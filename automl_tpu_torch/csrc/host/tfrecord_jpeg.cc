// Host-side data loader of automl_tpu_torch: TFRecord framing with CRC32C,
// a tf.Example wire walker, JPEG decode (whole image, or DCT-scaled nearest
// resize onto a canvas), JPEG encode, and reader-thread + worker-pool
// pipelines for classification and detection records. Plain C interface,
// loaded with ctypes (data/native_loader.py builds it with g++ at first use).
//
// The JPEG codec is chosen at build time:
//   - libjpeg (default): g++ -O3 -shared -fPIC tfrecord_jpeg.cc -ljpeg
//     -lpthread. jpeg_decode_full decodes as tf.io.decode_image does
//     (JDCT_IFAST, fancy upsampling); the canvas decodes use libjpeg's
//     defaults and its DCT scaling.
//   - nvJPEG (-DAUTOML_NVJPEG, -lnvjpeg -lcudart), for hosts without
//     libjpeg: the CUDA toolkit's decoder and encoder on the GPU, each
//     thread with its own state and stream. nvJPEG has no DCT scaling: the
//     canvas decodes take the scaled size libjpeg would give and sample the
//     full-size decode at the centres of its pixels, so the content sizes
//     (and the boxes) are libjpeg's; the pixels are not libjpeg's.
//
// TFRecord framing: { uint64 length, uint32 masked_crc32c(length),
//                     bytes data[length], uint32 masked_crc32c(data) }.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <atomic>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#ifdef AUTOML_NVJPEG
#include <cuda_runtime.h>
#include <nvjpeg.h>
#else
#include <csetjmp>
#include <jpeglib.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli), table-driven, with the TFRecord masking scheme.
// ---------------------------------------------------------------------------

static uint32_t kCrcTable[256];
static std::once_flag crc_once;

static void crc_init() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++)
      c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
    kCrcTable[i] = c;
  }
}

static uint32_t crc32c(const uint8_t* data, size_t n) {
  std::call_once(crc_once, crc_init);
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++)
    c = kCrcTable[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

static uint32_t masked_crc(const uint8_t* data, size_t n) {
  uint32_t crc = crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

// ---------------------------------------------------------------------------
// TFRecord reader.
// ---------------------------------------------------------------------------

struct TfRecordReader {
  FILE* f;
  uint8_t* buf;
  size_t buf_cap;
  int check_crc;
};

void* tfrecord_open(const char* path, int check_crc) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  return new TfRecordReader{f, (uint8_t*)malloc(1 << 20), 1 << 20, check_crc};
}

// Returns the record's length (>= 0), -2 at the end of the file, -1 on
// corruption. The data pointer is valid until the next call.
int64_t tfrecord_next(void* handle, const uint8_t** out_data) {
  auto* r = (TfRecordReader*)handle;
  uint8_t header[12];
  if (fread(header, 1, 12, r->f) != 12) return -2;
  uint64_t len;
  memcpy(&len, header, 8);
  if (r->check_crc) {
    uint32_t len_crc;
    memcpy(&len_crc, header + 8, 4);
    if (masked_crc(header, 8) != len_crc) return -1;
  }
  if (len + 4 > r->buf_cap) {
    r->buf_cap = len + 4;
    r->buf = (uint8_t*)realloc(r->buf, r->buf_cap);
  }
  if (fread(r->buf, 1, len + 4, r->f) != len + 4) return -1;
  if (r->check_crc) {
    uint32_t data_crc;
    memcpy(&data_crc, r->buf + len, 4);
    if (masked_crc(r->buf, len) != data_crc) return -1;
  }
  *out_data = r->buf;
  return (int64_t)len;
}

void tfrecord_rewind(void* handle) {
  fseek(((TfRecordReader*)handle)->f, 0, SEEK_SET);
}

void tfrecord_close(void* handle) {
  auto* r = (TfRecordReader*)handle;
  fclose(r->f);
  free(r->buf);
  delete r;
}

// The masked CRC32C of n bytes: TFRecord framing's, and the crc32c field
// of a TF checkpoint's BundleEntryProto and of its index blocks.
uint32_t crc32c_masked(const uint8_t* data, int64_t n) {
  return masked_crc(data, (size_t)n);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// The codec: header info, decode (whole, or DCT-scaled by num / 8) to
// interleaved RGB rows, encode from RGB. Each returns 0 on success.
// ---------------------------------------------------------------------------

namespace {

thread_local std::string last_error;

// The DCT scale num / 8 (1..8) that covers the canvas: the smallest with
// num / 8 >= the ratio, where the ratio is the smaller of out / src over
// the two sides (cover = 0: the aspect-preserving canvas) or the larger
// (cover = 1: the stretched canvas), at most 1.
int scale_num_for(int src_h, int src_w, int out_h, int out_w, int cover) {
  double ratio_h = (double)out_h / src_h;
  double ratio_w = (double)out_w / src_w;
  double ratio = cover ? (ratio_h > ratio_w ? ratio_h : ratio_w)
                       : (ratio_h < ratio_w ? ratio_h : ratio_w);
  if (ratio > 1.0) ratio = 1.0;
  int num = (int)(ratio * 8.0 + 0.999);
  if (num < 1) num = 1;
  if (num > 8) num = 8;
  return num;
}

#ifndef AUTOML_NVJPEG

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  char msg[JMSG_LENGTH_MAX];
  (*cinfo->err->format_message)(cinfo, msg);
  last_error = msg;
  longjmp(((JpegErr*)cinfo->err)->jb, 1);
}

const char* codec_name() { return "libjpeg"; }

int image_info(const uint8_t* data, int64_t len, int* hwc) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, (unsigned long)len);
  jpeg_read_header(&cinfo, TRUE);
  hwc[0] = (int)cinfo.image_height;
  hwc[1] = (int)cinfo.image_width;
  hwc[2] = cinfo.num_components;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decodes to RGB rows (malloc'd, *rows; the caller frees). scale_num 0
// picks the DCT scale from (out_h, out_w, cover) once the header is read.
// tf_decode: tf.io.decode_image's IDCT (JDCT_IFAST) and fancy upsampling
// instead of libjpeg's defaults.
int decode_rgb(const uint8_t* data, int64_t len, int out_h, int out_w,
               int cover, int full, int tf_decode, uint8_t** rows, int* h,
               int* w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  uint8_t* volatile buf = nullptr;
  uint8_t* volatile line = nullptr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    free(buf);
    free(line);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, (unsigned long)len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  if (tf_decode) {
    cinfo.dct_method = JDCT_IFAST;
    cinfo.do_fancy_upsampling = TRUE;
  }
  cinfo.scale_num = full ? 8 : scale_num_for(cinfo.image_height,
                                             cinfo.image_width, out_h, out_w,
                                             cover);
  cinfo.scale_denom = 8;
  jpeg_start_decompress(&cinfo);
  int src_h = cinfo.output_height, src_w = cinfo.output_width;
  int comps = cinfo.output_components;
  buf = (uint8_t*)malloc((size_t)src_h * src_w * 3);
  if (comps != 3) line = (uint8_t*)malloc((size_t)src_w * comps);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* dst = buf + (size_t)cinfo.output_scanline * src_w * 3;
    uint8_t* rowp = comps == 3 ? dst : line;
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    if (comps != 3) {
      for (int x = 0; x < src_w; x++) {
        const uint8_t* p = line + (size_t)x * comps;
        dst[x * 3 + 0] = p[0];
        dst[x * 3 + 1] = comps > 1 ? p[1] : p[0];
        dst[x * 3 + 2] = comps > 2 ? p[2] : p[0];
      }
    }
  }
  free(line);
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *rows = buf;
  *h = src_h;
  *w = src_w;
  return 0;
}

int64_t encode_rgb(const uint8_t* rgb, int h, int w, int quality,
                   uint8_t** out) {
  jpeg_compress_struct cinfo;
  JpegErr jerr;
  unsigned char* volatile mem = nullptr;
  unsigned long size = 0;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_compress(&cinfo);
    free(mem);
    return -1;
  }
  jpeg_create_compress(&cinfo);
  unsigned char* dest = nullptr;
  jpeg_mem_dest(&cinfo, &dest, &size);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);   // 4:2:0 chroma, Huffman tables of Annex K
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = (JSAMPROW)(rgb + (size_t)cinfo.next_scanline * w * 3);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  mem = dest;
  jpeg_destroy_compress(&cinfo);
  *out = dest;
  return (int64_t)size;
}

#else  // AUTOML_NVJPEG

const char* codec_name() { return "nvjpeg"; }

// libjpeg's output size at scale num / 8: ceil(size * num / 8).
int scaled_size(int size, int num) { return (int)(((long)size * num + 7) / 8); }

std::once_flag nv_once;
nvjpegHandle_t nv_handle = nullptr;
nvjpegStatus_t nv_init_status = NVJPEG_STATUS_SUCCESS;

bool nv_ok(nvjpegStatus_t s, const char* what) {
  if (s == NVJPEG_STATUS_SUCCESS) return true;
  last_error = std::string(what) + " failed: nvjpegStatus " +
               std::to_string((int)s);
  return false;
}

bool cuda_ok(cudaError_t e, const char* what) {
  if (e == cudaSuccess) return true;
  last_error = std::string(what) + " failed: " + cudaGetErrorString(e);
  return false;
}

nvjpegHandle_t handle() {
  std::call_once(nv_once, [] { nv_init_status = nvjpegCreateSimple(&nv_handle); });
  if (!nv_ok(nv_init_status, "nvjpegCreateSimple")) return nullptr;
  return nv_handle;
}

// One thread's decoder and encoder state, its stream and its device
// buffer; released when the thread ends.
struct NvThread {
  nvjpegJpegState_t dec = nullptr;
  nvjpegEncoderState_t enc = nullptr;
  nvjpegEncoderParams_t params = nullptr;
  cudaStream_t stream = nullptr;
  uint8_t* dbuf = nullptr;
  size_t dbuf_cap = 0;
  bool ready = false;

  bool init() {
    if (ready) return true;
    nvjpegHandle_t h = handle();
    if (!h) return false;
    if (!cuda_ok(cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking),
                 "cudaStreamCreate") ||
        !nv_ok(nvjpegJpegStateCreate(h, &dec), "nvjpegJpegStateCreate"))
      return false;
    ready = true;
    return true;
  }

  uint8_t* device(size_t bytes) {
    if (bytes > dbuf_cap) {
      if (dbuf) cudaFree(dbuf);
      dbuf = nullptr;
      dbuf_cap = 0;
      if (!cuda_ok(cudaMalloc(&dbuf, bytes), "cudaMalloc")) return nullptr;
      dbuf_cap = bytes;
    }
    return dbuf;
  }

  ~NvThread() {
    if (params) nvjpegEncoderParamsDestroy(params);
    if (enc) nvjpegEncoderStateDestroy(enc);
    if (dec) nvjpegJpegStateDestroy(dec);
    if (dbuf) cudaFree(dbuf);
    if (stream) cudaStreamDestroy(stream);
  }
};

thread_local NvThread nv;

int image_info(const uint8_t* data, int64_t len, int* hwc) {
  nvjpegHandle_t h = handle();
  if (!h) return 1;
  int comps = 0, widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  nvjpegChromaSubsampling_t css;
  if (!nv_ok(nvjpegGetImageInfo(h, data, (size_t)len, &comps, &css, widths,
                                heights), "nvjpegGetImageInfo"))
    return 1;
  hwc[0] = heights[0];
  hwc[1] = widths[0];
  hwc[2] = comps;
  return 0;
}

// The whole image decoded on the GPU and copied back as RGB rows; a
// one-component image is decoded as Y and repeated. Without `full`, the
// rows are sampled down to libjpeg's DCT-scaled size (see the top).
int decode_rgb(const uint8_t* data, int64_t len, int out_h, int out_w,
               int cover, int full, int tf_decode, uint8_t** rows, int* h,
               int* w) {
  (void)tf_decode;
  int hwc[3];
  if (image_info(data, len, hwc) != 0 || !nv.init()) return 1;
  int ih = hwc[0], iw = hwc[1], comps = hwc[2];
  if (comps != 1 && comps != 3) {
    last_error = "nvJPEG decode: " + std::to_string(comps) +
                 "-component JPEG not supported";
    return 1;
  }
  int ch = comps == 1 ? 1 : 3;
  uint8_t* d = nv.device((size_t)ih * iw * ch);
  if (!d) return 1;
  nvjpegImage_t img;
  memset(&img, 0, sizeof(img));
  img.channel[0] = d;
  img.pitch[0] = (size_t)iw * ch;
  if (!nv_ok(nvjpegDecode(handle(), nv.dec, data, (size_t)len,
                          comps == 1 ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_RGBI,
                          &img, nv.stream), "nvjpegDecode"))
    return 1;
  std::vector<uint8_t> host((size_t)ih * iw * ch);
  if (!cuda_ok(cudaMemcpyAsync(host.data(), d, host.size(),
                               cudaMemcpyDeviceToHost, nv.stream),
               "cudaMemcpyAsync") ||
      !cuda_ok(cudaStreamSynchronize(nv.stream), "cudaStreamSynchronize"))
    return 1;
  int num = full ? 8 : scale_num_for(ih, iw, out_h, out_w, cover);
  int sh = scaled_size(ih, num), sw = scaled_size(iw, num);
  uint8_t* buf = (uint8_t*)malloc((size_t)sh * sw * 3);
  for (int y = 0; y < sh; y++) {
    int fy = num == 8 ? y : (int)(((double)y + 0.5) * ih / sh);
    if (fy >= ih) fy = ih - 1;
    for (int x = 0; x < sw; x++) {
      int fx = num == 8 ? x : (int)(((double)x + 0.5) * iw / sw);
      if (fx >= iw) fx = iw - 1;
      const uint8_t* p = host.data() + ((size_t)fy * iw + fx) * ch;
      uint8_t* q = buf + ((size_t)y * sw + x) * 3;
      q[0] = p[0];
      q[1] = p[ch == 3 ? 1 : 0];
      q[2] = p[ch == 3 ? 2 : 0];
    }
  }
  *rows = buf;
  *h = sh;
  *w = sw;
  return 0;
}

int64_t encode_rgb(const uint8_t* rgb, int h, int w, int quality,
                   uint8_t** out) {
  if (!nv.init()) return -1;
  nvjpegHandle_t hd = handle();
  if (!nv.enc) {
    if (!nv_ok(nvjpegEncoderStateCreate(hd, &nv.enc, nv.stream),
               "nvjpegEncoderStateCreate") ||
        !nv_ok(nvjpegEncoderParamsCreate(hd, &nv.params, nv.stream),
               "nvjpegEncoderParamsCreate") ||
        !nv_ok(nvjpegEncoderParamsSetSamplingFactors(nv.params, NVJPEG_CSS_420,
                                                     nv.stream),
               "nvjpegEncoderParamsSetSamplingFactors") ||
        !nv_ok(nvjpegEncoderParamsSetOptimizedHuffman(nv.params, 0, nv.stream),
               "nvjpegEncoderParamsSetOptimizedHuffman"))
      return -1;
  }
  if (!nv_ok(nvjpegEncoderParamsSetQuality(nv.params, quality, nv.stream),
             "nvjpegEncoderParamsSetQuality"))
    return -1;
  size_t bytes = (size_t)h * w * 3;
  uint8_t* d = nv.device(bytes);
  if (!d) return -1;
  if (!cuda_ok(cudaMemcpyAsync(d, rgb, bytes, cudaMemcpyHostToDevice,
                               nv.stream), "cudaMemcpyAsync"))
    return -1;
  nvjpegImage_t img;
  memset(&img, 0, sizeof(img));
  img.channel[0] = d;
  img.pitch[0] = (size_t)w * 3;
  size_t length = 0;
  if (!nv_ok(nvjpegEncodeImage(hd, nv.enc, nv.params, &img, NVJPEG_INPUT_RGBI,
                               w, h, nv.stream), "nvjpegEncodeImage") ||
      !nv_ok(nvjpegEncodeRetrieveBitstream(hd, nv.enc, nullptr, &length,
                                           nv.stream),
             "nvjpegEncodeRetrieveBitstream") ||
      !cuda_ok(cudaStreamSynchronize(nv.stream), "cudaStreamSynchronize"))
    return -1;
  uint8_t* buf = (uint8_t*)malloc(length);
  if (!nv_ok(nvjpegEncodeRetrieveBitstream(hd, nv.enc, buf, &length,
                                           nv.stream),
             "nvjpegEncodeRetrieveBitstream") ||
      !cuda_ok(cudaStreamSynchronize(nv.stream), "cudaStreamSynchronize")) {
    free(buf);
    return -1;
  }
  *out = buf;
  return (int64_t)length;
}

#endif  // AUTOML_NVJPEG

}  // namespace

extern "C" {

// "libjpeg" or "nvjpeg": the codec this library was built with.
const char* jpeg_codec() { return codec_name(); }

// The calling thread's last codec error message.
const char* jpeg_last_error() { return last_error.c_str(); }

// hwc[3]: the image's height, width and number of components.
int jpeg_image_info(const uint8_t* data, int64_t len, int* hwc) {
  return image_info(data, len, hwc);
}

// The whole image as RGB into out [h, w, 3] (h, w from jpeg_image_info),
// decoded as tf.io.decode_image(channels=3) decodes (libjpeg: JDCT_IFAST,
// fancy upsampling); a grayscale JPEG comes out as RGB.
int jpeg_decode_full(const uint8_t* data, int64_t len, uint8_t* out, int h,
                     int w) {
  uint8_t* rows = nullptr;
  int sh = 0, sw = 0;
  if (decode_rgb(data, len, 0, 0, 0, /*full=*/1, /*tf_decode=*/1, &rows, &sh,
                 &sw) != 0)
    return 1;
  int rc = 0;
  if (sh != h || sw != w) {
    last_error = "jpeg_decode_full: the image is " + std::to_string(sh) +
                 "x" + std::to_string(sw) + ", the buffer " +
                 std::to_string(h) + "x" + std::to_string(w);
    rc = 1;
  } else {
    memcpy(out, rows, (size_t)h * w * 3);
  }
  free(rows);
  return rc;
}

// Encodes RGB [h, w, 3] as a baseline 4:2:0 JPEG at `quality`; *out
// (free it with jpeg_free) holds the returned number of bytes; -1 on
// failure.
int64_t jpeg_encode_rgb(const uint8_t* rgb, int h, int w, int quality,
                        uint8_t** out) {
  return encode_rgb(rgb, h, w, quality, out);
}

void jpeg_free(uint8_t* p) { free(p); }

// tf.image.resize(..., "bilinear") of RGB src [src_h, src_w, 3] to out
// [out_h, out_w, 3] as TF's CPU kernel computes it (half-pixel centres, no
// antialias), in float32 without contraction into FMAs, then
// tf.cast(tf.round(x), tf.uint8): round half to even.
void resize_bilinear_rgb(const uint8_t* src, int src_h, int src_w,
                         uint8_t* out, int out_h, int out_w) {
  struct Tap { int lo, hi; float lerp; };
  auto taps = [](int out_size, int in_size) {
    std::vector<Tap> t(out_size);
    const float scale = (float)in_size / (float)out_size;
    for (int i = 0; i < out_size; i++) {
      const float in = ((float)i + 0.5f) * scale - 0.5f;
      const float fl = floorf(in);
      t[i].lo = fl > 0.0f ? (int)fl : 0;
      t[i].hi = (int)ceilf(in) < in_size - 1 ? (int)ceilf(in) : in_size - 1;
      t[i].lerp = in - fl;
    }
    return t;
  };
  const std::vector<Tap> ys = taps(out_h, src_h), xs = taps(out_w, src_w);
  for (int y = 0; y < out_h; y++) {
    const uint8_t* top_row = src + (size_t)ys[y].lo * src_w * 3;
    const uint8_t* bottom_row = src + (size_t)ys[y].hi * src_w * 3;
    const float dy = ys[y].lerp;
    uint8_t* dst = out + (size_t)y * out_w * 3;
    for (int x = 0; x < out_w; x++) {
      const uint8_t* tl = top_row + xs[x].lo * 3;
      const uint8_t* tr = top_row + xs[x].hi * 3;
      const uint8_t* bl = bottom_row + xs[x].lo * 3;
      const uint8_t* br = bottom_row + xs[x].hi * 3;
      const float dx = xs[x].lerp;
      for (int c = 0; c < 3; c++) {
        const float top = (float)tl[c] + ((float)tr[c] - (float)tl[c]) * dx;
        const float bottom =
            (float)bl[c] + ((float)br[c] - (float)bl[c]) * dx;
        float v = nearbyintf(top + (bottom - top) * dy);
        v = v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
        dst[x * 3 + c] = (uint8_t)v;
      }
    }
  }
}

// Decodes a JPEG onto out (out_h x out_w x 3, uint8) with an
// aspect-preserving nearest resize placed top-left, zero elsewhere; writes
// the content size to content_hw[2]. Returns 0 on success.
int jpeg_decode_resize(const uint8_t* data, int64_t len, uint8_t* out,
                       int out_h, int out_w, int* content_hw) {
  uint8_t* rows = nullptr;
  int src_h = 0, src_w = 0;
  if (decode_rgb(data, len, out_h, out_w, /*cover=*/0, 0, 0, &rows, &src_h,
                 &src_w) != 0)
    return 1;
  double scale = (double)out_h / src_h;
  double sw = (double)out_w / src_w;
  if (sw < scale) scale = sw;
  int ch = (int)(src_h * scale + 0.5);
  int cw = (int)(src_w * scale + 0.5);
  if (ch > out_h) ch = out_h;
  if (cw > out_w) cw = out_w;
  memset(out, 0, (size_t)out_h * out_w * 3);
  for (int y = 0; y < ch; y++) {
    int sy = (int)(y / scale);
    if (sy >= src_h) sy = src_h - 1;
    const uint8_t* src_row = rows + (size_t)sy * src_w * 3;
    uint8_t* dst_row = out + (size_t)y * out_w * 3;
    for (int x = 0; x < cw; x++) {
      int sx = (int)(x / scale);
      if (sx >= src_w) sx = src_w - 1;
      memcpy(dst_row + x * 3, src_row + (size_t)sx * 3, 3);
    }
  }
  free(rows);
  content_hw[0] = ch;
  content_hw[1] = cw;
  return 0;
}

// Decodes a JPEG filling the whole canvas (independent nearest scales of
// the two sides): the classification training canvas.
int jpeg_decode_stretch(const uint8_t* data, int64_t len, uint8_t* out,
                        int out_h, int out_w, int* content_hw) {
  uint8_t* rows = nullptr;
  int src_h = 0, src_w = 0;
  if (decode_rgb(data, len, out_h, out_w, /*cover=*/1, 0, 0, &rows, &src_h,
                 &src_w) != 0)
    return 1;
  for (int y = 0; y < out_h; y++) {
    int sy = (int)((double)y * src_h / out_h);
    if (sy >= src_h) sy = src_h - 1;
    const uint8_t* src_row = rows + (size_t)sy * src_w * 3;
    uint8_t* dst_row = out + (size_t)y * out_w * 3;
    for (int x = 0; x < out_w; x++) {
      int sx = (int)((double)x * src_w / out_w);
      if (sx >= src_w) sx = src_w - 1;
      memcpy(dst_row + x * 3, src_row + (size_t)sx * 3, 3);
    }
  }
  free(rows);
  content_hw[0] = out_h;
  content_hw[1] = out_w;
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Parallel batch pipeline: reader thread -> JPEG-decode worker pool ->
// bounded ready queue of examples -> batch assembly in next_batch().
// Examples are parsed here too (a minimal tf.Example wire walk), so Python
// only sees ready uint8 canvas batches. Batch order depends on the workers.
// ---------------------------------------------------------------------------

namespace {

struct Slice { const uint8_t* p; size_t n; };

bool read_varint_c(const uint8_t*& p, const uint8_t* end, uint64_t* out) {
  uint64_t v = 0;
  int shift = 0;
  while (p < end) {
    uint8_t b = *p++;
    v |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) { *out = v; return true; }
    shift += 7;
    if (shift > 63) return false;
  }
  return false;
}

// Walks a message body; the bytes of the LAST occurrence of the
// length-delimited field `want` (a varint field's value in out->n).
bool find_field(Slice msg, int want, Slice* out) {
  const uint8_t* p = msg.p;
  const uint8_t* end = msg.p + msg.n;
  bool found = false;
  while (p < end) {
    uint64_t tag;
    if (!read_varint_c(p, end, &tag)) return found;
    int field = (int)(tag >> 3), wire = (int)(tag & 7);
    if (wire == 2) {
      uint64_t len;
      if (!read_varint_c(p, end, &len) || p + len > end) return found;
      if (field == want) { *out = {p, (size_t)len}; found = true; }
      p += len;
    } else if (wire == 0) {
      uint64_t v;
      if (!read_varint_c(p, end, &v)) return found;
      if (field == want) { out->p = nullptr; out->n = v; found = true; }
    } else if (wire == 5) {
      p += 4;
    } else if (wire == 1) {
      p += 8;
    } else {
      return found;
    }
  }
  return found;
}

// Example -> features(1) -> map entries: key(1) string, value(2) Feature.
bool example_lookup(Slice example, const char* key, Slice* feature) {
  Slice features;
  if (!find_field(example, 1, &features)) return false;
  const uint8_t* end = features.p + features.n;
  size_t key_len = strlen(key);
  const uint8_t* q = features.p;
  while (q < end) {
    uint64_t tag;
    const uint8_t* qq = q;
    if (!read_varint_c(qq, end, &tag)) return false;
    if ((tag >> 3) != 1 || (tag & 7) != 2) return false;
    uint64_t len;
    if (!read_varint_c(qq, end, &len) || qq + len > end) return false;
    Slice entry{qq, (size_t)len};
    Slice k, v;
    if (find_field(entry, 1, &k) && k.n == key_len &&
        memcmp(k.p, key, key_len) == 0 && find_field(entry, 2, &v)) {
      *feature = v;
      return true;
    }
    q = qq + len;
  }
  return false;
}

bool feature_bytes(Slice feature, Slice* out) {
  Slice blist;
  if (!find_field(feature, 1, &blist)) return false;
  return find_field(blist, 1, out);
}

bool feature_floats(Slice feature, std::vector<float>* out) {
  Slice flist;
  if (!find_field(feature, 2, &flist)) return false;
  const uint8_t* p = flist.p;
  const uint8_t* end = flist.p + flist.n;
  while (p < end) {
    uint64_t tag;
    if (!read_varint_c(p, end, &tag)) return false;
    if ((tag >> 3) != 1) return false;
    if ((tag & 7) == 5) {
      if (p + 4 > end) return false;
      float v;
      memcpy(&v, p, 4);
      out->push_back(v);
      p += 4;
    } else if ((tag & 7) == 2) {
      uint64_t len;
      if (!read_varint_c(p, end, &len) || p + len > end) return false;
      for (const uint8_t* q = p; q + 4 <= p + len; q += 4) {
        float v;
        memcpy(&v, q, 4);
        out->push_back(v);
      }
      p += len;
    } else {
      return false;
    }
  }
  return true;
}

bool feature_int64s(Slice feature, std::vector<int64_t>* out) {
  Slice ilist;
  if (!find_field(feature, 3, &ilist)) return false;
  const uint8_t* p = ilist.p;
  const uint8_t* end = ilist.p + ilist.n;
  while (p < end) {
    uint64_t tag;
    if (!read_varint_c(p, end, &tag)) return false;
    if ((tag >> 3) != 1) return false;
    if ((tag & 7) == 0) {
      uint64_t v;
      if (!read_varint_c(p, end, &v)) return false;
      out->push_back((int64_t)v);
    } else if ((tag & 7) == 2) {
      uint64_t len;
      if (!read_varint_c(p, end, &len) || p + len > end) return false;
      const uint8_t* e2 = p + len;
      while (p < e2) {
        uint64_t v;
        if (!read_varint_c(p, e2, &v)) return false;
        out->push_back((int64_t)v);
      }
    } else {
      return false;
    }
  }
  return true;
}

bool feature_int64(Slice feature, int64_t* out) {
  std::vector<int64_t> all;
  if (!feature_int64s(feature, &all) || all.empty()) return false;
  *out = all[0];
  return true;
}

struct ExampleOut {
  std::vector<uint8_t> canvas;
  int64_t label;
  int content_h, content_w;
  // detection mode
  std::vector<float> boxes;      // [max_instances, 4] canvas coords
  std::vector<int32_t> classes;  // [max_instances], -1 padded
  float source_id;
};

struct Pipeline {
  std::vector<std::string> files;
  int batch, canvas_h, canvas_w;
  size_t prefetch_max;      // bound on records (and examples) waiting
  bool repeat;
  int mode = 0;             // 0 = classification, 1 = detection
  int max_instances = 0;
  bool skip_crowd = false;
  bool stretch = false;     // cls: fill the canvas; det: letterbox

  std::mutex mu;
  std::condition_variable cv_work, cv_ready;
  std::deque<std::vector<uint8_t>> work;   // raw records
  std::deque<ExampleOut> ready;
  bool done_reading = false;
  std::atomic<bool> stop{false};
  int in_flight = 0;        // records popped by workers, not yet in ready
  int64_t dropped = 0;      // corrupt / undecodable examples (skipped)

  std::thread reader;
  std::vector<std::thread> workers;
};

void reader_main(Pipeline* pl) {
  do {
    int opened = 0;
    for (const auto& path : pl->files) {
      void* r = tfrecord_open(path.c_str(), 1);
      if (!r) continue;
      opened++;
      const uint8_t* data;
      int64_t n;
      while ((n = tfrecord_next(r, &data)) >= 0) {
        std::vector<uint8_t> rec(data, data + n);
        std::unique_lock<std::mutex> lk(pl->mu);
        pl->cv_work.wait(lk, [&] {
          return pl->stop || pl->work.size() < pl->prefetch_max;
        });
        if (pl->stop) { tfrecord_close(r); return; }
        pl->work.push_back(std::move(rec));
        pl->cv_ready.notify_all();
      }
      tfrecord_close(r);
      if (pl->stop) return;
    }
    if (opened == 0) break;  // nothing readable: end instead of spinning
  } while (pl->repeat && !pl->stop);
  std::lock_guard<std::mutex> lk(pl->mu);
  pl->done_reading = true;
  pl->cv_ready.notify_all();
}

// Detection: the normalised gt boxes in canvas coordinates (content size =
// source size * scale), crowds skipped if asked, cut or padded to
// max_instances; the source id as a float.
void parse_detection(Pipeline* pl, Slice ex, ExampleOut* out) {
  std::vector<float> ymin, xmin, ymax, xmax;
  std::vector<int64_t> labels, crowd;
  Slice f;
  if (example_lookup(ex, "image/object/bbox/ymin", &f)) feature_floats(f, &ymin);
  if (example_lookup(ex, "image/object/bbox/xmin", &f)) feature_floats(f, &xmin);
  if (example_lookup(ex, "image/object/bbox/ymax", &f)) feature_floats(f, &ymax);
  if (example_lookup(ex, "image/object/bbox/xmax", &f)) feature_floats(f, &xmax);
  if (example_lookup(ex, "image/object/class/label", &f))
    feature_int64s(f, &labels);
  if (example_lookup(ex, "image/object/is_crowd", &f)) feature_int64s(f, &crowd);
  out->source_id = 0.0f;
  if (example_lookup(ex, "image/source_id", &f)) {
    Slice s;
    if (feature_bytes(f, &s) && s.n > 0 && s.n < 32) {
      char tmp[32];
      memcpy(tmp, s.p, s.n);
      tmp[s.n] = 0;
      out->source_id = (float)atof(tmp);
    }
  }
  int g = pl->max_instances;
  out->boxes.assign((size_t)g * 4, 0.0f);
  out->classes.assign(g, -1);
  int n = 0;
  for (size_t i = 0; i < ymin.size() && n < g; i++) {
    if (i >= xmin.size() || i >= ymax.size() || i >= xmax.size()) break;
    if (pl->skip_crowd && i < crowd.size() && crowd[i]) continue;
    out->boxes[(size_t)n * 4 + 0] = ymin[i] * out->content_h;
    out->boxes[(size_t)n * 4 + 1] = xmin[i] * out->content_w;
    out->boxes[(size_t)n * 4 + 2] = ymax[i] * out->content_h;
    out->boxes[(size_t)n * 4 + 3] = xmax[i] * out->content_w;
    out->classes[n] = i < labels.size() ? (int32_t)labels[i] : -1;
    n++;
  }
}

void worker_main(Pipeline* pl) {
  for (;;) {
    std::vector<uint8_t> rec;
    {
      std::unique_lock<std::mutex> lk(pl->mu);
      pl->cv_ready.wait(lk, [&] {
        return pl->stop || !pl->work.empty() || pl->done_reading;
      });
      if (pl->stop) return;
      if (pl->work.empty()) {
        if (pl->done_reading) return;
        continue;
      }
      rec = std::move(pl->work.front());
      pl->work.pop_front();
      pl->in_flight++;
      pl->cv_work.notify_all();
    }
    Slice ex{rec.data(), rec.size()};
    Slice img_feat, jpeg;
    ExampleOut out;
    bool ok = example_lookup(ex, "image/encoded", &img_feat) &&
              feature_bytes(img_feat, &jpeg);
    if (ok) {
      int64_t label = -1;
      Slice lab_feat;
      if (example_lookup(ex, "image/class/label", &lab_feat))
        feature_int64(lab_feat, &label);
      out.canvas.resize((size_t)pl->canvas_h * pl->canvas_w * 3);
      int hw[2] = {0, 0};
      ok = (pl->stretch
            ? jpeg_decode_stretch(jpeg.p, (int64_t)jpeg.n, out.canvas.data(),
                                  pl->canvas_h, pl->canvas_w, hw)
            : jpeg_decode_resize(jpeg.p, (int64_t)jpeg.n, out.canvas.data(),
                                 pl->canvas_h, pl->canvas_w, hw)) == 0;
      out.content_h = hw[0];
      out.content_w = hw[1];
      out.label = label;
    }
    if (ok && pl->mode == 1) parse_detection(pl, ex, &out);
    std::unique_lock<std::mutex> lk(pl->mu);
    if (ok) {
      // Decoded examples are bounded too; in_flight stays above 0 until
      // the example is in `ready`, so the consumer's end-of-stream test
      // cannot fire early.
      pl->cv_work.wait(lk, [&] {
        return pl->stop || pl->ready.size() < pl->prefetch_max;
      });
      if (pl->stop) return;
      pl->ready.push_back(std::move(out));
    } else {
      pl->dropped++;
    }
    pl->in_flight--;
    pl->cv_ready.notify_all();
  }
}

Pipeline* create_impl(const char** paths, int n_paths, int batch,
                      int canvas_h, int canvas_w, int n_workers,
                      int prefetch_batches, int repeat, int mode,
                      int max_instances, int skip_crowd, int stretch) {
  auto* pl = new Pipeline();
  for (int i = 0; i < n_paths; i++) pl->files.emplace_back(paths[i]);
  pl->batch = batch;
  pl->canvas_h = canvas_h;
  pl->canvas_w = canvas_w;
  pl->prefetch_max = (size_t)prefetch_batches * batch;
  pl->repeat = repeat != 0;
  pl->mode = mode;                    // set before the threads start
  pl->max_instances = max_instances;
  pl->skip_crowd = skip_crowd != 0;
  pl->stretch = stretch != 0;
  pl->reader = std::thread(reader_main, pl);
  if (n_workers < 1) n_workers = 1;
  for (int i = 0; i < n_workers; i++) pl->workers.emplace_back(worker_main, pl);
  return pl;
}

// The next decoded example, false at the end of a finite stream (or on
// stop).
bool pop_ready(Pipeline* pl, ExampleOut* ex) {
  std::unique_lock<std::mutex> lk(pl->mu);
  // exhausted only when the reader finished and no record is queued or
  // being decoded
  pl->cv_ready.wait(lk, [&] {
    return pl->stop || !pl->ready.empty() ||
           (pl->done_reading && pl->work.empty() && pl->in_flight == 0);
  });
  if (pl->stop || pl->ready.empty()) return false;
  *ex = std::move(pl->ready.front());
  pl->ready.pop_front();
  pl->cv_work.notify_all();
  return true;
}

}  // namespace

extern "C" {

// Classification: fills the canvas (the tf.data train branch's stretch).
void* pipeline_create(const char** paths, int n_paths, int batch,
                      int canvas_h, int canvas_w, int n_workers,
                      int prefetch_batches, int repeat) {
  return create_impl(paths, n_paths, batch, canvas_h, canvas_w, n_workers,
                     prefetch_batches, repeat, /*mode=*/0, 0, 0,
                     /*stretch=*/1);
}

// Fills images [batch, H, W, 3] u8, labels [batch] i64, content_hw
// [batch, 2] i32. Returns the number of examples written (< batch only at
// the end of a non-repeating stream; 0 = exhausted).
int pipeline_next_batch(void* handle, uint8_t* images, int64_t* labels,
                        int32_t* content_hw) {
  auto* pl = (Pipeline*)handle;
  size_t canvas_bytes = (size_t)pl->canvas_h * pl->canvas_w * 3;
  int got = 0;
  ExampleOut ex;
  while (got < pl->batch && pop_ready(pl, &ex)) {
    memcpy(images + (size_t)got * canvas_bytes, ex.canvas.data(),
           canvas_bytes);
    labels[got] = ex.label;
    content_hw[got * 2] = ex.content_h;
    content_hw[got * 2 + 1] = ex.content_w;
    got++;
  }
  return got;
}

// Detection: images [B, H, W, 3] u8, true_hw [B, 2] f32 (content size),
// gt_boxes [B, G, 4] f32 canvas coordinates, gt_classes [B, G] i32 (-1
// padded), source_id [B] f32.
void* det_pipeline_create(const char** paths, int n_paths, int batch,
                          int canvas, int max_instances, int skip_crowd,
                          int n_workers, int prefetch_batches, int repeat) {
  return create_impl(paths, n_paths, batch, canvas, canvas, n_workers,
                     prefetch_batches, repeat, /*mode=*/1, max_instances,
                     skip_crowd, /*stretch=*/0);
}

int det_pipeline_next_batch(void* handle, uint8_t* images, float* true_hw,
                            float* gt_boxes, int32_t* gt_classes,
                            float* source_id) {
  auto* pl = (Pipeline*)handle;
  size_t canvas_bytes = (size_t)pl->canvas_h * pl->canvas_w * 3;
  int g = pl->max_instances;
  int got = 0;
  ExampleOut ex;
  while (got < pl->batch && pop_ready(pl, &ex)) {
    memcpy(images + (size_t)got * canvas_bytes, ex.canvas.data(),
           canvas_bytes);
    true_hw[got * 2] = (float)ex.content_h;
    true_hw[got * 2 + 1] = (float)ex.content_w;
    memcpy(gt_boxes + (size_t)got * g * 4, ex.boxes.data(),
           (size_t)g * 4 * sizeof(float));
    memcpy(gt_classes + (size_t)got * g, ex.classes.data(),
           (size_t)g * sizeof(int32_t));
    source_id[got] = ex.source_id;
    got++;
  }
  return got;
}

int64_t pipeline_dropped(void* handle) {
  auto* pl = (Pipeline*)handle;
  std::lock_guard<std::mutex> lk(pl->mu);
  return pl->dropped;
}

void pipeline_destroy(void* handle) {
  auto* pl = (Pipeline*)handle;
  {
    std::lock_guard<std::mutex> lk(pl->mu);
    pl->stop = true;
  }
  pl->cv_work.notify_all();
  pl->cv_ready.notify_all();
  pl->reader.join();
  for (auto& w : pl->workers) w.join();
  delete pl;
}

}  // extern "C"
