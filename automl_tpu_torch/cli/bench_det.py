"""Benchmark: EfficientDet-D0 inference (forward + postprocess) on one GPU.

  python -m automl_tpu_torch.cli.bench_det                 # b32, top-2048
  python -m automl_tpu_torch.cli.bench_det --pre_nms_topk=5000

The counterpart of bench.py: D0 at 512 x 512 under mixed_bfloat16, seeded
weights in the JAX layout, nms_configs.pre_nms_topk 2048 (the serving
path; the config's default is 5000), postprocess_global (gaussian NMS).
After two warm-up calls it runs 8 distinct seeded batches of uniform
[0, 1) NHWC images, three times each: the whole call, the forward alone
and the postprocess alone (on that batch's forward outputs), each between
CUDA events recorded around the one call (the device timeline from the
call's first launch to its last kernel, host gaps included). Prints one
JSON line: the means in ms, img/s of the whole call, and the card's name
and power limit (nvidia-smi). Without a CUDA device it exits 1: it never
times the CPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

BATCH = 32
CALLS = 8


def _card() -> str:
  return subprocess.run(
      ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
      check=True).stdout.strip()


def event_ms(fn):
  """(fn's result, ms between CUDA events recorded around one call)."""
  import torch
  torch.cuda.synchronize()
  start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  start.record()
  out = fn()
  end.record()
  end.synchronize()
  return out, start.elapsed_time(end)


def main(argv=None) -> int:
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument("--pre_nms_topk", type=int, default=2048)
  args = p.parse_args(argv)
  import torch
  if not torch.cuda.is_available():
    print("bench_det: no CUDA device; this benchmark runs only on a GPU",
          file=sys.stderr)
    return 1
  from automl_tpu_torch import convert
  from automl_tpu_torch.models.efficientdet import build_detection_model
  from automl_tpu_torch.nn import precision
  from automl_tpu_torch.ops import anchors, postprocess

  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device("cuda:0")
  precision.set_policy("mixed_bfloat16")
  model = build_detection_model(
      "efficientdet-d0", device=dev,
      nms_configs=dict(pre_nms_topk=args.pre_nms_topk))
  convert.load_det_params(model, convert.det_numpy_init(model, 0))
  config = model.config
  h, w = anchors.parse_image_size(config.image_size)
  batches = []
  for i in range(CALLS):
    gen = torch.Generator(device=dev).manual_seed(i)
    batches.append(torch.rand((BATCH, h, w, 3), generator=gen, device=dev))

  @torch.no_grad()
  def forward(images):
    return model(images.permute(0, 3, 1, 2), train=False)

  @torch.no_grad()
  def post(outputs):
    return postprocess.postprocess_global(config, *outputs)

  for images in batches[:2]:                 # warm-up
    post(forward(images))
  torch.cuda.synchronize()
  full, fwd, pp = [], [], []
  for images in batches:
    out, ms = event_ms(lambda: post(forward(images)))
    full.append(ms)
    outputs, ms = event_ms(lambda: forward(images))
    fwd.append(ms)
    _, ms = event_ms(lambda: post(outputs))
    pp.append(ms)
  if not all(bool(torch.isfinite(t).all()) for t in out[:3]):
    print("bench_det: non-finite detections", file=sys.stderr)
    return 1
  mean = lambda xs: sum(xs) / len(xs)
  print(json.dumps({
      "metric": "effdet_d0_infer_images_per_sec",
      "value": BATCH / (mean(full) / 1e3),
      "unit": "images/sec (CUDA events around each call)",
      "model": "efficientdet-d0", "batch": BATCH, "image_size": [h, w],
      "pre_nms_topk": args.pre_nms_topk,
      "nms_method": postprocess.nms_params(config)["method"],
      "calls": CALLS, "ms_per_call": mean(full),
      "forward_ms": mean(fwd), "postprocess_ms": mean(pp),
      "ms_per_call_each": full,
      "device": torch.cuda.get_device_name(0), "card": _card()}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
