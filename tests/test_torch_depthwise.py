"""automl_tpu_torch's depthwise conv and plain K6 vs automl_tpu's on the CPU.

The plain K6 (depthwise_filter_grad_reference, what a CPU tensor takes) is
held against the Pallas kernel in interpret mode at the shapes of
tests/test_depthwise.py, at JAX's tolerance there (atol 2e-4, rtol 1e-5),
plus a bf16-input case; depthwise_conv's dx and dW, knob on and off, at
stride 1 and 2 and k3 and k5, against the grads of JAX's depthwise_conv /
_dw_forward (atol 1e-5, rtol 1e-5: the same f32 sums in another order).
The Hopper K6's routing (takes_sm90), tile plan (sm90_plan: every output
covered once, at D0's 13 maps and ragged ones) and wrapper arguments are
pure Python, checked here with stand-ins for the libraries.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automl_tpu.ops import depthwise as jdw
from automl_tpu_torch.nn import layers as tlayers
from automl_tpu_torch.nn import precision as tprecision
from automl_tpu_torch.ops import depthwise as tdw

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def f32_policy():
  tprecision.set_policy("float32")
  try:
    yield
  finally:
    tprecision.set_policy("mixed_bfloat16")


@pytest.fixture
def knob_on():
  tdw.enable_pallas_filter_grad(True)
  try:
    yield
  finally:
    tdw.enable_pallas_filter_grad(False)


def _nchw(a):
  return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("h,w,c,k,dtype", [
    (16, 16, 8, 3, "float32"), (15, 17, 8, 5, "float32"),
    (32, 32, 16, 3, "float32"), (15, 17, 8, 3, "bfloat16")])
def test_plain_k6_matches_pallas_interpret(h, w, c, k, dtype):
  rng = np.random.RandomState(0)
  x = rng.randn(2, h, w, c).astype(np.float32)
  dy = rng.randn(2, h, w, c).astype(np.float32)
  jx, jdy = jnp.asarray(x, dtype), jnp.asarray(dy, dtype)
  want = np.asarray(jdw.depthwise_filter_grad(jx, jdy, k, 1, interpret=True))
  tx = _nchw(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
  tdy = _nchw(np.asarray(jdy.astype(jnp.float32))).to(getattr(torch, dtype))
  cl = torch.channels_last
  got = tdw.depthwise_filter_grad(tx.contiguous(memory_format=cl),
                                  tdy.contiguous(memory_format=cl), k)
  assert got.dtype == torch.float32 and got.shape == (c, 1, k, k)
  np.testing.assert_allclose(got.numpy().transpose(2, 3, 1, 0), want,
                             atol=2e-4, rtol=1e-5)


@pytest.mark.parametrize("knob", [False, True], ids=["knob_off", "knob_on"])
@pytest.mark.parametrize("s,k", [(1, 3), (2, 3), (1, 5), (2, 5)])
def test_depthwise_conv_grads_match_jax(s, k, knob):
  """x [2, 13, 11, 8] (odd sizes: asymmetric SAME pads at stride 2); the
  JAX reference is its depthwise_conv custom_vjp (XLA on the CPU) for dx
  and dW, and _dw_forward's vjp; the port's DepthwiseConv2D layer (knob on:
  the autograd function whose dW is the plain K6 at stride 1)."""
  rng = np.random.RandomState(1)
  x = rng.randn(2, 13, 11, 8).astype(np.float32)
  ker = rng.randn(k, k, 1, 8).astype(np.float32)

  def jloss(fn):
    return lambda a, b: jnp.sum(jnp.sin(fn(a, b, (s, s), "SAME")))

  g_custom = jax.grad(jloss(jdw.depthwise_conv), (0, 1))(x, ker)
  g_plain = jax.grad(jloss(jdw._dw_forward), (0, 1))(x, ker)
  for a, b in zip(g_custom, g_plain):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)

  layer = tlayers.DepthwiseConv2D(8, k, s)
  with torch.no_grad():
    layer.kernel.copy_(torch.from_numpy(ker.transpose(3, 2, 0, 1).copy()))
  tx = _nchw(x).contiguous(memory_format=torch.channels_last)
  tx.requires_grad_()
  calls = []
  ref = tdw.depthwise_filter_grad_reference
  tdw.enable_pallas_filter_grad(knob)
  try:
    tdw.depthwise_filter_grad_reference = lambda *a: calls.append(1) or ref(*a)
    torch.sin(layer(tx)).sum().backward()
  finally:
    tdw.depthwise_filter_grad_reference = ref
    tdw.enable_pallas_filter_grad(False)
  assert len(calls) == (1 if knob and s == 1 else 0)
  np.testing.assert_allclose(tx.grad.numpy().transpose(0, 2, 3, 1),
                             np.asarray(g_custom[0]), atol=1e-5, rtol=1e-5)
  np.testing.assert_allclose(layer.kernel.grad.numpy().transpose(2, 3, 1, 0),
                             np.asarray(g_custom[1]), atol=1e-5, rtol=1e-5)


def test_depthwise_conv_valid_padding_and_forward(knob_on):
  """VALID padding takes the library's dW; the forward equals JAX's."""
  rng = np.random.RandomState(2)
  x = rng.randn(2, 9, 10, 4).astype(np.float32)
  ker = rng.randn(3, 3, 1, 4).astype(np.float32)
  want = np.asarray(jdw._dw_forward(x, ker, (1, 1), "VALID"))
  got = tdw.depthwise_conv(_nchw(x), torch.from_numpy(
      ker.transpose(3, 2, 0, 1).copy()), (1, 1), "VALID")
  np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                             atol=1e-5, rtol=1e-5)


def test_knob_default_off_and_layer_dispatch():
  """Off by default; with it off DepthwiseConv2D calls F.conv2d with no
  autograd function around it, with it on the output's grad_fn is
  depthwise_conv's."""
  assert not tdw.pallas_filter_grad_enabled()
  layer = tlayers.DepthwiseConv2D(4, 3, 1)
  torch.nn.init.normal_(layer.kernel)
  x = torch.randn(1, 4, 6, 6)
  off = layer(x)
  assert "Convolution" in type(off.grad_fn).__name__
  tdw.enable_pallas_filter_grad(True)
  try:
    assert tdw.pallas_filter_grad_enabled()
    on = layer(x)
    assert "DepthwiseConv" in type(on.grad_fn).__name__
    torch.testing.assert_close(on, off, rtol=0, atol=0)
  finally:
    tdw.enable_pallas_filter_grad(False)


@pytest.mark.parametrize("on_at_forward", [False, True])
def test_k6_choice_is_made_at_the_forward(on_at_forward):
  """The knob is read when depthwise_conv runs forward: flipping it before
  the backward does not change which dW path the backward takes."""
  x = torch.randn(1, 4, 6, 6).contiguous(memory_format=torch.channels_last)
  ker = torch.randn(4, 1, 3, 3, requires_grad=True)
  calls = []
  ref = tdw.depthwise_filter_grad_reference
  tdw.enable_pallas_filter_grad(on_at_forward)
  try:
    tdw.depthwise_filter_grad_reference = lambda *a: calls.append(1) or ref(*a)
    y = tdw.depthwise_conv(x, ker)
    tdw.enable_pallas_filter_grad(not on_at_forward)
    y.sum().backward()
  finally:
    tdw.depthwise_filter_grad_reference = ref
    tdw.enable_pallas_filter_grad(False)
  assert len(calls) == int(on_at_forward)


def test_kernel_wrapper_refuses_what_it_does_not_take():
  cl = torch.channels_last
  x = torch.randn(1, 4, 5, 5).contiguous(memory_format=cl)
  with pytest.raises(NotImplementedError):
    tdw.depthwise_filter_grad(x, x, 3, stride=2)
  for bad, exc in [((x.double(), x.double(), 3), TypeError),
                   ((x, x, 9), ValueError),
                   ((x.contiguous(), x.contiguous(), 3), ValueError),
                   ((x, x[:, :, :4], 3), ValueError)]:
    with pytest.raises(exc):
      tdw._check_kernel_inputs(*bad)


# ---------------------------------------------------------------------------
# The Hopper K6's routing and tile plan (pure Python; the kernel runs only on
# the card, tests/test_torch_kernels_cuda.py).
# ---------------------------------------------------------------------------

# EfficientDet-D0's stride-1 depthwise convs at 512 x 512, batch 16 (C, H,
# W, k): every map of a training step, 76 calls.
D0_SHAPES = [(32, 256, 256, 3), (144, 128, 128, 3), (64, 64, 64, 3),
             (240, 64, 64, 5), (64, 32, 32, 3), (672, 32, 32, 5),
             (480, 32, 32, 5), (480, 32, 32, 3), (64, 16, 16, 3),
             (1152, 16, 16, 3), (1152, 16, 16, 5), (64, 8, 8, 3),
             (64, 4, 4, 3)]
# Ragged maps, odd batches, C past a chunk, k 1 and 7.
RAGGED_SHAPES = [(3, 40, 15, 17, 5), (2, 40, 9, 70, 7), (1, 8, 5, 6, 1),
                 (5, 24, 4, 4, 3), (16, 64, 3, 5, 3), (2, 64, 300, 7, 3),
                 (7, 136, 33, 31, 3), (1, 2048, 2, 2, 7)]


@pytest.mark.parametrize("dtype,c,want", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 8, True),
    (torch.bfloat16, 1152, True), (torch.bfloat16, 13, False),
    (torch.bfloat16, 4, False), (torch.bfloat16, 60, False),
    (torch.float32, 64, False), (torch.float32, 8, False)])
def test_takes_sm90(dtype, c, want):
  """bf16 with C a multiple of 8 (a pixel's channels 16-byte units, as TMA
  needs) takes the Hopper K6; float32 and other C csrc/depthwise.cu's."""
  assert tdw.takes_sm90(dtype, c) is want


@pytest.mark.parametrize(
    "b,c,h,w,k", [(16, *s) for s in D0_SHAPES] + RAGGED_SHAPES,
    ids=[f"d0_{c}x{h}x{w}_k{k}" for c, h, w, k in D0_SHAPES]
    + [f"ragged_{b}x{c}x{h}x{w}_k{k}" for b, c, h, w, k in RAGGED_SHAPES])
def test_sm90_plan_covers_every_output_once(b, c, h, w, k):
  """The plan's tiles, walked as the kernel walks them (tiles part,
  part + parts, ... of each chunk), cover every (image, row, column) of the
  output once, and its chunks every channel once; the boxes and the ring
  fit TMA's limits and a block's shared memory; parts come in whole
  clusters of at most 8."""
  plan = tdw.sm90_plan(b, c, h, w, k)
  assert plan.cb in (8, 16, 32, 64)
  assert (plan.chunks - 1) * plan.cb < c <= plan.chunks * plan.cb
  assert -(-c // plan.cb) * plan.cb <= 1.1 * c or plan.cb == 8
  assert 1 <= plan.nb <= min(b, 256)
  assert 1 <= plan.th <= h and plan.th + k - 1 <= 256
  assert 1 <= plan.tw <= w and plan.tw + k - 1 <= 256
  assert plan.nb == 1 or (plan.th, plan.tw) == (h, w)
  assert 2 * tdw._stage_bytes(plan.cb, plan.nb, plan.th, plan.tw, k) <= (
      2 * 48 * 1024)
  assert 1 <= plan.cluster <= 8 and plan.parts % plan.cluster == 0
  assert plan.parts <= plan.tiles + plan.cluster - 1
  count = np.zeros((b, h, w), dtype=np.int64)
  for part in range(plan.parts):
    for n0, y0, x0 in tdw.sm90_tile_origins(plan, b, h, w, part):
      count[n0:n0 + plan.nb, y0:y0 + plan.th, x0:x0 + plan.tw] += 1
  assert (count == 1).all()


def test_sm90_plan_fills_the_card():
  """On the H100's 132 SMs a plan that meets at the ticket needs no second
  wave (at most one block per SM); every chunk gets at least 8 parts where
  it has the tiles (one cluster, no ticket, on the maps of 8 chunks or
  more); BiFPN's 4 x 4 and 8 x 8 maps get whole images (no lane idles)."""
  for c, h, w, k in D0_SHAPES:
    plan = tdw.sm90_plan(16, c, h, w, k)
    assert plan.parts * plan.chunks <= 132 or plan.parts == plan.cluster
    assert plan.parts >= min(8, plan.tiles)
    assert (plan.cluster == plan.parts) == (plan.parts <= 8)
  for h in (4, 8):
    plan = tdw.sm90_plan(16, 64, h, h, 3)
    assert (plan.th, plan.tw) == (h, h) and plan.nb > 1


def test_filter_grad_routing_with_stand_in_libraries(monkeypatch):
  """With stand-ins for both libraries: bf16 with C a multiple of 8 reaches
  the Hopper entry point with sm90_plan's tiles (scratch and tickets only
  when more than one cluster serves a chunk), counted in launches_sm90;
  float32, bf16 C 13 and `_simt` reach csrc/depthwise.cu's, each with as
  many arguments as its binding declares. An x TMA cannot read raises
  before any launch or count."""
  calls = []

  def fake(impl, n_args, out=0):
    def fn(*args):
      assert len(args) == n_args, (impl, len(args))
      calls.append((impl, args))
      return out
    return fn

  monkeypatch.setattr(tdw, "_kernel_fns", lambda: (fake("simt", 12),
                                                   lambda *a: 4))
  monkeypatch.setattr(tdw, "_sm90_fn", lambda: fake("sm90", 17))
  monkeypatch.setattr(tdw, "_sms", lambda index: 132)
  monkeypatch.setattr(torch.cuda, "device",
                      lambda device: contextlib.nullcontext())
  monkeypatch.setattr(torch.cuda, "current_stream",
                      lambda device: types.SimpleNamespace(cuda_stream=0))
  f = tdw.depthwise_filter_grad
  cl = torch.channels_last

  def run(b, c, h, w, k, dtype, **kw):
    x = torch.zeros((b, c, h, w), dtype=dtype).contiguous(memory_format=cl)
    calls.clear()
    before = (f.launches, f.launches_sm90)
    out = tdw.depthwise_filter_grad_kernel(x, x, k, **kw)
    assert out.shape == (c, 1, k, k) and out.dtype == torch.float32
    return calls[0][0], calls[0][1], (f.launches - before[0],
                                      f.launches_sm90 - before[1])

  impl, args, counts = run(16, 64, 64, 64, 3, torch.bfloat16)
  plan = tdw.sm90_plan(16, 64, 64, 64, 3)
  assert impl == "sm90" and counts == (1, 1)
  assert args[5:15] == (16, 64, 64, 64, 3, plan.cb, plan.nb, plan.th,
                        plan.tw, plan.parts)
  assert args[15] == plan.cluster and args[2] and args[4]
  impl, args, _ = run(16, 64, 4, 4, 3, torch.bfloat16)
  assert impl == "sm90" and args[2] is None and args[4] is None  # 1 cluster
  for b, c, h, w, k, dtype, kw in ((1, 13, 15, 17, 3, torch.bfloat16, {}),
                                   (2, 64, 8, 8, 3, torch.float32, {}),
                                   (2, 64, 8, 8, 3, torch.bfloat16,
                                    dict(_simt=True))):
    impl, _, counts = run(b, c, h, w, k, dtype, **kw)
    assert impl == "simt" and counts == (1, 0)
  odd = torch.zeros((2 * 8 * 8 * 64 + 4,), dtype=torch.bfloat16)[4:]
  odd = odd.view(2, 8, 8, 64).permute(0, 3, 1, 2)
  calls.clear()
  before = (f.launches, f.launches_sm90)
  with pytest.raises(ValueError, match="16-byte aligned"):
    tdw.depthwise_filter_grad_kernel(odd, odd, 3)
  assert calls == [] and (f.launches, f.launches_sm90) == before
