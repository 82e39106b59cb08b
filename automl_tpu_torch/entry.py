"""entry(): EfficientDet-D0 inference as one callable, the counterpart of
__graft_entry__.py::entry.

  fn, (images,) = entry()               # on the card; entry("cpu") here
  boxes, scores, classes, valid_len = fn(images)

D0 under the mixed_bfloat16 policy (set process-wide, as JAX's entry
does), weights drawn from seed 0 in the JAX layout
(convert.det_numpy_init) or copied from a JAX-layout numpy tree
(convert.load_det_params). fn takes NHWC float32 images, already
normalised as the model expects, and runs the forward in eval mode and
postprocess_global, all on the model's device. The example input is
zeros [1, 512, 512, 3] (the config's image size).
"""

from __future__ import annotations

import torch

from automl_tpu_torch import convert
from automl_tpu_torch.models.efficientdet import build_detection_model
from automl_tpu_torch.nn import precision
from automl_tpu_torch.ops import anchors, postprocess


def entry(device=None, params=None, config=None):
  """-> (fn, (example_images,)). device: default "cuda"; params: a
  JAX-layout tree, default det_numpy_init(model, 0); config: an
  EfficientDet config, default efficientdet-d0's (tests take smaller
  ones)."""
  device = torch.device(device or "cuda")
  precision.set_policy("mixed_bfloat16")
  model = build_detection_model(config or "efficientdet-d0", device=device)
  convert.load_det_params(model, params if params is not None
                          else convert.det_numpy_init(model, 0))
  h, w = anchors.parse_image_size(model.config.image_size)
  images = torch.zeros((1, h, w, 3), dtype=torch.float32, device=device)

  @torch.no_grad()
  def forward(images):
    cls_outputs, box_outputs = model(images.permute(0, 3, 1, 2), train=False)
    return postprocess.postprocess_global(model.config, cls_outputs,
                                          box_outputs)

  return forward, (images,)
