"""Dataset registry: per-dataset input specs and training-config overlays.

The counterpart of automl_tpu/data/datasets.py, its tables copied (the JAX
module imports the JAX package's config, which loads jax): DatasetSpec
carries the input-side facts (classes, multiclass, splits), and
get_dataset_config(name) returns the training overlay merged with its
dataset's spec. With data_dir None / 'null' build_dataset yields synthetic
batches (the reference's null-input mode); multi-label (ImageNet21k-style)
batches carry padded label-id lists, expanded to dense multi-hot on the
device by multihot_on_device. The TFRecord readers (a data_dir) come with
ROADMAP M9.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from automl_tpu_torch.config import Config
from automl_tpu_torch.data import pipeline


@dataclasses.dataclass(frozen=True)
class SplitSpec:
  num_images: int
  file_pattern: str | None = None


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
  """Input-side facts of a dataset."""
  name: str
  num_classes: int
  multiclass: bool = False
  max_labels: int = 16          # padded multi-hot ids per example (21k)
  default_canvas: int = 260
  splits: dict = dataclasses.field(default_factory=dict)


DATASETS: dict[str, DatasetSpec] = {}


def register_dataset(spec: DatasetSpec):
  DATASETS[spec.name] = spec
  return spec


register_dataset(DatasetSpec(
    "imagenet", num_classes=1000,
    splits=dict(train=SplitSpec(1_281_167, "train-*"),
                minival=SplitSpec(25_021, "train-*"),
                eval=SplitSpec(50_000, "validation-*"))))
register_dataset(DatasetSpec(
    "imagenet21k", num_classes=21843, multiclass=True,
    splits=dict(train=SplitSpec(12_720_275, "imagenet21k*"),
                minival=SplitSpec(25_089, "imagenet21k*"),
                eval=SplitSpec(100_357, "imagenet21k*"))))
register_dataset(DatasetSpec(
    "imagenettfds", num_classes=1000,
    splits=dict(train=SplitSpec(1_281_167, "train-*"),
                minival=SplitSpec(50_000, "validation-*"),
                eval=SplitSpec(50_000, "validation-*"))))
register_dataset(DatasetSpec(
    "cifar10", num_classes=10, default_canvas=48,
    splits=dict(train=SplitSpec(50_000, "cifar10-train*"),
                minival=SplitSpec(10_000, "cifar10-test*"),
                eval=SplitSpec(10_000, "cifar10-test*"))))
register_dataset(DatasetSpec(
    "cifar100", num_classes=100, default_canvas=48,
    splits=dict(train=SplitSpec(50_000, "cifar100-train*"),
                minival=SplitSpec(10_000, "cifar100-test*"),
                eval=SplitSpec(10_000, "cifar100-test*"))))
register_dataset(DatasetSpec(
    "flowers", num_classes=102,
    splits=dict(train=SplitSpec(1_020, "flowers-train*"),
                minival=SplitSpec(1_020, "flowers-val*"),
                eval=SplitSpec(6_149, "flowers-test*"))))
register_dataset(DatasetSpec(
    "tfflowers", num_classes=5,
    splits=dict(train=SplitSpec(3_303, "tfflowers-train*"),
                minival=SplitSpec(367, "tfflowers-val*"),
                eval=SplitSpec(367, "tfflowers-val*"))))
register_dataset(DatasetSpec(
    "cars", num_classes=196,
    splits=dict(train=SplitSpec(8_144, "cars-train*"),
                minival=SplitSpec(8_041, "cars-test*"),
                eval=SplitSpec(8_041, "cars-test*"))))


# ---------------------------------------------------------------------------
# Training-config overlays.
# ---------------------------------------------------------------------------

_DS_CONFIGS: dict[str, Config] = {}


def register_ds_config(name: str, cfg: dict):
  _DS_CONFIGS[name.lower()] = Config(cfg)


register_ds_config("imagenet", dict(
    data=dict(ds_name="imagenet", multiclass=False),
    train=dict(epochs=350, lr_base=0.016, lr_warmup_epoch=5,
               lr_sched="exponential", label_smoothing=0.1),
    eval=dict(batch_size=8),
))
register_ds_config("imagenet21k", dict(
    model=dict(dropout_rate=0.000001, survival_prob=1.0),
    data=dict(ds_name="imagenet21k", multiclass=True, augname=None,
              mixup_alpha=0, cutmix_alpha=0),
    train=dict(epochs=60, lr_base=0.008, lr_warmup_epoch=1,
               lr_sched="cosine", label_smoothing=0.0, isize=224,
               stages=0, loss_type="sigmoid"),
    eval=dict(batch_size=128, isize=224),
))
_FT_BASE = dict(
    model=dict(dropout_rate=0.000001, survival_prob=0.8),
    train=dict(batch_size=512, stages=0, epochs=15, optimizer="rmsprop",
               lr_sched="constant", lr_base=0.0005, lr_warmup_epoch=1,
               ema_decay=0.9996, weight_decay=1e-5, label_smoothing=0.1,
               min_steps=10000, isize=1.0),
    data=dict(augname="ft", mixup_alpha=0, cutmix_alpha=0),
)


def _ft(ds_name: str) -> dict:
  cfg = copy.deepcopy(_FT_BASE)
  cfg["data"]["ds_name"] = ds_name
  return cfg


register_ds_config("imagenetft", _ft("imagenettfds"))
register_ds_config("cifar10ft", _ft("cifar10"))
register_ds_config("cifar100ft", _ft("cifar100"))
register_ds_config("flowersft", _ft("flowers"))
register_ds_config("tfflowersft", _ft("tfflowers"))
register_ds_config("carsft", _ft("cars"))


def dataset_names() -> list[str]:
  return sorted(_DS_CONFIGS)


def get_dataset_config(name: str) -> Config:
  """Training overlay for `name`, with data.{num_classes, multiclass,
  max_labels} filled from its DatasetSpec."""
  key = name.lower()
  if key not in _DS_CONFIGS:
    raise KeyError(f"Unknown dataset config {name!r}; "
                   f"available: {dataset_names()}")
  cfg = copy.deepcopy(_DS_CONFIGS[key])
  spec = DATASETS[cfg.data.ds_name]
  cfg.data.update(dict(num_classes=spec.num_classes,
                       multiclass=spec.multiclass,
                       max_labels=spec.max_labels))
  return cfg


# ---------------------------------------------------------------------------
# Loaders.
# ---------------------------------------------------------------------------


class SyntheticMultiLabel:
  """Synthetic 21k-style batches: padded label-id lists (ids, pad -1), a
  new batch each step from one numpy stream."""

  def __init__(self, batch_size: int, image_size: int, num_classes: int,
               max_labels: int = 16, seed: int = 0):
    self.b, self.s, self.k = batch_size, image_size, num_classes
    self.max_labels = max_labels
    self.rng = np.random.RandomState(seed)

  def __iter__(self):
    while True:
      ids = np.full((self.b, self.max_labels), -1, np.int32)
      for i in range(self.b):
        n = self.rng.randint(1, 4)
        ids[i, :n] = self.rng.randint(0, self.k, n)
      yield {
          "image": self.rng.randint(0, 256, (self.b, self.s, self.s, 3),
                                    np.uint8),
          "label_ids": ids,
      }


def multihot_on_device(label_ids, num_classes: int):
  """[B, K] padded ids (-1 pad) -> [B, num_classes] f32 multi-hot, on the
  ids' device (a scatter: no [num_classes, num_classes] eye)."""
  ids = torch.as_tensor(label_ids).long()
  out = torch.zeros((ids.shape[0], num_classes), dtype=torch.float32,
                    device=ids.device)
  valid = (ids >= 0) & (ids < num_classes)
  out.scatter_add_(1, torch.where(valid, ids, torch.zeros_like(ids)),
                   valid.float())
  return torch.clamp(out, max=1.0)


def build_dataset(config, split: str, batch_size: int,
                  canvas_size: int | None = None, shard_index: int = 0,
                  num_shards: int = 1):
  """Host iterator for `config.data` (train / minival / eval split):
  synthetic batches with data_dir None or 'null'. TFRecords under a
  data_dir (and shards) need the readers of ROADMAP M9."""
  spec = DATASETS[config.data.ds_name]
  canvas = canvas_size or spec.default_canvas
  data_dir = config.data.get("data_dir")
  if data_dir and data_dir != "null":
    raise NotImplementedError(
        "TFRecord input (data.data_dir) is not ported to automl_tpu_torch "
        "yet: ROADMAP M9")
  del split, shard_index, num_shards
  if spec.multiclass:
    return SyntheticMultiLabel(batch_size, canvas, spec.num_classes,
                               spec.max_labels)
  return pipeline.SyntheticClassification(batch_size, canvas,
                                          spec.num_classes)
