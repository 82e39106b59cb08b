"""Inspect detection TFRecords: per-dataset stats and annotated sample
PNGs (automl_tpu/cli/inspect_tfrecords.py's flags), over the TF-free
reader (data/pipeline.py::DetectionTFRecordLoader) and
inference/visualize.py. Host only: no device.

Examples:
  python -m automl_tpu_torch.cli.inspect_tfrecords \\
      --file_pattern="val*.tfrecord" --save_samples_dir=/tmp/samples \\
      --num_samples=4
  python -m automl_tpu_torch.cli.inspect_tfrecords --file_pattern=... \\
      --eval       # eval-mode parsing: crowds kept, no shuffle
"""

from __future__ import annotations

import argparse
import collections
import os


def parse_args(argv=None):
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument("--file_pattern", required=True)
  p.add_argument("--num_samples", type=int, default=10,
                 help="records to scan (and images to dump if saving)")
  p.add_argument("--save_samples_dir", default=None,
                 help="write annotated PNGs here")
  p.add_argument("--canvas_size", type=int, default=640,
                 help="host-loader canvas resolution for the dumped images")
  p.add_argument("--max_instances", type=int, default=100)
  p.add_argument("--eval", action="store_true",
                 help="eval-mode parsing (keep crowds, no shuffle)")
  p.add_argument("--label_map", default="coco",
                 help="label map name or yaml path for class names")
  return p.parse_args(argv)


def inspect(file_pattern: str, num_samples: int = 10,
            save_samples_dir: str | None = None, canvas_size: int = 640,
            max_instances: int = 100, is_training: bool = False,
            label_map="coco") -> dict:
  """Scans records; returns the stats; optionally dumps annotated PNGs
  (record_<i>.png, the ground truth drawn on the loader's canvas)."""
  import numpy as np
  from automl_tpu_torch.data import pipeline
  from automl_tpu_torch.inference import visualize

  loader = pipeline.DetectionTFRecordLoader(
      file_pattern, is_training=is_training, batch_size=1,
      canvas_size=canvas_size, max_instances=max_instances)
  class_counts: collections.Counter = collections.Counter()
  boxes_per_image = []
  if save_samples_dir:
    os.makedirs(save_samples_dir, exist_ok=True)
  it = iter(loader)
  seen = 0
  for i in range(num_samples):
    try:
      rec = next(it)
    except StopIteration:
      break
    seen += 1
    classes = rec["gt_classes"][0]
    valid = classes >= 0
    boxes_per_image.append(int(valid.sum()))
    for cid in classes[valid]:
      class_counts[int(cid)] += 1
    if save_samples_dir:
      img = visualize.visualize_image(
          rec["image"][0], rec["gt_boxes"][0][valid], classes[valid],
          np.ones(int(valid.sum()), np.float32), label_map=label_map,
          min_score_thresh=0.0)
      visualize.save_image_array_as_png(
          img, os.path.join(save_samples_dir, f"record_{i}.png"))
  return {
      "records_scanned": seen,
      "boxes_per_image_mean": (float(np.mean(boxes_per_image))
                               if boxes_per_image else 0.0),
      "boxes_per_image_max": max(boxes_per_image, default=0),
      "class_histogram": dict(sorted(class_counts.items())),
  }


def main(argv=None):
  args = parse_args(argv)
  stats = inspect(args.file_pattern, args.num_samples, args.save_samples_dir,
                  args.canvas_size, args.max_instances,
                  is_training=not args.eval, label_map=args.label_map)
  print(f"records scanned: {stats['records_scanned']}")
  print(f"boxes/image: mean {stats['boxes_per_image_mean']:.1f} "
        f"max {stats['boxes_per_image_max']}")
  print("class histogram (id: count):")
  for cid, cnt in stats["class_histogram"].items():
    print(f"  {cid}: {cnt}")
  if args.save_samples_dir:
    print(f"annotated samples in {args.save_samples_dir}")
  return stats


if __name__ == "__main__":
  main()
