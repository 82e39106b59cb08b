"""COCO JSON -> sharded TFRecords (automl_tpu/cli/create_coco_tfrecord.py;
its records byte for byte).

Schema parity: efficientdet/dataset/create_coco_tfrecord.py:15-50 standard
keys (image/encoded, image/source_id, image/object/bbox/{ymin,xmin,ymax,xmax}
normalized, image/object/class/label, image/object/is_crowd, image/object/area).
Uses the port's own Example builder and TFRecord writer (no TF).

Example:
  python -m automl_tpu_torch.cli.create_coco_tfrecord \
    --image_dir=val2017 --object_annotations_file=instances_val2017.json \
    --output_file_prefix=/tmp/coco/val --num_shards=8
"""

from __future__ import annotations

import argparse
import collections
import json
import os

from automl_tpu_torch.data.native_loader import TFRecordWriter, build_example


def coco_annotations_to_examples(image_dir: str, annotations_file: str):
  """Yield serialized tf.train.Examples for each image in the COCO json."""
  with open(annotations_file) as f:
    coco = json.load(f)
  anns_by_image = collections.defaultdict(list)
  for ann in coco.get("annotations", []):
    anns_by_image[ann["image_id"]].append(ann)

  for img in coco["images"]:
    path = os.path.join(image_dir, img["file_name"])
    with open(path, "rb") as f:
      encoded = f.read()
    h, w = float(img["height"]), float(img["width"])
    xmin, xmax, ymin, ymax, labels, crowd, area = [], [], [], [], [], [], []
    for ann in anns_by_image[img["id"]]:
      x, y, bw, bh = ann["bbox"]
      xmin.append(x / w)
      xmax.append((x + bw) / w)
      ymin.append(y / h)
      ymax.append((y + bh) / h)
      labels.append(int(ann["category_id"]))
      crowd.append(int(ann.get("iscrowd", 0)))
      area.append(float(ann.get("area", bw * bh)))
    yield build_example({
        "image/encoded": [encoded],
        "image/filename": [img["file_name"]],
        "image/source_id": [str(img["id"])],
        "image/height": [int(h)],
        "image/width": [int(w)],
        "image/format": [b"jpeg"],
        "image/object/bbox/xmin": [float(v) for v in xmin],
        "image/object/bbox/xmax": [float(v) for v in xmax],
        "image/object/bbox/ymin": [float(v) for v in ymin],
        "image/object/bbox/ymax": [float(v) for v in ymax],
        "image/object/class/label": labels,
        "image/object/is_crowd": crowd,
        "image/object/area": area,
    })


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument("--image_dir", required=True)
  p.add_argument("--object_annotations_file", required=True)
  p.add_argument("--output_file_prefix", required=True)
  p.add_argument("--num_shards", type=int, default=32)
  args = p.parse_args(argv)

  os.makedirs(os.path.dirname(args.output_file_prefix) or ".", exist_ok=True)
  writers = [
      TFRecordWriter(f"{args.output_file_prefix}-{i:05d}-of-"
                     f"{args.num_shards:05d}.tfrecord")
      for i in range(args.num_shards)]
  count = 0
  for example in coco_annotations_to_examples(
      args.image_dir, args.object_annotations_file):
    writers[count % args.num_shards].write(example)
    count += 1
  for w in writers:
    w.close()
  print(f"wrote {count} examples to {args.num_shards} shards")
  return count


if __name__ == "__main__":
  main()
