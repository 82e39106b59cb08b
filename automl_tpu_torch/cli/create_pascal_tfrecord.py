"""PASCAL VOC XML annotations -> sharded TFRecords
(automl_tpu/cli/create_pascal_tfrecord.py; its records byte for byte).

Schema parity with efficientdet/dataset/create_pascal_tfrecord.py (same
standard keys as the COCO converter). Uses stdlib xml.etree (the reference
needs lxml).

Example:
  python -m automl_tpu_torch.cli.create_pascal_tfrecord \
    --data_dir=VOCdevkit/VOC2012 --set=train \
    --output_path=/tmp/voc/train --num_shards=8
"""

from __future__ import annotations

import argparse
import os
import xml.etree.ElementTree as ET

from automl_tpu_torch.data.native_loader import TFRecordWriter, build_example
from automl_tpu_torch.inference.label_util import voc as VOC_LABELS

_NAME_TO_ID = {name: cid for cid, name in VOC_LABELS.items()}


def voc_xml_to_example(xml_path: str, image_dir: str,
                       source_id: int) -> bytes:
  root = ET.parse(xml_path).getroot()
  filename = root.findtext("filename")
  with open(os.path.join(image_dir, filename), "rb") as f:
    encoded = f.read()
  size = root.find("size")
  w = float(size.findtext("width"))
  h = float(size.findtext("height"))
  xmin, xmax, ymin, ymax, labels, difficult = [], [], [], [], [], []
  for obj in root.findall("object"):
    name = obj.findtext("name")
    if name not in _NAME_TO_ID:
      continue
    box = obj.find("bndbox")
    xmin.append(float(box.findtext("xmin")) / w)
    xmax.append(float(box.findtext("xmax")) / w)
    ymin.append(float(box.findtext("ymin")) / h)
    ymax.append(float(box.findtext("ymax")) / h)
    labels.append(_NAME_TO_ID[name])
    difficult.append(int(obj.findtext("difficult", "0")))
  return build_example({
      "image/encoded": [encoded],
      "image/filename": [filename],
      "image/source_id": [str(source_id)],
      "image/height": [int(h)],
      "image/width": [int(w)],
      "image/format": [b"jpeg"],
      "image/object/bbox/xmin": xmin,
      "image/object/bbox/xmax": xmax,
      "image/object/bbox/ymin": ymin,
      "image/object/bbox/ymax": ymax,
      "image/object/class/label": labels,
      "image/object/is_crowd": [0] * len(labels),
      "image/object/difficult": difficult,
  })


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument("--data_dir", required=True, help="VOC year dir")
  p.add_argument("--set", default="train",
                 choices=["train", "val", "trainval", "test"])
  p.add_argument("--annotations_dir", default="Annotations")
  p.add_argument("--output_path", required=True)
  p.add_argument("--num_shards", type=int, default=8)
  args = p.parse_args(argv)

  list_file = os.path.join(args.data_dir, "ImageSets", "Main",
                           f"{args.set}.txt")
  with open(list_file) as f:
    names = [line.strip().split()[0] for line in f if line.strip()]
  image_dir = os.path.join(args.data_dir, "JPEGImages")
  ann_dir = os.path.join(args.data_dir, args.annotations_dir)

  os.makedirs(os.path.dirname(args.output_path) or ".", exist_ok=True)
  writers = [TFRecordWriter(
      f"{args.output_path}-{i:05d}-of-{args.num_shards:05d}.tfrecord")
      for i in range(args.num_shards)]
  for i, name in enumerate(names):
    example = voc_xml_to_example(
        os.path.join(ann_dir, f"{name}.xml"), image_dir, source_id=i)
    writers[i % args.num_shards].write(example)
  for w in writers:
    w.close()
  print(f"wrote {len(names)} examples to {args.num_shards} shards")
  return len(names)


if __name__ == "__main__":
  main()
