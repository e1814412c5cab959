"""VLM caption + tag generation for datasets (counterpart of
`s3od_tpu/datagen/generate_metadata.py`).

Covers two reference components with one CLI:
- `model_training/generate_test_metadata.py` (captions/tags for the test
  datasets, required by teacher evaluation), and
- `data_generation/flux_finetune/{generate_captions,tag_data}.py` (the same
  over the real training sets DIS-TR/HRSOD-TR/UHRSD-TR/DUTS-TR for LoRA
  finetuning).

VLM: lazy transformers image-text-to-text model (Gemma-3-4b-it by default)
from a local checkpoint directory, on `--device` ("cuda" by default;
`filters/vlm._LazyVLM`); an offline fallback emits generic captions /
stem-derived tags so downstream tooling stays runnable.

Output format matches the reference consumer (`compute_metrics.py:16-39`):
`{out}/{dataset}/captions.json` = [{"image_path", "caption"}, ...] and
`tags.json` = [{"image_path", "tag"}, ...].

Usage:
    python -m s3od_torch.datagen.generate_metadata --input_dir DIR \
        --output_dir META --datasets DUTS-TE,DUT-OMRON [--model_id ...]
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from typing import List

import numpy as np

from s3od_torch.datagen.filters.vlm import _LazyVLM
from s3od_torch.datagen.sharding import detect_task, task_slice

# Test-set registry of the reference metadata generator
# (`generate_test_metadata.py:25-27`).
DIS_DATASETS = ["DIS-TE1", "DIS-TE2", "DIS-TE3", "DIS-TE4", "DIS-VD"]
SOD_DATASETS = ["HRSOD-TE", "UHRSD-TE", "ECSSD", "DUTS-TE", "HKU-IS",
                "DUT-OMRON", "DAVIS-S"]
TRAIN_DATASETS = ["DIS-TR", "HRSOD-TR", "UHRSD-TR", "DUTS-TR"]


def resolve_datasets(spec: str) -> List[str]:
    groups = {"dis": DIS_DATASETS, "sod": SOD_DATASETS,
              "all": DIS_DATASETS + SOD_DATASETS, "train": TRAIN_DATASETS}
    if spec in groups:
        return groups[spec]
    return [d.strip() for d in spec.split(",")]


# Prompt contracts from the reference (`generate_test_metadata.py:64-130`):
# captions are 1-2 sentences covering subjects/colors/composition/setting;
# tags are 1-2 word HIGH-LEVEL class names (no articles or adjectives).
CAPTION_PROMPT = (
    "You are an expert image captioning model. Analyze the image and give "
    "a detailed, accurate description that: is 1-2 sentences long; "
    "describes the main subjects, objects, and scene elements; includes "
    "relevant details about colors, composition, and setting; focuses on "
    "what is actually visible. Provide only the caption without any "
    "additional text."
)
TAG_PROMPT = (
    "You are an expert object detection model. Identify the main "
    "foreground object and give a short, high-level class name: 1-2 words "
    "maximum, a high-level category (e.g. 'dog' not 'labrador'), the most "
    "prominent/central subject if several, simple common English words, "
    "no articles or descriptive adjectives. Respond with ONLY the object "
    "class name, nothing else."
)


def _fallback_tag(stem: str) -> str:
    """Derive a tag from the filename when no VLM is available (dataset
    files are often named after their class)."""
    words = [w for w in stem.replace("-", "_").split("_") if w.isalpha()]
    return " ".join(words[:2]) if words else "object"


class MetadataGenerator:
    def __init__(self, model_id: str = "google/gemma-3-4b-it",
                 device: str = "cuda"):
        self.vlm = _LazyVLM(model_id, device)

    def caption(self, image: np.ndarray, stem: str) -> str:
        ans = self.vlm.ask(image, CAPTION_PROMPT)
        if ans:
            return ans.strip()
        return "a photo with a single salient foreground object"

    def tag(self, image: np.ndarray, stem: str) -> str:
        ans = self.vlm.ask(image, TAG_PROMPT)
        if ans:
            return ans.strip().splitlines()[0][:40]
        return _fallback_tag(stem)


def process_dataset(
    dataset_dir: Path, out_dir: Path, gen: MetadataGenerator,
    task_id: int = 0, num_tasks: int = 1,
) -> int:
    from PIL import Image

    images = sorted((dataset_dir / "images").glob("*"))
    images = task_slice(images, task_id, num_tasks)
    out_dir.mkdir(parents=True, exist_ok=True)
    captions, tags = [], []
    # Concurrent SLURM-array tasks each write their OWN shard file (a
    # shared captions.json read-modify-written by N tasks loses every
    # task's entries but the last writer's); `load_metadata` merges
    # `captions*.json`, so shards never need a separate merge step.
    suffix = f".task{task_id:04d}" if num_tasks > 1 else ""
    cap_file = out_dir / f"captions{suffix}.json"
    tag_file = out_dir / f"tags{suffix}.json"
    if cap_file.exists():  # resume: merge existing entries
        captions = json.loads(cap_file.read_text())
    if tag_file.exists():
        tags = json.loads(tag_file.read_text())
    done = {c["image_path"] for c in captions}

    for img_path in images:
        key = str(img_path)
        if key in done:
            continue
        try:
            image = np.array(Image.open(img_path).convert("RGB"))
        except Exception as e:  # noqa: BLE001
            logging.error("failed to read %s: %s", img_path, e)
            continue
        captions.append({"image_path": key,
                         "caption": gen.caption(image, img_path.stem)})
        tags.append({"image_path": key, "tag": gen.tag(image, img_path.stem)})

    cap_file.write_text(json.dumps(captions, indent=1))
    tag_file.write_text(json.dumps(tags, indent=1))
    return len(captions)


def main(argv: List[str] = None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--input_dir", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--datasets", required=True,
                    help="comma-separated dataset dir names, or a group: "
                         "dis | sod | all | train")
    ap.add_argument("--model_id", default="google/gemma-3-4b-it")
    ap.add_argument("--task_id", type=int, default=None)
    ap.add_argument("--num_tasks", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    gen = MetadataGenerator(args.model_id, args.device)
    tid, ntasks = detect_task(args.task_id, args.num_tasks)
    for ds in resolve_datasets(args.datasets):
        n = process_dataset(
            Path(args.input_dir) / ds, Path(args.output_dir) / ds, gen,
            tid, ntasks,
        )
        print(f"{ds}: {n} entries")


if __name__ == "__main__":
    main()
