"""VLM quality filters (Gemma-style vision-language judging; counterpart of
`s3od_tpu/datagen/filters/vlm.py`).

Reference (`data_generation/filters/vlm_filter.py`): Gemma-3-4b-it judges
(a) whether a clear salient object exists and the mask covers it, from an
[image | red-overlay] panel, and (b) whether the mask is fragmented or has
artifacts, from a mask-only render. Responses are JSON-parsed with a keyword
fallback; the model loads lazily.

Here the VLM is pluggable: `transformers` (any image-text-to-text
checkpoint, e.g. google/gemma-3-4b-it) loaded lazily from a LOCAL
directory (nothing is downloaded) onto the filter's device ("cuda" by
default); when no VLM can load (no such directory, no transformers) the
filter logs it once and judges by fast geometric heuristics, so the chain
still runs offline (fragmentation/coverage statistics on the mask
itself). Every result's metadata says which judge ran (`"heuristic"`).

The artifact heuristic counts 8-connected components (scipy's `label`
with a 3 x 3 structure), which is what the JAX package computes through
OpenCV's `connectedComponentsWithStats`; its scipy fallback counts
4-connected ones, so two parts touching only at a corner differ there.
"""

from __future__ import annotations

import json
import logging
import re
from pathlib import Path
from typing import Optional

import numpy as np

from s3od_torch.datagen.filtering import BaseFilter, FilterResult, Sample


def _overlay_panel(image: np.ndarray, mask: np.ndarray) -> np.ndarray:
    overlay = image.copy()
    m = mask > 127
    overlay[m] = (0.5 * overlay[m] + 0.5 * np.array([255, 0, 0])).astype(np.uint8)
    return np.concatenate([image, overlay], axis=1)


def _parse_json(text: str) -> Optional[dict]:
    """Extract the first {...} JSON object, tolerating ```json fences
    (reference `vlm_filter.py:176-193`)."""
    text = text.replace("```json", "").replace("```", "").strip()
    try:
        m = re.search(r"\{.*\}", text, re.DOTALL)
        if m:
            data = json.loads(m.group(0))
            if isinstance(data, dict):
                return data
    except json.JSONDecodeError:
        pass
    return None


def _as_bool(v, default: Optional[bool] = None) -> Optional[bool]:
    if isinstance(v, bool):
        return v
    if isinstance(v, str):
        return v.strip().lower() in ("yes", "true", "good", "pass")
    return default


def _keyword_verdict(text: str) -> Optional[bool]:
    low = text.lower()
    if any(w in low for w in ("yes", "good", "acceptable", "pass", "true")):
        return True
    if any(w in low for w in ("no", "bad", "poor", "fail", "false")):
        return False
    return None


class _LazyVLM:
    """Lazily-constructed transformers image-text-to-text pipeline on
    `device`, from a local checkpoint directory only."""

    def __init__(self, model_id: str, device: str = "cuda"):
        self.model_id = model_id
        self.device = device
        self._pipe = None
        self._failed = False

    def ask(self, image: np.ndarray, prompt: str) -> Optional[str]:
        if self._failed:
            return None
        if self._pipe is None:
            try:
                if not Path(self.model_id).is_dir():
                    raise FileNotFoundError(
                        "not a local checkpoint directory (nothing is "
                        "downloaded)")
                from transformers import pipeline

                self._pipe = pipeline("image-text-to-text",
                                      model=self.model_id, device=self.device)
            except Exception as e:  # model unavailable (offline etc.)
                logging.warning("VLM %s unavailable (%s); using heuristics",
                                self.model_id, e)
                self._failed = True
                return None
        from PIL import Image

        messages = [
            {
                "role": "user",
                "content": [
                    {"type": "image", "image": Image.fromarray(image)},
                    {"type": "text", "text": prompt},
                ],
            }
        ]
        out = self._pipe(text=messages, max_new_tokens=64)
        return out[0]["generated_text"][-1]["content"]


class GemmaSemanticFilter(BaseFilter):
    """Salient-object presence + mask coverage (`vlm_filter.py:101-132`).

    The JSON contract is the reference's: {"has_salient_object",
    "covers_object", "confidence"}; pass requires BOTH booleans
    (`vlm_filter.py:215-219`). Coverage criterion: red overlay captures
    >70% of the main object, not mostly background."""

    PROMPT = (
        "You are evaluating image segmentation for semantic correctness.\n"
        "The 2-panel image shows LEFT: the original image, RIGHT: the same "
        "image with the segmentation mask overlaid in red.\n"
        "Respond with ONLY this JSON format:\n"
        '{"has_salient_object": true/false, "covers_object": true/false, '
        '"confidence": 0.0-1.0}\n'
        "has_salient_object: is there a clear, distinct main foreground "
        "object that should be segmented (not a pure landscape, texture, "
        "or empty background)?\n"
        "covers_object: does the red area cover the majority (>70%) of the "
        "main object and follow its boundaries reasonably, rather than "
        "missing major parts or capturing mostly background?\n"
        "Focus on overall semantic correctness, not fine details."
    )

    def __init__(self, name: str = "semantic_quality",
                 model_id: str = "google/gemma-3-4b-it",
                 min_coverage: float = 0.02, max_coverage: float = 0.95,
                 device: str = "cuda"):
        super().__init__(name)
        self.vlm = _LazyVLM(model_id, device)
        self.min_coverage = min_coverage
        self.max_coverage = max_coverage

    def filter(self, sample: Sample) -> FilterResult:
        image = sample.load_image()
        mask = sample.load_mask()
        answer = self.vlm.ask(_overlay_panel(image, mask), self.PROMPT)
        if answer is not None:
            data = _parse_json(answer)
            if data is not None:
                has_obj = _as_bool(data.get("has_salient_object"), False)
                covers = _as_bool(data.get("covers_object"), False)
                verdict = bool(has_obj and covers)
            else:
                verdict = _keyword_verdict(answer)
            if verdict is not None:
                return FilterResult(
                    passed=verdict,
                    reason=None if verdict else "VLM rejected semantics",
                    metadata={"vlm_answer": answer[:200], "heuristic": False},
                )
        # Heuristic fallback: reasonable foreground coverage.
        cov = float((mask > 127).mean())
        passed = self.min_coverage <= cov <= self.max_coverage
        return FilterResult(
            passed=passed,
            reason=None if passed else f"coverage {cov:.3f} out of range",
            score=cov,
            metadata={"coverage": cov, "heuristic": True},
        )


class GemmaMaskArtifactFilter(BaseFilter):
    """Mask fragmentation / artifact check (`vlm_filter.py:328-361`).

    JSON contract: {"is_clean_mask": true/false, "confidence": 0.0-1.0};
    fail on severe fragmentation (>10 disconnected blobs), salt-and-pepper
    noise, or hole-riddled regions; pass 1-5 solid components with minor
    roughness."""

    PROMPT = (
        "You are evaluating ONLY segmentation-mask quality for artifacts.\n"
        "The image is a binary mask (white = object, black = background).\n"
        "Respond with ONLY this JSON format:\n"
        '{"is_clean_mask": true/false, "confidence": 0.0-1.0}\n'
        "Mark FALSE for severe fragmentation (more than 10 disconnected "
        "white blobs), salt-and-pepper noise, or large white regions full "
        "of black holes. Mark TRUE for 1-5 solid connected components with "
        "only minor edge roughness or a few small extra pieces. Be strict "
        "about obvious fragmentation but accept minor imperfections."
    )

    def __init__(self, name: str = "mask_artifacts",
                 model_id: str = "google/gemma-3-4b-it",
                 max_components: int = 4, min_main_fraction: float = 0.8,
                 device: str = "cuda"):
        super().__init__(name)
        self.vlm = _LazyVLM(model_id, device)
        self.max_components = max_components
        self.min_main_fraction = min_main_fraction

    def filter(self, sample: Sample) -> FilterResult:
        mask = sample.load_mask()
        rgb = np.stack([mask] * 3, axis=-1)
        answer = self.vlm.ask(rgb, self.PROMPT)
        if answer is not None:
            data = _parse_json(answer)
            if data is not None:
                verdict = _as_bool(data.get("is_clean_mask"), False)
            else:
                verdict = _keyword_verdict(answer)
            if verdict is not None:
                return FilterResult(
                    passed=verdict,
                    reason=None if verdict else "VLM found mask artifacts",
                    metadata={"vlm_answer": answer[:200], "heuristic": False},
                )
        # Heuristic fallback: connected-component analysis.
        binary = (mask > 127).astype(np.uint8)
        if binary.sum() == 0:
            return FilterResult(passed=False, reason="empty mask",
                                metadata={"heuristic": True})
        n, areas = components_8(binary)
        main_frac = areas[0] / sum(areas)
        passed = (n - 1) <= self.max_components and main_frac >= self.min_main_fraction
        return FilterResult(
            passed=passed,
            reason=None if passed else
            f"{n - 1} components, main fraction {main_frac:.2f}",
            score=main_frac,
            metadata={"components": int(n - 1), "main_fraction": float(main_frac),
                      "heuristic": True},
        )


def components_8(binary: np.ndarray):
    """8-connected components of a binary mask -> (count including the
    background, areas sorted descending): OpenCV's
    `connectedComponentsWithStats` (connectivity 8), which the JAX filter
    calls."""
    from scipy import ndimage

    labels, n_lab = ndimage.label(binary, structure=np.ones((3, 3), int))
    return n_lab + 1, sorted(np.bincount(labels.ravel())[1:], reverse=True)
