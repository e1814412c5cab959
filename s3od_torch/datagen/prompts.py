"""Prompt generation for the synthetic-image factory.

Reference (`data_generation/prompt_generator.py`): an LLM (GPT-4o via
langchain) produces N diverse photorealistic prompts per ImageNet class; a
`PromptEnhancer` stochastically appends color/clarity/lighting/complexity
terms. Here the LLM call is a pluggable backend (an OpenAI-compatible
endpoint if configured, else a deterministic template fallback so the
factory runs offline), and the enhancer is a faithful functional equivalent.

The port's own copy of `s3od_tpu/datagen/prompts.py` (which imports no
jax): the port imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Callable, List, Optional


class PromptEnhancer:
    """Stochastic prompt suffixes (`prompt_generator.py:9-55`).

    The term lists and per-group probabilities are the reference's exact
    FLUX-bias countermeasures (config constants: daylight/neutral color
    terms against the brownish bias, deep-depth-of-field terms against
    bokeh) — the paper's synthetic-data recipe depends on them."""

    COLOR = [
        "natural colors", "vibrant colors", "true colors",
        "balanced color temperature", "daylight color balance",
        "neutral white balance", "clear colors",
    ]
    CLARITY = [
        "sharp details", "clear image", "no filter", "natural lighting",
        "unprocessed", "raw photo style", "clean image",
    ]
    LIGHTING = [
        "bright daylight", "cool lighting", "blue hour lighting",
        "overcast lighting", "studio lighting", "fluorescent lighting",
        "LED lighting",
    ]
    COMPLEXITY = [
        "sharp focus throughout", "everything in focus",
        "deep depth of field", "no bokeh", "complex background",
        "detailed background", "cluttered scene", "busy environment",
        "multiple objects", "overlapping elements", "textured surfaces",
    ]
    # (group, probability) in the reference's application order.
    GROUPS = (
        (COLOR, 0.3), (CLARITY, 0.25), (LIGHTING, 0.2), (COMPLEXITY, 0.25),
    )

    def __init__(self, p_each: Optional[float] = None,
                 seed: Optional[int] = None):
        self.p_each = p_each  # None -> the reference's per-group values
        self.rng = random.Random(seed)

    def enhance(self, prompt: str) -> str:
        extras = []
        for group, p in self.GROUPS:
            if self.rng.random() < (self.p_each if self.p_each is not None else p):
                extras.append(self.rng.choice(group))
        return ", ".join([prompt] + extras) if extras else prompt


_TEMPLATES = [
    "a photograph of a {cls} in its natural environment",
    "a professional photo of a {cls}, centered composition",
    "a candid shot of a {cls} outdoors",
    "a close-up photograph of a {cls}",
    "a {cls} photographed against a contrasting background",
    "an environmental portrait of a {cls} in context",
    "a high-resolution photo of a {cls} from a low angle",
    "a {cls} in an urban setting, street photography",
    "a {cls} photographed from above",
    "a detailed studio photograph of a single {cls}",
]


def template_prompts(class_name: str, n: int, seed: int = 0) -> List[str]:
    """Deterministic offline fallback: template rotation + enhancement."""
    enh = PromptEnhancer(seed=seed)
    rng = random.Random(seed)
    templates = list(_TEMPLATES)  # copy: never mutate the module global,
    out = []                      # or determinism depends on call history
    for i in range(n):
        base = templates[i % len(templates)].format(cls=class_name)
        out.append(enh.enhance(base))
        rng.shuffle(templates)
    return out


def _parse_prompt_list(text: str) -> List[str]:
    """Parse the LLM's Python-list response (the reference evals the
    bracketed slice, `prompt_generator.py:111-117`; we use literal_eval
    with a line-split fallback)."""
    import ast

    start, end = text.find("["), text.rfind("]") + 1
    if 0 <= start < end:
        try:
            parsed = ast.literal_eval(text[start:end])
            if isinstance(parsed, list):
                return [str(p).strip() for p in parsed if str(p).strip()]
        except (ValueError, SyntaxError):
            pass
    return [ln.strip().strip('",') for ln in text.splitlines() if ln.strip()]


class ImagePromptGenerator:
    """LLM-backed prompt generation with offline fallback.

    `llm_fn(system, user) -> str` is any chat-completion callable (e.g. an
    OpenAI-compatible client); absent, templates are used.
    """

    SYSTEM = (
        "You are a helpful assistant that generates image prompts for a "
        "salient object detection synthetic data generation pipeline."
    )
    # The reference's diversity contract (`prompt_generator.py:63-93`):
    # photorealistic only, sharp focus, varied object count/size/position,
    # mixed scene complexity, lighting/environment/perspective/context
    # diversity, some occlusion/camouflage challenges; returned as a
    # Python list literal.
    USER_TEMPLATE = (
        "Generate exactly {n} diverse, photorealistic prompts for "
        "{cls} images for salient object detection. Create natural scenes "
        "with varying complexity levels.\n"
        "Requirements: photorealistic scenes only (no artistic or cartoon "
        "styles); main object clearly visible and identifiable; sharp "
        "focus throughout; natural lighting and environments.\n"
        "Vary across prompts: object sizes, positions, quantities (1-3), "
        "conditions and orientations; simple through cluttered "
        "backgrounds; daylight, golden hour, overcast, indoor lighting; "
        "indoor/outdoor environments and natural habitats; some partial "
        "occlusion, similar colors, reflective surfaces or camouflage "
        "where natural; close-ups through wide views and varied camera "
        "angles; objects in use, at rest, in groups, across weather and "
        "times of day. Maximize diversity — avoid repetitive scenarios.\n"
        'Return exactly {n} prompts as a Python list: '
        '["A scene description...", ...]'
    )

    def __init__(self, llm_fn: Optional[Callable[[str, str], str]] = None,
                 seed: int = 0):
        self.llm_fn = llm_fn
        self.seed = seed
        self.enhancer = PromptEnhancer(seed=seed)

    def generate(self, class_name: str, n: int) -> List[str]:
        if self.llm_fn is None:
            return template_prompts(class_name, n, self.seed)
        user = self.USER_TEMPLATE.format(n=n, cls=class_name)
        text = self.llm_fn(self.SYSTEM, user)
        prompts = _parse_prompt_list(text)[:n]
        while len(prompts) < n:
            prompts.append(template_prompts(class_name, 1, self.seed + len(prompts))[0])
        return [self.enhancer.enhance(p) for p in prompts]


class FilePromptProvider:
    """Prompt cache on disk: one JSON per class, generated on demand
    (reference `generate_train_images.py:105-172`)."""

    def __init__(self, prompts_dir: str, generator: ImagePromptGenerator):
        self.dir = Path(prompts_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.generator = generator

    def get_prompts(self, class_name: str, n: int) -> List[str]:
        path = self.dir / f"{class_name.replace(' ', '_')}.json"
        if path.exists():
            prompts = json.loads(path.read_text())
            if len(prompts) >= n:
                return prompts[:n]
        prompts = self.generator.generate(class_name, n)
        path.write_text(json.dumps(prompts, indent=1))
        return prompts
