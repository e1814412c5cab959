#!/usr/bin/env python3
"""The port's checks on an NVIDIA GPU, in one command:

    python3 chip_smoke.py                 # every card test
    python3 chip_smoke.py -k lora         # one part; any pytest argument passes

Builds the kernel library once, then runs `pytest -m cuda` over
`tests/test_torch_*_cuda.py` (or the test files given) in this process,
without `tests/conftest.py`, which sets JAX up for the CPU tests. Exits
non-zero without a CUDA device (where pytest would skip every test and
pass), on any failed or missing test, and if any module of jax or
s3od_tpu was loaded; else its last line is `{"ok": true, "device": ...}`.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from s3od_torch import _build

    _build.load_library()
    import pytest

    files = [] if any(a.endswith(".py") or "::" in a for a in argv) else [
        str(p) for p in sorted((REPO / "tests").glob("test_torch_*_cuda.py"))]
    code = pytest.main(["-m", "cuda", "--noconftest", "-p", "no:cacheprovider",
                        "-rfEs", *files, *argv])
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "s3od_tpu"))
    if code != 0 or loaded:
        print(f"chip_smoke: pytest exit {int(code)}; jax or s3od_tpu modules "
              f"loaded: {loaded}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
