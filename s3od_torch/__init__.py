"""s3od_torch — the PyTorch + CUDA port of S3OD: background removal,
training, evaluation and the synthetic-data factory's generation path.

It serves the same API as `s3od_tpu` (`BackgroundRemoval`, `RemovalResult`)
on an NVIDIA H100. The encoder blocks and the MMDiT's attention run on
hand-written Hopper kernels (`s3od_torch/ops/`, sources in
`s3od_torch/csrc/`); on CPU tensors every kernel wrapper takes its plain
PyTorch version, so the whole package also runs (and is tested) without a
GPU.

Imports are lazy: importing the package imports neither the predictor nor
`triton`, and builds nothing.
"""

__version__ = "0.1.0"
__all__ = ["BackgroundRemoval", "RemovalResult"]


def __getattr__(name):
    if name in ("BackgroundRemoval", "RemovalResult"):
        from s3od_torch import predictor

        return getattr(predictor, name)
    raise AttributeError(f"module 's3od_torch' has no attribute {name!r}")
