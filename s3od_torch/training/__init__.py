"""Training on PyTorch: `python -m s3od_torch.training.train` (counterpart
of `s3od_tpu.training`)."""
