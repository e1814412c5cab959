"""Evaluation on PyTorch: `SODPredictor` and the `compute_metrics` CLI.

The metrics and the dataset loop are the JAX package's jax-free
`s3od_tpu.evaluation.metrics` and `s3od_tpu.evaluation.compute_metrics`,
reused as they are.
"""
