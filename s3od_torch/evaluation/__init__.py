"""Evaluation on PyTorch: `SODPredictor`, the metrics and the
`compute_metrics` CLI (the port's own copies of the JAX package's
`s3od_tpu.evaluation` modules of the same names).
"""
