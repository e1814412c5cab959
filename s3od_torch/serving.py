"""Dynamic-batching server for the port's predictor.

`s3od_tpu.serving.InferenceServer` imports no jax and is duck-typed on
`remove_background_batch`, so it serves `s3od_torch.BackgroundRemoval` as
it is; this module is the port's one entry point for it.

    server = InferenceServer(BackgroundRemoval(...), max_batch=16).start()
    result = server.submit(image)          # blocking, thread-safe
    server.stop()
"""

from s3od_tpu.serving import InferenceServer  # noqa: F401  (re-exported)

__all__ = ["InferenceServer"]
