"""DINOv3 encoder, DPT decoder and the full segmentation model (PyTorch)."""
