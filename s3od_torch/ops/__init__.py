"""Kernel wrappers and plain tensor ops of the port.

Each kernel module holds the hand-written kernel's wrapper, its plain
PyTorch version and a launch counter. Nothing here is imported eagerly:
`triton` and the CUDA library load only when a kernel first launches.
"""
