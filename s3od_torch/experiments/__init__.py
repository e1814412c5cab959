"""The port's counterparts of the Pallas experiments in `benchmarks/`.

Each module mirrors one script's `main()` (same flags and defaults, plus
`--device`, which defaults to "cuda" and raises without a card) and holds
the hand-written Hopper kernel that replaces the script's Pallas kernel,
beside its plain PyTorch version:

    python -m s3od_torch.experiments.exp_flash_softmax  # E1
    python -m s3od_torch.experiments.exp_layernorm      # E2 (Triton)
    python -m s3od_torch.experiments.exp_exp2           # E3a, E3b
    python -m s3od_torch.experiments.exp_flash_single   # E4

E1, E3a and E4 share one CUDA forward (`flash_variants.py`,
`csrc/exp_flash_variants.cu`); E3b is `csrc/exp_loop.cu`. CPU tensors take
the plain versions, which is how `--device cpu` and the tests run. The
scripts are off every serving path: they measure how the card answers the
softmax questions the TPU kernels were shaped by.

`k8_d128_shapes` (the card only) builds K8's four D = 128 block shapes
from `csrc/flash_attention_bwd.cu` and times them side by side: the
record of why the kernel runs the shape it does.
"""
