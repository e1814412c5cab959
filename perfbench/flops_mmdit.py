"""The work of FLUX.1-dev's LoRA fine-tuning step, counted from its shapes:
the floating-point operations (two per multiply-add) of the matrix
products a LoRA step must compute. Elementwise work, norms, softmax and
the adapters' merge are not counted.

`flops.train_step_flops` counts a step as three forwards: the forward and
a backward of twice its products, input and weight gradients of every
layer. A LoRA step trains the adapters only, and no implementation
computes the frozen base's weight gradients, so this count is:

- the forward, every product (embedders, modulations, blocks, last layer);
- the input gradient of every linear that has something trainable
  upstream: every block's linears but the first dual block's two qkv
  (their inputs hold no adapter), and the last layer's projection; the
  embedders' and the modulations' inputs hold nothing trainable;
- the attention backward's five products (S, dP, dV, dQ, dK), 10 N^2 D a
  head;
- the adapters' own products, rank r on each target over its tokens m:
  x A and (x A) B forward, then (x A)^T dy, dy B^T, x^T d(xA) and the
  input's share d(xA) A^T: 6 m r (in + out).

A recompute under checkpointing is not counted. At the 1024^2 bucket (N =
4096 + 512 tokens) the forward is ~7.45e13 and a step ~1.71e14.
"""

from __future__ import annotations

from typing import List, Tuple

from perfbench.inputs_mmdit import PACK, adapter_shapes, mlp_dim


def tokens(cfg: dict, size: int) -> Tuple[int, int]:
    """(image tokens, text tokens) of the size^2 bucket."""
    return (size // PACK) ** 2, cfg["max_t5_tokens"]


def _mm(m: int, din: int, dout: int) -> float:
    return 2.0 * m * din * dout


def _block_linears(cfg: dict, n_img: int, n_txt: int) -> List[Tuple[str, int, int, int]]:
    """(name, tokens, in, out) of every linear inside the blocks."""
    d, f = cfg["hidden_size"], mlp_dim(cfg)
    n = n_img + n_txt
    out = []
    for i in range(cfg["num_layers"]):
        for s, m in (("img", n_img), ("txt", n_txt)):
            p = f"dual_blocks.{i}.{s}_"
            out += [(p + "attn.qkv", m, d, 3 * d), (p + "attn.proj", m, d, d),
                    (p + "mlp.fc1", m, d, f), (p + "mlp.fc2", m, f, d)]
    for i in range(cfg["num_single_layers"]):
        p = f"single_blocks.{i}."
        out += [(p + "qkv", n, d, 3 * d), (p + "mlp_in", n, d, f),
                (p + "proj_out", n, d + f, d)]
    return out


def attention_calls(cfg: dict, n_img: int, n_txt: int, batch: int = 1
                    ) -> List[Tuple[int, int, int]]:
    """(batch x heads, tokens, head dim) of each attention of a forward:
    one a block."""
    blocks = cfg["num_layers"] + cfg["num_single_layers"]
    return [(batch * cfg["num_attention_heads"], n_img + n_txt,
             cfg["attention_head_dim"])] * blocks


def forward_flops(cfg: dict, n_img: int, n_txt: int, batch: int = 1) -> float:
    d, cin = cfg["hidden_size"], cfg["in_channels"]
    total = _mm(n_img, cin, d) + _mm(n_txt, cfg["joint_attention_dim"], d)
    total += 2 * (_mm(1, 256, d) + _mm(1, d, d))                    # time, guidance
    total += _mm(1, cfg["pooled_projection_dim"], d) + _mm(1, d, d)   # pooled
    total += cfg["num_layers"] * 2 * _mm(1, d, 6 * d)                 # modulations
    total += cfg["num_single_layers"] * _mm(1, d, 3 * d) + _mm(1, d, 2 * d)
    total += sum(_mm(m, i, o) for _, m, i, o in _block_linears(cfg, n_img, n_txt))
    total += sum(4.0 * bh * n * n * dh for bh, n, dh in attention_calls(cfg, n_img, n_txt))
    total += _mm(n_img, d, cin)                                       # last layer
    return batch * total


def lora_step_flops(cfg: dict, n_img: int, n_txt: int, batch: int = 1) -> float:
    """One LoRA step's products (the module's count)."""
    d, r = cfg["hidden_size"], cfg["lora"]["rank"]
    first_qkv = {"dual_blocks.0.img_attn.qkv", "dual_blocks.0.txt_attn.qkv"}
    dgrad = sum(_mm(m, i, o) for name, m, i, o in _block_linears(cfg, n_img, n_txt)
                if name not in first_qkv)
    dgrad += _mm(n_img, d, cfg["in_channels"])
    attn_bwd = sum(10.0 * bh * n * n * dh
                   for bh, n, dh in attention_calls(cfg, n_img, n_txt))
    n = n_img + n_txt
    adapters = 0.0
    for name, (din, dout) in adapter_shapes(cfg).items():
        m = n if name.startswith("single") else (n_txt if ".txt_" in name else n_img)
        adapters += 6.0 * m * r * (din + dout)
    return forward_flops(cfg, n_img, n_txt, batch) + batch * (dgrad + attn_bwd + adapters)
