"""Device time launched on the same thread inside the program's spans
`s3od.mmdit.dual_block` (the forward of each dual-stream block), less
what its `s3od.lora.merge` spans launched, per step (ms)."""

from perfbench.spans import named, steps
from perfbench.trace import traced

SPAN = "s3od.mmdit.dual_block"


def read(ctx, span: str = SPAN):
    tr = traced(ctx)
    if tr is None:
        return None
    blocks, n = named(tr, span), steps(tr)
    if not blocks or not n:
        return None
    merges = {id(e) for e in tr._inside(named(tr, "s3od.lora.merge"))}
    return 1e3 * tr.seconds(e for e in tr._inside(blocks) if id(e) not in merges) / n
