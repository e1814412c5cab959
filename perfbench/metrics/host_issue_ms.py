"""The host time of the program's span `s3od.train.step` on its thread,
less the synchronizing CUDA calls inside it, per step (ms): the host's
own cost to issue a step."""

from perfbench.spans import host_issue_ms_per_step


def read(ctx):
    return host_issue_ms_per_step(ctx)
