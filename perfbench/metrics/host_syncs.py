"""Synchronizing runtime and driver calls (`kernels/host_syncs.json`)
made inside a `s3od.train.step` span's interval on any thread, per step;
the window's waits between steps are not counted."""

from perfbench.spans import host_syncs_per_step


def read(ctx):
    return host_syncs_per_step(ctx)
