"""Synchronizing CUDA calls a step or served batch in the traced window."""

from harness import readers


def read(run, config):
    return readers.host_syncs(run)
