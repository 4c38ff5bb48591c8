"""Percent of the traced window in which the card ran nothing."""

from harness import readers


def read(run, config):
    return readers.idle_share(run)
