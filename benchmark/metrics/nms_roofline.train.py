"""The share of its bound that the ``cmpl::nms`` launches reached."""

from harness import readers


def read(run, config):
    return readers.roofline(run, "nms")
