"""The share of its bound that the ``cmpl::roi_align`` launches reached."""

from harness import readers


def read(run, config):
    return readers.roofline(run, "roi_align")
