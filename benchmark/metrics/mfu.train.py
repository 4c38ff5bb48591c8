"""The training steps' model FLOPs over the traced window and the bf16
peak, in percent."""

from harness import readers


def read(run, config):
    return readers.mfu(run, config, train=True)
