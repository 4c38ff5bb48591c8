"""Undoes TensorBoard's tensorflow stub after a test module that forces it.

The port's tests block ``tensorflow`` (``sys.modules["tensorflow"] =
None``) so that TensorBoard writes through its own stub instead of
importing tensorflow, which takes most of a minute.  TensorBoard resolves
its lazy ``tensorboard.compat.tf`` once per process, so after such a test
it keeps the stub, and in the same worker a later test that writes
through ``tf.summary`` (the JAX package's ``engine/trainer.py`` writer,
``tests/test_trainer_loop.py``) fails with "cannot import tensorflow 2.0
API".  Whether the two share a worker depends on how xdist deals out the
files.  :func:`tensorboard_compat_reset`, imported into a test module,
reloads ``tensorboard.compat`` when the module's tests are done, so the
next use resolves tensorflow afresh.
"""

import importlib
import sys

import pytest


@pytest.fixture(scope="module", autouse=True)
def tensorboard_compat_reset():
    yield
    compat = sys.modules.get("tensorboard.compat")
    if compat is not None:
        importlib.reload(compat)
