"""Nothing the benchmark runs loads JAX or the JAX package, top-level
names compared whole; the reference loads nothing of the program."""

import json
import subprocess
import sys

from harness import env

ROOT = env.ROOT

RUN_TINY = """
import json, sys
sys.path[:0] = ['benchmark', 'benchmark/tests', '.']
from harness import env
env.set_caches()
import tiny
from harness import serve, train
train.run(tiny.context('st_r50c4_coco', 'coco_train_b8', seconds=0.3))
serve.run(tiny.context('st_r50c4_coco', 'coco_serve_b8', seconds=0.3))
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""

REFERENCE = """
import json, sys
sys.path[:0] = ['benchmark']
import reference.model, reference.ops, reference.optim
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""


def loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = loaded(RUN_TINY)
    assert "cvpr22_cross_modal_pseudo_labeling_torch" in names
    assert not names & set(env.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    names = loaded(REFERENCE)
    assert not names & set(env.FORBIDDEN)
    assert "cvpr22_cross_modal_pseudo_labeling_torch" not in names
