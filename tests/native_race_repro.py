"""Reproduces the JAX package's native-library race, and shows
``tests/native_libs.py`` closing it.

    python tests/native_race_repro.py --out DIR [--trials 3] [--procs 8] [--stagger 0.1]

Each trial copies the repository's files (as ``git ls-files`` lists
them, so without ``native/*.so`` and ``build/``) into ``DIR/tree`` and
starts ``--procs`` processes ``--stagger`` seconds apart.  Each imports
the JAX package's ``utils/native_image`` and reports whether its loader
returned the library (``before``); in the ``after`` runs each first
calls ``ensure_native_libs``.  Prints each trial's count of processes
that got no library, and the totals.
"""

import argparse
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = """
import sys
sys.path.insert(0, sys.argv[1])
from cvpr22_cross_modal_pseudo_labeling_tpu.utils import native_image
if sys.argv[2] == "after":
    from tests.native_libs import ensure_native_libs
    ensure_native_libs()
print("LOADED" if native_image._loader.get() is not None else "NONE")
"""


def copy_tree(dst: str) -> None:
    files = subprocess.run(["git", "ls-files", "-z", "--cached", "--others", "--exclude-standard"], cwd=REPO,
                           check=True, capture_output=True).stdout.decode().split("\0")
    shutil.rmtree(dst, ignore_errors=True)
    for f in filter(None, files):
        src = os.path.join(REPO, f)
        if os.path.isfile(src):
            os.makedirs(os.path.dirname(os.path.join(dst, f)), exist_ok=True)
            shutil.copy2(src, os.path.join(dst, f))


def trial(tree: str, mode: str, procs: int, stagger: float) -> int:
    copy_tree(tree)
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    running = []
    for _ in range(procs):
        running.append(subprocess.Popen([sys.executable, "-c", PROBE, tree, mode], env=env,
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        time.sleep(stagger)
    return sum("NONE" in p.communicate()[0] for p in running)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--procs", type=int, default=8)
    ap.add_argument("--stagger", type=float, default=0.1)
    args = ap.parse_args(argv)
    tree = os.path.join(args.out, "tree")
    for mode in ("before", "after"):
        counts = [trial(tree, mode, args.procs, args.stagger) for _ in range(args.trials)]
        print(f"{mode}: {counts} -> {sum(counts)} of {args.trials * args.procs} processes got no library")
    shutil.rmtree(tree, ignore_errors=True)


if __name__ == "__main__":
    main()
