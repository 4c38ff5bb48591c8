"""A checkpoint trained with the JAX package, made a port checkpoint:

    python -m cvpr22_cross_modal_pseudo_labeling_torch.tools.import_jax_checkpoint \\
        --config-file X.yaml --dump dump.npz --out DIR [--loader-state FILE|JAX_OUTPUT_DIR] \\
        [--device cuda|cpu] [--seed N] KEY VALUE ...

``dump.npz`` is what ``tools/orbax_to_npz.py`` writes, where jax runs,
from an orbax checkpoint of the JAX package (or its ``OUTPUT_DIR``).
This builds the ``Trainer`` the config and opts name on ``--device``
(``cuda`` unless the CPU is asked for; it raises without a card), draws
its weights from ``--seed``, loads the dump into it
(``engine/jax_checkpoint.py::load_into_trainer``: the parameters and, for
a train state, the momentum, the schedule count, the accumulation and the
exemplar table) and writes ``DIR/model_%07d.pth`` at the dump's iteration
with a ``last_checkpoint`` tag (``engine/checkpoint.py``), as
``train_net`` saves.  Then

* ``train_net ... MODEL.LOAD_TRAINER_STATE True OUTPUT_DIR DIR`` resumes
  the run at that iteration;
* ``test_net ... --ckpt DIR/model_%07d.pth`` (or ``OUTPUT_DIR DIR``)
  serves and scores it.

A bare parameter tree (an eval dump) gives iteration 0, a fresh
optimizer, and the leaves it lacks keep their ``--seed`` draw.  JAX's
``rng`` key does not carry (the log says so): the resumed run draws from
``--seed``.  ``--loader-state`` takes the JAX run's grain stream state,
a ``loader_state*.json`` or the run's ``OUTPUT_DIR`` (every rank's
file), and writes it into ``DIR``: ``train_net`` with
``DATALOADER.USE_GRAIN True`` then resumes the stream mid-epoch where
the JAX run left it.  ``MODEL.WEIGHT`` and ``MODEL.LANGUAGE_WEIGHT`` read
a dump directly, as weights.
"""

import argparse
import os
import sys
import time
from typing import Callable, Dict, Optional, Sequence


def convert(trainer, dump: str, out: str, seed: int = 0, log: Callable[[str], None] = print,
            loader_state: Optional[str] = None) -> Dict:
    """Loads the dump ``dump`` into ``trainer`` over weights drawn from
    ``seed`` and saves it as a port checkpoint in ``out``, beside the
    JAX run's grain stream states when ``loader_state`` names them;
    returns the checkpoint's path, its iteration, the stream states
    written, and the seconds the read, the load and the save took."""
    from .. import bridge
    from ..engine.checkpoint import checkpoint_state, save_checkpoint
    from ..engine.jax_checkpoint import import_loader_states, load_into_trainer, read_dump

    t = time.perf_counter()
    trainer.load_flax_params(bridge.seeded_flax_params(trainer.model, seed))
    flat = read_dump(dump)
    read_s = time.perf_counter() - t
    iteration = load_into_trainer(trainer, flat, log, source=dump)
    load_s = time.perf_counter() - t - read_s
    path = save_checkpoint(out, checkpoint_state(trainer, iteration), iteration)
    save_s = time.perf_counter() - t - read_s - load_s
    states = import_loader_states(loader_state, out, log) if loader_state else []
    log(f"wrote {path} (iteration {iteration}): resume with train_net MODEL.LOAD_TRAINER_STATE True "
        f"OUTPUT_DIR {os.path.abspath(out)}, serve with test_net --ckpt {path}")
    return {"path": path, "iteration": iteration, "loader_states": states, "read_s": read_s, "load_s": load_s,
            "save_s": save_s}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description="a JAX-trained checkpoint's dump as a port checkpoint")
    p.add_argument("--config-file", default="", metavar="FILE")
    p.add_argument("--dump", required=True, help="the .npz tools/orbax_to_npz.py wrote")
    p.add_argument("--out", required=True, help="directory of the port checkpoint")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--seed", type=int, default=0, help="seed of the weights the dump does not fill")
    p.add_argument("--loader-state", default=None, metavar="FILE|DIR",
                   help="the JAX run's grain stream state: a loader_state*.json or the run's OUTPUT_DIR")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None, help="config overrides: KEY VALUE pairs")
    args = p.parse_args(argv)

    from ..engine.train_step import Trainer
    from ..utils.logger import setup_logger

    logger = setup_logger(save_dir=args.out)
    trainer = Trainer(args.config_file, list(args.opts or []), device=args.device, seed=args.seed)
    return convert(trainer, args.dump, args.out, args.seed, logger.info, args.loader_state)


if __name__ == "__main__":
    main(sys.argv[1:])
