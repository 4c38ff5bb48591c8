"""JAX's ablation tool and the port's, step by step from the same weights
and draws, at full width on the CPU:

    JAX_PLATFORMS=cpu python -m tests.torch_ablation_lockstep \\
        --condition fixed [--steps 400] [--twin-steps 30] [--every 25] \\
        --out lockstep_fixed.json

Three runs of one condition of ``tools/ablate_st_e2e.py`` advance
together: JAX's own (its ``model.init`` keys and train step, as its
``run_condition``), JAX's again from the same weights each nudged one
float32 ulp up (the twin, for the first ``--twin-steps`` steps; with
``--twin-scope student`` only the student's weights, the ones that
train, so that the frozen RPN proposes what JAX's does), and the
port's ``run_condition`` from JAX's weights with JAX's random draws of
each step (RoI sampling and mask noise).  After each step the student's
weights of the twin and of the port are compared with JAX's: the distance
over the distance JAX's weights have moved from their start
(``d_twin``, ``d_port``).  With ``--resync`` the port starts each step
from JAX's weights and momentum, so ``d_step``, its update's distance
from JAX's over the norm of JAX's update, is one step's difference at
each point of JAX's run.  Every ``--every`` steps all runs are scored on
the held-out set (``gtbox_metrics``).  The JSON at ``--out`` is rewritten
as the runs go.  A JAX step takes about 35 s here at full width.
"""

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from cvpr22_cross_modal_pseudo_labeling_tpu.engine import train_step as jax_train
from cvpr22_cross_modal_pseudo_labeling_torch import bridge
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector.generalized_rcnn import TrainDraws
from cvpr22_cross_modal_pseudo_labeling_torch.tools import ablate_st_e2e as port_tool
from tests.test_torch_ablate_st_e2e import load_jax_tool
from tests.test_torch_st_train import _SINK, JaxDraws

BATCH, N_TRAIN, N_HELD = 8, 64, 32  # JAX's run_condition defaults


def nudge(tree, scope="all"):
    """Every float32 weight that is not a constant one ulp up: all of
    them, or only the student's (the weights that train)."""
    def up(path, v):
        inside = scope == "all" or path[0].key == "student"
        return np.nextafter(v, np.float32(np.inf)) if inside and v.dtype == np.float32 and v.std() > 0 else v

    return jax.tree_util.tree_map_with_path(up, tree)


def cut(node, like):
    return {k: cut(node[k], v) if isinstance(v, dict) else node[k] for k, v in like.items()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--condition", default="fixed")
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--twin-steps", type=int, default=30)
    p.add_argument("--twin-scope", default="all", choices=("all", "student"),
                   help="the weights the twin's nudge moves: all, or the student's")
    p.add_argument("--every", type=int, default=25)
    p.add_argument("--resync", action="store_true",
                   help="before each step give the port JAX's weights and momentum: one step's difference")
    p.add_argument("--threads", type=int, default=4, help="the port's torch threads")
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    torch.set_num_threads(a.threads)

    jax_tool = load_jax_tool()
    name, unc, est, ns, rw, sm = next(c for c in jax_tool.CONDITIONS if c[0] == a.condition)
    rng = np.random.RandomState(0)
    train = jax_tool.make_detection_data(rng, N_TRAIN)
    held = jax_tool.make_detection_data(np.random.RandomState(100), N_HELD)
    corrupt = rng.rand(N_TRAIN) < 0.5
    table = np.random.RandomState(5).randn(jax_tool.LVIS_SLOTS, jax_tool.EMB).astype(np.float32)
    model, cfg = jax_tool.build_model(unc, est, ns, rw, sm)
    first = jax_tool.make_batch(*(x[:BATCH] for x in train), corrupt[:BATCH], table)
    keys = {"params": jax.random.PRNGKey(0), "sampler": jax.random.PRNGKey(1), "uncertainty": jax.random.PRNGKey(2)}
    tree0 = jax.tree_util.tree_map(np.asarray, jax.jit(lambda r, b: model.init(
        r, b["images"], b["image_sizes"], {k: v for k, v in b.items() if k not in ("images", "image_sizes")},
        b["class_embeddings"], b["lvis_class_embeddings"], train=True))(keys, first)["params"])
    tx = optax.chain(optax.clip_by_global_norm(10.0), optax.sgd(cfg.SOLVER.BASE_LR, momentum=0.9))
    step = jax.jit(jax_train.build_train_step(model, tx, "STGeneralizedRCNN"))
    states = {run: jax_train.create_train_state({"params": jax.tree_util.tree_map(jnp.asarray, t)}, tx,
                                                jax.random.PRNGKey(7))
              for run, t in (("jax", tree0), ("twin", nudge(tree0, a.twin_scope)))}

    port_model, _ = port_tool.build_model(unc, est, ns, rw, sm)
    student = [k for k in port_model.state_dict() if k.startswith("student.")]

    def flat(state_dict):
        return np.concatenate([np.asarray(state_dict[k], np.float64).ravel() for k in student])

    def flat_jax(params):
        return flat(bridge.state_dict_from_flax(port_model, jax.tree_util.tree_map(np.asarray, params)))

    theta0 = flat_jax(tree0)
    log = {"condition": name, "steps": [], "held": {}, "args": vars(a)}
    order = np.arange(N_TRAIN)
    pending, draws = {}, {}
    record = {}
    t0 = time.time()

    def jax_step(it):
        if it % (N_TRAIN // BATCH) == 0:
            rng.shuffle(order)
        sel = order[(it * BATCH) % N_TRAIN:(it * BATCH) % N_TRAIN + BATCH]
        batch = jax_tool.make_batch(*(x[sel] for x in train), corrupt[sel], table)
        if it == a.twin_steps:
            states.pop("twin", None)
        out = {}
        for run in states:
            with JaxDraws(cfg.MODEL.RPN.POST_NMS_TOP_N_TEST):
                states[run], metrics = step(states[run], batch)
                jax.block_until_ready(metrics)
            out[run] = {k: float(v) for k, v in metrics.items() if np.ndim(v) == 0}
            if run == "jax":
                draws[it] = TrainDraws(torch.from_numpy(_SINK["pseudo_sampler"]),
                                       torch.from_numpy(_SINK["gt_sampler"]),
                                       torch.from_numpy(_SINK["mask_eps"]) if "mask_eps" in _SINK else None)
        pending[it] = out
        return draws.pop(it)

    def resync():
        """The port's weights and momentum set to JAX's."""
        state = states["jax"]
        weights = bridge.state_dict_from_flax(port_model, jax.tree_util.tree_map(np.asarray, state.params["params"]))
        trace = bridge.state_dict_from_flax(port_model, jax.tree_util.tree_map(np.asarray, state.opt_state[1][0].trace))
        sgd = record["optimizer"].sgd
        with torch.no_grad():
            for key, p in record["model"].named_parameters():
                p.copy_(weights[key])
                if p in sgd.state:
                    sgd.state[p]["momentum_buffer"].copy_(trace[key])
        return flat(weights)

    before = {0: theta0}  # JAX's student before each step

    def on_step(it):
        # the port calls this before its step `it`, after its update of it - 1
        if it == 0:
            return
        row = {"it": it - 1, **pending.pop(it - 1)}
        theta = flat_jax(states["jax"].params["params"])
        moved = np.linalg.norm(theta - theta0)
        row["moved"] = float(moved)
        if a.resync:
            port = flat(record["model"].state_dict())
            row["d_step"] = float(np.linalg.norm(port - theta) / np.linalg.norm(theta - before.pop(it - 1)))
        if "twin" in states:
            row["d_twin"] = float(np.linalg.norm(flat_jax(states["twin"].params["params"]) - theta) / moved)
        last = record["steps"][-1]
        row["port"] = {k: float(v) for k, v in last.items() if v.dim() == 0}
        row["d_port"] = float(np.linalg.norm(flat(record["model"].state_dict()) - theta) / moved)
        log["steps"].append(row)
        if it % a.every == 0 or it == a.steps:
            scores = {run: jax_tool.gtbox_metrics(model, {"params": s.params["params"]}, *held, table)
                      for run, s in states.items()}
            record["model"].eval()
            scores["port"] = port_tool.gtbox_metrics(record["model"], *held, table, "cpu")
            record["model"].train()
            log["held"][it] = scores
        if a.resync and it < a.steps:
            before[it] = resync()
        print(json.dumps({"it": it - 1, "s": round(time.time() - t0),
                          **{k: row[k] for k in ("d_twin", "d_port", "d_step") if k in row},
                          "mask_loss": {r: row[r]["loss_mask_pseudo"] for r in ("jax", "twin", "port") if r in row}}),
              flush=True)
        with open(a.out, "w") as f:
            json.dump(log, f)

    port_tool.run_condition(name, unc, est, ns, a.steps, 0.5, seed=0, reweight=rw, sigma_max=sm, device="cpu",
                            params=cut(tree0, bridge.flax_from_state_dict(port_model)), draws=jax_step,
                            record=record, on_step=on_step)


if __name__ == "__main__":
    main()
