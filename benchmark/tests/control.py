"""Readings of the control and of the planted faults, for setting the
limits of ``benchmark/limits/<workload>.json``; the benchmark's own runs
never run this.

    python3 benchmark/tests/control.py --workload st_train --seeds 11,12,13 --candidate float8

Puts a candidate in the program's place on the cell's own inputs (the
pool, weights and draws of each seed, at the cell's sizes) and prints
the compared numbers against the float32 reference, one JSON line a
seed.  Candidates: ``program``, the program itself through the cell's
loop with a window of (nearly) nothing, for its readings on many seeds
in one process; ``float8``, the reference itself computed in float8 where the
program computes in bfloat16 (the control): every conv, linear and
class-table product's inputs, weights and outputs through e4m3, the
gradients flowing back through them e5m2;
``half_batch`` (training cells), the float32 reference on the first
half of each batch only, its losses the means over that half;
``relabel`` (serving cells), the reference's detections with each label
moved to the next class; ``keep_duplicates`` (serving), the reference
with a detection NMS that suppresses nothing (IoU threshold 1);
``shifted_deltas`` (serving), the reference with the box head's
regression deltas shifted by one unit in x and y before they are decoded
(the box moves by a tenth of the proposal's size); ``shifted_rpn_deltas``
(serving, and the student-teacher training cell), the same in the RPN's
decode of the anchors.  Training needs no window: the candidate
follows the compared steps, and where the reference follows the
program's choices it follows the candidate's.  Serving compares the
first ``compared_batches`` of the pool, and the reference follows the
candidate's proposals as it follows the program's.
"""

import argparse
import contextlib
import json
import sys
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

from harness import env  # noqa: E402


def half(batch, b):
    return {k: v[: b // 2] for k, v in batch.items()}


def train_candidate(ctx, candidate):
    import torch
    from harness import compare, traffic, train, weights

    if candidate == "program":
        return train.run(SimpleNamespace(**dict(vars(ctx), seconds=0.0, trace=False)))["numbers"]
    dev = torch.device(ctx.device)
    batches, tables = traffic.make_pool(ctx.seed, ctx.mix, ctx.config)
    n = ctx.mix["compared_steps"]
    order = train.setup_order(batches, n)[:n]
    b = ctx.mix["batch"]
    cmp_batches = [batches[i] for i in order]
    draws = [train.make_draws(ctx.config, batches[i]["images"].shape[1:3], b, ctx.seed, s, dev)
             for s, i in enumerate(order)]
    state = weights.draw_state(train._template(ctx.config, dev), ctx.seed, dev)
    if candidate == "float8":
        cand = train.reference_steps(ctx.config, cmp_batches, tables, draws, state, dev, "float8")
    elif candidate == "shifted_rpn_deltas":
        with planted(candidate):
            cand = train.reference_steps(ctx.config, cmp_batches, tables, draws, state, dev, "float32")
    elif candidate == "half_batch":
        hb = [half(x, b) for x in cmp_batches]
        hd = [{k: (v[:, : v.shape[1] // 2] if k == "mask_eps" else v[: b // 2]) for k, v in d.items()} for d in draws]
        cand = train.reference_steps(ctx.config, hb, tables, hd, state, dev, "float32")
    else:
        raise SystemExit(f"no training candidate {candidate!r}")
    # the reference follows the candidate's choices, as it follows the program's
    ref = train.reference_steps(ctx.config, cmp_batches, tables, draws, state, dev, "float32", cand["chosen"])
    return compare.train_numbers(cand, ref)


@contextlib.contextmanager
def planted(candidate):
    """The serving faults, planted in the reference while it stands in
    the program's place."""
    import torch
    from reference import ops

    nms, decode = ops.nms, ops.decode_boxes

    def keep_all(boxes, scores, valid, iou_threshold, max_outputs, labels=None):
        return nms(boxes, scores, valid, 1.0 if labels is not None else iou_threshold, max_outputs, labels)

    def shifted(codes, boxes, weights):
        # the RPN decodes with unit weights, the box head with (10, 10, 5, 5):
        # either way its centre moves by a tenth of the box's size
        rpn = tuple(weights) == (1.0, 1.0, 1.0, 1.0)
        if rpn == (candidate == "shifted_rpn_deltas"):
            shift = torch.zeros(4, dtype=codes.dtype, device=codes.device)
            shift[:2] = weights[0] / 10.0
            codes = (codes.reshape(codes.shape[:-1] + (-1, 4)) + shift).reshape(codes.shape)
        return decode(codes, boxes, weights)

    if candidate == "keep_duplicates":
        ops.nms = keep_all
    elif candidate in ("shifted_deltas", "shifted_rpn_deltas"):
        ops.decode_boxes = shifted
    try:
        yield
    finally:
        ops.nms, ops.decode_boxes = nms, decode


SERVE_CANDIDATES = ("float8", "relabel", "keep_duplicates", "shifted_deltas", "shifted_rpn_deltas")


def serve_candidate(ctx, candidate):
    import torch
    from harness import compare, serve, traffic

    if candidate == "program":
        return serve.run(SimpleNamespace(**dict(vars(ctx), seconds=2.0, trace=False)))["numbers"]
    if candidate not in SERVE_CANDIDATES:
        raise SystemExit(f"no serving candidate {candidate!r}")
    dev = torch.device(ctx.device)
    batches, tables = traffic.make_pool(ctx.seed, ctx.mix, ctx.config)
    table = tables["class_embeddings"]
    picked = batches[: ctx.mix["compared_batches"]]
    precision = "float8" if candidate == "float8" else "float32"
    with planted(candidate):
        cand = serve.reference_outputs(ctx.config, [(x, None, None) for x in picked], table, ctx.seed, dev,
                                       precision)
    served = [{k: c[k] for k in ("boxes", "scores", "labels", "valid", "masks")} for c in cand]
    if candidate == "relabel":
        classes = table.shape[0] - 1
        for s in served:
            s["labels"] = (s["labels"] % classes) + 1
    given = [c["chosen"] for c in cand]
    ref = serve.reference_outputs(ctx.config, list(zip(picked, served, given)), table, ctx.seed, dev, "float32")
    return compare.serve_numbers(served, ref)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--candidate", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    env.set_caches()
    import run as bench_run

    _, cell, config, mix, limits, _, _ = bench_run.load_cell(env.ROOT, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = SimpleNamespace(config=config, mix=mix, seed=seed, device=args.device)
        fn = train_candidate if mix["loop"] == "train" else serve_candidate
        numbers = fn(ctx, args.candidate)
        print(json.dumps({"workload": args.workload, "candidate": args.candidate, "seed": seed,
                          "numbers": numbers, "limits": limits,
                          "fails": sorted(k for k in limits if numbers[k] > limits[k])}), flush=True)


if __name__ == "__main__":
    main()
