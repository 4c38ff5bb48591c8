"""The port's ``train_net`` and ``test_net`` on 2 gloo ranks, on the CPU.

Two processes of this file (``python tests/test_torch_ddp_train_net.py
--worker ...``) join one group through a ``file://`` rendezvous, with
torchrun's ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` set, and call the
entry points in process, as torchrun's ranks would, on the tiny COCO tree
of ``tests/test_torch_train_net.py`` at its narrow widths: the
student-teacher model (no exemplar table: its ``lambda_exemplar`` takes
no gradient, which DDP's search for such parameters finds) 2 iterations
of a global batch of 4, with the in-training evaluation and the
validation-loss pass at iteration 2; a resume to 3; ``test_net`` on the last checkpoint; MMSS
pretraining (``tests/test_torch_train_net.py``'s ``MMSS_TINY`` at res2
16) 2 iterations of a global batch of 4 with the validation-loss pass
at each, then a resume to 3.  Then ``test_net`` on 1 rank on the same
checkpoint.  Checked:

- each run adds exactly one checkpoint, and one ``last_checkpoint`` tag
  names it, written by rank 0 (each rank logs to its own file);
- both ranks resume at 2 and end with the same weights bit for bit;
- the gathered evaluation covers every image once: the ranks' stripes
  add up to the test set, every metric equals the 1-rank run's, and so
  do the detections of every image and class, scores within 1e-6 and
  boxes within 1e-3 px (the ranks' batches of 2 on 2 threads against
  batches of 4 here: the CPU convolutions sum in another order);
- MMSS trains and resumes on both ranks: one save each run, the ranks
  bit-equal, the same finite validation losses.
"""

import argparse
import hashlib
import json
import math
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest

if __name__ != "__main__":  # the ranks import no jax, which that module does
    from tests.test_torch_mmss_train import write_val_captions
    from tests.test_torch_train_net import MMSS_CONFIG, MMSS_TINY, STUDENT, TINY, tree  # noqa: F401  (tree: a fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 2
NAME = "coco_generalized_zeroshot_val"


def _digest(model):
    return {k: hashlib.sha1(v.detach().contiguous().numpy().tobytes()).hexdigest()
            for k, v in model.state_dict().items()}


def worker(rank_, world, init_file, plan_file, out_dir):
    import torch
    import torch.distributed as dist

    sys.modules["tensorflow"] = None  # TensorBoard writes through its own stub
    os.environ.update(RANK=str(rank_), WORLD_SIZE=str(world), LOCAL_RANK=str(rank_))
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank_, world_size=world)
    from cvpr22_cross_modal_pseudo_labeling_torch.tools import test_net, train_net

    with open(plan_file) as f:
        plan = json.load(f)
    out = {}
    for name, where in (("train", "out"), ("resume", "out"), ("mmss", "mmss_out"), ("mmss_resume", "mmss_out")):
        rec = train_net.main(plan[name])
        out[name] = dict(start_iter=rec["start_iter"], updates=rec["trainer"].optimizer.updates,
                         digest=_digest(rec["trainer"].model), evals=rec["evals"], val_losses=rec["val_losses"],
                         saves=sorted(p.name for p in pathlib.Path(plan[where]).iterdir()))
        if name == "resume":
            out["test"] = test_net.main(plan["test"])[NAME]
    with open(os.path.join(out_dir, f"rank{rank_}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def _without_time(metrics):
    return {k: v for k, v in metrics.items() if not k.startswith("time/") and k != "total_eval_seconds"}


def _same(a, b):
    return a.keys() == b.keys() and all(a[k] == b[k] or (math.isnan(a[k]) and math.isnan(b[k])) for k in a)


@pytest.fixture(scope="module")
def ranks(tree, tmp_path_factory):  # noqa: F811
    tmp = tmp_path_factory.mktemp("ddp_train_net")
    out, ev, mmss_out = tmp / "st", tmp / "eval", tmp / "mmss"
    write_val_captions(tree)  # MMSS's validation-loss pass reads them
    common = ["--device", "cpu", "--dist-backend", "gloo"]
    opts = [*map(str, TINY), "SOLVER.IMS_PER_BATCH", "4", "DATALOADER.ASPECT_RATIO_GROUPING", "False",
            "MODEL.LOAD_TRAINER_STATE", "True", "SOLVER.TEST_PERIOD", "2", "SOLVER.CHECKPOINT_PERIOD", "0",
            # the validation-loss pass needs the training classes
            "SOLVER.SKIP_VAL_LOSS", "False", "DATASETS.TEST", "('coco_not_zeroshot_val',)"]
    mmss = ["--config-file", MMSS_CONFIG, "--skip-test", *common, *map(str, MMSS_TINY),
            "MODEL.RESNETS.RES2_OUT_CHANNELS", "16", "SOLVER.IMS_PER_BATCH", "4", "SOLVER.CHECKPOINT_PERIOD", "0",
            "MODEL.LOAD_TRAINER_STATE", "True", "OUTPUT_DIR", str(mmss_out)]
    plan = {
        "out": str(out),
        "mmss_out": str(mmss_out),
        "train": ["--config-file", STUDENT, "--skip-test", *common, *opts, "SOLVER.MAX_ITER", "2",
                  "OUTPUT_DIR", str(out)],
        "resume": ["--config-file", STUDENT, "--skip-test", *common, *opts, "SOLVER.MAX_ITER", "3",
                   "OUTPUT_DIR", str(out)],
        "test": ["--config-file", STUDENT, *common, "--ckpt", str(out / "model_0000003.pth"), *map(str, TINY),
                 "OUTPUT_DIR", str(ev)],
        "mmss": mmss + ["SOLVER.MAX_ITER", "2"],
        "mmss_resume": mmss + ["SOLVER.MAX_ITER", "3"],
    }
    plan_file = tmp / "plan.json"
    plan_file.write_text(json.dumps(plan))
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2", CMPL_TPU_DATA_DIR=str(tree))
    procs = [
        subprocess.Popen([sys.executable, __file__, "--worker", str(r), str(WORLD), str(tmp / "rendezvous"),
                          str(plan_file), str(tmp)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)
    ]
    try:
        for p in procs:
            log, _ = p.communicate(timeout=600)
            assert p.returncode == 0, log[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    got = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return dict(ranks=got, out=out, eval=ev, tmp=tmp, tree=tree, mmss_out=mmss_out)


def test_rank_zero_writes_one_checkpoint_and_one_tag(ranks):
    for run, iterations in (("train", [2]), ("resume", [2, 3])):
        for r, got in enumerate(ranks["ranks"]):
            saves = [s for s in got[run]["saves"] if s.startswith("model_")]
            assert saves == [f"model_{i:07d}.pth" for i in iterations], (run, r, got[run]["saves"])
            assert "last_checkpoint" in got[run]["saves"] and not any(s.endswith(".tmp") for s in got[run]["saves"])
    out = ranks["out"]
    assert (out / "last_checkpoint").read_text() == "model_0000003.pth"
    assert (out / "labels.json").exists()
    # each rank logs to its own file; metrics from rank 0 only
    assert "resumed from" in (out / "log.txt.rank1").read_text()
    steps = [json.loads(line)["step"] for line in (out / "tb" / "metrics.jsonl").read_text().splitlines()]
    assert steps == [1, 2, 3]


def test_both_ranks_resume_and_stay_bit_equal(ranks):
    r0, r1 = ranks["ranks"]
    for run in ("train", "resume"):
        assert r0[run]["digest"] == r1[run]["digest"], run
    assert [r["resume"]["start_iter"] for r in (r0, r1)] == [2, 2]
    assert [r["resume"]["updates"] for r in (r0, r1)] == [3, 3]
    assert r0["train"]["digest"] != r0["resume"]["digest"]
    # the in-training evaluation and the validation loss, the same on both
    evals = [r["train"]["evals"][2]["coco_not_zeroshot_val"] for r in (r0, r1)]
    assert list(r0["train"]["evals"]) == [2] and _same(*map(_without_time, evals))
    assert r0["train"]["val_losses"] == r1["train"]["val_losses"] and math.isfinite(r0["train"]["val_losses"][2])


def test_gathered_eval_covers_every_image_once_and_equals_one_rank(ranks, monkeypatch):
    from cvpr22_cross_modal_pseudo_labeling_torch.tools import test_net

    r0, r1 = ranks["ranks"]
    assert _same(_without_time(r0["test"]), _without_time(r1["test"]))
    assert r0["test"]["time/images"] + r1["test"]["time/images"] == 8.0
    one = ranks["tmp"] / "one_rank"
    monkeypatch.setenv("CMPL_TPU_DATA_DIR", str(ranks["tree"]))
    single = test_net.main(["--config-file", STUDENT, "--device", "cpu", "--ckpt",
                            str(ranks["out"] / "model_0000003.pth"), *map(str, TINY), "OUTPUT_DIR", str(one)])[NAME]
    assert single["time/images"] == 8.0
    assert _same(_without_time(r0["test"]), _without_time(single))
    # the same detections of every image and class, in score order: a
    # batch of 2 a rank against one of 4 moves a score by an ulp
    two, ref = (_by_image_and_class(d / f"predictions_{NAME}.json") for d in (ranks["eval"], one))
    assert two and two.keys() == ref.keys()
    for k in ref:
        a, b = np.asarray(two[k]), np.asarray(ref[k])
        np.testing.assert_allclose(a[:, 0], b[:, 0], rtol=0, atol=1e-6, err_msg=str(k))
        np.testing.assert_allclose(a[:, 1:], b[:, 1:], rtol=0, atol=1e-3, err_msg=str(k))


def _by_image_and_class(path):
    """Each (image, class)'s detections as [score, x, y, w, h] rows in
    score order."""
    out = {}
    for d in json.loads(path.read_text()):
        out.setdefault((d["image_id"], d["category_id"]), []).append([d["score"], *d["bbox"]])
    return {k: sorted(v, reverse=True) for k, v in out.items()}


def test_mmss_trains_and_resumes_on_two_ranks(ranks):
    r0, r1 = ranks["ranks"]
    for run, iterations, start, losses in (("mmss", [2], 0, [1, 2]), ("mmss_resume", [2, 3], 2, [3])):
        for r, got in enumerate((r0, r1)):
            saves = [s for s in got[run]["saves"] if s.startswith("model_")]
            assert saves == [f"model_{i:07d}.pth" for i in iterations], (run, r, got[run]["saves"])
            assert got[run]["start_iter"] == start and got[run]["updates"] == iterations[-1], (run, r)
            assert list(got[run]["val_losses"]) == losses and all(map(math.isfinite, got[run]["val_losses"].values()))
        assert r0[run]["digest"] == r1[run]["digest"] and r0[run]["val_losses"] == r1[run]["val_losses"], run
    assert r0["mmss"]["digest"] != r0["mmss_resume"]["digest"]
    assert (ranks["mmss_out"] / "last_checkpoint").read_text() == "model_0000003.pth"
    assert "resumed from" in (ranks["mmss_out"] / "log.txt.rank1").read_text()


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    parser = argparse.ArgumentParser()
    parser.add_argument("--worker", nargs=5, required=True, metavar=("RANK", "WORLD", "INIT", "PLAN", "OUT"))
    a = parser.parse_args().worker
    worker(int(a[0]), int(a[1]), a[2], a[3], a[4])
