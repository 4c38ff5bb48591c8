"""The command: its arguments, the cell lookup by name, the result line,
and its refusals without a card or without the program."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import run as bench_run
import tiny
from harness import env, serve, train

ROOT = env.ROOT
WORKLOADS = ["st_train", "st_serve", "teacher_train"]


def test_arguments():
    a = bench_run.parse(["--workload", "st_train", "--seed", "3000000001", "--seconds", "20", "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == ("st_train", 3000000001, 20.0, 1)
    with pytest.raises(SystemExit):
        bench_run.parse(["--workload", "st_train", "--seed", "1", "--seconds", "20", "--trace", "2"])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_finds_its_files_by_name(workload):
    spec, cell, config, mix, limits, e2e, per_layer = bench_run.load_cell(ROOT, workload)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert per_layer and all(m["moves"] in names for m in per_layer)
    for m in per_layer:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
    assert limits, "every cell has the limits of its compared numbers"
    assert mix["loop"] in ("train", "serve") and config["reduced"] == []


@pytest.mark.parametrize("workload,loop", [("teacher_train", train.run), ("st_serve", serve.run)])
def test_result_line_keys(workload, loop):
    spec, cell, config, mix, limits, e2e, per_layer = bench_run.load_cell(ROOT, workload)
    ctx = tiny.context(cell["config"], cell["traffic"], seconds=0.5)
    r = loop(ctx)
    line = bench_run.result_line(r, ctx.config, limits, e2e, per_layer, False, 1.0,
                                 {"platform": "gpu", "kind": "test", "count": 1})
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "compared" and set(line["compared"]) == set(limits)
    assert set(line["metrics"]) == {m["name"] for m in e2e}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert line["correct"] is True
    json.dumps(line)


def test_no_card_exits_without_a_result():
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "st_train", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True)
    if p.returncode == 0:
        pytest.skip("a card is present")
    assert p.returncode == 2 and p.stdout == ""


def test_a_checkout_of_only_the_benchmark_exits_without_a_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "st_train", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode != 0 and p.stdout == ""
