"""Runs one cell of the benchmark once and prints its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic mix are found by name in
``BENCHMARK.json`` at the root of the checkout: ``benchmark/configs/
<config>.json``, ``benchmark/traffic/<traffic>.json``, the limits of its
compared numbers in ``benchmark/limits/<workload>.json`` and each
per-layer metric's reader in ``benchmark/metrics/<metric>.py``.  With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics and the traced window's breakdown.
The last line of standard output is the JSON result; the numbers that
decided ``correct`` are the last lines of standard error and the last
key of the result.  Exits 2 without a card (or with fewer than the cell
asks for) and 3 when JAX or the JAX package was loaded.
"""

import argparse
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

T0 = time.perf_counter()
HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from harness import env  # noqa: E402  (sets no state on import)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_cell(root: Path, workload: str):
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits_path = HERE / "limits" / f"{workload}.json"
    limits = json.loads(limits_path.read_text()) if limits_path.exists() else {}
    end_to_end = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    per_layer = [m for m in spec["per_layer"] if workload in m.get("workloads", [])
                 or ("workloads" not in m and any(e["name"] == m["moves"] for e in end_to_end))]
    return spec, cell, config, mix, limits, end_to_end, per_layer


def read_metric(name: str, run, config):
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run, config)


def end_to_end_values(run, setup_s: float):
    values = {"setup_s": setup_s}
    rate = run["images"] / run["window_s"]
    values["train_images_per_s"] = rate
    values["serve_images_per_s"] = rate
    if run.get("latencies"):
        lat = sorted(run["latencies"])
        values["serve_batch_p95_ms"] = 1e3 * statistics.quantiles(lat, n=20, method="inclusive")[18] \
            if len(lat) > 1 else 1e3 * lat[0]
    return values


def main(argv=None) -> int:
    args = parse(argv)
    env.set_caches()
    root = env.ROOT
    spec, cell, config, mix, limits, end_to_end, per_layer = load_cell(root, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    from harness import serve, train

    ctx = SimpleNamespace(config=config, mix=mix, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device="cuda")
    run = {"train": train.run, "serve": serve.run}[mix["loop"]](ctx)
    found = env.forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    line = result_line(run, config, limits, end_to_end, per_layer, bool(args.trace), run["setup_end"] - T0,
                       {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"]})
    for k, (v, lim) in line["compared"].items():
        print(f"compared {k}: {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


def result_line(run, config, limits, end_to_end, per_layer, trace: bool, setup_s: float, device):
    """The JSON result of one run: with ``trace`` the per-layer metrics
    the readers find and the breakdown, else the end-to-end metrics; the
    numbers compared with their limits under ``compared``, last."""
    if trace:
        metrics = {}
        for m in per_layer:
            v = read_metric(m["name"], run, config)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = end_to_end_values(run, setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in end_to_end}
    numbers = run["numbers"]
    device = dict(device, memory_peak_bytes=run.get("memory_peak_bytes", 0))
    line = {"correct": bool(limits) and all(numbers[k] <= limits[k] for k in limits),
            "attempted": run["steps"], "failed": int(run.get("failed", 0)), "metrics": metrics, "device": device}
    if trace:
        t = run["trace"]
        device.update(busy_s=t["busy_s"], window_s=t["window_s"])
        line["breakdown"] = {"device_ops": [[n, s] for n, s in t["device_ops"]],
                             "idle_gaps": [[n, s] for n, s in t["idle_gaps"]]}
    line["diagnostic"] = {k: v for k, v in numbers.items() if k not in limits}
    line["compared"] = {k: [numbers[k], limits[k]] for k in limits}
    return line


if __name__ == "__main__":
    sys.exit(main())
