"""The traced window: profiler, spans, launch records and host syncs, and
their reduction to what the per-layer metric readers read.

Spans are the benchmark's own: ``record_function`` ranges around the
calls the loop makes into the program (``bench::step_dispatch``,
``bench::predictor_call``) and forward hooks on the detector's modules
(``bench::module::<name>``).  The batch hand-off and the metrics' copy
happen inside the program's ``do_train`` and have no span here.  Device time is read from the profiler's
device events; an op's device time is that of the kernels linked to it
or to any op under it, so a kernel rewritten under the same op keeps its
metric.
"""

import bisect
import time
import warnings
from collections import defaultdict
from typing import Dict, List, Optional

import torch

SPAN_MODULES = ("backbone", "rpn_head", "roi_extractor", "mask_predictor", "bert")
KERNEL_OPS = {
    "nms": ("cmpl::nms",),
    "roi_align": ("cmpl::roi_align", "cmpl::roi_align_levels"),
    "roi_align_backward": ("cmpl::roi_align_backward",),
}


def span(name: str):
    return torch.profiler.record_function(f"bench::{name}")


def module_spans(model: torch.nn.Module) -> List:
    """Forward hooks that open a span when each named module's forward
    starts and close it when it ends; returns the hook handles."""
    handles = []
    for name, mod in model.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        if leaf not in SPAN_MODULES:
            continue
        label = f"bench::module::{name}"

        def pre(module, args, _label=label):
            rf = torch.profiler.record_function(_label)
            rf.__enter__()
            module._bench_spans = getattr(module, "_bench_spans", []) + [rf]

        def post(module, args, output):
            module._bench_spans.pop().__exit__(None, None, None)

        handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    return handles


def add_launch_hook(kernel, fn):
    """Adds ``fn`` to the port's ``on_launch`` hook of ``kernel`` (called
    after every launch with the launch's inputs and outputs), after any
    hook already there; returns the function that takes it off again."""
    prev = kernel.on_launch

    def hook(inputs, out):
        if prev is not None:
            prev(inputs, out)
        fn(inputs, out)

    kernel.on_launch = hook

    def remove():
        kernel.on_launch = prev

    return remove


class LaunchRecorder:
    """Keeps each kernel launch's inputs while it is on, through the port's
    ``on_launch`` hooks: references to the small tensors (nothing changes
    them after the launch, so no copy runs on the device) and the shapes
    of the large ones.  The work is computed after the window, so that
    nothing waits on the device inside it."""

    def __init__(self):
        self.records: Dict[str, List] = defaultdict(list)
        self.on = False
        self._removers = []

    def install(self):
        from cvpr22_cross_modal_pseudo_labeling_torch.ops import kernels

        def nms(inputs, out):
            if self.on:
                boxes, scores, valid, _, k, labels = inputs
                self.records["nms"].append((scores, valid, labels, out[0], out[1], k))

        def roi(inputs, out):
            if self.on:
                f, rois = inputs[0], inputs[1]
                self.records["roi_align"].append((tuple(f.shape), f.element_size(), rois) + tuple(inputs[2:7]))

        def bwd(inputs, out):
            if self.on:
                g, rois, fshape = inputs[0], inputs[1], inputs[2]
                self.records["roi_align_backward"].append(
                    (tuple(g.shape), g.element_size(), rois, tuple(fshape)) + tuple(inputs[4:9]))

        self._removers = [add_launch_hook(kernels.NMS, nms), add_launch_hook(kernels.ROI_ALIGN, roi),
                          add_launch_hook(kernels.ROI_ALIGN_BACKWARD, bwd)]

    def remove(self):
        for r in reversed(self._removers):
            r()
        self._removers = []

    def work(self) -> Dict[str, List]:
        """Per kernel, each launch's (bytes, operations) in launch order."""
        from work import kernels as w

        out = {}
        out["nms"] = [w.nms_work(s, v, lab, i, k_, k) for s, v, lab, i, k_, k in self.records["nms"]]
        out["roi_align"] = [w.roi_align_work(shape, es, rois, size, scale, sr, ms, bs)
                            for shape, es, rois, size, scale, sr, ms, bs in self.records["roi_align"]]
        out["roi_align_backward"] = [w.roi_align_backward_work(gs, es, rois, fs, size, scale, sr, ms, bs)
                                     for gs, es, rois, fs, size, scale, sr, ms, bs in self.records["roi_align_backward"]]
        return out


class SyncCounter:
    """Counts the synchronizing CUDA calls while it is open, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""

    def __init__(self):
        self.count = 0

    def __enter__(self):
        self._catch = warnings.catch_warnings(record=True)
        self._caught = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        self.count = sum("synchronizing CUDA operation" in str(w.message) for w in self._caught)
        self._catch.__exit__(*exc)


class Window:
    """The profiler over the traced window."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.t0: Optional[float] = None
        self.t1: Optional[float] = None

    def start(self):
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def analyse(self) -> Dict:
        """Device intervals, busy seconds, the longest device ops, idle gaps
        by the innermost benchmark span open when each gap began, and the
        device seconds under each kernel op."""
        raw = self.prof.profiler.kineto_results.events()
        device, spans = [], []
        for e in raw:
            dt = str(e.device_type())
            start, dur = e.start_ns(), e.duration_ns()
            if e.name().startswith("bench::"):
                # a span; on the device's timeline its annotation is no work
                if "CUDA" not in dt:
                    spans.append((start, start + dur, e.name()[len("bench::"):]))
            elif "CUDA" in dt:
                device.append((start, start + dur, e.name()))
        device.sort()
        merged = []
        for s, t, _ in device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        busy = sum(t - s for s, t in merged)
        by_name = defaultdict(float)
        for s, t, name in device:
            by_name[name] += (t - s) * 1e-9
        gaps = defaultdict(float)
        spans.sort()
        starts = [s for s, _, _ in spans]
        for (_, t0), (s1, _) in zip(merged, merged[1:]):
            # the innermost span open when the device went idle: the
            # latest-starting one that has not ended
            label = "no benchmark span"
            i = bisect.bisect_right(starts, t0)
            while i > 0:
                i -= 1
                if spans[i][1] >= t0:
                    label = spans[i][2]
                    break
            gaps[label] += (s1 - t0) * 1e-9
        return dict(
            busy_s=busy * 1e-9,
            window_s=self.t1 - self.t0,
            device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
            idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1])[:10],
            op_device_s=self.op_device_s(),
        )

    def op_device_s(self) -> Dict[str, List[float]]:
        """Per kernel op of :data:`KERNEL_OPS`, each call's device seconds:
        the kernels linked to the op or to any op it called."""
        out = {k: [] for k in KERNEL_OPS}
        names = {n: k for k, ns in KERNEL_OPS.items() for n in ns}

        for ev in self.prof.events():
            key = names.get(ev.name)
            if key is None or (ev.cpu_parent is not None and ev.cpu_parent.name in names):
                continue
            # the op's kernels and those of every op under it, in us
            out[key].append(ev.device_time_total * 1e-6)
        return out
