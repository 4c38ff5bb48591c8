"""The serving loop of a cell: one client calling the program's
``Predictor`` back to back, each batch timed from the call to its numpy
results.

Set-up builds the ``Predictor`` from the configuration's YAML, loads
weights drawn on the card from the seed, makes the pool and serves every
bucket of it twice.  The window then serves the pool cycled until
``--seconds`` have passed, and keeps, for a sample of its calls drawn
from the seed as they come (a reservoir), references to what each
``cmpl::nms`` launch of the call took and kept: the RPN's proposal
selection and the detections' NMS.  Afterwards the program is freed,
and the float32 reference serves the sampled calls' batches: it follows
the program's proposals, holds the proposal selection and the detection
NMS by themselves, and computes the detections, their scores and masks
again, on its own boxes and on the boxes the program served.
"""

import contextlib
import gc
import random
import time
from typing import Dict, List

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import compare, traffic, weights
from .env import ROOT
from .trace import LaunchRecorder, SyncCounter, Window, add_launch_hook, module_spans, span


class NmsTap:
    """References to the inputs and outputs of each ``cmpl::nms`` launch
    of the call in progress.  On the card the port's launch hook feeds
    it, which costs the device nothing; the plain version on the CPU
    calls no hook, so there (the tests) a dispatch mode around each call
    reads the op instead."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.launches: List[Dict] = []
        self._remove = None

    def record(self, inputs, out):
        boxes, scores, valid, _, k, labels = inputs
        self.launches.append(dict(boxes=boxes, scores=scores, valid=valid, labels=labels, idx=out[0],
                                  keep=out[1], k=int(k)))

    def install(self):
        if self.cuda:
            from cvpr22_cross_modal_pseudo_labeling_torch.ops import kernels

            self._remove = add_launch_hook(kernels.NMS, self.record)

    def remove(self):
        if self._remove is not None:
            self._remove()
            self._remove = None

    def around_call(self):
        return contextlib.nullcontext() if self.cuda else _OpTap(self)

    def take(self, m) -> Dict[str, Dict]:
        """The call's two launches, checked by what they keep: ``rpn``, the
        proposal selection, and ``det``, the detections' NMS."""
        launches, self.launches = self.launches, []
        ks = [x.pop("k") for x in launches]
        if ks != [m["rpn_post_nms_test"], m["detections_per_img"]]:
            raise RuntimeError(f"a served call made NMS launches keeping {ks}")
        return dict(rpn=launches[0], det=launches[1])


class _OpTap(TorchDispatchMode):
    def __init__(self, tap: NmsTap):
        super().__init__()
        self.tap = tap

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func._schema.name == "cmpl::nms":
            self.tap.record(tuple(args) + (None,) * (6 - len(args)), out)
        return out


def run(ctx) -> Dict:
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.inference import Predictor

    config, mix, dev = ctx.config, ctx.mix, torch.device(ctx.device)
    cuda = dev.type == "cuda"
    pred = Predictor(str(ROOT / config["yaml"]), list(config.get("opts", [])), device=ctx.device)
    pred.model.load_state_dict(weights.draw_state(pred.model.state_dict(), ctx.seed, dev))
    batches, tables = traffic.make_pool(ctx.seed, mix, config)
    table = tables["class_embeddings"]
    warmed = {}
    for b in batches:
        hw = b["images"].shape[1:3]
        while warmed.get(hw, 0) < 2:
            pred(b["images"], b["image_sizes"], table)
            warmed[hw] = warmed.get(hw, 0) + 1
    recorder = LaunchRecorder() if ctx.trace else None
    hooks = module_spans(pred.model) if ctx.trace else []
    if recorder:
        recorder.install()
    tap = NmsTap(cuda)
    tap.install()
    n_cmp = mix["compared_batches"]
    reservoir, draw = [], random.Random(ctx.seed)
    seconds = min(ctx.seconds, mix["trace_seconds"]) if ctx.trace else ctx.seconds
    if cuda:
        torch.cuda.synchronize()
    window = syncs = None
    if ctx.trace:
        recorder.on = True
        window, syncs = Window(), SyncCounter().__enter__()
        window.start()
    latencies, served = [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        b = batches[len(latencies) % len(batches)]
        t = time.perf_counter()
        with span("predictor_call") if ctx.trace else contextlib.nullcontext(), tap.around_call():
            dets, masks = pred(b["images"], b["image_sizes"], table)
        latencies.append(time.perf_counter() - t)
        served.append(dict(boxes=dets.boxes, scores=dets.scores, labels=dets.labels, valid=dets.valid,
                           masks=masks))
        i, given = len(served) - 1, tap.take(config["model"])
        if i < n_cmp:
            reservoir.append((i, given))
        else:
            j = draw.randrange(i + 1)
            if j < n_cmp:
                reservoir[j] = (i, given)
    if ctx.trace:
        window.stop()
        syncs.__exit__(None, None, None)
        recorder.on = False
    t1 = time.perf_counter()
    tap.remove()
    if recorder:
        recorder.remove()
    for h in hooks:
        h.remove()
    n = len(latencies)
    failed = sum(not all(np.isfinite(s[k]).all() for k in ("boxes", "scores", "masks")) for s in served)
    result = dict(
        steps=n, images=n * mix["batch"], window_s=t1 - t0, setup_end=t0, latencies=latencies, failed=failed,
        window_buckets=[tuple(batches[j % len(batches)]["images"].shape[1:3]) for j in range(n)],
    )
    if cuda:
        result["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    if ctx.trace:
        result["trace"] = window.analyse()
        result["launch_work"] = recorder.work()
        result["syncs"] = syncs.count
        result["traced_steps"] = n
    del pred
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    sample = [(batches[j % len(batches)], served[j], given) for j, given in sorted(reservoir, key=lambda x: x[0])]
    result["numbers"] = check(ctx, sample, table, "float32")
    # how much detection and mask work the window's batches carried
    result["numbers"]["served_dets_per_image"] = float(np.mean([s["valid"].sum(-1).mean() for s in served]))
    return result


def reference_outputs(config, sample, table, seed, device, precision: str) -> List[Dict]:
    """The reference's detections of each sampled batch, following the
    proposals the candidate chose where it gives them, with that stage's
    gaps (``gaps``), its own choices (``chosen``) and its masks on the
    boxes that were served (``sample``: (batch, served, given) triples; a
    None served has no such masks, a None given no proposals to
    follow)."""
    from reference import model as R

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device(device):
        ref = R.build(config["kind"], config["model"])
    ref.load_state_dict(weights.draw_state(ref.state_dict(), seed, device))
    R.set_precision(ref, precision)
    ref.requires_grad_(False)
    t = torch.as_tensor(table).to(device)
    out = []
    with torch.no_grad():
        for batch, served, given in sample:
            images = torch.as_tensor(batch["images"]).to(device)
            sizes = torch.as_tensor(batch["image_sizes"]).to(device)
            d, feats = ref.serve(images, sizes, t, given)
            out.append({k: v.cpu().numpy() for k, v in d._asdict().items()})
            out[-1].update(gaps=ref.gaps, chosen=ref.chosen)
            if served is not None:
                boxes = torch.as_tensor(served["boxes"]).to(device)
                mlog, _ = ref.student.mask_logits(ref.student.extract(feats, boxes))
                masks = torch.sigmoid(mlog[:, 1]).reshape(boxes.shape[0], -1, *mlog.shape[-2:])
                out[-1]["masks_on_served"] = masks.cpu().numpy()
    return out


def check(ctx, sample, table, precision="float32") -> Dict[str, float]:
    dev = torch.device(ctx.device)
    ref = reference_outputs(ctx.config, sample, table, ctx.seed, dev, precision)
    return compare.serve_numbers([s for _, s, _ in sample], ref)
