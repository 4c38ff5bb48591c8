"""The training loop of a cell: the program's ``do_train`` over
``Trainer.train_step``, as its ``train_net`` runs it.

Set-up builds one ``Trainer`` from the configuration's YAML, loads
weights drawn on the card from the seed, and drives that same object
through ``do_train`` on the pool's batches: first the compared steps,
each on its own batch with random draws the benchmark makes from the
seed (the ``TrainDraws`` that ``Trainer.train_step`` takes), then one
step of every other bucket the pool holds, so that every shape is warm.
The window follows in the same ``do_train`` call, on the pool cycled;
it ends in a synchronize once ``--seconds`` have passed, and the step
function then leaves the loop by raising :class:`WindowClosed`, so that
the loop saves no checkpoint.  After the window the program's state is
freed, and the float32 reference follows the compared steps from the
same weights, batches and draws.
"""

import contextlib
import gc
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import compare, traffic, weights
from .env import ROOT
from .trace import LaunchRecorder, SyncCounter, Window, module_spans, span


class WindowClosed(Exception):
    """Raised by the step function when the window's time is up."""


class Choices(TorchDispatchMode):
    """The discrete choices a compared step of the program makes, read at
    its custom ops while the mode is on: each ``cmpl::nms`` call's inputs
    and outputs and each ``cmpl::roi_align`` call's rois.  The reference
    follows them (:meth:`given`), so that its comparison is not of two
    different sets of proposals: with random weights the RPN's scores lie
    close together and bf16 ties many of them."""

    def __init__(self):
        super().__init__()
        self.nms, self.rois = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._schema.name
        if name == "cmpl::nms":
            boxes, scores, valid, _, k = args[:5]
            self.nms.append(dict(boxes=boxes.detach().clone(), scores=scores.detach().clone(),
                                 valid=valid.clone(), idx=out[0].to(torch.int64), keep=out[1].clone(), k=int(k)))
        elif name == "cmpl::roi_align":
            self.rois.append(args[1].detach().clone())
        return out

    def given(self, m) -> Dict:
        """The step's two proposal selections, in the order the
        student-teacher step makes them (the eval selector's for the
        caption branch, then the train selector's), and its pseudo boxes
        (the rois pooled once per caption noun)."""
        pseudo = [r for r in self.rois if r.shape[1] == m["max_cap_nouns"]]
        ks = [c.pop("k") for c in self.nms]
        if ks != [m["rpn_post_nms_test"], m["rpn_post_nms_train"]] or len(pseudo) != 1:
            raise RuntimeError(f"a compared step kept {ks} proposals and pooled {len(pseudo)} sets of pseudo boxes")
        return dict(eval=self.nms[0], train=self.nms[1], pseudo=pseudo[0])


def anchors_count(hw, m) -> int:
    h, w = hw
    return -(-h // m["anchor_stride"]) * -(-w // m["anchor_stride"]) * len(m["anchor_sizes"]) * len(m["aspect_ratios"])


def make_draws(config, hw, b, seed: int, step: int, device) -> Dict[str, torch.Tensor]:
    """One compared step's draws, from the seed on ``device``: the
    samplers' uniform priorities and the mask uncertainty's normal
    samples, in the mask logits' dtype."""
    m = config["model"]
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 7919 + 104729 * (step + 1)) % (2 ** 63))
    cap = min(m["mask_pos_cap"], m["roi_batch_per_image"])
    dtype = torch.bfloat16 if m["compute_dtype"] == "bfloat16" else torch.float32
    out = {"gt_sampler": torch.rand((b, 2, m["rpn_post_nms_train"] + m["max_gt"]), generator=gen, device=device)}
    if config["kind"] == "teacher":
        out["rpn_sampler"] = torch.rand((b, 2, anchors_count(hw, m)), generator=gen, device=device)
    else:
        out["pseudo_sampler"] = torch.rand((b, 2, m["rpn_post_nms_test"]), generator=gen, device=device)
        out["mask_eps"] = torch.randn((1, b * cap, 14, 14, 2), generator=gen, device=device).to(dtype)
    return out


def setup_order(batches, n_cmp: int) -> List[int]:
    """The compared steps' batches first, then one batch of every bucket
    they leave out."""
    seen, order = set(), []
    for i, b in enumerate(batches):
        hw = b["images"].shape[1:3]
        if i < n_cmp or hw not in seen:
            order.append(i)
        seen.add(hw)
    return order


def run(ctx) -> Dict:
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import Trainer
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.trainer import do_train
    from cvpr22_cross_modal_pseudo_labeling_torch.models.detector.generalized_rcnn import TrainDraws

    config, mix, dev = ctx.config, ctx.mix, torch.device(ctx.device)
    cuda = dev.type == "cuda"
    n_cmp = mix["compared_steps"]
    out_dir = tempfile.mkdtemp(prefix="benchmark_train_")
    try:
        opts = ["OUTPUT_DIR", out_dir, "SOLVER.CHECKPOINT_PERIOD", 10 ** 9, "SOLVER.TEST_PERIOD", 0,
                "SOLVER.MAX_ITER", 10 ** 9] + list(config.get("opts", []))
        trainer = Trainer(str(ROOT / config["yaml"]), opts, device=ctx.device, seed=ctx.seed % (2 ** 62))
        trainer.model.load_state_dict(weights.draw_state(trainer.model.state_dict(), ctx.seed, dev))
        batches, tables = traffic.make_pool(ctx.seed, mix, config)
        trainer.set_class_tables(**tables)
        order = setup_order(batches, n_cmp)
        b = mix["batch"]
        draws = [make_draws(config, batches[i]["images"].shape[1:3], b, ctx.seed, s, dev)
                 for s, i in enumerate(order[:n_cmp])]
        recorder = LaunchRecorder() if ctx.trace else None
        hooks = module_spans(trainer.model) if ctx.trace else []
        if recorder:
            recorder.install()
        st = dict(step=0, losses=[], grad1=None, after=None, t0=None, t1=None, steps=0, window=None,
                  syncs=None, given=[])
        follow = config["kind"] == "student_teacher"
        seconds = min(ctx.seconds, mix["trace_seconds"]) if ctx.trace else ctx.seconds
        names = trainer.optimizer.names

        def loader():
            for i in order:
                yield batches[i], None
            while True:
                for batch in batches:
                    yield batch, None

        def step_fn(batch):
            i = st["step"]
            if i < len(order):
                d = TrainDraws(**draws[i]) if i < n_cmp else None
                with Choices() if follow and i < n_cmp else contextlib.nullcontext() as choices:
                    metrics = trainer.train_step(batch, d)
                if i < n_cmp:
                    st["losses"].append({k: v for k, v in metrics.items() if k.startswith("loss")})
                    if choices is not None:
                        st["given"].append(choices.given(config["model"]))
                if i == 0:
                    # a parameter the optimizer never stepped has no buffer
                    mom = trainer.optimizer.state_dict()["momentum"]
                    st["grad1"] = {n: (mom[n].detach().clone() if n in mom
                                       else torch.zeros_like(trainer.model.get_parameter(n))) for n in names}
                if i == n_cmp - 1:
                    st["after"] = {n: trainer.model.get_parameter(n).detach().clone() for n in names}
                st["step"] += 1
                if st["step"] == len(order):
                    if cuda:
                        torch.cuda.synchronize()
                    if ctx.trace:
                        recorder.on = True
                        st["window"] = Window()
                        st["syncs"] = SyncCounter().__enter__()
                        st["window"].start()
                    st["t0"] = time.perf_counter()
                return metrics
            if time.perf_counter() - st["t0"] >= seconds:
                if ctx.trace:
                    st["window"].stop()
                    st["syncs"].__exit__(None, None, None)
                    recorder.on = False
                elif cuda:
                    torch.cuda.synchronize()
                st["t1"] = time.perf_counter()
                raise WindowClosed
            with span("step_dispatch") if ctx.trace else contextlib.nullcontext():
                metrics = trainer.train_step(batch)
            st["steps"] += 1
            st["step"] += 1
            return metrics

        try:
            do_train(step_fn, trainer, loader(), trainer.cfg, output_dir=out_dir)
        except WindowClosed:
            pass
        else:
            raise RuntimeError("do_train ended before the window closed")
        for h in hooks:
            h.remove()
        result = dict(
            steps=st["steps"], images=st["steps"] * b, window_s=st["t1"] - st["t0"],
            setup_end=st["t0"],
            window_buckets=[tuple(batches[j % len(batches)]["images"].shape[1:3]) for j in range(st["steps"])],
        )
        if cuda:
            result["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        if ctx.trace:
            result["trace"] = st["window"].analyse()
            result["launch_work"] = recorder.work()
            result["syncs"] = st["syncs"].count
            result["traced_steps"] = st["steps"]
        prog = dict(
            losses=[{k: float(v) for k, v in lo.items()} for lo in st["losses"]],
            grad1=st["grad1"], after=st["after"], given=st["given"] or None,
        )
        del trainer, step_fn, st
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        cmp_batches = [batches[i] for i in order[:n_cmp]]
        result["numbers"] = check(ctx, prog, cmp_batches, tables, draws, "float32")
        return result
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def program_side(config, prog, initial: Dict[str, torch.Tensor]) -> Dict:
    """The program's first gradient, from its momentum after one step
    (weight decay added the step's weights times the decay), and its
    change over the compared steps."""
    s = config["solver"]
    grad1 = {n: buf - (s["weight_decay_bias"] if n.endswith("bias") else s["weight_decay"]) * initial[n]
             for n, buf in prog["grad1"].items()}
    delta = {n: p - initial[n] for n, p in prog["after"].items()}
    return dict(losses=prog["losses"], grad1=grad1, delta=delta)


def reference_steps(config, batches, tables, draws, state, device, precision: str, given=None) -> Dict:
    """The reference's compared steps from ``state``: each step's losses,
    the first step's gradient and the change of the trainable
    parameters; with ``given`` (a step's candidate choices each, the
    student-teacher model's), the choices followed and the selection
    stage's gaps (``gaps``); ``chosen``, the reference's own choices."""
    from reference import model as R, optim as RO

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device(device):
        ref = R.build(config["kind"], config["model"])
    ref.load_state_dict(state)
    R.set_precision(ref, precision)
    params = dict(ref.named_parameters())
    names = RO.trainable(list(params), config["frozen"])
    for n, p in params.items():
        p.requires_grad_(n in names)
    opt = RO.SGD({n: params[n] for n in names}, config["solver"])
    initial = {n: params[n].detach().clone() for n in names}
    losses, grad1, gaps, chosen = [], None, [], []
    for step, (batch, d) in enumerate(zip(batches, draws)):
        hb = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        d = {k: v.to(device, torch.float32) for k, v in d.items()}
        table = torch.as_tensor(tables["class_embeddings"]).to(device)
        if config["kind"] == "teacher":
            lo = ref.losses(hb, table, d)
        else:
            lo = ref.losses(hb, {"classes": table, "lvis": torch.as_tensor(tables["lvis_class_embeddings"]).to(device)}, d,
                            given[step] if given else None)
            gaps.append(ref.gaps)
            chosen.append(ref.chosen)
        trained = [n for n in names if params[n].requires_grad]
        grads = torch.autograd.grad(sum(lo.values()), [params[n] for n in trained], allow_unused=True)
        g = {n: x for n, x in zip(trained, grads) if x is not None}
        if step == 0:
            grad1 = {n: g.get(n, torch.zeros_like(params[n])).detach().clone() for n in names}
        opt.step(g)
        losses.append({k: float(v.detach()) for k, v in lo.items()})
        del lo, grads, g
    delta = {n: params[n].detach() - initial[n] for n in names}
    return dict(losses=losses, grad1=grad1, delta=delta, gaps=gaps, chosen=chosen or None)


def check(ctx, prog, batches, tables, draws, precision="float32") -> Dict[str, float]:
    """The compared numbers of the program's compared steps against the
    reference's, which follows them in ``precision`` (float32; the
    control's lower precision in the control's own runs)."""
    dev = torch.device(ctx.device)
    state = weights.draw_state(_template(ctx.config, dev), ctx.seed, dev)
    initial = {n: state[n] for n in prog["grad1"]}
    p = program_side(ctx.config, prog, initial)
    r = reference_steps(ctx.config, batches, tables, draws, state, dev, precision, prog.get("given"))
    return compare.train_numbers(p, r)


def _template(config, device) -> Dict[str, torch.Tensor]:
    """The state dict's names and shapes, from the reference's modules
    (they carry the program's names)."""
    from reference import model as R

    with torch.device("meta"):
        ref = R.build(config["kind"], config["model"])
    return {k: v for k, v in ref.state_dict().items()}
