"""Does the mask head's uncertainty flag noisy pseudo-labels?  The
counterpart of ``tools/ablate_st.py``, on the port's ``MaskPredictor``:

    python -m cvpr22_cross_modal_pseudo_labeling_torch.tools.ablate_st \\
        [--steps 1200] [--seeds 3] [--device cuda|cpu]

A controlled synthetic study of the paper's claim that sigma flags noisy
pseudo-labels and that the adaptive weight ``0.01 / avg_uncertain`` beats
a fixed one, under both loss estimators (``MODEL.ROI_MASK_HEAD.
UNCERTAINTY_ESTIMATOR``): ``sampled_bce`` (one reparameterized sample,
the reference's) and ``logmeanexp`` (Kendall and Gal's attenuation over 8
samples).  Every example's true box is readable from feature channel 0;
"hard" examples carry a marker in channel 1 and their target is
replaced by a random box with probability :data:`CORRUPT_P`.  Per
estimator: sigma on the noisy against the clean population (ratio and
AUROC), the adaptive weight on pure batches and its trajectory, and a
linear probe trained with per-example weights ``0.01 / sigma`` on labels
corrupted on the noisy population, scored on clean held-out labels
against a fixed weight and an oracle that drops the noisy examples.

The data, the batch order and the probe's labels are JAX's numpy draws
(``np.random.RandomState``), bit-equal for a seed.  The head's weights
are drawn from a ``torch.Generator`` seeded by the seed, out of the
distributions of JAX's ``model.init``, and its sampling noise from
another, or given (``params=``, a flax tree such as JAX's ``model.init``;
``eps=``, each step's normal draws), as the CPU tests give JAX's.  The
head trains under optax's Adam, written out (:class:`OptaxAdam`), the
probe under plain SGD.  Prints one JSON line, as JAX's tool does.
"""

import argparse
import json
import math
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

CORRUPT_P = 0.8  # P(target replaced | hard example)


def make_data(rng, n, noisy_frac=0.5, m=14, feat_noise=0.35):
    """Features [n, m, m, 8]; targets [n, 2m, 2m]; is_noisy [n];
    is_corrupted [n]; clean_cls [n] (JAX's draws from ``rng``, a
    ``np.random.RandomState``)."""
    feats = rng.randn(n, m, m, 8).astype(np.float32) * feat_noise
    targets = np.zeros((n, 2 * m, 2 * m), np.float32)
    is_noisy = rng.rand(n) < noisy_frac
    is_corrupted = np.zeros(n, bool)
    areas = np.zeros(n, np.float32)
    for i in range(n):
        y0, x0 = rng.randint(4, 2 * m - 2, size=2)
        # the true geometry, always readable from channel 0
        feats[i, : max(y0 // 2, 1), : max(x0 // 2, 1), 0] += 1.0
        areas[i] = y0 * x0
        if is_noisy[i]:
            feats[i, :, :, 1] += 1.0  # the "hard image" marker
            if rng.rand() < CORRUPT_P:
                is_corrupted[i] = True
                ry0, rx0 = rng.randint(0, 2 * m - 6, size=2)
                rh, rw = rng.randint(4, m, size=2)
                targets[i, ry0 : ry0 + rh, rx0 : rx0 + rw] = 1.0
                continue
        targets[i, :y0, :x0] = 1.0
    # a clean attribute of the true geometry (median split on area)
    clean_cls = (areas > np.median(areas)).astype(np.int32)
    return feats, targets, is_noisy, is_corrupted, clean_cls


class OptaxAdam:
    """``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) in its
    own arithmetic: ``m = (1 - b1) g + b1 m``, ``v = (1 - b2) g^2 + b2 v``,
    ``p += -lr * m_hat / (sqrt(v_hat) + eps)`` with float32 bias
    corrections."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self):
        self.count += 1
        c1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(self.count))
        c2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(self.count))
        for p, mu, nu in zip(self.params, self.mu, self.nu):
            g = p.grad
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            p.add_(-self.lr * update)
            p.grad = None


def _init_like_jax(model, generator: torch.Generator):
    """JAX's ``MaskPredictor`` initializers: ``variance_scaling(2.0,
    "fan_out", "truncated_normal")`` for ``conv5_mask`` and
    ``mask_fcn_logits`` (biases 0), normal(0.001) and bias 1 for
    ``uncertain_pred``."""
    with torch.no_grad():
        for conv, fan_out in ((model.conv5_mask, model.conv5_mask.weight[0].numel()),
                              (model.mask_fcn_logits, model.mask_fcn_logits.weight[:, 0].numel())):
            std = math.sqrt(2.0 / fan_out) / 0.87962566103423978
            torch.nn.init.trunc_normal_(conv.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
            conv.bias.zero_()
        model.uncertain_pred.weight.normal_(0.0, 0.001, generator=generator)
        model.uncertain_pred.bias.fill_(1.0)


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy``."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def train_mask_head(
    seed, steps, batch, feats, targets, estimator, num_samples, lr=1e-3, traj_every=0, dim_reduced=256,
    device="cpu", params=None, eps: Optional[Sequence[np.ndarray]] = None,
) -> Tuple[Callable, List[Tuple[int, float]]]:
    """Trains the port's ``MaskPredictor`` under ``estimator``; returns
    ``(sigma_of, trajectory)``: ``sigma_of(feats)`` is each example's mean
    sigma (numpy), the trajectory ``[(step, mean sigma)]`` when
    ``traj_every``.  The batches are JAX's (``RandomState(seed + 1)``);
    ``params`` (a flax tree) replaces the drawn weights, ``eps[s]`` (``[
    num_samples, batch, 2m, 2m, 1]``) step s's normal draws."""
    from .. import bridge
    from ..models.roi_heads.mask_head import MaskPredictor

    device = torch.device(device)
    model = MaskPredictor(in_channels=feats.shape[-1], num_classes=1, dim_reduced=dim_reduced, uncertainty=True)
    if params is not None:
        bridge.load_flax_params(model, params)
    else:
        _init_like_jax(model, torch.Generator().manual_seed(seed))
    model.to(device)
    opt = OptaxAdam(model.parameters(), lr)
    n = feats.shape[0]
    idx_all = np.random.RandomState(seed + 1).randint(0, n, size=(steps, batch))
    feats_d = torch.as_tensor(feats, device=device)
    targets_d = torch.as_tensor(targets, device=device)
    generator = torch.Generator(device=device).manual_seed(seed + 2)
    sigma_per_step = []
    for s in range(steps):
        idx = torch.as_tensor(idx_all[s], device=device)
        x, y = feats_d[idx], targets_d[idx]
        draw = None if eps is None else torch.tensor(np.asarray(eps[s]), device=device)
        logits, scale = model(x, compute_uncertain=True, train=True, num_samples=num_samples, eps=draw,
                              generator=generator)
        bce = sigmoid_bce(logits, y[None, ..., None].expand(logits.shape))
        if estimator == "logmeanexp":
            # Kendall and Gal's attenuation over the sample axis
            bce = -(torch.logsumexp(-bce, dim=0) - math.log(float(num_samples)))
        bce.mean().backward()
        opt.step()
        sigma_per_step.append(scale.detach().mean())
    sigma_per_step = torch.stack(sigma_per_step).cpu().numpy() if steps else np.zeros(0, np.float32)
    trajectory = []
    if traj_every:
        for it in list(range(0, steps, traj_every)) + [steps - 1]:
            if not trajectory or trajectory[-1][0] != it:
                trajectory.append((it, round(float(sigma_per_step[it]), 4)))

    @torch.no_grad()
    def sigma_of(x):
        _, scale = model(torch.as_tensor(np.asarray(x), device=device), compute_uncertain=True, train=False)
        return scale[..., 0].mean(dim=(1, 2)).cpu().numpy()

    return sigma_of, trajectory


def auroc(scores, labels):
    """Rank AUROC of scores for binary labels (no sklearn)."""
    order = np.argsort(scores)
    ranks = np.empty(len(scores))
    ranks[order] = np.arange(1, len(scores) + 1)
    pos = labels.astype(bool)
    n_pos, n_neg = pos.sum(), (~pos).sum()
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def downstream_cls(seed, steps, feats, labels_noisy, labels_clean, weights, n_train, lr=0.5, device="cpu"):
    """A linear probe on the pooled features, trained by SGD on per-example
    weighted cross-entropy over the noisy labels of the first ``n_train``
    examples; returns its clean-label accuracy on the rest."""
    device = torch.device(device)
    pooled = feats.mean(axis=(1, 2))  # [n, 8]
    x_tr = torch.as_tensor(pooled[:n_train], device=device)
    y_tr = torch.as_tensor(labels_noisy[:n_train], dtype=torch.int64, device=device)
    w_tr = weights[:n_train]
    w_tr = torch.as_tensor(w_tr / w_tr.mean(), dtype=torch.float32, device=device)  # the control's mean weight
    w = torch.zeros((pooled.shape[1], 2), device=device, requires_grad=True)
    b = torch.zeros((2,), device=device, requires_grad=True)
    for _ in range(steps):
        logits = x_tr @ w + b
        ce = torch.logsumexp(logits, dim=-1) - logits.gather(-1, y_tr[:, None])[:, 0]
        gw, gb = torch.autograd.grad((w_tr * ce).mean(), (w, b))
        with torch.no_grad():
            w.add_(-lr * gw)
            b.add_(-lr * gb)
    with torch.no_grad():
        pred = torch.argmax(torch.as_tensor(pooled[n_train:], device=device) @ w + b, -1).cpu().numpy()
    return float((pred == labels_clean[n_train:]).mean())


def run_estimator(seed, steps, estimator, num_samples, data, batch=32, n_train=160, device="cpu") -> Dict:
    feats, targets, is_noisy, is_corrupted, clean_cls = data
    n = feats.shape[0]
    sigma_of, traj = train_mask_head(seed, steps, batch, feats, targets, estimator, num_samples,
                                     traj_every=max(steps // 8, 1), device=device)
    sigmas = np.concatenate([sigma_of(feats[i : i + 64]) for i in range(0, n, 64)])
    sig_noisy = float(sigmas[is_noisy].mean())
    sig_clean = float(sigmas[~is_noisy].mean())
    # the adaptive weight on pure-clean and pure-noisy batches
    lam_clean = 0.01 / max(sig_clean, 1e-20)
    lam_noisy = 0.01 / max(sig_noisy, 1e-20)
    # the probe: labels random exactly on the noisy population
    rng = np.random.RandomState(seed + 17)
    labels_noisy = np.where(is_noisy, rng.randint(0, 2, size=n), clean_cls).astype(np.int32)
    w_adaptive = 0.01 / np.maximum(sigmas, 1e-20)
    weights = {
        "adaptive": w_adaptive,
        "fixed": np.ones_like(w_adaptive),
        "oracle_drop_noisy": (~is_noisy).astype(np.float32) + 1e-6,
    }
    accs = {name: downstream_cls(seed, 3000, feats, labels_noisy, clean_cls, w, n_train, device=device)
            for name, w in weights.items()}
    return {
        "estimator": estimator,
        "num_samples": num_samples,
        "sigma_clean": round(sig_clean, 4),
        "sigma_noisy": round(sig_noisy, 4),
        "sigma_ratio": round(sig_noisy / max(sig_clean, 1e-20), 4),
        "sigma_auroc_vs_noisy": round(auroc(sigmas, is_noisy), 4),
        "lambda_clean_batch": round(lam_clean, 5),
        "lambda_noisy_batch": round(lam_noisy, 5),
        "avg_sigma_trajectory": traj,
        **{f"acc_{k}": round(v, 4) for k, v in accs.items()},
    }


def run_seed(seed, steps, n=768, device="cpu") -> Dict:
    data = make_data(np.random.RandomState(seed), n)
    return {
        "ref": run_estimator(seed, steps, "sampled_bce", 1, data, device=device),
        "kg": run_estimator(seed, steps, "logmeanexp", 8, data, device=device),
    }


def aggregate(rows, variant, key):
    return round(float(np.mean([r[variant][key] for r in rows])), 4)


def summarize(rows, steps: int) -> Dict:
    """The study's record and its claims over the seeds' rows."""
    scalar_keys = [k for k, v in rows[0]["ref"].items() if isinstance(v, (int, float)) and k != "num_samples"]
    mean = {variant: {k: aggregate(rows, variant, k) for k in scalar_keys} for variant in ("ref", "kg")}
    ref, kg = mean["ref"], mean["kg"]
    traj0 = rows[0]["ref"]["avg_sigma_trajectory"]
    return {
        "study": "uncertainty_efficacy",
        "seeds": len(rows),
        "steps": steps,
        "corrupt_p": CORRUPT_P,
        "mean": mean,
        "per_seed": rows,
        "claims": {
            # the paper's narrative, as the K&G estimator realizes it
            "kg_sigma_discriminates_noise": kg["sigma_ratio"] > 1.1 and kg["sigma_auroc_vs_noisy"] > 0.9,
            "kg_adaptive_lambda_downweights_noise": kg["lambda_noisy_batch"] < kg["lambda_clean_batch"],
            "kg_adaptive_beats_fixed_on_clean_heldout": kg["acc_adaptive"] > kg["acc_fixed"],
            # the reference's estimator: sigma shrinks fastest on noisy
            # targets (Jensen), so the per-batch weight is inverted ...
            "ref_sigma_inverted": ref["sigma_ratio"] < 1.0,
            # ... and acts as a rising anneal of the pseudo-loss weight
            "ref_weight_anneals_up": traj0[-1][1] < traj0[0][1],
        },
    }


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description="does sigma flag noisy pseudo-labels? (PyTorch port)")
    p.add_argument("--steps", type=int, default=1200)
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
    out = summarize([run_seed(s, args.steps, device=args.device) for s in range(args.seeds)], args.steps)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
