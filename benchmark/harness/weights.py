"""Seeded weights for a model, drawn on its device in a few large calls.

The scales are a frozen copy of the program's seeded-weight rules (its
``bridge.seeded_flax_params``, as the benchmark was defined), keyed by
state-dict name: He-normal convs and linears (the stem at 1/64 of He, as
pixels enter at O(100)), the RPN at 0.01, box regression 0.001, the
region-embedding projection 0.01, the mask uncertainty head 0.001,
biases N(0, 0.1), frozen BN a near-identity affine (weight U(0.5, 1),
variance U(0.5, 1.5), bias and mean N(0, 0.1)), the word table N(0,
0.02) and ``lambda_exemplar`` 0.  They must not follow later changes to
the program.  The same seed gives the same tensors, so the reference
draws its copy again after the program's window.
"""

from typing import Dict

import torch

EMB_PRED_STD = 0.01


def _fan_in(name: str, shape) -> int:
    """Inputs per output of a conv, transposed conv or linear weight."""
    if len(shape) == 2:
        return shape[1]
    receptive = shape[2] * shape[3]
    # ConvTranspose2d keeps its weight as [in, out, kh, kw]
    return (shape[0] if "conv5_mask" in name else shape[1]) * receptive


def rule(name: str, shape):
    """``("normal", std)``, ``("uniform", lo, hi)`` or ``("zero",)``."""
    leaf = name.rsplit(".", 1)[-1]
    if name == "lambda_exemplar":
        return ("zero",)
    if name.endswith("word_embeddings"):
        return ("normal", 0.02)
    if "bn" in name.rsplit(".", 2)[-2]:
        if leaf == "weight":
            return ("uniform", 0.5, 1.0)
        if leaf == "running_var":
            return ("uniform", 0.5, 1.5)
        return ("normal", 0.1)
    if leaf == "bias":
        return ("normal", 0.1)
    if leaf != "weight":
        raise KeyError(f"no draw rule for {name}")
    for part, std in (("rpn_head", 0.01), ("bbox_pred", 0.001), ("emb_pred", EMB_PRED_STD),
                      ("uncertain_pred", 0.001)):
        if part in name:
            return ("normal", std)
    std = (2.0 / _fan_in(name, shape)) ** 0.5
    if ".stem." in name:
        std /= 64.0
    return ("normal", std)


def draw_state(template: Dict[str, torch.Tensor], seed: int, device) -> Dict[str, torch.Tensor]:
    """A float32 tensor on ``device`` for every entry of ``template`` (a
    state dict), from ``seed``: one normal and one uniform draw for all
    the entries, split and scaled by :func:`rule`."""
    names = sorted(template)
    rules = {n: rule(n, tuple(template[n].shape)) for n in names}
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2 ** 63))
    sizes = {n: template[n].numel() for n in names}
    normal = [n for n in names if rules[n][0] == "normal"]
    uniform = [n for n in names if rules[n][0] == "uniform"]
    z = torch.randn(sum(sizes[n] for n in normal), generator=gen, device=device)
    u = torch.rand(sum(sizes[n] for n in uniform), generator=gen, device=device)
    out = {}
    for pool, members in ((z, normal), (u, uniform)):
        for n, part in zip(members, torch.split(pool, [sizes[n] for n in members])):
            r = rules[n]
            part = part * r[1] if r[0] == "normal" else r[1] + part * (r[2] - r[1])
            out[n] = part.reshape(template[n].shape)
    for n in names:
        if rules[n][0] == "zero":
            out[n] = torch.zeros(template[n].shape, device=device)
    return out
