"""The port's MMSS modules against the JAX package on the CPU: the grid
regions and the spatial dropout, MLM masking, BERT, both MMSS heads and
``MMSSGridModel``'s forward and gradients.

Inputs come from numpy seeds; the weights are ``bridge.
seeded_flax_params`` draws loaded into both packages (the word table
scaled up, so that the grounding similarities are O(1)).  The model runs
at narrow statics: the R-50-C5 body at stem 8, res2 16, width 4; a
2-layer BERT of width 64, 4 heads, intermediate 128; a 2-layer
transformer head; a vocabulary of 128; 3 images of 128 x 128 (a 4 x 4
grid, two images smaller than the batch's padded size) and 12-token
captions with padding.

JAX's random draws are its own: :class:`JaxMMSSDraws` wraps the JAX
``spatial_dropout_select`` and ``apply_mlm_masking`` of ``mmss_gcnn.py``
to compute, from the key each is given, the uniforms and ids they draw,
and passes them out with ``jax.debug.callback``; the port takes them as
an ``MMSSDraws``.  The grounding head's noise is computed in the test
from the head's key: ``jax.random.categorical`` adds Gumbel noise of the
logits' shape and takes the argmax.

Tolerances (float32): the grid inputs, the dropout's selection (with
its ties at 2.0) and the MLM corruption exactly; BERT and the heads
1e-5 (relative and absolute); the model's losses 1e-5 relative and its
accuracies exactly; gradients 1e-4 of each JAX gradient's norm, with a
floor for the gradients that are zero but for rounding (see
:func:`test_every_mmss_gradient_matches_jax`; the trunk's are within
2e-6 at this seed).  bfloat16 losses: 2%.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import mmss_gcnn as jax_mmss
from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector.statics import RCNNStatics as JaxRCNNStatics
from cvpr22_cross_modal_pseudo_labeling_tpu.models.language import bert as jax_bert
from cvpr22_cross_modal_pseudo_labeling_tpu.models.mmss import grounding_head as jax_gh
from cvpr22_cross_modal_pseudo_labeling_tpu.models.mmss import transformer_head as jax_th
from cvpr22_cross_modal_pseudo_labeling_torch import bridge
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector import mmss_gcnn as torch_mmss
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector.statics import RCNNStatics
from cvpr22_cross_modal_pseudo_labeling_torch.models.language import bert as torch_bert
from cvpr22_cross_modal_pseudo_labeling_torch.models.mmss import grounding_head as torch_gh
from cvpr22_cross_modal_pseudo_labeling_torch.models.mmss import transformer_head as torch_th

VOCAB = 128
B, W, HW = 3, 12, 128


def narrow_statics(pkg="torch", dtype="float32", **kw):
    """The narrow MMSS statics of ``pkg`` (``"torch"`` or ``"jax"``):
    mmss.yaml's heads and options at test widths."""
    m, r, g, t = (
        (torch_mmss, RCNNStatics, torch_gh, torch_th) if pkg == "torch"
        else (jax_mmss, JaxRCNNStatics, jax_gh, jax_th)
    )
    s = m.MMSSStatics(
        backbone=r(conv_body="R-50-C5", stem_out_channels=8, res2_out_channels=16, width_per_group=4,
                   compute_dtype=dtype),
        v_dim=128, l_dim=64, spatial_dropout=14, heads=("GroundingHead", "TransformerHead"), tie_vl=True,
        grounding=g.GroundingStatics(temperature=10.0, loss_type="cross_entropy", alignment="softmax"),
        transformer=t.TransformerHeadStatics(num_layers=2, num_heads=4, intermediate_size=64, hidden_size=64,
                                             vocab_size=VOCAB, mmm_loss="cross_entropy"),
        vocab_size=VOCAB, bert_layers=2, bert_heads=4, bert_intermediate=128,
    )
    return s._replace(**kw)


def caption_batch(seed=1, b=B, w=W):
    """Tokenized captions as the collator gives them: [CLS] ... [SEP]
    then padding; caption 1 and 2 are padded."""
    rng = np.random.default_rng(seed)
    lengths = [w, w - 4, 5][:b] + [w] * max(b - 3, 0)
    ids = np.zeros((b, w), np.int32)
    att = np.zeros((b, w), np.int32)
    spec = np.zeros((b, w), np.int32)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.integers(1, VOCAB, n)
        ids[i, 0], ids[i, n - 1] = 101, 102
        att[i, :n] = 1
        spec[i, 0] = spec[i, n - 1] = 1
    return dict(input_ids=ids, attention_mask=att, special_tokens_mask=spec)


def image_batch(seed=1, b=B, hw=HW):
    rng = np.random.default_rng(seed)
    sizes = np.array([[hw, hw], [80, 100], [hw, 96]] * b, np.int32)[:b]
    return dict(images=rng.integers(0, 256, (b, hw, hw, 3), dtype=np.uint8), image_sizes=sizes)


def mmss_batch(seed=1, b=B):
    return {**image_batch(seed, b), **caption_batch(seed, b)}


def seeded_tree(model, seed=0):
    """The port's seeded tree with the word table at unit scale, so that
    the grounding similarities are O(1)."""
    tree = bridge.seeded_flax_params(model, seed)
    tree["language_backbone"]["word_embeddings"] *= np.float32(30.0)
    return tree


def jax_params(tree):
    return {"params": jax.tree_util.tree_map(jnp.asarray, tree)}


def torch_captions(batch):
    return {k: torch.from_numpy(np.asarray(batch[k])) for k in ("input_ids", "attention_mask",
                                                                 "special_tokens_mask")}


# the callbacks of a jitted program are fixed when it is traced, so they
# write here and each recorder reads what its own execution wrote
_SINK = {}


class JaxMMSSDraws(contextlib.ContextDecorator):
    """Records the JAX model's spatial-dropout uniforms and MLM draws."""

    def __enter__(self):
        _SINK.clear()
        self._saved = jax_mmss.spatial_dropout_select, jax_mmss.apply_mlm_masking
        select, mlm = self._saved

        def record(**named):
            jax.debug.callback(lambda *a: _SINK.update({k: np.array(v) for k, v in zip(named, a)}),
                               *named.values())

        def spatial_dropout_select(rf, rm, rl, cap, key):
            record(dropout=jax.random.uniform(key, rm.shape))
            return select(rf, rm, rl, cap, key)

        def apply_mlm_masking(input_ids, special, attention, key, **kw):
            k1, k2, k3 = jax.random.split(key, 3)
            shape = input_ids.shape
            record(mlm_select=jax.random.uniform(k1, shape), mlm_mask=jax.random.uniform(k2, shape),
                   mlm_ids=jax.random.randint(k3, shape, 0, kw["vocab_size"]))
            return mlm(input_ids, special, attention, key, **kw)

        jax_mmss.spatial_dropout_select = spatial_dropout_select
        jax_mmss.apply_mlm_masking = apply_mlm_masking
        return self

    def __exit__(self, *exc):
        jax_mmss.spatial_dropout_select, jax_mmss.apply_mlm_masking = self._saved
        return False

    def draws(self):
        sink = dict(_SINK)
        return torch_mmss.MMSSDraws(
            dropout=torch.from_numpy(sink["dropout"]),
            mlm_select=torch.from_numpy(sink["mlm_select"]),
            mlm_mask=torch.from_numpy(sink["mlm_mask"]),
            mlm_ids=torch.from_numpy(sink["mlm_ids"]).to(torch.int64),
        )


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_grid_region_inputs_and_spatial_dropout_match_jax_exactly():
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((3, 5, 7, 4)).astype(np.float32)
    sizes = np.array([[80, 112], [33, 50], [10, 112]], np.int32)
    got = torch_mmss.grid_region_inputs(torch.from_numpy(feats), torch.from_numpy(sizes), (80, 112))
    want = jax_mmss.grid_region_inputs(jnp.asarray(feats), jnp.asarray(sizes), (80, 112))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    rf, rm, rl = want
    assert int(np.asarray(rm)[2].sum()) < 20  # the cap exceeds the third image's cells: ties at 2.0
    key = jax.random.PRNGKey(3)
    u = np.array(jax.random.uniform(key, rm.shape))
    u[0, 3] = u[0, 9]  # a tie among valid cells too
    sel = jax_mmss.spatial_dropout_select(rf, rm, rl, 20, key)
    # the tie: JAX's selection computed from the edited uniforms
    prio = jnp.where(rm, jnp.asarray(u), 2.0)
    _, idx = jax.lax.top_k(-prio, 20)
    want_sel = [np.take_along_axis(np.asarray(a), np.asarray(idx)[..., None] if a.ndim == 3 else np.asarray(idx),
                                   axis=1) for a in (rf, rm, rl)]
    rf, rm, rl = (np.array(a) for a in (rf, rm, rl))
    got_sel = torch_mmss.spatial_dropout_select(*map(torch.from_numpy, (rf, rm, rl)), 20, torch.from_numpy(u))
    for g, w in zip(got_sel, want_sel):
        np.testing.assert_array_equal(g.numpy(), w)
    # and the port's selection from JAX's untouched draws equals JAX's
    got_sel = torch_mmss.spatial_dropout_select(
        *map(torch.from_numpy, (rf, rm, rl)), 20, torch.from_numpy(np.array(jax.random.uniform(key, rm.shape))))
    for g, w in zip(got_sel, sel):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("prob_noise", [0.0, 0.05])
def test_mlm_masking_with_replayed_draws_matches_jax_exactly(prob_noise):
    cap = caption_batch(seed=4, b=4, w=40)
    key = jax.random.PRNGKey(7)
    args = [jnp.asarray(cap[k]) for k in ("input_ids", "special_tokens_mask", "attention_mask")]
    want_ids, want_sel = jax_bert.apply_mlm_masking(*args, key, vocab_size=VOCAB, prob=0.3,
                                                    prob_mask=0.8, prob_noise=prob_noise)
    k1, k2, k3 = jax.random.split(key, 3)
    shape = cap["input_ids"].shape
    draws = [torch.from_numpy(np.array(d)) for d in (
        jax.random.uniform(k1, shape), jax.random.uniform(k2, shape), jax.random.randint(k3, shape, 0, VOCAB))]
    got_ids, got_sel = torch_bert.apply_mlm_masking(
        *[torch.from_numpy(np.asarray(a)) for a in args], *draws, prob=0.3, prob_mask=0.8, prob_noise=prob_noise)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_sel.numpy(), np.asarray(want_sel))
    assert np.asarray(want_sel).any() and (np.asarray(want_ids) == 103).any()


def _load_module(port, jax_module, *jax_args, seed=0):
    tree = bridge.seeded_flax_params(port, seed)
    bridge.load_flax_params(port, tree)
    shapes = jax.eval_shape(lambda: jax_module.init(jax.random.PRNGKey(0), *jax_args))["params"]
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(tree)
    return jax_params(tree)


def test_bert_model_and_encoder_match_jax_with_padded_masks():
    cap = caption_batch(seed=2, b=3, w=W)
    ids, mask = cap["input_ids"], cap["attention_mask"] > 0
    port = torch_bert.BertModel(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=4,
                                intermediate_size=128)
    ref = jax_bert.BertModel(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128)
    params = _load_module(port, ref, jnp.asarray(ids), jnp.asarray(mask))
    want, want_table = ref.apply(params, jnp.asarray(ids), jnp.asarray(mask))
    got, table = port(torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (3, W, 64)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(table.detach().numpy(), np.asarray(want_table))

    x = np.random.default_rng(3).standard_normal((3, W, 64)).astype(np.float32)
    port = torch_bert.BertEncoder(2, 64, 4, 128)
    ref = jax_bert.BertEncoder(2, 64, 4, 128)
    params = _load_module(port, ref, jnp.asarray(x), jnp.asarray(mask), seed=1)
    want = ref.apply(params, jnp.asarray(x), jnp.asarray(mask))
    got = port(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


GROUNDING_GRID = [
    dict(local_metric="dot", alignment="softmax", global_metric="aligned_local", loss_type="cross_entropy"),
    dict(local_metric="dot", alignment="softmax", global_metric="aligned_local", loss_type="cross_entropy",
         align_regions=False),
    dict(local_metric="dot", alignment="hardmax", global_metric="reconstruction_mse", loss_type="cross_entropy",
         align_words=False),
    dict(local_metric="cosine", alignment="softmax", global_metric="aligned_local", loss_type="matching"),
    dict(local_metric="cosine", alignment="hardmax", global_metric="reconstruction_mse", loss_type="matching"),
    dict(local_metric="euclidean", alignment="softmax", global_metric="reconstruction_mse",
         loss_type="cross_entropy"),
    dict(local_metric="euclidean", alignment="random_categorical", global_metric="aligned_local",
         loss_type="matching"),
    dict(local_metric="dot", alignment="random_categorical", global_metric="reconstruction_mse",
         loss_type="cross_entropy"),
    dict(local_metric="cosine", alignment="random_top3", global_metric="aligned_local", loss_type="cross_entropy"),
    dict(local_metric="euclidean", alignment="random_top3", global_metric="reconstruction_mse",
         loss_type="matching"),
    dict(local_metric="dot", alignment="softmax", global_metric="aligned_local", loss_type="triplet",
         negative_mining="hardest"),
    dict(local_metric="cosine", alignment="hardmax", global_metric="aligned_local", loss_type="triplet",
         negative_mining="easiest"),
    dict(local_metric="euclidean", alignment="softmax", global_metric="reconstruction_mse", loss_type="triplet",
         negative_mining="random"),
    dict(local_metric="dot", alignment="random_top3", global_metric="aligned_local", loss_type="triplet",
         negative_mining="random"),
    dict(local_metric="dot", alignment="softmax", global_metric="aligned_local", loss_type="matching"),
]


def grounding_draws(key, statics, b, w, r, pairwise):
    """The noise JAX's head draws from ``key``, as ``AlignmentDraws``."""
    k1, k2 = jax.random.split(key)
    lead = (b, b) if pairwise else (b,)
    w2r = jax.random.gumbel(k1, lead + (w, r))
    r2w = jax.random.gumbel(k2, lead + (r, w))
    triplet = None
    if statics.loss_type == "triplet" and statics.negative_mining == "random":
        rows = []
        for k in jax.random.split(key, 2):
            kc, ki = jax.random.split(k)
            rows.append([jax.random.randint(kc, (b,), 0, b - 1), jax.random.randint(ki, (b,), 0, b - 1)])
        triplet = torch.from_numpy(np.asarray(rows)).to(torch.int64)
    return torch_gh.AlignmentDraws(torch.from_numpy(np.asarray(w2r)), torch.from_numpy(np.asarray(r2w)), triplet)


@pytest.mark.parametrize("variant", range(len(GROUNDING_GRID)))
def test_grounding_head_matches_jax_over_its_options(variant):
    """Losses 1e-5, accuracies exactly; caption 2 is empty (the AND
    guard), image 1 has padded regions."""
    opts = dict(temperature=2.0, margin=0.5, **GROUNDING_GRID[variant])
    b, w, r, d = 4, 6, 5, 8
    rng = np.random.default_rng(variant)
    img = rng.standard_normal((b, r, d)).astype(np.float32)
    cap = rng.standard_normal((b, w, d)).astype(np.float32)
    cmask = (rng.uniform(size=(b, w)) < 0.8).astype(np.int32)
    cmask[2] = 0
    cmask[0, 0] = 1
    rmask = np.ones((b, r), bool)
    rmask[1, 3:] = False
    key = jax.random.PRNGKey(variant)
    ref = jax_gh.GroundingHead(jax_gh.GroundingStatics(**opts), d)
    port = torch_gh.GroundingHead(torch_gh.GroundingStatics(**opts), d)
    args = (img, rmask, cap, cmask)
    if opts["loss_type"] == "matching" and opts["local_metric"] == "dot":
        with pytest.raises(ValueError, match="unbounded dot"):
            ref.apply({}, *map(jnp.asarray, args), rng=key)
        with pytest.raises(ValueError, match="unbounded dot"):
            port(*map(torch.from_numpy, args))
        return
    want_info, want_losses = ref.apply({}, *map(jnp.asarray, args), rng=key)
    draws = grounding_draws(key, port.statics, b, w, r, opts["loss_type"] != "matching")
    got_info, got_losses = port(*map(torch.from_numpy, args), draws=draws)
    assert set(got_losses) == set(want_losses) and set(got_info) == set(want_info)
    for k, v in want_losses.items():
        np.testing.assert_allclose(got_losses[k].numpy(), np.asarray(v), rtol=1e-5, atol=1e-6, err_msg=k)
    for k, v in want_info.items():
        np.testing.assert_array_equal(got_info[k].numpy(), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("mmm_loss", ["cross_entropy", ""])
def test_transformer_head_matches_jax(mmm_loss):
    statics = dict(num_layers=2, num_heads=4, intermediate_size=64, hidden_size=64, vocab_size=50,
                   mmm_loss=mmm_loss)
    b, r, w, d = 3, 5, 6, 64
    rng = np.random.default_rng(5)
    img = rng.standard_normal((b, r, d)).astype(np.float32)
    loc = rng.uniform(size=(b, r, 2)).astype(np.float32)
    rmask = np.ones((b, r), bool)
    rmask[2, 4:] = False
    tokens = rng.standard_normal((b, w, d)).astype(np.float32)
    cmask = np.ones((b, w), np.int32)
    cmask[1, 4:] = 0
    mlm = rng.uniform(size=(b, w)) < 0.4
    mlm[1, 4:] = False
    tgt = rng.integers(0, 50, (b, w)).astype(np.int32)
    table = rng.standard_normal((50, d)).astype(np.float32)
    args = (img, loc, rmask, tokens, cmask, mlm, tgt, table)
    port = torch_th.TransformerHead(torch_th.TransformerHeadStatics(**statics), d)
    ref = jax_th.TransformerHead(jax_th.TransformerHeadStatics(**statics))
    params = _load_module(port, ref, *map(jnp.asarray, args))
    want_info, want_losses = ref.apply(params, *map(jnp.asarray, args))
    got_info, got_losses = port(*map(torch.from_numpy, args))
    assert set(got_losses) == set(want_losses) and set(got_info) == set(want_info)
    for k, v in want_losses.items():
        np.testing.assert_allclose(got_losses[k].detach().numpy(), np.asarray(v), rtol=1e-5, atol=1e-6, err_msg=k)
    for k, v in want_info.items():
        np.testing.assert_allclose(got_info[k].numpy(), np.asarray(v), rtol=1e-6, err_msg=k)
    # the matching loss without MMM is the zero-weighted seq_relationship
    # term: its gradient is zero, but it reaches the layer
    if not mmm_loss:
        got_losses["Image Caption Matching Loss"].backward()
        assert torch.count_nonzero(port.seq_relationship.weight.grad) == 0


def jax_model_loss(model, rngs_seed=0):
    """The JAX model's summed loss, info and losses (``build_loss_fn``'s
    MMSS branch), jitted."""

    def loss_fn(params, batch):
        rng = jax.random.PRNGKey(rngs_seed)
        rngs = {"dropout": jax.random.fold_in(rng, 2), "mlm": jax.random.fold_in(rng, 3),
                "alignment": jax.random.fold_in(rng, 4)}
        captions = {k: batch[k] for k in ("input_ids", "attention_mask", "special_tokens_mask")}
        info, losses = model.apply(params, batch["images"], batch["image_sizes"], captions, train=True, rngs=rngs)
        return sum(losses.values()), (info, losses)

    return loss_fn


@pytest.fixture(scope="module")
def f32_run():
    """One JAX program: the float32 model's losses, info and gradients on
    :func:`mmss_batch`, with the draws it made."""
    port = torch_mmss.MMSSGridModel(narrow_statics())
    tree = seeded_tree(port)
    bridge.load_flax_params(port, tree)
    model = jax_mmss.MMSSGridModel(narrow_statics("jax"))
    batch = mmss_batch()
    fn = jax.jit(jax.grad(jax_model_loss(model), has_aux=True))
    with JaxMMSSDraws() as rec:
        grads, (info, losses) = fn(jax_params(tree), jax.tree_util.tree_map(jnp.asarray, batch))
        jax.block_until_ready(grads)
    return dict(port=port, tree=tree, batch=batch, draws=rec.draws(), info=info, losses=losses,
                grads=bridge.state_dict_from_flax(port, jax.tree_util.tree_map(np.asarray, grads["params"])))


def port_forward(port, batch, draws):
    return port(torch.from_numpy(batch["images"]), torch.from_numpy(batch["image_sizes"]),
                torch_captions(batch), train=True, draws=draws)


def test_mmss_model_losses_and_info_match_jax(f32_run):
    r = f32_run
    info, losses = port_forward(r["port"], r["batch"], r["draws"])
    assert set(losses) == set(r["losses"]) and set(info) == set(r["info"])
    assert len(losses) == 7 and len(info) == 7
    for k, v in r["losses"].items():
        np.testing.assert_allclose(losses[k].detach().numpy(), np.asarray(v), rtol=1e-5, atol=1e-7, err_msg=k)
    for k, v in r["info"].items():
        np.testing.assert_array_equal(info[k].numpy(), np.asarray(v), err_msg=k)
    # the draws select MLM targets and drop cells, and the losses say so
    assert float(losses["Masked Language Modeling Loss"].detach()) > 0
    assert r["draws"].mlm_select.lt(0.15).any()


def test_every_mmss_gradient_matches_jax(f32_run):
    """Every parameter's gradient, the frozen BERT's included (JAX
    computes it, and its logged norm counts it), within 1e-4 of the
    larger of its own norm and 1e-4 of the largest gradient norm of its
    module (backbone, language backbone, v2l, transformer head).  The
    floor matters only for gradients that are zero but for rounding (the
    attention's key biases, ``seq_relationship``'s bias under the
    softmax) or nearly cancel (``seq_relationship``'s and the pooler's
    weights: the B^2 pairs' pooled outputs differ little)."""
    r = f32_run
    port = r["port"]
    port.zero_grad(set_to_none=True)
    _, losses = port_forward(port, r["batch"], r["draws"])
    sum(losses.values()).backward()
    modules = ("backbone.", "language_backbone.", "v2l_projection.", "transformer_head.")
    largest = {m: max(float(np.linalg.norm(g.numpy())) for k, g in r["grads"].items() if k.startswith(m))
               for m in modules}
    groups = set()
    for name, p in port.named_parameters():
        want = r["grads"][name].numpy()
        scale = max(float(np.linalg.norm(want)),
                    1e-4 * next(v for m, v in largest.items() if name.startswith(m)))
        err = float(np.linalg.norm(p.grad.numpy().astype(np.float64) - want))
        assert err <= 1e-4 * scale, (name, err, scale)
        groups.add(".".join(name.split(".")[:2]))
    assert {"backbone.body", "language_backbone.word_embeddings", "language_backbone.encoder", "v2l_projection.weight",
            "transformer_head.encoder", "transformer_head.mlm_bias", "transformer_head.seq_relationship"} <= groups
    port.zero_grad(set_to_none=True)


def test_mmss_bf16_losses_within_two_percent():
    port = torch_mmss.MMSSGridModel(narrow_statics(dtype="bfloat16"))
    tree = seeded_tree(port)
    bridge.load_flax_params(port, tree)
    model = jax_mmss.MMSSGridModel(narrow_statics("jax", dtype="bfloat16"))
    batch = mmss_batch(seed=2)
    fn = jax.jit(jax_model_loss(model))
    with JaxMMSSDraws() as rec:
        total, (info, losses) = fn(jax_params(tree), jax.tree_util.tree_map(jnp.asarray, batch))
        jax.block_until_ready(total)
    with torch.no_grad():
        got_info, got = port_forward(port, batch, rec.draws())
    for k, v in losses.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=0.02, atol=1e-6, err_msg=k)


def test_mmss_tree_round_trips_through_its_layouts(f32_run):
    """The bridge maps the MMSS tree (DenseGeneral heads, LayerNorm
    scales) leaf for leaf, and a checkpoint's layouts rebuild it without
    the model."""
    port, tree = f32_run["port"], f32_run["tree"]
    layouts = bridge.port_layouts(port)
    assert layouts["language_backbone.encoder.layer0.attention.query.weight"] == "dense_heads_out:4"
    assert layouts["language_backbone.encoder.layer0.attention.query.bias"] == "heads:4"
    assert layouts["transformer_head.encoder.layer1.attention.output.weight"] == "dense_heads_in:4"
    assert layouts["transformer_head.mlm_ln.weight"] == "ln_scale"
    back = bridge.flax_tree_from_state_dict(port.state_dict(), layouts)
    flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    want = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    assert flat.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k])
    q = back["language_backbone"]["encoder"]["layer0"]["attention"]["query"]
    assert q["kernel"].shape == (64, 4, 16) and q["bias"].shape == (4, 16)
    assert back["transformer_head"]["encoder"]["layer0"]["attention"]["output"]["kernel"].shape == (4, 16, 64)
