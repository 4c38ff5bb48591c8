"""The port's ``tools/ablate_st.py`` against JAX's ``tools/ablate_st.py``
on the CPU.

- ``make_data`` and ``auroc`` are JAX's numpy, equal exactly.
- ``train_mask_head``: three Adam steps of each estimator (``sampled_bce``
  with one sample, ``logmeanexp`` with eight) from JAX's own
  ``model.init`` and JAX's normal draws (replayed: a flax module's first
  ``make_rng("uncertainty")`` in the root scope, as ``MaskPredictor``'s),
  over JAX's batches: the per-step mean sigma and each example's sigma
  after the steps agree within float32 rounding (1e-5 relative).
- ``downstream_cls``: the probe's held-out accuracy equals JAX's.
- The tool's record has JAX's keys.
"""

import sys
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cvpr22_cross_modal_pseudo_labeling_tpu.models.roi_heads.mask_head import MaskPredictor as JaxMaskPredictor
from cvpr22_cross_modal_pseudo_labeling_torch.tools import ablate_st
from tests.torch_threads import two_torch_threads  # noqa: F401  (an autouse fixture)

REPO = Path(__file__).resolve().parents[1]
STEPS, BATCH, N, DIM = 3, 8, 48, 32


@pytest.fixture(scope="module")
def jax_tool():
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import ablate_st as tool
    finally:
        sys.path.remove(str(REPO / "tools"))
    return tool


@pytest.fixture(scope="module")
def data(jax_tool):
    got = ablate_st.make_data(np.random.RandomState(0), N, m=8)
    ref = jax_tool.make_data(np.random.RandomState(0), N, m=8)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    return got


class Draw(nn.Module):
    """The normal draw of the root scope's first ``make_rng``."""

    shape: tuple

    @nn.compact
    def __call__(self):
        return jax.random.normal(self.make_rng("uncertainty"), self.shape, jnp.float32)


def jax_init_and_draws(seed, feats, num_samples):
    """JAX's tool's ``model.init`` and each step's ``eps`` (its key split)."""
    model = JaxMaskPredictor(num_classes=1, uncertainty=True, dim_reduced=DIM)
    key = jax.random.PRNGKey(seed)
    k_init, k_unc, key = jax.random.split(key, 3)
    params = model.init({"params": k_init, "uncertainty": k_unc}, jnp.asarray(feats[:2]), compute_uncertain=True,
                        train=True)
    m2 = 2 * feats.shape[1]
    shape = (num_samples, BATCH, m2, m2, 1)
    eps = [np.asarray(Draw(shape).apply({}, rngs={"uncertainty": r})) for r in jax.random.split(key, STEPS)]
    # the replayed draw is the module's: sampled logits = mean + eps * sigma
    r = jax.random.split(key, STEPS)[0]
    x = jnp.asarray(feats[:BATCH])
    sampled, _ = model.apply(params, x, compute_uncertain=True, train=True, num_samples=num_samples,
                             rngs={"uncertainty": r})
    mean, scale = model.apply(params, x, compute_uncertain=True, train=False)
    np.testing.assert_allclose(np.asarray(sampled), np.asarray(mean[None] + eps[0] * scale[None]), rtol=1e-6,
                               atol=1e-6)
    return jax.tree_util.tree_map(np.asarray, params["params"]), eps


@pytest.mark.parametrize("estimator,num_samples", [("sampled_bce", 1), ("logmeanexp", 8)])
def test_train_mask_head_steps_are_jaxs(jax_tool, data, estimator, num_samples):
    feats, targets = data[0], data[1]
    params, eps = jax_init_and_draws(0, feats, num_samples)
    ref_sigma_of, ref_traj = jax_tool.train_mask_head(0, STEPS, BATCH, feats, targets, estimator, num_samples,
                                                      traj_every=1, dim_reduced=DIM)
    sigma_of, traj = ablate_st.train_mask_head(0, STEPS, BATCH, feats, targets, estimator, num_samples,
                                               traj_every=1, dim_reduced=DIM, params=params, eps=eps)
    assert [s for s, _ in traj] == [s for s, _ in ref_traj] == list(range(STEPS))
    np.testing.assert_allclose([v for _, v in traj], [v for _, v in ref_traj], rtol=0, atol=1e-4)  # 4 decimals
    ref = np.asarray(ref_sigma_of(jnp.asarray(feats)))
    np.testing.assert_allclose(sigma_of(feats), ref, rtol=1e-5)
    # the port's own draws train too
    own, _ = ablate_st.train_mask_head(0, STEPS, BATCH, feats, targets, estimator, num_samples, dim_reduced=DIM)
    assert np.isfinite(own(feats)).all()


def test_probe_and_auroc_are_jaxs(jax_tool, data):
    feats, _, is_noisy, _, clean_cls = data
    rng = np.random.RandomState(3)
    noisy_labels = np.where(is_noisy, rng.randint(0, 2, size=N), clean_cls).astype(np.int32)
    weights = rng.uniform(0.1, 2.0, N).astype(np.float32)
    got = ablate_st.downstream_cls(0, 200, feats, noisy_labels, clean_cls, weights, 24)
    ref = jax_tool.downstream_cls(0, 200, feats, noisy_labels, clean_cls, weights, 24)
    assert got == ref
    scores = rng.random(N)
    assert ablate_st.auroc(scores, is_noisy) == jax_tool.auroc(scores, is_noisy)


def test_the_record_has_jaxs_keys(data):
    rec = ablate_st.run_estimator(0, 2, "logmeanexp", 2, data, batch=4, n_train=24)
    assert list(rec) == ["estimator", "num_samples", "sigma_clean", "sigma_noisy", "sigma_ratio",
                         "sigma_auroc_vs_noisy", "lambda_clean_batch", "lambda_noisy_batch", "avg_sigma_trajectory",
                         "acc_adaptive", "acc_fixed", "acc_oracle_drop_noisy"]
    out = ablate_st.summarize([{"ref": rec, "kg": rec}], 2)
    assert set(out["claims"]) == {"kg_sigma_discriminates_noise", "kg_adaptive_lambda_downweights_noise",
                                  "kg_adaptive_beats_fixed_on_clean_heldout", "ref_sigma_inverted",
                                  "ref_weight_anneals_up"}
