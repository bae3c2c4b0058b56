"""The port's GLASS selection against the JAX package's, fed the same stats.

Ranks, top-k and block selection, and ``build_masks(slot_axis=True)`` must
give EQUAL indices and masks (no tolerance): both packages sort stably, so
ties break by unit index in both.  Inputs are made with numpy from a seed;
scores are small integers so that ties are frequent.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fusion as jfusion
from repro.core import importance as jimportance
from repro.core.glass import build_masks as jax_build_masks
from repro_torch.core import fusion, importance
from repro_torch.core.glass import GlassParams, build_masks


def _stats(seed, R, L, m):
    rng = np.random.RandomState(seed)
    sum_abs = rng.randint(0, 20, size=(R, L, m)).astype(np.float32)
    count = rng.randint(1, 9, size=(R, L)).astype(np.float32)
    return sum_abs, count


def test_ranks_scores_and_topk_equal_jax():
    rng = np.random.RandomState(0)
    s = rng.randint(0, 7, size=(3, 64)).astype(np.float32)  # many ties
    g = rng.rand(3, 64).astype(np.float32)
    np.testing.assert_array_equal(fusion.ranks_ascending(torch.from_numpy(s)).numpy(),
                                  np.asarray(jfusion.ranks_ascending(jnp.asarray(s))))
    fused = fusion.glass_scores(torch.from_numpy(s), torch.from_numpy(g), 0.3)
    jfused = jfusion.glass_scores(jnp.asarray(s), jnp.asarray(g), 0.3)
    np.testing.assert_array_equal(fused.numpy(), np.asarray(jfused))
    for k in (1, 17, 64):
        idx, mask = fusion.select_topk(fused, k)
        jidx, jmask = jfusion.select_topk(jfused, k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    bidx, bmask = fusion.select_blocks(fused, 20, 16)
    jbidx, jbmask = jfusion.select_blocks(jfused, 20, 16)
    np.testing.assert_array_equal(bidx.numpy(), np.asarray(jbidx))
    np.testing.assert_array_equal(bmask.numpy(), np.asarray(jbmask))


@pytest.mark.parametrize("selection,block_size,density", [
    ("neuron", 128, 0.5), ("block", 32, 0.5), ("block", 16, 0.3), ("neuron", 128, 0.25),
])
def test_build_masks_slot_axis_equal_jax(selection, block_size, density):
    R, L, m = 3, 2, 128
    sum_abs, count = _stats(1, R, L, m)
    prior = np.random.RandomState(2).rand(L, m).astype(np.float32)
    gcfg_j = jfusion.GlassConfig(density=density, selection=selection, block_size=block_size)
    gcfg_t = fusion.GlassConfig(density=density, selection=selection, block_size=block_size)
    jm = jax_build_masks({"sum_abs": jnp.asarray(sum_abs), "count": jnp.asarray(count)},
                         jnp.asarray(prior), gcfg_j, slot_axis=True)
    tm = build_masks({"sum_abs": torch.from_numpy(sum_abs), "count": torch.from_numpy(count)},
                     torch.from_numpy(prior), gcfg_t, slot_axis=True)
    np.testing.assert_array_equal(tm.idx.numpy(), np.asarray(jm.idx))
    np.testing.assert_array_equal(tm.mask.numpy(), np.asarray(jm.mask))
    np.testing.assert_array_equal(tm.scores.numpy(), np.asarray(jm.scores))
    # one call per request gives the same rows as the slot-axis call
    for r in range(R):
        one = build_masks({"sum_abs": torch.from_numpy(sum_abs[r]),
                           "count": torch.from_numpy(count[r])},
                          torch.from_numpy(prior), gcfg_t)
        assert torch.equal(one.idx, tm.idx[:, r])


def test_finalize_and_merge_match_jax():
    sum_abs, count = _stats(3, 1, 2, 16)
    a = {"sum_abs": torch.from_numpy(sum_abs[0]), "count": torch.from_numpy(count[0])}
    ja = {"sum_abs": jnp.asarray(sum_abs[0]), "count": jnp.asarray(count[0])}
    merged = importance.merge(a, a)
    jmerged = jimportance.merge(ja, ja)
    np.testing.assert_array_equal(importance.finalize(merged).numpy(),
                                  np.asarray(jimportance.finalize(jmerged)))
    assert fusion.merge_stat_sums(None, a) is a and fusion.merge_stat_sums(a, None) is a


def test_glass_params_resolve_and_validate():
    g = fusion.GlassConfig(density=0.5)
    assert GlassParams().resolve(g, 0) == GlassParams(density=0.5, draft_ratio=None, spec_k=0)
    assert GlassParams(density=0.25).resolve(None, 2).density == 0.25
    with pytest.raises(ValueError):
        GlassParams(density=0.0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fusion.select(torch.zeros(8), fusion.GlassConfig(selection="shard_balanced"))
