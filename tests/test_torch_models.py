"""The port's dense model against the JAX package's, on the same weights.

Weights cross through the numpy bridge (``params.from_reference``); inputs
are made with numpy from a seed.  Tiny float32 configs as in the JAX
suites (``tests/test_paged_serving.py``), in both GQA layouts.  Logits, KV
rows and stat sums agree to 1e-5 (absolute and relative: float32, with
different summation orders in the two frameworks).  The JAX Pallas
kernels run in interpret mode (``repro.kernels.ops.INTERPRET`` on CPU).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _flatten as jax_flatten
from repro.configs import get_config as jax_get_config
from repro.models import ModelConfig as JaxModelConfig
from repro.models import build_model as jax_build_model
from repro.models import transformer as jtr
from repro_torch.configs import get_config
from repro_torch.models import ModelConfig
from repro_torch.models import transformer as ttr
from repro_torch.params import flatten, from_reference, init_params, to_reference

TOL = 1e-5
BASE = dict(n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, head_dim=12,
            d_ff=96, vocab_size=101, dtype="float32", remat="none")
GROUPED = JaxModelConfig(name="tm-dense", family="dense", **BASE)
REPEATED = GROUPED.replace(name="tm-repeated", gqa_layout="repeated")
BS, NUM_BLOCKS = 8, 10


def _setup(jcfg):
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    cfg = ModelConfig.from_dict(dataclasses.asdict(jcfg))
    params = from_reference(jax.device_get(jparams), device="cpu")
    return jparams, cfg, params


def _zero_cache(cfg):
    shape = (cfg.n_layers, NUM_BLOCKS, BS, cfg.n_kv_heads, cfg.head_dim)
    return np.zeros(shape, np.float32)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL, rtol=TOL)


def test_param_bridge_round_trips_and_keeps_leaf_paths():
    jparams, cfg, params = _setup(GROUPED)
    tree = jax.device_get(jparams)
    assert set(flatten(params)) == set(jax_flatten(tree))
    back = flatten(to_reference(params))
    for k, v in jax_flatten(tree).items():
        np.testing.assert_array_equal(back[k], np.asarray(v))
        assert back[k].dtype == np.asarray(v).dtype


def test_init_params_shapes_match_init_lm():
    for jcfg in (GROUPED, GROUPED.replace(tie_embeddings=False, gated_ffn=False)):
        jshapes = {k: v.shape for k, v in jax_flatten(
            jax.eval_shape(lambda: jax_build_model(jcfg).init(jax.random.key(0)))).items()}
        cfg = ModelConfig.from_dict(dataclasses.asdict(jcfg))
        params = init_params(cfg, 0, device="cpu")
        assert {k: tuple(v.shape) for k, v in flatten(params).items()} == jshapes
    assert dataclasses.asdict(get_config("llama3-8b")) == dataclasses.asdict(jax_get_config("llama3-8b"))


def _prefill_both(jcfg, attn_mode):
    """Two rows, an 11-token prompt each, prefilled in chunks of 6 + 5."""
    jparams, cfg, params = _setup(jcfg)
    rng = np.random.RandomState(1)
    prompts = rng.randint(0, cfg.vocab_size, size=(2, 11)).astype(np.int32)
    table = np.array([[1, 2], [3, 4]], np.int32)
    jcache = {"k": jnp.asarray(_zero_cache(cfg)), "v": jnp.asarray(_zero_cache(cfg))}
    tcache = {"k": torch.from_numpy(_zero_cache(cfg)), "v": torch.from_numpy(_zero_cache(cfg))}
    outs = []
    for lo, hi in ((0, 6), (6, 11)):
        clen = np.array([lo, lo], np.int32)
        jl, jcache, js = jtr.dense_prefill_chunk(
            jparams, jnp.asarray(prompts[:, lo:hi]), jcfg, jcache, jnp.asarray(table),
            jnp.asarray(clen), attn_mode=attn_mode)
        tl, tcache, ts = ttr.dense_prefill_chunk(
            params, torch.from_numpy(prompts[:, lo:hi]), cfg, tcache, torch.from_numpy(table),
            torch.from_numpy(clen), attn_mode=attn_mode)
        outs.append((jl, js, tl, ts))
    return jparams, cfg, params, jcache, tcache, outs


@pytest.mark.parametrize("jcfg", [GROUPED, REPEATED], ids=["grouped", "repeated"])
@pytest.mark.parametrize("attn_mode", ["gather", "paged_pallas"])
def test_prefill_chunk_matches_jax(jcfg, attn_mode):
    _, _, _, jcache, tcache, outs = _prefill_both(jcfg, attn_mode)
    for jl, js, tl, ts in outs:
        _close(tl.numpy(), jl)
        _close(ts["sum_abs"].numpy(), js["sum_abs"])
        _close(ts["count"].numpy(), js["count"])
    _close(tcache["k"].numpy(), jcache["k"])
    _close(tcache["v"].numpy(), jcache["v"])


DECODE_MODES = [
    ("gather", "dense"), ("gather", "masked"), ("gather", "rowwise"), ("gather", "grouped"),
    ("paged_pallas", "grouped"),
]


@pytest.mark.parametrize("attn_mode,ffn_mode", DECODE_MODES)
def test_decode_step_matches_jax(attn_mode, ffn_mode):
    """Three rows after an 11-token prefill (rows 0/1) plus an inactive row
    at trash block 0, one decode tick, in each FFN mode: dense, masked,
    rowwise block-sparse, and grouped block-sparse (rows 0 and 2 share a
    list through the shared-list kernel)."""
    jparams, cfg, params, jcache, _, _ = _prefill_both(GROUPED, "gather")
    rng = np.random.RandomState(2)
    L, B, m, bs_ffn = cfg.n_layers, 3, cfg.d_ff, 32
    table = np.array([[1, 2], [3, 4], [0, 0]], np.int32)
    clen = np.array([11, 11, 0], np.int32)
    tok = rng.randint(0, cfg.vocab_size, size=(B, 1)).astype(np.int32)
    kw = {}
    if ffn_mode == "masked":
        kw["ffn_masks"] = (rng.rand(L, B, m) > 0.5).astype(np.float32)
    elif ffn_mode in ("rowwise", "grouped"):
        idx = np.stack([[np.sort(rng.permutation(m // bs_ffn)[:2]) for _ in range(B)]
                        for _ in range(L)]).astype(np.int32)
        scale = np.ones((L, B, 2), np.float32)
        scale[:, 1, 0] = 0.0
        if ffn_mode == "grouped":
            idx[:, 2] = idx[:, 0]
            scale[:, 2] = scale[:, 0]
        kw.update(ffn_block_idx=idx, ffn_block_scale=scale, ffn_block_size=bs_ffn)
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    if ffn_mode == "grouped":
        perm = np.array([0, 2, 1], np.int32)
        jkw.update(ffn_groups=(2,), ffn_row_perm=jnp.asarray(perm))
        tkw.update(ffn_groups=(2,), ffn_row_perm=torch.from_numpy(perm).long())
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in jax.device_get(jcache).items()}
    jl, jcache = jtr.dense_decode_step(
        jparams, jnp.asarray(tok), jcache, jnp.asarray(clen), GROUPED,
        block_table=jnp.asarray(table), attn_mode=attn_mode, **jkw)
    tl, tcache = ttr.dense_decode_step(
        params, torch.from_numpy(tok), tcache, torch.from_numpy(clen), cfg,
        block_table=torch.from_numpy(table), attn_mode=attn_mode, **tkw)
    _close(tl[:2].numpy(), jl[:2])  # row 2 is inert (trash block), its logits unused
    live = [1, 2, 3, 4]
    _close(tcache["k"][:, live].numpy(), np.asarray(jcache["k"])[:, live])
    _close(tcache["v"][:, live].numpy(), np.asarray(jcache["v"])[:, live])
    if ffn_mode == "grouped":  # the inactive row shares row 0's list: same FFN rows
        assert np.isfinite(tl.numpy()).all()
