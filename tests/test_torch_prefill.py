"""The port's full-sequence prefill against the JAX package's.

Two kernels are new on this path: flash attention (every layer of
``dense_forward`` on the card) and the GLASS local-stats sums (every
``ffn_forward_with_stats``).  Their plain versions, which the CPU runs,
are held against the JAX Pallas kernels in interpret mode and against the
jnp oracles, in float32: attention within 2e-5, stat sums within 1e-5 (the
two frameworks sum in different orders).  The model-level tests hold
``dense_forward``, ``dense_prefill``, ``Model.logits_with_stats`` and
``compact_params`` against JAX on the same weights (numpy bridge) on the
tiny fp32 configs of the JAX suites, in both GQA layouts: logits, cache
rows and stats within 1e-5, compact weights equal.  A ``gpu`` test holds
the two CUDA kernels against their plain versions on the card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.glass import compact_params as jax_compact_params
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.local_stats import local_stats as jax_local_stats
from repro.kernels.ref import flash_attention_ref as jax_flash_ref
from repro.models import ModelConfig as JaxModelConfig
from repro.models import attention as jattn
from repro.models import build_model as jax_build_model
from repro.models import ffn as jffn
from repro.models import transformer as jtr
from repro_torch.core import compact_params
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref, local_stats_ref
from repro_torch.models import ModelConfig, build_model
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttr
from repro_torch.models.transformer import layer_params
from repro_torch.params import from_reference

ATTN_TOL, STATS_TOL, TOL = 2e-5, 1e-5, 1e-5
BASE = dict(n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, head_dim=12,
            d_ff=96, vocab_size=101, dtype="float32", remat="none")
GROUPED = JaxModelConfig(name="tp-dense", family="dense", **BASE)
REPEATED = GROUPED.replace(name="tp-repeated", gqa_layout="repeated")
# every mask of the full-sequence path: a local (window 5) and a global
# layer, score and logit softcaps
GEMMALIKE = GROUPED.replace(name="tp-local-global", sliding_window=5,
                            attn_pattern="local_global", attn_softcap=30.0,
                            logit_softcap=20.0, ffn_act="gelu")
CONFIGS = {"grouped": GROUPED, "repeated": REPEATED, "local_global": GEMMALIKE}


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol, rtol=tol)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


@pytest.fixture(scope="module")
def models():
    """{name: (jax cfg, jax params, port model, port params)}, built once."""
    out = {}
    for name, jcfg in CONFIGS.items():
        jparams = jax_build_model(jcfg).init(jax.random.key(0))
        model = build_model(ModelConfig.from_dict(dataclasses.asdict(jcfg)))
        out[name] = (jcfg, jparams, model, from_reference(jax.device_get(jparams), device="cpu"))
    return out


# -- the plain versions against the JAX kernels ---------------------------------


@pytest.mark.parametrize("Sq,Skv,window,softcap", [
    (64, 64, None, None), (64, 128, None, None), (128, 128, 32, None),
    (96, 128, None, 30.0), (64, 96, 16, 12.0),
])
def test_flash_attention_plain_matches_jax_kernel(Sq, Skv, window, softcap):
    """K == H, the TPU kernel's signature, with its 32-row blocks."""
    rng = np.random.RandomState(Sq + Skv)
    q, k, v = (rng.randn(2, 3, n, 16).astype(np.float32) for n in (Sq, Skv, Skv))
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
                               softcap=softcap, block_q=32, block_k=32, interpret=True)
    got = flash_attention_ref(_t(q), _t(k), _t(v), window=window, softcap=softcap)
    _close(got.numpy(), want, ATTN_TOL)


@pytest.mark.parametrize("Sq,Skv,window,softcap", [
    (37, 37, None, None), (13, 53, None, None), (45, 45, 7, 20.0), (1, 29, 4, None),
])
def test_flash_attention_plain_gqa_at_any_length(Sq, Skv, window, softcap):
    """Lengths the TPU kernel refuses (no block divides them), and K < H:
    the GQA form equals the jnp oracle over the KV heads repeated."""
    rng = np.random.RandomState(Sq * Skv)
    H, K = 6, 2
    q = rng.randn(2, H, Sq, 16).astype(np.float32)
    k, v = (rng.randn(2, K, Skv, 16).astype(np.float32) for _ in range(2))
    want = jax_flash_ref(jnp.asarray(q), jnp.repeat(jnp.asarray(k), H // K, axis=1),
                         jnp.repeat(jnp.asarray(v), H // K, axis=1), window=window,
                         softcap=softcap)
    got = flash_attention_ref(_t(q), _t(k), _t(v), window=window, softcap=softcap)
    _close(got.numpy(), want, ATTN_TOL)


@pytest.mark.parametrize("name", ["grouped", "repeated", "local_global"])
def test_flash_attention_plain_in_the_model_layout_matches_jax_attention(models, name):
    """The (B, S, heads, hd) projections handed to the plain flash version
    as (B, heads, S, hd) views, as the card's path hands them to the
    kernel, give JAX ``attention_forward`` in both GQA layouts."""
    jcfg, jparams, model, params = models[name]
    cfg = model.cfg
    x = np.random.RandomState(3).randn(2, 19, cfg.d_model).astype(np.float32)
    window = ttr.layer_windows(cfg)[0]
    lp = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    want = jattn.attention_forward(lp, jnp.asarray(x), jcfg,
                                   positions=jnp.broadcast_to(jnp.arange(19)[None], (2, 19)),
                                   window=jnp.int32(window))
    tp = layer_params(params["layers"], 0)["attn"]
    q, k, v = tattn.project_qkv(tp, _t(x), cfg)
    q, k = tattn.rope_qk(q, k, cfg, torch.arange(19)[None].expand(2, 19))
    out = ops.flash_attention(q.reshape(2, 19, cfg.n_heads, cfg.head_dim).transpose(1, 2),
                              k.transpose(1, 2), v.transpose(1, 2), window=window,
                              softcap=cfg.attn_softcap)
    got = out.transpose(1, 2).reshape(2, 19, cfg.attn_dim) @ tp["wo"]
    _close(got.numpy(), want)
    # and the CPU branch of the port's attention_forward (the jnp path's port)
    _close(tattn.attention_forward(tp, _t(x), cfg, window=window).numpy(), want)


def test_attention_forward_chunked_branch_matches_jax(models):
    """S > 2 * attn_chunk with attn_chunk | S takes the query-chunked path
    in both packages."""
    jcfg, jparams, model, params = models["grouped"]
    jcfg, cfg = jcfg.replace(attn_chunk=8), model.cfg.replace(attn_chunk=8)
    x = np.random.RandomState(4).randn(1, 32, cfg.d_model).astype(np.float32)
    lp = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    want = jattn.attention_forward(lp, jnp.asarray(x), jcfg,
                                   positions=jnp.arange(32)[None], window=jnp.int32(6))
    tp = layer_params(params["layers"], 0)["attn"]
    _close(tattn.attention_forward(tp, _t(x), cfg, window=6).numpy(), want)


@pytest.mark.parametrize("Sq,Skv,window,softcap", [(128, 128, None, None), (64, 128, 32, 30.0)])
def test_bf16_flash_limit_holds_the_jax_kernel_and_fails_a_wrong_tile(Sq, Skv, window, softcap):
    """``chip_smoke.py`` holds the bf16 flash-attention kernel to its plain
    version elementwise within 8e-3 * (|ref| + attention over |v|).  The
    JAX kernel, whose online softmax rounds unnormalized probabilities per
    tile as the CUDA kernel does, stays within that limit; the plain
    version with 16 keys' values read from the wrong keys does not."""
    from chip_smoke import _flash_err

    rng = np.random.RandomState(Sq + (window or 0))
    q, k, v = (rng.randn(1, 2, n, 64).astype(np.float32) for n in (Sq, Skv, Skv))
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = jax_flash_attention(bf(q), bf(k), bf(v), window=window, softcap=softcap,
                               block_q=32, block_k=32, interpret=True)
    tq, tk, tv = (_t(a).bfloat16() for a in (q, k, v))
    got = _t(want.astype(jnp.float32)).bfloat16()
    err, over = _flash_err(got, tq, tk, tv, window, softcap)
    assert over <= 1.0, (err, over)
    wrong = tv.clone()
    wrong[:, :, Skv - 32 : Skv - 16] = tv[:, :, :16]
    bad = flash_attention_ref(tq, tk, wrong, window=window, softcap=softcap)
    assert _flash_err(bad, tq, tk, tv, window, softcap)[1] > 1.0


@pytest.mark.parametrize("T,m,bt,bm", [(64, 256, 32, 128), (96, 384, 32, 128), (32, 512, 32, 512)])
def test_local_stats_plain_matches_jax_kernel(T, m, bt, bm):
    h = np.random.RandomState(T + m).randn(T, m).astype(np.float32) * 2.0
    want = jax_local_stats(jnp.asarray(h), block_t=bt, block_m=bm, interpret=True)
    _close(local_stats_ref(_t(h)).numpy(), want, STATS_TOL)


@pytest.mark.parametrize("T,m", [(37, 50), (1, 96), (130, 7)])
def test_local_stats_plain_row_mask_matches_jax_ffn_stats(T, m):
    """Any T and m, with the token mask of ``ffn_forward_with_stats`` that
    the TPU kernel lacks: equal to the jnp path's masked sum."""
    rng = np.random.RandomState(T * m)
    h = rng.randn(T, m).astype(np.float32)
    mask = (rng.rand(T) > 0.4).astype(np.float32)
    a = jffn.token_normalized_abs(jnp.asarray(h)) * jnp.asarray(mask)[:, None]
    _close(local_stats_ref(_t(h), _t(mask)).numpy(), jnp.sum(a, axis=0), STATS_TOL)
    _close(local_stats_ref(_t(h)).numpy(), jnp.sum(jffn.token_normalized_abs(jnp.asarray(h)), 0),
           STATS_TOL)


def test_ops_route_cpu_tensors_to_the_new_plain_versions():
    """On CPU tensors ops.flash_attention and ops.local_stats are the plain
    versions (bitwise) and count no launch; other devices raise."""
    ops.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    q, k, v = torch.randn(1, 4, 9, 16, generator=g), *torch.randn(2, 1, 2, 11, 16, generator=g)
    assert torch.equal(ops.flash_attention(q, k, v, window=4, softcap=5.0),
                       flash_attention_ref(q, k, v, window=4, softcap=5.0))
    h, mask = torch.randn(9, 33, generator=g), (torch.rand(9, generator=g) > 0.5).float()
    assert torch.equal(ops.local_stats(h, mask), local_stats_ref(h, mask))
    assert ops.launch_counts()["flash_attention"] == ops.launch_counts()["local_stats"] == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.local_stats(h.to("meta"))
    with pytest.raises(ValueError, match="H % K"):
        flash_attention_ref(*(torch.randn(1, h, 4, 8) for h in (3, 2, 2)))


# -- the model against JAX -------------------------------------------------------


@pytest.mark.parametrize("name", ["grouped", "repeated", "local_global"])
def test_dense_forward_and_logits_with_stats_match_jax(models, name):
    jcfg, jparams, model, params = models[name]
    toks = np.random.RandomState(5).randint(0, jcfg.vocab_size, size=(2, 13)).astype(np.int32)
    jlogits, _, jstats, (jk, jv) = jtr.dense_forward(jparams, jnp.asarray(toks), jcfg,
                                                      collect_stats=True, return_cache=True)
    logits, aux, stats, (k, v) = ttr.dense_forward(params, torch.from_numpy(toks), model.cfg,
                                                   collect_stats=True, return_cache=True)
    _close(logits.numpy(), jlogits)
    _close(k.numpy(), jk)
    _close(v.numpy(), jv)
    _close(stats["sum_abs"].numpy(), jstats["sum_abs"], STATS_TOL)
    np.testing.assert_array_equal(stats["count"].numpy(), np.asarray(jstats["count"]))
    assert float(aux) == 0.0
    lg, st = model.logits_with_stats(params, {"tokens": torch.from_numpy(toks)})
    assert torch.equal(lg, logits) and torch.equal(st["sum_abs"], stats["sum_abs"])
    assert torch.equal(model.logits(params, {"tokens": torch.from_numpy(toks)}), logits)


def test_dense_forward_stats_mask_matches_jax(models):
    jcfg, jparams, model, params = models["grouped"]
    rng = np.random.RandomState(6)
    toks = rng.randint(0, jcfg.vocab_size, size=(3, 9)).astype(np.int32)
    smask = (rng.rand(3, 9) > 0.3).astype(np.float32)
    _, _, jstats, _ = jtr.dense_forward(jparams, jnp.asarray(toks), jcfg, collect_stats=True,
                                        stats_mask=jnp.asarray(smask))
    _, _, stats, _ = ttr.dense_forward(params, torch.from_numpy(toks), model.cfg,
                                       collect_stats=True, stats_mask=_t(smask))
    _close(stats["sum_abs"].numpy(), jstats["sum_abs"], STATS_TOL)
    _close(stats["count"].numpy(), jstats["count"])


def test_dense_forward_ffn_masks_match_jax(models):
    """Model.logits with a shared (L, m) unit mask on every FFN."""
    jcfg, jparams, model, params = models["local_global"]
    rng = np.random.RandomState(9)
    toks = rng.randint(0, jcfg.vocab_size, size=(2, 8)).astype(np.int32)
    masks = (rng.rand(jcfg.n_layers, jcfg.d_ff) > 0.5).astype(np.float32)
    want = jax_build_model(jcfg).logits(jparams, {"tokens": jnp.asarray(toks)},
                                        ffn_masks=jnp.asarray(masks))
    got = model.logits(params, {"tokens": torch.from_numpy(toks)}, ffn_masks=_t(masks))
    _close(got.numpy(), want)


@pytest.mark.parametrize("name", ["grouped", "repeated"])
def test_dense_prefill_matches_jax(models, name):
    """Model.prefill: logits, the contiguous cache (prompt rows filled,
    the rest zero) and the stat sums."""
    jcfg, jparams, model, params = models[name]
    toks = np.random.RandomState(7).randint(0, jcfg.vocab_size, size=(2, 11)).astype(np.int32)
    jlogits, jcache, jstats = jax_build_model(jcfg).prefill(jparams, {"tokens": jnp.asarray(toks)},
                                                            16)
    logits, cache, stats = model.prefill(params, {"tokens": torch.from_numpy(toks)}, 16)
    _close(logits.numpy(), jlogits)
    for key in ("k", "v"):
        assert tuple(cache[key].shape) == jcache[key].shape == (2, 2, 16, 2, 12)
        _close(cache[key].numpy(), jcache[key])
        assert not cache[key][:, :, 11:].any()
    _close(stats["sum_abs"].numpy(), jstats["sum_abs"], STATS_TOL)
    _close(stats["count"].numpy(), jstats["count"])


@pytest.mark.parametrize("per_slot", [False, True])
def test_compact_params_equal_jax(models, per_slot):
    jcfg, jparams, model, params = models["local_global"]
    rng = np.random.RandomState(8)
    shape = (jcfg.n_layers, 3) if per_slot else (jcfg.n_layers,)
    idx = np.sort(np.stack([rng.permutation(jcfg.d_ff)[:40] for _ in range(int(np.prod(shape)))]),
                  axis=-1).reshape(*shape, 40).astype(np.int32)
    want = jax_compact_params(jax_build_model(jcfg), jparams, jnp.asarray(idx))
    got = compact_params(model, params, torch.from_numpy(idx))
    assert set(got) == set(want) == {"w_up", "w_down", "w_gate"}
    for key in got:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


def test_options_outside_the_slice_raise(models):
    _, _, model, params = models["grouped"]
    toks = torch.zeros(1, 4, dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="item 7"):
        ttr.dense_forward(params, toks, model.cfg, probes=torch.zeros(2, 1, 4, 96))
    mrope = model.cfg.replace(rope_type="mrope", mrope_sections=(2, 2, 2))
    with pytest.raises(NotImplementedError, match="item 8"):
        ttr.dense_forward(params, toks, mrope)
    moe = build_model(model.cfg.replace(family="moe", n_experts=4, n_experts_per_tok=2))
    with pytest.raises(NotImplementedError, match="item 8"):
        moe.prefill(params, {"tokens": toks}, 8)
    with pytest.raises(NotImplementedError, match="item 8"):
        compact_params(moe, params, torch.zeros(2, 4, dtype=torch.int32))


# -- the kernels on the card -------------------------------------------------------


@pytest.mark.gpu
def test_cuda_prefill_kernels_match_plain_versions():
    """On the card: flash attention (GQA, any length, window, softcap,
    strided model-layout views) within 2e-5 and local stats within 1e-5 of
    their plain versions in f32, local stats bitwise equal across two
    calls, and one launch counted per call.  The bf16 (tensor-core) flash
    kernel is deterministic (two calls bitwise equal) and batch-invariant
    (each batch row bitwise equal to a B 1 call on that row)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    ops.reset_launch_counts()
    g = torch.Generator(device="cuda").manual_seed(0)
    for Sq, Skv, H, K, window, softcap in [(37, 37, 8, 2, None, None), (20, 70, 4, 4, 9, 30.0)]:
        q = torch.randn(2, Sq, H, 64, generator=g, device="cuda").transpose(1, 2)
        k, v = (torch.randn(2, Skv, K, 64, generator=g, device="cuda").transpose(1, 2)
                for _ in range(2))
        torch.testing.assert_close(ops.flash_attention(q, k, v, window=window, softcap=softcap),
                                   flash_attention_ref(q, k, v, window=window, softcap=softcap),
                                   atol=ATTN_TOL, rtol=ATTN_TOL)
    h = torch.randn(70, 300, generator=g, device="cuda")
    mask = (torch.rand(70, generator=g, device="cuda") > 0.5).float()
    got = ops.local_stats(h, mask)
    torch.testing.assert_close(got, local_stats_ref(h, mask), atol=STATS_TOL, rtol=STATS_TOL)
    assert torch.equal(got, ops.local_stats(h, mask))
    q = torch.randn(3, 100, 8, 128, generator=g, device="cuda").bfloat16().transpose(1, 2)
    k, v = (torch.randn(3, 100, 2, 128, generator=g, device="cuda").bfloat16().transpose(1, 2)
            for _ in range(2))
    out = ops.flash_attention(q, k, v)
    assert torch.isfinite(out.float()).all()
    assert torch.equal(out, ops.flash_attention(q, k, v))
    for i in range(3):
        assert torch.equal(out[i : i + 1], ops.flash_attention(q[i : i + 1], k[i : i + 1],
                                                               v[i : i + 1]))
    assert ops.launch_counts()["flash_attention"] == 7 and ops.launch_counts()["local_stats"] == 2
