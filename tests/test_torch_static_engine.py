"""The port's static ``Engine`` and ``ContinuousEngine`` against the JAX
package's, and the port's queue-driven engines against its own ``Engine``.

Both packages serve the same prompts on the same weights (numpy bridge) on
the tiny fp32 config of the JAX suites (``tests/test_serve_engine.py``):
greedy token streams must be EQUAL, in every GLASS mode and both GQA
layouts; ``Engine``'s per-step logits agree within 1e-5.  Then the parity
oracle of the JAX suites, port against port: greedy ``ContinuousEngine``
and ``PagedEngine`` streams equal a per-request ``Engine.generate``.  Each
JAX engine mode compiles its own programs, so the JAX side runs once per
module (fixtures) with few new tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GlassConfig as JaxGlassConfig
from repro.models import ModelConfig as JaxModelConfig
from repro.models import build_model as jax_build_model
from repro.serve.engine import ContinuousEngine as JaxContinuousEngine
from repro.serve.engine import Engine as JaxEngine
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.core import GlassConfig
from repro_torch.models import ModelConfig, build_model
from repro_torch.params import from_reference
from repro_torch.serve import ContinuousEngine, Engine, PagedEngine, Request

TOL = 1e-5
BASE = dict(n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, head_dim=12,
            d_ff=96, vocab_size=101, dtype="float32", remat="none")
LAYOUTS = {
    "grouped": JaxModelConfig(name="ts-dense", family="dense", **BASE),
    "repeated": JaxModelConfig(name="ts-repeated", family="dense", gqa_layout="repeated", **BASE),
}
# mode -> GlassConfig kwargs; None serves dense
MODES = {
    None: None,
    "compact": dict(density=0.5),
    "masked": dict(density=0.5),
    "block_sparse": dict(density=0.5, selection="block", block_size=32),
}
# (prompt_len, max_new, arrival): staggered arrivals, slot reuse, max_new 1
STAGGERED = [(4, 6, 0), (6, 4, 0), (4, 8, 1), (5, 1, 3), (6, 5, 7)]
MAX_NEW = 6


@pytest.fixture(scope="module")
def models():
    """{layout: (jax model, jax params, port model, port params)} and the prior."""
    out = {}
    for name, jcfg in LAYOUTS.items():
        jmodel = jax_build_model(jcfg)
        jparams = jmodel.init(jax.random.key(0))
        model = build_model(ModelConfig.from_dict(dataclasses.asdict(jcfg)))
        out[name] = (jmodel, jparams, model, from_reference(jax.device_get(jparams), device="cpu"))
    prior = np.abs(np.random.RandomState(7).randn(BASE["n_layers"], BASE["d_ff"]))
    prior = prior.astype(np.float32)
    return out, prior


def _glass(mode, prior, jax_side: bool):
    if mode is None:
        return {}
    cls = JaxGlassConfig if jax_side else GlassConfig
    return dict(glass=cls(**MODES[mode]), glass_mode=mode,
                global_prior=jnp.asarray(prior) if jax_side else torch.from_numpy(prior))


def _prompts():
    return np.random.RandomState(0).randint(3, 101, size=(3, 9)).astype(np.int32)


def _requests(cls):
    rng = np.random.RandomState(0)
    return [cls(uid=i, prompt=rng.randint(3, 101, size=n).astype(np.int32), max_new=m, arrival=a)
            for i, (n, m, a) in enumerate(STAGGERED)]


# -- against JAX -------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["grouped", "repeated"])
@pytest.mark.parametrize("mode", ["compact", "masked", "block_sparse"])
def test_engine_generate_equals_jax(models, mode, layout):
    ms, prior = models
    jmodel, jparams, model, params = ms[layout]
    want = JaxEngine(jmodel, jparams, **_glass(mode, prior, True)).generate(
        jnp.asarray(_prompts()), MAX_NEW, return_logits=True)
    got = Engine(model, params, **_glass(mode, prior, False), device="cpu").generate(
        _prompts(), MAX_NEW, return_logits=True)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    assert got.tokens.shape == (3, MAX_NEW) and got.tokens.dtype == np.int32
    np.testing.assert_allclose(got.logits_seq, np.asarray(want.logits_seq), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(got.masks.idx.numpy(), np.asarray(want.masks.idx))


@pytest.mark.parametrize("mode", [None, "compact", "block_sparse"])
def test_continuous_engine_equals_jax(models, mode):
    """Same streams, and the same ticks and slot-steps: the decode horizon
    logic is the JAX engine's."""
    ms, prior = models
    jmodel, jparams, model, params = ms["grouped"]
    jeng = JaxContinuousEngine(jmodel, jparams, max_slots=2, max_len=32,
                               **_glass(mode, prior, True))
    want = jeng.run(_requests(JaxRequest))
    eng = ContinuousEngine(model, params, max_slots=2, max_len=32, **_glass(mode, prior, False),
                           device="cpu")
    got = eng.run(_requests(Request))
    assert sorted(got) == sorted(want) == list(range(len(STAGGERED)))
    for uid in got:
        np.testing.assert_array_equal(got[uid].tokens, want[uid].tokens, err_msg=f"uid={uid}")
        assert (got[uid].admitted_step, got[uid].finished_step) == (
            want[uid].admitted_step, want[uid].finished_step)
    assert (eng.t, eng.slot_steps) == (jeng.t, jeng.slot_steps)
    assert eng.pool.n_free == 2 and not eng.pool.active.any() and eng.n_active == 0


# -- port against port: the parity oracle ---------------------------------------------


def _per_request(model, params, prior, mode, reqs):
    ref = Engine(model, params, **_glass(mode, prior, False), device="cpu")
    return {r.uid: ref.generate(r.prompt[None], r.max_new).tokens[0] for r in reqs}


@pytest.mark.parametrize("mode", ["compact", "masked", "block_sparse"])
def test_continuous_engine_equals_per_request_engine(models, mode):
    ms, prior = models
    _, _, model, params = ms["repeated"]
    reqs = _requests(Request)
    done = ContinuousEngine(model, params, max_slots=2, max_len=32, **_glass(mode, prior, False),
                            device="cpu").run(reqs)
    for uid, want in _per_request(model, params, prior, mode, reqs).items():
        np.testing.assert_array_equal(done[uid].tokens, want, err_msg=f"uid={uid}")


@pytest.mark.parametrize("mode,attn_mode", [
    (None, "paged_pallas"), ("compact", "paged_pallas"), ("masked", "gather"),
    ("block_sparse", "paged_pallas"),
])
def test_paged_engine_equals_per_request_engine(models, mode, attn_mode):
    """Chunked paged prefill (chunks of 3) and interleaved decode give the
    streams of the full-sequence prefill and the contiguous-cache decode."""
    ms, prior = models
    _, _, model, params = ms["grouped"]
    reqs = _requests(Request)
    eng = PagedEngine(model, params, max_slots=2, max_len=32, block_size=4, chunk_tokens=3,
                      alloc_mode="full", attn_mode=attn_mode, **_glass(mode, prior, False),
                      device="cpu")
    for r in reqs:
        eng.add_request(r.prompt, r.max_new, uid=r.uid, arrival=r.arrival)
    done = eng.run()
    for uid, want in _per_request(model, params, prior, mode, reqs).items():
        np.testing.assert_array_equal(done[uid].tokens, want, err_msg=f"uid={uid}")


# -- what is not ported --------------------------------------------------------------


@pytest.mark.parametrize("kwargs", [dict(temperature=0.7), dict(top_k=5), dict(rng=object())])
def test_sampling_options_raise(models, kwargs):
    ms, prior = models
    _, _, model, params = ms["grouped"]
    with pytest.raises(NotImplementedError, match="item 2"):
        Engine(model, params, device="cpu").generate(_prompts(), 3, **kwargs)
    with pytest.raises(NotImplementedError, match="item 2"):
        ContinuousEngine(model, params, device="cpu", **kwargs)


def test_invalid_configurations_raise(models):
    ms, prior = models
    _, _, model, params = ms["grouped"]
    tprior = torch.from_numpy(prior)
    with pytest.raises(ValueError, match="prior"):
        Engine(model, params, glass=GlassConfig(), device="cpu")
    with pytest.raises(ValueError, match="block ids"):
        ContinuousEngine(model, params, glass=GlassConfig(selection="block"), global_prior=tprior,
                         device="cpu")
    with pytest.raises(ValueError, match="selection='block'"):
        Engine(model, params, glass=GlassConfig(), global_prior=tprior, glass_mode="block_sparse",
               device="cpu")
    with pytest.raises(ValueError, match="block ids"):
        PagedEngine(model, params, glass=GlassConfig(selection="block"), global_prior=tprior,
                    glass_mode="compact", device="cpu")
    moe = build_model(model.cfg.replace(family="moe", n_experts=4, n_experts_per_tok=2))
    for cls in (Engine, ContinuousEngine):
        with pytest.raises(NotImplementedError, match="item 8"):
            cls(moe, params, device="cpu")
