"""The port's engines against the JAX package's on the configs whose
attention and embedding paths the plain dense config leaves out.

Three tiny fp32 configs: a sliding window with the local/global layer
pattern; an attention softcap with a logit softcap; a non-gated FFN with
untied embeddings and ``embed_scale``.  On each, the port's
``PagedEngine`` (gather attention and the paged-attention kernel's plain
version, chunked prefill across the window's edge) and its static
``Engine`` serve the same prompts on the same weights (numpy bridge) as
the JAX engines: greedy streams EQUAL, and the logits of every decode
step within 1e-5 of the JAX ``Engine``'s.  Each JAX engine compiles once
per config (module fixture).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import ModelConfig as JaxModelConfig
from repro.models import build_model as jax_build_model
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import PagedEngine as JaxPagedEngine
from repro_torch.models import ModelConfig, build_model
from repro_torch.params import from_reference
from repro_torch.serve import Engine, PagedEngine

TOL = 1e-5  # fp32, across frameworks
BASE = JaxModelConfig(name="tc-dense", family="dense", n_layers=2, d_model=48, n_heads=4,
                      n_kv_heads=2, head_dim=12, d_ff=96, vocab_size=101, dtype="float32",
                      remat="none")
CONFIGS = {
    # window 5 against prompts of 10 in chunks of 4 through blocks of 4
    "local_global": BASE.replace(name="tc-local-global", sliding_window=5,
                                 attn_pattern="local_global"),
    # caps small enough to bend this model's scores and logits
    "softcaps": BASE.replace(name="tc-softcaps", attn_softcap=1.0, logit_softcap=2.0),
    "ungated_untied": BASE.replace(name="tc-ungated", gated_ffn=False, ffn_act="gelu",
                                   tie_embeddings=False, embed_scale=True),
}
PAGED = dict(max_slots=2, max_len=24, block_size=4, chunk_tokens=4, alloc_mode="full")
MAX_NEW = 6


def _prompts():
    """Three prompts of one length, so one batched ``Engine.generate`` gives
    each request's logits (the rows of a dense batch are independent)."""
    return np.random.RandomState(3).randint(3, 101, size=(3, 10)).astype(np.int32)


def _serve_paged(eng):
    """{uid: tokens}, {uid: first-decode logits} of the prompts served one
    request per uid, stepped by hand (the JAX engine keeps no logits)."""
    for uid, p in enumerate(_prompts()):
        eng.add_request(p, MAX_NEW, uid=uid)
    done, first = {}, {}
    while eng._work_remaining():
        assert eng.t < 200, "the engine did not drain"
        done.update((f.uid, f.tokens) for f in eng.step() if getattr(f, "finished", True))
        first.update(getattr(eng, "first_logits", {}))
    return done, first


@pytest.fixture(scope="module")
def runs():
    """{config: (port model, port params, JAX Engine result, JAX PagedEngine
    streams)}, built on first use."""
    out = {}

    def get(name):
        if name not in out:
            jcfg = CONFIGS[name]
            jmodel = jax_build_model(jcfg)
            jparams = jmodel.init(jax.random.key(0))
            model = build_model(ModelConfig.from_dict(dataclasses.asdict(jcfg)))
            params = from_reference(jax.device_get(jparams), device="cpu")
            jres = JaxEngine(jmodel, jparams).generate(_prompts(), MAX_NEW, return_logits=True)
            jstreams, _ = _serve_paged(JaxPagedEngine(jmodel, jparams, **PAGED))
            out[name] = (model, params, jres, jstreams)
        return out[name]

    return get


@pytest.mark.parametrize("config", list(CONFIGS))
def test_engine_equals_jax(runs, config):
    model, params, jres, _ = runs(config)
    res = Engine(model, params, device="cpu").generate(_prompts(), MAX_NEW, return_logits=True)
    np.testing.assert_array_equal(res.tokens, jres.tokens)
    np.testing.assert_allclose(res.logits_seq, jres.logits_seq, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("attn_mode", ["gather", "paged_pallas"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_paged_engine_equals_jax(runs, config, attn_mode):
    """Streams equal the JAX PagedEngine's and the JAX Engine's; each
    request's first-decode logits equal the JAX Engine's first decode step
    within tolerance."""
    model, params, jres, jstreams = runs(config)
    eng = PagedEngine(model, params, **PAGED, attn_mode=attn_mode, device="cpu")
    streams, first = _serve_paged(eng)
    assert sorted(streams) == sorted(jstreams) == [0, 1, 2]
    assert sorted(first) == [0, 1, 2]
    for uid, toks in streams.items():
        np.testing.assert_array_equal(toks, jstreams[uid], err_msg=f"uid={uid}")
        np.testing.assert_array_equal(toks, jres.tokens[uid], err_msg=f"uid={uid}")
        np.testing.assert_allclose(first[uid].numpy(), jres.logits_seq[uid, 0], rtol=TOL,
                                   atol=TOL, err_msg=f"uid={uid}")
