"""The port's PagedEngine against the JAX package's, and its guard rails.

Both engines serve the same workload on the same weights (numpy bridge)
with ``alloc_mode="full"``; greedy token streams must be EQUAL, dense, with
GLASS compact decode (each slot's gathered FFN rows, held against the JAX
engine's at admission) and with block-sparse decode, including two
requests that share a prompt and so batch through the shared-list kernel;
under staggered arrivals the
step accounting (``admitted_step``, ``finished_step``, ``t``,
``slot_steps``) must be equal too, for every ``decode_chunk``.  The tiny
float32 config is the JAX suites' (``tests/test_paged_serving.py``).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GlassConfig as JaxGlassConfig
from repro.models import ModelConfig as JaxModelConfig
from repro.models import build_model as jax_build_model
from repro.serve.engine import PagedEngine as JaxPagedEngine
from repro.serve.sampling import SamplingParams as JaxSamplingParams
from repro_torch.core import GlassConfig, GlassParams
from repro_torch.models import ModelConfig, build_model
from repro_torch.params import from_reference
from repro_torch.serve import AdmissionPolicy, PagedEngine, SamplingParams

BASE = dict(n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, head_dim=12,
            d_ff=96, vocab_size=101, dtype="float32", remat="none")
JCFG = JaxModelConfig(name="te-dense", family="dense", **BASE)
ENGINE = dict(max_slots=3, max_len=32, block_size=8, chunk_tokens=5, alloc_mode="full")
TOL = 1e-5  # fp32, across frameworks
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


@pytest.fixture(scope="module")
def models():
    jmodel = jax_build_model(JCFG)
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(ModelConfig.from_dict(dataclasses.asdict(JCFG)))
    params = from_reference(jax.device_get(jparams), device="cpu")
    prior = np.abs(np.random.RandomState(7).randn(JCFG.n_layers, JCFG.d_ff)).astype(np.float32)
    return jmodel, jparams, model, params, prior


def _workload():
    """(prompt, max_new): requests 0 and 1 share a prompt."""
    rng = np.random.RandomState(0)
    shared = rng.randint(3, 101, size=11).astype(np.int32)
    return [(shared, 10), (shared, 10), (rng.randint(3, 101, size=7).astype(np.int32), 6),
            (rng.randint(3, 101, size=9).astype(np.int32), 8)]


def _serve(eng, work):
    for uid, (prompt, max_new) in enumerate(work):
        eng.add_request(prompt, max_new, uid=uid)
    return eng.run()


# glass_mode -> GlassConfig kwargs: compact takes neuron selection, as in JAX
GLASS = {
    "compact": dict(density=0.5),
    "block_sparse": dict(density=0.5, selection="block", block_size=32),
}


def _serve_stepped(eng, work):
    """Serve ``work`` step by step; returns (final outputs, {uid: the
    request's compact FFN rows, as numpy, read from the engine's slot arena
    at the end of the step in which it first decodes}).  A request's rows
    are written when its last prefill chunk runs."""
    for uid, (prompt, max_new) in enumerate(work):
        eng.add_request(prompt, max_new, uid=uid)
    done, rows = {}, {}
    while eng._work_remaining():
        assert eng.t < 200, "the engine did not drain"
        done.update((f.uid, f) for f in eng.step() if getattr(f, "finished", True))
        arena = eng.glass_slots.arena
        for e in eng.lc.entries.values():
            if e.state.value == "running" and e.uid not in rows:
                rows[e.uid] = {k: np.array(a[:, e.slot]) for k, a in arena.items()}  # a copy
    return done, rows


@pytest.fixture(scope="module")
def jax_streams(models):
    """{glass_mode: (the JAX engine's final outputs, its compact rows per
    request or None)} (gather attention), run once per mode and shared by
    the port's attention modes."""
    jmodel, jparams, _, _, prior = models
    runs = {}

    def get(glass_mode):
        if glass_mode not in runs:
            jkw = {}
            if glass_mode:
                jkw = dict(glass=JaxGlassConfig(**GLASS[glass_mode]),
                           global_prior=jnp.asarray(prior), glass_mode=glass_mode)
            eng = JaxPagedEngine(jmodel, jparams, **ENGINE, **jkw)
            if glass_mode == "compact":
                runs[glass_mode] = _serve_stepped(eng, _workload())
            else:
                runs[glass_mode] = (_serve(eng, _workload()), None)
        return runs[glass_mode]

    return get


@pytest.mark.parametrize("glass_mode,attn_mode", [
    (None, "gather"), (None, "paged_pallas"), ("compact", "gather"), ("compact", "paged_pallas"),
    ("block_sparse", "gather"), ("block_sparse", "paged_pallas"),
])
def test_greedy_streams_equal_jax_engine(models, jax_streams, glass_mode, attn_mode):
    """Equal streams; in compact mode also each request's gathered FFN rows
    (w_up, w_gate (L, d, k), w_down (L, k, d)) equal the JAX engine's
    ``compact_params`` rows of the same request within the file's fp32
    tolerance (the JAX engine exposes no per-request logits)."""
    _, _, model, params, prior = models
    kw = {}
    if glass_mode:
        kw = dict(glass=GlassConfig(**GLASS[glass_mode]), global_prior=torch.from_numpy(prior),
                  glass_mode=glass_mode)
    work = _workload()
    jdone, jrows = jax_streams(glass_mode)
    eng = PagedEngine(model, params, **ENGINE, **kw, attn_mode=attn_mode, device="cpu")
    if glass_mode == "compact":
        done, rows = _serve_stepped(eng, work)
        assert sorted(rows) == sorted(jrows) == list(range(len(work)))
        for uid, got in rows.items():
            assert sorted(got) == sorted(jrows[uid]) == ["w_down", "w_gate", "w_up"]
            for k, a in got.items():
                np.testing.assert_allclose(a, jrows[uid][k], rtol=TOL, atol=TOL,
                                           err_msg=f"uid={uid} {k}")
        for a in eng.glass_slots.arena.values():  # every slot cleared after the drain
            assert not a.any()
    else:
        done = _serve(eng, work)
    assert sorted(done) == sorted(jdone) == list(range(len(work)))
    for uid in done:
        np.testing.assert_array_equal(done[uid].tokens, jdone[uid].tokens, err_msg=f"uid={uid}")
        assert done[uid].finish_reason == jdone[uid].finish_reason == "length"
    if glass_mode == "block_sparse":
        assert eng.grouped_rows > 0  # the shared prompt went through the shared-list kernel
    # the drained pool is empty
    assert eng.pool.allocator.n_live == 0
    assert eng.pool.n_free_slots == ENGINE["max_slots"] and not eng.pool.active.any()
    assert not eng.lc.entries and not len(eng.scheduler)


# staggered arrivals through 2 slots: requests wait for slots, prefill in
# 4-token chunks between decode ticks, and the horizon is cut by budgets
# and by the next arrival
HORIZON_ENGINE = dict(max_slots=2, max_len=32, block_size=4, chunk_tokens=4, alloc_mode="full")
ARRIVALS = (0, 0, 2, 3, 10)


def _staggered_workload():
    rng = np.random.RandomState(1)
    return [(rng.randint(3, 101, size=n).astype(np.int32), m)
            for n, m in zip((9, 6, 11, 5, 7), (7, 9, 5, 8, 6))]


def _serve_staggered(eng, sampling):
    for uid, ((prompt, max_new), arrival) in enumerate(zip(_staggered_workload(), ARRIVALS)):
        eng.add_request(prompt, max_new, uid=uid, arrival=arrival, sampling=sampling)
    return eng.run(), eng.t, eng.slot_steps


@pytest.fixture(scope="module")
def jax_staggered(models):
    """{(decode_chunk, with_eos): (final outputs, t, slot_steps)} of the JAX
    engine; the eos leg stops on a token of request 3's stream."""
    jmodel, jparams, _, _, prior = models
    runs = {}

    def get(decode_chunk, with_eos):
        key = (decode_chunk, with_eos)
        if key not in runs:
            sampling = None
            if with_eos:
                sampling = JaxSamplingParams.make_greedy(eos_token_id=_staggered_eos(get))
            eng = JaxPagedEngine(
                jmodel, jparams, **HORIZON_ENGINE, decode_chunk=decode_chunk,
                glass=JaxGlassConfig(density=0.5, selection="block", block_size=32),
                global_prior=jnp.asarray(prior), glass_mode="block_sparse")
            runs[key] = _serve_staggered(eng, sampling)
        return runs[key]

    return get


def _staggered_eos(jax_get):
    return int(jax_get(1, False)[0][3].tokens[2])


class _TickSpy:
    """A Model whose ``decode_step`` also hands each tick's logits to
    ``on_tick``; every other attribute is the model's."""

    def __init__(self, model, on_tick):
        self._model, self._on_tick = model, on_tick

    def __getattr__(self, name):
        return getattr(self._model, name)

    def decode_step(self, *args, **kw):
        logits, cache = self._model.decode_step(*args, **kw)
        self._on_tick(logits)
        return logits, cache


@pytest.mark.parametrize("with_eos", [False, True])
@pytest.mark.parametrize("decode_chunk", [1, 8])
def test_step_accounting_equals_jax_engine(models, jax_staggered, decode_chunk, with_eos):
    """The port decodes the JAX engine's horizon each step, so every
    request is admitted and finished at the same step and the engines end
    at the same ``t`` and ``slot_steps``, with equal streams.  Stepped by
    hand: ``first_logits`` holds each decoded request once, with the
    logits of tick 0 of the step that first decodes it."""
    _, _, model, params, prior = models
    jdone, jt, jslot_steps = jax_staggered(decode_chunk, with_eos)
    sampling = None
    if with_eos:
        sampling = SamplingParams.make_greedy(eos_token_id=_staggered_eos(jax_staggered))
    eng = PagedEngine(model, params, **HORIZON_ENGINE, decode_chunk=decode_chunk,
                      glass=GlassConfig(density=0.5, selection="block", block_size=32),
                      global_prior=torch.from_numpy(prior), glass_mode="block_sparse",
                      device="cpu")
    ticks = []  # (f32 last-position logits, {uid: slot}) of each decode tick of a step
    eng.model = _TickSpy(model, lambda lg: ticks.append(
        (lg[:, -1].float().clone(), {e.uid: e.slot for e in eng.lc.entries.values()})))
    for uid, ((prompt, max_new), arrival) in enumerate(zip(_staggered_workload(), ARRIVALS)):
        eng.add_request(prompt, max_new, uid=uid, arrival=arrival, sampling=sampling)
    done, first = {}, {}
    while eng._work_remaining():
        assert eng.t < 200, "PagedEngine did not drain"
        ticks.clear()
        done.update((f.uid, f) for f in eng.step() if f.finished)
        for uid, row in eng.first_logits.items():
            assert uid not in first, f"uid={uid} in first_logits twice"
            lg, slots = ticks[0]
            torch.testing.assert_close(row, lg[slots[uid]], rtol=0, atol=0)
            first[uid] = row
    t, slot_steps = eng.t, eng.slot_steps
    assert sorted(first) == sorted(u for u, d in done.items() if len(d.tokens) > 1)
    for uid, row in first.items():
        assert int(torch.argmax(row)) == int(done[uid].tokens[1]), f"uid={uid}"
    assert sorted(done) == sorted(jdone) == list(range(len(ARRIVALS)))
    for uid in done:
        got, want = done[uid], jdone[uid]
        np.testing.assert_array_equal(got.tokens, want.tokens, err_msg=f"uid={uid}")
        assert (got.admitted_step, got.finished_step, got.finish_reason) == (
            want.admitted_step, want.finished_step, want.finish_reason), f"uid={uid}"
    assert (t, slot_steps) == (jt, jslot_steps)
    if with_eos:
        assert any(d.finish_reason == "eos" for d in done.values())
    assert eng.pool.allocator.n_live == 0 and not eng.lc.entries


def test_abort_and_stop_release_everything(models):
    _, _, model, params, prior = models
    glass = dict(glass=GlassConfig(density=0.5, selection="block", block_size=32),
                 global_prior=torch.from_numpy(prior), glass_mode="block_sparse")
    work = _workload()
    ref = _serve(PagedEngine(model, params, **ENGINE, **glass, device="cpu"), work)
    eng = PagedEngine(model, params, **ENGINE, **glass, device="cpu")
    eos = int(ref[2].tokens[2])
    for uid, (prompt, max_new) in enumerate(work):
        sp = SamplingParams.make_greedy(eos_token_id=eos) if uid == 2 else None
        eng.add_request(prompt, max_new, uid=uid, sampling=sp)
    eng.add_request(work[3][0], 4, uid=9)  # aborted while queued
    for _ in range(4):
        eng.step()
    assert eng.abort(9).finish_reason == "aborted"
    running = next(e.uid for e in eng.lc.entries.values() if e.state.value == "running")
    aborted = eng.abort(running)
    assert aborted.finish_reason == "aborted" and eng.abort(running) is None
    done = eng.run()
    stop_at = list(ref[2].tokens).index(eos) + 1
    np.testing.assert_array_equal(done[2].tokens, ref[2].tokens[:stop_at])
    assert done[2].finish_reason == "eos"
    assert eng.pool.allocator.n_live == 0 and not eng.lc.entries


@pytest.mark.parametrize("kwargs,match", [
    (dict(alloc_mode="incremental"), "item 1"),
    (dict(preemption=object()), "item 1"),
    (dict(policy=AdmissionPolicy.PRIORITY), "item 1"),
    (dict(temperature=0.8), "item 2"),
    (dict(top_k=40), "item 2"),
    (dict(sampling=SamplingParams(seed=3)), "item 2"),
    (dict(spec_k=2), "item 4"),
    (dict(glass=GlassConfig(density=0.5, draft_ratio=0.5)), "item 4"),
    (dict(prefix_cache=True), "item 5"),
])
def test_options_outside_the_slice_raise(models, kwargs, match):
    _, _, model, params, prior = models
    kw = dict(ENGINE, glass=GlassConfig(density=0.5, selection="neuron"),
              global_prior=torch.from_numpy(prior), glass_mode="masked", device="cpu")
    kw.update(kwargs)
    with pytest.raises(NotImplementedError, match=match):
        PagedEngine(model, params, **kw)


@pytest.mark.parametrize("request_kw,match", [
    (dict(sampling=SamplingParams(seed=5, temperature=0.9)), "item 2"),
    (dict(glass=GlassParams(density=0.25)), "item 3"),
    (dict(glass=GlassParams(spec_k=2)), "item 4"),
])
def test_request_options_outside_the_slice_raise(models, request_kw, match):
    _, _, model, params, prior = models
    eng = PagedEngine(model, params, **ENGINE, glass=GlassConfig(density=0.5),
                      global_prior=torch.from_numpy(prior), glass_mode="masked", device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        eng.add_request(np.arange(5, dtype=np.int32), 3, **request_kw)
    assert not len(eng.scheduler)


def test_defaults_are_the_slice_path(models):
    """With no mode given, the engine takes the JAX engine's default,
    compact GLASS decode, with full allocation; block selection under
    compact raises ValueError, as in JAX, and is served by asking for
    block_sparse."""
    _, _, model, params, prior = models
    tprior = torch.from_numpy(prior)
    eng = PagedEngine(model, params, max_slots=3, max_len=32, block_size=8,
                      glass=GlassConfig(density=0.5), global_prior=tprior, device="cpu")
    assert eng.glass_slots.mode == "compact"
    block = GlassConfig(density=0.5, selection="block", block_size=32)
    with pytest.raises(ValueError, match="block ids"):
        PagedEngine(model, params, glass=block, global_prior=tprior, device="cpu")
    eng = PagedEngine(model, params, glass=block, global_prior=tprior, glass_mode="block_sparse",
                      device="cpu")
    assert eng.glass_slots.mode == "block_sparse"
    with pytest.raises(ValueError, match="glass_mode='masked'"):  # neuron ids to block_sparse
        PagedEngine(model, params, glass=GlassConfig(density=0.5), global_prior=tprior,
                    glass_mode="block_sparse", device="cpu")


def test_serve_example_call_shape_names_item_4(models):
    """The JAX serve example's engine call (examples/serve_glass.py) takes
    the default compact mode with a draft tier (``draft_ratio=0.5``), so it
    raises NotImplementedError naming ROADMAP Queue 1 item 4 (speculative
    decode) until that item is ported."""
    _, _, model, params, prior = models
    with pytest.raises(NotImplementedError, match="item 4"):
        PagedEngine(model, params, max_slots=3, max_len=48, block_size=8, chunk_tokens=8,
                    glass=GlassConfig(density=0.5, draft_ratio=0.5),
                    global_prior=torch.from_numpy(prior), device="cpu")


def test_other_families_raise():
    moe = build_model(ModelConfig(name="m", family="moe", n_experts=4, n_experts_per_tok=2,
                                  **BASE))
    with pytest.raises(NotImplementedError, match="item 8"):
        PagedEngine(moe, {}, **ENGINE, device="cpu")


def test_port_imports_no_jax_and_nothing_of_repro():
    """In a fresh interpreter, importing every repro_torch module (and
    chip_smoke) leaves jax and repro out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    root = os.path.dirname(SRC)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, root]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=root, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_entry_points_refuse_to_run_on_cpu_unasked(models):
    """With no device given, the entry points target CUDA; on a host
    without a card they fail instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device is valid here")
    jmodel, jparams, model, params, prior = models
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        from_reference(jax.device_get(jparams))
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedEngine(model, params, **ENGINE)
