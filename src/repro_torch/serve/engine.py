"""Serving engines with GLASS decode (dense family).

``Engine`` — static batch: every request arrives together, shares one
prompt length and finishes together; one mask set is built from the whole
batch's prefill stats.  The JAX package's baseline and offline-eval engine,
and the parity oracle of the queue-driven engines.

``ContinuousEngine`` — continuous batching over a :class:`KVPool` slot
arena: each request is prefilled alone at its exact length
(``Model.prefill``, the flash-attention and local-stats kernels on the
card), owns per-slot GLASS rows, and decodes in the fixed ``max_slots``
batch over the contiguous cache; up to ``decode_chunk`` ticks run between
admission checks (``_horizon``), as in the JAX engine.

``PagedEngine`` — the port of ``repro/serve/engine.py:PagedEngine`` on the
path the paper's serving loop runs: a :class:`BlockPool` block table,
prompts prefilled in chunks of at most ``chunk_tokens`` interleaved with
decode ticks (GLASS local stats accumulate across chunks; the fused mask
is built at the final chunk), FIFO admission with each request's full KV
need reserved at admission (``alloc_mode="full"``), and greedy decode of
the fixed ``max_slots`` batch through the block table; ``attn_mode=
"paged_pallas"`` runs the paged-attention kernel, ``"gather"`` the dense
gather + softmax.  Each :meth:`PagedEngine.step` decodes the JAX engine's
horizon (``_horizon``: 1 while a prefill chunk is pending, else up to
``decode_chunk`` ticks, bounded by the first possible finish and the next
admissible arrival) as a host loop of single-tick device calls, so steps,
``admitted_step`` and ``finished_step`` count as the JAX engine's do.

GLASS modes (``glass=None`` serves dense): ``"compact"`` (the default, as
in the JAX engines) gathers each request's selected units into narrow FFN
weights, per slot in the queue-driven engines; ``"masked"`` multiplies the
unit mask into h; ``"block_sparse"`` (with
``selection="block"``) feeds the active block lists to the GLASS FFN
kernels — one shared list through the shared-list kernel, per-slot lists
through the rowwise kernel, and, in ``PagedEngine``, rows whose lists
coincide batched through the shared-list kernel.

All three are greedy.  Options of the JAX engines outside the port raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.fusion import GlassConfig, merge_stat_sums
from ..core.glass import GlassParams, build_masks, compact_params
from ..models.api import Model
from ..models.common import resolve_device
from .kv_pool import BlockPool, KVPool, pow2_bucket
from .lifecycle import Lifecycle, LiveRequest, ReqState
from .sampling import SamplingParams
from .scheduler import AdmissionPolicy, FinishedRequest, Request, RequestOutput, Scheduler

_SAMPLING_TODO = "sampled decoding is ROADMAP Queue 1 item 2; the port is greedy"


def _check_glass_args(model: Model, glass: Optional[GlassConfig], global_prior, glass_mode: str):
    """The validation the JAX engines share: a prior with GLASS, block
    selection exactly where the mode needs block ids, the dense family."""
    if model.cfg.family != "dense":
        raise NotImplementedError(
            f"family={model.cfg.family!r}: the port serves the dense family only "
            "(ROADMAP Queue 1 item 8)"
        )
    if glass_mode not in ("compact", "masked", "block_sparse"):
        raise ValueError(f"unknown glass_mode {glass_mode!r}")
    if glass is None:
        return
    if global_prior is None:
        raise ValueError("GLASS needs the offline prior (global_prior)")
    if glass_mode == "block_sparse" and glass.selection != "block":
        raise ValueError(
            "block_sparse mode needs GlassConfig(selection='block'); "
            "pass glass_mode='masked' for another selection"
        )
    if glass_mode == "compact" and glass.selection == "block":
        raise ValueError(
            "block selection yields block ids, not unit indices — "
            "use glass_mode='masked' or 'block_sparse' with it"
        )


def _check_on_device(device: torch.device, params, global_prior) -> None:
    if any(t.device != device for t in _leaves(params)):
        raise ValueError(f"params must live on the engine's device {device}")
    if global_prior is not None and global_prior.device != device:
        raise ValueError(f"global_prior must live on the engine's device {device}")


@dataclass
class GenerationResult:
    tokens: np.ndarray  # (B, max_new) int32
    logits_seq: Optional[np.ndarray]  # (B, max_new, V) f32 when requested
    masks: Optional[object]  # the batch's MaskSet under GLASS


class Engine:
    """Static-batch greedy generation.  ``generate`` prefills the batch
    (``Model.prefill``), builds one GLASS mask set from the batch's stats,
    and decodes ``max_new`` tokens over the contiguous cache.

    The JAX engine keeps a jit cache that it drops when ``params`` is
    rebound; the port runs eagerly, so ``params`` is a plain attribute."""

    def __init__(
        self,
        model: Model,
        params,
        *,
        glass: Optional[GlassConfig] = None,
        global_prior=None,
        glass_mode: str = "compact",  # compact | masked | block_sparse
        device="cuda",
    ):
        _check_glass_args(model, glass, global_prior, glass_mode)
        self.device = resolve_device(device)
        _check_on_device(self.device, params, global_prior)
        self.model = model
        self.params = params
        self.glass = glass
        self.prior = global_prior
        self.glass_mode = glass_mode

    def generate(
        self,
        prompts,  # (B, S) int token ids, one length for the batch
        max_new: int,
        *,
        rng=None,
        temperature: float = 0.0,
        top_k: int = 0,
        return_logits: bool = False,
    ) -> GenerationResult:
        """Greedy: ``tokens[:, 0]`` is the argmax of the prefill's last
        logits, each later token the argmax of the decode step fed the one
        before.  ``logits_seq[:, i]`` are the logits of the decode step fed
        ``tokens[:, i]`` (as float32)."""
        if temperature > 0.0 or top_k != 0 or rng is not None:
            raise NotImplementedError(_SAMPLING_TODO)
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        model, params = self.model, self.params
        toks = torch.as_tensor(np.asarray(prompts), dtype=torch.int64, device=self.device)
        B, S = toks.shape
        logits, cache, stats = model.prefill(params, {"tokens": toks}, S + max_new)
        masks = None
        kw = {}
        if self.glass is not None:
            masks = build_masks(stats, self.prior, self.glass)
            if self.glass_mode == "compact":
                kw["compact_layers"] = compact_params(model, params, masks.idx)
            elif self.glass_mode == "block_sparse":
                kw.update(ffn_block_idx=masks.idx, ffn_block_size=self.glass.block_size)
            else:
                kw["ffn_masks"] = masks.mask
        tok = torch.argmax(logits[:, -1].float(), dim=-1)
        out, lgs = [tok], []
        # the write position lives on the device: no host-to-device copy
        # (which waits for the stream) in the decode loop
        pos = torch.full((), S, dtype=torch.int64, device=self.device)
        # the JAX engine runs max_new steps and drops the last token; the
        # last step only matters for its logits
        for _ in range(max_new if return_logits else max_new - 1):
            lg, cache = model.decode_step(params, tok[:, None], cache, pos, **kw)
            pos = pos + 1
            tok = torch.argmax(lg[:, -1].float(), dim=-1)
            out.append(tok)
            if return_logits:
                lgs.append(lg[:, -1].float())
        return GenerationResult(
            tokens=torch.stack(out[:max_new], dim=1).cpu().numpy().astype(np.int32),
            logits_seq=torch.stack(lgs, dim=1).cpu().numpy() if return_logits else None,
            masks=masks,
        )


class GlassSlotState:
    """Per-slot GLASS rows of the queue-driven engines: ``masked`` keeps a
    float mask arena (L, max_slots, m); ``compact`` the gathered FFN
    weights, w_up (L, max_slots, d, k) and the rest; ``block_sparse`` the
    active block ids and their f32 tile scales, (L, max_slots, nb_keep)
    each.  The arena is created on the first admission (that fixes its
    shapes); a cleared row (zero mask, zero weights, zero scales on block
    0) contributes exactly zero."""

    def __init__(self, model: Model, params, gcfg: GlassConfig, prior: torch.Tensor, mode: str,
                 max_slots: int):
        _check_glass_args(model, gcfg, prior, mode)
        self.model = model
        self.params = params
        self.gcfg = gcfg
        self.prior = prior
        self.mode = mode
        self.max_slots = max_slots
        self.arena = None

    def _rows(self, stats_list):
        stacked = {k: torch.stack([st[k] for st in stats_list]) for k in stats_list[0]}
        ms = build_masks(stacked, self.prior, self.gcfg, slot_axis=True)
        if self.mode == "masked":
            return {"mask": ms.mask}  # (L, R, m)
        if self.mode == "compact":
            return compact_params(self.model, self.params, ms.idx)  # w_up (L, R, d, k), ...
        # all-ones scales: 1.0 * tile is bitwise the unscaled tile
        return {"idx": ms.idx, "scale": torch.ones(ms.idx.shape, device=ms.idx.device)}

    def admit(self, slots: List[int], stats_list) -> Dict[str, torch.Tensor]:
        """Fuse each request's stats with the prior, write the rows into the
        arena at ``slots``, and return the rows (slot axis ``len(slots)``)."""
        rows = self._rows(stats_list)
        if self.arena is None:
            self.arena = {
                k: torch.zeros((r.shape[0], self.max_slots) + tuple(r.shape[2:]),
                               dtype=r.dtype, device=r.device)
                for k, r in rows.items()
            }
        idx = torch.as_tensor(slots, device=self.prior.device)
        for k, r in rows.items():
            self.arena[k][:, idx] = r
        return rows

    def clear(self, slot: int) -> None:
        if self.arena is not None:
            for a in self.arena.values():
                a[:, slot] = 0


class _QueueEngineBase:
    """Host-side plumbing the queue-driven engines share: submission and
    the drain loop.  Subclasses provide ``step()`` and ``_drain_budget()``
    (a safe bound on the ticks that drain the current workload)."""

    def __init__(self, decode_chunk: int):
        self.decode_chunk = max(1, decode_chunk)  # max decode ticks between admission checks

    def submit(self, req: Request) -> None:
        self.scheduler.submit(req)

    def _pow2_horizon(self, h: int) -> int:
        """``h`` clamped to ``decode_chunk`` and rounded down to a power of
        two, as the JAX engines bucket their fused decode."""
        h = min(h, self.decode_chunk)
        p = 1
        while p * 2 <= h:
            p *= 2
        return p

    def _decode_kwargs(self) -> dict:
        """``decode_step``'s GLASS arguments: the per-slot rows of the mode."""
        if self.glass_slots is None:
            return {}
        arena, mode = self.glass_slots.arena, self.glass_slots.mode
        if mode == "masked":
            return {"ffn_masks": arena["mask"]}
        if mode == "compact":  # a cleared slot's zero rows add exactly 0
            return {"compact_layers": arena}
        return {"ffn_block_idx": arena["idx"], "ffn_block_scale": arena["scale"],
                "ffn_block_size": self.glass_slots.gcfg.block_size}

    @property
    def n_active(self) -> int:
        return int(self.pool.active.sum())

    def _inflight_requests(self) -> List[Request]:
        return [r for r in self.live if r is not None]

    def _work_remaining(self) -> bool:
        return bool(len(self.scheduler) or self.pool.active.any())

    def run(self, requests=(), max_steps: Optional[int] = None) -> Dict[int, object]:
        """Submit ``requests`` (:class:`Request` objects) and serve until the
        queue and the slots drain; returns {uid: final output}
        (:class:`FinishedRequest`, or the final :class:`RequestOutput` of
        the streaming paged engine)."""
        for r in requests:
            self.submit(r)
        if max_steps is None:
            queued = list(self.scheduler.queue)
            budget = self._drain_budget(queued, self._inflight_requests())
            arrivals = [r.arrival for r in queued] + [0]
            max_steps = self.t + max(arrivals) + budget + len(queued) + self.pool.max_slots + 8
        done: Dict[int, object] = {}
        while self._work_remaining():
            if self.t > max_steps:
                raise RuntimeError(f"{type(self).__name__} did not drain in {max_steps} steps")
            for f in self.step():
                if getattr(f, "finished", True):
                    done[f.uid] = f
        return done


class ContinuousEngine(_QueueEngineBase):
    """Continuous batching over a fixed slot arena: admit as slots free,
    prefill each request alone at its exact length, decode every slot of
    the arena, evict on completion.  Greedy."""

    def __init__(
        self,
        model: Model,
        params,
        *,
        max_slots: int = 8,
        max_len: int = 256,
        glass: Optional[GlassConfig] = None,
        global_prior=None,
        glass_mode: str = "compact",  # compact | masked | block_sparse
        temperature: float = 0.0,
        top_k: int = 0,
        rng=None,
        decode_chunk: int = 8,  # max decode ticks between admission checks
        device="cuda",
    ):
        _check_glass_args(model, glass, global_prior, glass_mode)
        if temperature > 0.0 or top_k != 0 or rng is not None:
            raise NotImplementedError(_SAMPLING_TODO)
        self.device = resolve_device(device)
        _check_on_device(self.device, params, global_prior)
        self.model = model
        self.params = params
        self.pool = KVPool(model, max_slots, max_len, device=self.device)
        self.scheduler = Scheduler(max_len)
        self.glass_slots = (
            GlassSlotState(model, params, glass, global_prior, glass_mode, max_slots)
            if glass is not None else None
        )
        self.pending = np.zeros((max_slots,), np.int64)  # next token to feed, per slot
        self.outputs: List[Optional[List[int]]] = [None] * max_slots
        self.live: List[Optional[Request]] = [None] * max_slots
        self.admitted_step = [0] * max_slots
        self.t = 0  # engine step counter == decode ticks
        self.slot_steps = 0  # decode ticks x active slots
        super().__init__(decode_chunk)

    def _horizon(self) -> int:
        """Largest safe decode run: bounded by the first possible eviction
        (the least remaining tokens of an active slot) and, when a free slot
        could take it, the next queued arrival; rounded down to a power of
        two, as the JAX engine buckets its fused decode."""
        active = np.nonzero(self.pool.active)[0]
        h = min(self.live[int(s)].max_new - len(self.outputs[int(s)]) for s in active)
        if self.pool.n_free and len(self.scheduler):
            na = self.scheduler.next_arrival()
            if na is not None:
                h = min(h, na - self.t)
        return self._pow2_horizon(h)

    def step(self) -> List[FinishedRequest]:
        """Admit arrived requests into free slots, then decode the largest
        provably safe run of ticks for every slot.  Returns the requests
        finished in this step."""
        finished: List[FinishedRequest] = []
        reqs = self.scheduler.pop_admissible(self.t, self.pool.n_free)
        if reqs:
            self._admit(reqs, finished)
        if not self.pool.active.any():
            na = self.scheduler.next_arrival()  # idle: fast-forward to the next arrival
            self.t = max(self.t + 1, na if na is not None else self.t + 1)
            return finished
        H = self._horizon()
        kw = self._decode_kwargs()
        lengths = torch.as_tensor(self.pool.lengths, dtype=torch.int64, device=self.device)
        toks = torch.as_tensor(self.pending, device=self.device)
        seq = []
        for _ in range(H):
            lg, _ = self.model.decode_step(self.params, toks[:, None], self.pool.cache, lengths,
                                           **kw)
            toks = torch.argmax(lg[:, -1].float(), dim=-1)
            lengths = lengths + 1
            seq.append(toks)
        seq = torch.stack(seq).cpu().numpy()  # (H, max_slots)
        self.slot_steps += H * self.n_active
        for s in np.nonzero(self.pool.active)[0]:
            s = int(s)
            self.pool.lengths[s] += H
            self.outputs[s].extend(int(x) for x in seq[:, s])
            self.pending[s] = seq[-1, s]
            if len(self.outputs[s]) >= self.live[s].max_new:
                self._finish(s, finished)
        self.t += H
        return finished

    def _drain_budget(self, queued: List[Request], live: List[Request]) -> int:
        return sum(r.max_new for r in queued) + sum(r.max_new for r in live)

    def _admit(self, reqs: List[Request], finished: List[FinishedRequest]) -> None:
        slots, stats_list = [], []
        for r in reqs:
            slot = self.pool.alloc()
            toks = torch.as_tensor(np.asarray(r.prompt), dtype=torch.int64, device=self.device)
            logits, cache, stats = self.model.prefill(self.params, {"tokens": toks[None]},
                                                      len(r.prompt))
            first = int(torch.argmax(logits[0, -1].float()))
            self.pool.write_prefill(slot, cache, len(r.prompt))
            self.pending[slot] = first
            self.outputs[slot] = [first]
            self.live[slot] = r
            self.admitted_step[slot] = self.t
            slots.append(slot)
            stats_list.append(stats)
        if self.glass_slots is not None:
            self.glass_slots.admit(slots, stats_list)
        for slot in slots:  # max_new == 1 completes without a decode tick
            if len(self.outputs[slot]) >= self.live[slot].max_new:
                self._finish(slot, finished)

    def _finish(self, slot: int, finished: List[FinishedRequest]) -> None:
        r = self.live[slot]
        finished.append(FinishedRequest(
            uid=r.uid, prompt=np.asarray(r.prompt, np.int32),
            tokens=np.asarray(self.outputs[slot], np.int32), arrival=r.arrival,
            admitted_step=self.admitted_step[slot], finished_step=self.t,
        ))
        self.pool.free(slot)
        if self.glass_slots is not None:
            self.glass_slots.clear(slot)
        self.live[slot] = None
        self.outputs[slot] = None
        self.pending[slot] = 0


class PagedEngine(_QueueEngineBase):
    """Continuous batching over a paged KV block table (see the module
    docstring).  Submit with :meth:`add_request`, consume
    :class:`RequestOutput` deltas from :meth:`step`, cancel with
    :meth:`abort`; :meth:`run` serves until the queue drains.

    The constructor keeps the JAX engine's signature, plus ``device`` (the
    device the params live on), and its default ``glass_mode="compact"``:
    each slot decodes through its own gathered FFN rows (``GlassSlotState``).
    ``alloc_mode`` defaults to ``"full"``; the JAX default, ``"incremental"``,
    is ROADMAP Queue 1 item 1.  ``decode_chunk``
    bounds the decode ticks of one step, as in the JAX engine.  ``verify_mode``
    stays in the signature only so that a call written for the JAX engine
    runs unchanged (it matters only with ``spec_k > 0``, which raises).
    """

    def __init__(
        self,
        model: Model,
        params,
        *,
        max_slots: int = 8,
        max_len: int = 256,
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        chunk_tokens: int = 32,
        glass: Optional[GlassConfig] = None,
        global_prior=None,
        glass_mode: str = "compact",  # compact | masked | block_sparse
        policy: AdmissionPolicy = AdmissionPolicy.FIFO,
        alloc_mode: str = "full",  # full (incremental: not ported)
        preemption=None,
        spec_k: int = 0,
        temperature: float = 0.0,
        top_k: int = 0,
        rng=None,
        decode_chunk: int = 8,
        sampling: Optional[SamplingParams] = None,
        prefix_cache: bool = False,
        attn_mode: str = "gather",  # gather | paged_pallas (the paged-attention kernel)
        verify_mode: str = "auto",
        device="cuda",
    ):
        _check_glass_args(model, glass, global_prior, glass_mode)
        if attn_mode not in ("gather", "paged_pallas"):
            raise ValueError(f"unknown attn_mode {attn_mode!r}")
        if verify_mode not in ("auto", "sequential", "parallel"):
            raise ValueError(f"unknown verify_mode {verify_mode!r}")
        if chunk_tokens < 1:
            raise ValueError(f"chunk_tokens must be >= 1, got {chunk_tokens}")
        if alloc_mode not in ("incremental", "full"):
            raise ValueError(f"unknown alloc_mode {alloc_mode!r}")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if alloc_mode == "incremental" or preemption is not None:
            raise NotImplementedError(
                "alloc_mode='incremental' and preemption are ROADMAP Queue 1 item 1; "
                "pass alloc_mode='full' (each request's full KV need reserved at admission)"
            )
        if policy is not AdmissionPolicy.FIFO:
            raise NotImplementedError(f"policy={policy}: only FIFO is ported (ROADMAP Queue 1 item 1)")
        if spec_k or (glass is not None and glass.draft_ratio is not None):
            raise NotImplementedError(
                "speculative decode (spec_k > 0, a draft tier) is ROADMAP Queue 1 item 4"
            )
        if prefix_cache:
            raise NotImplementedError("prefix_cache=True is ROADMAP Queue 1 item 5")
        if (temperature > 0.0 or top_k != 0 or rng is not None
                or (sampling is not None and not sampling.is_greedy)):
            raise NotImplementedError(_SAMPLING_TODO)
        self.device = resolve_device(device)
        _check_on_device(self.device, params, global_prior)
        self.model = model
        self.params = params
        self.default_sampling = sampling if sampling is not None else SamplingParams.make_greedy()
        self._auto_uid = itertools.count()
        self._used_uids: set = set()
        self._policies: Dict[int, Tuple[SamplingParams, GlassParams]] = {}
        self.chunk_tokens = chunk_tokens
        super().__init__(decode_chunk)
        self.attn_mode = attn_mode
        self.pool = BlockPool(model.cfg, max_slots, max_len, block_size, num_blocks,
                              device=self.device)
        self.scheduler = Scheduler(max_len)
        self.glass = glass
        self.glass_slots = (
            GlassSlotState(model, params, glass, global_prior, glass_mode, max_slots)
            if glass is not None else None
        )
        self._mode = self.glass_slots.mode if self.glass_slots is not None else None
        self.lc = Lifecycle()
        self.t = 0
        self.slot_steps = 0  # decode ticks x decoding slots
        self.prefill_tokens = 0  # prompt tokens prefilled
        self.grouped_rows = 0  # decode row-ticks served by the shared-list kernel
        # {uid: f32 logits row of its first decode tick} for the requests
        # whose first decode tick ran in the latest step
        self.first_logits: Dict[int, torch.Tensor] = {}

    # -- public API ---------------------------------------------------------

    def add_request(
        self,
        prompt,
        max_new: int,
        *,
        sampling: Optional[SamplingParams] = None,
        glass: Optional[GlassParams] = None,
        uid: Optional[int] = None,
        arrival: Optional[int] = None,
        priority: int = 0,
        deadline: Optional[int] = None,
    ) -> int:
        """Enqueue one request; returns its uid (auto-assigned when not
        given).  Every :meth:`step` returns :class:`RequestOutput` deltas
        for live requests and a final ``finished=True`` output."""
        if uid is None:
            uid = next(self._auto_uid)
            while uid in self._used_uids:
                uid = next(self._auto_uid)
        req = Request(
            uid=uid, prompt=np.asarray(prompt, np.int32), max_new=max_new,
            arrival=self.t if arrival is None else arrival,
            priority=priority, deadline=deadline, sampling=sampling, glass=glass,
        )
        self.submit(req)
        return uid

    def submit(self, req: Request) -> None:
        """Validate and enqueue a :class:`Request` (the JAX engine's legacy
        frontend; :meth:`add_request` builds the request)."""
        need = self.pool.blocks_needed(self._rows_needed(req))
        if need > self.pool.num_blocks - 1:
            raise ValueError(
                f"request {req.uid} needs {need} blocks > pool capacity {self.pool.num_blocks - 1}"
            )
        if req.uid in self.lc.entries or any(q.uid == req.uid for q in self.scheduler.queue):
            raise ValueError(f"request uid {req.uid} is already in flight")
        policy = self._resolve_policy(req)
        self.scheduler.submit(req)
        self._policies[req.uid] = policy
        self._used_uids.add(req.uid)

    def _resolve_policy(self, req: Request) -> Tuple[SamplingParams, GlassParams]:
        sp = req.sampling if req.sampling is not None else self.default_sampling
        if not sp.is_greedy:
            raise NotImplementedError(
                f"request {req.uid}: sampled decoding is ROADMAP Queue 1 item 2"
            )
        gp = (req.glass if req.glass is not None else GlassParams()).resolve(self.glass, 0)
        if gp.spec_k:
            raise NotImplementedError(
                f"request {req.uid}: speculative decode is ROADMAP Queue 1 item 4"
            )
        if req.glass is not None and req.glass.draft_ratio is not None:
            raise NotImplementedError(
                f"request {req.uid}: draft tiers are ROADMAP Queue 1 item 4"
            )
        if self.glass is None:
            if gp.density is not None:
                raise ValueError(
                    f"request {req.uid}: per-request GLASS params need an engine-level "
                    "GlassConfig (the engine serves dense)"
                )
            return sp, gp
        eps = 1e-9
        if gp.density > self.glass.density + eps:
            raise ValueError(
                f"request {req.uid}: density {gp.density} exceeds the engine capacity tier "
                f"{self.glass.density}"
            )
        if gp.density < self.glass.density - eps:
            raise NotImplementedError(
                f"request {req.uid}: a density below the engine's is ROADMAP Queue 1 item 3"
            )
        return sp, gp

    def abort(self, uid: int) -> Optional[RequestOutput]:
        """Cancel a request in any state, releasing its slot, blocks and
        GLASS rows.  Returns the final aborted output, or None if the uid
        is not live."""
        e = self.lc.entries.get(uid)
        if e is None:
            r = self.scheduler.remove(uid)
            if r is None:
                return None
            e = self.lc.add(r)
        elif e.state in (ReqState.PREFILLING, ReqState.RUNNING):
            self._release(e)
        self.lc.to(e, ReqState.FINISHED)
        self._policies.pop(uid, None)
        e.finish_reason = "aborted"
        return self._output(e, finished=True, reason="aborted")

    def _drain_budget(self, queued: List[Request], live: List[Request]) -> int:
        chunks = self.chunk_tokens
        return sum(r.max_new + -(-len(r.prompt) // chunks) for r in queued + live)

    def _inflight_requests(self) -> List[Request]:
        return [e.req for e in self.lc.entries.values()]

    def step(self) -> List[RequestOutput]:
        """One engine tick: admissions, at most one bounded prefill chunk,
        then the horizon's decode ticks over every running request.  Returns
        the tick's outputs: one ``finished=True`` entry per request that
        completed and one delta per live request that grew."""
        out: List[RequestOutput] = []
        self.first_logits = {}
        self._admit_tick()
        prefilled = self._prefill_tick(out)
        self._admit_tick()  # a finished max_new == 1 request frees capacity
        prefill_pending = prefilled or bool(self.lc.in_state(ReqState.PREFILLING))
        if not self._decode_tick(out, prefill_pending):
            if prefilled:
                self.t += 1
            else:
                na = self.scheduler.next_arrival()
                self.t = max(self.t + 1, na if na is not None else self.t + 1)
        for e in self.lc.in_state(ReqState.PREFILLING, ReqState.RUNNING):
            if len(e.outputs) > e.emitted:
                out.append(self._output(e, finished=False))
        return out

    # -- lifecycle transitions ----------------------------------------------

    def _rows_needed(self, r: Request) -> int:
        return len(r.prompt) + r.max_new - 1

    def _output(self, e: LiveRequest, *, finished: bool,
                reason: Optional[str] = None) -> RequestOutput:
        out = RequestOutput(
            uid=e.uid,
            prompt=np.asarray(e.req.prompt, np.int32),
            new_tokens=np.asarray(e.outputs[e.emitted:], np.int32),
            tokens=np.asarray(e.outputs, np.int32),
            finished=finished,
            finish_reason=reason,
            arrival=e.req.arrival,
            admitted_step=e.first_admitted_step,
            finished_step=self.t if finished else -1,
        )
        e.emitted = len(e.outputs)
        return out

    def _release(self, e: LiveRequest) -> None:
        self.pool.free(e.slot)
        if self.glass_slots is not None:
            self.glass_slots.clear(e.slot)
        e.slot = -1
        e.pstats = None

    def _finish(self, e: LiveRequest, out: List[RequestOutput], reason: str) -> None:
        e.finish_reason = reason
        out.append(self._output(e, finished=True, reason=reason))
        self._release(e)
        self.lc.to(e, ReqState.FINISHED)
        self._policies.pop(e.uid, None)

    def _maybe_finish(self, e: LiveRequest, out: List[RequestOutput]) -> None:
        tok = e.outputs[-1]
        if tok in e.sp.stop_set:
            self._finish(e, out, "eos" if tok == e.sp.eos_token_id else "stop")
        elif len(e.outputs) >= e.req.max_new:
            self._finish(e, out, "length")

    def _horizon(self, prefill_pending: bool) -> int:
        """Decode ticks for this step, as the JAX engine fuses them: 1 while
        a prefill chunk is pending (chunks interleave with decode), else the
        largest power of two up to the least remaining budget of the running
        requests, the next arrival that could be admitted (when a slot is
        free), and ``decode_chunk``."""
        if prefill_pending:
            return 1
        h = min(e.req.max_new - len(e.outputs) for e in self.lc.in_state(ReqState.RUNNING))
        if self.pool.n_free_slots and len(self.scheduler):
            na = min((r.arrival for r in self.scheduler.queue
                      if self.pool.fits(self._rows_needed(r))), default=None)
            if na is not None:
                h = min(h, max(1, na - self.t))
        return self._pow2_horizon(h)

    def _admit_tick(self) -> None:
        """WAITING -> PREFILLING in FIFO order while a slot and the
        request's full block need are free."""
        while self.pool.n_free_slots:
            got = self.scheduler.pop_admissible(
                self.t, 1, fits=lambda r: self.pool.fits(self._rows_needed(r))
            )
            if not got:
                return
            r = got[0]
            slot = self.pool.admit(self._rows_needed(r))
            if slot is None:  # ``fits`` held, so this cannot happen; retry later
                self.scheduler.requeue(r)
                return
            e = self.lc.add(r)
            e.sp, e.gp = self._policies[r.uid]
            self.lc.to(e, ReqState.PREFILLING)
            e.slot = slot
            e.admitted_step = e.first_admitted_step = self.t

    def _prefill_tick(self, out: List[RequestOutput]) -> bool:
        """Run ONE bounded chunk for the oldest mid-prefill request; at the
        final chunk build its GLASS rows and take its first token."""
        pre = self.lc.in_state(ReqState.PREFILLING)
        if not pre:
            return False
        e = min(pre, key=lambda e: (e.admitted_step, e.uid))
        r, slot, pos = e.req, e.slot, e.prefill_pos
        # chunks never cross the prompt boundary: the stat sums cover exactly
        # the prompt tokens
        T = min(self.chunk_tokens, len(r.prompt) - pos)
        dev = self.device
        toks = torch.as_tensor(r.prompt[pos : pos + T], dtype=torch.int64, device=dev)[None]
        # gather width covers the prefilled prefix plus this chunk
        nb = pow2_bucket(-(-(pos + T) // self.pool.block_size), self.pool.nb_max)
        btab = torch.as_tensor(self.pool.block_table[slot : slot + 1, :nb], device=dev)
        logits, _, stats = self.model.prefill_chunk(
            self.params, toks, self.pool.cache, torch.tensor([pos], dtype=torch.int32, device=dev),
            block_table=btab, attn_mode=self.attn_mode,
        )
        self.pool.lengths[slot] = pos + T
        e.prefill_pos = pos + T
        e.pstats = merge_stat_sums(e.pstats, stats)
        self.prefill_tokens += T
        if pos + T == len(r.prompt):  # final chunk: finalize GLASS + first token
            if self.glass_slots is not None:
                rows = self.glass_slots.admit([slot], [e.pstats])
                if self._mode == "block_sparse":
                    # group-by key for the shared-list kernel: rows batch
                    # through one list only when list AND scales coincide
                    e.glass_key = (rows["idx"][:, 0].cpu().numpy().tobytes()
                                   + rows["scale"][:, 0].cpu().numpy().tobytes())
            e.pstats = None
            self.lc.to(e, ReqState.RUNNING)
            first = int(torch.argmax(logits[0, -1].float()))
            e.outputs = [first]
            e.pending = first
            self._maybe_finish(e, out)
        return True

    def _ffn_grouping(self, run: List[LiveRequest]):
        """Group decode rows by identical active-block lists (block_sparse
        mode): groups of >= 2 rows batch through the shared-list kernel;
        singletons and inactive rows take the rowwise kernel.  Returns
        (group sizes, row permutation) or ((), None)."""
        if self._mode != "block_sparse":
            return (), None
        groups: Dict[bytes, List[int]] = {}
        for e in sorted(run, key=lambda e: e.slot):
            groups.setdefault(e.glass_key, []).append(e.slot)
        multi = [g for g in groups.values() if len(g) > 1]
        if not multi:
            return (), None
        multi.sort(key=lambda g: (-len(g), g[0]))  # canonical: sizes descending
        in_multi = {s for g in multi for s in g}
        rest = [s for s in range(self.pool.max_slots) if s not in in_multi]
        perm = [s for g in multi for s in g] + rest
        return tuple(len(g) for g in multi), np.asarray(perm, np.int64)

    def _scan_inputs(self, run: List[LiveRequest], H: int):
        """Fixed-width (``max_slots``) batch arrays for H decode ticks:
        per-slot lengths and tokens, and a gather-width-bucketed block table
        covering every participant's rows plus H new ones (non-participants
        point at trash block 0 with length 0)."""
        B = self.pool.max_slots
        decoding = np.zeros((B,), bool)
        lengths = np.zeros((B,), np.int32)
        toks = np.zeros((B,), np.int64)
        for e in run:
            decoding[e.slot] = True
            lengths[e.slot] = self.pool.lengths[e.slot]
            toks[e.slot] = e.pending
        need = int(max(lengths[e.slot] + H for e in run))
        nb = pow2_bucket(-(-need // self.pool.block_size), self.pool.nb_max)
        btab = np.where(decoding[:, None], self.pool.block_table[:, :nb], 0).astype(np.int32)
        return lengths, toks, btab

    def _decode_tick(self, out: List[RequestOutput], prefill_pending: bool) -> bool:
        """The horizon's greedy decode ticks over every RUNNING request, one
        device tick at a time with the batch fixed for the horizon; a request
        that emits a stop token is cut there and finished, with the step's
        starting ``t`` as its ``finished_step``, as in the JAX engine."""
        run = self.lc.in_state(ReqState.RUNNING)
        if not run:
            return False
        dev = self.device
        H = self._horizon(prefill_pending)
        lengths, toks, btab = self._scan_inputs(run, H)
        kw = dict(block_table=torch.as_tensor(btab, device=dev), attn_mode=self.attn_mode,
                  **self._decode_kwargs())
        groups, perm = self._ffn_grouping(run)
        if groups:
            kw.update(ffn_groups=groups, ffn_row_perm=torch.as_tensor(perm, device=dev))
        toks_d, lengths_d = torch.as_tensor(toks, device=dev), torch.as_tensor(lengths, device=dev)
        seq = []
        for i in range(H):
            logits, _ = self.model.decode_step(self.params, toks_d[:, None], self.pool.cache,
                                               lengths_d, **kw)
            lg = logits[:, -1].float()
            toks_d = torch.argmax(lg, dim=-1)
            lengths_d = lengths_d + 1
            seq.append(toks_d)
            if i == 0:  # a request with only its prefill token decodes for the first time
                self.first_logits = {e.uid: lg[e.slot] for e in run if len(e.outputs) == 1}
        seq = torch.stack(seq).cpu().numpy()  # (H, max_slots)
        self.slot_steps += H * len(run)
        self.grouped_rows += H * sum(groups)
        for e in run:
            self.pool.lengths[e.slot] += H
            new = [int(x) for x in seq[:, e.slot]]
            hit = next((j for j, tok in enumerate(new) if tok in e.sp.stop_set), None)
            e.outputs.extend(new if hit is None else new[: hit + 1])
            e.pending = new[-1]
            self._maybe_finish(e, out)
        self.t += H
        return True


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
