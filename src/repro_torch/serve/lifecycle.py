"""Per-request lifecycle state machine for the paged engine.

    WAITING ──▶ PREFILLING ──▶ RUNNING ──▶ FINISHED

A request reaches FINISHED by length, by an eos/stop token, or by
``engine.abort`` from any state.  Every resource transition (slot binding,
block allocation, GLASS slot rows) happens at a state transition, and
:class:`Lifecycle` refuses illegal ones.  Preemption (the PREEMPTED_*
states), speculative decode (SPECULATING) and migration (MIGRATING) of
``repro/serve/lifecycle.py`` are ROADMAP Queue 1 items 1, 4 and 11.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional

from .scheduler import Request


class ReqState(str, Enum):
    WAITING = "waiting"
    PREFILLING = "prefilling"
    RUNNING = "running"
    FINISHED = "finished"


_LEGAL = {
    ReqState.WAITING: {ReqState.PREFILLING, ReqState.FINISHED},
    ReqState.PREFILLING: {ReqState.RUNNING, ReqState.FINISHED},
    ReqState.RUNNING: {ReqState.FINISHED},
    ReqState.FINISHED: set(),
}


@dataclass(eq=False)
class LiveRequest:
    """One request's lifecycle entry (host-side; device state lives in the
    pool and the GLASS arena).  ``eq=False``: entries are identity objects."""

    req: Request
    state: ReqState = ReqState.WAITING
    slot: int = -1  # pool slot while PREFILLING / RUNNING, else -1
    prefill_pos: int = 0  # prompt tokens already prefilled
    outputs: List[int] = field(default_factory=list)  # generated token ids
    pending: int = 0  # next token to feed into decode
    pstats: Any = None  # running-sum GLASS stats while PREFILLING
    glass_key: Optional[bytes] = None  # host active-block-list key (block_sparse)
    admitted_step: int = -1
    first_admitted_step: int = -1
    sp: Any = None  # resolved SamplingParams
    gp: Any = None  # resolved GlassParams
    finish_reason: Optional[str] = None  # length | stop | eos | aborted
    emitted: int = 0  # tokens already reported through step()

    @property
    def uid(self) -> int:
        return self.req.uid


class Lifecycle:
    """Registry of live entries + the legal-transition checker."""

    def __init__(self):
        self.entries: Dict[int, LiveRequest] = {}

    def add(self, req: Request) -> LiveRequest:
        if req.uid in self.entries:
            raise ValueError(f"request {req.uid} is already live")
        e = LiveRequest(req=req)
        self.entries[req.uid] = e
        return e

    def to(self, e: LiveRequest, new: ReqState) -> None:
        if new not in _LEGAL[e.state]:
            raise ValueError(f"illegal transition {e.state.value} -> {new.value} (uid={e.uid})")
        e.state = new
        if new is ReqState.FINISHED and self.entries.get(e.uid) is e:
            del self.entries[e.uid]  # stay O(in-flight), not O(served)

    def in_state(self, *states: ReqState) -> List[LiveRequest]:
        return [e for e in self.entries.values() if e.state in states]
