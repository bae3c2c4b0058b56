"""Request queue and FIFO admission for the queue-driven engines.

Host-side and tiny: it tracks arrival times (in engine ticks), validates
feasibility against the KV capacity at submit, and hands out arrived
requests in submission order as capacity frees up, best-effort under a
capacity filter (a request that does not fit now is retried later).
The PRIORITY and DEADLINE policies of ``repro/serve/scheduler.py`` are
ROADMAP Queue 1 item 1.
"""
from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Deque, List, Optional

import numpy as np

from ..core.glass import GlassParams
from .sampling import SamplingParams


class AdmissionPolicy(str, Enum):
    FIFO = "fifo"
    PRIORITY = "priority"
    DEADLINE = "deadline"


@dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (S,) int32 token ids
    max_new: int  # tokens to generate (incl. the first post-prefill token)
    arrival: int = 0  # engine step at which the request becomes visible
    priority: int = 0  # larger = more urgent (PRIORITY policy only)
    deadline: Optional[int] = None  # absolute engine step (DEADLINE policy only)
    sampling: Optional[SamplingParams] = None  # None = engine default
    glass: Optional[GlassParams] = None  # None = engine GlassConfig


@dataclass
class FinishedRequest:
    """A finished request of ``ContinuousEngine`` (the whole stream at once)."""

    uid: int
    prompt: np.ndarray
    tokens: np.ndarray  # (max_new,) generated ids
    arrival: int
    admitted_step: int
    finished_step: int


@dataclass
class RequestOutput:
    """One request's streaming update from ``PagedEngine.step()``: the
    delta since the previous step (``new_tokens``) and the cumulative
    stream; the final update has ``finished=True`` and a ``finish_reason``."""

    uid: int
    prompt: np.ndarray
    new_tokens: np.ndarray  # (delta,) ids emitted since the previous step()
    tokens: np.ndarray  # (n,) cumulative generated ids
    finished: bool
    finish_reason: Optional[str]  # length | stop | eos | aborted (None while live)
    arrival: int
    admitted_step: int
    finished_step: int  # -1 until finished


@dataclass
class Scheduler:
    """FIFO queue with a KV-feasibility check at submit time.  A request
    needs ``len(prompt) + max_new - 1`` cache rows (the last sampled token
    is never written back)."""

    max_len: int
    queue: Deque[Request] = field(default_factory=deque)
    _seq: "itertools.count" = field(default_factory=itertools.count, repr=False)

    def submit(self, req: Request) -> None:
        need = len(req.prompt) + req.max_new - 1
        if req.max_new < 1:
            raise ValueError(f"request {req.uid}: max_new must be >= 1")
        if need > self.max_len:
            raise ValueError(
                f"request {req.uid} needs {need} cache rows > max_len={self.max_len}"
            )
        req._submit_seq = next(self._seq)  # admission order: submission order
        self.queue.append(req)

    def requeue(self, req: Request) -> None:
        """Put a request that could not be admitted back, keeping its place
        in submission order."""
        if not hasattr(req, "_submit_seq"):
            raise ValueError("requeue() is for previously submitted requests")
        self.queue.append(req)

    def remove(self, uid: int) -> Optional[Request]:
        """Drop a queued request by uid (abort).  Index-based: the dataclass
        ``__eq__`` compares ndarray prompts."""
        for i, r in enumerate(self.queue):
            if r.uid == uid:
                del self.queue[i]
                return r
        return None

    def __len__(self) -> int:
        return len(self.queue)

    def next_arrival(self) -> Optional[int]:
        return min((r.arrival for r in self.queue), default=None)

    def pop_admissible(
        self, now: int, k: int, fits: Optional[Callable[[Request], bool]] = None,
    ) -> List[Request]:
        """Up to ``k`` arrived requests in submission order.  Requests not
        yet arrived, or that do not ``fit`` now, stay queued; ``fits`` is
        re-evaluated after every pick."""
        out: List[Request] = []
        while len(out) < k:
            best_i = -1
            for i, r in enumerate(self.queue):
                if r.arrival > now or (fits is not None and not fits(r)):
                    continue
                if best_i < 0 or r._submit_seq < self.queue[best_i]._submit_seq:
                    best_i = i
            if best_i < 0:
                break
            out.append(self.queue[best_i])
            del self.queue[best_i]
        return out
