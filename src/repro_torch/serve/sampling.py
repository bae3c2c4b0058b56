"""Request-scoped sampling policy.

The port serves greedy requests (with eos / stop sets); a request that
samples (a temperature with a seed) is refused by the engine: positional
sampling (``repro/serve/sampling.py:sample_positional``) is ROADMAP Queue 1
item 2.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

# per-request stop-set capacity: eos_token_id plus up to MAX_STOP_IDS - 1
# extra stop ids
MAX_STOP_IDS = 4


@dataclass(frozen=True)
class SamplingParams:
    """``seed=None`` (or ``greedy=True``, or ``temperature <= 0``) selects
    greedy argmax decoding.  ``eos_token_id`` / ``stop_token_ids`` finish
    the request early (``finish_reason`` "eos" / "stop"); the matched token
    is included in the output.  At most :data:`MAX_STOP_IDS` ids in total."""

    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    seed: Optional[int] = None  # None = greedy
    greedy: bool = False
    eos_token_id: Optional[int] = None
    stop_token_ids: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if not (0.0 <= self.min_p <= 1.0):
            raise ValueError(f"min_p must be in [0, 1], got {self.min_p}")
        object.__setattr__(self, "stop_token_ids", tuple(self.stop_token_ids))
        if len(self.stop_set) > MAX_STOP_IDS:
            raise ValueError(
                f"at most {MAX_STOP_IDS} stop ids (eos included), got {self.stop_set}"
            )

    @property
    def is_greedy(self) -> bool:
        return self.greedy or self.seed is None or self.temperature <= 0.0

    @property
    def stop_set(self) -> Tuple[int, ...]:
        """All token ids that finish the request early (eos first)."""
        eos = () if self.eos_token_id is None else (self.eos_token_id,)
        return eos + tuple(t for t in self.stop_token_ids if t != self.eos_token_id)

    @classmethod
    def make_greedy(cls, *, eos_token_id: Optional[int] = None,
                    stop_token_ids: Tuple[int, ...] = ()) -> "SamplingParams":
        return cls(temperature=0.0, greedy=True, eos_token_id=eos_token_id,
                   stop_token_ids=stop_token_ids)
