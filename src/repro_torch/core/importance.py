"""Neuron-importance statistics: running sums (sum_abs, count) merged
across chunks, and ``finalize`` to the expectation used for ranking."""
from __future__ import annotations

from typing import Dict, Optional

import torch


def finalize(stats: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(sum_abs, count) -> mean importance.  sum_abs (..., m), count (...)."""
    sum_abs, count = stats["sum_abs"], stats["count"]
    while count.ndim < sum_abs.ndim:
        count = count[..., None]
    return sum_abs / torch.clamp_min(count, 1.0)


def merge(a: Optional[Dict], b: Dict) -> Dict:
    if a is None:
        return b
    return {k: a[k] + b[k] for k in a}
