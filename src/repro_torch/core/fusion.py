"""Rank aggregation and critical-neuron selection (the heart of GLASS).

  * ``ranks_ascending`` — rank 1 = least important ... rank m = most, ties
    broken by unit index (stable argsort);
  * ``glass_scores``    — GLASS_j = (1-lambda) R^l_j + lambda R^g_j;
  * selection modes ``neuron`` (exact top-k) and ``block`` (scores averaged
    over blocks of ``block_size`` units, top blocks kept).

Every sort that JAX does stably is ``torch.argsort(stable=True)`` here, so
both packages select the same indices from the same scores.  Selections
return sorted index arrays plus a binary mask.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class GlassConfig:
    density: float = 0.5  # fraction of FFN units kept
    lam: float = 0.5  # lambda: weight of the global rank
    variant: str = "I"  # "A" (activation) | "I" (impact) global prior
    selection: str = "neuron"  # neuron | block | shard_balanced
    block_size: int = 128
    n_shards: int = 1
    draft_ratio: Optional[float] = None  # draft tier for self-speculative decode

    def __post_init__(self):
        if self.draft_ratio is not None and not (0.0 < self.draft_ratio <= 1.0):
            raise ValueError(f"draft_ratio must be in (0, 1], got {self.draft_ratio}")

    def k_of(self, m: int) -> int:
        return max(1, int(round(self.density * m)))


def ranks_ascending(scores: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """rank_up: smallest value -> rank 1, ..., largest -> rank m (f32)."""
    order = torch.argsort(scores, dim=dim, stable=True)
    inv = torch.argsort(order, dim=dim, stable=True)  # position of j in order
    return (inv + 1).float()


def glass_scores(local: torch.Tensor, global_: torch.Tensor, lam: float) -> torch.Tensor:
    """Fused consensus score per unit; larger = more important.  Both
    signals go through rank space first (monotone-invariant)."""
    rl = ranks_ascending(local)
    rg = ranks_ascending(global_)
    return (1.0 - lam) * rl + lam * rg


def merge_stat_sums(a, b):
    """Additive merge of two running stat-sum dicts ({"sum_abs", "count"});
    ``None`` is the empty element (no chunks yet)."""
    if a is None:
        return b
    if b is None:
        return a
    return {k: a[k] + b[k] for k in a}


def select_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k with stable index tie-breaking.  scores (..., m) ->
    (idx (..., k) int32 sorted ascending, mask (..., m) f32)."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    idx = torch.sort(order[..., :k], dim=-1).values
    mask = torch.zeros_like(scores, dtype=torch.float32).scatter_(-1, idx, 1.0)
    return idx.to(torch.int32), mask


def block_aggregate(scores: torch.Tensor, block_size: int) -> torch.Tensor:
    """Mean score per block of ``block_size`` consecutive units."""
    m = scores.shape[-1]
    if m % block_size:
        raise ValueError(f"width {m} is not a multiple of block_size {block_size}")
    return scores.reshape(*scores.shape[:-1], m // block_size, block_size).mean(dim=-1)


def select_blocks(scores: torch.Tensor, k: int, block_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the ceil(k / block_size) highest-mean-score blocks.  Returns
    (block_idx (..., nb_keep) int32 sorted, mask (..., m) f32)."""
    bsc = block_aggregate(scores, block_size)
    nb_keep = max(1, (k + block_size - 1) // block_size)
    bidx, bmask = select_topk(bsc, nb_keep)
    return bidx, torch.repeat_interleave(bmask, block_size, dim=-1)


def select(scores: torch.Tensor, gcfg: GlassConfig, m: Optional[int] = None):
    """Dispatch on gcfg.selection. scores (..., m) -> (idx, mask)."""
    m = m if m is not None else scores.shape[-1]
    k = gcfg.k_of(m)
    if gcfg.selection == "neuron":
        return select_topk(scores, k)
    if gcfg.selection == "block":
        return select_blocks(scores, k, gcfg.block_size)
    raise NotImplementedError(
        f"selection={gcfg.selection!r}: shard-balanced selection is ROADMAP Queue 1 item 11"
    )
