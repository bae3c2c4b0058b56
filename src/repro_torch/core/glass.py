"""GLASS mask building: fuse prefill-local stats with the global prior.

The global prior is an input here; computing it (NPS, ``repro/core/nps.py``)
is ROADMAP Queue 1 item 7.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..models.ffn import compact_ffn_params
from . import importance
from .fusion import GlassConfig, glass_scores, select


@dataclass(frozen=True)
class GlassParams:
    """Request-scoped GLASS policy; every field None = inherit the engine's
    :class:`GlassConfig` (the capacity tier)."""

    density: Optional[float] = None
    draft_ratio: Optional[float] = None
    spec_k: Optional[int] = None

    def __post_init__(self):
        if self.density is not None and not (0.0 < self.density <= 1.0):
            raise ValueError(f"density must be in (0, 1], got {self.density}")
        if self.draft_ratio is not None and not (0.0 < self.draft_ratio <= 1.0):
            raise ValueError(f"draft_ratio must be in (0, 1], got {self.draft_ratio}")
        if self.spec_k is not None and self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {self.spec_k}")

    def resolve(self, gcfg: Optional[GlassConfig], spec_k_default: int) -> "GlassParams":
        """Fill None fields from the engine's config."""
        return GlassParams(
            density=self.density if self.density is not None
            else (gcfg.density if gcfg is not None else None),
            draft_ratio=self.draft_ratio if self.draft_ratio is not None
            else (gcfg.draft_ratio if gcfg is not None else None),
            spec_k=self.spec_k if self.spec_k is not None else spec_k_default,
        )


@dataclass(frozen=True)
class MaskSet:
    # ``selection="block"`` yields BLOCK ids in ``idx`` (for the block-sparse
    # kernels); ``neuron`` yields unit indices.
    idx: torch.Tensor  # (L, k) int32; block selection: (L, nb_keep) block ids
    mask: torch.Tensor  # (L, m) f32
    scores: torch.Tensor  # fused consensus scores, same shape as mask


def build_masks(
    local_stats: Dict[str, torch.Tensor],
    global_prior: torch.Tensor,  # (L, m)
    gcfg: GlassConfig,
    *,
    slot_axis: bool = False,
) -> MaskSet:
    """Fuse prefill-local and global importance into the decode mask set.

    ``slot_axis=True``: local_stats leaves are stacked over a leading
    request axis (sum_abs (R, L, m), count (R, L)); the prior stays shared
    and the result has the slot axis second — idx (L, R, k), mask (L, R, m).
    Every request ranks independently, exactly as one call per request."""
    local = importance.finalize(local_stats)
    scores = glass_scores(local, global_prior.expand_as(local), gcfg.lam)
    idx, mask = select(scores, gcfg)
    if slot_axis:
        idx, mask, scores = (t.transpose(0, 1).contiguous() for t in (idx, mask, scores))
    return MaskSet(idx=idx, mask=mask, scores=scores)


def compact_params(model, params, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One-time gather of the selected units into compact decode weights:
    the ``compact_layers`` tree that ``model.decode_step`` takes.  idx
    (L, k) shared gives w_up (L, d, k), w_down (L, k, d) [, w_gate]; a
    per-slot idx (L, B, k) from ``build_masks(..., slot_axis=True)`` gives
    the same leaves with the slot axis after L.  Dense family only."""
    cfg = model.cfg
    if cfg.family != "dense" or cfg.sandwich_norms:
        raise NotImplementedError(
            f"family={cfg.family!r}: compact weights cover the dense family only "
            "(ROADMAP Queue 1 item 8)"
        )
    if idx.ndim not in (2, 3):
        raise ValueError(f"idx must be (L, k) or (L, B, k), got {tuple(idx.shape)}")
    ffn = params["layers"]["ffn"]
    out = None
    for pos in np.ndindex(*idx.shape[:-1]):  # (l,) or (l, slot), gathered one at a time
        rows = compact_ffn_params({n: w[pos[0]] for n, w in ffn.items()}, idx[pos])
        if out is None:  # preallocated: no stacked copy of the compact weights
            out = {n: torch.empty(tuple(idx.shape[:-1]) + tuple(t.shape), dtype=t.dtype,
                                  device=t.device) for n, t in rows.items()}
        for n, t in rows.items():
            out[n][pos] = t
    return out
