"""Gated FFN block with the GLASS hooks the serving path uses.

    h = phi(x @ w_gate) * (x @ w_up)        (gated)
    h = phi(x @ w_up)                        (non-gated)
    y = h @ w_down

  * ``mask``  — multiplier applied to h (neuron-level masking);
  * ``stats`` — running sum of |h|/||h||_2 over tokens (the local signal);
  * ``compact_ffn_params`` — the selected units gathered into narrow weights.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels import ops
from .common import ModelConfig, activation


def ffn_hidden(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Hidden unit vector h (..., m)."""
    act = activation(cfg.ffn_act)
    if "w_gate" in p:
        return act(x @ p["w_gate"]) * (x @ p["w_up"])
    return act(x @ p["w_up"])


def ffn_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    h = ffn_hidden(p, x, cfg)
    if mask is not None:
        h = h * mask.to(h.dtype)
    return h @ p["w_down"]


def ffn_forward_with_stats(
    p: dict, x: torch.Tensor, cfg: ModelConfig, *, token_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, dict]:
    """Forward pass that also emits GLASS local-importance sums:
    {"sum_abs": (m,) f32 sum over tokens of |h|/||h||_2, "count": () f32}.
    ``token_mask`` (the leading axes of x; 1.0 valid, 0.0 pad) restricts
    both to the valid tokens.  The sums go through the local-stats kernel
    (``kernels/ops.py``) on a CUDA device."""
    h = ffn_hidden(p, x, cfg)
    m = h.shape[-1]
    row_mask = None
    if token_mask is not None:
        row_mask = token_mask.float().reshape(-1)
        count = torch.sum(row_mask)
    else:
        count = torch.tensor(float(h.numel() // m), dtype=torch.float32, device=h.device)
    sum_abs = ops.local_stats(h.reshape(-1, m), row_mask)
    y = h @ p["w_down"]
    return y, {"sum_abs": sum_abs, "count": count}


def compact_ffn_params(p: dict, idx: torch.Tensor) -> dict:
    """Gather the k selected hidden units into compact weights: idx (k,)
    int, the columns of w_up/w_gate and the rows of w_down.  Decode then
    runs dense matmuls of width k."""
    idx = idx.long()
    out = {"w_up": p["w_up"][:, idx], "w_down": p["w_down"][idx]}
    if "w_gate" in p:
        out["w_gate"] = p["w_gate"][:, idx]
    return out
