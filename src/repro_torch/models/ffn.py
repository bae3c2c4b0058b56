"""Gated FFN block with the GLASS hooks the serving path uses.

    h = phi(x @ w_gate) * (x @ w_up)        (gated)
    h = phi(x @ w_up)                        (non-gated)
    y = h @ w_down

  * ``mask``  — multiplier applied to h (neuron-level masking);
  * ``stats`` — running sum of |h|/||h||_2 over tokens (the local signal).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .common import ModelConfig, activation

STATS_EPS = 1e-6


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


def token_normalized_abs(h: torch.Tensor) -> torch.Tensor:
    """|h|/(||h||_2 + eps) per token, f32. h (..., m) -> same shape f32."""
    h32 = h.float()
    nrm = torch.sqrt(torch.sum(torch.square(h32), dim=-1, keepdim=True))
    return torch.abs(h32) / (nrm + STATS_EPS)


def ffn_forward_with_stats(p: dict, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """Forward pass that also emits GLASS local-importance sums:
    {"sum_abs": (m,) f32 sum over tokens of |h|/||h||_2, "count": () f32}.
    (The JAX package's ``token_mask`` for padded batches has no caller on
    the paged path.)"""
    h = ffn_hidden(p, x, cfg)
    a = token_normalized_abs(h)
    count = torch.tensor(float(h.numel() // h.shape[-1]), dtype=torch.float32, device=h.device)
    sum_abs = torch.sum(a.reshape(-1, a.shape[-1]), dim=0)
    y = h @ p["w_down"]
    return y, {"sum_abs": sum_abs, "count": count}
