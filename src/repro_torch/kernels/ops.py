"""Public entry points for the port's kernels.

A tensor on the CPU goes to the kernel's plain version; a tensor on a CUDA
device goes to the hand-written kernel, with no fallback: a kernel that
does not build or launch raises.  Any other device raises.

Each kernel wrapper counts its launches in a plain int attribute
(``<wrapper>.launches``); :func:`launch_counts` reads them all and
:func:`reset_launch_counts` sets them to 0.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .flash_attention import flash_attention_cuda
from .glass_ffn import glass_ffn_cuda, glass_ffn_rowwise_cuda
from .local_stats import local_stats_cuda
from .paged_attention import paged_attention_cuda
from .ref import (
    flash_attention_ref,
    glass_ffn_ref,
    glass_ffn_rowwise_ref,
    local_stats_ref,
    paged_attention_ref,
)

_WRAPPERS = {
    "paged_attention": paged_attention_cuda,
    "glass_ffn": glass_ffn_cuda,
    "glass_ffn_rowwise": glass_ffn_rowwise_cuda,
    "flash_attention": flash_attention_cuda,
    "local_stats": local_stats_cuda,
}


def on_card(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"kernels run on CUDA tensors (plain versions on CPU ones), got {t.device}")


def paged_attention(
    q, cache_k, cache_v, block_table, cache_len, window: int, *,
    softcap: Optional[float] = None, scale: Optional[float] = None,
) -> torch.Tensor:
    """Fused paged attention: block-table gather + online-softmax attention,
    with no gathered KV copy; the caller scatters the new k/v rows first.
    ``window`` is an int (2**30 for global layers)."""
    fn = paged_attention_cuda if on_card(q) else paged_attention_ref
    return fn(q, cache_k, cache_v, block_table, cache_len, window, softcap=softcap, scale=scale)


def glass_ffn(
    x, w_up, w_down, block_idx, w_gate=None, *, block_scale=None, act="silu", block_size=128,
) -> torch.Tensor:
    """Block-sparse GLASS FFN over one shared block list: only the active
    weight tiles are read.  Returns (B, d) f32."""
    fn = glass_ffn_cuda if on_card(x) else glass_ffn_ref
    return fn(x, w_up, w_down, block_idx, w_gate, block_scale=block_scale, act=act,
              block_size=block_size)


def glass_ffn_rowwise(
    x, w_up, w_down, block_idx, w_gate=None, *, block_scale=None, act="silu", block_size=128,
) -> torch.Tensor:
    """Per-row block-sparse GLASS FFN: block_idx (B, nb_keep), one list per
    serving slot.  Returns (B, d) f32."""
    fn = glass_ffn_rowwise_cuda if on_card(x) else glass_ffn_rowwise_ref
    return fn(x, w_up, w_down, block_idx, w_gate, block_scale=block_scale, act=act,
              block_size=block_size)


def flash_attention(
    q, k, v, *, causal: bool = True, window: Optional[int] = None,
    softcap: Optional[float] = None, scale: Optional[float] = None,
) -> torch.Tensor:
    """Full-sequence attention with ends aligned: q (B, H, Sq, hd), k and v
    (B, K, Skv, hd) with H % K == 0.  Returns (B, H, Sq, hd)."""
    fn = flash_attention_cuda if on_card(q) else flash_attention_ref
    return fn(q, k, v, causal=causal, window=window, softcap=softcap, scale=scale)


def local_stats(h, row_mask=None) -> torch.Tensor:
    """GLASS local-importance sum over rows of |h_t| / ||h_t||_2, each row
    times ``row_mask`` when given: h (T, m) -> (m,) f32."""
    fn = local_stats_cuda if on_card(h) else local_stats_ref
    return fn(h, row_mask)


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
