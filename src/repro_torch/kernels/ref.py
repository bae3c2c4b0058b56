"""Plain PyTorch versions of the port's kernels.

They compute what the CUDA kernels compute, with the same rounding points
(f32 scores and accumulators; attention probabilities rounded to V's
dtype before the PV product; the GLASS hidden vector rounded to the
weight dtype before the down projection; stat sums in f32).  ``kernels/ops.py`` sends CPU
tensors here; on the card only ``chip_smoke.py`` calls them, to hold the
kernels against them.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models.common import activation

NEG = -2.0e38
STATS_EPS = 1e-6


def paged_attention_ref(
    q: torch.Tensor,  # (B, T, K, G, hd) post-RoPE grouped queries
    cache_k: torch.Tensor,  # (num_blocks, bs, K, hd)
    cache_v: torch.Tensor,
    block_table: torch.Tensor,  # (B, nb) int32
    cache_len: torch.Tensor,  # (B,) int32 rows live before the T new ones
    window: int,  # sliding window; 2**30 = global
    *,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attend T queries per row to the row's paged KV.  Query t sits at
    ``cache_len + t``; causal + window mask; masked entries add exactly 0.

    The gather covers only the blocks some row's frontier reaches, so the
    result is bitwise independent of the ``nb`` bucket the table is padded
    to (the kernel skips dead blocks for the same reason)."""
    B, T, K, G, hd = q.shape
    bs = cache_k.shape[1]
    scale = scale if scale is not None else hd**-0.5
    live = int((cache_len.max().item() + T + bs - 1) // bs)
    tab = block_table[:, : min(live, block_table.shape[1])].long()
    n = tab.shape[1] * bs
    kg = cache_k[tab].reshape(B, n, K, hd).float()
    vg = cache_v[tab].reshape(B, n, K, hd)
    qpos = cache_len.long()[:, None] + torch.arange(T, device=q.device)[None]  # (B, T)
    kpos = torch.arange(n, device=q.device)
    diff = qpos[:, :, None] - kpos  # (B, T, n)
    mask = ((diff >= 0) & (diff < window))[:, :, None, None, :]  # (B, T, 1, 1, n)
    s = torch.einsum("btkgd,bnkd->btkgn", q.float(), kg) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(mask, s, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    acc = torch.einsum("btkgn,bnkd->btkgd", p.to(vg.dtype).float(), vg.float())
    return (acc / l).to(q.dtype)


def _tile_cols(block_idx: torch.Tensor, block_size: int) -> torch.Tensor:
    offs = torch.arange(block_size, device=block_idx.device)
    return (block_idx.long()[:, None] * block_size + offs).reshape(-1)


def glass_ffn_ref(
    x: torch.Tensor,  # (B, d)
    w_up: torch.Tensor,  # (d, m)
    w_down: torch.Tensor,  # (m, d)
    block_idx: torch.Tensor,  # (nb_keep,) int32 active block ids
    w_gate: Optional[torch.Tensor] = None,  # (d, m)
    *,
    block_scale: Optional[torch.Tensor] = None,  # (nb_keep,) f32
    act: str = "silu",
    block_size: int = 128,
) -> torch.Tensor:
    """y = sum over the listed blocks, in list order, of
    ``scale * (act(x Wg[:, blk]) * (x Wu[:, blk])) Wd[blk, :]`` — h rounded
    to Wd's dtype before the down product.  Returns (B, d) f32."""
    nbk = block_idx.shape[0]
    cols = _tile_cols(block_idx, block_size)
    x32 = x.float()
    up = x32 @ w_up[:, cols].float()
    if w_gate is not None:
        h = activation(act)(x32 @ w_gate[:, cols].float()) * up
    else:
        h = activation(act)(up)
    h = h.to(w_down.dtype).float().reshape(x.shape[0], nbk, block_size)
    wd = w_down[cols].float().reshape(nbk, block_size, -1)
    y = torch.zeros(x.shape[0], w_down.shape[1], dtype=torch.float32, device=x.device)
    for i in range(nbk):  # list order, as the kernel adds the tiles
        contrib = h[:, i] @ wd[i]
        y = y + (contrib if block_scale is None else block_scale[i].float() * contrib)
    return y


def glass_ffn_rowwise_ref(
    x: torch.Tensor,  # (B, d)
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    block_idx: torch.Tensor,  # (B, nb_keep) per-row active block ids
    w_gate: Optional[torch.Tensor] = None,
    *,
    block_scale: Optional[torch.Tensor] = None,  # (B, nb_keep) f32
    act: str = "silu",
    block_size: int = 128,
) -> torch.Tensor:
    """:func:`glass_ffn_ref` with each row's own block list and scales."""
    rows = [
        glass_ffn_ref(
            x[b : b + 1], w_up, w_down, block_idx[b], w_gate,
            block_scale=None if block_scale is None else block_scale[b],
            act=act, block_size=block_size,
        )
        for b in range(x.shape[0])
    ]
    return torch.cat(rows, dim=0)


def flash_attention_ref(
    q: torch.Tensor,  # (B, H, Sq, hd)
    k: torch.Tensor,  # (B, K, Skv, hd), H % K == 0: query head h reads kv head h // (H // K)
    v: torch.Tensor,  # (B, K, Skv, hd)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Full-sequence attention with the ends aligned: query i sits at
    position ``i + Skv - Sq``.  Causal and window masks, optional tanh
    softcap before the mask, softmax in f32, normalized probabilities
    rounded to V's dtype before the PV product.  Returns (B, H, Sq, hd) in
    q's dtype.  With K == H this is ``repro/kernels/ref.py:flash_attention_ref``."""
    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    if H % K or Sq > Skv:
        raise ValueError(f"need H % K == 0 and Sq <= Skv, got H={H}, K={K}, Sq={Sq}, Skv={Skv}")
    scale = scale if scale is not None else hd**-0.5
    qg = q.reshape(B, K, H // K, Sq, hd)
    s = torch.einsum("bkgqd,bktd->bkgqt", qg.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    p = torch.softmax(torch.where(mask, s, NEG), dim=-1)
    out = torch.einsum("bkgqt,bktd->bkgqd", p.to(v.dtype).float(), v.float())
    return out.reshape(B, H, Sq, hd).to(q.dtype)


def local_stats_ref(h: torch.Tensor, row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum over rows of |h_t| / (||h_t||_2 + 1e-6), each row times its
    ``row_mask`` entry when one is given: (T, m) -> (m,) f32."""
    h32 = h.float()
    nrm = torch.sqrt(torch.sum(torch.square(h32), dim=-1, keepdim=True))
    a = torch.abs(h32) / (nrm + STATS_EPS)
    if row_mask is not None:
        a = a * row_mask.float()[:, None]
    return torch.sum(a, dim=0)
