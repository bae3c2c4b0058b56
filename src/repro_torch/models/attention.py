"""Grouped-query attention with RoPE and a paged KV cache.

Conventions (as in ``repro/models/attention.py``):
  x            (B, S, d_model)
  q            (B, S, K, G, hd)   K = kv heads, G = q_per_kv
  k, v         (B, S, K, hd)
  paged cache  (num_blocks, block_size, K, hd) per layer, read through a
               block table (B, nb)
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import ops
from .common import ModelConfig
from .rope import apply_rope, rope_angles

NEG_INF = -2.0e38
GLOBAL_WINDOW = 2**30


def project_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig):
    B, S, _ = x.shape
    K, G, hd = cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim
    if cfg.gqa_layout == "repeated":
        q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, hd)
    else:
        q = (x @ p["wq"]).reshape(B, S, K, G, hd)
    k = (x @ p["wk"]).reshape(B, S, K, hd)
    v = (x @ p["wv"]).reshape(B, S, K, hd)
    return q, k, v


def rope_qk(q, k, cfg: ModelConfig, positions: torch.Tensor):
    """positions (B, S); standard rope only (m-rope is not ported yet)."""
    if cfg.rope_type == "none":
        return q, k
    if cfg.rope_type != "standard":
        raise NotImplementedError(
            f"rope_type={cfg.rope_type!r}: m-rope is ROADMAP Queue 1 item 8 (other families)"
        )
    ang = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    if q.ndim == 4:  # repeated layout: (B,S,H,hd)
        q = apply_rope(q, ang)
    else:  # grouped layout: fold (K, G) -> heads for rotation, then back
        B, S, K, G, hd = q.shape
        q = apply_rope(q.reshape(B, S, K * G, hd), ang).reshape(B, S, K, G, hd)
    k = apply_rope(k, ang)
    return q, k


def _attend_gathered(q, kg, vg, cfg: ModelConfig, mask) -> torch.Tensor:
    """Dense masked softmax attention over gathered KV.  q (B,T,K,G,hd),
    kg/vg (B,N,K,hd), mask (B,T,N) bool.  Scores in f32, probabilities cast
    to V's dtype before the PV product.  Returns (B, T, attn_dim)."""
    scale = cfg.head_dim ** -0.5
    s = torch.einsum("btkgd,bnkd->bkgtn", q.float(), kg.float()) * scale
    if cfg.attn_softcap is not None:
        s = cfg.attn_softcap * torch.tanh(s / cfg.attn_softcap)
    s = torch.where(mask[:, None, None], s, NEG_INF)
    probs = torch.softmax(s, dim=-1).to(vg.dtype)
    out = torch.einsum("bkgtn,bnkd->btkgd", probs, vg)
    B, T = out.shape[0], out.shape[1]
    return out.reshape(B, T, cfg.attn_dim)


def attention_decode_paged(
    p: dict,
    x: torch.Tensor,  # (B, T, d): T = 1 decode tick, T > 1 prefill chunk
    cfg: ModelConfig,
    *,
    cache_k: torch.Tensor,  # (num_blocks, block_size, K, hd) shared block pool
    cache_v: torch.Tensor,
    block_table: torch.Tensor,  # (B, nb) int32 block ids in logical order
    cache_len: torch.Tensor,  # (B,) int32 tokens already in each row's blocks
    window: Optional[int] = None,
    attn_mode: str = "gather",
):
    """Decode/chunk-prefill attention through a paged KV block table.

    The T new tokens' k/v are written IN PLACE into each row's blocks at
    logical positions ``cache_len + t`` (page ``table[pos // bs]``, offset
    ``pos % bs``); the kernel never writes the pool.  ``attn_mode="gather"``
    gathers each row's blocks into a ``(B, nb * bs)`` view and runs a dense
    masked softmax; ``"paged_pallas"`` (the name the JAX package gives its
    fused path) runs the paged-attention kernel through ``kernels/ops.py``.
    Rows that must stay inert point their table at trash block 0 with
    ``cache_len = 0``.  Returns (y, cache_k, cache_v); the caches are the
    updated input tensors.
    """
    B, T, _ = x.shape
    nb, bs = block_table.shape[1], cache_k.shape[1]
    q, k, v = project_qkv(p, x, cfg)
    cache_len = cache_len.to(torch.int32)
    pos = cache_len[:, None].long() + torch.arange(T, device=x.device)[None]  # (B, T)
    q, k = rope_qk(q, k, cfg, pos)
    if q.ndim == 4:  # repeated layout: regroup to (B,T,K,G,hd)
        q = q.reshape(B, T, cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim)
    pages = torch.gather(block_table.long(), 1, pos // bs)  # (B, T)
    offs = pos % bs
    cache_k[pages, offs] = k
    cache_v[pages, offs] = v
    if attn_mode == "paged_pallas":
        wnd = GLOBAL_WINDOW if window is None else int(window)
        out = ops.paged_attention(
            q.contiguous(), cache_k, cache_v, block_table, cache_len, wnd,
            softcap=cfg.attn_softcap, scale=cfg.head_dim**-0.5,
        )
        y = out.reshape(B, T, cfg.attn_dim) @ p["wo"]
        return y, cache_k, cache_v
    if attn_mode != "gather":
        raise ValueError(f"unknown attn_mode {attn_mode!r}")
    tab = block_table.long()
    kg = cache_k[tab].reshape(B, nb * bs, *cache_k.shape[2:])
    vg = cache_v[tab].reshape(B, nb * bs, *cache_v.shape[2:])
    kpos = torch.arange(nb * bs, device=x.device)
    diff = pos[:, :, None] - kpos  # (B, T, N)
    mask = (diff >= 0) & (kpos < (cache_len.long() + T)[:, None, None])
    if window is not None:
        mask = mask & (diff < window)
    out = _attend_gathered(q, kg, vg, cfg, mask)
    y = out @ p["wo"]
    return y, cache_k, cache_v
