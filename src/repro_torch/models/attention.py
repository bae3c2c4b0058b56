"""Grouped-query attention with RoPE, score softcap, sliding window and
KV-cache decode.

Conventions (as in ``repro/models/attention.py``):
  x            (B, S, d_model)
  q            (B, S, K, G, hd)   K = kv heads, G = q_per_kv
               (B, S, H, hd)      in the ``repeated`` layout
  k, v         (B, S, K, hd)
  cache        (B, S_max, K, hd) per layer, contiguous
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


def _attend(q, k, v, cfg: ModelConfig, mask) -> torch.Tensor:
    """Scores in f32, optional tanh softcap, probabilities cast to V's
    dtype before the PV product.  Returns (B, Sq, attn_dim).

    grouped layout:  q (B,Sq,K,G,hd), k/v (B,Skv,K,hd)
    repeated layout: q (B,Sq,H,hd),   k/v repeated to H heads
    mask (B,1,1,Sq,Skv) broadcastable.
    """
    scale = cfg.head_dim ** -0.5
    if q.ndim == 4:  # repeated, as the JAX package computes it
        G = cfg.q_per_kv
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
        s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
        if cfg.attn_softcap is not None:
            s = cfg.attn_softcap * torch.tanh(s / cfg.attn_softcap)
        s = torch.where(mask[:, 0], s, NEG_INF)  # (B,H,Sq,Skv)
        probs = torch.softmax(s, dim=-1).to(v.dtype)
        out = torch.einsum("bhst,bthd->bshd", probs, v)
    else:
        s = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) * scale
        if cfg.attn_softcap is not None:
            s = cfg.attn_softcap * torch.tanh(s / cfg.attn_softcap)
        s = torch.where(mask, s, NEG_INF)
        probs = torch.softmax(s, dim=-1).to(v.dtype)
        out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(out.shape[0], out.shape[1], cfg.attn_dim)


def causal_window_mask(
    q_pos: torch.Tensor,  # (B, Sq) int
    kv_pos: torch.Tensor,  # (Skv,) int
    window: Optional[int],  # None => no window
    kv_len=None,  # int or (B,) tensor: only positions < kv_len are valid
    causal: bool = True,
) -> torch.Tensor:
    """Boolean mask (B, 1, 1, Sq, Skv): True = attend."""
    qp = q_pos[:, None, None, :, None]
    kp = kv_pos[None, None, None, None, :]
    mask = qp >= kp if causal else torch.ones(qp.shape[:4] + kp.shape[-1:], dtype=torch.bool,
                                               device=q_pos.device)
    if window is not None:
        mask = mask & ((qp - kp) < window)
    if kv_len is not None:
        if torch.is_tensor(kv_len) and kv_len.ndim:  # per-slot lengths
            kv_len = kv_len[:, None, None, None, None]
        mask = mask & (kp < kv_len)
    return mask


def _attend_chunked(q, k, v, cfg: ModelConfig, qpos, kvpos, window, causal, chunk):
    """Query-chunked attention: exact full-row softmax per chunk of
    ``chunk`` queries, so peak score memory is O(chunk * S_kv)."""
    S = q.shape[1]
    outs = []
    for c0 in range(0, S, chunk):
        mask = causal_window_mask(qpos[:, c0 : c0 + chunk], kvpos, window, causal=causal)
        outs.append(_attend(q[:, c0 : c0 + chunk], k, v, cfg, mask))
    return torch.cat(outs, dim=1)


def attention_forward(
    p: dict,
    x: torch.Tensor,  # (B, S, d)
    cfg: ModelConfig,
    *,
    window: Optional[int] = None,
    causal: bool = True,
    return_kv: bool = False,
):
    """Full-sequence attention (prefill) at positions 0..S-1.

    On a CUDA device it always runs the flash-attention kernel
    (``kernels/ops.py``), which reads the (B, S, heads, hd) projections
    through their strides: no transpose copy, and no repeat of the KV
    heads.  On the CPU it computes what the JAX package's jnp path does:
    ``_attend``, or ``_attend_chunked`` when ``S > 2 * attn_chunk`` and
    ``attn_chunk`` divides S.  Returns y, or (y, (k, v)) with k, v
    (B, S, K, hd)."""
    B, S, _ = x.shape
    q, k, v = project_qkv(p, x, cfg)
    pos = torch.arange(S, device=x.device)
    q, k = rope_qk(q, k, cfg, pos[None].expand(B, S))
    if ops.on_card(x):
        out = ops.flash_attention(
            q.reshape(B, S, cfg.n_heads, cfg.head_dim).transpose(1, 2), k.transpose(1, 2),
            v.transpose(1, 2), causal=causal, window=window, softcap=cfg.attn_softcap,
            scale=cfg.head_dim**-0.5,
        )
        out = out.transpose(1, 2).reshape(B, S, cfg.attn_dim)
    else:
        qpos = pos[None].expand(B, S)
        if S > 2 * cfg.attn_chunk and S % cfg.attn_chunk == 0:
            out = _attend_chunked(q, k, v, cfg, qpos, pos, window, causal, cfg.attn_chunk)
        else:
            out = _attend(q, k, v, cfg, causal_window_mask(qpos, pos, window, causal=causal))
    y = out @ p["wo"]
    return (y, (k, v)) if return_kv else y


def init_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int, dtype,
               device="cpu") -> dict:
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def write_cache_prefill(cache_k, cache_v, k, v):
    """Write prefill k/v (B,S,K,hd) at offset 0 of a per-layer cache
    (B,S_max,K,hd), in place."""
    S = k.shape[1]
    cache_k[:, :S] = k
    cache_v[:, :S] = v
    return cache_k, cache_v


def attention_decode(
    p: dict,
    x: torch.Tensor,  # (B, 1, d)
    cfg: ModelConfig,
    *,
    cache_k: torch.Tensor,  # (B, S_max, K, hd), updated in place
    cache_v: torch.Tensor,
    cache_len,  # int tokens already in the cache: scalar, or (B,) per slot
    window: Optional[int] = None,
):
    """One decode step over a contiguous cache: write the token's k/v at
    ``cache_len`` and attend over the valid prefix (plain torch, as the
    JAX package computes it with jnp).  Returns (y, cache_k, cache_v)."""
    B = x.shape[0]
    S_max = cache_k.shape[1]
    q, k, v = project_qkv(p, x, cfg)
    cache_len = torch.as_tensor(cache_len, dtype=torch.int64, device=x.device)
    pos = cache_len[:, None] if cache_len.ndim else cache_len.expand(B, 1)
    q, k = rope_qk(q, k, cfg, pos)
    if q.ndim == 4:  # repeated layout: regroup to (B,1,K,G,hd), the grouped einsum
        q = q.reshape(B, 1, cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim)
    rows = torch.arange(B, device=x.device)
    cache_k[rows, pos[:, 0]] = k[:, 0]
    cache_v[rows, pos[:, 0]] = v[:, 0]
    kvpos = torch.arange(S_max, device=x.device)
    mask = causal_window_mask(pos, kvpos, window, kv_len=cache_len + 1)
    y = _attend(q, cache_k, cache_v, cfg, mask) @ p["wo"]
    return y, cache_k, cache_v


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
    kvpos = torch.arange(nb * bs, device=x.device)
    mask = causal_window_mask(pos, kvpos, window, kv_len=cache_len.long() + T)
    y = _attend(q, kg, vg, cfg, mask) @ p["wo"]
    return y, cache_k, cache_v
