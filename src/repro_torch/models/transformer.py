"""Decoder-only LM assembly for the dense family.

Layer parameters are stacked along a leading L axis (the JAX package's
layout); the JAX layer scan becomes a Python loop over layers that takes
per-layer views.  Caches are updated in place: the contiguous cache
{"k","v": (L, B, S_max, K, hd)} of ``dense_prefill`` / the slot arena, or
the paged cache {"k","v": (L, num_blocks, bs, K, hd)}.  GLASS plumbing per
layer:

  * ``ffn_masks``        (L, m) shared or (L, B, m) per slot — multiplier on h
  * ``compact_layers``   gathered FFN weights (``core/glass.compact_params``):
                         w_up (L, d, k) shared or (L, B, d, k) per slot
  * ``ffn_block_idx``    (L, nb_keep) shared or (L, B, nb_keep) per slot —
                         active FFN block ids for the block-sparse kernels
  * ``collect_stats``    per-layer sums of |h|/||h||_2 (prefill)
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from ..kernels import ops
from .attention import (
    GLOBAL_WINDOW,
    attention_decode,
    attention_decode_paged,
    attention_forward,
    init_cache,
    write_cache_prefill,
)
from .common import ModelConfig, rms_norm, softcap
from .ffn import ffn_forward, ffn_forward_with_stats


def layer_params(layers: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Per-layer views of the L-stacked layer params."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in layers.items()}


def layer_windows(cfg: ModelConfig) -> List[int]:
    if cfg.attn_pattern == "local_global" and cfg.sliding_window:
        return [cfg.sliding_window if i % 2 == 0 else GLOBAL_WINDOW for i in range(cfg.n_layers)]
    if cfg.sliding_window:
        return [cfg.sliding_window] * cfg.n_layers
    return [GLOBAL_WINDOW] * cfg.n_layers


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = params["embed"][tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x


def lm_logits(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["lm_head"]
    return softcap(logits, cfg.logit_softcap)


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.sandwich_norms:
        raise NotImplementedError(
            f"family={cfg.family!r} (sandwich_norms={cfg.sandwich_norms}): the port serves the "
            "dense family only; the others are ROADMAP Queue 1 item 8"
        )


def _dense_block(x, lp, cfg: ModelConfig, *, window, mask_l=None, collect_stats=False,
                 stats_mask=None, return_kv=False):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    attn_out = attention_forward(lp["attn"], h, cfg, window=window, return_kv=return_kv)
    kv = None
    if return_kv:
        attn_out, kv = attn_out
    x = x + attn_out
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    stats = None
    if collect_stats:
        y, stats = ffn_forward_with_stats(lp["ffn"], h2, cfg, token_mask=stats_mask)
    else:
        y = ffn_forward(lp["ffn"], h2, cfg, mask=mask_l)
    return x + y, stats, kv


def dense_forward(
    params,
    tokens: torch.Tensor,  # (B, S) int
    cfg: ModelConfig,
    *,
    ffn_masks: Optional[torch.Tensor] = None,  # (L, m)
    probes=None,
    collect_stats: bool = False,
    stats_mask: Optional[torch.Tensor] = None,  # (B, S) float: restrict stats to these tokens
    return_cache: bool = False,
):
    """Full-sequence forward at positions 0..S-1.  Returns (logits, aux,
    stats, kv): aux is 0.0 (the dense family has no router loss), stats
    {"sum_abs": (L, m), "count": (L,)} when ``collect_stats``, kv
    (k, v) each (L, B, S, K, hd) when ``return_cache``."""
    _check_dense(cfg)
    if probes is not None:
        raise NotImplementedError(
            "probes (the I-GLASS impact gradient) are ROADMAP Queue 1 item 7 (NPS and the "
            "global prior)"
        )
    x = embed_tokens(params, tokens, cfg)
    sums, counts, ks, vs = [], [], [], []
    for i, window in enumerate(layer_windows(cfg)):
        x, stats, kv = _dense_block(
            x, layer_params(params["layers"], i), cfg, window=window,
            mask_l=None if ffn_masks is None else ffn_masks[i], collect_stats=collect_stats,
            stats_mask=stats_mask, return_kv=return_cache,
        )
        if collect_stats:
            sums.append(stats["sum_abs"])
            counts.append(stats["count"])
        if return_cache:
            ks.append(kv[0])
            vs.append(kv[1])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(params, x, cfg)
    stats = {"sum_abs": torch.stack(sums), "count": torch.stack(counts)} if collect_stats else None
    kvs = (torch.stack(ks), torch.stack(vs)) if return_cache else None
    return logits, torch.zeros((), dtype=torch.float32, device=x.device), stats, kvs


def dense_prefill(params, tokens: torch.Tensor, cfg: ModelConfig, max_len: int):
    """Prefill: logits, a contiguous cache {"k","v": (L, B, max_len, K, hd)}
    holding the prompt's rows, and the GLASS local stat sums."""
    logits, _, stats, (k, v) = dense_forward(
        params, tokens, cfg, collect_stats=True, return_cache=True
    )
    B = tokens.shape[0]
    cache = init_cache(cfg, B, max_len, cfg.n_layers, k.dtype, device=k.device)
    for i in range(cfg.n_layers):
        write_cache_prefill(cache["k"][i], cache["v"][i], k[i], v[i])
    return logits, cache, stats


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, **kw):
    """The uniform full-sequence entry point (the dense family)."""
    return dense_forward(params, tokens, cfg, **kw)


def dense_prefill_chunk(
    params, tokens: torch.Tensor, cfg: ModelConfig, cache, block_table: torch.Tensor,
    cache_len: torch.Tensor, attn_mode: str = "gather",
):
    """One chunk of a paged prefill.  tokens (B, T) continue prompts whose
    first ``cache_len`` tokens already live in the paged cache through
    ``block_table`` (B, nb); positions are absolute (``cache_len + t``).
    Returns (logits (B,T,V), cache, chunk_stats) — stats are per-layer sums
    over this chunk's tokens ({"sum_abs": (L, m), "count": (L,)}) and merge
    across chunks by addition."""
    _check_dense(cfg)
    x = embed_tokens(params, tokens, cfg)
    sums, counts = [], []
    for i, window in enumerate(layer_windows(cfg)):
        lp = layer_params(params["layers"], i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _, _ = attention_decode_paged(
            lp["attn"], h, cfg, cache_k=cache["k"][i], cache_v=cache["v"][i],
            block_table=block_table, cache_len=cache_len, window=window, attn_mode=attn_mode,
        )
        x = x + a
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        y, stats = ffn_forward_with_stats(lp["ffn"], h2, cfg)
        sums.append(stats["sum_abs"])
        counts.append(stats["count"])
        x = x + y
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(params, x, cfg)
    return logits, cache, {"sum_abs": torch.stack(sums), "count": torch.stack(counts)}


def _block_sparse_ffn(fp, h2, cfg, bidx_l, bscale_l, block_size, groups, row_perm):
    """The FFN of one layer through the block-sparse GLASS kernels.  h2
    (B, 1, d).  Per-slot lists (``bidx_l`` (B, nb_keep)) batch rows with
    identical lists through the shared-list kernel (``groups`` sizes over
    ``row_perm``-ordered rows) and send the rest to the rowwise kernel."""
    xb = h2[:, 0]
    kw = dict(act=cfg.ffn_act, block_size=block_size)
    if bidx_l.ndim == 1:
        return ops.glass_ffn(xb, fp["w_up"], fp["w_down"], bidx_l, fp.get("w_gate"),
                             block_scale=bscale_l, **kw)
    if not groups:
        return ops.glass_ffn_rowwise(xb, fp["w_up"], fp["w_down"], bidx_l, fp.get("w_gate"),
                                     block_scale=bscale_l, **kw)
    xp, bp = xb[row_perm], bidx_l[row_perm]
    sp = None if bscale_l is None else bscale_l[row_perm]
    parts = []
    off = 0
    for gs in groups:
        parts.append(ops.glass_ffn(
            xp[off : off + gs], fp["w_up"], fp["w_down"], bp[off], fp.get("w_gate"),
            block_scale=None if sp is None else sp[off], **kw,
        ))
        off += gs
    if off < xp.shape[0]:
        parts.append(ops.glass_ffn_rowwise(
            xp[off:], fp["w_up"], fp["w_down"], bp[off:], fp.get("w_gate"),
            block_scale=None if sp is None else sp[off:], **kw,
        ))
    yp = torch.cat(parts, dim=0)
    y32 = torch.empty_like(yp)
    y32[row_perm] = yp
    return y32


def dense_decode_step(
    params,
    token: torch.Tensor,  # (B, 1) int: one decode tick
    cache,  # {"k","v"}: paged (L, num_blocks, bs, K, hd) or (L, B, S_max, K, hd), in place
    cache_len,  # (B,) per-slot lengths, or an int for every row (contiguous cache only)
    cfg: ModelConfig,
    *,
    ffn_masks: Optional[torch.Tensor] = None,  # (L, m) shared or (L, B, m) per slot
    compact_layers=None,  # gathered FFN weights, w_up (L, d, k) or (L, B, d, k)
    block_table: Optional[torch.Tensor] = None,  # (B, nb) int32 paged-KV block table
    ffn_block_idx: Optional[torch.Tensor] = None,  # (L, nb_keep) or (L, B, nb_keep)
    ffn_block_size: int = 128,
    ffn_block_scale: Optional[torch.Tensor] = None,  # like ffn_block_idx, f32
    ffn_groups: Sequence[int] = (),  # rows sharing a block list (sizes >= 2)
    ffn_row_perm: Optional[torch.Tensor] = None,  # (B,) rows group-major, singletons last
    attn_mode: str = "gather",
):
    """One decode tick across all layers.  Returns (logits (B,1,V), cache).

    With a ``block_table`` the cache is paged and ``cache_len`` is (B,);
    without, it is contiguous ({"k","v": (L, B, S_max, K, hd)}) and
    ``cache_len`` is an int for every row or (B,) per slot."""
    _check_dense(cfg)
    if token.shape[1] != 1:
        raise NotImplementedError(
            "T > 1 decode (the parallel speculative verify) is ROADMAP Queue 1 item 4"
        )
    if ffn_groups and ffn_row_perm is None:
        raise ValueError("ffn_groups requires ffn_row_perm")
    x = embed_tokens(params, token, cfg)
    for i, window in enumerate(layer_windows(cfg)):
        lp = layer_params(params["layers"], i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if block_table is not None:
            a, _, _ = attention_decode_paged(
                lp["attn"], h, cfg, cache_k=cache["k"][i], cache_v=cache["v"][i],
                block_table=block_table, cache_len=cache_len, window=window, attn_mode=attn_mode,
            )
        else:
            a, _, _ = attention_decode(lp["attn"], h, cfg, cache_k=cache["k"][i],
                                       cache_v=cache["v"][i], cache_len=cache_len, window=window)
        x = x + a
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        if ffn_block_idx is not None:
            y32 = _block_sparse_ffn(
                lp["ffn"], h2, cfg, ffn_block_idx[i],
                None if ffn_block_scale is None else ffn_block_scale[i],
                ffn_block_size, ffn_groups, ffn_row_perm,
            )
            y = y32.to(x.dtype).reshape(x.shape)
        else:
            fp = lp["ffn"] if compact_layers is None else layer_params(compact_layers, i)
            mask_l = None if ffn_masks is None else ffn_masks[i]
            if mask_l is not None and mask_l.ndim == 2:  # per-slot (B, m)
                mask_l = mask_l[:, None, :]
            y = ffn_forward(fp, h2, cfg, mask=mask_l)
        x = x + y
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(params, x, cfg), cache
