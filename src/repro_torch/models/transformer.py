"""Decoder-only LM assembly for the dense family over a paged KV cache.

Layer parameters are stacked along a leading L axis (the JAX package's
layout); the JAX layer scan becomes a Python loop over layers that takes
per-layer views.  The paged cache {"k","v": (L, num_blocks, bs, K, hd)} is
updated in place.  GLASS plumbing per layer:

  * ``ffn_masks``        (L, m) shared or (L, B, m) per slot — multiplier on h
  * ``ffn_block_idx``    (L, nb_keep) shared or (L, B, nb_keep) per slot —
                         active FFN block ids for the block-sparse kernels
  * prefill stats        per-layer sums of |h|/||h||_2
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from ..kernels import ops
from .attention import GLOBAL_WINDOW, attention_decode_paged
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
    cache,  # paged {"k","v": (L, num_blocks, bs, K, hd)}, updated in place
    cache_len: torch.Tensor,  # (B,) int32 per-slot lengths
    cfg: ModelConfig,
    *,
    ffn_masks: Optional[torch.Tensor] = None,  # (L, m) shared or (L, B, m) per slot
    compact_layers=None,
    block_table: Optional[torch.Tensor] = None,  # (B, nb) int32 paged-KV block table
    ffn_block_idx: Optional[torch.Tensor] = None,  # (L, nb_keep) or (L, B, nb_keep)
    ffn_block_size: int = 128,
    ffn_block_scale: Optional[torch.Tensor] = None,  # like ffn_block_idx, f32
    ffn_groups: Sequence[int] = (),  # rows sharing a block list (sizes >= 2)
    ffn_row_perm: Optional[torch.Tensor] = None,  # (B,) rows group-major, singletons last
    attn_mode: str = "gather",
):
    """One decode tick across all layers.  Returns (logits (B,1,V), cache)."""
    _check_dense(cfg)
    if block_table is None:
        raise NotImplementedError(
            "the port decodes through a paged KV cache only; the slot-arena cache of "
            "Engine/ContinuousEngine is ROADMAP Queue 1 item 9"
        )
    if compact_layers is not None:
        raise NotImplementedError("compact FFN layers are ROADMAP Queue 1 item 6 (compact mode)")
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
        a, _, _ = attention_decode_paged(
            lp["attn"], h, cfg, cache_k=cache["k"][i], cache_v=cache["v"][i],
            block_table=block_table, cache_len=cache_len, window=window, attn_mode=attn_mode,
        )
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
            mask_l = None if ffn_masks is None else ffn_masks[i]
            if mask_l is not None and mask_l.ndim == 2:  # per-slot (B, m)
                mask_l = mask_l[:, None, :]
            y = ffn_forward(lp["ffn"], h2, cfg, mask=mask_l)
        x = x + y
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(params, x, cfg), cache
