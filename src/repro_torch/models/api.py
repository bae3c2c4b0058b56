"""Uniform model API (the dense family's part of ``repro``'s ``Model``):
full-sequence logits, prefill into a contiguous cache, chunked prefill
into a paged cache, and one decode step over either."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import transformer
from .attention import init_cache as _init_kv_cache
from .common import ModelConfig, resolve_device


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, seed: int, device="cuda"):
        """Random weights from ``seed`` on ``device`` (``params.init_params``)."""
        from ..params import init_params

        return init_params(self.cfg, seed, device)

    def logits(self, params, batch, **kw) -> torch.Tensor:
        """Full-sequence logits of ``batch["tokens"]`` (B, S)."""
        out, _, _, _ = transformer.forward(params, batch["tokens"], self.cfg, **kw)
        return out

    def logits_with_stats(self, params, batch):
        """Returns (logits, stats): stats are per-layer |h|/||h||_2 sums."""
        out, _, stats, _ = transformer.forward(params, batch["tokens"], self.cfg,
                                               collect_stats=True)
        return out, stats

    def prefill(self, params, inputs, max_len: int):
        """inputs {"tokens": (B, S)}.  Returns (logits (B,S,V), contiguous
        cache {"k","v": (L, B, max_len, K, hd)}, local stat sums)."""
        return transformer.dense_prefill(params, inputs["tokens"], self.cfg, max_len)

    def init_cache(self, batch: int, max_len: int, device="cuda"):
        """A zero contiguous cache {"k","v": (L, batch, max_len, K, hd)}."""
        cfg = self.cfg
        transformer._check_dense(cfg)
        return _init_kv_cache(cfg, batch, max_len, cfg.n_layers, cfg.compute_dtype,
                              device=resolve_device(device))

    def prefill_chunk(
        self,
        params,
        tokens: torch.Tensor,  # (B, T): the next T prompt tokens
        cache,  # paged {"k","v": (L, num_blocks, bs, K, hd)}
        cache_len: torch.Tensor,  # (B,) int32 tokens already processed
        *,
        block_table: torch.Tensor,  # (B, nb) int32
        attn_mode: str = "gather",  # "paged_pallas" = the paged-attention kernel
    ):
        """Incremental prefill: extend the cache by T prompt tokens.
        Returns (logits (B,T,V), cache, chunk_stats)."""
        return transformer.dense_prefill_chunk(
            params, tokens, self.cfg, cache, block_table, cache_len, attn_mode=attn_mode,
        )

    def decode_step(
        self,
        params,
        token: torch.Tensor,  # (B, 1)
        cache,  # contiguous {"k","v": (L, B, S_max, K, hd)}, or paged with a block_table
        cache_len,  # int for every row, or (B,) per-slot lengths
        *,
        ffn_masks=None,
        compact_layers=None,
        block_table=None,
        ffn_block_idx=None,
        ffn_block_size: int = 128,
        ffn_block_scale=None,
        ffn_groups=(),
        ffn_row_perm=None,
        attn_mode: str = "gather",
    ):
        if ffn_groups and ffn_block_idx is None:
            raise ValueError("ffn_groups requires ffn_block_idx (block-sparse decode)")
        return transformer.dense_decode_step(
            params, token, cache, cache_len, self.cfg, ffn_masks=ffn_masks,
            compact_layers=compact_layers, block_table=block_table,
            ffn_block_idx=ffn_block_idx, ffn_block_size=ffn_block_size,
            ffn_block_scale=ffn_block_scale, ffn_groups=ffn_groups,
            ffn_row_perm=ffn_row_perm, attn_mode=attn_mode,
        )


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
