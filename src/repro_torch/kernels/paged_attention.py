"""Paged attention: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/paged_attention.cu``) replaces the TPU kernel
``repro/kernels/paged_attention.py:paged_attention``: a split launch (one
CTA per 64 query rows, kv head, split of the KV walk and batch row, on the
tensor cores in bf16) writes f32 partials to scratch that the wrapper
allocates, and a combine launch merges each query's splits in order.  The
plain version, :func:`paged_attention_ref` (``kernels/ref.py``), computes
the same function; ``kernels/ops.py`` sends CPU tensors to it and CUDA
tensors here.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build
from .ref import paged_attention_ref

__all__ = ["paged_attention_cuda", "paged_attention_ref", "split_size"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "paged_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I,
                        _P),
    "paged_attention_split_size": (),
}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def paged_attention_cuda(
    q: torch.Tensor,  # (B, T, K, G, hd)
    cache_k: torch.Tensor,  # (num_blocks, bs, K, hd)
    cache_v: torch.Tensor,
    block_table: torch.Tensor,  # (B, nb) int32
    cache_len: torch.Tensor,  # (B,) int32
    window: int,
    *,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch the paged-attention kernel on the current stream.  Returns
    (B, T, K, G, hd) in q's dtype.  Raises on inputs it does not take."""
    B, T, K, G, hd = q.shape
    nb = block_table.shape[1]
    bs = cache_k.shape[1]
    if q.dtype not in _DTYPE_CODES or cache_k.dtype != q.dtype or cache_v.dtype != q.dtype:
        raise TypeError(f"paged_attention takes float32 or bfloat16 q/k/v of one dtype, got "
                        f"{q.dtype}, {cache_k.dtype}, {cache_v.dtype}")
    if block_table.dtype != torch.int32 or cache_len.dtype != torch.int32:
        raise TypeError("block_table and cache_len must be int32")
    if cache_k.shape != cache_v.shape or cache_k.shape[2:] != (K, hd):
        raise ValueError(f"pool shape {tuple(cache_k.shape)} does not match q {tuple(q.shape)}")
    if cache_len.shape != (B,) or block_table.shape[0] != B:
        raise ValueError("block_table / cache_len must have one row per q row")
    if bs > 32 or hd > 256 or G > 32:
        raise ValueError(f"kernel takes block_size <= 32, head_dim <= 256, G <= 32; "
                         f"got bs={bs}, hd={hd}, G={G}")
    tensors = (q, cache_k, cache_v, block_table, cache_len)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("paged_attention_cuda needs every input on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention_cuda needs contiguous inputs")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, cache_k, cache_v)):
        # the tensor-core kernel copies 16-byte chunks
        raise ValueError("bfloat16 paged_attention_cuda needs 16-byte aligned q, cache_k and "
                         "cache_v")
    n_split = -(-nb * bs // split_size())
    if B * n_split > 65535 or T > 65535:
        raise ValueError(f"grid too large: B * splits = {B * n_split}, T = {T} (65535 each)")
    scale = scale if scale is not None else hd**-0.5
    lib = build.load("paged_attention", _SIGNATURES)
    out = torch.empty_like(q)
    # each split's f32 partials: O (rows, hd) and (m, l) per row
    rows = B * T * K * G
    part_o = torch.empty(n_split * rows * hd, dtype=torch.float32, device=q.device)
    part_ml = torch.empty(n_split * rows * 2, dtype=torch.float32, device=q.device)
    err = lib.paged_attention(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), block_table.data_ptr(),
        cache_len.data_ptr(), out.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(), B, T, K, G,
        hd, nb, bs, int(window), float(softcap) if softcap is not None else 0.0, float(scale),
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "paged_attention")
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0


@functools.cache
def split_size() -> int:
    """The kernel's split: logical key positions per CTA of the KV walk (a
    constant of ``csrc/paged_attention.cu``).  Builds the kernel if needed."""
    return build.load("paged_attention", _SIGNATURES).paged_attention_split_size()
