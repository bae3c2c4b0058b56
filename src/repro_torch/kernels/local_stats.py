"""GLASS local-importance sums: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/local_stats.cu``) replaces the TPU kernel
``repro/kernels/local_stats.py:local_stats`` and adds the optional row mask
of ``ffn_forward_with_stats``.  The plain version, :func:`local_stats_ref`
(``kernels/ref.py``), computes the same function; ``kernels/ops.py`` sends
CPU tensors to it and CUDA tensors here.  Each call is up to three
launches (row norms, column partial sums, their fixed-order total); the
launch counter counts calls.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .ref import local_stats_ref

__all__ = ["local_stats_cuda", "local_stats_ref"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "local_stats": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "local_stats_row_tiles": (_I,),
}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def local_stats_cuda(h: torch.Tensor, row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the local-stats kernel on the current stream.  h (T, m)
    float32 or bfloat16, row_mask (T,) float32 or None.  Returns (m,) f32.
    Two calls on the same input return the same bits."""
    if h.ndim != 2 or h.shape[0] < 1:
        raise ValueError(f"local_stats takes h of shape (T >= 1, m), got {tuple(h.shape)}")
    T, m = h.shape
    if h.dtype not in _DTYPE_CODES:
        raise TypeError(f"local_stats takes float32 or bfloat16 h, got {h.dtype}")
    if row_mask is not None and (row_mask.dtype != torch.float32 or row_mask.shape != (T,)):
        raise ValueError(f"row_mask must be float32 of shape ({T},), got "
                         f"{row_mask.dtype} {tuple(row_mask.shape)}")
    tensors = [t for t in (h, row_mask) if t is not None]
    if not all(t.is_cuda and t.device == h.device for t in tensors):
        raise ValueError("local_stats_cuda needs every input on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("local_stats_cuda needs contiguous inputs")
    lib = build.load("local_stats", _SIGNATURES)
    n_tiles = lib.local_stats_row_tiles(T)
    denom = torch.empty(T, dtype=torch.float32, device=h.device)
    partial = torch.empty(n_tiles if n_tiles > 1 else 0, m, dtype=torch.float32, device=h.device)
    out = torch.empty(m, dtype=torch.float32, device=h.device)
    err = lib.local_stats(
        h.data_ptr(), row_mask.data_ptr() if row_mask is not None else None, denom.data_ptr(),
        partial.data_ptr(), out.data_ptr(), T, m, _DTYPE_CODES[h.dtype],
        torch.cuda.current_stream(h.device).cuda_stream,
    )
    build.check(err, "local_stats")
    local_stats_cuda.launches += 1
    return out


local_stats_cuda.launches = 0
