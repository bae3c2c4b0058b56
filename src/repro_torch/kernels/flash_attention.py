"""Flash attention: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``repro/kernels/flash_attention.py:flash_attention``, with grouped-query
heads taken as they are (k and v carry K <= H heads) and any lengths.  One
C entry dispatches on dtype: bfloat16 runs on the tensor cores (mma.sync,
cp.async), float32 on the CUDA cores in f32; each is the kernel for its
dtype, and neither falls back to the other.  The plain version,
:func:`flash_attention_ref` (``kernels/ref.py``), computes the same
function; ``kernels/ops.py`` sends CPU tensors to it and CUDA tensors
here.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .ref import flash_attention_ref

__all__ = ["flash_attention_cuda", "flash_attention_ref"]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    "flash_attention": (_P, _P, _P, _P) + (_L,) * 12 + (_I,) * 8 + (_F, _F, _I, _P),
}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)
NO_WINDOW = 2**30


def flash_attention_cuda(
    q: torch.Tensor,  # (B, H, Sq, hd)
    k: torch.Tensor,  # (B, K, Skv, hd), H % K == 0
    v: torch.Tensor,  # (B, K, Skv, hd)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch the flash-attention kernel on the current stream.  Inputs
    may be strided views (head_dim contiguous), e.g. ``(B, S, H, hd)``
    projections transposed to ``(B, H, S, hd)``.  Returns (B, H, Sq, hd) in
    q's dtype, as a view of a ``(B, Sq, H, hd)`` buffer, so that
    ``out.transpose(1, 2)`` is contiguous.  Raises on inputs it does not
    take."""
    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd or K < 1 or H % K:
        raise ValueError(f"k/v shape {tuple(k.shape)} / {tuple(v.shape)} does not match "
                         f"q {tuple(q.shape)} (need (B, K, Skv, hd) with H % K == 0)")
    if not 1 <= Sq <= Skv:
        raise ValueError(f"flash_attention needs 1 <= Sq <= Skv, got Sq={Sq}, Skv={Skv}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"flash_attention takes head_dim in {_HEAD_DIMS}, got {hd}")
    window = NO_WINDOW if window is None else min(int(window), NO_WINDOW)
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("flash_attention_cuda needs every input on one CUDA device")
    if not all(t.stride(-1) == 1 for t in (q, k, v)):
        raise ValueError("flash_attention_cuda needs the head_dim axis contiguous")
    scale = scale if scale is not None else hd**-0.5
    out = torch.empty(B, Sq, H, hd, dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    ptrs = [t.data_ptr() for t in (q, k, v, out)]
    if q.dtype == torch.bfloat16 and (any(p % 16 for p in ptrs) or any(s % 8 for s in strides)):
        # the tensor-core kernel copies 16-byte chunks
        raise ValueError("bfloat16 flash_attention_cuda needs 16-byte aligned q/k/v and strides "
                         "that are multiples of 8 elements")
    lib = build.load("flash_attention", _SIGNATURES)
    err = lib.flash_attention(
        *ptrs, *strides, B, K, H // K, Sq, Skv, hd, int(causal), window,
        float(softcap) if softcap is not None else 0.0, float(scale), _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "flash_attention")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
