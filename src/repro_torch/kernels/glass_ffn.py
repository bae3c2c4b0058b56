"""Block-sparse GLASS FFN: the CUDA kernels' wrappers and their plain versions.

The kernels (``csrc/glass_ffn.cu``) replace the TPU kernels
``repro/kernels/glass_ffn.py:glass_ffn_block_sparse`` (one block list
shared by every row) and ``glass_ffn_block_sparse_rowwise`` (one list per
row).  The plain versions, :func:`glass_ffn_ref` and
:func:`glass_ffn_rowwise_ref` (``kernels/ref.py``), compute the same
functions; ``kernels/ops.py`` sends CPU tensors to them and CUDA tensors
here.  Each call is two launches (hidden, then down); the launch counters
count calls.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..models.common import ACTIVATION_CODES
from . import build
from .ref import glass_ffn_ref, glass_ffn_rowwise_ref

__all__ = ["glass_ffn_cuda", "glass_ffn_rowwise_cuda", "glass_ffn_ref", "glass_ffn_rowwise_ref"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"glass_ffn": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P)}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _launch(x, w_up, w_down, block_idx, w_gate, block_scale, act, block_size, rowwise):
    B, d = x.shape
    m = w_up.shape[1]
    nbk = block_idx.shape[-1]
    if x.dtype not in _DTYPE_CODES or any(
        w.dtype != x.dtype for w in (w_up, w_down) + ((w_gate,) if w_gate is not None else ())
    ):
        raise TypeError(f"glass_ffn takes float32 or bfloat16 x and weights of one dtype, got "
                        f"x {x.dtype}, w_up {w_up.dtype}, w_down {w_down.dtype}")
    if m % block_size or w_down.shape != (m, d) or (w_gate is not None and w_gate.shape != (d, m)):
        raise ValueError(f"weight shapes do not match x {tuple(x.shape)} / block {block_size}")
    want_idx = (B, nbk) if rowwise else (nbk,)
    if block_idx.dtype != torch.int32 or tuple(block_idx.shape) != want_idx:
        raise ValueError(f"block_idx must be int32 of shape {want_idx}, got "
                         f"{block_idx.dtype} {tuple(block_idx.shape)}")
    if block_scale is not None and (block_scale.dtype != torch.float32
                                    or block_scale.shape != block_idx.shape):
        raise ValueError("block_scale must be float32 shaped like block_idx")
    tensors = [t for t in (x, w_up, w_down, block_idx, w_gate, block_scale) if t is not None]
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("glass_ffn kernels need every input on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("glass_ffn kernels need contiguous inputs")
    hbuf = torch.empty(B, nbk * block_size, dtype=x.dtype, device=x.device)
    y = torch.empty(B, d, dtype=torch.float32, device=x.device)
    lib = build.load("glass_ffn", _SIGNATURES)
    err = lib.glass_ffn(
        x.data_ptr(), w_gate.data_ptr() if w_gate is not None else None, w_up.data_ptr(),
        w_down.data_ptr(), block_idx.data_ptr(),
        block_scale.data_ptr() if block_scale is not None else None, hbuf.data_ptr(),
        y.data_ptr(), B, d, m, block_size, nbk, int(rowwise), ACTIVATION_CODES[act],
        _DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "glass_ffn_rowwise" if rowwise else "glass_ffn")
    return y


def glass_ffn_cuda(
    x: torch.Tensor,  # (B, d)
    w_up: torch.Tensor,  # (d, m)
    w_down: torch.Tensor,  # (m, d)
    block_idx: torch.Tensor,  # (nb_keep,) int32
    w_gate: Optional[torch.Tensor] = None,
    *,
    block_scale: Optional[torch.Tensor] = None,  # (nb_keep,) f32
    act: str = "silu",
    block_size: int = 128,
) -> torch.Tensor:
    """Shared-list block-sparse GLASS FFN on the card.  Returns (B, d) f32."""
    y = _launch(x, w_up, w_down, block_idx, w_gate, block_scale, act, block_size, False)
    glass_ffn_cuda.launches += 1
    return y


def glass_ffn_rowwise_cuda(
    x: torch.Tensor,  # (B, d)
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    block_idx: torch.Tensor,  # (B, nb_keep) int32
    w_gate: Optional[torch.Tensor] = None,
    *,
    block_scale: Optional[torch.Tensor] = None,  # (B, nb_keep) f32
    act: str = "silu",
    block_size: int = 128,
) -> torch.Tensor:
    """Rowwise block-sparse GLASS FFN on the card.  Returns (B, d) f32."""
    y = _launch(x, w_up, w_down, block_idx, w_gate, block_scale, act, block_size, True)
    glass_ffn_rowwise_cuda.launches += 1
    return y


glass_ffn_cuda.launches = 0
glass_ffn_rowwise_cuda.launches = 0
