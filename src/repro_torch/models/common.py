"""Shared model pieces: config, norms, activations, device resolution.

The port's counterpart of ``repro/models/common.py``.  Params are nested
dicts of tensors; apply functions are module-level and take the config
explicitly, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def resolve_device(device) -> torch.device:
    """The device an entry point was asked for.  A CUDA device on a host
    without one raises: no entry point carries on on the CPU unless the
    caller asked for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU"
            )
        if dev.index is None:  # tensors report an indexed device: compare like with like
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class ModelConfig:
    name: str = "tiny"
    family: str = "dense"  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int = 4
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 32
    d_ff: int = 512
    vocab_size: int = 512

    # FFN
    ffn_act: str = "silu"  # silu | gelu | relu | relu2
    gated_ffn: bool = True

    # attention extras
    rope_theta: float = 10000.0
    rope_type: str = "standard"  # standard | mrope | none
    mrope_sections: Tuple[int, ...] = ()
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None
    attn_pattern: str = "global"  # global | local_global (alternating, local first)
    sandwich_norms: bool = False  # gemma2 post-norms
    embed_scale: bool = False  # gemma: embeddings scaled by sqrt(d_model)
    gqa_layout: str = "grouped"  # grouped | repeated (numerics-identical)

    # MoE
    n_experts: int = 0
    n_experts_per_tok: int = 0
    moe_strategy: str = "dense"
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_chunk: int = 512
    expert_replication: int = 1

    # SSM (mamba2) / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    mamba_headdim: int = 64
    mamba_expand: int = 2
    attn_every: int = 0

    # rwkv6
    rwkv_headdim: int = 64
    rwkv_lora_rank: int = 32

    # enc-dec (whisper)
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    max_positions: int = 8192

    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    remat: str = "full"
    attn_chunk: int = 1024

    # GLASS integration defaults (density applied at serve time)
    glass_density: float = 0.5
    glass_block: int = 128

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelConfig":
        """Build from a plain dict (e.g. ``dataclasses.asdict`` of the JAX
        package's config); sequences become tuples, unknown keys raise."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise KeyError(f"unknown ModelConfig fields: {sorted(unknown)}")
        kw = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
        return cls(**kw)

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in f32, cast back. ``plus_one``: gemma-style (1 + w) scale."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    w = weight.float()
    scale = 1.0 + w if plus_one else w
    return (x * scale).to(dt)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


_ACTIVATIONS = {
    "silu": F.silu,
    "gelu": lambda t: F.gelu(t, approximate="tanh"),
    "relu": F.relu,
    "relu2": lambda t: torch.square(F.relu(t)),
}

# the codes the CUDA kernels take for the same activations
ACTIVATION_CODES = {"silu": 0, "gelu": 1, "relu": 2, "relu2": 3}


def activation(name: str):
    return _ACTIVATIONS[name]
