"""Parameter trees: random init and the weight bridge to the JAX package.

The tree has ``repro``'s leaf names and layouts (``init_lm`` for the dense
family): {"embed": (V, d), "layers": {"attn": {"wq","wk","wv","wo"},
"ln1", "ln2", "ffn": {"w_up","w_down"[,"w_gate"]}} stacked over a leading
L axis, "final_norm" (d,) [, "lm_head" (d, V)]}.  Leaf paths join keys
with ``###``, the naming of ``repro/checkpoint/ckpt.py:_flatten``.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from .models.common import ModelConfig, resolve_device

SEP = "###"


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """Nested dict of leaf shapes for the dense family (``init_lm``)."""
    if cfg.family != "dense" or cfg.sandwich_norms:
        raise NotImplementedError(
            f"family={cfg.family!r}: the port's params cover the dense family only "
            "(ROADMAP Queue 1 item 8)"
        )
    L, d, f, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    ffn = {"w_up": (L, d, f), "w_down": (L, f, d)}
    if cfg.gated_ffn:
        ffn["w_gate"] = (L, d, f)
    shapes = {
        "embed": (V, d),
        "layers": {
            "attn": {"wq": (L, d, cfg.attn_dim), "wk": (L, d, cfg.kv_dim),
                     "wv": (L, d, cfg.kv_dim), "wo": (L, cfg.attn_dim, d)},
            "ln1": (L, d),
            "ln2": (L, d),
            "ffn": ffn,
        },
        "final_norm": (d,),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, V)
    return shapes


def init_params(cfg: ModelConfig, seed: int, device="cuda") -> Dict[str, Any]:
    """Random weights from ``seed`` through an explicit ``torch.Generator``,
    with ``init_lm``'s distributions: truncated normal (+-2 std) scaled by
    1/sqrt(fan_in) for matrices, N(0, 0.02) for the embedding, ones for
    norms.  Each layer is drawn in f32 and cast to the compute dtype, so a
    full-size model never holds an f32 copy of a whole stacked leaf.
    The numbers differ from JAX's for the same seed; use
    :func:`from_reference` to load the JAX package's weights."""
    dev = resolve_device(device)
    dt = cfg.compute_dtype
    gen = torch.Generator(device=dev).manual_seed(seed)

    def fill(path: str, shape):
        out = torch.empty(shape, dtype=dt, device=dev)
        leaf = path.split(SEP)[-1]
        if leaf in ("ln1", "ln2", "final_norm"):
            return out.fill_(1.0)
        if leaf == "embed":
            return out.copy_(torch.randn(shape, generator=gen, device=dev) * 0.02)
        fan_in = shape[-2]
        for sl in ([out] if len(shape) == 2 else list(out)):
            tmp = torch.empty(sl.shape, dtype=torch.float32, device=dev)
            torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0, generator=gen)
            sl.copy_(tmp / math.sqrt(fan_in))
        return out

    flat = {path: fill(path, shape) for path, shape in flatten(param_shapes(cfg)).items()}
    return unflatten(flat)


def flatten(tree) -> Dict[str, Any]:
    """{"a###b###c": leaf} for a nested dict."""
    flat: Dict[str, Any] = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{SEP}{k}" if prefix else str(k), v)
        else:
            flat[prefix] = node

    walk("", tree)
    return flat


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split(SEP)
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def _to_torch(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def from_reference(tree, device="cuda") -> Dict[str, Any]:
    """The JAX package's param tree (nested dicts of numpy arrays, e.g.
    ``jax.device_get(params)``) as torch tensors on ``device``."""
    dev = resolve_device(device)
    return unflatten({k: _to_torch(v, dev) for k, v in flatten(tree).items()})


def to_reference(params) -> Dict[str, Any]:
    """The port's params as the JAX package's tree of numpy arrays.  bf16
    leaves come back as float32 (an exact widening: numpy has no bf16)."""
    def one(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return unflatten({k: one(v) for k, v in flatten(params).items()})
