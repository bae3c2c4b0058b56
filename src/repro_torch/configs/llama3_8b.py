"""Llama 3 8B [arXiv:2407.21783] — paper evaluation model (Tabs 2/3/5/6)."""
from ..models.common import ModelConfig
from .registry import register


@register("llama3-8b")
def llama3_8b() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=128256,
        ffn_act="silu",
        gated_ffn=True,
        rope_theta=500000.0,
        tie_embeddings=False,
        gqa_layout="repeated",
        norm_eps=1e-5,
    )
