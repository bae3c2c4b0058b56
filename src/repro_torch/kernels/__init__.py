from .ops import glass_ffn, glass_ffn_rowwise, paged_attention

__all__ = ["glass_ffn", "glass_ffn_rowwise", "paged_attention"]
