from .ops import flash_attention, glass_ffn, glass_ffn_rowwise, local_stats, paged_attention

__all__ = ["flash_attention", "glass_ffn", "glass_ffn_rowwise", "local_stats", "paged_attention"]
