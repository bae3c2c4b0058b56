from .fusion import GlassConfig, glass_scores, ranks_ascending, select
from .glass import GlassParams, MaskSet, build_masks, compact_params

__all__ = [
    "GlassConfig", "GlassParams", "MaskSet", "build_masks", "compact_params", "glass_scores",
    "ranks_ascending", "select",
]
