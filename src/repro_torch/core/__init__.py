from .fusion import GlassConfig, glass_scores, ranks_ascending, select
from .glass import GlassParams, MaskSet, build_masks

__all__ = [
    "GlassConfig", "GlassParams", "MaskSet", "build_masks", "glass_scores",
    "ranks_ascending", "select",
]
