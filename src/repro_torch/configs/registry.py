"""Architecture registry: ``get_config(<id>)`` resolution."""
from __future__ import annotations

from typing import Callable, Dict, List

from ..models.common import ModelConfig

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> List[str]:
    return sorted(_REGISTRY)
