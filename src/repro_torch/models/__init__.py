from .api import Model, build_model
from .common import ModelConfig

__all__ = ["Model", "ModelConfig", "build_model"]
