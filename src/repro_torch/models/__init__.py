"""Models of the port (``repro.models``): the ViT and dense-LM paths."""
from repro_torch.models.api import Model, build_model

__all__ = ["Model", "build_model"]
