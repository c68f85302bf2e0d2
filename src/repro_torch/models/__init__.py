"""Models of the port (``repro.models``): the ViT, dense-LM and RWKV-6
paths."""
from repro_torch.models.api import Model, build_model

__all__ = ["Model", "build_model"]
