"""Models of the port (``repro.models``): the ViT, the LMs (dense, MoE,
MLA, RWKV-6 and Mamba stacks) and the encoder-decoder."""
from repro_torch.models.api import Model, build_model

__all__ = ["Model", "build_model"]
