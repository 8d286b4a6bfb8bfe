"""Model definitions of the port (dense GQA, MoE, SSM, hybrid and VLM
families; the encoder-decoder)."""

from repro_torch.models.api import build_model
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import LM

__all__ = ["EncDecLM", "LM", "build_model"]
