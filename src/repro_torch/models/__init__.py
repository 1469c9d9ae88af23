from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, build_model, padded_vocab

__all__ = ["ModelConfig", "Model", "build_model", "padded_vocab"]
