from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, padded_vocab

__all__ = ["ModelConfig", "Model", "padded_vocab"]
