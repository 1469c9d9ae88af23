from repro_torch.configs.registry import ARCHITECTURES, get_config, list_architectures

__all__ = ["ARCHITECTURES", "get_config", "list_architectures"]
