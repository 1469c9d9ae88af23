"""Architecture registry: --arch <id> resolution for launch/ and tests."""

from repro_torch.configs.internlm2_1p8b import CONFIG as internlm2_1p8b
from repro_torch.configs.granite_20b import CONFIG as granite_20b
from repro_torch.configs.mistral_large_123b import CONFIG as mistral_large_123b
from repro_torch.configs.gemma_7b import CONFIG as gemma_7b
from repro_torch.configs.whisper_large_v3 import CONFIG as whisper_large_v3
from repro_torch.configs.granite_moe_1b import CONFIG as granite_moe_1b
from repro_torch.configs.olmoe_1b_7b import CONFIG as olmoe_1b_7b
from repro_torch.configs.hymba_1p5b import CONFIG as hymba_1p5b
from repro_torch.configs.llava_next_34b import CONFIG as llava_next_34b
from repro_torch.configs.rwkv6_7b import CONFIG as rwkv6_7b

ARCHITECTURES = {
    "internlm2-1.8b": internlm2_1p8b,
    "granite-20b": granite_20b,
    "mistral-large-123b": mistral_large_123b,
    "gemma-7b": gemma_7b,
    "whisper-large-v3": whisper_large_v3,
    "granite-moe-1b-a400m": granite_moe_1b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "hymba-1.5b": hymba_1p5b,
    "llava-next-34b": llava_next_34b,
    "rwkv6-7b": rwkv6_7b,
}


def get_config(arch: str):
    if arch not in ARCHITECTURES:
        raise KeyError(f"unknown --arch {arch!r}; known: {sorted(ARCHITECTURES)}")
    return ARCHITECTURES[arch]


def list_architectures():
    return sorted(ARCHITECTURES)
