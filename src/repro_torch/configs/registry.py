"""--arch <id> registry over the 10 assigned architectures."""
from repro_torch.configs import (arctic_480b, internvl2_2b, mamba2_780m,
                                 mistral_nemo_12b, qwen1_5_4b, qwen1_5_32b,
                                 qwen3_32b, qwen3_moe_235b_a22b,
                                 seamless_m4t_large_v2, zamba2_1_2b)

ARCHS = {m.CONFIG.name: m.CONFIG for m in (
    seamless_m4t_large_v2, qwen3_moe_235b_a22b, arctic_480b, qwen1_5_4b,
    qwen1_5_32b, mistral_nemo_12b, qwen3_32b, internvl2_2b, mamba2_780m,
    zamba2_1_2b,
)}


def get(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
