"""mamba2-780m [ssm]: 48L d_model=1536 (attn-free) vocab=50280,
ssm_state=128 — SSD state-space duality [arXiv:2405.21060; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab=50280, ssm_state=128, ssm_expand=2, ssm_headdim=64,
)
