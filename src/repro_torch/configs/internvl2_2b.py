"""internvl2-2b [vlm]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553 — InternViT + InternLM2 [arXiv:2404.16821; hf].
ViT frontend is a stub: input_specs provides 256 precomputed patch
embeddings per image (assignment rule)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab=92553, frontend="vision", frontend_len=256,
)
