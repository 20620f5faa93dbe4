"""seamless-m4t-large-v2 [audio]: enc-dec multimodal backbone
[arXiv:2308.11596; hf].  24L enc + 24L dec, d_model=1024, 16H (GQA kv=16),
d_ff=8192, vocab=256206.  Audio frontend is a stub: input_specs provides
precomputed frame embeddings (assignment rule)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, encoder_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=8192, vocab=256206,
    frontend="audio",
)
