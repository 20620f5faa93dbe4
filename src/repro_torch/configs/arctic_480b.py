"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864,
vocab=32000, MoE 128 experts top-2 + dense FFN residual
[hf:Snowflake/snowflake-arctic-base; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=4864, vocab=32000, n_experts=128, top_k=2, moe_d_ff=4864,
    dense_residual=True, grad_accum=4,
)
