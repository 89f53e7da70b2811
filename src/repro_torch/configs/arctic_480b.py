"""arctic-480b — MoE LM, 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base; hf].

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2, with a
dense FFN residual branch in parallel with the MoE block (Arctic's
dense-MoE hybrid).
"""
import dataclasses

from repro_torch.configs.base import LMConfig, MoEConfig

CONFIG = LMConfig(
    arch_id="arctic-480b",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000,
    moe=MoEConfig(n_experts=128, top_k=2, dense_residual=True),
)

SMOKE = dataclasses.replace(
    CONFIG, arch_id="arctic-480b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab=256,
    moe=MoEConfig(n_experts=8, top_k=2, dense_residual=True),
    user_embed_dim=32, dtype="float32",
)
