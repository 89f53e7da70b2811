"""granite-moe-1b-a400m — MoE LM, 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32e top-8.
"""
import dataclasses

from repro_torch.configs.base import LMConfig, MoEConfig

CONFIG = LMConfig(
    arch_id="granite-moe-1b-a400m",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=512, vocab=49155,
    moe=MoEConfig(n_experts=32, top_k=8),
)

SMOKE = dataclasses.replace(
    CONFIG, arch_id="granite-moe-1b-a400m-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64, vocab=256,
    moe=MoEConfig(n_experts=8, top_k=4),
    user_embed_dim=32, dtype="float32",
)
