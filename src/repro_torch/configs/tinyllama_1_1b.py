"""tinyllama-1.1b — llama2-arch small dense LM [arXiv:2401.02385; hf].

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.
"""
import dataclasses

from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    arch_id="tinyllama-1.1b",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=5632, vocab=32000,
)

SMOKE = dataclasses.replace(
    CONFIG, arch_id="tinyllama-1.1b-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=128, vocab=256,
    user_embed_dim=32, dtype="float32",
)
