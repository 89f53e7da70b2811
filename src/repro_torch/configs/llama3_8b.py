"""llama3-8b — GQA dense LM, 128k vocab [arXiv:2407.21783; unverified].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
"""
import dataclasses

from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    arch_id="llama3-8b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256, rope_theta=500_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, arch_id="llama3-8b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=192, vocab=512,
    user_embed_dim=32, dtype="float32",
)
