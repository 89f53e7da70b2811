"""yi-6b — llama-arch GQA dense LM [arXiv:2403.04652; hf].

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""
import dataclasses

from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    arch_id="yi-6b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab=64000,
)

SMOKE = dataclasses.replace(
    CONFIG, arch_id="yi-6b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160, vocab=256,
    user_embed_dim=32, dtype="float32",
)
