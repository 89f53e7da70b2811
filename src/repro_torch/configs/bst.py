"""bst — Behavior Sequence Transformer (Alibaba) [arXiv:1905.06874; paper].

embed_dim=32 seq_len=20 n_blocks=1 n_heads=8 mlp=1024-512-256
interaction=transformer-seq.
"""
import dataclasses

from repro_torch.configs.base import RecsysConfig

CONFIG = RecsysConfig(
    arch_id="bst", interaction="transformer-seq",
    embed_dim=32, seq_len=20, n_blocks=1, n_heads=8, mlp=(1024, 512, 256),
    vocab=1_000_000,
)

SMOKE = dataclasses.replace(
    CONFIG, arch_id="bst-smoke",
    embed_dim=8, seq_len=6, n_blocks=1, n_heads=2, mlp=(32, 16), vocab=512,
)
