"""mind — Multi-Interest Network with Dynamic routing
[arXiv:1904.08030; unverified].

embed_dim=64 n_interests=4 capsule_iters=3 interaction=multi-interest.
"""
import dataclasses

from repro_torch.configs.base import RecsysConfig

CONFIG = RecsysConfig(
    arch_id="mind", interaction="multi-interest",
    embed_dim=64, n_interests=4, capsule_iters=3, seq_len=50,
    vocab=1_000_000,
)

SMOKE = dataclasses.replace(
    CONFIG, arch_id="mind-smoke",
    embed_dim=16, n_interests=2, capsule_iters=2, seq_len=10, vocab=512,
)
