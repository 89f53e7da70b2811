"""wide-deep — Wide & Deep Learning for Recommender Systems
[arXiv:1606.07792; paper]. (Cited by the ERCache paper itself as [1].)

n_sparse=40 embed_dim=32 mlp=1024-512-256 interaction=concat.
"""
import dataclasses

from repro_torch.configs.base import RecsysConfig

CONFIG = RecsysConfig(
    arch_id="wide-deep", interaction="concat",
    embed_dim=32, n_sparse=40, mlp=(1024, 512, 256),
    vocab=2_000_000,
)

SMOKE = dataclasses.replace(
    CONFIG, arch_id="wide-deep-smoke",
    embed_dim=8, n_sparse=6, mlp=(32, 16), vocab=1024,
)
