"""gin-tu — Graph Isomorphism Network [arXiv:1810.00826; paper].

n_layers=5 d_hidden=64 aggregator=sum eps=learnable.
"""
import dataclasses

from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    arch_id="gin-tu",
    n_layers=5, d_hidden=64, aggregator="sum", learnable_eps=True,
)

SMOKE = dataclasses.replace(
    CONFIG, arch_id="gin-tu-smoke",
    n_layers=2, d_hidden=16, n_classes=4,
)
