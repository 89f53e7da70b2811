"""sasrec — Self-Attentive Sequential Recommendation [arXiv:1808.09781; paper].

embed_dim=50 n_blocks=2 n_heads=1 seq_len=50 interaction=self-attn-seq.
"""
import dataclasses

from repro_torch.configs.base import RecsysConfig

CONFIG = RecsysConfig(
    arch_id="sasrec", interaction="self-attn-seq",
    embed_dim=50, n_blocks=2, n_heads=1, seq_len=50,
    vocab=1_000_000,
)

SMOKE = dataclasses.replace(
    CONFIG, arch_id="sasrec-smoke",
    embed_dim=16, n_blocks=1, n_heads=1, seq_len=12, vocab=512,
)
