"""Per-model cache configuration (paper §3.3, Table 1).

Twin of ``repro/core/config.py``: ``CacheConfig``, the registry and the
paper's production cells that the multi-model tier serves. The lookup
backend is ``"torch"`` (plain PyTorch ops, the port's oracle, any device)
or ``"cuda"`` (the hand-written kernels, CUDA tensors only).

ERCache lets every ranking model (or model *type*) opt in with its own TTL.
Production values from the paper's evaluation:

  * direct cache TTLs:   1–5 minutes (Table 2; NE-neutral up to 5 min, Table 4)
  * failover cache TTLs: 1–2 hours   (Table 3)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

MINUTE_MS = 60_000
HOUR_MS = 3_600_000
# "No TTL" sentinel for the relaxed failover probe: int32 max, so the
# freshness check `now - write_ts <= ttl` passes for every real entry.
NO_TTL_MS = 0x7FFFFFFF


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Table 1 of the paper, plus the failover TTL and sizing knobs."""

    model_id: int                       # unique id of the ranking model
    model_type: str                     # family, e.g. "ctr", "cvr"
    enable_flag: bool = True
    cache_ttl_ms: int = 5 * MINUTE_MS   # direct-cache TTL
    failover_ttl_ms: int = 1 * HOUR_MS  # failover-cache TTL
    # Device-resident sizing knobs (no memcache tier to hide capacity in):
    n_buckets: int = 1 << 14
    ways: int = 8
    value_dim: int = 64
    # Failover-cache sizing. The paper gives the failover tier its own
    # capacity/TTL settings (§4.4); None → same as the direct cache.
    failover_n_buckets: Optional[int] = None
    failover_ways: Optional[int] = None
    # serving-tier provisioning: max tower inferences per serve batch,
    # as a fraction of the batch (see core/server.py miss-budget compaction).
    miss_budget_frac: float = 0.75
    # Lookup execution backend: "torch" (plain ops, bit-exact oracle) or
    # "cuda" (the hand-written probe kernels, csrc/cache_probe.cu).
    backend: str = "cuda"
    # Eviction policy (paper §3.3): "ttl" — TTL-priority (empty > expired >
    # oldest, the paper's default) or "lru" — LRU-timestamp (empty > least-
    # recently-used). Selectable per model in the multi-model tier.
    eviction: str = "ttl"
    # Record last-access bumps for this model's hits (the touch buffer →
    # last_access_ts recency plane). None resolves to (eviction == "lru"):
    # LRU models need access recency to be LRU at all; TTL-priority models
    # never rank on it, so recording touches for them is pure overhead.
    touch: Optional[bool] = None
    # SLA-aware admission control (DESIGN.md §8). ``infer_budget_per_step``
    # is this model's tower-inference token budget per serve step (the
    # paper's inference capacity as a provisioned rate; fractional rates
    # accumulate — 0.25 grants one inference every 4th step). None disables
    # admission control: every miss inside the miss-budget window runs the
    # tower, exactly the pre-admission behavior.
    infer_budget_per_step: Optional[float] = None
    # TTL (ms) the failover tier serves at on the admission degradation
    # path (deferred / failed / overflowed misses). None = no TTL: any
    # entry the failover still holds is served, however stale — trading
    # staleness for SLA compliance, the paper's failover rationale. Only
    # consulted when admission control is on; must be >= failover_ttl_ms.
    failover_ttl_relax: Optional[int] = None
    # In-batch inference coalescing (DESIGN.md §9): dedupe this model's
    # admitted-miss keys within each serve batch, run the user tower ONCE
    # per distinct user, and broadcast the embedding to the duplicate
    # queries. Tower FLOPs and budget tokens are charged per UNIQUE
    # inference, so skewed (Zipf) traffic pays sublinearly. Off by
    # default: the uncoalesced path is the bit-exact legacy behavior,
    # and coalescing assumes user-tower features are a function of the
    # user (duplicates serve the representative's embedding).
    coalesce_misses: bool = False
    # Which tiers the async flush populates: "dual" (default — every
    # computed embedding warms BOTH the direct and the failover slab, so
    # the failover can actually assist) or "off" (direct-only; the
    # failover slab stays cold). "off" is a deliberate opt-out for
    # probe-only experiments; combining it with admission control is a
    # configuration error — the degradation chain would silently degrade
    # straight to default embeddings.
    failover_write: str = "dual"

    def __post_init__(self) -> None:
        if self.backend not in ("torch", "cuda"):
            raise ValueError(
                f"backend must be 'torch' or 'cuda', got {self.backend!r}")
        if self.eviction not in ("ttl", "lru"):
            raise ValueError(
                f"eviction must be 'ttl' or 'lru', got {self.eviction!r}")
        if self.failover_write not in ("dual", "off"):
            raise ValueError("failover_write must be 'dual' or 'off', "
                             f"got {self.failover_write!r}")
        if self.infer_budget_per_step is not None:
            if self.infer_budget_per_step <= 0:
                raise ValueError("infer_budget_per_step must be > 0 "
                                 f"(got {self.infer_budget_per_step}); use "
                                 "None to disable admission control")
            if self.failover_write == "off":
                raise ValueError(
                    "admission control (infer_budget_per_step="
                    f"{self.infer_budget_per_step}) requires "
                    "failover_write='dual': with the failover slab never "
                    "written, deferred misses would silently degrade "
                    "straight to default embeddings")
        if (self.failover_ttl_relax is not None
                and self.failover_ttl_relax < self.failover_ttl_ms):
            raise ValueError(
                f"failover_ttl_relax ({self.failover_ttl_relax}) must be >= "
                f"failover_ttl_ms ({self.failover_ttl_ms}): the relaxed "
                "degradation-path TTL can only loosen the strict one")

    def resolved_touch(self) -> bool:
        return (self.eviction == "lru") if self.touch is None else self.touch

    def resolved_failover_n_buckets(self) -> int:
        return (self.n_buckets if self.failover_n_buckets is None
                else self.failover_n_buckets)

    def resolved_failover_ways(self) -> int:
        return self.ways if self.failover_ways is None else self.failover_ways

    def resolved_failover_relax_ttl_ms(self) -> int:
        """The TTL the failover tier is PROBED at on the serve path.

        Without admission control the degradation path doesn't exist, so
        the probe validates at the strict failover TTL. With it, deferred
        misses serve at ``failover_ttl_relax`` (None → no TTL at all,
        ``NO_TTL_MS``); strict-TTL hits are recovered from the relaxed
        probe's age, so one dual dispatch still covers both.
        """
        if self.infer_budget_per_step is None:
            return self.failover_ttl_ms
        if self.failover_ttl_relax is None:
            return NO_TTL_MS
        return self.failover_ttl_relax


@dataclasses.dataclass(frozen=True)
class StageConfig:
    """A (model, ranking-stage) pair (paper Fig. 5: retrieval / first /
    second stages)."""

    stage: str                          # "retrieval" | "first" | "second"
    cache: CacheConfig


class CacheConfigRegistry:
    """enable/lookup by model_id with model_type fallback (paper Table 1:
    caching can be enabled per model id OR per model type)."""

    def __init__(self) -> None:
        self._by_id: Dict[int, CacheConfig] = {}
        self._by_type: Dict[str, CacheConfig] = {}

    def register(self, cfg: CacheConfig) -> None:
        self._by_id[cfg.model_id] = cfg

    def register_type(self, cfg: CacheConfig) -> None:
        self._by_type[cfg.model_type] = cfg

    def get(self, model_id: int, model_type: Optional[str] = None
            ) -> Optional[CacheConfig]:
        cfg = self._by_id.get(model_id)
        if cfg is None and model_type is not None:
            cfg = self._by_type.get(model_type)
        if cfg is not None and not cfg.enable_flag:
            return None
        return cfg


def paper_production_configs() -> Dict[str, StageConfig]:
    """The (task x stage) cells of Tables 2-3, with the paper's TTLs. The
    second-stage models (tightest freshness budgets, Table 4) run
    LRU-timestamp eviction; the others the TTL-priority default."""
    rows = [
        # (name, model_id, type, stage, direct ttl min, failover ttl h, evict)
        ("cvr_retrieval", 10, "cvr", "retrieval", 5, 1, "ttl"),
        ("ctr_retrieval", 11, "ctr", "retrieval", 5, 1, "ttl"),
        ("cvr_first_a", 12, "cvr", "first", 5, 1, "ttl"),
        ("cvr_first_b", 13, "cvr", "first", 5, 1, "ttl"),
        ("ctr_first_a", 14, "ctr", "first", 5, 1, "ttl"),
        ("ctr_first_b", 15, "ctr", "first", 5, 1, "ttl"),
        ("ctr_second", 16, "ctr", "second", 5, 2, "lru"),
        ("cvr_second", 17, "cvr", "second", 1, 2, "lru"),
    ]
    return {
        name: StageConfig(stage=stage, cache=CacheConfig(
            model_id=mid, model_type=mtype,
            cache_ttl_ms=ttl_min * MINUTE_MS,
            failover_ttl_ms=fo_h * HOUR_MS, eviction=evict))
        for name, mid, mtype, stage, ttl_min, fo_h, evict in rows}


def multi_model_tier_configs(value_dim: int = 64, n_buckets: int = 1 << 12,
                             ways: int = 8,
                             failover_n_buckets: Optional[int] = None
                             ) -> List[CacheConfig]:
    """The paper registry sized for one multi-model serving tier: every
    Table 2-3 cell, ordered by model_id, sharing value_dim and ways but
    keeping its own TTLs and eviction policy. Retrieval-stage models get a
    double-capacity DIRECT cache; the failover tier stays at
    ``failover_n_buckets`` (default: the base ``n_buckets``)."""
    fo_nb = n_buckets if failover_n_buckets is None else failover_n_buckets
    cfgs = [dataclasses.replace(
        cell.cache, value_dim=value_dim, ways=ways,
        n_buckets=n_buckets * 2 if cell.stage == "retrieval" else n_buckets,
        failover_n_buckets=fo_nb)
        for cell in paper_production_configs().values()]
    return sorted(cfgs, key=lambda c: c.model_id)
