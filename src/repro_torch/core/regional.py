"""Regional serving on the device: the drain test at paper scale
(§3.6–3.7, Fig. 10).

Twin of ``repro/core/regional.py``. R regions become a leading axis over
the multi-model cache tier: :class:`RegionalServer` replicates the
M-model registry R times and fronts ONE ``MultiModelServer`` over the R*M
combined slots, so a request routed to region ``r`` for model ``m`` serves
combined slot ``r*M + m`` and every probe, insert, flush and counter is
the multi-model tier's (one ``cache_probe_dual_multi`` launch a step).

Sticky routing lives on the device:

* the **home-region table** is an int32 (n_users,) plane (-1 =
  unassigned) in :class:`RegionalState`, written IN PLACE each step with
  one ``index_put_``: users re-home lazily (only when routed while their
  home is drained) and permanently;
* the **drain mask**, **drain epoch** and **event base** are staged per
  step as (S, R) / (S,) / (S,) inputs (:func:`stage_drain_schedule`,
  :func:`event_bases`), so a drain replays through chunked ``serve_many``
  calls (on the card one CUDA graph a chunk shape) with no host sync;
* the routing draws are counter-keyed hashes (``hashing.hash_u32`` with
  hi = counter, lo = uid), the avalanche the host router's "hash" sampler
  computes, so the numpy ``RegionRouter`` replays them bit for bit:
  re-homes are keyed by the drain epoch (duplicates of a user in a batch
  agree without a sequential pass), excursions by the global event index.

torch has no uint32 arithmetic: ``hash_u32`` returns the unsigned value
in an int64 tensor, and the modulo, the excursion threshold and the
event index (which wraps at 2**32, like the host oracle's) all act on
that unsigned value.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import server as server_lib
from repro_torch.core.cache import resolve_device
from repro_torch.core.config import CacheConfig
from repro_torch.core.hashing import Key64, hash_u32
from repro_torch.core.regions import (AllRegionsDrainedError, EXC_SALT,
                                      HOME_SALT, TGT_SALT,
                                      excursion_threshold)

_M32 = 0xFFFFFFFF


def _salted(seed: int, salt: int) -> int:
    return (seed + salt) & _M32


class RegionalState(NamedTuple):
    home: torch.Tensor                  # (n_users,) int32; -1 = unassigned
    inner: server_lib.MultiServerState  # stacked (R*M)-slot tier


def route_batch(home, uids, drained, epoch, event_base, *,
                locality: float, seed: int):
    """One step of sticky routing on the device, no host sync.

    ``home`` (U,) int32 table, written IN PLACE; ``uids`` (B,) int32;
    ``drained`` (R,) bool; ``epoch`` / ``event_base`` int32 0-d tensors
    (staged). Returns ``(regions (B,) int32, home, rehomed, excursions)``.
    The caller guarantees a live region (:func:`stage_drain_schedule`
    raises otherwise)."""
    dev = home.device
    uids = torch.as_tensor(uids, dtype=torch.int32, device=dev)
    R = drained.shape[0]
    B = uids.shape[0]
    region_iota = torch.arange(R, dtype=torch.int32, device=dev)
    # live regions ascending, drained ones pushed past the end as R
    live_sorted = torch.sort(torch.where(drained, R, region_iota)).values
    n_live = (~drained).sum()                                  # int64

    # lazy re-home of the rows whose home is unassigned or drained, keyed
    # by (uid, drain epoch): duplicates of a user pick the same home
    u = uids.long()
    cur = home[u]
    invalid = (cur < 0) | drained[cur.clamp(0, R - 1).long()]
    aux = torch.as_tensor(epoch, dtype=torch.int32, device=dev).expand(B)
    h = hash_u32(Key64(hi=aux, lo=uids), _salted(seed, HOME_SALT))
    fresh = live_sorted[h % n_live]
    homes = torch.where(invalid, fresh, cur)
    # duplicates write the same value (keyed by uid and epoch)
    home.index_put_((u,), homes)
    rehomed = invalid.sum(dtype=torch.int32)

    if locality >= 1.0:
        return homes, home, rehomed, torch.zeros_like(rehomed)

    # cross-region excursion: coin and target keyed by the global event
    # index (unsigned, wrapping at 2**32); the target skips the home's
    # rank among the live regions, so an excursion never lands home
    ev = (torch.as_tensor(event_base, dtype=torch.int32, device=dev).long()
          + torch.arange(B, dtype=torch.int64, device=dev)) & _M32
    key = Key64(hi=ev, lo=uids)
    coin = hash_u32(key, _salted(seed, EXC_SALT))
    n_others = n_live - 1
    exc = (coin >= excursion_threshold(locality)) & (n_others > 0)
    j = hash_u32(key, _salted(seed, TGT_SALT)) % n_others.clamp(min=1)
    hrank = torch.searchsorted(live_sorted, homes)
    j = j + (j >= hrank).long()
    # with one live region j may pass the table where exc is False (the
    # reference's gather clamps there); the clamp changes no used row
    regions = torch.where(exc, live_sorted[j.clamp(max=R - 1)], homes)
    return regions, home, rehomed, exc.sum(dtype=torch.int32)


def stage_drain_schedule(n_steps: int, n_regions: int,
                         events: Sequence[Tuple[int, str, int]] = (),
                         device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage a drain/undrain schedule as per-step inputs on ``device``.

    ``events`` is a sequence of ``(step, op, region)``, op in {"drain",
    "undrain"}, applied BEFORE serving that step; each bumps the drain
    epoch, as the host router's counter does. Returns ``(drained (S, R)
    bool, epoch (S,) int32)``; raises :class:`AllRegionsDrainedError`
    here if a step would have no live region."""
    by_step: dict = {}
    for step, op, region in events:
        if not 0 <= int(step) < n_steps:
            raise ValueError(f"event step {step} outside [0, {n_steps})")
        if not 0 <= int(region) < n_regions:
            raise ValueError(f"event region {region} outside "
                             f"[0, {n_regions})")
        by_step.setdefault(int(step), []).append((op, int(region)))
    drained = np.zeros((n_steps, n_regions), bool)
    epoch = np.zeros((n_steps,), np.int32)
    cur = np.zeros((n_regions,), bool)
    ep = 0
    for s in range(n_steps):
        for op, r in by_step.get(s, ()):
            if op == "drain":
                cur[r] = True
            elif op == "undrain":
                cur[r] = False
            else:
                raise ValueError(f"unknown drain op {op!r}")
            ep += 1
        if cur.all():
            raise AllRegionsDrainedError(
                f"step {s}: all {n_regions} regions drained")
        drained[s] = cur
        epoch[s] = ep
    device = resolve_device(device)
    return (torch.as_tensor(drained, device=device),
            torch.as_tensor(epoch, device=device))


def event_bases(start_event: int, n_steps: int, batch: int,
                device="cuda") -> torch.Tensor:
    """(S,) int32 global-event-index bases (step s covers events
    ``base[s] .. base[s]+B-1``), wrapping at 2**32: the int32 bits of the
    uint32 value, as the routing hash and the host oracle read it."""
    e = (int(start_event)
         + np.arange(n_steps, dtype=np.int64) * int(batch)) & _M32
    return torch.as_tensor(e.astype(np.uint32).view(np.int32),
                           device=resolve_device(device))


@dataclasses.dataclass(frozen=True)
class RegionalServer(server_lib._CompiledEntryPoints):
    """R regions over the M-model tier as ONE stacked (R*M)-slot server.

    ``cfgs`` is the per-model registry (M entries), replicated R times
    region-major: region ``r`` / model ``m`` is combined slot ``r*M + m``,
    and per-region counters are the inherited (R*M,) per-model counters
    reshaped to (R, M) (:meth:`per_region`). ``n_users`` sizes the home
    table; uids must lie in [0, n_users). ``jit_serve_step``,
    ``jit_serve_many`` and ``jit_flush`` are the servers' compiled entry
    points (CUDA graphs on a card state).
    """

    cfgs: Tuple[CacheConfig, ...]
    n_regions: int
    n_users: int
    tower_fn: Callable
    miss_budget: int
    locality: float = 0.98
    seed: int = 0
    fallback_value: float = 0.0
    backend: Optional[str] = None
    device: Any = "cuda"

    def __post_init__(self) -> None:
        if self.n_regions < 1:
            raise ValueError(f"n_regions must be >= 1, got {self.n_regions}")
        if self.n_users < 1:
            raise ValueError(f"n_users must be >= 1, got {self.n_users}")
        rep = tuple(c for _ in range(self.n_regions) for c in self.cfgs)
        object.__setattr__(self, "inner", server_lib.MultiModelServer(
            cfgs=rep, tower_fn=self.tower_fn, miss_budget=self.miss_budget,
            fallback_value=self.fallback_value, backend=self.backend,
            device=self.device))

    @property
    def n_models(self) -> int:
        return len(self.cfgs)

    def init_state(self, dtype=torch.float32, writebuf_capacity: int = 4096,
                   touchbuf_capacity: Optional[int] = None) -> RegionalState:
        device = resolve_device(self.device)
        return RegionalState(
            home=torch.full((self.n_users,), -1, dtype=torch.int32,
                            device=device),
            inner=server_lib.init_multi_server_state(
                self.inner.cfgs, dtype, writebuf_capacity,
                touchbuf_capacity, device=device))

    def per_region(self, per_model_counter, n_regions: Optional[int] = None):
        """Reshape an inherited (R*M,) per-model counter to (R, M)."""
        R = self.n_regions if n_regions is None else n_regions
        return per_model_counter.reshape(R, self.n_models)

    # ----------------------------------------------------------------- serve
    def serve_step(self, params, state: RegionalState, uids, slots,
                   keys: Key64, features, now_ms, drained, epoch,
                   event_base,
                   failure_mask: Optional[torch.Tensor] = None
                   ) -> server_lib.ServeResult:
        """Route one mixed batch, then serve it on the stacked tier.

        ``uids`` (B,) int32 routes each request (``keys`` stays the cache
        identity); ``slots`` (B,) picks each request's model within its
        region; ``drained`` (R,) bool and the ``epoch`` / ``event_base``
        0-d tensors come from :func:`stage_drain_schedule` /
        :func:`event_bases`. The stats gain the ``rehomed`` /
        ``excursions`` routing counters."""
        regions, home, rehomed, excursions = route_batch(
            state.home, uids, drained, epoch, event_base,
            locality=self.locality, seed=self.seed)
        slots = torch.as_tensor(slots, dtype=torch.int32,
                                device=regions.device)
        combined = regions.to(torch.int32) * self.n_models + slots
        res = self.inner.serve_step(params, state.inner, combined, keys,
                                    features, now_ms, failure_mask)
        stats = dict(res.stats)
        stats["rehomed"] = rehomed
        stats["excursions"] = excursions
        return server_lib.ServeResult(
            embeddings=res.embeddings, source=res.source, age_ms=res.age_ms,
            state=RegionalState(home=home, inner=res.state), stats=stats)

    # ------------------------------------------------------------ serve_many
    def serve_many(self, params, state: RegionalState, uids, slots,
                   keys: Key64, features, now_ms, drained, epoch,
                   event_base, failure_mask: Optional[torch.Tensor] = None,
                   *, flush_every: int = 1, collect: bool = True):
        """S routed serve steps over a staged (S, B) stream plus the
        (S, R) / (S,) / (S,) drain inputs, counters on the device (one
        fetch a call)."""
        dev = keys.hi.device
        now_ms = torch.as_tensor(now_ms, dtype=torch.int32, device=dev)
        uids = torch.as_tensor(uids, dtype=torch.int32, device=dev)
        slots = torch.as_tensor(slots, dtype=torch.int32, device=dev)
        if failure_mask is None:
            failure_mask = torch.zeros(keys.hi.shape, dtype=torch.bool,
                                       device=dev)

        def step(st, i):
            return self.serve_step(
                params, st, uids[i], slots[i], Key64(keys.hi[i], keys.lo[i]),
                server_lib.take_rows(features, i), now_ms[i], drained[i],
                epoch[i], event_base[i], failure_mask[i])

        acc = server_lib._zero_acc(dev, self.inner.n_models)
        acc["rehomed"] = torch.zeros((), dtype=torch.int32, device=dev)
        acc["excursions"] = torch.zeros((), dtype=torch.int32, device=dev)
        return server_lib._serve_many_loop(
            step, lambda st, i: self.flush(st, now_ms[i]), state,
            now_ms.shape[0], acc, flush_every=int(flush_every),
            collect=collect)

    # ----------------------------------------------------------------- flush
    def flush(self, state: RegionalState, now_ms) -> RegionalState:
        """Drain the shared rings into every region's slabs (one insert
        plan across all R*M slots), IN PLACE; the home table passes
        through."""
        return RegionalState(home=state.home,
                             inner=self.inner.flush(state.inner, now_ms))


# ------------------------------------------------------------------ snapshot
def cache_image(state: RegionalState) -> dict:
    """Durable subset for warm restarts: the inner tier's image plus the
    home-region plane (a restore that forgot homes would re-spread every
    user)."""
    img = dict(server_lib.cache_image(state.inner))
    img["home"] = state.home
    return img


def with_cache_image(state: RegionalState, image: dict) -> RegionalState:
    """Graft a restored regional image onto a same-shape cold state."""
    image = dict(image)
    home = image.pop("home")
    return RegionalState(
        home=home, inner=server_lib.with_cache_image(state.inner, image))
