"""Chaos engine: composable fault schedules staged on the device as
per-step inputs of ``serve_many``.

Twin of ``repro/ft/chaos.py``. The paper's reliability claim (§3.6–3.7,
Table 3) is about *compounding* failures: an inference-failure burst
during a capacity outage while a cache shard is dark. A scenario, a list
of :class:`Fault` events with wall-clock windows, is compiled on the host
into per-step tensors (one leading (S,) axis per fault family) that ride
through ``serve_many`` beside the staged stream, so the whole timeline
replays in chunked calls (on the card one CUDA graph a chunk shape) with
one counter fetch a chunk and no per-step host sync. Invalid scenarios
raise at staging, never inside a step.

Fault families (windows are half-open ``[t0_ms, t1_ms)`` on the serve
clock):

* :class:`InferFailure`: per-model Bernoulli inference-failure bursts
  (``model=None`` hits every model).
* :class:`Outage`: a model's admission grant is forced to 0
  (``ratelimit.grant_from(blocked=...)``); every miss defers down the
  degradation chain.
* :class:`BucketBlackout`: a contiguous range of the direct tier's
  (pooled) bucket space goes dark: probes in the range miss and their
  inserts are dropped (counted); the failover tier absorbs the reads.
* :class:`FlushStall`: the folded flush stops; the rings ride through
  and drop their oldest records once full (counted).
* :class:`ClockSkew`: an offset added to the TTL ``now`` stream.

:class:`RetryPolicy` adds bounded retry-with-backoff inside the
admission budget: attempt r is evaluated at its backoff-shifted time
against the same timeline (a retry landing in an outage re-fails), and
every attempt that runs charges a token.

:func:`compile_schedule` is host numpy throughout, with the reference's
draws in the reference's order from the same ``default_rng(seed)``, so
the same faults give the same arrays; only its last step differs: it
makes tensors on ``device``.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.cache import resolve_device


# ---------------------------------------------------------------- fault spec
@dataclasses.dataclass(frozen=True)
class Fault:
    """A wall-clock fault window ``[t0_ms, t1_ms)``."""

    t0_ms: int
    t1_ms: int

    def active(self, now_ms: int) -> bool:
        return self.t0_ms <= now_ms < self.t1_ms


@dataclasses.dataclass(frozen=True)
class InferFailure(Fault):
    """Inference-failure burst: tower calls fail with ``rate`` inside the
    window (``model=None``: every model)."""

    rate: float = 1.0
    model: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Outage(Fault):
    """Full capacity outage for one model: admission grant forced to 0."""

    model: int = 0


@dataclasses.dataclass(frozen=True)
class BucketBlackout(Fault):
    """Direct-tier bucket range ``[lo, hi)`` (pooled index space on the
    multi-model tier) goes dark: probes miss, inserts drop."""

    lo: int = 0
    hi: int = 0


@dataclasses.dataclass(frozen=True)
class FlushStall(Fault):
    """The folded flush stops for the window (the rings absorb until
    full, then drop their oldest records, counted)."""


@dataclasses.dataclass(frozen=True)
class ClockSkew(Fault):
    """``skew_ms`` added to the TTL ``now`` stream inside the window."""

    skew_ms: int = 0


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry-with-backoff for failed inferences: attempt ``r``
    (1-based) of a step at wall time ``t`` is evaluated at ``t +
    backoff_ms * multiplier**(r-1)`` (outage windows force failure), and
    every attempt that runs charges one admission token."""

    max_retries: int = 2
    backoff_ms: int = 500
    multiplier: int = 2

    def attempt_offset_ms(self, r: int) -> int:
        """Backoff delay of 1-based attempt ``r`` after its serve step."""
        return int(self.backoff_ms * self.multiplier ** (r - 1))


# ------------------------------------------------------------- the schedule
class ChaosSchedule(NamedTuple):
    """A compiled scenario: per-step tensors on the device. ``serve_many``
    hands step i the row ``ChaosSchedule(*(x[i] for x in sched))``, the
    ``chaos`` argument of ``serve_step``."""

    fail: torch.Tensor          # (S, B) bool — first-attempt tower failures
    retry_fail: torch.Tensor    # (S, R, B) bool — per-attempt re-failures
    outage: torch.Tensor        # (S, M) bool — admission grant forced to 0
    blackout_lo: torch.Tensor   # (S,) int32 — dark bucket range [lo, hi)
    blackout_hi: torch.Tensor   # (S,) int32 — (lo == hi: no blackout)
    flush_off: torch.Tensor     # (S,) bool — skip the folded flush
    skew_ms: torch.Tensor       # (S,) int32 — clock skew on the now stream

    @property
    def n_steps(self) -> int:
        return self.fail.shape[0]

    @property
    def n_retries(self) -> int:
        return self.retry_fail.shape[1]


def slice_schedule(sched: ChaosSchedule, lo: int, hi: int) -> ChaosSchedule:
    """The ``[lo, hi)`` step span of a compiled schedule (views), what a
    chunked launcher hands each ``serve_many`` call."""
    return ChaosSchedule(*(x[lo:hi] for x in sched))


def skewed_now(sched: ChaosSchedule, now_ms) -> torch.Tensor:
    """The TTL clock the serve path runs on: the (S,) step clock plus the
    scenario's injected skew, int32 on the schedule's device."""
    now = torch.as_tensor(np.asarray(now_ms), dtype=torch.int32,
                          device=sched.skew_ms.device)
    return now + sched.skew_ms


def _check_window(f: Fault) -> None:
    if f.t1_ms <= f.t0_ms:
        raise ValueError(f"{type(f).__name__}: empty window "
                         f"[{f.t0_ms}, {f.t1_ms})")


def compile_schedule(faults: Sequence[Fault], now_ms,
                     batch: int, *, n_models: int = 1,
                     n_buckets: int, slots=None,
                     base_fail_rate: float = 0.0,
                     retry: Optional[RetryPolicy] = None,
                     seed: int = 0, device="cuda") -> ChaosSchedule:
    """Compile a scenario into per-step tensors on ``device``.

    ``now_ms`` is the (S,) serve clock BEFORE skew (the launcher serves
    on :func:`skewed_now`). ``slots`` is the (S, B) model-slot matrix (None:
    single-model, all slot 0). ``n_buckets`` is the direct tier's bucket
    count, POOLED (``M * n_buckets_stack``) on the multi-model tier,
    against which blackout ranges are checked. Invalid scenarios (empty
    windows, models or buckets out of range, overlapping blackouts or
    skews) raise here.
    """
    now = np.asarray(now_ms, np.int64)
    S = int(now.shape[0])
    if slots is None:
        slots_np = np.zeros((S, batch), np.int32)
    else:
        slots_np = np.asarray(slots, np.int32)
        if slots_np.shape != (S, batch):
            raise ValueError(f"slots shape {slots_np.shape} != {(S, batch)}")
        if slots_np.size and (slots_np.min() < 0
                              or slots_np.max() >= n_models):
            raise ValueError("slots reference models outside "
                             f"[0, {n_models})")

    by_family: dict = {InferFailure: [], Outage: [], BucketBlackout: [],
                       FlushStall: [], ClockSkew: []}
    for f in faults:
        _check_window(f)
        for fam, lst in by_family.items():
            if isinstance(f, fam):
                lst.append(f)
                break
        else:
            raise TypeError(f"unknown fault family: {type(f).__name__}")
    for f in by_family[InferFailure]:
        if not (0.0 <= f.rate <= 1.0):
            raise ValueError(f"InferFailure rate {f.rate} outside [0, 1]")
        if f.model is not None and not (0 <= f.model < n_models):
            raise ValueError(f"InferFailure model {f.model} outside "
                             f"[0, {n_models})")
    for f in by_family[Outage]:
        if not (0 <= f.model < n_models):
            raise ValueError(f"Outage model {f.model} outside "
                             f"[0, {n_models})")
    for f in by_family[BucketBlackout]:
        if not (0 <= f.lo < f.hi <= n_buckets):
            raise ValueError(f"BucketBlackout [{f.lo}, {f.hi}) outside "
                             f"[0, {n_buckets}]")

    def overlap(events) -> bool:
        spans = sorted((f.t0_ms, f.t1_ms) for f in events)
        return any(a[1] > b[0] for a, b in zip(spans, spans[1:]))

    # two simultaneous blackouts or skews have no single (lo, hi) or
    # offset a step: a scenario bug (bursts and outages compose)
    if overlap(by_family[BucketBlackout]):
        raise ValueError("overlapping BucketBlackout windows")
    if overlap(by_family[ClockSkew]):
        raise ValueError("overlapping ClockSkew windows")

    R = 0 if retry is None else int(retry.max_retries)
    if R < 0:
        raise ValueError(f"max_retries must be >= 0, got {R}")

    rng = np.random.default_rng(seed)

    def fail_rate_at(t: int) -> np.ndarray:
        """(M,) failure probability at wall time ``t``: the base rate,
        maxed with every active burst (the worst burst wins)."""
        rate = np.full(n_models, base_fail_rate, np.float64)
        for f in by_family[InferFailure]:
            if f.active(t):
                if f.model is None:
                    rate = np.maximum(rate, f.rate)
                else:
                    rate[f.model] = max(rate[f.model], f.rate)
        return rate

    def outage_at(t: int) -> np.ndarray:
        out = np.zeros(n_models, bool)
        for f in by_family[Outage]:
            if f.active(t):
                out[f.model] = True
        return out

    fail = np.zeros((S, batch), bool)
    retry_fail = np.zeros((S, R, batch), bool)
    outage = np.zeros((S, n_models), bool)
    bl_lo = np.zeros(S, np.int32)
    bl_hi = np.zeros(S, np.int32)
    flush_off = np.zeros(S, bool)
    skew = np.zeros(S, np.int32)
    for s in range(S):
        t = int(now[s])
        sl = slots_np[s]
        fail[s] = rng.uniform(size=batch) < fail_rate_at(t)[sl]
        for r in range(R):
            tr = t + retry.attempt_offset_ms(r + 1)
            # a retry landing in an outage window re-fails, whatever the draw
            retry_fail[s, r] = ((rng.uniform(size=batch)
                                 < fail_rate_at(tr)[sl])
                                | outage_at(tr)[sl])
        outage[s] = outage_at(t)
        for f in by_family[BucketBlackout]:
            if f.active(t):
                bl_lo[s], bl_hi[s] = f.lo, f.hi
        flush_off[s] = any(f.active(t) for f in by_family[FlushStall])
        for f in by_family[ClockSkew]:
            if f.active(t):
                skew[s] = f.skew_ms
    device = resolve_device(device)
    return ChaosSchedule(*(torch.as_tensor(a, device=device) for a in (
        fail, retry_fail, outage, bl_lo, bl_hi, flush_off, skew)))


def benign_schedule(n_steps: int, batch: int, *, n_models: int = 1,
                    device="cuda") -> ChaosSchedule:
    """An all-quiet schedule: every fault family staged but inactive.
    Serving with it is bit-identical to ``chaos=None``."""
    return compile_schedule([], np.zeros(n_steps, np.int64), batch,
                            n_models=n_models, n_buckets=1, device=device)


# ------------------------------------------------------- scenario presets
def preset_faults(name: str, horizon_ms: int, *, n_models: int = 1,
                  n_buckets: int, fail_rate: float = 0.9,
                  skew_ms: int = 90_000) -> List[Fault]:
    """The named scenarios of ``launch/serve.py --chaos``, all inside the
    middle ``[0.3, 0.6)`` of the horizon (a warm pre-fault baseline and a
    recovery tail around them):

    * ``incident``: one inference-failure burst across the registry.
    * ``cascade``: the burst plus a model-0 capacity outage, a blackout
      of the lower quarter of the (pooled) direct bucket space, a flush
      stall and forward clock skew, all overlapping.
    * ``rolling``: each model's capacity outage in turn, back to back.
    """
    lo = int(horizon_ms * 0.3)
    hi = int(horizon_ms * 0.6)
    if name == "incident":
        return [InferFailure(lo, hi, rate=fail_rate)]
    if name == "cascade":
        mid = (lo + hi) // 2
        return [
            InferFailure(lo, hi, rate=fail_rate),
            Outage(lo, mid, model=0),
            BucketBlackout(lo, hi, lo=0, hi=max(n_buckets // 4, 1)),
            FlushStall(lo, mid),
            ClockSkew(mid, hi, skew_ms=skew_ms),
        ]
    if name == "rolling":
        span = max((hi - lo) // n_models, 1)
        return [Outage(lo + m * span, min(lo + (m + 1) * span, hi), model=m)
                for m in range(n_models)]
    raise ValueError(f"unknown chaos scenario {name!r}; "
                     "presets: incident, cascade, rolling")


PRESETS = ("incident", "cascade", "rolling")


def fault_windows(faults: Sequence[Fault], horizon_ms: int
                  ) -> List[Tuple[int, int, str]]:
    """Cut ``[0, horizon_ms)`` at every fault edge: the degradation
    ledger's reporting windows, each labeled ``quiet`` or by the (sorted,
    deduped) fault families active inside it."""
    edges = {0, int(horizon_ms)}
    for f in faults:
        _check_window(f)
        edges.add(int(min(f.t0_ms, horizon_ms)))
        edges.add(int(min(f.t1_ms, horizon_ms)))
    cuts = sorted(e for e in edges if 0 <= e <= horizon_ms)
    out = []
    for a, b in zip(cuts, cuts[1:]):
        fams = sorted({type(f).__name__ for f in faults
                       if f.t0_ms < b and a < f.t1_ms})
        out.append((a, b, "+".join(fams) if fams else "quiet"))
    return out
