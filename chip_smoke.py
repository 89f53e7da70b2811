#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. **kernels**: build every CUDA kernel of the serve paths from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, all at once), then
   hold each against its plain PyTorch version at the serve paths' shapes
   (B=512 queries on 2**20 x 8-way tables of D=50 float32; the SASRec
   item gather on the 1,000,000 x 50 table; the multi-model probe on the
   8-model pooled tier of phase 4, strict and relaxed policy tables) and
   time both on the card.
2. **serve**: the full-width SASRec tower (``get_config("sasrec")``) behind
   ``CachedEmbeddingServer`` with ``backend="cuda"``: a cold and a warm
   chunk of ``serve_many`` over a generated stream, then a read-back
   ``lookup`` of the last batch. Asserts one dual-probe launch per step,
   bag-kernel launches, a warm hit rate above 0, and then replays the same
   stream with ``backend="torch"`` (float32 matmuls without TF32): sources,
   ages, counters and every cache plane must be bit-identical. A
   ``torch.profiler`` pass over one more warm chunk then reports where a
   serve step's time goes (device kernel time by group, idle share).
3. **entry point**: ``launch.serve.run_serving`` as a user calls it.
4. **multi**: the same tower behind ``MultiModelServer`` with
   ``backend="cuda"`` over the 8-model registry
   (``multi_model_tier_configs(value_dim=50, n_buckets=2**18)``: direct
   stack 8 x 2**19 x 8, failover stack 8 x 2**18 x 8), requests fanned out
   to the models round-robin as the launcher does: a cold and a warm
   chunk, ONE dual-multi launch per step, a warm hit rate above 0, then a
   ``backend="torch"`` replay bit-identical in sources, ages, every
   counter (per-model vectors included) and all planes of both stacked
   tiers, and a profile of one more warm chunk.
5. **multi entry point**: ``launch.serve.run_serving_multi``.

Each kernel's ``launches`` in the ``kernels`` line counts the run of its
own path: the single-model serve (phase 2) for the dual and one-table
probes and the bag, the multi-model serve (phase 4) for the multi-model
probe; the counts are reset just before each path and read just after.

Prints a ``kernels`` JSON line, the card's name and power limit, and ends
with ``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
when there is no CUDA card or no ``src/repro_torch`` beside this file.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
MIN = 60_000
BATCH = 512                        # RECSYS_SHAPES["serve_p99"]
N_BUCKETS, WAYS = 1 << 20, 8
MULTI_BUCKETS = 1 << 18            # per model; retrieval models get 2x


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def device_ms(fn, n: int = 40, reps: int = 5) -> float:
    """Median device time of one ``fn(i)`` call: the card is held by a
    spin kernel while the host enqueues ``n`` calls, so the events measure
    back-to-back device execution, not the host's launch rate."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(0)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(min(4e9 * host_s * n + 2e6, 4e9)))
        start.record()
        for i in range(n):
            fn(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


# ------------------------------------------------------------ phase 1
def populate(torch, C, Key64, gen_np, n_users, device):
    """A (2**20, 8) direct and failover pair holding ``n_users`` users:
    fresh, direct-expired (failover-fresh) and never-written keys."""
    direct = C.init_cache(N_BUCKETS, WAYS, 50, device=device)
    failover = C.init_cache(N_BUCKETS, WAYS, 50, device=device)
    ids = gen_np.choice(10 ** 9, size=n_users, replace=False)
    vals = torch.randn(n_users, 50, device=device)
    ts = torch.as_tensor(gen_np.integers(0, 4 * MIN, n_users).astype("int32"),
                         device=device)
    keys = Key64.from_int(ids, device=device)
    for lo in range(0, n_users, 65536):
        sl = slice(lo, lo + 65536)
        C.insert_dual(direct, failover, Key64(keys.hi[sl], keys.lo[sl]),
                      vals[sl], 4 * MIN, MIN, 60 * MIN, ts_ms=ts[sl])
    return direct, failover, ids


def probe_bytes(B, hits_d, hits_f, wd, wf, D, elem):
    """Least bytes of a dual probe: queries + buckets read, 3*W int32 of
    metadata per table, the winning row only on a hit, outputs written."""
    reads = B * 16 + B * 12 * (wd + wf) + (hits_d + hits_f) * D * elem
    writes = 2 * B * (1 + 4 + 4 + D * elem)
    return reads + writes


def multi_probe_bytes(B, hits_d, hits_f, wd, wf, D, elem, n_models):
    """Least bytes of a multi-model dual probe: the dual probe's plus a
    4-byte slot per query and the (M, 2) int32 policy table."""
    return probe_bytes(B, hits_d, hits_f, wd, wf, D, elem) + 4 * B \
        + 8 * n_models


def populate_multi(torch, C, Key64, rng, cfgs, n_users, device,
                   fo_ways=None):
    """The stacked pair of ``cfgs`` holding ``n_users`` (user, model)
    records written at ts in [0, 4 min), read at 6 min: fresh,
    direct-expired (failover-fresh) and, with other keys, never-written
    entries, across models whose direct TTLs differ (5 min, and 1 min for
    model 17)."""
    policy = C.policy_from_configs(cfgs, device)
    ways = max(c.ways for c in cfgs)
    direct = C.init_multi_cache([c.n_buckets for c in cfgs], ways, 50,
                                device=device)
    failover = C.init_multi_cache([c.resolved_failover_n_buckets()
                                   for c in cfgs], fo_ways or ways, 50,
                                  device=device)
    ids = rng.choice(10 ** 9, size=n_users, replace=False)
    slots = rng.integers(0, len(cfgs), n_users).astype("int32")
    keys = Key64.from_int(ids, device=device)
    slots_t = torch.as_tensor(slots, device=device)
    vals = torch.randn(n_users, 50, device=device)
    ts = torch.as_tensor(rng.integers(0, 4 * MIN, n_users).astype("int32"),
                         device=device)
    for lo in range(0, n_users, 65536):
        sl = slice(lo, lo + 65536)
        C.insert_dual_multi(direct, failover, policy, slots_t[sl],
                            Key64(keys.hi[sl], keys.lo[sl]), vals[sl],
                            4 * MIN, ts_ms=ts[sl])
    return policy, direct, failover, ids, slots


def kernels_dual_multi(torch, results):
    """The multi-model probe against its plain version on the 8-model
    pooled tier of phase 4, and its time on the card."""
    import numpy as np

    from repro_torch.core import cache as C
    from repro_torch.core.config import NO_TTL_MS, multi_model_tier_configs
    from repro_torch.core.hashing import Key64
    from repro_torch.kernels import cache_probe as pk
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    cfgs = multi_model_tier_configs(value_dim=50, n_buckets=MULTI_BUCKETS,
                                    ways=WAYS)
    M = len(cfgs)
    policy, direct, failover, ids, id_slots = populate_multi(
        torch, C, Key64, rng, cfgs, 200_000, dev)
    fd, ff = direct.flat(), failover.flat()
    strict = policy.table()
    relaxed = strict.clone()
    relaxed[:, 1] = NO_TTL_MS
    now = torch.tensor(6 * MIN, dtype=torch.int32, device=dev)

    def batch(i, b=BATCH):
        g = np.random.default_rng(300 + i)
        pick = g.integers(0, len(ids), b)
        stored = g.uniform(size=b) < 0.7
        q = np.where(stored, ids[pick], g.integers(10 ** 9, 2 * 10 ** 9, b))
        sl = np.where(stored, id_slots[pick], g.integers(0, M, b))
        k = Key64.from_int(q, device=dev)
        s = torch.as_tensor(sl.astype("int32"), device=dev)
        return (k, s) + C._pooled_bucket_pair(direct, failover, policy, s, k)

    err = [0.0]

    def check(got, want, what):
        for g_half, w_half in zip(got, want):
            for g, w in zip(g_half, w_half):
                if g.dtype != w.dtype or not torch.equal(g, w):
                    raise AssertionError(f"cache_probe_dual_multi disagrees "
                                         f"with its plain version {what}")
                if g.is_floating_point() and g.numel():
                    err[0] = max(err[0], float((g - w).abs().max()))

    for b in (BATCH, 509, 37, 1):
        k, s, bd, bf = batch(1000 + b, b)
        for name, table in (("strict", strict), ("relaxed", relaxed)):
            got = pk.cache_probe_dual_multi(*fd[:4], *ff[:4], k.hi, k.lo, s,
                                            bd, bf, table, now)
            torch.cuda.synchronize()
            want = ref.cache_probe_dual_multi_ref(*fd[:4], *ff[:4], k.hi,
                                                  k.lo, s, bd, bf, table, now)
            check(got, want, f"at B={b}, {name} policy")
        if b == BATCH:
            (hd, *_), (hf, *_) = want
            exp = ~hd & hf
            per_model = [int(hd[s == m].sum()) for m in range(M)]
            print(f"[kernels] multi probe mix at B={b}: direct hits "
                  f"{int(hd.sum())} (per model {per_model}), "
                  f"direct-expired {int(exp.sum())}, misses "
                  f"{int((~hd & ~hf).sum())}")
            if not (int(hd.sum()) and int(exp.sum())
                    and int((~hd & ~hf).sum())) or per_model[-1] != 0:
                raise AssertionError("multi probe population lacks a case")
    # hours later: the strict failover column has run out, NO_TTL_MS not
    k, s, bd, bf = batch(7)
    late = torch.tensor(3 * 60 * MIN, dtype=torch.int32, device=dev)
    fo_hits = []
    for table in (strict, relaxed):
        got = pk.cache_probe_dual_multi(*fd[:4], *ff[:4], k.hi, k.lo, s, bd,
                                        bf, table, late)
        check(got, ref.cache_probe_dual_multi_ref(
            *fd[:4], *ff[:4], k.hi, k.lo, s, bd, bf, table, late),
            "3 h later")
        fo_hits.append(int(got[1][0].sum()))
    if not fo_hits[0] == 0 < fo_hits[1]:
        raise AssertionError(f"relaxed policy column not honoured: "
                             f"{fo_hits}")
    # Wd != Wf on a small tier
    small = multi_model_tier_configs(value_dim=50, n_buckets=1 << 10,
                                     ways=WAYS)
    pol_s, sd, sf, sids, sslots = populate_multi(torch, C, Key64, rng,
                                                 small, 20_000, dev,
                                                 fo_ways=4)
    k = Key64.from_int(sids[:300], device=dev)
    s = torch.as_tensor(sslots[:300], device=dev)
    bd, bf = C._pooled_bucket_pair(sd, sf, pol_s, s, k)
    check(pk.cache_probe_dual_multi(*sd.flat()[:4], *sf.flat()[:4], k.hi,
                                    k.lo, s, bd, bf, pol_s.table(), now),
          ref.cache_probe_dual_multi_ref(*sd.flat()[:4], *sf.flat()[:4],
                                         k.hi, k.lo, s, bd, bf,
                                         pol_s.table(), now),
          "at Wd=8, Wf=4")
    print(f"[kernels] multi probe bit-exact vs plain at B=512/509/37/1 with "
          f"strict and NO_TTL_MS failover columns (8 models, direct "
          f"{tuple(direct.key_hi.shape)}, failover "
          f"{tuple(failover.key_hi.shape)} x D=50), 3 h later (failover "
          f"hits strict {fo_hits[0]}, relaxed {fo_hits[1]}), and at Wd=8 "
          f"Wf=4")

    batches = [batch(i) for i in range(40)]

    def multi_fn(i, table=strict):
        k, s, bd, bf = batches[i % len(batches)]
        return pk.cache_probe_dual_multi(*fd[:4], *ff[:4], k.hi, k.lo, s, bd,
                                         bf, table, now)

    def multi_plain(i):
        k, s, bd, bf = batches[i % len(batches)]
        return ref.cache_probe_dual_multi_ref(*fd[:4], *ff[:4], k.hi, k.lo,
                                              s, bd, bf, strict, now)

    hits = [multi_plain(i) for i in range(len(batches))]
    hd = statistics.mean(int(h[0][0].sum()) for h in hits)
    hf = statistics.mean(int(h[1][0].sum()) for h in hits)
    results["cache_probe_dual_multi"] = dict(
        name="cache_probe_dual_multi", route="cuda",
        source="src/repro_torch/csrc/cache_probe.cu",
        replaces="src/repro/kernels/cache_probe.py:526",
        max_abs_err=err[0], ms=device_ms(multi_fn),
        plain_ms=device_ms(multi_plain, n=10),
        bound_ms=multi_probe_bytes(BATCH, hd, hf, WAYS, WAYS, 50, 4, M)
        / HBM_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None)
    r = results["cache_probe_dual_multi"]
    print(f"[kernels] cache_probe_dual_multi: {r['ms'] * 1e3:.2f} us on the "
          f"card (plain {r['plain_ms'] * 1e3:.2f} us, bound "
          f"{r['bound_ms'] * 1e3:.3f} us by bytes; {hd:.1f} direct and "
          f"{hf:.1f} failover hits per batch)")


def phase_kernels(torch, results):
    import numpy as np

    from repro_torch.core import cache as C
    from repro_torch.core.hashing import Key64, bucket_index
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import cache_probe as pk
    from repro_torch.kernels import embedding_bag as ebk

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    libs = build.build()
    print(f"[build] {len(libs)} CUDA libraries for sm_90a in "
          f"{time.perf_counter() - t0:.1f}s")
    for name, path in libs.items():
        log = path.with_suffix(".log").read_text() if path.with_suffix(
            ".log").exists() else ""
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"[build] {name}: {'; '.join(regs) or 'cached'}")

    rng = np.random.default_rng(0)
    direct, failover, ids = populate(torch, C, Key64, rng, 200_000, dev)
    now = torch.tensor(4 * MIN, dtype=torch.int32, device=dev)

    def batch(i, b=BATCH):
        g = np.random.default_rng(100 + i)
        q = np.where(g.uniform(size=b) < 0.7, g.choice(ids, b),
                     g.integers(10 ** 9, 2 * 10 ** 9, b))
        k = Key64.from_int(q, device=dev)
        return k, bucket_index(k, N_BUCKETS), bucket_index(k, N_BUCKETS)

    batches = [batch(i) for i in range(40)]
    tabs_d = (direct.key_hi, direct.key_lo, direct.write_ts, direct.values)
    tabs_f = (failover.key_hi, failover.key_lo, failover.write_ts,
              failover.values)

    # -- correctness: dual and tiled vs the plain version, bit for bit
    max_err = {"cache_probe_dual": 0.0, "cache_probe_tiled": 0.0}
    for b in (BATCH, 509, 1, 37):
        k, bd, bf = batch(1000 + b, b)
        dual = pk.cache_probe_dual(*tabs_d, *tabs_f, k.hi, k.lo, bd, bf, now,
                                   MIN, 60 * MIN)
        tiled = pk.cache_probe_tiled(*tabs_d, k.hi, k.lo, bd, now, MIN)
        want_d = ref.cache_probe_ref(*tabs_d, k.hi, k.lo, bd, now, MIN)
        want_f = ref.cache_probe_ref(*tabs_f, k.hi, k.lo, bf, now, 60 * MIN)
        torch.cuda.synchronize()
        for got, want, name in ((dual[0], want_d, "cache_probe_dual"),
                                (dual[1], want_f, "cache_probe_dual"),
                                (tiled, want_d, "cache_probe_tiled")):
            for g, w in zip(got, want):
                if g.dtype != w.dtype or not torch.equal(g, w):
                    raise AssertionError(f"{name} disagrees with its plain "
                                         f"version at B={b}")
                if g.is_floating_point():
                    max_err[name] = max(max_err[name],
                                        float((g - w).abs().max()))
        if b == BATCH:
            hd, hf = int(want_d[0].sum()), int(want_f[0].sum())
            miss = int((~want_d[0] & ~want_f[0]).sum())
            exp = int((~want_d[0] & want_f[0]).sum())
            print(f"[kernels] probe mix at B={b}: direct hits {hd}, "
                  f"failover hits {hf} (direct-expired {exp}), misses "
                  f"{miss}")
            if not (hd and exp and miss):
                raise AssertionError("probe population lacks a case")
    # Wd != Wf and Nb_d != Nb_f
    small_d = C.init_cache(1 << 12, 8, 50, device=dev)
    small_f = C.init_cache(1 << 10, 4, 50, device=dev)
    k = Key64.from_int(rng.integers(0, 5000, 3000), device=dev)
    C.insert_dual(small_d, small_f, k, torch.randn(3000, 50, device=dev),
                  MIN, MIN, 60 * MIN)
    kq = Key64.from_int(rng.integers(0, 6000, 300), device=dev)
    bd, bf = bucket_index(kq, 1 << 12), bucket_index(kq, 1 << 10)
    got = pk.cache_probe_dual(*small_d[:4], *small_f[:4], kq.hi, kq.lo, bd,
                              bf, now, MIN, 60 * MIN)
    for g_half, w_half in zip(got, (
            ref.cache_probe_ref(*small_d[:4], kq.hi, kq.lo, bd, now, MIN),
            ref.cache_probe_ref(*small_f[:4], kq.hi, kq.lo, bf, now,
                                60 * MIN))):
        for g, w in zip(g_half, w_half):
            if not torch.equal(g, w):
                raise AssertionError("cache_probe_dual disagrees with its "
                                     "plain version at Wd=8, Wf=4")
    print("[kernels] probes bit-exact vs plain at B=512/509/37/1, "
          "and at Wd=8 Wf=4 Nb_d=4096 Nb_f=1024")

    # -- timing at the serve shape, a fresh batch per launch
    def dual_fn(i):
        k, bd, bf = batches[i % len(batches)]
        return pk.cache_probe_dual(*tabs_d, *tabs_f, k.hi, k.lo, bd, bf,
                                   now, MIN, 60 * MIN)

    def dual_plain(i):
        k, bd, bf = batches[i % len(batches)]
        return (ref.cache_probe_ref(*tabs_d, k.hi, k.lo, bd, now, MIN),
                ref.cache_probe_ref(*tabs_f, k.hi, k.lo, bf, now, 60 * MIN))

    def tiled_fn(i):
        k, bd, _ = batches[i % len(batches)]
        return pk.cache_probe_tiled(*tabs_d, k.hi, k.lo, bd, now, MIN)

    def tiled_plain(i):
        k, bd, _ = batches[i % len(batches)]
        return ref.cache_probe_ref(*tabs_d, k.hi, k.lo, bd, now, MIN)

    hits = [dual_plain(i) for i in range(len(batches))]
    hd = statistics.mean(int(h[0][0].sum()) for h in hits)
    hf = statistics.mean(int(h[1][0].sum()) for h in hits)
    dual_bytes = probe_bytes(BATCH, hd, hf, WAYS, WAYS, 50, 4)
    tiled_bytes = (BATCH * 12 + BATCH * 12 * WAYS + hd * 200
                   + BATCH * (9 + 200))
    results["cache_probe_dual"] = dict(
        name="cache_probe_dual", route="cuda",
        source="src/repro_torch/csrc/cache_probe.cu",
        replaces="src/repro/kernels/cache_probe.py:390",
        max_abs_err=max_err["cache_probe_dual"],
        ms=device_ms(dual_fn), plain_ms=device_ms(dual_plain, n=10),
        bound_ms=dual_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None)
    results["cache_probe_tiled"] = dict(
        name="cache_probe_tiled", route="cuda",
        source="src/repro_torch/csrc/cache_probe.cu",
        replaces="src/repro/kernels/cache_probe.py:228",
        max_abs_err=max_err["cache_probe_tiled"],
        ms=device_ms(tiled_fn), plain_ms=device_ms(tiled_plain, n=10),
        bound_ms=tiled_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None)

    # -- embedding_bag: the SASRec item gather on the (1M, 50) table
    gen = torch.Generator(device=dev).manual_seed(1)
    table = torch.randn(1_000_000, 50, generator=gen, device=dev) * 0.01
    n_bags = int(BATCH * 0.75) * 50      # miss_budget rows x seq_len
    bag_ids = [torch.randint(0, 1_000_000, (n_bags, 1), generator=gen,
                             device=dev, dtype=torch.int32)
               for _ in range(40)]
    err = 0.0
    for ids_, exact in ((bag_ids[0], True),
                        (torch.randint(0, 1_000_000, (25_600, 1),
                                       generator=gen, device=dev,
                                       dtype=torch.int32), True)):
        got = ebk.embedding_bag(table, ids_)
        if not torch.equal(got, ref.embedding_bag_ref(table, ids_)):
            raise AssertionError(f"embedding_bag nnz=1 not exact at "
                                 f"{ids_.shape[0]} bags")
    padded = torch.randint(0, 1_000_000, (25_600, 4), generator=gen,
                           device=dev, dtype=torch.int32)
    padded[torch.rand(padded.shape, generator=gen, device=dev) < 0.3] = -1
    for mode in ("sum", "mean"):
        got = ebk.embedding_bag(table, padded, mode=mode)
        want = ref.embedding_bag_ref(table, padded, mode=mode)
        # float32 sums of up to 4 rows in another order: one rounding
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
        err = max(err, float((got - want).abs().max()))
    print(f"[kernels] embedding_bag exact at nnz=1 ({n_bags} and 25600 "
          f"bags), nnz=4 with -1 pads within atol=rtol=1e-6 "
          f"(max |err| {err:.3g})")
    bag_bytes = n_bags * (4 + 50 * 4 + 50 * 4)
    ids_long = [i.long() for i in bag_ids]
    results["embedding_bag"] = dict(
        name="embedding_bag", route="cuda",
        source="src/repro_torch/csrc/embedding_bag.cu",
        replaces="src/repro/kernels/embedding_bag.py:53",
        max_abs_err=err,
        ms=device_ms(lambda i: ebk.embedding_bag(table, bag_ids[i % 40])),
        plain_ms=device_ms(lambda i: ref.embedding_bag_ref(
            table, bag_ids[i % 40]), n=10),
        bound_ms=bag_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=device_ms(lambda i: torch.nn.functional.embedding_bag(
            ids_long[i % 40], table, mode="sum")))
    for r in results.values():
        print(f"[kernels] {r['name']}: {r['ms'] * 1e3:.2f} us on the card "
              f"(plain {r['plain_ms'] * 1e3:.2f} us, bound "
              f"{r['bound_ms'] * 1e3:.3f} us by bytes"
              + (f", library {r['library_ms'] * 1e3:.2f} us"
                 if r["library_ms"] is not None else "") + ")")
    del direct, failover, table, small_d, small_f
    kernels_dual_multi(torch, results)


# ------------------------------------------------------------ phase 2
def staged_stream(torch, launch, features_of, dev, n_steps):
    from repro_torch.data.access_patterns import (FIG6_KNOTS,
                                                  InterArrivalDist,
                                                  StreamConfig,
                                                  generate_stream_fast)

    times, uids = generate_stream_fast(
        StreamConfig(n_users=20_000, horizon_s=600.0, seed=0),
        InterArrivalDist(FIG6_KNOTS))
    assert len(uids) >= n_steps * BATCH, len(uids)
    return launch._stage_chunk(uids, times, features_of, 0, n_steps, BATCH,
                               dev)


def _chunk_out(torch, out, ys, acc, t0, chunk, dim):
    """Record one serve_many chunk of a run: counters (the fetch syncs),
    host ms per step, sources, ages, finiteness and shape."""
    from repro_torch.core import server as srv

    out["chunks"].append(srv.fetch_counters(acc))
    out["step_ms"].append((time.perf_counter() - t0) * 1e3 / chunk)
    out["src"].append(ys[1])
    out["age"].append(ys[2])
    out["emb_finite"] &= bool(torch.isfinite(ys[0]).all())
    if tuple(ys[0].shape) != (chunk, BATCH, dim):
        raise AssertionError(f"embeddings shape {tuple(ys[0].shape)}")


def compare_runs(torch, a, b, what):
    """Sources, ages, counters and every plane of both tiers equal."""
    for x, y in zip(a["src"] + a["age"], b["src"] + b["age"]):
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: sources/ages differ between "
                                 "backends")
    if a["chunks"] != b["chunks"]:
        raise AssertionError(f"{what}: counters differ between backends")
    for tier in ("direct", "failover"):
        ta, tb = getattr(a["state"], tier), getattr(b["state"], tier)
        for name, x, y in zip(ta._fields, ta, tb):
            if not torch.equal(x, y):
                raise AssertionError(f"{what}: {tier}.{name} differs "
                                     "between backends")


def serve_run(torch, backend, stream, chunk):
    """Cold then warm chunk of serve_many + a read-back lookup of the last
    batch, at full SASRec width. Returns what the run produced, the
    server and its state."""
    from repro_torch.core import cache as C
    from repro_torch.core import server as srv
    from repro_torch.core.config import CacheConfig
    from repro_torch.core.hashing import Key64
    from repro_torch.launch import serve as launch

    dev = torch.device("cuda")
    tcfg, params, tower_fn, _ = launch.build_tower(
        "sasrec", backend=backend, device=dev, smoke=False, seed=0)
    cfg = CacheConfig(model_id=1, model_type="ctr", n_buckets=N_BUCKETS,
                      ways=WAYS, value_dim=tcfg.user_embed_dim,
                      miss_budget_frac=0.75, backend=backend)
    server = srv.CachedEmbeddingServer(
        cfg=cfg, tower_fn=tower_fn, miss_budget=int(BATCH * 0.75))
    state = srv.init_server_state(cfg, writebuf_capacity=BATCH * 4,
                                  device=dev)
    keys, feats, nows, _ = stream
    out = {"chunks": [], "src": [], "age": [], "step_ms": [],
           "emb_finite": True}
    for lo in range(0, 2 * chunk, chunk):
        sl = slice(lo, lo + chunk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, acc, ys = server.serve_many(
            params, state, Key64(keys.hi[sl], keys.lo[sl]),
            {k: v[sl] for k, v in feats.items()}, nows[sl], flush_every=1)
        _chunk_out(torch, out, ys, acc, t0, chunk, tcfg.user_embed_dim)
        last_emb = ys[0][-1]
    # read back the last batch: every computed row's write is acknowledged
    last = Key64(keys.hi[2 * chunk - 1], keys.lo[2 * chunk - 1])
    rb = C.lookup(state.direct, last, nows[2 * chunk - 1], cfg.cache_ttl_ms,
                  backend=backend)
    computed = out["src"][-1][-1] == srv.SRC_COMPUTED
    ids64 = (last.hi.long() << 32) | (last.lo.long() & 0xFFFFFFFF)
    _, inv, cnt = torch.unique(ids64, return_inverse=True,
                               return_counts=True)
    if not bool(rb.hit[computed].all()):
        raise AssertionError("a computed embedding was not read back")
    sel = computed & (cnt[inv] == 1)
    if not torch.equal(rb.values[sel], last_emb[sel]):
        raise AssertionError("read-back values differ from served ones")
    out.update(server=server, params=params, state=state)
    return out


def phase_serve(torch, counts):
    from repro_torch.configs import RECSYS_SHAPES
    from repro_torch.core.hashing import Key64
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch

    assert RECSYS_SHAPES["serve_p99"].batch == BATCH
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[serve] float32 matmuls without TF32 "
          "(torch.backends.cuda.matmul.allow_tf32 = False)")
    chunk = 32
    _, _, _, features_of = launch.build_tower("sasrec", backend="torch",
                                              device=dev, smoke=False)
    stream = staged_stream(torch, launch, features_of, dev, 3 * chunk)

    ops.reset_launch_counts()                    # this path's window
    cuda = serve_run(torch, "cuda", stream, chunk)
    n = ops.launch_counts()
    counts.update({k: n[k] for k in SERVE_KERNELS})
    steps = 2 * chunk
    if counts["cache_probe_dual"] != steps:
        raise AssertionError(f"{counts['cache_probe_dual']} dual-probe "
                             f"launches for {steps} serve steps")
    if min(counts.values()) <= 0 or n["cache_probe_dual_multi"]:
        raise AssertionError(f"kernel not launched on the path: {n}")
    cold, warm = cuda["chunks"]
    hit = [c["direct_hits"] / c["requests"] for c in cuda["chunks"]]
    print(f"[serve] SASRec full width (embed 50, 2 blocks, seq 50, vocab "
          f"1M), {N_BUCKETS}x{WAYS} tiers, B={BATCH}, miss_budget "
          f"{int(BATCH * 0.75)}: {steps} steps, launches {n}, hit rate "
          f"cold {hit[0]:.4f} warm {hit[1]:.4f}, tower inferences "
          f"{cold['tower_inferences']}+{warm['tower_inferences']}, "
          f"fallbacks {cold['fallbacks'] + warm['fallbacks']}; host ms per "
          f"step cold {cuda['step_ms'][0]:.2f} warm {cuda['step_ms'][1]:.2f}")
    if not hit[1] > 0:
        raise AssertionError("warm chunk has no direct hits")
    if not cuda["emb_finite"]:
        raise AssertionError("non-finite embeddings")

    plain = serve_run(torch, "torch", stream, chunk)
    print(f"[serve] torch-backend replay on the card: host ms per step cold "
          f"{plain['step_ms'][0]:.2f} warm {plain['step_ms'][1]:.2f}")
    compare_runs(torch, cuda, plain, "serve")
    print("[serve] cuda and torch backends bit-identical: sources, ages, "
          "counters, all 5 planes of both tiers")
    del plain
    keys, feats, nows, _ = stream
    sl = slice(2 * chunk, 3 * chunk)
    phase_profile(torch, "profile", chunk, lambda: cuda["server"].serve_many(
        cuda["params"], cuda["state"], Key64(keys.hi[sl], keys.lo[sl]),
        {k: v[sl] for k, v in feats.items()}, nows[sl], flush_every=1,
        collect=False)[1])


SERVE_KERNELS = ("cache_probe_dual", "cache_probe_tiled", "embedding_bag")
KERNEL_GROUPS = (("cache_probe", ("probe_kernel",)),
                 ("embedding_bag", ("bag_kernel",)),
                 ("matmul", ("gemm", "xmma", "cutlass", "sm90_")),
                 ("sort", ("sort", "radix", "cub::")),
                 ("index/scatter", ("index", "scatter", "gather")),
                 ("reduce", ("reduce",)),
                 ("elementwise", ("elementwise", "vectorized")),
                 ("memcpy/memset", ("memcpy", "memset")))


def phase_profile(torch, tag, chunk, drive):
    """Where a warm serve step's time goes: torch.profiler over one more
    chunk of a cuda run (``drive()`` continues its state and returns the
    chunk's device counters), device kernel time by group against the
    host wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import server as srv

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        srv.fetch_counters(drive())
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"[{tag}] device time not measured (the profiler recorded "
              "no CUDA events)")
        return
    by_group, by_name = {}, {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        low = e.name.lower()
        group = next((g for g, keys_ in KERNEL_GROUPS
                      if any(k in low for k in keys_)), "other")
        by_group[group] = by_group.get(group, 0.0) + us
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + us
    busy_ms = sum(by_group.values()) / 1e3
    print(f"[{tag}] warm chunk of {chunk} steps under torch.profiler: "
          f"{wall_ms / chunk:.3f} ms host wall per step, "
          f"{busy_ms / chunk:.3f} ms device kernel time per step, device "
          f"idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{len(kernels) / chunk:.0f} device ops per step")
    print(f"[{tag}] device us per step by group: " + ", ".join(
        f"{g} {us / chunk:.1f}" for g, us in sorted(
            by_group.items(), key=lambda kv: -kv[1])))
    print(f"[{tag}] top device ops, us per step: " + "; ".join(
        f"{n} {us / chunk:.1f}" for n, us in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:6]))


# ------------------------------------------------------------ phase 3
def phase_entry(torch):
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch

    ops.reset_launch_counts()
    d = launch.run_serving(arch="sasrec", minutes=8, users=400,
                           backend="cuda", log=lambda s: print(f"[entry] {s}"))
    n = ops.launch_counts()
    if (n["cache_probe_dual"] != d["batches"] or n["embedding_bag"] <= 0
            or d["requests"] <= 0):
        raise AssertionError(f"entry point: {d['batches']} batches, "
                             f"launches {n}")


# ------------------------------------------------------------ phase 4
MULTI_KERNELS = ("cache_probe_dual_multi",)


def multi_run(torch, backend, stream, slots, chunk):
    """Cold then warm chunk of the multi-model serve_many at full SASRec
    width over the 8-model registry. Returns what the run produced, the
    server and its state."""
    import dataclasses

    from repro_torch.core import server as srv
    from repro_torch.core.config import multi_model_tier_configs
    from repro_torch.core.hashing import Key64
    from repro_torch.launch import serve as launch

    dev = torch.device("cuda")
    tcfg, params, tower_fn, _ = launch.build_tower(
        "sasrec", backend=backend, device=dev, smoke=False, seed=0)
    cfgs = [dataclasses.replace(c, backend=backend)
            for c in multi_model_tier_configs(
                value_dim=tcfg.user_embed_dim, n_buckets=MULTI_BUCKETS)]
    server = srv.MultiModelServer(cfgs=tuple(cfgs), tower_fn=tower_fn,
                                  miss_budget=int(BATCH * 0.75), device=dev)
    state = srv.init_multi_server_state(cfgs, writebuf_capacity=BATCH * 4,
                                        device=dev)
    keys, feats, nows, _ = stream
    out = {"chunks": [], "src": [], "age": [], "step_ms": [],
           "emb_finite": True}
    for lo in range(0, 2 * chunk, chunk):
        sl = slice(lo, lo + chunk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, acc, ys = server.serve_many(
            params, state, slots[sl], Key64(keys.hi[sl], keys.lo[sl]),
            {k: v[sl] for k, v in feats.items()}, nows[sl], flush_every=1)
        _chunk_out(torch, out, ys, acc, t0, chunk, tcfg.user_embed_dim)
    out.update(server=server, params=params, state=state, cfgs=cfgs)
    return out


def phase_multi(torch, counts):
    import numpy as np

    from repro_torch.core.hashing import Key64
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch

    dev = torch.device("cuda")
    chunk = 32
    _, _, _, features_of = launch.build_tower("sasrec", backend="torch",
                                              device=dev, smoke=False)
    stream = staged_stream(torch, launch, features_of, dev, 3 * chunk)
    # the launcher's fan-out: request b of batch i goes to model (b + i) % M
    slots = torch.as_tensor(
        (np.arange(BATCH)[None, :] + np.arange(3 * chunk)[:, None]) % 8,
        dtype=torch.int32, device=dev)

    ops.reset_launch_counts()                    # this path's window
    cuda = multi_run(torch, "cuda", stream, slots, chunk)
    n = ops.launch_counts()
    counts.update({k: n[k] for k in MULTI_KERNELS})
    steps = 2 * chunk
    if n["cache_probe_dual_multi"] != steps or n["cache_probe_dual"]:
        raise AssertionError(f"launches {n} for {steps} multi-model serve "
                             "steps: want one dual-multi launch per step")
    if n["embedding_bag"] <= 0:
        raise AssertionError(f"bag kernel not launched on the path: {n}")
    cold, warm = cuda["chunks"]
    hit = [c["direct_hits"] / c["requests"] for c in cuda["chunks"]]
    for c in cuda["chunks"]:
        if sum(c["per_model_requests"]) != c["requests"]:
            raise AssertionError("per-model requests do not sum to the "
                                 "total")
    d, f = cuda["state"].direct, cuda["state"].failover
    print(f"[multi] SASRec full width, 8 models, direct stack "
          f"{tuple(d.key_hi.shape)} failover stack {tuple(f.key_hi.shape)} "
          f"x D=50 float32 ({sum(t.nbytes for t in d) / 1e9:.2f} + "
          f"{sum(t.nbytes for t in f) / 1e9:.2f} GB), B={BATCH}, miss_budget "
          f"{int(BATCH * 0.75)}: {steps} steps, launches {n}, hit rate cold "
          f"{hit[0]:.4f} warm {hit[1]:.4f}, tower inferences "
          f"{cold['tower_inferences']}+{warm['tower_inferences']}, fallbacks "
          f"{cold['fallbacks'] + warm['fallbacks']}; host ms per step cold "
          f"{cuda['step_ms'][0]:.2f} warm {cuda['step_ms'][1]:.2f}")
    print("[multi] warm hit rate per model: " + ", ".join(
        f"{c.model_id} ({c.eviction}, ttl {c.cache_ttl_ms // MIN} min) "
        f"{h / max(r, 1):.4f}" for c, h, r in zip(
            cuda["cfgs"], warm["per_model_direct_hits"],
            warm["per_model_requests"])))
    if not hit[1] > 0:
        raise AssertionError("warm multi chunk has no direct hits")
    if not cuda["emb_finite"]:
        raise AssertionError("non-finite embeddings")

    plain = multi_run(torch, "torch", stream, slots, chunk)
    print(f"[multi] torch-backend replay on the card: host ms per step cold "
          f"{plain['step_ms'][0]:.2f} warm {plain['step_ms'][1]:.2f}")
    compare_runs(torch, cuda, plain, "multi")
    print("[multi] cuda and torch backends bit-identical: sources, ages, "
          "counters with every per-model vector, all 5 planes of both "
          "stacked tiers")
    del plain
    keys, feats, nows, _ = stream
    sl = slice(2 * chunk, 3 * chunk)
    phase_profile(torch, "profile multi", chunk,
                  lambda: cuda["server"].serve_many(
                      cuda["params"], cuda["state"], slots[sl],
                      Key64(keys.hi[sl], keys.lo[sl]),
                      {k: v[sl] for k, v in feats.items()}, nows[sl],
                      flush_every=1, collect=False)[1])


# ------------------------------------------------------------ phase 5
def phase_entry_multi(torch):
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch

    ops.reset_launch_counts()
    d = launch.run_serving_multi(arch="sasrec", minutes=8, users=400,
                                 backend="cuda",
                                 log=lambda s: print(f"[entry multi] {s}"))
    n = ops.launch_counts()
    if (n["cache_probe_dual_multi"] != d["batches"]
            or n["embedding_bag"] <= 0 or d["requests"] <= 0):
        raise AssertionError(f"multi entry point: {d['batches']} batches, "
                             f"launches {n}")


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA card (torch.cuda.is_available() is False)")
    if not (ROOT / "src" / "repro_torch").is_dir():
        return fail(f"no src/repro_torch beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    t0 = time.perf_counter()
    results, counts = {}, {}
    phase_kernels(torch, results)
    print(f"[time] kernels phase done at {time.perf_counter() - t0:.1f}s")
    phase_serve(torch, counts)
    print(f"[time] serve and profile phases done at {time.perf_counter() - t0:.1f}s")
    phase_entry(torch)
    print(f"[time] entry phase done at {time.perf_counter() - t0:.1f}s")
    phase_multi(torch, counts)
    print(f"[time] multi and profile phases done at "
          f"{time.perf_counter() - t0:.1f}s")
    phase_entry_multi(torch)
    print(f"[time] multi entry phase done at {time.perf_counter() - t0:.1f}s")

    kernels = []
    for name in sorted(counts):
        r = dict(results[name])
        r["launches"] = counts[name]
        kernels.append({k: r[k] for k in (
            "name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")})
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
