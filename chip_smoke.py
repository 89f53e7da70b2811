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
   time both on the card. The probes (per-query included) are also held
   at edge tables (``PROBE_EDGES``: D=33, D=64, bfloat16 at D=50, Wd=32
   beside Wf=1, two adjacent -0.0 columns in the direct tier) and
   the bag on views off 16-byte alignment, at D=33 and 64 and in
   bfloat16; an empty launch (``torch.cuda._sleep(0)``) gives the launch
   floor beside the kernels' times, and the bag is timed once more on an
   L2-resident table.
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
6. **LM serve**: TinyLlama-1.1B at its published widths
   (``get_config("tinyllama-1.1b")``, 22 layers, d_model 2048, 32/4 heads,
   bf16, random weights from seed 0) with ``attn_impl="flash_kernel"`` as
   the user tower behind ``CachedEmbeddingServer``, in the deployment of
   ``examples/serve_lm_tower.py`` (B=64, miss budget 48, 2**12 x 8 tiers,
   2% failures) at a 2048-token history: 3 cold and 3 warm steps of the
   example's loop (``serve_lm_tower.serve_steps``). Asserts 22
   ``flash_attention`` launches and one dual-probe launch per step and a
   warm hit rate above 0, replays the stream with ``backend="torch"``
   (sources, ages, counters and the key, write_ts and last_access planes
   bit-identical; values and embeddings within a stated tolerance) and
   profiles one more warm step.
7. **LM entry point**: ``repro_torch.examples.serve_lm_tower.run`` at full
   width.
8. **LM decode**: the same TinyLlama-1.1B at its published widths
   generating at B=128 (``LM_SHAPES["decode_32k"].global_batch``):
   ``prefill_step`` of a 1920-token prompt into a 2048-position KV cache
   (TinyLlama's context length; 22 ``flash_attention`` launches), then 128
   greedy decode steps (``decode_step``, ``backend="cuda"``) up to
   position 2048 (22 ``decode_attention`` launches per step). A ``backend="torch"``
   replay from a copy of the prefilled cache, fed the same tokens, must
   give logits within relative L2 0.02 at every step, and the same replay
   with one 64-position tile of v zeroed in every layer (a planted fault)
   must exceed that bar; a float32 twin at B=8 holds the two backends
   within relative L2 1e-4; the first step's logits of 8 rows must match
   ``forward_hidden`` over prompt + token within relative L2 0.02; one
   more decode step is profiled.
9. **overload**: ``launch.serve.overload_timeline`` (the overload arm of
   the launcher) on the same full-width SASRec tower with 2**20 x 8 tiers
   of D=50 float32, B=512, over phase 2's stream (20,000 users, 10
   minutes: 119 steps, 47 pre, 24 outage, 48 post), the inference budget
   at 0.5 of the stream's miss demand during the outage, a flash crowd,
   failures at 0.02 with a 0.2 burst in the outage window (Table 3's
   range). Asserts one dual-probe launch per step, bag launches, deferred
   misses and relaxed failover serves (nonzero staleness) in the outage
   with a fallback rate below the one without failover, none deferred
   before or after, and a ``backend="torch"`` replay bit-identical in
   every per-phase counter, every plane of both tiers and the budget
   tokens. A cuda replay of the same plan (set up before the profiler
   starts, its pre counters checked equal to the run's) then profiles
   the last warm chunk of pre and the first chunk of the outage, each
   continuing the replay's state.
10. **overload and quickstart entry points**:
    ``launch.serve.run_serving_overload`` and
    ``repro_torch.examples.quickstart.main`` as a user calls them.
11. **compiled**: the compiled entry points (``jit_serve_many``: on the
    card one CUDA graph per chunk shape, the whole chunk with its flushes,
    captured at its first call and replayed) against eager
    ``serve_many`` in the cells of phases 2, 4 and 9 at their widths,
    over phase 2's whole stream (119 steps in chunks of 64 and 55; the
    overload's 47/24/48) from identically initialised states: a first
    compiled run captures, then eager, compiled, compiled, eager, each
    from its state reset in place, so the compiled runs replay. Asserts
    counters, sources, ages, embeddings and every state tensor (both
    tiers, both rings, the budget tokens) bit-identical and each chunk's
    launches (one probe and one bag a step) on every replay; prints each
    graph's capture time and pool memory, host wall a step of the four
    runs, and one profiled chunk of each mode (device kernel time, idle
    share). Then the LM example's step at phase 6's width, eager
    (``serve_step`` + ``flush``) against its own compiled loop
    (``jit_serve_step`` + ``jit_flush``), eager/compiled/compiled/eager.

The launchers and the examples serve through the compiled entry points
(``jit_serve_many``, ``jit_serve_step``, ``jit_flush``), so phases 3, 5,
6, 7, 9 and 10 run CUDA graphs (each captured at its first call, whose
eager run is the call's result); phases 2 and 4 and the profile of phase
9 drive eager ``serve_many``.

Phase 1 also holds ``flash_attention`` against its plain version at the
LM path's shapes (q (48, 2048, 32, 64), k/v (48, 2048, 4, 64), bf16,
causal) and edge shapes (FLASH_KERNEL_TOL: bf16 per (batch, row, head)
scaled to the outputs), checks that the plain version with one 64-key
tile of v zeroed fails that bar, and times it beside
``F.scaled_dot_product_attention``; holds ``decode_attention`` (split
across the cache, ``split_plan``) against its plain version at the decode
path's shape (q (128, 32, 64), k/v (128, 2048, 4, 64), bf16), at
``LM_SHAPES["decode_32k"]`` and ``["long_500k"]`` and at edge shapes with
a valid_len on a split boundary (DEC_KERNEL_TOL), timed beside SDPA at
all three; each time is printed with its rate and roofline share; and
runs the
probe shootout of ``benchmarks/bench_kernel_probe.py`` (2**12 x 8 x 64
tier, B=4096, ~60% hits): ``cache_probe_perquery`` against its plain
version bit for bit (a -0.0 column read back +0.0) and against the tiled
probe, then perquery, tiled and dual timed side by side. The per-query
probe runs the tiled probe's body (a warp per query, eight a CTA, each
copied element passed through +0.0), so ``tiled_vs_perquery_speedup``
compares two TPU schedules that are one schedule on this card.

Each kernel's ``launches`` in the ``kernels`` line counts the run of its
own path: the single-model serve (phase 2) for the dual and one-table
probes and the bag, the multi-model serve (phase 4) for the multi-model
probe, the LM serve (phase 6, its cuda run) for ``flash_attention``, the
probe shootout for ``cache_probe_perquery`` and the decode steps (phase 8,
the cuda run) for ``decode_attention``; the counts are reset just before
each path and read just after. Phases 9 and 10 check their own counts.

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
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 tensor cores
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


PROBE_EDGES = [  # (D, dtype, Wd, Wf): copy units of 4 and 16 bytes, the
    # bfloat16 row of 4-byte units, a full warp of direct ways beside one
    (33, "float32", 8, 8), (64, "float32", 8, 8), (50, "bfloat16", 8, 8),
    (50, "float32", 32, 1)]


def random_tier(torch, rng, nb, ways, dim, dtype, now, ttl, dev):
    """A (nb, ways) table of random fresh, expired and empty slots, some
    keys twice in one bucket, and its int32 key planes as numpy."""
    import numpy as np

    from repro_torch.core.cache import TS_EMPTY
    from repro_torch.core.hashing import EMPTY_HI

    key_hi = np.full((nb, ways), EMPTY_HI, np.int32)
    key_lo = np.zeros((nb, ways), np.int32)
    ts = np.full((nb, ways), TS_EMPTY, np.int32)
    live = rng.uniform(size=(nb, ways)) < 0.6
    key_hi[live] = rng.integers(0, 2 ** 31 - 1, int(live.sum()))
    key_lo[live] = rng.integers(-2 ** 31, 2 ** 31 - 1, int(live.sum()))
    ts[live] = now - rng.integers(0, 2 * ttl, int(live.sum()))
    if ways > 1:
        dup = rng.integers(0, nb, nb // 8)
        key_hi[dup, 1], key_lo[dup, 1] = key_hi[dup, 0], key_lo[dup, 0]
    values = torch.randn((nb, ways, dim), device=dev).to(getattr(torch,
                                                                 dtype))
    planes = tuple(torch.as_tensor(a, device=dev) for a in (key_hi, key_lo,
                                                            ts))
    return planes + (values,), (key_hi, key_lo)


def kernels_probe_edges(torch):
    """The three serve probes (dual, tiled, dual-multi with strict and
    NO_TTL_MS failover columns) and the per-query probe bit for bit
    against their plain versions at PROBE_EDGES, B=512 and 37: a quarter
    of the queries probe a direct slot's key at its bucket, a quarter a
    failover slot's, half random keys. The direct tier holds two adjacent
    -0.0 columns (both halves of a packed bfloat16 unit), which the
    per-query probe must read back +0.0."""
    import numpy as np

    from repro_torch.core.config import NO_TTL_MS
    from repro_torch.core.hashing import EMPTY_HI
    from repro_torch.kernels import cache_probe as pk
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    now = torch.tensor(10 * MIN, dtype=torch.int32, device=dev)
    strict = torch.tensor([[MIN, 60 * MIN], [3 * MIN, 5 * MIN],
                           [MIN // 2, 2 * MIN]], dtype=torch.int32,
                          device=dev)
    relaxed = strict.clone()
    relaxed[:, 1] = NO_TTL_MS
    nb_d, nb_f = 1 << 12, 1 << 10
    for dim, dtype, wd, wf in PROBE_EDGES:
        rng = np.random.default_rng(dim + wd)
        d, (dhi, dlo) = random_tier(torch, rng, nb_d, wd, dim, dtype,
                                    10 * MIN, MIN, dev)
        f, (fhi, flo) = random_tier(torch, rng, nb_f, wf, dim, dtype,
                                    10 * MIN, 60 * MIN, dev)
        d[3][..., 6:8] = -0.0
        bits = torch.int32 if dtype == "float32" else torch.int16
        for b in (BATCH, 37):
            q_hi = rng.integers(0, 2 ** 31 - 1, b).astype(np.int32)
            q_lo = rng.integers(-2 ** 31, 2 ** 31 - 1, b).astype(np.int32)
            bd = rng.integers(0, nb_d, b).astype(np.int32)
            bf = rng.integers(0, nb_f, b).astype(np.int32)
            n = b // 4
            for sl, hi, lo, rows in ((slice(0, n), dhi, dlo, bd),
                                     (slice(n, 2 * n), fhi, flo, bf)):
                r, w = np.nonzero(hi != EMPTY_HI)         # stored slots
                pick = rng.integers(0, len(r), n)
                q_hi[sl], q_lo[sl] = hi[r[pick], w[pick]], lo[r[pick],
                                                              w[pick]]
                rows[sl] = r[pick]
            q_hi, q_lo, bd, bf = (torch.as_tensor(a, device=dev)
                                  for a in (q_hi, q_lo, bd, bf))
            slots = torch.as_tensor(rng.integers(0, 3, b).astype(np.int32),
                                    device=dev)
            got = [pk.cache_probe_dual(*d, *f, q_hi, q_lo, bd, bf, now, MIN,
                                       60 * MIN),
                   (pk.cache_probe_tiled(*d, q_hi, q_lo, bd, now, MIN),),
                   pk.cache_probe_dual_multi(*d, *f, q_hi, q_lo, slots, bd,
                                             bf, strict, now),
                   pk.cache_probe_dual_multi(*d, *f, q_hi, q_lo, slots, bd,
                                             bf, relaxed, now)]
            torch.cuda.synchronize()
            want = [(ref.cache_probe_ref(*d, q_hi, q_lo, bd, now, MIN),
                     ref.cache_probe_ref(*f, q_hi, q_lo, bf, now, 60 * MIN)),
                    (ref.cache_probe_ref(*d, q_hi, q_lo, bd, now, MIN),)]
            want += [ref.cache_probe_dual_multi_ref(
                *d, *f, q_hi, q_lo, slots, bd, bf, t, now)
                for t in (strict, relaxed)]
            for entry, g_all, w_all in zip(("dual", "tiled", "dual-multi",
                                            "dual-multi NO_TTL_MS"), got,
                                           want):
                for g_half, w_half in zip(g_all, w_all):
                    for g, w in zip(g_half, w_half):
                        if g.dtype != w.dtype or not torch.equal(g, w):
                            raise AssertionError(
                                f"cache_probe {entry} disagrees with its "
                                f"plain version at D={dim} {dtype} Wd={wd} "
                                f"Wf={wf} B={b}")
            g = pk.cache_probe_perquery(*d, q_hi, q_lo, bd, now, MIN)
            w = ref.cache_probe_perquery_ref(*d, q_hi, q_lo, bd, now, MIN)
            torch.cuda.synchronize()
            if not (torch.equal(g[0], w[0]) and torch.equal(g[2], w[2])
                    and torch.equal(g[1].view(bits), w[1].view(bits))
                    and not bool(torch.signbit(g[1][:, 6:8]).any())):
                raise AssertionError(
                    f"cache_probe_perquery disagrees with its plain version "
                    f"at D={dim} {dtype} W={wd} B={b}")
            hits = [int(want[0][i][0].sum()) for i in (0, 1)]
            if not all(0 < h < b for h in hits):
                raise AssertionError(f"probe edge lacks hits or misses: "
                                     f"direct/failover hits {hits} of {b}")
    print("[kernels] dual, tiled, dual-multi (strict and NO_TTL_MS) and "
          "per-query probes bit-exact vs plain at B=512/37 (per-query: "
          "-0.0 read back +0.0) on edges " + ", ".join(
              f"D={d} {t} Wd={wd} Wf={wf}" for d, t, wd, wf in PROBE_EDGES))


def kernels_bag_edges(torch, table):
    """The bag kernel against its plain version on a view of the serve
    table offset by one row and one element (off 16-byte alignment), on
    D=33 and D=64 tables and a bfloat16 table at D=50: nnz=1 bit for bit,
    nnz=4 with -1 pads within atol=rtol=1e-6 (float32)."""
    from repro_torch.kernels import embedding_bag as ebk
    from repro_torch.kernels import ref

    dev = table.device
    gen = torch.Generator(device=dev).manual_seed(3)
    flat = table.view(-1)
    n = table.shape[0] - 1
    views = {"one row off": table[1:],
             "one element off": flat[1:1 + n * 50].view(n, 50),
             "D=33": torch.randn(n, 33, generator=gen, device=dev),
             "D=64": torch.randn(n, 64, generator=gen, device=dev),
             "D=50 bfloat16": table[:n].to(torch.bfloat16)}
    err = 0.0
    for what, t in views.items():
        ids1 = torch.randint(0, n, (19_200, 1), generator=gen, device=dev,
                             dtype=torch.int32)
        if not torch.equal(ebk.embedding_bag(t, ids1),
                           ref.embedding_bag_ref(t, ids1)):
            raise AssertionError(f"embedding_bag nnz=1 not exact, {what}")
        ids4 = torch.randint(0, n, (19_200, 4), generator=gen, device=dev,
                             dtype=torch.int32)
        ids4[torch.rand(ids4.shape, generator=gen, device=dev) < 0.3] = -1
        got, want = ebk.embedding_bag(t, ids4), ref.embedding_bag_ref(t, ids4)
        if t.dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
            err = max(err, float((got - want).abs().max()))
        else:   # one bfloat16 rounding of a float32 sum in another order
            torch.testing.assert_close(got.float(), want.float(), atol=1e-2,
                                       rtol=1e-2)
    print(f"[kernels] embedding_bag edges: nnz=1 exact and nnz=4 within "
          f"tolerance (float32 max |err| {err:.3g}) on "
          + ", ".join(views))
    return err


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
    kernels_probe_edges(torch)

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
    err = max(err, kernels_bag_edges(torch, table))
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
    floor_us = device_ms(lambda i: torch.cuda._sleep(0)) * 1e3
    print(f"[kernels] launch floor: {floor_us:.2f} us a launch of an empty "
          f"kernel (torch.cuda._sleep(0)), timed as the kernels below")
    # the same bags on a table that fits in L2: what is left is the launch
    # and the dependent id -> row chain, not HBM bytes
    small = table[:65_536].clone()
    small_ids = [i % 65_536 for i in bag_ids]
    small_us = device_ms(lambda i: ebk.embedding_bag(
        small, small_ids[i % 40])) * 1e3
    print(f"[kernels] embedding_bag on an L2-resident 65536 x 50 table "
          f"(13.1 MB): {small_us:.2f} us")
    del small, small_ids
    for r in results.values():
        print(f"[kernels] {r['name']}: {r['ms'] * 1e3:.2f} us on the card "
              f"(plain {r['plain_ms'] * 1e3:.2f} us, bound "
              f"{r['bound_ms'] * 1e3:.3f} us by bytes"
              + (f", library {r['library_ms'] * 1e3:.2f} us"
                 if r["library_ms"] is not None else "") + ")")
    del direct, failover, table, small_d, small_f
    kernels_dual_multi(torch, results)
    kernels_flash(torch, results)
    kernels_decode(torch, results)


LM_B, LM_S, LM_HQ, LM_HKV, LM_HD = 48, 2048, 32, 4, 64   # miss budget 48


def sdpa(torch, q, k, v, causal):
    """One PyTorch call computing the same attention (the library
    yardstick; the port never calls it): (B, S, H, hd) views as
    (B, H, S, hd), GQA by ``enable_gqa`` where this PyTorch has it."""
    F = torch.nn.functional
    n_rep = q.shape[2] // k.shape[2]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    try:
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=n_rep > 1)
    except TypeError:
        from repro_torch.models.layers import repeat_kv

        return F.scaled_dot_product_attention(
            qt, repeat_kv(k, n_rep).transpose(1, 2),
            repeat_kv(v, n_rep).transpose(1, 2), is_causal=causal)


# decode_attention against its plain version: float32 at atol 1e-5;
# bfloat16 per (row, head) within 2**-6 of that head's largest |output|
# (two bf16 ulps of it), never more than 2e-2, and in relative L2 within
# 2**-8. Outputs scale as sqrt(e / valid_len) (~0.04 at the decode path,
# ~0.002 at long_500k), so a fixed bf16 atol alone would pass a kernel
# that writes zeros or loses a tile. flash_attention is held to the same
# rule per (batch, query row, head) in bfloat16 (its late causal rows
# shrink as ~1/sqrt(position), ~0.02 at 2048) and at atol 2e-5 in float32.
DEC_KERNEL_TOL = dict(f32_atol=1e-5, bf16_rel_max=2.0 ** -6, bf16_atol=2e-2,
                      bf16_rel_l2=2.0 ** -8)
FLASH_KERNEL_TOL = dict(DEC_KERNEL_TOL, f32_atol=2e-5)


def attention_errors(torch, got, want, tol):
    """(max |err|, worst per-(row, head) max |err| / max |want|, relative
    L2, within ``tol``) of an attention output (..., hd) against its plain
    version: float32 at ``tol["f32_atol"]``, bfloat16 by the scaled rule
    above."""
    bf16 = got.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    err = (got - want).abs().amax(-1)
    scale = want.abs().amax(-1)
    ratio = float((err / scale.clamp(min=1e-30)).max())
    rel_l2 = float((got - want).norm() / want.norm().clamp(min=1e-30))
    bar = (tol["bf16_rel_max"] * scale).clamp(max=tol["bf16_atol"])
    ok = ((bool((err <= bar).all()) and rel_l2 <= tol["bf16_rel_l2"]) if bf16
          else float(err.max()) <= tol["f32_atol"])
    return float(err.max()), ratio, rel_l2, ok


def tol_text(tol, dtype, ratio, rel_l2):
    """The bar an attention check read, for its [kernels] line."""
    if str(dtype) != "torch.bfloat16":
        return f"atol {tol['f32_atol']:g}"
    return (f"per head max |err| / max |want| {ratio:.3g} (bar "
            f"{tol['bf16_rel_max']:g}, at most atol {tol['bf16_atol']:g}), "
            f"relative L2 {rel_l2:.3g} (bar {tol['bf16_rel_l2']:g})")


def kernels_flash(torch, results):
    """flash_attention against its plain version at the LM path's shapes
    and at edge shapes (FLASH_KERNEL_TOL), a planted fault that must fail
    that bar, and its time on the card beside the plain version and
    SDPA."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    tol = FLASH_KERNEL_TOL

    def inputs(b, sq, sk, hq, hkv, hd, dtype):
        mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)
        return mk(b, sq, hq, hd), mk(b, sk, hkv, hd), mk(b, sk, hkv, hd)

    err = 0.0
    edges = [  # (B, Sq, Sk, Hq, Hkv, hd, causal, q_offset, dtype)
        (LM_B, LM_S, LM_S, LM_HQ, LM_HKV, LM_HD, True, 0, torch.bfloat16),
        (2, 256, 256, 8, 2, 64, True, 0, torch.float32),
        (2, 256, 256, 8, 2, 64, False, 0, torch.float32),
        (2, 256, 256, 8, 2, 64, False, 0, torch.bfloat16),
        (2, 128, 384, 8, 1, 64, True, 256, torch.float32),
        (2, 128, 384, 8, 8, 64, True, 256, torch.bfloat16),
        (2, 512, 512, 32, 4, 128, True, 0, torch.bfloat16),
        (2, 128, 384, 8, 2, 128, True, 256, torch.bfloat16),
        (2, 100, 100, 4, 1, 128, True, 0, torch.bfloat16),
        (2, 256, 256, 4, 1, 128, False, 0, torch.float32),
        (3, 128, 128, 4, 4, 64, True, 0, torch.float32),
        (2, 100, 100, 4, 2, 16, True, 0, torch.float32),
        (2, 100, 100, 8, 2, 16, True, 0, torch.bfloat16),
        (1, 1152, 1152, 8, 2, 8, True, 0, torch.float32),
        (1, 1152, 1152, 8, 2, 8, True, 0, torch.bfloat16),
        (1, 1152, 1152, 4, 2, 16, True, 0, torch.bfloat16),
        (1, 1152, 1152, 8, 1, 128, True, 0, torch.bfloat16),
    ]
    for b, sq, sk, hq, hkv, hd, causal, off, dtype in edges:
        q, k, v = inputs(b, sq, sk, hq, hkv, hd, dtype)
        n0 = fa.LAUNCHES["flash_attention"]
        got = fa.flash_attention(q, k, v, causal=causal, q_offset=off)
        torch.cuda.synchronize()
        if fa.LAUNCHES["flash_attention"] != n0 + 1:
            raise AssertionError("flash_attention did not count one launch")
        want = ref.flash_attention_ref(q, k, v, causal=causal, q_offset=off)
        e, ratio, rel_l2, ok = attention_errors(torch, got, want, tol)
        shape = (f"B={b} Sq={sq} Sk={sk} {hq}/{hkv} heads hd={hd} "
                 f"causal={causal} q_offset={off} {str(dtype)[6:]}")
        print(f"[kernels] flash_attention {shape}: max |err| {e:.3g}, max "
              f"|want| {float(want.float().abs().max()):.3g}; "
              + tol_text(tol, dtype, ratio, rel_l2))
        if not (ok and bool(torch.isfinite(got).all())):
            raise AssertionError(f"flash_attention disagrees with its plain "
                                 f"version at {shape}")
        if b == LM_B:
            err = e
            # the planted fault: the plain version with the last 64 keys
            # of v zeroed (a kernel that drops the late rows' last tile,
            # whose outputs are the smallest) must fail the bar
            v_bad = v.clone()
            v_bad[:, sk - 64:] = 0
            bad = ref.flash_attention_ref(q, k, v_bad, causal=causal)
            be, bratio, brel, bok = attention_errors(torch, bad, want, tol)
            print(f"[kernels] flash_attention control (v zeroed at keys "
                  f"{sk - 64}..{sk - 1}): max |err| {be:.3g} (a fixed atol "
                  f"{tol['bf16_atol']:g} would "
                  f"{'pass' if be <= tol['bf16_atol'] else 'fail'} it); "
                  + tol_text(tol, dtype, bratio, brel) + " -> must fail")
            if bok:
                raise AssertionError("the flash bf16 bar does not separate "
                                     "a one-tile fault")
            del v_bad, bad
    del q, k, v, got, want
    q, k, v = inputs(LM_B, LM_S, LM_S, LM_HQ, LM_HKV, LM_HD, torch.bfloat16)
    # 2 operations per multiply-add, QK^T and PV, over the causal pairs
    flops = 4 * LM_B * LM_HQ * LM_HD * LM_S * (LM_S + 1) // 2
    nbytes = sum(x.nbytes for x in (q, k, v)) + q.nbytes
    ms = device_ms(lambda i: fa.flash_attention(q, k, v), n=10, reps=3)
    plain_ms = device_ms(lambda i: ref.flash_attention_ref(q, k, v), n=1,
                         reps=3)
    lib_ms = device_ms(lambda i: sdpa(torch, q, k, v, True), n=10, reps=3)
    results["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:85",
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)
        * 1e3, bound_by="operations" if flops / BF16_FLOP_PER_S
        >= nbytes / HBM_BYTES_PER_S else "bytes", library_ms=lib_ms)
    r = results["flash_attention"]
    print(f"[kernels] flash_attention at q {tuple(q.shape)} k/v "
          f"{tuple(k.shape)} bf16 causal: {ms:.3f} ms on the card "
          f"({flops / ms / 1e9:.1f} TFLOP/s, {r['bound_ms'] / ms:.1%} of its "
          f"bound), plain {plain_ms:.3f} ms, SDPA {lib_ms:.3f} ms "
          f"({flops / lib_ms / 1e9:.1f} TFLOP/s, {r['bound_ms'] / lib_ms:.1%}"
          f"); bound {r['bound_ms']:.3f} ms by {r['bound_by']} "
          f"({flops:.4g} operations at 989 TFLOP/s bf16; "
          f"{nbytes / 1e9:.3f} GB at 3.35 TB/s = "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms)")


DEC_B, DEC_PROMPT, DEC_MAX = 128, 1920, 2048   # decode_32k's batch


def sdpa_decode(torch, q, k, v, mask):
    """One PyTorch call computing the same decode attention (the library
    yardstick; the port never calls it): q (B, Hq, 1, hd) against k, v
    viewed (B, Hkv, S, hd) with ``enable_gqa`` and ``mask``, the
    (B, 1, 1, S) boolean valid_len mask."""
    return torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
        enable_gqa=True)[:, :, 0]


def valid_mask(torch, valid, S):
    """(B, 1, 1, S) boolean mask of the positions below valid_len."""
    return (torch.arange(S, device=valid.device)[None, :]
            < valid[:, None])[:, None, None, :]


def decode_bytes(q, k, valid):
    """Least bytes of one decode launch: the valid prefix of k and v, q
    read and the output written once."""
    S, Hkv, hd = k.shape[1:]
    n = int(valid.clamp(0, S).sum())
    return 2 * n * Hkv * hd * k.element_size() + 2 * q.nbytes


def kernels_decode(torch, results):
    """decode_attention against its plain version at edge shapes, at the
    decode path's shape, at decode_32k and at long_500k, and its time on
    the card beside the plain version and SDPA."""
    from repro_torch.configs import LM_SHAPES
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    t = DEC_KERNEL_TOL

    def inputs(b, s, hq, hkv, hd, dtype):
        mk = lambda *sh: torch.randn(sh, generator=gen, device=dev).to(dtype)
        return mk(b, hq, hd), mk(b, s, hkv, hd), mk(b, s, hkv, hd)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def check(q, k, v, valid, what):
        n0 = dk.LAUNCHES["decode_attention"]
        got = dk.decode_attention(q, k, v, valid)
        torch.cuda.synchronize()
        if dk.LAUNCHES["decode_attention"] != n0 + 1:
            raise AssertionError("decode_attention did not count one launch")
        want = ref.decode_attention_ref(q, k, v, valid)
        e, ratio, rel_l2, ok = attention_errors(torch, got, want, t)
        n_split, split_len = dk.split_plan(q.shape[0], k.shape[1],
                                           k.shape[2], sms)
        print(f"[kernels] decode_attention {what}, {n_split} split(s) of "
              f"{split_len} keys: max |err| {e:.3g}, max |want| "
              f"{float(want.float().abs().max()):.3g}; "
              + tol_text(t, q.dtype, ratio, rel_l2))
        if not (ok and bool(torch.isfinite(got).all())
                and not bool(got[valid <= 0].any())):
            raise AssertionError(f"decode_attention disagrees with its "
                                 f"plain version at {what}")
        return e

    edges = [  # (S, Hq, Hkv, hd, dtype): n_rep 8, 1, 4; hd 8, 16, 64, 128
        (1024, 32, 4, 64, torch.bfloat16), (1024, 32, 4, 64, torch.float32),
        (1024, 8, 8, 64, torch.float32), (1024, 32, 4, 128, torch.bfloat16),
        (1024, 16, 4, 128, torch.float32), (512, 8, 2, 16, torch.float32),
        (512, 8, 1, 8, torch.bfloat16), (512, 4, 4, 8, torch.float32),
        (256, 8, 2, 16, torch.bfloat16), (100, 8, 1, 64, torch.float32)]
    for S, hq, hkv, hd, dtype in edges:
        # valid_len 0 (zeros), 1, around 512, all of S, and ending exactly
        # on the first split boundary
        bound = dk.split_plan(7, S, hkv, sms)[1]
        valid = torch.tensor([min(n, S) for n in (0, 1, 511, 512, 513, S,
                                                  bound)],
                             dtype=torch.int32, device=dev)
        check(*inputs(len(valid), S, hq, hkv, hd, dtype), valid,
              f"S={S} {hq}/{hkv} heads hd={hd} {str(dtype)[6:]} valid_len "
              f"{valid.tolist()}")

    # the decode path's shape: valid_len 1921..2048 (positions 1920..2047)
    q, k, v = inputs(DEC_B, DEC_MAX, LM_HQ, LM_HKV, LM_HD, torch.bfloat16)
    valid = torch.arange(DEC_PROMPT + 1, DEC_MAX + 1, dtype=torch.int32,
                         device=dev)
    err = check(q, k, v, valid, f"at the decode path q {tuple(q.shape)} "
                f"k/v {tuple(k.shape)} bf16 valid_len "
                f"{DEC_PROMPT + 1}..{DEC_MAX}")
    mask = valid_mask(torch, valid, DEC_MAX)
    row = dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:91",
        max_abs_err=err,
        ms=device_ms(lambda i: dk.decode_attention(q, k, v, valid), n=20,
                     reps=3),
        plain_ms=device_ms(lambda i: ref.decode_attention_ref(q, k, v, valid),
                           n=2, reps=3),
        bound_ms=decode_bytes(q, k, valid) / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
        library_ms=device_ms(lambda i: sdpa_decode(torch, q, k, v, mask),
                             n=20, reps=3))
    nb = decode_bytes(q, k, valid)
    print(f"[kernels] decode_attention at the decode path: {row['ms']:.4f} ms"
          f" on the card ({nb / row['ms'] / 1e6:.0f} GB/s, "
          f"{row['bound_ms'] / row['ms']:.1%} of its bound), plain "
          f"{row['plain_ms']:.3f} ms, SDPA (enable_gqa) "
          f"{row['library_ms']:.4f} ms ({row['bound_ms'] / row['library_ms']:.1%}"
          f"); bound {row['bound_ms']:.4f} ms by bytes ({nb / 1e9:.4f} GB at "
          f"3.35 TB/s)")
    results["decode_attention"] = row
    del q, k, v, mask

    for shape, n_k in (("decode_32k", 5), ("long_500k", 3)):
        sh = LM_SHAPES[shape]
        q, k, v = inputs(sh.global_batch, sh.seq_len, LM_HQ, LM_HKV, LM_HD,
                         torch.bfloat16)
        valid = (torch.randint(1, sh.seq_len + 1, (sh.global_batch,),
                               generator=gen, device=dev, dtype=torch.int32)
                 if sh.global_batch > 1 else
                 torch.full((1,), sh.seq_len, dtype=torch.int32, device=dev))
        check(q, k, v, valid, f"at {shape} q {tuple(q.shape)} k/v "
              f"{tuple(k.shape)} bf16 ({k.nbytes * 2 / 1e9:.2f} GB of KV), "
              f"valid_len in [{int(valid.min())}, {int(valid.max())}]")
        ms = device_ms(lambda i: dk.decode_attention(q, k, v, valid), n=n_k,
                       reps=3)
        plain = device_ms(lambda i: ref.decode_attention_ref(q, k, v, valid),
                          n=1, reps=3)
        mask = valid_mask(torch, valid, sh.seq_len)
        lib = device_ms(lambda i: sdpa_decode(torch, q, k, v, mask), n=n_k,
                        reps=3)
        del mask
        nb = decode_bytes(q, k, valid)
        bound = nb / HBM_BYTES_PER_S * 1e3
        print(f"[kernels] decode_attention at {shape}: {ms:.4f} ms on the "
              f"card ({nb / ms / 1e6:.0f} GB/s, {bound / ms:.1%} of its "
              f"bound), plain {plain:.3f} ms, SDPA (enable_gqa) {lib:.4f} ms "
              f"({bound / lib:.1%}); bound {bound:.4f} ms by bytes "
              f"({nb / 1e9:.3f} GB)")
        del q, k, v
    torch.cuda.empty_cache()


# probe shootout: benchmarks/bench_kernel_probe.py's shapes (:23-26, :45)
PQ_BUCKETS, PQ_WAYS, PQ_DIM, PQ_B, PQ_TTL, PQ_NOW = 1 << 12, 8, 64, 4096, \
    60_000, 1000


def phase_shootout(torch, results, counts):
    """The twin of bench_kernel_probe.py on the card: the per-query probe
    against its plain version (bit for bit, values with a -0.0 column) and
    the tiled probe, then perquery, tiled and dual timed side by side. The
    timed launches are the per-query kernel's path."""
    import numpy as np

    from repro_torch.core import cache as C
    from repro_torch.core.hashing import Key64, bucket_index
    from repro_torch.kernels import cache_probe as pk
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def populated(n_keys):
        st = C.init_cache(PQ_BUCKETS, PQ_WAYS, PQ_DIM, device=dev)
        ids = np.arange(n_keys, dtype=np.int64) * 7919
        vals = torch.as_tensor(rng.standard_normal((n_keys, PQ_DIM)),
                               dtype=torch.float32, device=dev)
        C.insert(st, Key64.from_int(ids, device=dev), vals, 0, PQ_TTL)
        return st, ids

    state, ids = populated(PQ_B)
    failover, _ = populated(PQ_B // 2)
    state.values[..., 5] = -0.0                  # a -0.0 column
    probe_ids = np.where(rng.uniform(size=PQ_B) < 0.6,
                         rng.choice(ids, size=PQ_B),
                         rng.integers(10 ** 9, 2 * 10 ** 9, size=PQ_B))
    k = Key64.from_int(probe_ids, device=dev)
    bd = bucket_index(k, PQ_BUCKETS)
    bf = bucket_index(k, failover.n_buckets)
    now = torch.tensor(PQ_NOW, dtype=torch.int32, device=dev)  # no H2D copy
    args = (state.key_hi, state.key_lo, state.write_ts, state.values, k.hi,
            k.lo, bd, now, PQ_TTL)
    got = pk.cache_probe_perquery(*args)
    want = ref.cache_probe_perquery_ref(*args)
    tiled = pk.cache_probe_tiled(*args)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
            and torch.equal(got[1].view(torch.int32),
                            want[1].view(torch.int32))):
        raise AssertionError("cache_probe_perquery disagrees with its plain "
                             "version")
    hit = got[0]
    if not (torch.equal(hit, tiled[0]) and torch.equal(got[2], tiled[2])
            and torch.equal(got[1], tiled[1])):
        raise AssertionError("cache_probe_perquery disagrees with the tiled "
                             "probe beyond the sign of zero")
    signs = (int(torch.signbit(got[1][hit, 5]).sum()),
             int(torch.signbit(tiled[1][hit, 5]).sum()))
    hits = int(hit.sum())
    print(f"[shootout] {PQ_BUCKETS}x{PQ_WAYS}x{PQ_DIM} float32, B={PQ_B}: "
          f"{hits} hits ({hits / PQ_B:.3f}); perquery bit-exact vs plain, "
          f"equal to tiled on hit/age/values; the -0.0 column has the sign "
          f"bit set on {signs[0]} perquery and {signs[1]} tiled hit rows")
    if signs[0] != 0 or signs[1] != hits or not 0 < hits < PQ_B:
        raise AssertionError(f"-0.0 column: perquery/tiled sign bits {signs} "
                             f"for {hits} hits")

    ops.reset_launch_counts()                    # the per-query path
    us = {"perquery": device_ms(lambda i: pk.cache_probe_perquery(*args)),
          "tiled": device_ms(lambda i: pk.cache_probe_tiled(*args)),
          "dual": device_ms(lambda i: pk.cache_probe_dual(
              *state[:4], *failover[:4], k.hi, k.lo, bd, bf, now, PQ_TTL,
              10 * PQ_TTL))}
    counts["cache_probe_perquery"] = ops.launch_counts()[
        "cache_probe_perquery"]
    us = {n: ms * 1e3 for n, ms in us.items()}
    print("[shootout] " + json.dumps({
        "probe_us": us,
        "tiled_vs_perquery_speedup": us["perquery"] / us["tiled"],
        "dual_vs_two_tiled_speedup": 2 * us["tiled"] / us["dual"]}))
    # least HBM bytes: each query's (hi, lo, bucket) read once, each
    # DISTINCT probed bucket's 3*W int32 of metadata and each DISTINCT
    # winning row once (queries repeat buckets and ids at this shape), the
    # (hit, value, age) outputs written
    n_rows = int(torch.unique(bd[hit].long() * PQ_WAYS
                              + tiled[3][hit].long()).numel())
    n_bkts = int(torch.unique(bd).numel())
    nbytes = (PQ_B * 12 + n_bkts * 12 * PQ_WAYS + n_rows * PQ_DIM * 4
              + PQ_B * (1 + PQ_DIM * 4 + 4))
    results["cache_probe_perquery"] = dict(
        name="cache_probe_perquery", route="cuda",
        source="src/repro_torch/csrc/cache_probe.cu",
        replaces="src/repro/kernels/cache_probe.py:620", max_abs_err=0.0,
        ms=us["perquery"] / 1e3,
        plain_ms=device_ms(lambda i: ref.cache_probe_perquery_ref(*args),
                           n=10),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None)
    r = results["cache_probe_perquery"]
    print(f"[shootout] cache_probe_perquery: {us['perquery']:.2f} us on the "
          f"card (plain {r['plain_ms'] * 1e3:.2f} us, bound "
          f"{r['bound_ms'] * 1e3:.3f} us by bytes, {nbytes / 1e6:.3f} MB: "
          f"{n_bkts} distinct buckets, {n_rows} distinct winning rows for "
          f"{hits} hits; {r['bound_ms'] * 1e3 / us['perquery']:.1%} of "
          f"its bound)")


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
                 ("decode_attention", ("decode_split_kernel",
                                       "decode_combine_kernel")),
                 ("embedding_bag", ("bag_kernel",)),
                 ("flash_attention", ("fa_kernel", "fa_wgmma_kernel")),
                 ("matmul", ("gemm", "xmma", "cutlass", "sm90_", "nvjet")),
                 ("sort", ("sort", "radix", "cub::")),
                 ("index/scatter", ("index", "scatter", "gather")),
                 ("reduce", ("reduce",)),
                 ("elementwise", ("elementwise", "vectorized")),
                 ("memcpy/memset", ("memcpy", "memset")))


def phase_profile(torch, tag, chunk, drive):
    """Where a step's time goes: torch.profiler over the ``chunk`` steps
    that ``drive()`` serves on the card (a warm chunk continuing a cuda
    run's state, or an overload chunk), device kernel time by group
    against the host wall time. A serve loop's ``drive()``
    returns its device counters, and the wall ends with their read-back
    (``fetch_counters``) as in the serve loop; any other ends at a
    synchronize."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import server as srv

    torch.cuda.synchronize()
    # device activity only: the host ops' events are not read, and at
    # ~800 ops a step they cost seconds to record and parse
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = drive()
        if isinstance(out, dict):
            srv.fetch_counters(out)
        else:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"[{tag}] device time not measured (the profiler recorded "
              "no CUDA events)")
        return None
    by_group, by_name = {}, {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        low = e.name.lower()
        group = next((g for g, keys_ in KERNEL_GROUPS
                      if any(k in low for k in keys_)), "other")
        by_group[group] = by_group.get(group, 0.0) + us
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + us
    busy_ms = sum(by_group.values()) / 1e3
    print(f"[{tag}] {chunk} steps under torch.profiler: "
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
    return by_group, wall_ms


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


# ------------------------------------------------------------ phase 6
LM_STEPS_COLD, LM_STEPS_WARM = 3, 3
LM_USERS, LM_MINUTES = 1200, 90              # the example's own stream
LM_SEQ = 2048                                # TinyLlama's context length
LM_TOL = dict(max_abs=0.1, rel_l2=1e-2)      # cuda vs torch, bf16 tower


def lm_config():
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("tinyllama-1.1b"),
                               attn_impl="flash_kernel")


def lm_run(torch, backend, cfg, params, n_steps, launches=None):
    """The first ``n_steps`` steps of the example's loop at full width.
    Returns what they produced and the live generator (its state goes on).
    With ``launches`` (a list), records each step's kernel launches."""
    from repro_torch.examples import serve_lm_tower as ex
    from repro_torch.kernels import ops

    gen = ex.serve_steps(cfg, params, seq=LM_SEQ, batch=64,
                         minutes=LM_MINUTES, users=LM_USERS,
                         failure_rate=0.02, device="cuda", backend=backend)
    out = {"src": [], "age": [], "emb": [], "stats": [], "step_ms": []}
    for _ in range(n_steps):
        before = ops.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, stats, state = next(gen)            # one stats fetch per step
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        if launches is not None:
            after = ops.launch_counts()
            launches.append({k: after[k] - before[k] for k in after})
        out["src"].append(res.source)
        out["age"].append(res.age_ms)
        out["emb"].append(res.embeddings)
        out["stats"].append(stats)
    out.update(state=state, gen=gen)
    return out


def close_errors(torch, a, b):
    """(max |a - b|, ||a - b|| / ||b||) in float32."""
    a, b = a.float(), b.float()
    return (float((a - b).abs().max()),
            float((a - b).norm() / b.norm().clamp(min=1e-30)))


def phase_lm(torch, counts):
    from repro_torch.core.cache import CacheState
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm

    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    cfg = lm_config()
    t0 = time.perf_counter()
    params = tfm.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                             dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[lm] {cfg.arch_id}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.hd},"
          f" d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}, attn_impl "
          f"{cfg.attn_impl}: {n_params / 1e9:.3f}B parameters "
          f"({sum(p.nbytes for p in params.parameters()) / 1e9:.2f} GB) in "
          f"{time.perf_counter() - t0:.1f}s")
    steps = LM_STEPS_COLD + LM_STEPS_WARM
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()                    # this path's window
    per_step = []
    cuda = lm_run(torch, "cuda", cfg, params, steps, per_step)
    n = ops.launch_counts()
    counts["flash_attention"] = n["flash_attention"]
    for i, c in enumerate(per_step):
        if c["flash_attention"] != cfg.n_layers or c["cache_probe_dual"] != 1:
            raise AssertionError(f"LM step {i}: launches {c}; want "
                                 f"{cfg.n_layers} flash_attention and one "
                                 "dual probe")
    hits = [s["direct_hits"] for s in cuda["stats"]]
    req = [s["requests"] for s in cuda["stats"]]
    warm = sum(hits[LM_STEPS_COLD:]) / sum(req[LM_STEPS_COLD:])
    print(f"[lm] serve at seq {LM_SEQ}, B=64, miss budget 48, 2**12 x 8 "
          f"tiers, 2% failures: {steps} steps, launches {n} "
          f"({cfg.n_layers} flash_attention + 1 dual probe per step), "
          f"direct hits per step "
          f"{hits}, warm hit rate {warm:.4f}, tower inferences "
          f"{sum(s['tower_inferences'] for s in cuda['stats'])}, fallbacks "
          f"{sum(s['fallbacks'] for s in cuda['stats'])}; host wall ms per "
          f"step {[round(t, 1) for t in cuda['step_ms']]}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if not warm > 0:
        raise AssertionError("warm LM steps have no direct hits")
    for e in cuda["emb"]:
        if tuple(e.shape) != (64, cfg.user_embed_dim) or not bool(
                torch.isfinite(e).all()):
            raise AssertionError(f"LM embeddings {tuple(e.shape)} or "
                                 "non-finite")

    ops.reset_launch_counts()
    plain = lm_run(torch, "torch", cfg, params, steps)
    if sum(ops.launch_counts().values()):
        raise AssertionError(f"torch replay launched kernels: "
                             f"{ops.launch_counts()}")
    print(f"[lm] torch-backend replay (plain attention): host wall ms per "
          f"step {[round(t, 1) for t in plain['step_ms']]}")
    for x, y in zip(cuda["src"] + cuda["age"], plain["src"] + plain["age"]):
        if not torch.equal(x, y):
            raise AssertionError("LM: sources/ages differ between backends")
    if cuda["stats"] != plain["stats"]:
        raise AssertionError("LM: counters differ between backends")
    for tier in ("direct", "failover"):
        ta, tb = getattr(cuda["state"], tier), getattr(plain["state"], tier)
        for name in CacheState._fields:
            if name != "values" and not torch.equal(getattr(ta, name),
                                                    getattr(tb, name)):
                raise AssertionError(f"LM: {tier}.{name} differs between "
                                     "backends")
    errs = [close_errors(torch, a, b) for a, b in zip(cuda["emb"],
                                                      plain["emb"])]
    errs += [close_errors(torch, getattr(cuda["state"], t).values,
                          getattr(plain["state"], t).values)
             for t in ("direct", "failover")]
    worst = (max(e[0] for e in errs), max(e[1] for e in errs))
    print(f"[lm] cuda and torch backends: sources, ages, counters and the "
          f"key_hi/key_lo/write_ts/last_access_ts planes of both tiers "
          f"bit-identical; embeddings and value planes max |err| "
          f"{worst[0]:.4g}, relative L2 {worst[1]:.3g} (tolerance "
          f"{LM_TOL['max_abs']} / {LM_TOL['rel_l2']})")
    if worst[0] > LM_TOL["max_abs"] or worst[1] > LM_TOL["rel_l2"]:
        raise AssertionError("LM: embeddings differ between backends "
                             "beyond the tolerance")
    del plain
    got = phase_profile(torch, "profile lm", 1,
                        lambda: next(cuda["gen"])[0].stats)
    if got is not None:
        by_group, wall_ms = got
        flash = by_group.get("flash_attention", 0.0) / 1e3
        mm = by_group.get("matmul", 0.0) / 1e3
        busy = sum(by_group.values()) / 1e3
        print(f"[profile lm] flash_attention {flash:.1f} ms "
              f"({flash / busy:.1%} of device time), matmul {mm:.1f} ms "
              f"({mm / busy:.1%}); unprofiled warm step "
              f"{statistics.median(cuda['step_ms'][LM_STEPS_COLD:]):.1f} ms "
              f"host wall, idle share estimate "
              f"{1 - busy / statistics.median(cuda['step_ms'][LM_STEPS_COLD:]):.3f}")


# ------------------------------------------------------------ phase 7
def phase_lm_entry(torch):
    from repro_torch.examples import serve_lm_tower as ex
    from repro_torch.kernels import ops

    torch.cuda.empty_cache()
    cfg = lm_config()
    ops.reset_launch_counts()
    totals = ex.run(cfg=cfg, seq=LM_SEQ, batch=64, minutes=2, users=100,
                    failure_rate=0.02, device="cuda", backend="cuda")
    n = ops.launch_counts()
    steps = totals["requests"] // 64
    if (not steps or n["flash_attention"] != cfg.n_layers * steps
            or n["cache_probe_dual"] != steps):
        raise AssertionError(f"LM entry point: {steps} steps, launches {n}")
    print(f"[lm entry] {steps} steps, launches {n}")


# ------------------------------------------------------------ phase 8
DEC_STEPS = DEC_MAX - DEC_PROMPT             # 128 greedy steps to 2048
# bf16 logits of the cuda run and the torch replay (two attentions that
# agree to one bf16 ulp, through 22 bf16 layers and a cache each backend
# writes itself) sit at the same ~1.5% relative L2 as the decode step
# against the full forward, so both are held at 2e-2, not 1e-2. The float32
# twin (no bf16 rounding) holds the path itself at 1e-4, and a control
# replay with one tile of the cache's values zeroed must fail the 2e-2 bar.
DEC_TOL = dict(replay_rel_l2=2e-2, forward_rel_l2=2e-2, forward_rows=8,
               f32_rel_l2=1e-4)
DEC_F32_B, DEC_F32_STEPS = 8, 8
DEC_CTRL_TILE, DEC_CTRL_STEPS = (512, 576), 2


def phase_decode(torch, counts):
    import dataclasses

    from repro_torch.configs import LM_SHAPES
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm

    assert LM_SHAPES["decode_32k"].global_batch == DEC_B
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    cfg = lm_config()
    params = tfm.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                             dev)
    prompt = torch.randint(0, cfg.vocab, (DEC_B, DEC_PROMPT), dtype=torch.int32,
                           device=dev,
                           generator=torch.Generator(device=dev).manual_seed(7))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = tfm.prefill_step(params, prompt, cfg, backend="cuda",
                                     max_seq=DEC_MAX)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    n = ops.launch_counts()
    if n["flash_attention"] != cfg.n_layers or n["decode_attention"]:
        raise AssertionError(f"prefill launches {n}: want {cfg.n_layers} "
                             "flash_attention")
    start = tfm.KVCache(cache.k.clone(), cache.v.clone(),
                        cache.length.clone())
    tok = logits.argmax(-1).to(torch.int32)

    ops.reset_launch_counts()                    # this path's window
    toks, outs, step_ms = [], [], []
    for _ in range(DEC_STEPS):
        before = ops.launch_counts()["decode_attention"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = tfm.decode_step(params, cache, tok, cfg,
                                        backend="cuda")
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if ops.launch_counts()["decode_attention"] - before != cfg.n_layers:
            raise AssertionError("a decode step did not launch "
                                 f"{cfg.n_layers} decode_attention")
        toks.append(tok)
        outs.append(logits)
        tok = logits.argmax(-1).to(torch.int32)
    n = ops.launch_counts()
    counts["decode_attention"] = n["decode_attention"]
    if (n["decode_attention"] != DEC_STEPS * cfg.n_layers
            or sum(n.values()) != n["decode_attention"]):
        raise AssertionError(f"decode launches {n}")
    if not bool((cache.length == DEC_MAX).all()):
        raise AssertionError(f"cache length {cache.length.unique().tolist()}")
    for lg in outs:
        if tuple(lg.shape) != (DEC_B, cfg.vocab) or not bool(
                torch.isfinite(lg).all()):
            raise AssertionError(f"decode logits {tuple(lg.shape)} or "
                                 "non-finite")
    kv_gb = (cache.k.nbytes + cache.v.nbytes) / 1e9
    print(f"[decode] {cfg.arch_id} full width, B={DEC_B}, prompt "
          f"{DEC_PROMPT} tokens, cache {DEC_MAX} positions ({kv_gb:.2f} GB "
          f"of KV): prefill {prefill_ms:.1f} ms host wall ({cfg.n_layers} "
          f"flash_attention); {DEC_STEPS} greedy decode steps, launches "
          f"{n['decode_attention']} decode_attention ({cfg.n_layers} per "
          f"step); host wall ms per step median "
          f"{statistics.median(step_ms):.2f} (first {step_ms[0]:.2f}, min "
          f"{min(step_ms):.2f}, max {max(step_ms):.2f}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # the first step against the full forward over prompt + token
    r = DEC_TOL["forward_rows"]
    full = torch.cat([prompt[:r], toks[0][:r, None]], dim=1)
    fwd = tfm.logits_from_hidden(params, tfm.forward_hidden(
        params, full, dataclasses.replace(cfg, attn_impl="chunked"))[:, -1])
    f_err = close_errors(torch, outs[0][:r], fwd)
    print(f"[decode] first step vs forward_hidden over prompt + token "
          f"({r} rows, {full.shape[1]} tokens): max |err| {f_err[0]:.4g}, "
          f"relative L2 {f_err[1]:.3g} (tolerance "
          f"{DEC_TOL['forward_rel_l2']})")
    if f_err[1] > DEC_TOL["forward_rel_l2"]:
        raise AssertionError("decode step differs from the full forward")
    del fwd, full

    # the torch backend, teacher-forced with the cuda run's tokens
    ops.reset_launch_counts()
    plain, replay_ms, errs, agree = start, [], [], 0
    for i in range(DEC_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, plain = tfm.decode_step(params, plain, toks[i], cfg,
                                        backend="torch")
        torch.cuda.synchronize()
        replay_ms.append((time.perf_counter() - t0) * 1e3)
        errs.append(close_errors(torch, outs[i], logits))
        agree += int((outs[i].argmax(-1) == logits.argmax(-1)).sum())
    if sum(ops.launch_counts().values()):
        raise AssertionError(f"torch replay launched kernels: "
                             f"{ops.launch_counts()}")
    worst = (max(e[0] for e in errs), max(e[1] for e in errs))
    print(f"[decode] torch-backend replay (decode_attention_local), "
          f"teacher-forced: host wall ms per step median "
          f"{statistics.median(replay_ms):.2f}; logits max |err| "
          f"{worst[0]:.4g}, worst relative L2 {worst[1]:.3g} (tolerance "
          f"{DEC_TOL['replay_rel_l2']}); greedy choices agree on "
          f"{agree}/{DEC_STEPS * DEC_B} ({agree / (DEC_STEPS * DEC_B):.4f}); "
          f"relative L2 by step: " + ", ".join(
              f"{i}: {errs[i][1]:.4f}" for i in (0, 1, 3, 7, 15, 31, 63, 127)))
    if worst[1] > DEC_TOL["replay_rel_l2"]:
        raise AssertionError("decode logits differ between backends beyond "
                             "the tolerance")

    # the control: the same replay with one 64-position tile of v zeroed in
    # every layer (an attention that loses a tile) must fail the bar
    lo, hi = DEC_CTRL_TILE
    start.v[:, :, lo:hi] = 0                   # start shares plain's k/v
    bad, ctrl = start, []
    for i in range(DEC_CTRL_STEPS):
        logits, bad = tfm.decode_step(params, bad, toks[i], cfg,
                                      backend="torch")
        ctrl.append(close_errors(torch, outs[i], logits)[1])
    print(f"[decode] control: the replay with v zeroed at positions "
          f"{lo}..{hi - 1} of every layer reads relative L2 "
          + ", ".join(f"{e:.3g}" for e in ctrl)
          + f" over {DEC_CTRL_STEPS} steps (must exceed "
          f"{DEC_TOL['replay_rel_l2']})")
    if min(ctrl) <= DEC_TOL["replay_rel_l2"]:
        raise AssertionError("the replay bar does not separate a one-tile "
                             "fault")
    del plain, start, bad, outs

    # the float32 twin: the same path at B=8 without bf16 rounding
    f32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tfm.init_params(torch.Generator(device=dev).manual_seed(0), f32,
                          dev)
    lg, c32 = tfm.prefill_step(p32, prompt[:DEC_F32_B], f32, backend="cuda",
                               max_seq=DEC_MAX)
    t32 = tfm.KVCache(c32.k.clone(), c32.v.clone(), c32.length.clone())
    tok32 = lg.argmax(-1).to(torch.int32)
    f_errs = []
    for _ in range(DEC_F32_STEPS):
        a, c32 = tfm.decode_step(p32, c32, tok32, f32, backend="cuda")
        b, t32 = tfm.decode_step(p32, t32, tok32, f32, backend="torch")
        f_errs.append(close_errors(torch, a, b)[1])
        tok32 = a.argmax(-1).to(torch.int32)
    print(f"[decode] float32 twin (B={DEC_F32_B}, {DEC_F32_STEPS} steps from "
          f"the same prompt): cuda vs torch logits worst relative L2 "
          f"{max(f_errs):.3g} (tolerance {DEC_TOL['f32_rel_l2']})")
    if max(f_errs) > DEC_TOL["f32_rel_l2"]:
        raise AssertionError("float32 decode logits differ between backends")
    del p32, c32, t32

    # one more full-length step (position 2047 again) under the profiler
    again = tfm.KVCache(cache.k, cache.v, torch.full_like(cache.length,
                                                          DEC_MAX - 1))
    got = phase_profile(torch, "profile decode", 1,
                        lambda: tfm.decode_step(params, again, tok, cfg,
                                                backend="cuda"))
    if got is not None:
        by_group, wall_ms = got
        busy = sum(by_group.values()) / 1e3
        dec = by_group.get("decode_attention", 0.0) / 1e3
        unprof = statistics.median(step_ms)
        print(f"[profile decode] decode_attention {dec:.3f} ms "
              f"({dec / busy:.1%} of device time); unprofiled step "
              f"{unprof:.2f} ms host wall, idle share estimate "
              f"{1 - busy / unprof:.3f}")


# ------------------------------------------------------------ phase 9
# the overload arm at SASRec's published widths over phase 2's stream
# (20,000 users, 10 minutes: 119 steps of B=512, 47 pre, 24 outage, 48
# post), Table 3's failure range in the outage window
OVERLOAD = dict(arch="sasrec", minutes=10, users=20_000, batch=BATCH,
                budget_frac=0.5, failure_rate=0.02, failure_burst_rate=0.2,
                n_buckets=N_BUCKETS, smoke=False)
OVERLOAD_MIN_SPAN = 8                        # steps in each phase, at least
OVERLOAD_PROFILE_CHUNK = 16                  # steps a profiled chunk


def overload_profile(torch, launch, dev, rep):
    """Replay the cuda overload run chunk by chunk and profile the last
    (warm) chunk of pre and the first chunk of the outage, each continuing
    the replay's state. The set-up (tower, tiers, stream, calibration) is
    done before any profile starts; the replay's pre counters must equal
    the checked run's."""
    import dataclasses

    from repro_torch.core import server as srv
    from repro_torch.core.metrics import ServingCounters

    plan = launch.plan_overload(backend="cuda", device=dev, **OVERLOAD)
    n_pre = plan.spans[0][2]
    last_pre = -(-n_pre // OVERLOAD_PROFILE_CHUNK) - 1
    state, pre, prof = plan.state, ServingCounters(), {}
    for i, (phase, server, staged) in enumerate(
            launch.overload_chunks(plan, OVERLOAD_PROFILE_CHUNK)):
        steps = int(staged[2].shape[0])
        box = {}

        def drive(server=server, staged=staged, state=state, box=box):
            box["out"] = server.serve_many(plan.params, state, *staged,
                                           flush_every=1, collect=False)
            return box["out"][1]

        if i in (last_pre, last_pre + 1):
            prof[phase] = (steps, phase_profile(
                torch, f"profile overload {phase}", steps, drive))
        else:
            drive()
        state, acc, _ = box["out"]
        if phase != "pre":
            break
        pre.merge(ServingCounters.from_stats(srv.fetch_counters(acc)))
    want = rep["phases"]["pre"]
    for f in dataclasses.fields(ServingCounters):
        if getattr(pre, f.name) != want[f.name]:
            raise AssertionError(f"profile replay pre.{f.name} "
                                 f"{getattr(pre, f.name)} != {want[f.name]}")
    for phase, (steps, res) in prof.items():
        if res is None:
            continue
        busy_ms = sum(res[0].values()) / 1e3
        print(f"[profile overload {phase}] {steps} steps: device kernel "
              f"time {busy_ms / steps:.3f} ms a step against the "
              f"unprofiled run's {rep['step_ms']:.3f} ms host step (all "
              f"119 steps, staging included; each chunk is its graph's "
              f"first call, an eager run and a capture, phase 11 times "
              f"replays): idle share estimate "
              f"{1 - busy_ms / (rep['step_ms'] * steps):.3f}")


def phase_overload(torch):
    import dataclasses

    from repro_torch.core.metrics import ServingCounters
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch

    dev = torch.device("cuda")
    runs = {}
    for backend in ("cuda", "torch"):
        plan = launch.plan_overload(backend=backend, device=dev, **OVERLOAD)
        ops.reset_launch_counts()                # this path's window
        report, state = launch.overload_timeline(
            plan, log=lambda s, b=backend: print(f"[overload {b}] {s}"))
        runs[backend] = (report, state, ops.launch_counts())
        del plan
    (rep, st, n), (rep_t, st_t, n_t) = runs["cuda"], runs["torch"]
    ph, steps = rep["phases"], rep["batches"]
    spans = {p: ph[p]["requests"] // BATCH for p in ph}
    if n["cache_probe_dual"] != steps or n["embedding_bag"] <= 0:
        raise AssertionError(f"launches {n} for {steps} overload steps: "
                             "want one dual probe a step and the bag")
    if sum(n_t.values()):
        raise AssertionError(f"the torch backend launched kernels: {n_t}")
    if min(spans.values()) < OVERLOAD_MIN_SPAN:
        raise AssertionError(f"overload spans {spans}: fewer than "
                             f"{OVERLOAD_MIN_SPAN} steps in a phase")
    out = ph["outage"]
    if not (out["deferred"] > 0 and out["failover_serves"] > 0
            and out["mean_failover_stale_ms"] > 0
            and out["fallback_rate"] < out["fallback_rate_wo_failover"]):
        raise AssertionError(f"the outage did not degrade through the "
                             f"relaxed failover tier: {out}")
    if ph["pre"]["deferred"] or ph["post"]["deferred"]:
        raise AssertionError("misses deferred at full capacity")
    for p in ph:
        for f in dataclasses.fields(ServingCounters):
            if ph[p][f.name] != rep_t["phases"][p][f.name]:
                raise AssertionError(f"overload {p}.{f.name} differs "
                                     "between backends")
    for tier in ("direct", "failover"):
        for name, a, b in zip(getattr(st, tier)._fields, getattr(st, tier),
                              getattr(st_t, tier)):
            if not torch.equal(a, b):
                raise AssertionError(f"overload {tier}.{name} differs "
                                     "between backends")
    if not torch.equal(st.budget.tokens, st_t.budget.tokens):
        raise AssertionError("overload budget tokens differ between backends")
    print(f"[overload] SASRec full width, {N_BUCKETS}x{WAYS} tiers, "
          f"B={BATCH}, {OVERLOAD['users']} users over "
          f"{OVERLOAD['minutes']} min, budget {rep['budget_per_step']}/step "
          f"(0.5 of miss demand {rep['provisioned_miss_rate']}), steps "
          f"pre/outage/post {spans['pre']}/{spans['outage']}/"
          f"{spans['post']}, launches {n}; outage deferred "
          f"{out['deferred']}, failover serves {out['failover_serves']} "
          f"(mean stale {out['mean_failover_stale_ms']} ms), fallback rate "
          f"{out['fallback_rate']} vs {out['fallback_rate_wo_failover']} "
          f"without failover")
    print(f"[overload] host ms per step cuda {rep['step_ms']} torch "
          f"{rep_t['step_ms']}; cuda and torch backends bit-identical: every "
          f"per-phase counter, all 5 planes of both tiers, the budget tokens")
    del runs, st, st_t
    overload_profile(torch, launch, dev, rep)


# ------------------------------------------------------------ phase 10
def phase_entry_overload(torch):
    import contextlib
    import io

    from repro_torch.examples import quickstart
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch

    ops.reset_launch_counts()
    d = launch.run_serving_overload(
        minutes=8, users=400, backend="cuda",
        log=lambda s: print(f"[entry overload] {s}"))
    n = ops.launch_counts()
    if (n["cache_probe_dual"] != d["batches"] or n["embedding_bag"] <= 0
            or sum(p["requests"] for p in d["phases"].values()) <= 0):
        raise AssertionError(f"overload entry point: {d['batches']} "
                             f"batches, launches {n}")
    lines = []
    for kw in (dict(), dict(device="cpu", backend="torch")):
        ops.reset_launch_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            quickstart.main(**kw)
        lines.append(buf.getvalue().splitlines())
        if not kw:
            n = ops.launch_counts()
    for ln in lines[0]:
        print(f"[quickstart] {ln}")
    if n["cache_probe_dual"] != 3 or sum(n.values()) != 3:
        raise AssertionError(f"quickstart launches {n}: want 3 dual probes")
    if lines[0] != lines[1] or len(lines[0]) != 5:
        raise AssertionError("quickstart on the card differs from its CPU "
                             "run on the plain versions")
    print("[quickstart] 3 dual-probe launches; the same lines as its CPU "
          "run on the plain versions")


# ------------------------------------------------------------ phase 11
COMPILED_CHUNK = 64                          # the launchers' chunk_steps
COMPILED_STEPS = 119                         # phase 2's whole stream
LM_COMPILED_STEPS = 3                        # the first one captures


def serve_chunks(torch, jit, params, state, calls):
    """Serve ``calls`` [(server, inputs, steps)] through each server's
    ``jit_serve_many`` (``jit``) or ``serve_many``, fetching each chunk's
    counters as the launchers do. Returns the counters, outputs and
    launches of each call, the host wall in ms and the final state."""
    from repro_torch.core import server as srv
    from repro_torch.kernels import ops

    out = {"chunks": [], "ys": [], "launches": []}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for server, inputs, _ in calls:
        run = server.jit_serve_many if jit else server.serve_many
        before = ops.launch_counts()
        state, acc, ys = run(params, state, *inputs, flush_every=1)
        out["chunks"].append(srv.fetch_counters(acc))
        after = ops.launch_counts()
        out["launches"].append({k: after[k] - before[k] for k in after
                                if after[k] != before[k]})
        out["ys"].append(ys)
    torch.cuda.synchronize()
    out["wall_ms"] = (time.perf_counter() - t0) * 1e3
    out["state"] = state
    return out


def same_run(torch, a, b):
    return a["chunks"] == b["chunks"] and all(
        torch.equal(x, y) for ya, yb in zip(a["ys"], b["ys"])
        for x, y in zip(ya, yb))


def compiled_cell(torch, tag, params, calls, init, probe):
    """One SASRec cell eager against compiled over the same staged chunks,
    from identically initialised states: a first compiled run captures
    each chunk shape's graph (and serves it); then eager, compiled,
    compiled, eager, each from its state reset in place, so the compiled
    runs replay. Asserts bit-identity of counters, outputs and every
    state tensor, and each call's launches; profiles one chunk of each."""
    from repro_torch.core.graph import tensors_of

    torch.cuda.empty_cache()
    t_cell = time.perf_counter()
    fresh, states = init(), {False: init(), True: init()}

    def reset(state):
        for a, b in zip(tensors_of(state), tensors_of(fresh), strict=True):
            a.copy_(b)

    steps = sum(n for *_, n in calls)
    servers = list({id(c[0]): c[0] for c in calls}.values())
    graphs = lambda: [g for sv in servers
                      for g in sv.jit_serve_many.graphs.values()]
    reset(states[True])
    prime = serve_chunks(torch, True, params, states[True], calls)
    captured = graphs()
    runs = {False: [], True: []}
    for i, jit in enumerate((False, True, True, False)):
        reset(states[jit])
        runs[jit].append(serve_chunks(torch, jit, params, states[jit],
                                      calls))
        if i == 1:
            for name, (a, b) in enumerate(zip(
                    tensors_of(runs[False][0]["state"]),
                    tensors_of(runs[True][0]["state"]))):
                if not torch.equal(a, b):
                    raise AssertionError(f"{tag}: state tensor {name} "
                                         "differs, compiled vs eager")
    if len(graphs()) != len(captured):
        raise AssertionError(f"{tag}: a replay run captured again")
    (e1, e2), (j1, j2) = runs[False], runs[True]
    for name, run in (("the capturing run", prime), ("replay 1", j1),
                      ("replay 2", j2), ("eager 2", e2)):
        if not same_run(torch, e1, run):
            raise AssertionError(f"{tag}: {name} differs from eager in "
                                 "counters or outputs")
    for run in (prime, j1, j2, e1):
        for (_, _, n), got in zip(calls, run["launches"]):
            if got != {probe: n, "embedding_bag": n}:
                raise AssertionError(f"{tag}: launches {got} for a "
                                     f"{n}-step chunk")
    ms = {jit: [r["wall_ms"] / steps for r in runs[jit]]
          for jit in (False, True)}
    print(f"[compiled {tag}] {len(captured)} graphs captured (chunks of "
          + "/".join(str(g.launches[probe]) for g in captured)
          + " steps, each whole chunk with its flushes one graph): capture "
          + "/".join(f"{g.capture_s:.2f}" for g in captured) + " s, graph "
          "pools " + "/".join(f"{g.pool_bytes / 1e6:.1f}" for g in captured)
          + f" MB; the capturing run {prime['wall_ms'] / steps:.2f} ms a "
          f"step over {steps} steps")
    print(f"[compiled {tag}] host wall ms a step (eager/compiled/compiled/"
          f"eager, {steps} steps each): {ms[False][0]:.3f} / "
          f"{ms[True][0]:.3f} / {ms[True][1]:.3f} / {ms[False][1]:.3f}; "
          f"bit-identical: counters, sources, ages, embeddings, every state "
          f"tensor; launches per replay {captured[0].launches}")
    busy = {}
    for jit in (False, True):
        reset(states[jit])
        server, inputs, n = calls[0]
        run = server.jit_serve_many if jit else server.serve_many
        got = phase_profile(
            torch, f"profile compiled {tag} {'compiled' if jit else 'eager'}",
            n, lambda: run(params, states[jit], *inputs, flush_every=1)[1])
        if got is not None:
            busy[jit] = sum(got[0].values()) / 1e3 / n
    if len(busy) == 2:
        print(f"[compiled {tag}] device kernel time a step eager "
              f"{busy[False]:.3f} ms, compiled {busy[True]:.3f} ms; "
              f"unprofiled idle share eager "
              f"{1 - busy[False] / statistics.median(ms[False]):.3f}, "
              f"compiled {1 - busy[True] / statistics.median(ms[True]):.3f}")
    print(f"[compiled {tag}] cell done in {time.perf_counter() - t_cell:.1f}s")


def compiled_lm(torch):
    """The LM example's step eager (``serve_step`` + ``flush``) against
    compiled (its own ``serve_steps``: ``jit_serve_step`` +
    ``jit_flush``) at full width, eager/compiled/compiled/eager, each run
    from a fresh deployment whose first compiled step captures."""
    from repro_torch.core import server as srv
    from repro_torch.examples import serve_lm_tower as ex
    from repro_torch.models import transformer as tfm

    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    cfg = lm_config()
    params = tfm.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                             dev)
    kw = dict(seq=LM_SEQ, batch=64, minutes=LM_MINUTES, users=LM_USERS,
              failure_rate=0.02, device=dev, backend="cuda")

    def eager_steps():
        server, state, batches = ex.deployment(cfg, **kw)
        for keys, tokens, now, fails in batches:
            res = server.serve_step(params, state, keys, tokens, now, fails)
            state = server.flush(res.state, now)
            yield res, srv.fetch_counters(res.stats), state

    runs = {False: [], True: []}
    for jit in (False, True, True, False):
        gen = ex.serve_steps(cfg, params, **kw) if jit else eager_steps()
        out = {"ms": [], "res": [], "stats": []}
        for _ in range(LM_COMPILED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, stats, state = next(gen)
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["res"].append(res)
            out["stats"].append(stats)
        out["state"] = state
        runs[jit].append(out)
        del gen
    e, j = runs[False][0], runs[True][0]
    if e["stats"] != j["stats"] or not all(
            torch.equal(a.source, b.source) and torch.equal(a.age_ms,
                                                            b.age_ms)
            for a, b in zip(e["res"], j["res"])):
        raise AssertionError("LM: compiled steps differ from eager in "
                             "sources, ages or counters")
    errs = [close_errors(torch, b.embeddings, a.embeddings)
            for a, b in zip(e["res"], j["res"])]
    errs += [close_errors(torch, getattr(j["state"], t).values,
                          getattr(e["state"], t).values)
             for t in ("direct", "failover")]
    worst = (max(x[0] for x in errs), max(x[1] for x in errs))
    if worst[0] > LM_TOL["max_abs"] or worst[1] > LM_TOL["rel_l2"]:
        raise AssertionError(f"LM: compiled embeddings off by {worst}")
    warm = lambda r: statistics.median(r["ms"][1:])
    print(f"[compiled lm] TinyLlama-1.1B full width, seq {LM_SEQ}, B=64: "
          f"host wall ms a step, first / warm median, eager/compiled/"
          f"compiled/eager: " + " | ".join(
              f"{r['ms'][0]:.1f} / {warm(r):.1f}" for r in (
                  runs[False][0], runs[True][0], runs[True][1],
                  runs[False][1]))
          + f"; sources, ages, counters equal, embeddings and value planes "
          f"max |err| {worst[0]:.3g} (bit-identical: {worst[0] == 0})")


def phase_compiled(torch):
    """Phase 11: the compiled entry points against eager ``serve_many`` in
    the single-model, multi-model and overload cells, and the LM
    example's step."""
    import dataclasses

    import numpy as np

    from repro_torch.core import server as srv
    from repro_torch.core.config import CacheConfig, multi_model_tier_configs
    from repro_torch.core.hashing import Key64
    from repro_torch.launch import serve as launch

    dev = torch.device("cuda")
    tcfg, params, tower_fn, features_of = launch.build_tower(
        "sasrec", backend="cuda", device=dev, smoke=False, seed=0)
    keys, feats, nows, _ = staged_stream(torch, launch, features_of, dev,
                                         COMPILED_STEPS)

    def chunk_inputs(lo, n):
        sl = slice(lo, lo + n)
        return (Key64(keys.hi[sl], keys.lo[sl]),
                {k: v[sl] for k, v in feats.items()}, nows[sl])

    spans = list(launch._chunks(COMPILED_STEPS, COMPILED_CHUNK))
    cfg = CacheConfig(model_id=1, model_type="ctr", n_buckets=N_BUCKETS,
                      ways=WAYS, value_dim=tcfg.user_embed_dim,
                      miss_budget_frac=0.75, backend="cuda")
    server = srv.CachedEmbeddingServer(cfg=cfg, tower_fn=tower_fn,
                                       miss_budget=int(BATCH * 0.75))
    compiled_cell(
        torch, "single", params,
        [(server, chunk_inputs(lo, n), n) for lo, n in spans],
        lambda: srv.init_server_state(cfg, writebuf_capacity=BATCH * 4,
                                      device=dev), "cache_probe_dual")

    cfgs = [dataclasses.replace(c, backend="cuda")
            for c in multi_model_tier_configs(
                value_dim=tcfg.user_embed_dim, n_buckets=MULTI_BUCKETS)]
    multi = srv.MultiModelServer(cfgs=tuple(cfgs), tower_fn=tower_fn,
                                 miss_budget=int(BATCH * 0.75), device=dev)
    slots = torch.as_tensor(
        (np.arange(BATCH)[None, :] + np.arange(COMPILED_STEPS)[:, None]) % 8,
        dtype=torch.int32, device=dev)
    compiled_cell(
        torch, "multi", params,
        [(multi, (slots[lo:lo + n], *chunk_inputs(lo, n)), n)
         for lo, n in spans],
        lambda: srv.init_multi_server_state(cfgs, writebuf_capacity=BATCH * 4,
                                            device=dev),
        "cache_probe_dual_multi")
    del keys, feats, nows, slots, server, multi, params

    plan = launch.plan_overload(backend="cuda", device=dev, **OVERLOAD)
    plan.state = None
    compiled_cell(
        torch, "overload", plan.params,
        [(sv, staged, int(staged[2].shape[0]))
         for _, sv, staged in launch.overload_chunks(plan, COMPILED_CHUNK)],
        lambda: srv.init_server_state(plan.spans[1][3].cfg,
                                      writebuf_capacity=BATCH * 4,
                                      device=dev), "cache_probe_dual")
    del plan
    compiled_lm(torch)


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
    phase_shootout(torch, results, counts)
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
    phase_lm(torch, counts)
    print(f"[time] LM serve and profile phases done at "
          f"{time.perf_counter() - t0:.1f}s")
    phase_lm_entry(torch)
    print(f"[time] LM entry phase done at {time.perf_counter() - t0:.1f}s")
    phase_decode(torch, counts)
    print(f"[time] LM decode and profile phases done at "
          f"{time.perf_counter() - t0:.1f}s")
    phase_overload(torch)
    print(f"[time] overload and profile phases done at "
          f"{time.perf_counter() - t0:.1f}s")
    phase_entry_overload(torch)
    print(f"[time] overload and quickstart entry phase done at "
          f"{time.perf_counter() - t0:.1f}s")
    phase_compiled(torch)
    print(f"[time] compiled phase done at {time.perf_counter() - t0:.1f}s")

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
