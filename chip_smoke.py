#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. **kernels**: build every CUDA kernel of the serve path from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, all at once), then
   hold each against its plain PyTorch version at the serve path's shapes
   (B=512 queries on 2**20 x 8-way tables of D=50 float32; the SASRec
   item gather on the 1,000,000 x 50 table) and time both on the card.
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
        out["chunks"].append(srv.fetch_counters(acc))   # syncs
        out["step_ms"].append((time.perf_counter() - t0) * 1e3 / chunk)
        out["src"].append(ys[1])
        out["age"].append(ys[2])
        out["emb_finite"] &= bool(torch.isfinite(ys[0]).all())
        if tuple(ys[0].shape) != (chunk, BATCH, tcfg.user_embed_dim):
            raise AssertionError(f"embeddings shape {tuple(ys[0].shape)}")
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

    ops.reset_launch_counts()                    # the main path's window
    cuda = serve_run(torch, "cuda", stream, chunk)
    counts.update(ops.launch_counts())
    steps = 2 * chunk
    if counts["cache_probe_dual"] != steps:
        raise AssertionError(f"{counts['cache_probe_dual']} dual-probe "
                             f"launches for {steps} serve steps")
    if min(counts.values()) <= 0:
        raise AssertionError(f"kernel not launched on the path: {counts}")
    cold, warm = cuda["chunks"]
    hit = [c["direct_hits"] / c["requests"] for c in cuda["chunks"]]
    print(f"[serve] SASRec full width (embed 50, 2 blocks, seq 50, vocab "
          f"1M), {N_BUCKETS}x{WAYS} tiers, B={BATCH}, miss_budget "
          f"{int(BATCH * 0.75)}: {steps} steps, launches {counts}, hit rate "
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
    for a, b in zip(cuda["src"] + cuda["age"], plain["src"] + plain["age"]):
        if not torch.equal(a, b):
            raise AssertionError("sources/ages differ between backends")
    if cuda["chunks"] != plain["chunks"]:
        raise AssertionError("counters differ between backends")
    for tier in ("direct", "failover"):
        for name, a, b in zip(cuda["state"].direct._fields,
                              getattr(cuda["state"], tier),
                              getattr(plain["state"], tier)):
            if not torch.equal(a, b):
                raise AssertionError(f"{tier}.{name} differs between "
                                     "backends")
    print("[serve] cuda and torch backends bit-identical: sources, ages, "
          "counters, all 5 planes of both tiers")
    del plain
    phase_profile(torch, cuda, stream, chunk)


KERNEL_GROUPS = (("cache_probe", ("probe_kernel",)),
                 ("embedding_bag", ("bag_kernel",)),
                 ("matmul", ("gemm", "xmma", "cutlass", "sm90_")),
                 ("sort", ("sort", "radix", "cub::")),
                 ("index/scatter", ("index", "scatter", "gather")),
                 ("reduce", ("reduce",)),
                 ("elementwise", ("elementwise", "vectorized")),
                 ("memcpy/memset", ("memcpy", "memset")))


def phase_profile(torch, run, stream, chunk):
    """Where a warm serve step's time goes: torch.profiler over one more
    chunk of the cuda run (continuing its state), device kernel time by
    group against the host wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import server as srv
    from repro_torch.core.hashing import Key64

    keys, feats, nows, _ = stream
    sl = slice(2 * chunk, 3 * chunk)
    args = (Key64(keys.hi[sl], keys.lo[sl]),
            {k: v[sl] for k, v in feats.items()}, nows[sl])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, acc, _ = run["server"].serve_many(
            run["params"], run["state"], *args, flush_every=1,
            collect=False)
        srv.fetch_counters(acc)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("[profile] device time not measured (the profiler recorded "
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
    print(f"[profile] warm chunk of {chunk} steps under torch.profiler: "
          f"{wall_ms / chunk:.3f} ms host wall per step, "
          f"{busy_ms / chunk:.3f} ms device kernel time per step, device "
          f"idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{len(kernels) / chunk:.0f} device ops per step")
    print("[profile] device us per step by group: " + ", ".join(
        f"{g} {us / chunk:.1f}" for g, us in sorted(
            by_group.items(), key=lambda kv: -kv[1])))
    print("[profile] top device ops, us per step: " + "; ".join(
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
