"""One run of one cell: set-up, the measured window, the traced slice, the
check, and the result.

The window is a closed loop with one batch in flight: one ranking client
stages a batch (ids, features, clock, failure mask) on the device, calls
``CachedEmbeddingServer.jit_serve_many`` with one step (``flush_every=1``,
``collect=True``: one CUDA graph covers the probe, the tower, the ring
append and the flush), copies the batch's embeddings, sources and ages to
the host, and only then stages the next batch. Set-up makes the weights,
the stream, the features and both tiers' image from the seed, and serves
``warmup_batches`` batches (the first call runs eagerly and captures the
graph; the next replays it) before the window opens.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import subprocess
import time
import types
from pathlib import Path

import numpy as np
import torch

from bench import check as check_lib
from bench import tracing
from bench import work
from bench.reference import ercache as ref_tier
from bench.reference.precision import matmul_at
from bench.stream import (Features, ImageValues, Traffic, image_tiers,
                          make_stream)

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
# the program's counters each answer carries back (all int32)
COUNTERS = ("direct_hits", "tower_inferences", "tower_failures", "overflow",
            "failover_hits", "failover_serves", "fallbacks")
# batches the profiler runs before the slice it keeps (its own start-up)
PROFILER_WARMUP = 2
# tower replays timed: many for a small tower, few for a large one
TOWER_REPLAYS = (20, 3)
# device memory a chunk of the staged stream takes while it is laid out
STAGE_CHUNK_BYTES = 1 << 30
# image slots given their values at once
VALUE_CHUNK = 1 << 20


@dataclasses.dataclass
class Cell:
    name: str
    cfg: dict
    traffic: Traffic
    chips: int
    end_to_end: list
    per_layer: list

    @property
    def miss_budget(self) -> int:
        return max(int(self.traffic.batch * self.cfg["cache"]["miss_budget_frac"]),
                   1)

    @property
    def ring(self) -> int:
        return self.cfg["cache"]["ring_factor"] * self.traffic.batch


def load_cell(name: str, bench_json: Path = ROOT / "BENCHMARK.json",
              traffic_dir: Path = BENCH / "traffic") -> Cell:
    """The cell ``name`` of ``bench_json``: its configuration file, its
    traffic file (``<traffic_dir>/<traffic>.json``) and its metrics."""
    bench = json.loads(Path(bench_json).read_text())
    wl = [w for w in bench["workloads"] if w["name"] == name]
    if not wl:
        raise SystemExit(f"no workload {name!r} in {bench_json}")
    wl = wl[0]
    conf = [c for c in bench["configs"] if c["name"] == wl["config"]][0]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = Traffic.from_json(json.loads(
        (Path(traffic_dir) / f"{wl['traffic']}.json").read_text()))
    mine = lambda m: name in m.get("workloads", [name])
    return Cell(name, cfg, traffic, wl["chips"],
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)])


def family(cfg: dict, device, backend: str):
    mod = importlib.import_module(f"bench.towers.{cfg['family']}")
    return mod.Family(cfg, device, backend)


def base_name(name: str) -> str:
    """A metric's name up to its first dot: ``mfu.lm`` is ``mfu`` read in
    the cells that report ``req_per_s.lm``."""
    return name.split(".")[0]


def metric_reader(name: str):
    """``bench/metrics/<base name>.py``'s ``read(ctx)``."""
    base = base_name(name)
    path = BENCH / "metrics" / f"{base}.py"
    spec = importlib.util.spec_from_file_location("bench_metric_" + base,
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out[0] if out else "not read"


class Stager:
    """Every batch's request as it reaches the server: set-up lays each
    batch out in one pinned host block (key words, clock, feature ids) and
    its failure mask beside it; staging batch i is one host-to-device copy
    of each."""

    def __init__(self, stream, feats, fam, failures: bool, device):
        pinned = device.type == "cuda"
        B, S, n = stream.batch, feats.width, stream.n_batches
        width = 2 * B + 1 + B * S
        self.B, self.S, self.fam = B, S, fam
        self.host = torch.empty((n, width), dtype=torch.int32,
                                pin_memory=pinned)
        uid = torch.as_tensor(stream.uid[:n * B], device=device).view(n, B)
        now = torch.as_tensor(stream.t_ms[B - 1:n * B:B], dtype=torch.int64,
                              device=device)
        step = max(1, STAGE_CHUNK_BYTES // (4 * width))
        for lo in range(0, n, step):
            u, t = uid[lo:lo + step], now[lo:lo + step]
            ids = feats.of(u.reshape(-1), t.repeat_interleave(B))
            self.host[lo:lo + u.shape[0]].copy_(torch.cat(
                [(u >> 32).to(torch.int32), (u & 0xFFFFFFFF).to(torch.int32),
                 t[:, None].to(torch.int32), ids.view(u.shape[0], -1)], dim=1))
        self.dev = torch.empty(width, dtype=torch.int32, device=device)
        self.fhost = self.fdev = None
        if failures:
            self.fhost = torch.empty((n, B), dtype=torch.bool,
                                     pin_memory=pinned)
            self.fhost.copy_(torch.as_tensor(stream.fail[:n * B]).view(n, B))
            self.fdev = torch.empty(B, dtype=torch.bool, device=device)

    def stage(self, i: int):
        from repro_torch.core.hashing import Key64

        B, S = self.B, self.S
        self.dev.copy_(self.host[i], non_blocking=True)
        d = self.dev
        fails = None
        if self.fhost is not None:
            self.fdev.copy_(self.fhost[i], non_blocking=True)
            fails = self.fdev.view(1, B)
        return (Key64(d[:B].view(1, B), d[B:2 * B].view(1, B)),
                self.fam.program_features(d[2 * B + 1:].view(1, B, S)),
                d[2 * B:2 * B + 1], fails)


class Answers:
    """Each batch's answer copied to the host with its counters: sources,
    ages and counters kept for every batch, embeddings for the sampled
    ones. Nothing of a batch stays on the device once it is answered."""

    def __init__(self, n_max: int, B: int, D: int, device, keep):
        pinned = device.type == "cuda"
        self.cuda = pinned
        self.src = np.zeros((n_max, B), np.int32)
        self.age = np.zeros((n_max, B), np.int32)
        self.cnt = np.zeros((n_max, len(COUNTERS)), np.int64)
        self.h_emb = torch.empty((B, D), dtype=torch.float32, pin_memory=pinned)
        self.h_src = torch.empty(B, dtype=torch.int32, pin_memory=pinned)
        self.h_age = torch.empty(B, dtype=torch.int32, pin_memory=pinned)
        self.h_cnt = torch.empty(len(COUNTERS), dtype=torch.int32,
                                 pin_memory=pinned)
        self.emb = {}
        self.keep = keep

    def take(self, i: int, ys, acc) -> None:
        emb, src, age = ys
        self.h_emb.copy_(emb[0], non_blocking=True)
        self.h_src.copy_(src[0], non_blocking=True)
        self.h_age.copy_(age[0], non_blocking=True)
        self.h_cnt.copy_(torch.stack([acc[k] for k in COUNTERS]),
                         non_blocking=True)
        if self.cuda:
            torch.cuda.current_stream().synchronize()
        self.src[i] = self.h_src.numpy()
        self.age[i] = self.h_age.numpy()
        self.cnt[i] = self.h_cnt.numpy()
        if self.keep(i):
            self.emb[i] = self.h_emb.numpy().copy()

    def counters(self, n: int) -> dict:
        return {k: self.cnt[:n, j] for j, k in enumerate(COUNTERS)}


def _program_tier(t: ref_tier.Tier, values: ImageValues):
    """The program's CacheState of a reference tier: keys and times
    copied, each image entry's value its user's ``values[uid]``."""
    from repro_torch.core.cache import CacheState

    where = torch.nonzero(t.origin != ref_tier.FROM_NONE)
    uid = (t.key_hi.long() << 32) | (t.key_lo.long() & 0xFFFFFFFF)
    vals = torch.zeros(t.key_hi.shape + (values.dim,), dtype=torch.float32,
                       device=t.slots.device)
    for a in range(0, where.shape[0], VALUE_CHUNK):
        b, w = where[a:a + VALUE_CHUNK].unbind(1)
        vals[b, w] = values[uid[b, w]]
    return CacheState(key_hi=t.key_hi.clone(), key_lo=t.key_lo.clone(),
                      write_ts=t.ts.clone(), values=vals,
                      last_access_ts=t.ts.clone())


def _server(cell, fam, weights, control: bool):
    """The program's server; the control puts the reference, one
    precision below the configuration's, in the tower's place."""
    from repro_torch.core import server as srv
    from repro_torch.core.config import CacheConfig

    c = cell.cfg["cache"]
    ccfg = CacheConfig(
        model_id=1, model_type="ctr", cache_ttl_ms=c["cache_ttl_ms"],
        failover_ttl_ms=c["failover_ttl_ms"], n_buckets=c["n_buckets"],
        ways=c["ways"], value_dim=fam.value_dim,
        failover_n_buckets=c["failover_n_buckets"],
        failover_ways=c["failover_ways"],
        miss_budget_frac=c["miss_budget_frac"], backend=fam.backend,
        eviction=c["eviction"], coalesce_misses=c["coalesce_misses"])
    tower = fam.tower_fn()
    if control:
        tower = fam.reference_tower_fn(
            weights, matmul_at(cell.cfg["control_precision"]),
            cell.miss_budget)
    return ccfg, srv.CachedEmbeddingServer(
        cfg=ccfg, tower_fn=tower, miss_budget=cell.miss_budget)


def run(cell: Cell, seed: int, seconds: float, trace: bool, *, device,
        t_start: float, marks=(), control: bool = False,
        log=print) -> dict:
    """One run (module docstring). ``t_start`` is the process's start on
    the host clock, from which set-up is counted; ``marks`` are the
    caller's (name, host clock) steps before this call. ``control`` runs
    the control: the reference one precision below in the tower's place,
    called eagerly."""
    from repro_torch.core import server as srv

    cuda = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sync = torch.cuda.synchronize if cuda else (lambda *a: None)
    tr, c = cell.traffic, cell.cfg["cache"]
    fam = family(cell.cfg, device, "cuda" if cuda else "torch")
    gen = torch.Generator(device=device).manual_seed(seed & (2 ** 63 - 1))

    # ------------------------------------------------------------ set-up
    marks = list(marks) + [("program", time.perf_counter())]
    mark = lambda name: (sync(), marks.append((name, time.perf_counter())))
    weights = fam.make_weights(gen)
    params = fam.program_params(weights)
    mark("weights")
    stream = make_stream(tr, seed, seconds, c["cache_ttl_ms"], device)
    mark("stream")
    feats = Features(tr, fam.vocab, seed, device)
    tiers0 = image_tiers(stream, c["n_buckets"], c["ways"],
                         c["failover_n_buckets"], c["failover_ways"],
                         c["cache_ttl_ms"], c["failover_ttl_ms"], device)
    image_values = ImageValues(fam.value_dim, seed)
    ccfg, server = _server(cell, fam, weights, control)
    state = srv.init_server_state(ccfg, writebuf_capacity=cell.ring,
                                  device=device)
    state = srv.with_cache_image(state, {
        "direct": _program_tier(tiers0[0], image_values),
        "failover": _program_tier(tiers0[1], image_values),
        "budget": state.budget})
    mark("image")
    stager = Stager(stream, feats, fam, tr.failure_rate > 0, device)
    mark("staged")
    every = cell.cfg["check"]["sample_every"] if not control else 1
    answers = Answers(stream.n_batches, tr.batch, fam.value_dim, device,
                      lambda i: check_lib.sampled(seed, i, every))
    call = server.serve_many if control else server.jit_serve_many
    spans, traced_spans = [], []
    traced = {"on": False}

    def serve(i):
        nonlocal state
        t0, n0 = time.perf_counter(), time.time_ns()
        keys, fin, now, fails = stager.stage(i)
        t1, n1 = time.perf_counter(), time.time_ns()
        state, acc, ys = call(params, state, keys, fin, now, fails,
                              flush_every=1, collect=True)
        t2, n2 = time.perf_counter(), time.time_ns()
        answers.take(i, ys, acc)
        t3, n3 = time.perf_counter(), time.time_ns()
        spans.append((t0, t1, t2, t3))
        if traced["on"]:
            traced_spans.extend((("stage", n0, n1), ("call", n1, n2),
                                 ("answer", n2, n3)))

    for i in range(tr.warmup_batches):
        serve(i)
        mark("first call" if i == 0 else f"call {i + 1}")
    setup_s = time.perf_counter() - t_start
    occ = [int((t.origin > 0).sum()) for t in tiers0]
    log(f"set-up {setup_s:.3f} s: {stream.n_batches} batches staged; image "
        f"{len(stream.image_uid)} users, {occ[0]} / {occ[1]} entries in the "
        f"direct / failover tier ({occ[0] / tiers0[0].ts.numel():.4f} / "
        f"{occ[1] / tiers0[1].ts.numel():.4f} of the slots); s from the "
        f"process's start: " + ", ".join(f"{n} {t - t_start:.3f}"
                                         for n, t in marks))

    # ------------------------------------------------------------ window
    # the harness keeps a record of every batch; the collector would scan
    # them again and again at fixed batch counts, so it waits until the
    # window has closed
    gc.collect()
    gc.disable()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    first = tr.warmup_batches
    i = first
    prof = prof_done = None
    slice_batches, profiled = [], []
    t_open = time.perf_counter()
    while True:
        if i >= stream.n_batches:
            raise RuntimeError(
                f"the stream ran out after {i} batches: its max_req_per_s "
                f"({tr.max_req_per_s}) is below what this run served")
        if (trace and prof is None and not slice_batches
                and time.perf_counter() - t_open >= 0.3 * seconds):
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            prof_warm = PROFILER_WARMUP
        serve(i)
        if prof is not None:
            profiled.append(i)
            if prof_warm:
                prof_warm -= 1
                if not prof_warm:
                    sync()
                    tracing.mark_slice_start()
                    traced["on"] = True
            else:
                slice_batches.append(i)
                if len(slice_batches) == tr.trace_batches:
                    sync()
                    traced["on"] = False
                    prof.stop()
                    prof_done, prof = prof, None
        i += 1
        if spans[-1][3] - t_open >= seconds and (
                not trace or len(slice_batches) == tr.trace_batches):
            break
    window = np.arange(first, i)
    window_s = spans[-1][3] - t_open
    gc.enable()
    sync()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    lat = np.diff(np.asarray(spans[first:], np.float64)[:, [0, 3]],
                  axis=1)[:, 0]
    worst = np.argsort(lat)[::-1][:5]
    log(f"window {window_s:.3f} s: {len(window)} batches, batch ms median "
        f"{np.median(lat) * 1e3:.4f} (by tenth of the window: " + " ".join(
            f"{np.median(part) * 1e3:.3f}" for part in np.array_split(lat, min(10, len(lat))))
        + "); longest (batch: ms) " + ", ".join(
            f"{first + j}: {lat[j] * 1e3:.3f}" for j in worst))

    tower_ms = None
    if trace and cuda:
        uid = torch.as_tensor(stream.uid[:cell.miss_budget], device=device)
        rows = fam.program_features(
            feats.of(uid, torch.full_like(uid, stream.batch_now(0))))
        tower = server.tower_fn
        with torch.no_grad():
            tower_ms = tracing.graph_ms(lambda: tower(params, rows),
                                        TOWER_REPLAYS[tr.trace_batches < 8])
    n_served = len(spans)
    counters = answers.counters(n_served)
    served = check_lib.Served(
        n_served, answers.src[:n_served], answers.age[:n_served], counters,
        answers.emb, state.direct, state.failover)

    # free the program's rings, graphs and weights before the reference
    del state, params, server, stager, call
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    report = check_lib.reference_pass(cell, fam, weights, stream, feats,
                                      tiers0, image_values, served, seed,
                                      device)
    log(f"check {time.perf_counter() - t_check:.3f} s")

    span_arr = np.asarray(spans[first:first + len(window)], np.float64)
    in_slice = np.isin(window, profiled)
    ctx = types.SimpleNamespace(
        cell=cell, fam=fam, traffic=tr, work=work, report=report,
        counters=counters, window=window, outside=~in_slice,
        stage_s=span_arr[:, 1] - span_arr[:, 0],
        call_s=span_arr[:, 2] - span_arr[:, 1],
        batch_s=span_arr[:, 3] - span_arr[:, 0],
        slice=tracing.Slice(prof_done, traced_spans, len(slice_batches))
        if slice_batches else None,
        slice_batches=slice_batches, tower_device_ms=tower_ms,
        miss_budget=cell.miss_budget, feats=feats, stream=stream)

    if ctx.slice is not None:
        log(f"trace: {len(ctx.slice.device_ops)} device ops over "
            f"{len(slice_batches)} batches, {ctx.slice.inside_spans():.4f} of "
            f"their time inside the batches' host spans")
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        lat_ms = (span_arr[:, 3] - span_arr[:, 0]) * 1e3
        e2e = {"req_per_s": len(window) * tr.batch / window_s,
               "p99_ms": float(np.percentile(lat_ms, 99)),
               "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[base_name(m["name"])],
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips if cuda else 0,
           "memory_peak_bytes": int(peak),
           "card": card_line() if cuda else "not read"}
    out = {"correct": report.correct,
           "attempted": int(len(window) * tr.batch),
           "failed": int(report.bad_rows[window].sum()),
           "metrics": metrics, "device": dev}
    if ctx.slice is not None:
        dev["busy_s"] = ctx.slice.busy_s()
        dev["window_s"] = ctx.slice.window_s()
        out["breakdown"] = {"device_ops": ctx.slice.top_ops(),
                            "idle_gaps": ctx.slice.idle_gaps()}
    out["checks"] = {k: {"value": report.numbers[k],
                         "limit": report.limits[k]} for k in report.numbers}
    out["_lines"] = report.lines()
    return out

