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
12. **towers and combiner**: Wide&Deep, BST and MIND at their published
    widths (``get_config(arch)``, random weights from seed 0 drawn in
    place on the card; Wide&Deep's 40 x 2M x 32 tables are 10.24 GB),
    each behind ``CachedEmbeddingServer`` with ``backend="cuda"`` in
    phase 2's deployment (2**20 x 8 tiers at D = the tower's
    ``user_embed_dim``, 256/32/256; B=512, miss budget 384) over phase
    2's whole stream (119 steps through ``jit_serve_many`` in chunks of
    64 and 55, as the launcher serves): one dual probe and one bag
    launch a step (Wide&Deep's 40 field bags are one launch), an eager
    ``backend="torch"`` replay bit-identical in counters, sources, ages
    and the key, write_ts and last_access planes, and in embeddings and
    values for BST and MIND (Wide&Deep: ``WD_TOL``), a timed replay of the
    captured graphs and a profiled chunk. Then each tower's score
    (``wide_deep_score``, ``bst_score``) cuda vs torch at B=512,
    ``retrieval_step`` on BST's and MIND's own 1M-row item tables against
    a float64 recompute, and ``run_serving(arch=...)`` per tower as a user
    calls it. The bag kernel is held and timed at Wide&Deep's shape (the
    (80M, 32) view, 15,360 and 20,480 bags of nnz 4) beside
    ``F.embedding_bag`` with offsets. Last, the combiner at
    ``benchmarks/bench_serving_cost.py``'s deployment (30 members x D=64,
    B=1024; a 2**16 x 8 grouped tier of 4.03 GB): grouped writes, the 30
    member reads each one ``cache_probe_tiled`` launch, cuda == torch in
    every read and plane; the tiled probe timed at its 7,680-byte rows;
    one grouped write against 30 single-table inserts (Fig. 5), device
    kernel time under the profiler and host wall.
13. **chaos**: ``launch.serve.chaos_timeline`` (the ``--chaos`` launcher)
    for ``incident``, ``cascade`` and ``rolling`` at SASRec's published
    widths on 4 models of 2**18 x 8 direct and failover tiers (3.4 GB),
    B=512, 20,000 users, 240 steps of 250 ms, 2 retries, through
    ``jit_serve_many`` (one graph a chunk length, chunks cut at the fault
    edges), against an eager ``backend="torch"`` replay: every window row,
    every chunk's counters (per-model vectors included) and every state
    tensor (both stacked tiers, both rings, the budget tokens)
    bit-identical, one dual-multi probe and one bag a step, conservation
    in every window; cascade's fault windows move deferred, failover
    serves, blackout drops and retries, its quiet window none. Then
    cascade's graphs replayed over pre-staged chunks (compiled / eager /
    compiled host ms a step) and a quiet and a fault chunk profiled; a
    benign schedule against ``chaos=None``, both compiled; the
    single-model server in phase 2's deployment under cascade and under a
    flush stall alone (which must drop ring records), compiled cuda
    against eager torch; and ``main(["--chaos", p, "--users", "1000"])``
    per preset at the settings ``benchmarks/bench_chaos.py`` serves, held
    to its SLA and recovery gates and printed beside
    ``BENCH_chaos.json``.
14. **regions**: ``launch.serve.regional_timeline`` (``--regions 4
    --drain``) at SASRec's published widths, 4 regions of 2**18 x 8
    tiers, B=512, phase 2's stream thinned to its diurnal envelope (78
    steps in chunks of 16, locality 0.98), through ``jit_serve_many``
    against an eager torch replay: the report (counters, re-homes,
    excursions, region load, the hit-rate curve), every chunk's counters
    and every state tensor (the home table included) bit-identical; the
    drained region serves 0 requests in its window; one dual-multi probe
    a step; a timed replay, an eager cuda run and a profiled drain chunk;
    then ``main(["--regions", "4", "--drain"])`` as a user calls it (and
    with ``--chunk-steps 8``, whose 31 steps hold a drain window).
15. **restart**: ``launch.serve.restart_timeline`` (the ``--restart``
    kill/restore harness) at SASRec's published widths at the launcher's
    defaults (2**12 x 8 tiers of D=50, 3,000 Zipf users, B=256, 240 + 120
    steps, a snapshot every 40: the kill lands at step 120 and a torn
    save follows it) through ``jit_serve_many``, against an eager
    ``backend="torch"`` run: the report and every restored and final
    tensor of the four variants bit-identical; modes bitexact / rehash /
    rehash / cold, the torn step skipped, the ledger continuous, the
    parity block passing, a warm-vs-cold gain above 0; one dual probe and
    one bag a step and one ``cache_probe_tiled`` launch a restore probe
    and a rehash chunk. Printed beside ``BENCH_restart.json`` (another
    stream; not gated). Then phase 2's deployment served over its 119
    steps, snapshotted (``retain_last_k=1``) and restored bit-exact
    (equal to the served tables plane for plane) and into 2**21 buckets
    (every live key of both tiers still hits, values and ages
    bit-identical), each timed in seconds and GB/s, in a temporary
    directory whose free space is printed first and which is removed
    afterwards.
16. **train**: the training slice, after the earlier phases' tensors are
    freed. (a) ``llama-100m`` (``examples/train_lm.py``'s model: 12L,
    d512, 8/4 heads, ffn 1536, vocab 32000, float32, two microbatches,
    AdamW + cosine by ``for_config``) through ``run_train_loop`` at B=8,
    S=256 for 20 steps, a checkpoint every 10 in a temporary directory
    (removed afterwards);
    the step-20 checkpoint is removed and a second loop resumes from step
    10: its losses at steps 11-20 equal the first run's within
    ``RESUME_RTOL`` (the phase does not set
    ``torch.use_deterministic_algorithms``; it prints whether they were
    bit-identical). The first step's loss and grad_norm on the card
    equal the port's own CPU step from the same weights within
    ``CARD_CPU_RTOL`` (TF32 off). (b) ``granite-moe-1b-a400m`` at its
    published widths (24L, d1024, 32 experts top-8, vocab 49155, bf16,
    Adafactor by ``for_config``), 5 steps on one repeated batch of B=8,
    S=128 (2 dispatch groups of 512 tokens, capacity 160), no checkpoint
    (the port's ``save`` refuses bfloat16 leaves): every loss finite, the
    last below the first. (c) Wide&Deep, SASRec, BST and MIND at their
    published widths, 3 steps each on one batch of
    ``RECSYS_SHAPES["train_batch"]`` = 65,536: every loss finite, the
    last at most the first + 1e-3. (d) The trained SASRec served through
    ``tower_step(impl="cuda")`` (the bag kernel) and ``impl="torch"``:
    bit-identical at nnz=1. One ``[train]`` line a run: arch, parameter
    count, steps, first and last loss, median host ms a step (the
    profiled last step left out), device kernel ms of the last step under
    torch.profiler and its idle share, peak
    ``torch.cuda.max_memory_allocated`` in GB, the card's name and power
    limit. Training runs the plain versions under autograd (the hand
    kernels have no backward and refuse inputs that need a gradient).
17. **shards**: the bucket-sharded cache tier on the one card, every
    shard on ``cuda:0`` through ``make_cache_mesh``. Phase 2's deployment
    (32 cold + 32 warm steps) on 1, 2, 4 and 8 shards, eager and through
    ``jit_serve_many`` (a chunk captured, one replayed, a third profiled):
    counters, sources, ages, embeddings (a -0.0 may read +0.0 at N >= 2,
    the reference's ``psum`` rule) and every plane and ring bit-identical
    to phase 2's unsharded cuda run, compiled == eager, N dual-probe
    launches a step; host ms a step eager and compiled, device ms of the
    profiled chunk, the card's name and power limit per N. Phase 4's
    deployment on 4 shards against its unsharded run. Phase 2's image
    snapshotted from 4 shards, restored onto 1 and 8 shards plane for
    plane and rehashed into 2**21 buckets on 4, where every live key
    still hits; seconds and GB/s. ``run_serving(n_shards=4)`` against
    ``n_shards=1``.
18. **mesh and GNN**: the model-axis mesh (``launch.mesh.ModelMesh``, every
    shard on ``cuda:0``; ``make_host_mesh`` is (1, 1) on one card and a
    mesh over distinct devices is refused) and GIN-TU. (a) Wide&Deep at
    its published widths (the 10.24 GB tables row-sharded) on (1, N)
    meshes, N = 1, 2, 4, B=512: ``wide_deep_score(mesh=)`` with and
    without ``serve_scatter`` against the unsharded cuda score within
    ``WD_TOL``, 2N bag launches a score, device ms a score. (b)
    ``retrieval_step(mesh=)`` on BST's 1M-row item table for 512 users on
    (1, 4) and (2, 2) meshes: the unsharded step's ids, order and scores;
    ``collectives.top_k`` (the tie rule) equal to a stable sort's first
    100 on bf16-rounded scores, its device time beside ``torch.topk`` and
    the stable sort. (c) TinyLlama-1.1B in phase 8's deployment: the
    1920-token prefill under a mesh (22 flash launches), then 16 decode
    steps on 1, 2 and 4 sequence shards (``decode_step(mesh=)``, 22 x N
    ``decode_attention_partials`` launches a step) teacher-forced against
    the unsharded cuda decode within relative L2 ``MESH_DEC_TOL``; host ms
    a step. (d) ``long_500k``: a seeded B=1 cache of 524,288 positions
    (11.8 GB of bf16 KV), 4 steps on 4 sequence shards against unsharded,
    held to the larger of 0.02 and twice the torch backend's gap to the
    unsharded cuda run on the same steps (one bf16 row's noise floor), and
    each layer's sharded attention against the unsharded kernel on its
    cache at ``DEC_KERNEL_TOL``.
    (e) gin-tu at its published widths: ``full_graph_sm`` (the sampler
    copy's power-law graph) on the card against the port's CPU forward
    and ``forward_partitioned`` over 4 node shards against ``forward``;
    ``ogb_products``' size (2,449,029 nodes padded to 2,449,032, 61,859,140
    edges drawn on the card, d_feat 100) replicated against partitioned,
    ms and peak GB of each. (f) ``launch.train.main(["--arch", "gin-tu",
    "--full-config", ...])`` for 20 steps as a user calls it, every loss
    finite, and its ``[train]`` line.
19. **plan**: the cell planner (``launch/specs.py``, ``launch/dryrun.py``).
    (a) All 40 cells on both production meshes planned on meta in a pool
    of spawned workers that never touch the card (the LM cells through
    the linear accounting on both meshes), one terms line each, every
    plan ``ok`` under 80 GB a device. (b) The ERCache serve cell
    (``run_ercache_cell``: TinyLlama-1.1B at its published widths,
    B=4096, miss budget 1024, seq 64, 2**22 x 8 x 256 float32 tiers, cut
    to 2**21 only if the plan's peak and the graph pool do not fit the
    free memory) planned for a (1, 1) model mesh and one cache shard of
    ``cuda:0``, then run there through ``jit_serve_step`` on fresh keys
    (every row a miss, the miss budget full): the plan's argument bytes
    equal the card's tensors, the first step's computed rows equal the
    torch tower, one dual probe a step and no flash launch (the
    reference's naive path at seq 64), a profiled step by kernel group,
    and the device kernel time a warm step at least 0.95 x the plan's
    bound (the larger of its compute and memory terms); the plan's peak
    against ``max_memory_allocated``. (c) Table 4
    (``examples/train_ctr_tower.run`` at 2,000 users x 24 h) on the card
    and on the CPU: each arm's NE within a relative 1e-5, each ne_diff
    within 1e-4 points, printed beside the paper's.

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
all three; holds ``decode_attention_partials`` (the same kernel's split
partials, unmerged) on a key range at an offset, with a range all masked
(m = -1e30, l = acc = 0 exactly), against its plain version, and times
it at the decode path's shape and at long_500k; each time is printed
with its rate and roofline share; and
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
each path and read just after. The sharded runs of phase 17 add their
dual and dual-multi launches, each counted over its own run; phase 18
adds the sharded Wide&Deep scores' bag launches, the mesh prefill's
flash launches, and counts ``decode_attention_partials`` over its
sharded decode steps (c) and (d); phase 19 adds the ERCache cell's dual
probes. Phases 9,
10 and 12–15 check their own counts; phase 16 checks the bag's launches
on the trained tower.

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


def kernel_ms(torch, fn, reps: int = 5):
    """(device kernel ms, host wall ms, device ops) of one ``fn()`` call,
    averaged over ``reps`` calls: the summed durations of its kernels,
    memcpys and memsets under torch.profiler, and the synchronized wall.
    For a call of more launches than the launch queue holds, where
    :func:`device_ms` would time the host's dispatch."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.end - e.time_range.start for e in ev)
    return busy_us / 1e3 / reps, wall_ms, len(ev) / reps


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
    kernels_decode_partials(torch, results)


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


def partials_bytes(q, k, valid, pos_offset, n_split):
    """Least bytes of one partials launch: the valid keys of its range in
    k and v, q read once, the float32 partials written once."""
    S, Hkv, hd = k.shape[1:]
    n = int((valid.long() - pos_offset).clamp(0, S).sum())
    B, Hq = q.shape[:2]
    return (2 * n * Hkv * hd * k.element_size() + q.nbytes
            + n_split * B * Hq * (hd + 2) * 4)


def kernels_decode_partials(torch, results):
    """decode_attention_partials (the decode kernel's split partials, the
    merge skipped) against its plain version: on the second half of the
    decode path's cache (a view at position offset 1024, valid_len 0, 1024
    -- the range all masked --, one split boundary past it, 2048) with the
    split plan's and 3 splits; then timed at the decode path's shape and
    at long_500k over the whole cache, beside the plain version."""
    from repro_torch.configs import LM_SHAPES
    from repro_torch.distributed.collectives import combine_decode_partials
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smi = smi_line()

    def inputs(b, s):
        mk = lambda *sh: torch.randn(sh, generator=gen, device=dev).to(
            torch.bfloat16)
        return (mk(b, LM_HQ, LM_HD), mk(b, s, LM_HKV, LM_HD),
                mk(b, s, LM_HKV, LM_HD))

    def merged(m, l, acc):
        return combine_decode_partials(m, l, acc, torch.float32)

    q, k, v = inputs(DEC_B, DEC_MAX)
    half = DEC_MAX // 2
    for n_split in (None, 3):
        n, sl = (dk.split_plan(DEC_B, half, LM_HKV, sms) if n_split is None
                 else dk.splits_of(half, n_split))
        lens = torch.tensor([0, half, half + sl + 1, DEC_MAX], device=dev,
                            dtype=torch.int32).repeat(DEC_B // 4)
        n0 = dk.LAUNCHES["decode_attention_partials"]
        m, l, acc = dk.decode_attention_partials(
            q, k[:, half:], v[:, half:], lens, half, n_split=n_split)
        torch.cuda.synchronize()
        if dk.LAUNCHES["decode_attention_partials"] != n0 + 1:
            raise AssertionError("decode_attention_partials did not count "
                                 "one launch")
        wm, wl, wacc = ref.decode_attention_partials_ref(
            q, k[:, half:], v[:, half:], lens, half, n, sl)
        empty = wl == 0
        err = float((merged(m, l, acc)[~empty.all(0)]
                     - merged(wm, wl, wacc)[~empty.all(0)]).abs().max())
        if not (m.shape[0] == n and bool((m[empty] == -1e30).all())
                and not bool(l[empty].any()) and not bool(acc[empty].any())
                and bool(torch.isfinite(m).all()) and err <= 1e-5
                and float((m - wm).abs().max()) <= 1e-4):
            raise AssertionError(f"decode_attention_partials disagrees with "
                                 f"its plain version ({n} splits: merged "
                                 f"max |err| {err:.3g})")
        print(f"[kernels] decode_attention_partials on keys {half}.."
              f"{DEC_MAX - 1} of q {tuple(q.shape)} k/v {tuple(k.shape)} bf16, "
              f"{n} split(s) of {sl} keys, valid_len 0/{half}/{half + sl + 1}"
              f"/{DEC_MAX}: empty splits m = -1e30, l = acc = 0 exactly; "
              f"merged max |err| {err:.3g} (float32, tolerance 1e-5)")

    valid = torch.arange(DEC_PROMPT + 1, DEC_MAX + 1, dtype=torch.int32,
                         device=dev)
    rows = []
    for shape, qkv, vl, n_k in (
            ("the decode path", (q, k, v), valid, 20),
            ("long_500k", inputs(1, LM_SHAPES["long_500k"].seq_len),
             torch.full((1,), LM_SHAPES["long_500k"].seq_len,
                        dtype=torch.int32, device=dev), 3)):
        qq, kk, vv = qkv
        m, l, acc = dk.decode_attention_partials(qq, kk, vv, vl)
        n_split = m.shape[0]
        err = float((merged(m, l, acc) - merged(
            *ref.decode_attention_partials_ref(qq, kk, vv, vl))).abs().max())
        ms = device_ms(lambda i: dk.decode_attention_partials(qq, kk, vv, vl),
                       n=n_k, reps=3)
        plain = device_ms(lambda i: ref.decode_attention_partials_ref(
            qq, kk, vv, vl), n=1, reps=3)
        nb = partials_bytes(qq, kk, vl, 0, n_split)
        bound = nb / HBM_BYTES_PER_S * 1e3
        rows.append(dict(
            name="decode_attention_partials", route="cuda",
            source="src/repro_torch/csrc/decode_attention.cu",
            replaces="src/repro/kernels/decode_attention.py:91",
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
            bound_by="bytes", library_ms=None))
        print(f"[kernels] decode_attention_partials at {shape} q "
              f"{tuple(qq.shape)} k/v {tuple(kk.shape)} bf16, {n_split} "
              f"split(s): {ms:.4f} ms on the card ({nb / ms / 1e6:.0f} GB/s, "
              f"{bound / ms:.1%} of its bound), plain {plain:.3f} ms; bound "
              f"{bound:.4f} ms by bytes ({nb / 1e9:.4f} GB at 3.35 TB/s); "
              f"merged max |err| {err:.3g} (float32); no library call "
              f"returns the partials | {smi}")
        del qkv, qq, kk, vv
    results["decode_attention_partials"] = rows[0]
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
    out["emb"].append(ys[0])
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


def serve_run(torch, backend, stream, chunk, mesh=None):
    """Cold then warm chunk of serve_many + a read-back lookup of the last
    batch, at full SASRec width (on ``mesh``'s shards: phase 17). Returns
    what the run produced, the server and its state."""
    from repro_torch.core import cache as C
    from repro_torch.core import server as srv
    from repro_torch.core.config import CacheConfig
    from repro_torch.core.hashing import Key64
    from repro_torch.distributed.sharding import gather_cache
    from repro_torch.launch import serve as launch

    dev = torch.device("cuda")
    tcfg, params, tower_fn, _ = launch.build_tower(
        "sasrec", backend=backend, device=dev, smoke=False, seed=0)
    cfg = CacheConfig(model_id=1, model_type="ctr", n_buckets=N_BUCKETS,
                      ways=WAYS, value_dim=tcfg.user_embed_dim,
                      miss_budget_frac=0.75, backend=backend)
    server = srv.CachedEmbeddingServer(
        cfg=cfg, tower_fn=tower_fn, miss_budget=int(BATCH * 0.75), mesh=mesh)
    state = srv.init_server_state(cfg, writebuf_capacity=BATCH * 4,
                                  device=dev, mesh=mesh)
    keys, feats, nows, _ = stream
    out = {"chunks": [], "emb": [], "src": [], "age": [], "step_ms": [],
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
    rb = C.lookup(gather_cache(state.direct), last, nows[2 * chunk - 1],
                  cfg.cache_ttl_ms, backend=backend)
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


def multi_run(torch, backend, stream, slots, chunk, mesh=None):
    """Cold then warm chunk of the multi-model serve_many at full SASRec
    width over the 8-model registry (on ``mesh``'s shards: phase 17).
    Returns what the run produced, the server and its state."""
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
                                  miss_budget=int(BATCH * 0.75), device=dev,
                                  mesh=mesh)
    state = srv.init_multi_server_state(cfgs, writebuf_capacity=BATCH * 4,
                                        device=dev, mesh=mesh)
    keys, feats, nows, _ = stream
    out = {"chunks": [], "emb": [], "src": [], "age": [], "step_ms": [],
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
          + " steps, each whole chunk with its flushes one graph): first "
          "call (eager + capture) "
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


# ------------------------------------------------------------ phase 12
TOWER_ARCHS = ("wide-deep", "bst", "mind")
# Wide&Deep, cuda vs torch: its field bags sum nnz = 4 float32 rows in
# another order than the plain ``sum`` (a few ulps of each bag), carried
# through the float32 MLP; BST and MIND gather nnz = 1 rows (copies) and
# are held bit for bit.
WD_TOL = dict(atol=1e-6, rtol=1e-5)
RETRIEVAL_QUERIES = 64                       # users scored against 1M items
# benchmarks/bench_serving_cost.py's grouped write: 30 members x D=64 (a
# 1,920-float group row) at B=1024, here on a 2**16 x 8 grouped tier;
# member TTLs 1/5/10/30 min in turn, so one read mixes fresh and stale
GROUP = dict(members=30, dim=64, n_buckets=1 << 16, ways=8, batch=1024)


def close_or_equal(torch, arch, a, b, what):
    """BST and MIND: bit for bit; Wide&Deep: within WD_TOL. Returns the
    max |a - b|."""
    if arch != "wide-deep":
        if not torch.equal(a, b):
            raise AssertionError(f"{arch}: {what} differ between backends")
        return 0.0
    torch.testing.assert_close(a, b, **WD_TOL, msg=f"{arch}: {what}")
    return float((a - b).abs().max())


def wide_deep_bag_shape(torch, tables):
    """The bag kernel at Wide&Deep's shape, the (F*V, D) = (80M, 32)
    float32 view of the field tables: ``field_embedding_bag`` (one launch
    for all 40 fields) against the per-field plain bags at 15,360 bags
    (the tower on a miss budget of 384 rows) and 20,480 (the score at
    B=512) with 30% -1 pads, then the kernel timed at 15,360 bags of
    field-offset ids drawn as the launcher draws them (no pads) beside
    ``F.embedding_bag`` with offsets on the same ids. The bound counts
    each distinct row, each id and each output once."""
    from repro_torch.kernels import embedding_bag as ebk
    from repro_torch.kernels import ref
    from repro_torch.models import recsys as rec

    dev = tables.device
    n_fields, vocab, dim = tables.shape
    flat = tables.view(n_fields * vocab, dim)
    gen = torch.Generator(device=dev).manual_seed(12)
    offset = (torch.arange(n_fields, device=dev, dtype=torch.int32)
              * vocab)[:, None]

    def field_ids(rows, pad):
        ids = torch.randint(0, vocab, (rows, n_fields, 4), generator=gen,
                            device=dev, dtype=torch.int32)
        ids[torch.rand(ids.shape, generator=gen, device=dev) < pad] = -1
        return ids

    err = 0.0
    for rows in (384, 512):
        ids = field_ids(rows, 0.3)
        n0 = ebk.LAUNCHES["embedding_bag"]
        got = rec.field_embedding_bag(tables, ids, impl="cuda")
        if ebk.LAUNCHES["embedding_bag"] != n0 + 1:
            raise AssertionError("field_embedding_bag is not one launch")
        want = torch.stack([ref.embedding_bag_ref(tables[f], ids[:, f])
                            for f in range(n_fields)], dim=1)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
        if bool(got[(ids < 0).all(dim=-1)].any()):
            raise AssertionError("a bag of -1 pads is not zeros")
        err = max(err, float((got - want).abs().max()))
    batches = [(field_ids(384, 0.0) + offset).view(-1, 4)
               for _ in range(40)]
    flat_ids = [b.view(-1).long() for b in batches]
    n_bags = batches[0].shape[0]
    offsets = torch.arange(0, 4 * n_bags, 4, device=dev)
    distinct = statistics.mean(int(torch.unique(b).numel()) for b in batches)
    bag_bytes = n_bags * 4 * 4 + distinct * dim * 4 + n_bags * dim * 4
    r = dict(ms=device_ms(lambda i: ebk.embedding_bag(flat, batches[i % 40])),
             plain_ms=device_ms(lambda i: ref.embedding_bag_ref(
                 flat, batches[i % 40]), n=10),
             library_ms=device_ms(lambda i: torch.nn.functional.embedding_bag(
                 flat_ids[i % 40], flat, offsets, mode="sum")),
             bound_ms=bag_bytes / HBM_BYTES_PER_S * 1e3)
    print(f"[kernels] embedding_bag at Wide&Deep's shape ((F*V, D) = "
          f"({n_fields * vocab}, {dim}) float32 view, nnz 4): "
          f"field_embedding_bag one launch for {n_fields} fields, within "
          f"atol=rtol=1e-6 of the per-field plain bags at 15360 and 20480 "
          f"bags with 30% -1 pads (max |err| {err:.3g}); {n_bags} bags: "
          f"{r['ms'] * 1e3:.2f} us (plain {r['plain_ms'] * 1e3:.2f} us, "
          f"F.embedding_bag with offsets {r['library_ms'] * 1e3:.2f} us), "
          f"bound {r['bound_ms'] * 1e3:.3f} us by bytes ({bag_bytes:.0f} B: "
          f"{distinct:.0f} distinct rows of {dim * 4} B, the ids, the "
          f"outputs)")


def tower_scores(torch, arch, tcfg, params, feats):
    """The serve-side score (Wide&Deep, BST) cuda vs torch at B=512, and
    ``retrieval_step`` on the tower's own 1M-row item table (BST, MIND)
    for RETRIEVAL_QUERIES users, held against a float64 recompute."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models import recsys as rec

    dev = torch.device("cuda")
    batch = {k: v[0] for k, v in feats.items()}
    if arch == "bst":
        rng = np.random.default_rng(12)
        batch["target"] = torch.as_tensor(
            rng.integers(0, tcfg.vocab, BATCH).astype(np.int32), device=dev)
    score = {"wide-deep": rec.wide_deep_score, "bst": rec.bst_score}.get(arch)
    if score is not None:
        ops.reset_launch_counts()
        got = score(params, batch, tcfg, impl="cuda")
        n = ops.launch_counts()["embedding_bag"]
        want = score(params, batch, tcfg, impl="torch")
        err = close_or_equal(torch, arch, got, want, "scores")
        if n != (2 if arch == "wide-deep" else 1) or got.shape != (BATCH,):
            raise AssertionError(f"{arch} score: {n} bag launches, shape "
                                 f"{tuple(got.shape)}")
        print(f"[towers {arch}] {score.__name__} at B={BATCH}: {n} bag "
              f"launch(es), cuda vs torch max |err| {err:.3g}")
    if arch == "wide-deep":
        return
    q = {"seq": batch["seq"][:RETRIEVAL_QUERIES]}
    user = rec.tower_step(params, q, tcfg, impl="cuda")
    user_t = rec.tower_step(params, q, tcfg, impl="torch")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores, ids = rec.retrieval_step(user, params.item_emb, tcfg)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    scores_t, ids_t = rec.retrieval_step(user_t, params.item_emb, tcfg)
    if not (torch.equal(scores, scores_t) and torch.equal(ids, ids_t)):
        raise AssertionError(f"{arch}: retrieval differs between backends")
    u64 = user.double().view(RETRIEVAL_QUERIES, -1, tcfg.embed_dim)
    full = torch.einsum("bkd,nd->bkn", u64,
                        params.item_emb.double()).amax(dim=1)
    top = torch.topk(full, scores.shape[1], dim=1).values
    picked = full.gather(1, ids.long())
    if not (torch.allclose(scores.double(), picked, atol=1e-6, rtol=1e-5)
            and torch.allclose(scores.double(), top, atol=1e-6,
                               rtol=1e-5)):
        raise AssertionError(f"{arch}: retrieval top-k off its float64 "
                             "recompute")
    print(f"[towers {arch}] retrieval_step: {RETRIEVAL_QUERIES} users x "
          f"{params.item_emb.shape[0]} items ({tcfg.interaction}), top-"
          f"{scores.shape[1]} in {ms:.2f} ms host wall, cuda == torch, "
          f"scores within 1e-5 of the float64 top-k")


def tower_cell(torch, arch):
    """One tower at its published widths behind the single-model server:
    119 steps compiled (``jit_serve_many``, chunks of 64 and 55), an eager
    ``backend="torch"`` replay held against it, a timed replay of the
    captured graphs and a profiled chunk; then its score and retrieval
    paths."""
    import dataclasses

    from repro_torch.core import server as srv
    from repro_torch.core.config import CacheConfig
    from repro_torch.core.graph import tensors_of
    from repro_torch.core.hashing import Key64
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch
    from repro_torch.models import recsys as rec

    t_cell = time.perf_counter()
    dev = torch.device("cuda")
    tcfg, params, tower_fn, features_of = launch.build_tower(
        arch, backend="cuda", device=dev, smoke=False, seed=0)
    if arch == "wide-deep":
        wide_deep_bag_shape(torch, params.tables)
    keys, feats, nows, _ = staged_stream(torch, launch, features_of, dev,
                                         COMPILED_STEPS)
    spans = list(launch._chunks(COMPILED_STEPS, COMPILED_CHUNK))

    def chunk_inputs(lo, n):
        sl = slice(lo, lo + n)
        return (Key64(keys.hi[sl], keys.lo[sl]),
                {k: v[sl] for k, v in feats.items()}, nows[sl])

    cfg = CacheConfig(model_id=1, model_type="ctr", n_buckets=N_BUCKETS,
                      ways=WAYS, value_dim=tcfg.user_embed_dim,
                      miss_budget_frac=0.75, backend="cuda")
    plain_cfg = dataclasses.replace(cfg, backend="torch")
    server = srv.CachedEmbeddingServer(cfg=cfg, tower_fn=tower_fn,
                                       miss_budget=int(BATCH * 0.75))
    plain = srv.CachedEmbeddingServer(
        cfg=plain_cfg, miss_budget=int(BATCH * 0.75),
        tower_fn=lambda p, f: rec.tower_step(p, f, tcfg, impl="torch"))
    init = lambda c: srv.init_server_state(c, writebuf_capacity=BATCH * 4,
                                           device=dev)
    calls = [(server, chunk_inputs(lo, n), n) for lo, n in spans]

    ops.reset_launch_counts()                    # this path's window
    cuda = serve_chunks(torch, True, params, init(cfg), calls)
    n = ops.launch_counts()
    want = {"cache_probe_dual": COMPILED_STEPS,
            "embedding_bag": COMPILED_STEPS}
    if {k: v for k, v in n.items() if v} != want or any(
            got != {"cache_probe_dual": c, "embedding_bag": c}
            for (_, _, c), got in zip(calls, cuda["launches"])):
        raise AssertionError(f"{arch}: launches {n} / per chunk "
                             f"{cuda['launches']}, want one dual probe and "
                             "one bag a step")
    tiers = cuda["state"].direct
    acc = {k: sum(c[k] for c in cuda["chunks"]) for k in (
        "requests", "direct_hits", "tower_inferences", "fallbacks")}
    warm = cuda["chunks"][-1]
    print(f"[towers {arch}] {tcfg.arch_id} published widths ("
          f"{sum(p.numel() for p in params.parameters()) / 1e6:.1f}M "
          f"parameters, {sum(p.nbytes for p in params.parameters()) / 1e9:.2f}"
          f" GB), 2 tiers of {tuple(tiers.values.shape)} float32 "
          f"({sum(t.nbytes for t in tiers) / 1e9:.2f} GB each), B={BATCH}, "
          f"miss_budget {int(BATCH * 0.75)}: {COMPILED_STEPS} steps through "
          f"jit_serve_many in chunks of "
          f"{'/'.join(str(c) for *_, c in calls)}, launches {want}, hit rate "
          f"{acc['direct_hits'] / acc['requests']:.4f} (last chunk "
          f"{warm['direct_hits'] / warm['requests']:.4f}), tower inferences "
          f"{acc['tower_inferences']}, fallbacks {acc['fallbacks']}; the "
          f"capturing run {cuda['wall_ms'] / COMPILED_STEPS:.2f} ms a step")
    if not warm["direct_hits"] > 0:
        raise AssertionError(f"{arch}: last chunk has no direct hits")
    if not all(bool(torch.isfinite(ys[0]).all()) for ys in cuda["ys"]):
        raise AssertionError(f"{arch}: non-finite embeddings")

    plain_run = serve_chunks(torch, False, params, init(plain_cfg),
                             [(plain, inputs, c) for _, inputs, c in calls])
    if cuda["chunks"] != plain_run["chunks"]:
        raise AssertionError(f"{arch}: counters differ between backends")
    err = 0.0
    for ya, yb in zip(cuda["ys"], plain_run["ys"]):
        if not (torch.equal(ya[1], yb[1]) and torch.equal(ya[2], yb[2])):
            raise AssertionError(f"{arch}: sources/ages differ between "
                                 "backends")
        err = max(err, close_or_equal(torch, arch, ya[0], yb[0],
                                      "embeddings"))
    for tier in ("direct", "failover"):
        ta = getattr(cuda["state"], tier)
        tb = getattr(plain_run["state"], tier)
        for name in ("key_hi", "key_lo", "write_ts", "last_access_ts"):
            if not torch.equal(getattr(ta, name), getattr(tb, name)):
                raise AssertionError(f"{arch}: {tier}.{name} differs "
                                     "between backends")
        err = max(err, close_or_equal(torch, arch, ta.values, tb.values,
                                      f"{tier}.values"))
    print(f"[towers {arch}] eager torch-backend replay (TF32 off) "
          f"{plain_run['wall_ms'] / COMPILED_STEPS:.2f} ms a step: counters, "
          f"sources, ages and the key, write_ts and last_access planes of "
          f"both tiers bit-identical; embeddings and value planes "
          + ("bit-identical" if arch != "wide-deep" else
             f"within atol {WD_TOL['atol']:g} rtol {WD_TOL['rtol']:g} "
             f"(max |err| {err:.3g})"))
    del plain_run, plain
    torch.cuda.empty_cache()

    fresh = init(cfg)

    def reset(state):
        for a, b in zip(tensors_of(state), tensors_of(fresh), strict=True):
            a.copy_(b)

    state = cuda["state"]
    graphs = len(server.jit_serve_many.graphs)
    reset(state)
    replay = serve_chunks(torch, True, params, state, calls)
    if not same_run(torch, cuda, replay) or len(
            server.jit_serve_many.graphs) != graphs:
        raise AssertionError(f"{arch}: a replay differs from the capturing "
                             "run or captured again")
    ms = replay["wall_ms"] / COMPILED_STEPS
    reset(state)
    _, inputs, c = calls[0]
    prof = phase_profile(
        torch, f"profile towers {arch} compiled", c,
        lambda: server.jit_serve_many(params, state, *inputs,
                                      flush_every=1)[1])
    busy = (f"{sum(prof[0].values()) / 1e3 / c:.3f} ms device kernel time "
            f"a step, unprofiled idle share "
            f"{1 - sum(prof[0].values()) / 1e3 / c / ms:.3f}"
            if prof is not None else "device time not measured")
    print(f"[towers {arch}] compiled replay of the {graphs} captured graphs: "
          f"{ms:.3f} ms host wall a step over {COMPILED_STEPS} steps, "
          f"bit-identical to the capturing run; {busy}")
    tower_scores(torch, arch, tcfg, params, feats)
    print(f"[towers {arch}] cell done in {time.perf_counter() - t_cell:.1f}s")


def combiner_cell(torch):
    """The combiner on the card at bench_serving_cost.py's deployment:
    grouped writes, then every member's read through the tiled probe (one
    launch each), cuda == torch in every plane and every read; the tiled
    probe timed at the 7,680-byte group rows; one grouped write timed
    against 30 single-table inserts (Fig. 5's consolidation)."""
    import gc

    import numpy as np

    from repro_torch.core import cache as C
    from repro_torch.core import combiner as G
    from repro_torch.core.hashing import Key64, bucket_index
    from repro_torch.kernels import cache_probe as pk
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    nm, dim, nb, ways, b = (GROUP[k] for k in (
        "members", "dim", "n_buckets", "ways", "batch"))
    ttls = [(1, 5, 10, 30)[i % 4] * MIN for i in range(nm)]
    spec = G.GroupSpec(tuple(G.GroupMember(f"m{i}", dim, ttls[i])
                             for i in range(nm)))
    states = [G.init_grouped(spec, nb, ways, device=dev) for _ in range(2)]
    rng = np.random.default_rng(13)
    gen = torch.Generator(device=dev).manual_seed(13)
    pool = np.arange(400_000, dtype=np.int64) * 7919 + 1
    rounds, written = [], []
    # device-resident clocks, as the serve path stages them: a host int
    # would be copied to the card, and wait for it, at every call
    clock = lambda ms: torch.tensor(ms, dtype=torch.int32, device=dev)
    for r, now in enumerate((0, 3 * MIN, 6 * MIN, 9 * MIN)):
        now = clock(now)
        written.append(rng.choice(pool, b))
        keys = Key64.from_int(written[-1], device=dev)
        values = {m.name: torch.randn(b, dim, generator=gen, device=dev)
                  for i, m in enumerate(spec.members) if (i + r) % 7}
        mask = {n: torch.rand(b, generator=gen, device=dev) < 0.9
                for n in values}
        rounds.append((keys, values, mask, now))
    for st in states:
        for keys, values, mask, now in rounds:
            G.insert_group(spec, st, keys, values, now, member_mask=mask)
    for (name, x), y in zip(zip(states[0].base._fields, states[0].base),
                            states[1].base):
        if not torch.equal(x, y):
            raise AssertionError(f"combiner: base.{name} differs between "
                                 "two runs of the same writes")
    occupied = int((states[0].present != 0).sum())
    # users written in any of the 4 rounds, and 64 never written
    q = Key64.from_int(np.concatenate([
        rng.choice(np.concatenate(written), b - 64),
        rng.integers(10 ** 12, 10 ** 13, 64)]), device=dev)
    now = clock(10 * MIN)
    ops.reset_launch_counts()
    got = [G.lookup_member(spec, states[0], m.name, q, now)
           for m in spec.members]
    n = ops.launch_counts()
    want = [G.lookup_member(spec, states[1], m.name, q, now, backend="torch")
            for m in spec.members]
    if n["cache_probe_tiled"] != nm or sum(n.values()) != nm:
        raise AssertionError(f"combiner: launches {n} for {nm} member reads")
    for m, a, w in zip(spec.members, got, want):
        for field, x, y in zip(("hit", "values", "age_ms"), a[:3], w[:3]):
            if x.dtype != y.dtype or not torch.equal(x, y):
                raise AssertionError(f"combiner: {m.name}.{field} differs "
                                     "between backends")
    hits = [int(r.hit.sum()) for r in got]
    if not (0 < sum(hits) < nm * b and len(set(hits)) > 1):
        raise AssertionError(f"combiner: member hits {hits}")
    row = spec.total_dim * 4
    print(f"[combiner] {nm} members x D={dim} ({row}-byte group rows), "
          f"grouped tier {nb}x{ways} "
          f"({sum(t.nbytes for t in states[0].base) / 1e9:.2f} GB), "
          f"B={b}: 4 grouped writes (member failures, a member missing a "
          f"round), {occupied} slots present; {nm} member reads, "
          f"{n['cache_probe_tiled']} cache_probe_tiled launches, cuda == "
          f"torch in every read (hit, values, age) and both states equal; "
          f"hits per member {min(hits)}..{max(hits)} of {b}")

    base = states[0].base
    tabs = (base.key_hi, base.key_lo, base.write_ts, base.values)
    bk = bucket_index(q, nb)
    hit_rows = int(ref.cache_probe_ref(*tabs, q.hi, q.lo, bk, now,
                                       30 * MIN)[0].sum())
    tiled_bytes = b * 12 + b * 12 * ways + hit_rows * row + b * (9 + row)
    t_ms = device_ms(lambda i: pk.cache_probe_tiled(*tabs, q.hi, q.lo, bk,
                                                    now, 30 * MIN))
    p_ms = device_ms(lambda i: ref.cache_probe_ref(*tabs, q.hi, q.lo, bk,
                                                   now, 30 * MIN), n=10)
    print(f"[kernels] cache_probe_tiled at D={spec.total_dim} ({row}-byte "
          f"rows, B={b}, {hit_rows} hits at a 30 min TTL): "
          f"{t_ms * 1e3:.2f} us (plain {p_ms * 1e3:.2f} us), bound "
          f"{tiled_bytes / HBM_BYTES_PER_S * 1e6:.3f} us by bytes "
          f"({tiled_bytes} B)")
    del states[1]
    gc.collect()
    torch.cuda.empty_cache()

    singles = [C.init_cache(nb, ways, dim, device=dev) for _ in range(nm)]
    keys, values, _, now = rounds[0]
    full = {m.name: values.get(m.name, values["m1"]) for m in spec.members}

    def grouped():
        G.insert_group(spec, states[0], keys, full, now)

    def thirty():
        for m, st in zip(spec.members, singles):
            C.insert(st, keys, full[m.name], now, m.ttl_ms)

    t = {name: kernel_ms(torch, fn) for name, fn in (("group", grouped),
                                                     ("single", thirty))}
    print(f"[combiner] one grouped write of {b} users x {nm} members: "
          f"{t['group'][0]:.3f} ms of device kernels ({t['group'][2]:.0f} "
          f"ops), {t['group'][1]:.3f} ms host wall; {nm} single-table "
          f"inserts (2**16 x 8 x {dim} each) of the same users: "
          f"{t['single'][0]:.3f} ms of device kernels ({t['single'][2]:.0f} "
          f"ops), {t['single'][1]:.3f} ms host wall "
          f"({t['single'][0] / t['group'][0]:.1f}x device, "
          f"{t['single'][1] / t['group'][1]:.1f}x host); write requests "
          f"{nm} -> 1 (write_amplification "
          f"{G.write_amplification(nm, 1):.0f}x)")
    del singles, states, rounds
    gc.collect()
    torch.cuda.empty_cache()


def towers_entry(torch):
    """``run_serving(arch=...)`` once per new tower, as a user calls it
    (the SMOKE tower the launcher serves by default)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch

    for arch in TOWER_ARCHS:
        ops.reset_launch_counts()
        d = launch.run_serving(arch=arch, minutes=8, users=400,
                               backend="cuda",
                               log=lambda s: print(f"[towers entry] {s}"))
        n = ops.launch_counts()
        if (n["cache_probe_dual"] != d["batches"]
                or n["embedding_bag"] != d["batches"]
                or d["requests"] <= 0 or d["hit_rate"] <= 0):
            raise AssertionError(f"{arch} entry point: {d['batches']} "
                                 f"batches, hit rate {d['hit_rate']}, "
                                 f"launches {n}")


def phase_towers(torch):
    """Phase 12: Wide&Deep, BST and MIND at their published widths behind
    the server, their scores and retrieval, the entry point per arch, and
    the combiner."""
    import gc

    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in TOWER_ARCHS:
        # a cell's server, graphs, tiers and tables die with it (a server
        # is a reference cycle: the collector frees its graphs)
        gc.collect()
        torch.cuda.empty_cache()
        tower_cell(torch, arch)
    gc.collect()
    torch.cuda.empty_cache()
    towers_entry(torch)
    combiner_cell(torch)


# ------------------------------------------------------------ phase 13
# the chaos engine at SASRec's published widths on the launcher's
# deployment: 4 models of 2**18 x 8 direct and failover tiers, B=512,
# 20,000 users, 240 steps of 250 ms, 2 retries
CHAOS = dict(arch="sasrec", n_models=4, n_buckets=MULTI_BUCKETS,
             batch=BATCH, users=20_000, steps=240, step_ms=250,
             max_retries=2, smoke=False, seed=0)
CHAOS_SLA = {"incident": 0.99, "cascade": 0.95, "rolling": 0.99}
CHAOS_RECOVERY_MAX_WINDOWS = 2               # benchmarks/bench_chaos.py
CHAOS_FAULT_KEYS = ("deferred", "failover_serves", "blackout_write_drops",
                    "retries", "write_ring_drops")


def same_tensors(torch, a, b, what):
    from repro_torch.core.graph import tensors_of

    for i, (x, y) in enumerate(zip(tensors_of(a), tensors_of(b),
                                   strict=True)):
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: state tensor {i} "
                                 f"{tuple(x.shape)} differs")


def graph_line(server, probe):
    """Capture count, capture seconds and pool MB of a server's
    ``jit_serve_many`` graphs; raises unless each replays one probe and
    one bag a step."""
    graphs = list(server.jit_serve_many.graphs.values())
    for g in graphs:
        n = g.launches.get(probe, 0)
        if not n or g.launches != {probe: n, "embedding_bag": n}:
            raise AssertionError(f"a graph replays {g.launches}: want one "
                                 f"{probe} and one bag a step")
    return (f"{len(graphs)} graphs (chunks of "
            + "/".join(str(g.launches[probe]) for g in graphs)
            + " steps): first call (eager + capture) "
            + "/".join(f"{g.capture_s:.2f}" for g in graphs)
            + " s, pools " + "/".join(f"{g.pool_bytes / 1e6:.1f}"
                                      for g in graphs) + " MB")


def timed_calls(torch, run, params, state, calls):
    """Serve staged ``calls`` [(inputs, steps)] through ``run``, fetching
    each chunk's counters. Returns (counters, host ms a step per call)."""
    from repro_torch.core import server as srv

    out, ms = [], []
    for inputs, n in calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, acc, _ = run(params, state, *inputs, flush_every=1,
                        collect=False)
        out.append(srv.fetch_counters(acc))
        ms.append((time.perf_counter() - t0) * 1e3 / n)
    return out, ms


def chaos_scenario(torch, launch, scenario):
    """One preset compiled (cuda, ``jit_serve_many``, the launcher's
    path) against an eager torch-backend replay: every window row, every
    chunk's counters and every state tensor bit-identical; one dual-multi
    probe and one bag a step; conservation in every window. Returns the
    cuda plan, its report and chunk counters."""
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    runs = {}
    for backend, jit in (("cuda", True), ("torch", False)):
        plan = launch.plan_chaos(scenario=scenario, backend=backend,
                                 device=dev, **CHAOS)
        ops.reset_launch_counts()                # this path's window
        rep, state, chunks = launch.chaos_timeline(
            plan, jit=jit, log=lambda s, b=backend: print(
                f"[chaos {scenario} {b}] {s}"))
        runs[backend] = (plan, rep, state, chunks, ops.launch_counts())
    (plan, rep, st, chunks, n), (plan_t, rep_t, st_t, chunks_t, n_t) = (
        runs["cuda"], runs["torch"])
    steps = CHAOS["steps"]
    if {k: v for k, v in n.items() if v} != {
            "cache_probe_dual_multi": steps, "embedding_bag": steps}:
        raise AssertionError(f"{scenario}: launches {n} for {steps} steps")
    if sum(n_t.values()):
        raise AssertionError(f"the torch backend launched kernels: {n_t}")
    graphs = graph_line(plan.server, "cache_probe_dual_multi")
    strip = lambda r: {k: v for k, v in r.items() if k not in (
        "wall_s", "host_ms_per_step", "backend")}
    if strip(rep) != strip(rep_t) or chunks != chunks_t:
        raise AssertionError(f"{scenario}: the report or a chunk's counters "
                             "differ, compiled cuda vs eager torch")
    same_tensors(torch, st, st_t, f"{scenario} compiled cuda vs eager torch")
    if not (rep["conservation_ok"]
            and all(w["conservation_ok"] for w in rep["windows"])):
        raise AssertionError(f"{scenario}: conservation violated")
    print(f"[chaos {scenario}] compiled cuda (capturing run "
          f"{rep['host_ms_per_step']:.2f} ms a step, staging included) and "
          f"eager torch ({rep_t['host_ms_per_step']:.2f} ms a step) "
          f"bit-identical: {len(rep['windows'])} window rows, "
          f"{len(chunks)} chunks' counters incl. per-model vectors, all "
          f"planes of both stacked tiers, both rings, the budget tokens; "
          f"launches {n}; {graphs}; conservation in every window")
    del runs, st_t, plan_t
    return plan, rep, chunks


def chaos_fault_checks(rep):
    """Cascade: every fault counter moves inside the fault windows and
    none in the quiet pre-fault window."""
    faulty = [w for w in rep["windows"]
              if w["label"] not in ("quiet", "recovery")]
    quiet = rep["windows"][0]
    tot = {k: sum(w[k] for w in faulty) for k in CHAOS_FAULT_KEYS}
    print(f"[chaos cascade] fault windows {[w['label'] for w in faulty]}: "
          + ", ".join(f"{k} {v}" for k, v in tot.items())
          + f"; quiet window: " + ", ".join(
              f"{k} {quiet[k]}" for k in CHAOS_FAULT_KEYS))
    if quiet["label"] != "quiet" or any(quiet[k] for k in CHAOS_FAULT_KEYS):
        raise AssertionError(f"cascade's quiet window moved: {quiet}")
    # the flush stall coincides with model 0's outage and 0.9 failures:
    # what the other models append in it stays inside the 2048-record
    # ring, so the preset drops nothing (the stall-only schedule of
    # chaos_single does)
    missing = [k for k in CHAOS_FAULT_KEYS[:4] if not tot[k] > 0]
    if missing:
        raise AssertionError(f"cascade's fault windows show no {missing}")


def chaos_profile(torch, launch, plan, rep, chunks):
    """The cascade's captured graphs replayed from a reset state over
    pre-staged chunks (host ms a step, bit-identical to the capturing
    run), the same chunks eager on the cuda backend, then one quiet and
    one fault chunk profiled continuing a replay."""
    from repro_torch.core import server as srv
    from repro_torch.core.graph import tensors_of

    staged = list(launch.chaos_chunks(plan))
    calls = [(inputs, n) for _, (_, n), inputs in staged]
    fresh = srv.init_multi_server_state(list(plan.server.cfgs),
                                        writebuf_capacity=BATCH * 4,
                                        device=plan.device)

    def reset():
        for a, b in zip(tensors_of(plan.state), tensors_of(fresh),
                        strict=True):
            a.copy_(b)

    n_graphs = len(plan.server.jit_serve_many.graphs)
    ms = {}
    for mode in ("compiled", "eager", "compiled"):
        reset()
        run = (plan.server.jit_serve_many if mode == "compiled"
               else plan.server.serve_many)
        got, per_call = timed_calls(torch, run, plan.params, plan.state,
                                    calls)
        if got != chunks:
            raise AssertionError(f"cascade {mode} run differs from the "
                                 "capturing run")
        ms.setdefault(mode, []).append(per_call)
    if len(plan.server.jit_serve_many.graphs) != n_graphs:
        raise AssertionError("cascade: a replay captured again")
    step = lambda per: sum(m * n for m, (_, n) in zip(per, calls)) / sum(
        n for _, n in calls)
    print(f"[chaos cascade] host wall ms a step over {CHAOS['steps']} "
          f"staged steps, compiled / eager / compiled: "
          f"{step(ms['compiled'][0]):.3f} / {step(ms['eager'][0]):.3f} / "
          f"{step(ms['compiled'][1]):.3f}; bit-identical counters")
    reset()
    quiet_i = 1                                   # warm, the 2nd quiet chunk
    fault_i = next(i for i, (wi, _, _) in enumerate(staged)
                   if plan.spans[wi][2] not in ("quiet", "recovery"))
    for i, (inputs, n) in enumerate(calls[:fault_i + 1]):
        if i not in (quiet_i, fault_i):
            plan.server.jit_serve_many(plan.params, plan.state, *inputs,
                                       flush_every=1, collect=False)
            continue
        label = plan.spans[staged[i][0]][2]
        got = phase_profile(
            torch, f"profile chaos cascade {label} compiled", n,
            lambda: plan.server.jit_serve_many(
                plan.params, plan.state, *inputs, flush_every=1,
                collect=False)[1])
        if got is not None:
            busy = sum(got[0].values()) / 1e3 / n
            wall = statistics.median([m[i] for m in ms["compiled"]])
            print(f"[chaos cascade] {label} chunk of {n} steps: device "
                  f"kernel time {busy:.3f} ms a step, unprofiled compiled "
                  f"replay {wall:.3f} ms a step, idle share "
                  f"{1 - busy / wall:.3f}")
    del fresh


def chaos_single(torch):
    """The single-model server in phase 2's deployment (2**20 x 8 tiers,
    B=512, miss budget 384, phase 2's 119 steps, admission at B tokens a
    step) under the cascade preset and under a flush stall alone over the
    same span: compiled cuda (``jit_serve_many``, chunks cut at the fault
    edges) against eager torch, bit-identical in counters, outputs and
    every state tensor."""
    import dataclasses

    import numpy as np

    from repro_torch.core import server as srv
    from repro_torch.core.config import CacheConfig
    from repro_torch.core.hashing import Key64
    from repro_torch.ft import chaos
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch
    from repro_torch.models import recsys as rec

    dev = torch.device("cuda")
    tcfg, params, tower_fn, features_of = launch.build_tower(
        "sasrec", backend="cuda", device=dev, smoke=False, seed=0)
    keys, feats, nows, _ = staged_stream(torch, launch, features_of, dev,
                                         COMPILED_STEPS)
    nows_np = nows.cpu().numpy().astype(np.int64)
    horizon = int(nows_np[-1]) + 1
    cfg = CacheConfig(model_id=1, model_type="ctr", n_buckets=N_BUCKETS,
                      ways=WAYS, value_dim=tcfg.user_embed_dim,
                      miss_budget_frac=0.75, backend="cuda",
                      infer_budget_per_step=float(BATCH),
                      failover_ttl_relax=None)
    plain_cfg = dataclasses.replace(cfg, backend="torch")
    servers = {
        "cuda": srv.CachedEmbeddingServer(cfg=cfg, tower_fn=tower_fn,
                                          miss_budget=int(BATCH * 0.75)),
        "torch": srv.CachedEmbeddingServer(
            cfg=plain_cfg, miss_budget=int(BATCH * 0.75),
            tower_fn=lambda p, f: rec.tower_step(p, f, tcfg, impl="torch"))}
    cascade = chaos.preset_faults("cascade", horizon, n_models=1,
                                  n_buckets=N_BUCKETS)
    lo, hi = cascade[0].t0_ms, cascade[0].t1_ms
    for name, faults in (("cascade", cascade),
                         ("stall", [chaos.FlushStall(lo, hi)])):
        sched = chaos.compile_schedule(
            faults, nows_np, BATCH, n_models=1, n_buckets=N_BUCKETS,
            retry=chaos.RetryPolicy(max_retries=2), seed=1, device=dev)
        snow = chaos.skewed_now(sched, nows_np)
        spans = launch._window_steps(chaos.fault_windows(faults, horizon),
                                     nows_np, 24)
        calls = []
        for w_lo, w_hi, _ in spans:
            for a, n in launch._chunks(w_hi - w_lo, COMPILED_CHUNK):
                sl = slice(w_lo + a, w_lo + a + n)
                calls.append((Key64(keys.hi[sl], keys.lo[sl]),
                              {k: v[sl] for k, v in feats.items()},
                              snow[sl], None,
                              chaos.slice_schedule(sched, sl.start,
                                                   sl.stop)))
        runs = {}
        for backend in ("cuda", "torch"):
            server = servers[backend]
            state = srv.init_server_state(server.cfg,
                                          writebuf_capacity=BATCH * 4,
                                          device=dev)
            run = server.jit_serve_many if backend == "cuda" else \
                server.serve_many
            ops.reset_launch_counts()
            out = []
            for inputs in calls:
                state, acc, ys = run(params, state, *inputs, flush_every=1)
                out.append((srv.fetch_counters(acc), ys))
            runs[backend] = (out, state, ops.launch_counts())
        (out, st, n), (out_t, st_t, _) = runs["cuda"], runs["torch"]
        if {k: v for k, v in n.items() if v} != {
                "cache_probe_dual": COMPILED_STEPS,
                "embedding_bag": COMPILED_STEPS}:
            raise AssertionError(f"single {name}: launches {n}")
        for (c, ys), (c_t, ys_t) in zip(out, out_t):
            if c != c_t or not all(torch.equal(x, y)
                                   for x, y in zip(ys, ys_t)):
                raise AssertionError(f"single {name}: counters or outputs "
                                     "differ, compiled cuda vs eager torch")
        same_tensors(torch, st, st_t, f"single {name}")
        tot = {k: sum(c[k] for c, _ in out) for k in CHAOS_FAULT_KEYS}
        if name == "stall" and not tot["write_ring_drops"] > 0:
            raise AssertionError("the flush stall dropped no ring record")
        print(f"[chaos single {name}] SASRec full width, {N_BUCKETS}x{WAYS} "
              f"tiers, B={BATCH}, {COMPILED_STEPS} steps in chunks of "
              f"{'/'.join(str(int(c[2].shape[0])) for c in calls)}: "
              f"compiled cuda == eager torch in counters, sources, ages, "
              f"embeddings, every state tensor; "
              + ", ".join(f"{k} {v}" for k, v in tot.items())
              + f"; {graph_line(servers['cuda'], 'cache_probe_dual')}")
        del runs, st, st_t
        servers["cuda"].jit_serve_many.graphs.clear()


def chaos_benign(torch, launch):
    """A benign schedule through ``jit_serve_many`` against ``chaos=None``
    through ``jit_serve_many`` on the chaos deployment: counters (the
    shared keys), outputs and every state tensor bit-identical."""
    import numpy as np

    from repro_torch.core import server as srv
    from repro_torch.ft import chaos

    dev = torch.device("cuda")
    plan = launch.plan_chaos(scenario="incident", backend="cuda",
                             device=dev, **CHAOS)
    steps, cfgs = CHAOS["steps"], list(plan.server.cfgs)
    benign = chaos.benign_schedule(steps, BATCH, n_models=CHAOS["n_models"],
                                   device=dev)
    states = [plan.state, srv.init_multi_server_state(
        cfgs, writebuf_capacity=BATCH * 4, device=dev)]
    for lo, n in launch._chunks(steps, COMPILED_CHUNK):
        keys, feats, nows = launch._stage_steps(
            plan.ids[lo:lo + n], plan.nows[lo:lo + n], plan.features_of, dev)
        args = (plan.slots[lo:lo + n], keys, feats, nows, None)
        out = []
        for state, ch in zip(states, (None, chaos.slice_schedule(
                benign, lo, lo + n))):
            _, acc, ys = plan.server.jit_serve_many(
                plan.params, state, *args, ch, flush_every=1)
            out.append((srv.fetch_counters(acc), ys))
        (a, ya), (b, yb) = out
        if any(b[k] != v for k, v in a.items()) or not all(
                torch.equal(x, y) for x, y in zip(ya, yb)):
            raise AssertionError("a benign schedule differs from chaos=None")
        if any(b[k] for k in ("retries", "blackout_write_drops",
                              "write_ring_drops", "touch_ring_drops")):
            raise AssertionError(f"a benign schedule moved the ledger: {b}")
    same_tensors(torch, states[0], states[1], "benign vs chaos=None")
    print(f"[chaos benign] {steps} steps through jit_serve_many in chunks of "
          f"{COMPILED_CHUNK}: a benign schedule bit-identical to chaos=None "
          f"(counters, embeddings, sources, ages, every state tensor); "
          f"{len(plan.server.jit_serve_many.graphs)} graphs")


def chaos_entry(torch):
    """``launch.serve.main(["--chaos", p, "--users", "1000"])`` per preset
    as a user calls it, at the settings benchmarks/bench_chaos.py serves
    (``run_serving_chaos``'s defaults: SMOKE SASRec, 4 models of 2**10
    buckets, B=256, 1,000 users, 240 steps; the CLI's ``--users`` defaults
    to 2,000, a stream whose incident SLA is 0.975 in both packages), held
    to the bench's gates, beside BENCH_chaos.json (a JAX CPU run of an
    earlier commit). The stream is numpy's Zipf draw, which may differ
    between numpy versions: its digest is printed."""
    import hashlib

    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch

    bench = json.loads((ROOT / "BENCH_chaos.json").read_text())["scenarios"]
    keys = ("sla_served_rate", "fallbacks", "failover_serves", "retries",
            "retry_successes", "blackout_write_drops", "write_ring_drops")
    draw = np.random.default_rng(0).zipf(1.2, size=(240, 256))
    print(f"[chaos entry] numpy {np.__version__}: the stream's Zipf draw "
          f"digest {hashlib.sha1(draw.tobytes()).hexdigest()[:12]}")
    for p in CHAOS_SLA:
        ops.reset_launch_counts()
        rep = launch.main(["--chaos", p, "--users", "1000"])
        n = ops.launch_counts()
        rec = rep["recovery"]["recovered_after_windows"]
        if (rep["sla_served_rate"] < CHAOS_SLA[p] or rec is None
                or rec > CHAOS_RECOVERY_MAX_WINDOWS
                or not rep["conservation_ok"]
                or n["cache_probe_dual_multi"] != rep["steps"]):
            raise AssertionError(f"--chaos {p}: sla {rep['sla_served_rate']}"
                                 f" (floor {CHAOS_SLA[p]}), recovered after "
                                 f"{rec}, conservation "
                                 f"{rep['conservation_ok']}, launches {n}")
        ref = bench[p]
        print(f"[chaos entry {p}] gates held (SLA >= {CHAOS_SLA[p]}, "
              f"recovery <= {CHAOS_RECOVERY_MAX_WINDOWS} windows, "
              f"conservation); port vs BENCH_chaos.json: " + ", ".join(
                  f"{k} {rep[k]} vs {ref[k]}" for k in keys)
              + f", recovered_after {rec} vs "
              f"{ref['recovery']['recovered_after_windows']}, p99 "
              f"{rep['hedging']['p99_ms']} vs {ref['hedging']['p99_ms']} ms")


def phase_chaos(torch):
    """Phase 13: the chaos engine on the card."""
    import gc

    from repro_torch.launch import serve as launch

    torch.backends.cuda.matmul.allow_tf32 = False
    for scenario in ("incident", "cascade", "rolling"):
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        plan, rep, chunks = chaos_scenario(torch, launch, scenario)
        if scenario == "cascade":
            chaos_fault_checks(rep)
            chaos_profile(torch, launch, plan, rep, chunks)
        del plan
        print(f"[chaos {scenario}] done in {time.perf_counter() - t:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    chaos_benign(torch, launch)
    gc.collect()
    torch.cuda.empty_cache()
    chaos_single(torch)
    gc.collect()
    torch.cuda.empty_cache()
    chaos_entry(torch)


# ------------------------------------------------------------ phase 14
# the regional drain at SASRec's published widths: 4 regions of 2**18 x 8
# direct and failover tiers, B=512, phase 2's 20,000-user 10-minute
# stream thinned to a diurnal envelope (78 steps), the drain window at
# chunks of 16 (pre 16 steps, drain 32, post 30)
REGIONS = dict(arch="sasrec", n_regions=4, minutes=10, users=20_000,
               batch=BATCH, drain=True, locality=0.98,
               n_buckets=MULTI_BUCKETS, chunk_steps=16, smoke=False, seed=0)


def phase_regions(torch):
    """Phase 14: ``regional_timeline`` compiled (cuda, ``jit_serve_many``)
    against an eager torch-backend replay, bit-identical in the report
    (counters, re-homes, excursions, region load, the hit-rate curve),
    every chunk's counters and every state tensor (the home table, both
    stacked tiers, both rings, the tokens); the drained region serves 0
    requests in its window; one dual-multi probe a step. Then a timed
    replay, an eager cuda run and a profiled chunk, and ``main(["--regions",
    "4", "--drain"])`` as a user calls it."""
    import gc

    from repro_torch.core.graph import tensors_of
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    runs = {}
    for backend, jit in (("cuda", True), ("torch", False)):
        plan = launch.plan_regional(backend=backend, device=dev, **REGIONS)
        ops.reset_launch_counts()
        d, state, chunks = launch.regional_timeline(
            plan, jit=jit, log=lambda s, b=backend: print(
                f"[regions {b}] {s}"))
        runs[backend] = (plan, d, state, chunks, ops.launch_counts())
    (plan, d, st, chunks, n), (_, d_t, st_t, chunks_t, n_t) = (
        runs["cuda"], runs["torch"])
    steps = d["batches"]
    if {k: v for k, v in n.items() if v} != {
            "cache_probe_dual_multi": steps, "embedding_bag": steps}:
        raise AssertionError(f"regions: launches {n} for {steps} steps")
    if sum(n_t.values()):
        raise AssertionError(f"the torch backend launched kernels: {n_t}")
    strip = lambda r: {k: v for k, v in r.items() if k not in (
        "wall_s", "req_per_s", "step_ms")}
    if strip(d) != strip(d_t) or chunks != chunks_t:
        raise AssertionError("regions: the report or a chunk's counters "
                             "differ, compiled cuda vs eager torch")
    same_tensors(torch, st, st_t, "regions compiled cuda vs eager torch")
    phases = [p for p in ("pre", "drain", "post")
              if d[f"hit_rate_{p}"] is not None]
    if (d["drained_load_during_drain"] != 0 or phases != ["pre", "drain",
                                                         "post"]
            or d["region_load"][d["drain_region"]] <= 0):
        raise AssertionError(f"regions: drained load "
                             f"{d['drained_load_during_drain']}, phases "
                             f"{phases}, region load {d['region_load']}")
    print(f"[regions] SASRec full width, 4 regions of {MULTI_BUCKETS}x{WAYS}"
          f" tiers ({sum(t.nbytes for t in st.inner.direct) / 1e9:.2f} GB "
          f"direct), B={BATCH}, {steps} steps in chunks of "
          f"{REGIONS['chunk_steps']}, drain batches {d['drain_batches']}: "
          f"hit rate pre/drain/post {d['hit_rate_pre']}/"
          f"{d['hit_rate_drain']}/{d['hit_rate_post']}, dip_pp "
          f"{d['dip_pp']}, rehomed {d['rehomed']}, excursions "
          f"{d['excursions']}, region load {d['region_load']}, drained "
          f"region's in-window load {d['drained_load_during_drain']}; "
          f"compiled cuda == eager torch in the report, every chunk's "
          f"counters and every state tensor (home table included); "
          f"launches {n}; {graph_line(plan.server, 'cache_probe_dual_multi')}")
    del runs, st_t

    staged = list(launch.regional_chunks(plan))
    calls = [(inputs, int(inputs[0].shape[0])) for _, _, inputs in staged]
    fresh = plan.server.init_state(writebuf_capacity=BATCH * 4)

    def reset():
        for a, b in zip(tensors_of(plan.state), tensors_of(fresh),
                        strict=True):
            a.copy_(b)

    ms = {}
    for mode in ("compiled", "eager", "compiled"):
        reset()
        run = (plan.server.jit_serve_many if mode == "compiled"
               else plan.server.serve_many)
        got, per = timed_calls(torch, run, plan.params, plan.state, calls)
        if got != chunks:
            raise AssertionError(f"regions {mode} run differs")
        ms.setdefault(mode, []).append(per)
    step = lambda per: sum(m * c for m, (_, c) in zip(per, calls)) / steps
    print(f"[regions] host wall ms a step over {steps} staged steps, "
          f"compiled / eager / compiled: {step(ms['compiled'][0]):.3f} / "
          f"{step(ms['eager'][0]):.3f} / {step(ms['compiled'][1]):.3f}")
    reset()
    i_prof = next(i for i, (_, ph, _) in enumerate(staged) if ph == "drain")
    for i, (inputs, c) in enumerate(calls[:i_prof + 1]):
        drive = lambda inputs=inputs: plan.server.jit_serve_many(
            plan.params, plan.state, *inputs, flush_every=1,
            collect=False)[1]
        if i < i_prof:
            drive()
            continue
        got = phase_profile(torch, "profile regions drain compiled", c,
                            drive)
        if got is not None:
            busy = sum(got[0].values()) / 1e3 / c
            wall = statistics.median([m[i] for m in ms["compiled"]])
            print(f"[regions] drain chunk of {c} steps: device kernel time "
                  f"{busy:.3f} ms a step, unprofiled compiled replay "
                  f"{wall:.3f} ms a step, idle share {1 - busy / wall:.3f}")
    del plan, fresh, st
    gc.collect()
    torch.cuda.empty_cache()
    for argv in (["--regions", "4", "--drain"],
                 ["--regions", "4", "--drain", "--chunk-steps", "8"]):
        ops.reset_launch_counts()
        d = launch.main(argv)
        n = ops.launch_counts()
        if (d["drained_load_during_drain"] != 0
                or n["cache_probe_dual_multi"] != d["batches"]
                or d["requests"] <= 0):
            raise AssertionError(f"{argv}: {d['batches']} batches, drained "
                                 f"load {d['drained_load_during_drain']}, "
                                 f"launches {n}")
        print(f"[regions entry] main({argv}): {d['batches']} steps, drain "
              f"batches {d['drain_batches']}, pre/drain/post "
              f"{d['hit_rate_pre']}/{d['hit_rate_drain']}/"
              f"{d['hit_rate_post']}, drained load "
              f"{d['drained_load_during_drain']}, launches {n}")


# ------------------------------------------------------------ phase 15
# the kill/restore harness (``--restart``) at SASRec's published widths at
# the launcher's defaults: 2**12 x 8 tiers of D=50, 3,000 users, B=256,
# 240 + 120 steps, a snapshot every 40 (the kill lands at step 120)
RESTART = dict(arch="sasrec", smoke=False)
REHASH_COUNTS = r"(\d+) (?:direct|failover)"


def rehash_chunks(detail, chunk=4096):
    """Recency-pass lookups (one tiled probe each) of a rehash restore,
    from its candidate counts."""
    import re

    return sum(-(-int(n) // chunk) for n in re.findall(REHASH_COUNTS,
                                                       detail or ""))


def restart_harness(torch, tmp):
    """``restart_timeline`` compiled on the kernels (``jit_serve_many``, one
    graph a chunk shape a server) against an eager torch-backend run on
    the card: the report, every variant's restored cache image and final
    state bit for bit; modes, the torn step, the ledger, the parity block
    and the warm-vs-cold gain; one dual probe and one bag a step and one
    tiled probe a restore probe and a rehash chunk."""
    from repro_torch.core.graph import tensors_of
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch

    dev = torch.device("cuda")
    runs = {}
    for backend, jit in (("cuda", True), ("torch", False)):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        rep, states = launch.restart_timeline(
            backend=backend, jit=jit, device=dev,
            workdir=str(Path(tmp) / f"harness-{backend}"),
            log=lambda s, b=backend: print(f"[restart {b}] {s}"), **RESTART)
        torch.cuda.synchronize()
        runs[backend] = (rep, states, ops.launch_counts(),
                         time.perf_counter() - t0)
    (rep, st, n, wall), (rep_t, st_t, n_t, wall_t) = (runs["cuda"],
                                                      runs["torch"])
    strip = lambda r: {k: v for k, v in r.items()
                       if k not in ("wall_s", "workdir", "backend")}
    if strip(rep) != strip(rep_t):
        raise AssertionError("restart: the report differs, compiled cuda vs "
                             "eager torch")
    modes = [v["mode"] for v in rep["variants"].values()]
    if (modes != ["bitexact", "rehash", "rehash", "cold"]
            or not rep["torn_step_skipped"] or not rep["ledger_continuous"]
            or not rep["parity"]["pass"] or not rep["warm_vs_cold_gain"] > 0):
        raise AssertionError(f"restart: modes {modes}, torn skipped "
                             f"{rep['torn_step_skipped']}, ledger "
                             f"{rep['ledger_continuous']}, parity "
                             f"{rep['parity']}, gain "
                             f"{rep['warm_vs_cold_gain']}")
    for name in st:
        if st[name]["detail"] != st_t[name]["detail"]:
            raise AssertionError(f"restart {name}: {st[name]['detail']!r} "
                                 f"vs {st_t[name]['detail']!r}")
        for part in ("restored", "final"):
            same_tensors(torch, st[name][part], st_t[name][part],
                         f"restart {name} {part}, cuda vs torch")
    steps = rep["kill_step"] + 4 * rep["recovery_steps"]
    chunks = sum(rehash_chunks(v["detail"]) for v in st.values())
    want = {"cache_probe_dual": steps, "embedding_bag": steps,
            "cache_probe_tiled": 3 + chunks}
    if {k: v for k, v in n.items() if v} != want or sum(n_t.values()):
        raise AssertionError(f"restart: launches {n} (torch {n_t}), want "
                             f"{want}")
    bench = json.loads((ROOT / "BENCH_restart.json").read_text())
    curve = lambda r: "/".join(
        str(r["variants"][k]["recovery_hit_rate"])
        for k in ("warm_same", "warm_grow", "warm_shrink", "cold"))
    print(f"[restart] SASRec full width, {rep['n_buckets']}x8 tiers, "
          f"{rep['users']} users, B={rep['batch']}, kill at step "
          f"{rep['kill_step']} (a snapshot every {rep['checkpoint_every']}"
          f"), {rep['recovery_steps']} recovery steps: modes "
          f"{'/'.join(modes)}, recovery hit rate same/grow/shrink/cold "
          f"{curve(rep)}, warm-vs-cold gain {rep['warm_vs_cold_gain']}, "
          f"pre hit rate {rep['pre_hit_rate']}, parity {rep['parity']}, "
          f"torn step skipped, ledger continuous; compiled cuda == eager "
          f"torch in the report and every restored and final tensor of the "
          f"4 variants; launches {n}; wall {wall:.2f} s compiled cuda, "
          f"{wall_t:.2f} s eager torch")
    print(f"[restart] beside BENCH_restart.json (the reference at the "
          f"bench's quick settings: {bench['users']} users, B="
          f"{bench['batch']}, {bench['n_buckets']} buckets, a snapshot every "
          f"{bench['checkpoint_every']}, SMOKE tower): recovery hit rate "
          f"{curve(bench)}, gain {bench['warm_vs_cold_gain']}, pre hit rate "
          f"{bench['pre_hit_rate']} (another stream: not gated)")


def restart_full_state(torch, tmp):
    """Snapshot and restore of phase 2's deployment (2**20 x 8 tiers of
    D=50 float32, about 1.8 GB a tier) served over phase 2's 119 steps:
    ``snapshot_server`` with ``retain_last_k=1``, a bit-exact
    ``restore_server`` equal to the served tables plane for plane, then a
    rehash restore into 2**21 buckets where every live key of both tiers
    still hits with bit-identical values. Seconds and GB/s of each."""
    import dataclasses
    import shutil

    from repro_torch.core import cache as C
    from repro_torch.core import server as srv
    from repro_torch.core.config import CacheConfig
    from repro_torch.core.graph import tensors_of
    from repro_torch.core.hashing import Key64
    from repro_torch.core.metrics import ServingCounters
    from repro_torch.ft import snapshot as snap
    from repro_torch.launch import serve as launch

    dev = torch.device("cuda")
    tcfg, params, tower_fn, features_of = launch.build_tower(
        "sasrec", backend="cuda", device=dev, smoke=False, seed=0)
    cfg = CacheConfig(model_id=1, model_type="ctr", n_buckets=N_BUCKETS,
                      ways=WAYS, value_dim=tcfg.user_embed_dim,
                      miss_budget_frac=0.75, backend="cuda")
    server = srv.CachedEmbeddingServer(cfg=cfg, tower_fn=tower_fn,
                                       miss_budget=int(BATCH * 0.75))
    state = srv.init_server_state(cfg, writebuf_capacity=BATCH * 4,
                                  device=dev)
    steps = 119
    keys, feats, nows, _ = staged_stream(torch, launch, features_of, dev,
                                         steps)
    state, acc, _ = server.serve_many(params, state, keys, feats, nows,
                                      flush_every=1, collect=False)
    counters = ServingCounters.from_stats(srv.fetch_counters(acc))
    now = int(nows[-1])
    image_bytes = sum(t.nbytes for t in tensors_of(srv.cache_image(state)))
    d = str(Path(tmp) / "full")
    free = shutil.disk_usage(tmp).free
    print(f"[restart full] {tmp}: {free / 1e9:.1f} GB free for a "
          f"{image_bytes / 1e9:.2f} GB image")
    if free < 1.5 * image_bytes:
        raise AssertionError("not enough free space for the snapshot")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    state, t_save = timed(lambda: snap.snapshot_server(
        d, steps, server, state, now, counters=counters, retain_last_k=1))
    on_disk = sum(f.stat().st_size for f in Path(d).rglob("*")
                  if f.is_file())
    r, t_load = timed(lambda: snap.restore_server(
        d, server, now_ms=now, writebuf_capacity=BATCH * 4, device=dev))
    if (r.mode, r.step) != ("bitexact", steps) or r.counters != counters:
        raise AssertionError(f"full-state restore: {r.mode} {r.step} "
                             f"{r.detail}")
    same_tensors(torch, srv.cache_image(r.state), srv.cache_image(state),
                 "bit-exact restore vs the served tables")
    del r
    torch.cuda.empty_cache()
    grown = srv.CachedEmbeddingServer(
        cfg=dataclasses.replace(cfg, n_buckets=2 * N_BUCKETS),
        tower_fn=tower_fn, miss_budget=int(BATCH * 0.75))
    g, t_grow = timed(lambda: snap.restore_server(
        d, grown, now_ms=now, writebuf_capacity=BATCH * 4, device=dev))
    if g.mode != "rehash":
        raise AssertionError(f"grown restore: {g.mode} {g.detail}")
    u = torch.unique(torch.stack([keys.hi.reshape(-1), keys.lo.reshape(-1)],
                                 1), dim=0)
    users = Key64(hi=u[:, 0].contiguous(), lo=u[:, 1].contiguous())
    live = {}
    for tier, ttl in (("direct", cfg.cache_ttl_ms),
                      ("failover", cfg.resolved_failover_relax_ttl_ms())):
        a = C.lookup(getattr(state, tier), users, now, ttl, backend="cuda")
        b = C.lookup(getattr(g.state, tier), users, now, ttl, backend="cuda")
        if not (bool((b.hit | ~a.hit).all())
                and torch.equal(b.values[a.hit], a.values[a.hit])
                and torch.equal(b.age_ms[a.hit], a.age_ms[a.hit])):
            raise AssertionError(f"grown restore: a live {tier} key misses "
                                 "or its value or age differs")
        live[tier] = int(a.hit.sum())
    gb = image_bytes / 1e9
    print(f"[restart full] phase 2's deployment ({N_BUCKETS}x{WAYS} tiers "
          f"of D={tcfg.user_embed_dim} float32, {gb:.2f} GB image, "
          f"{on_disk / 1e9:.2f} GB on disk) served over {steps} steps: "
          f"snapshot_server {t_save:.2f} s ({gb / t_save:.2f} GB/s); "
          f"bit-exact restore_server {t_load:.2f} s ({gb / t_load:.2f} "
          f"GB/s), equal to the served tables plane for plane; rehash "
          f"restore into {2 * N_BUCKETS} buckets {t_grow:.2f} s "
          f"({gb / t_grow:.2f} GB/s read), {g.detail}; {live['direct']} "
          f"live direct and "
          f"{live['failover']} live failover keys of {users.hi.numel()} "
          "users all still hit, values and ages bit-identical")


def phase_restart(torch):
    """Phase 15: the kill/restore harness compiled against eager torch,
    then snapshot and restore of phase 2's full-size tiers, in a temporary
    directory removed afterwards."""
    import gc
    import shutil
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-restart-")
    try:
        restart_harness(torch, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        restart_full_state(torch, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------ phase 16
# llama-100m in float32 with TF32 off: the card and the CPU sum the same
# matmuls in other orders through 12 layers, a loss of ~10.4 and a grad
# norm of a few units; a resumed run restores every leaf bit for bit and
# replays the same kernels, so any gap is the card's own non-determinism.
CARD_CPU_RTOL = 1e-4
RESUME_RTOL = 1e-5


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def free_card(torch):
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


class StepRecorder:
    """Wraps a loop's ``step(state, batch)``: the metrics of every step,
    its host ms (synchronized), and the device kernel ms of the last one
    (``n_steps``-th call) under torch.profiler."""

    def __init__(self, torch, step_fn, n_steps):
        self.torch, self.step_fn, self.n_steps = torch, step_fn, n_steps
        self.metrics, self.host_ms, self.device_ms = [], [], None

    def __call__(self, state, batch):
        torch = self.torch
        last = len(self.metrics) + 1 == self.n_steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if last:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                state, m = self.step_fn(state, batch)
                torch.cuda.synchronize()
            ev = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
            self.device_ms = sum(e.time_range.end - e.time_range.start
                                 for e in ev) / 1e3
        else:
            state, m = self.step_fn(state, batch)
            torch.cuda.synchronize()
            self.host_ms.append((time.perf_counter() - t0) * 1e3)
        self.metrics.append({k: float(v) for k, v in m.items()})
        return state, m

    @property
    def losses(self):
        return [m["loss"] for m in self.metrics]


def train_line(torch, arch, n_params, rec, smi):
    host = statistics.median(rec.host_ms)
    idle = 1.0 - rec.device_ms / host
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[train] {arch}: {n_params / 1e6:.1f}M params, "
          f"{len(rec.metrics)} steps, loss first {rec.losses[0]:.6f} last "
          f"{rec.losses[-1]:.6f}, host {host:.2f} ms/step (median), device "
          f"{rec.device_ms:.2f} ms/step (last step, profiled; idle "
          f"{idle:.3f}), peak {peak:.2f} GB | {smi}")


def check_finite(losses, what):
    import math

    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{what}: a loss is not finite: {losses}")


def train_llama(torch, smi):
    """(a) llama-100m: 20 steps with checkpoints in a temporary directory
    (removed afterwards), a resume from step 10, and the first step
    against the port's CPU step."""
    import shutil
    import tempfile

    ckpt_dir = Path(tempfile.mkdtemp(prefix="chip-smoke-train-"))
    try:
        train_llama_in(torch, smi, ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def train_llama_in(torch, smi, ckpt_dir):
    import itertools
    import shutil

    from repro_torch.examples.train_lm import llama_100m_config
    from repro_torch.launch.train import lm_batches, lm_train_state
    from repro_torch.models import transformer as tfm
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.train_loop import LoopConfig, run_train_loop

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on")
    cfg = llama_100m_config()
    steps, B, S = 20, 8, 256
    opt = opt_lib.for_config(cfg, total_steps=steps)
    state = lm_train_state(cfg, opt, "cuda")
    cpu_params = opt_lib.tree_map(lambda t: t.detach().cpu().clone(),
                                  state.params)
    cpu_state = tfm.TrainState(cpu_params, opt.init(cpu_params),
                               torch.zeros((), dtype=torch.int32))
    t0 = time.perf_counter()
    _, cpu_m = tfm.make_train_step(cfg, opt)(
        cpu_state, next(lm_batches(cfg, B, S, device="cpu")))
    cpu_s = time.perf_counter() - t0
    loop = LoopConfig(total_steps=steps, log_every=10, ckpt_every=10,
                      ckpt_dir=str(ckpt_dir), keep_last=5)
    logs = []
    rec = StepRecorder(torch, tfm.make_train_step(cfg, opt), steps)
    run_train_loop(rec, state, lm_batches(cfg, B, S, device="cuda"), loop,
                   log_fn=logs.append)
    for line in logs:
        print(f"[train llama-100m] {line}")
    check_finite(rec.losses, "llama-100m")
    train_line(torch, cfg.arch_id, cfg.param_count(), rec, smi)
    first = rec.metrics[0]
    for k in ("loss", "grad_norm"):
        card, cpu = first[k], float(cpu_m[k])
        rel = abs(card - cpu) / abs(cpu)
        print(f"[train llama-100m] step 1 {k}: card {card:.7f} cpu "
              f"{cpu:.7f} rel {rel:.2e} (bar {CARD_CPU_RTOL:g}; cpu step "
              f"{cpu_s:.1f} s)")
        if not rel <= CARD_CPU_RTOL:
            raise AssertionError(f"llama-100m step 1 {k}: card {card} vs "
                                 f"cpu {cpu}")
    # resume: drop the final checkpoint, restart the loop from step 10
    # (from another init, which the restore replaces) on the stream's
    # batches 11-20 (the loop restarts its iterator; the data position is
    # the caller's)
    shutil.rmtree(ckpt_dir / f"step_{steps:08d}")
    del state
    free_card(torch)
    logs2 = []
    rec2 = StepRecorder(torch, tfm.make_train_step(cfg, opt), steps // 2)
    run_train_loop(rec2, lm_train_state(cfg, opt, "cuda", seed=1),
                   itertools.islice(lm_batches(cfg, B, S, device="cuda"),
                                    steps // 2, None), loop,
                   log_fn=logs2.append)
    if logs2[0] != "[resume] from checkpoint step 10":
        raise AssertionError(f"llama-100m resume: {logs2[:1]}")
    want, got = rec.losses[10:], rec2.losses
    worst = max(abs(a - b) / abs(a) for a, b in zip(want, got))
    print(f"[train llama-100m] resumed from step 10: steps 11-20 losses "
          f"max rel diff {worst:.2e} (bar {RESUME_RTOL:g}), bit-identical "
          f"{want == got}; {logs2[-1]}")
    if len(got) != 10 or not worst <= RESUME_RTOL:
        raise AssertionError(f"llama-100m resume: {got} vs {want}")


def train_granite(torch, smi):
    """(b) granite-moe-1b-a400m at its published widths: 5 steps of
    Adafactor on one repeated batch."""
    import itertools

    from repro_torch.configs import get_config
    from repro_torch.launch.train import lm_batches, lm_train_state
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tfm
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.train_loop import LoopConfig, run_train_loop

    cfg = get_config("granite-moe-1b-a400m")
    steps, B, S = 5, 8, 128
    g = moe_lib.pick_group_size(B * S, cfg.moe_group_size)
    print(f"[train granite-moe-1b-a400m] {B * S // g} dispatch groups of "
          f"{g} tokens, capacity {moe_lib.capacity_for(g, cfg.moe)}; "
          f"{cfg.dtype}, remat {cfg.remat}")
    opt = opt_lib.for_config(cfg, total_steps=steps)
    state = lm_train_state(cfg, opt, "cuda")
    batch = next(lm_batches(cfg, B, S, device="cuda"))
    rec = StepRecorder(torch, tfm.make_train_step(cfg, opt), steps)
    run_train_loop(rec, state, itertools.repeat(batch),
                   LoopConfig(total_steps=steps, log_every=1),
                   log_fn=lambda line: print(
                       f"[train granite-moe-1b-a400m] {line}"))
    check_finite(rec.losses, "granite")
    train_line(torch, cfg.arch_id, cfg.param_count(), rec, smi)
    if not rec.losses[-1] < rec.losses[0]:
        raise AssertionError(f"granite: the loss did not fall on a "
                             f"repeated batch: {rec.losses}")


def train_recsys(torch, arch, smi):
    """(c) one tower at its published widths, 3 steps on one batch of
    65,536; returns the trained SASRec params and a batch to serve."""
    import itertools

    from repro_torch.configs import RECSYS_SHAPES, get_config
    from repro_torch.launch.train import (loop_step, recsys_batches,
                                          recsys_train_state)
    from repro_torch.models import recsys as rec_lib
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.train_loop import LoopConfig, run_train_loop

    cfg = get_config(arch)
    steps, B = 3, RECSYS_SHAPES["train_batch"].batch
    opt = opt_lib.for_config(cfg)
    state = recsys_train_state(cfg, opt, "cuda")
    n_params = sum(t.numel() for t in opt_lib.tree_leaves(state[0]))
    batch = next(recsys_batches(cfg, B, device="cuda"))
    rec = StepRecorder(torch, loop_step(rec_lib.make_train_step(cfg, opt)),
                       steps)
    state = run_train_loop(rec, state, itertools.repeat(batch),
                           LoopConfig(total_steps=steps, log_every=steps),
                           log_fn=lambda line: print(f"[train {arch}] "
                                                     f"{line}"))
    check_finite(rec.losses, arch)
    train_line(torch, arch, n_params, rec, smi)
    if not rec.losses[-1] <= rec.losses[0] + 1e-3:
        raise AssertionError(f"{arch}: the loss rose: {rec.losses}")
    return (state[0], batch) if arch == "sasrec" else None


def serve_trained_sasrec(torch, params, batch):
    """(d) the trained SASRec behind tower_step: the bag kernel against
    its plain version, bit for bit at nnz=1 (a quarter of the positions
    padded with -1)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import embedding_bag as ebk
    from repro_torch.models import recsys as rec_lib

    cfg = get_config("sasrec")
    model = rec_lib.bind_tree(rec_lib.SASRec.from_config(cfg, "meta"),
                              params)
    seq = batch["seq"][:BATCH].clone()
    seq[:, : cfg.seq_len // 4] = -1
    n0 = ebk.LAUNCHES["embedding_bag"]
    got = rec_lib.tower_step(model, {"seq": seq}, cfg, impl="cuda")
    launches = ebk.LAUNCHES["embedding_bag"] - n0
    want = rec_lib.tower_step(model, {"seq": seq}, cfg, impl="torch")
    same = torch.equal(got, want)
    print(f"[train sasrec serve] trained tower at B={BATCH}: cuda == torch "
          f"{same}, {launches} bag launch(es), max |out| "
          f"{float(got.abs().max()):.4f}")
    if not same or launches != 1 or ebk.LAUNCHES["embedding_bag"] != n0 + 1:
        raise AssertionError("trained SASRec: the bag kernel disagrees with "
                             "its plain version or did not launch once")


def phase_train(torch):
    """Phase 16: the training slice on the card."""
    smi = smi_line()
    for run in ("llama", "granite"):
        free_card(torch)
        (train_llama if run == "llama" else train_granite)(torch, smi)
    trained = None
    for arch in ("wide-deep", "sasrec", "bst", "mind"):
        free_card(torch)
        out = train_recsys(torch, arch, smi)
        trained = out or trained
    serve_trained_sasrec(torch, *trained)


# ------------------------------------------------------------ phase 17
# The bucket-sharded cache tier on the one card: N shards of every table,
# all on cuda:0 (make_cache_mesh's round-robin over the cards there are).
SHARD_COUNTS = (1, 2, 4, 8)
SHARD_MULTI = 4
SHARD_KERNELS = ("cache_probe_dual", "cache_probe_dual_multi")


def bits_equal(torch, a, b, zero_sign=False):
    """Bit for bit (float32 through an int32 view); with ``zero_sign`` a
    -0.0 may read +0.0, the sharded probe's stated rule at N >= 2."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype != torch.float32:
        return torch.equal(a, b)
    same = a.view(torch.int32) == b.view(torch.int32)
    if zero_sign:
        same |= (a == 0) & (b == 0)
    return bool(same.all())


def state_tensors(state):
    """Every tensor of a server state, its sharded tables gathered into
    the global planes."""
    from repro_torch.core.graph import tensors_of
    from repro_torch.distributed.sharding import gather_cache

    return tensors_of(state._replace(direct=gather_cache(state.direct),
                                     failover=gather_cache(state.failover)))


def compare_sharded(torch, base, run, what, zero_sign=False):
    """Counters, sources, ages and embeddings of every chunk and every
    state tensor (both tiers' planes, both rings, the budget) equal."""
    if base["chunks"] != run["chunks"]:
        raise AssertionError(f"{what}: counters differ")
    for name in ("src", "age", "emb"):
        for x, y in zip(base[name], run[name], strict=True):
            if not bits_equal(torch, x, y, zero_sign and name == "emb"):
                raise AssertionError(f"{what}: {name} differ")
    for i, (x, y) in enumerate(zip(state_tensors(base["state"]),
                                   state_tensors(run["state"]),
                                   strict=True)):
        if not bits_equal(torch, x, y):
            raise AssertionError(f"{what}: state tensor {i} differs")


def shard_compiled(torch, eager, stream, chunk, mesh):
    """The eager run's deployment through ``jit_serve_many`` from a fresh
    state: the first chunk captures (its eager first call is the result),
    the second replays, and both equal the eager run in every output and
    state tensor; then a third chunk's replay is profiled."""
    from repro_torch.core import server as srv
    from repro_torch.core.hashing import Key64

    server, params = eager["server"], eager["params"]
    state = srv.init_server_state(server.cfg, writebuf_capacity=BATCH * 4,
                                  device=mesh.devices[0], mesh=mesh)
    keys, feats, nows, _ = stream
    out = {"chunks": [], "emb": [], "src": [], "age": [], "step_ms": [],
           "emb_finite": True}
    inputs = lambda sl: (Key64(keys.hi[sl], keys.lo[sl]),
                         {k: v[sl] for k, v in feats.items()}, nows[sl])
    for lo in (0, chunk):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, acc, ys = server.jit_serve_many(
            params, state, *inputs(slice(lo, lo + chunk)), flush_every=1)
        _chunk_out(torch, out, ys, acc, t0, chunk,
                   ys[0].shape[-1])
    out["state"] = state
    out["graphs"] = list(server.jit_serve_many.graphs.values())
    compare_sharded(torch, eager, out,
                    f"{mesh.n_shards} shards compiled vs eager")
    got = phase_profile(
        torch, f"profile shards {mesh.n_shards} compiled", chunk,
        lambda: server.jit_serve_many(params, state,
                                      *inputs(slice(2 * chunk, 3 * chunk)),
                                      flush_every=1)[1])
    out["device_ms"] = (None if got is None
                        else sum(got[0].values()) / 1e3 / chunk)
    return out


def shard_snapshots(torch, run4, base, stream, chunk, smi):
    """(d): snapshot phase 2's image from 4 shards, restore it onto 1 and
    8 shards bit-exact plane for plane, and rehash it into 2**21 buckets
    on 4 shards, where every live key still hits. Seconds and GB/s."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.core import cache as C
    from repro_torch.core import server as srv
    from repro_torch.core.graph import tensors_of
    from repro_torch.core.hashing import Key64
    from repro_torch.distributed import collectives as coll
    from repro_torch.ft import snapshot as snap
    from repro_torch.launch.mesh import make_cache_mesh

    dev = torch.device("cuda")
    server4, state4 = run4["server"], run4["state"]
    keys, _, nows, _ = stream
    now = int(nows[2 * chunk - 1])
    gb = sum(t.nbytes for t in tensors_of(srv.cache_image(state4))) / 1e9
    base_image = tensors_of(srv.cache_image(base["state"]))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    tmp = tempfile.mkdtemp(prefix="chip-smoke-shards-")
    try:
        d = str(Path(tmp) / "snap")
        _, t_save = timed(lambda: snap.snapshot_server(
            d, 2 * chunk, server4, state4, now, retain_last_k=1))
        times = [f"snapshot from 4 shards {t_save:.2f} s "
                 f"({gb / t_save:.2f} GB/s)"]
        for n in (1, 8):
            target = dataclasses.replace(server4, mesh=make_cache_mesh(n))
            r, t = timed(lambda: snap.restore_server(
                d, target, now_ms=now, writebuf_capacity=BATCH * 4,
                device=dev))
            if r.mode != "bitexact" or r.state.direct.n_shards != n:
                raise AssertionError(f"restore onto {n} shards: {r.mode} "
                                     f"{r.detail}")
            for i, (x, y) in enumerate(zip(
                    tensors_of(srv.cache_image(r.state)), base_image,
                    strict=True)):
                if not bits_equal(torch, x, y):
                    raise AssertionError(f"restore onto {n} shards: image "
                                         f"tensor {i} differs from phase "
                                         "2's served tables")
            times.append(f"bit-exact restore onto {n} shard(s) {t:.2f} s "
                         f"({gb / t:.2f} GB/s)")
            del r
            torch.cuda.empty_cache()
        grown = dataclasses.replace(
            server4, cfg=dataclasses.replace(server4.cfg,
                                             n_buckets=2 * N_BUCKETS))
        g, t_grow = timed(lambda: snap.restore_server(
            d, grown, now_ms=now, writebuf_capacity=BATCH * 4, device=dev))
        if g.mode != "rehash" or g.state.direct.n_buckets != 2 * N_BUCKETS:
            raise AssertionError(f"grown restore: {g.mode} {g.detail}")
        times.append(f"rehash restore into {2 * N_BUCKETS} buckets on 4 "
                     f"shards {t_grow:.2f} s ({gb / t_grow:.2f} GB/s read)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    sl = slice(0, 2 * chunk)
    u = torch.unique(torch.stack([keys.hi[sl].reshape(-1),
                                  keys.lo[sl].reshape(-1)], 1), dim=0)
    users = Key64(hi=u[:, 0].contiguous(), lo=u[:, 1].contiguous())
    cfg = server4.cfg
    ttl = (cfg.cache_ttl_ms, cfg.resolved_failover_relax_ttl_ms())
    a = C.lookup_dual(base["state"].direct, base["state"].failover, users,
                      now, *ttl, backend="cuda")
    b = coll.sharded_lookup_dual(grown.mesh, g.state.direct,
                                 g.state.failover, users, now, *ttl,
                                 backend="cuda")
    live = []
    for tier, x, y in zip(("direct", "failover"), a, b):
        if not (bool((y.hit | ~x.hit).all())
                and bits_equal(torch, y.values[x.hit], x.values[x.hit],
                               zero_sign=True)
                and torch.equal(y.age_ms[x.hit], x.age_ms[x.hit])):
            raise AssertionError(f"grown restore: a live {tier} key misses "
                                 "or its value or age differs")
        live.append(int(x.hit.sum()))
    print(f"[shards snapshot] phase 2's image ({gb:.2f} GB): "
          + "; ".join(times) + f"; {g.detail}; {live[0]} live direct and "
          f"{live[1]} live failover keys of {users.hi.numel()} users all "
          f"still hit on 4 shards; {smi}")


def shard_entry(torch):
    """(e): ``run_serving(n_shards=4)`` as a user calls it: the report of
    ``n_shards=1`` but ``n_shards`` and the clock keys; 4 dual-probe
    launches a step."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch

    reports, launches = {}, {}
    for n in (1, 4):
        ops.reset_launch_counts()
        reports[n] = launch.run_serving(
            arch="sasrec", minutes=8, users=400, backend="cuda", n_shards=n,
            log=lambda line, n=n: print(f"[shards entry {n}] {line}"))
        launches[n] = ops.launch_counts()["cache_probe_dual"]
    one, four = reports[1], reports[4]
    for k in set(one) - {"wall_s", "req_per_s", "n_shards"}:
        if four[k] != one[k]:
            raise AssertionError(f"run_serving(n_shards=4): {k} "
                                 f"{four[k]} != {one[k]}")
    if (four["n_shards"], launches[1], launches[4]) != (
            4, one["batches"], 4 * one["batches"]):
        raise AssertionError(f"run_serving(n_shards=4): launches {launches}"
                             f" for {one['batches']} batches")
    print(f"[shards entry] run_serving(n_shards=4) == n_shards=1 in every "
          f"report key but n_shards and the clock ({one['batches']} "
          f"batches, hit rate {four['hit_rate']:.4f}); dual launches "
          f"{launches[1]} / {launches[4]}; wall {one['wall_s']} / "
          f"{four['wall_s']} s")


def phase_shards(torch, counts):
    """Phase 17: the bucket-sharded cache tier on the card."""
    import gc

    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch
    from repro_torch.launch.mesh import make_cache_mesh

    t_phase = time.perf_counter()
    smi = smi_line()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chunk = 32
    steps = 2 * chunk
    _, _, _, features_of = launch.build_tower("sasrec", backend="torch",
                                              device=dev, smoke=False)
    stream = staged_stream(torch, launch, features_of, dev, 3 * chunk)
    base = serve_run(torch, "cuda", stream, chunk)      # phase 2's run
    path = {k: 0 for k in SHARD_KERNELS}
    for n in SHARD_COUNTS:
        mesh = make_cache_mesh(n)
        if mesh.devices != (torch.device("cuda", 0),) * n:
            raise AssertionError(f"mesh placement {mesh.devices}")
        ops.reset_launch_counts()                # this path's window
        run = serve_run(torch, "cuda", stream, chunk, mesh=mesh)
        got = ops.launch_counts()
        if got["cache_probe_dual"] != n * steps:
            raise AssertionError(f"{n} shards: {got['cache_probe_dual']} "
                                 f"dual launches for {steps} steps")
        path["cache_probe_dual"] += got["cache_probe_dual"]
        compare_sharded(torch, base, run, f"{n} shards vs unsharded",
                        zero_sign=n > 1)
        comp = shard_compiled(torch, run, stream, chunk, mesh)
        (graph,) = comp["graphs"]
        if graph.launches.get("cache_probe_dual") != n * chunk:
            raise AssertionError(f"{n} shards: graph launches "
                                 f"{graph.launches}")
        dms = comp["device_ms"]
        print(f"[shards {n}] phase 2's deployment on {n} shard(s) of "
              f"cuda:0 ({N_BUCKETS // n} buckets a shard): {steps} steps "
              f"bit-identical to the unsharded cuda run (counters, sources, "
              f"ages, embeddings{' up to -0.0 -> +0.0' if n > 1 else ''}, "
              f"every plane of both tiers, both rings, the budget); "
              f"compiled == eager; host ms a step eager "
              f"{run['step_ms'][1]:.3f} (warm), compiled "
              f"{comp['step_ms'][1]:.3f} (replay; first call (eager + "
              f"capture) {graph.capture_s:.2f} s, pool "
              f"{graph.pool_bytes / 1e6:.1f} MB); device ms a step "
              + ("not measured" if dms is None else f"{dms:.3f}")
              + f" (profiled compiled chunk); probe launches a step "
              f"{graph.launches['cache_probe_dual'] // chunk}; {smi}")
        if n == 4:
            print("[shards compiled] 4 shards: the compiled chunks equal "
                  "the eager ones in every output and state tensor")
            shard_snapshots(torch, run, base, stream, chunk, smi)
        del run, comp, graph
        gc.collect()
        torch.cuda.empty_cache()
    del base
    gc.collect()
    torch.cuda.empty_cache()

    slots = torch.as_tensor(
        (np.arange(BATCH)[None, :] + np.arange(3 * chunk)[:, None]) % 8,
        dtype=torch.int32, device=dev)
    mbase = multi_run(torch, "cuda", stream, slots, chunk)   # phase 4's
    ops.reset_launch_counts()                    # this path's window
    mrun = multi_run(torch, "cuda", stream, slots, chunk,
                     mesh=make_cache_mesh(SHARD_MULTI))
    got = ops.launch_counts()["cache_probe_dual_multi"]
    if got != SHARD_MULTI * steps:
        raise AssertionError(f"multi on {SHARD_MULTI} shards: {got} "
                             f"dual-multi launches for {steps} steps")
    path["cache_probe_dual_multi"] += got
    compare_sharded(torch, mbase, mrun, f"multi on {SHARD_MULTI} shards",
                    zero_sign=True)
    print(f"[shards multi] phase 4's deployment (8 models) on "
          f"{SHARD_MULTI} shards: {steps} steps bit-identical to the "
          f"unsharded cuda run (counters with every per-model vector, "
          f"sources, ages, embeddings up to -0.0 -> +0.0, every plane of "
          f"both stacked tiers, both rings, the budget); host ms a step "
          f"eager {mrun['step_ms'][1]:.3f} (unsharded "
          f"{mbase['step_ms'][1]:.3f}); dual-multi launches a step "
          f"{got // steps}; {smi}")
    del mbase, mrun
    gc.collect()
    torch.cuda.empty_cache()
    shard_entry(torch)
    for k, v in path.items():
        counts[k] = counts.get(k, 0) + v
    print(f"[shards] phase 17 launches {path} added to the kernels line; "
          f"phase done in {time.perf_counter() - t_phase:.1f}s")


# ------------------------------------------------------------ phase 18
MESH_SHARDS = (1, 2, 4)                      # the model axis of (1, N)
MESH_DEC_STEPS = 16
MESH_DEC_TOL = 2e-2                          # phase 8's bf16 relative L2
LONG_STEPS, LONG_SHARDS = 4, 4
TOPK_K = 100                                 # retrieval_step's default
GIN_TOL = 1e-4               # relative to the largest |output| (atomics)
GIN_SHARDS = 4
GIN_TRAIN_STEPS = 20


def model_mesh(torch, dims):
    """A ("data", "model") mesh of ``dims`` whose every shard is cuda:0."""
    from repro_torch.launch.mesh import ModelMesh

    return ModelMesh(dims, ("data", "model"),
                     (torch.device("cuda", 0),) * (dims[0] * dims[1]))


def mesh_wide_deep(torch, smi):
    """(a) Wide&Deep's score at its published widths on (1, N) meshes,
    with and without ``serve_scatter``, against the unsharded cuda score;
    returns the bag launches of the sharded scores (2N a score)."""
    import dataclasses

    import numpy as np

    from repro_torch.kernels import embedding_bag as ebk
    from repro_torch.launch import serve as launch
    from repro_torch.models import recsys as rec

    dev = torch.device("cuda")
    tcfg, params, _, _ = launch.build_tower("wide-deep", backend="cuda",
                                            device=dev, smoke=False, seed=0)
    rng = np.random.default_rng(18)
    batch = {"sparse_ids": torch.as_tensor(rng.integers(
        0, tcfg.vocab, (BATCH, tcfg.n_sparse, tcfg.nnz_per_field)).astype(
        np.int32), device=dev)}
    base = rec.wide_deep_score(params, batch, tcfg, impl="cuda")
    launches = 0
    for n in MESH_SHARDS:
        mesh = model_mesh(torch, (1, n))
        errs = []
        for scatter in (False, True):
            cfg = dataclasses.replace(tcfg, serve_scatter=scatter)
            n0 = ebk.LAUNCHES["embedding_bag"]
            got = rec.wide_deep_score(params, batch, cfg, impl="cuda",
                                      mesh=mesh)
            made = ebk.LAUNCHES["embedding_bag"] - n0
            launches += made
            errs.append(float((got - base).abs().max()))
            if made != 2 * n or not torch.allclose(got, base, **WD_TOL):
                raise AssertionError(f"wide-deep on (1, {n}) scatter="
                                     f"{scatter}: {made} bag launches, max "
                                     f"|err| {errs[-1]:.3g}")
        ms = device_ms(lambda i: rec.wide_deep_score(params, batch, tcfg,
                                                     impl="cuda", mesh=mesh),
                       n=10, reps=3)
        print(f"[mesh wide-deep] (1, {n}) mesh of cuda:0, B={BATCH}, "
              f"{tcfg.n_sparse} x {tcfg.vocab} x {tcfg.embed_dim} tables "
              f"row-sharded {n} ways: {2 * n} bag launches a score; vs the "
              f"unsharded cuda score max |err| {errs[0]:.3g} (serve_scatter "
              f"{errs[1]:.3g}; WD_TOL); device {ms:.4f} ms a score | {smi}")
    return launches


def mesh_retrieval(torch, smi):
    """(b) ``retrieval_step(mesh=)`` on BST's 1M-row item table against
    the unsharded step (ids and order), and the top-k tie pass timed
    beside ``torch.topk`` and, on tied scores, a full stable sort."""
    import numpy as np

    from repro_torch.distributed import collectives as coll
    from repro_torch.launch import serve as launch
    from repro_torch.models import recsys as rec

    dev = torch.device("cuda")
    tcfg, params, _, _ = launch.build_tower("bst", backend="cuda", device=dev,
                                            smoke=False, seed=0)
    rng = np.random.default_rng(19)
    seq = torch.as_tensor(rng.integers(0, tcfg.vocab, (
        BATCH, tcfg.seq_len)).astype(np.int32), device=dev)
    user = rec.tower_step(params, {"seq": seq}, tcfg, impl="cuda")
    base_v, base_i = rec.retrieval_step(user, params.item_emb, tcfg)
    for dims in ((1, 4), (2, 2)):
        v, i = rec.retrieval_step(user, params.item_emb, tcfg,
                                  mesh=model_mesh(torch, dims))
        if not (torch.equal(i, base_i) and torch.equal(v, base_v)):
            raise AssertionError(f"retrieval on {dims}: ids or scores differ "
                                 "from the unsharded step")
    scores = user.float() @ params.item_emb.float().T
    tied = scores.to(torch.bfloat16).float()        # many exact ties
    got = coll.top_k(tied, TOPK_K)
    want = torch.sort(tied, dim=-1, descending=True, stable=True)
    if not (torch.equal(got[1], want.indices[:, :TOPK_K])
            and torch.equal(got[0], want.values[:, :TOPK_K])):
        raise AssertionError("top_k on tied scores is not the stable order")
    t = {name: kernel_ms(torch, fn, reps=3)[0] for name, fn in (
        ("topk", lambda: torch.topk(scores, TOPK_K, dim=-1)),
        ("tie pass", lambda: coll.top_k(scores, TOPK_K)),
        ("topk tied", lambda: torch.topk(tied, TOPK_K, dim=-1)),
        ("tie pass tied", lambda: coll.top_k(tied, TOPK_K)),
        ("stable sort tied", lambda: torch.sort(tied, dim=-1,
                                                descending=True,
                                                stable=True)))}
    print(f"[mesh retrieval] BST, {BATCH} users x {params.item_emb.shape[0]} "
          f"items: retrieval_step on (1, 4) and (2, 2) meshes of cuda:0 "
          f"equals the unsharded step (ids, order, scores); top-{TOPK_K} of "
          f"the ({BATCH}, {scores.shape[1]}) scores, device kernel ms: "
          f"torch.topk {t['topk']:.3f}, top_k with the tie pass "
          f"{t['tie pass']:.3f}; on bf16-rounded scores (ties at the k-th "
          f"value; top_k == a stable sort's first {TOPK_K}) torch.topk "
          f"{t['topk tied']:.3f}, top_k {t['tie pass tied']:.3f}, the full "
          f"stable sort {t['stable sort tied']:.3f} | {smi}")


def mesh_decode(torch, smi):
    """(c) TinyLlama decode in phase 8's deployment: the prefill under a
    mesh (22 flash launches), then MESH_DEC_STEPS steps on 1, 2 and 4
    sequence shards against the unsharded cuda decode; (d) long_500k on
    LONG_SHARDS shards against unsharded. Returns (flash launches,
    partials launches)."""
    from repro_torch.configs import LM_SHAPES
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as tfm

    dev = torch.device("cuda")
    cfg = lm_config()
    L = cfg.n_layers
    params = tfm.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                             dev)
    prompt = torch.randint(0, cfg.vocab, (DEC_B, DEC_PROMPT), dtype=torch.int32,
                           device=dev,
                           generator=torch.Generator(device=dev).manual_seed(7))
    n0 = fa.LAUNCHES["flash_attention"]
    logits, cache = tfm.prefill_step(params, prompt, cfg, backend="cuda",
                                     max_seq=DEC_MAX,
                                     mesh=model_mesh(torch, (1, 4)))
    flash = fa.LAUNCHES["flash_attention"] - n0
    if flash != L:
        raise AssertionError(f"prefill under a mesh: {flash} flash launches")
    clone = lambda c: tfm.KVCache(c.k.clone(), c.v.clone(), c.length.clone())
    start = clone(cache)
    toks, want, base_ms = [logits.argmax(-1).to(torch.int32)], [], []
    for _ in range(MESH_DEC_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = tfm.decode_step(params, cache, toks[-1], cfg,
                                    backend="cuda")
        torch.cuda.synchronize()
        base_ms.append((time.perf_counter() - t0) * 1e3)
        want.append(lg)
        toks.append(lg.argmax(-1).to(torch.int32))
    del cache
    partials = 0
    for n in MESH_SHARDS:
        mesh, c, errs, ms = model_mesh(torch, (1, n)), clone(start), [], []
        n0 = dk.LAUNCHES["decode_attention_partials"]
        for i in range(MESH_DEC_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, c = tfm.decode_step(params, c, toks[i], cfg, backend="cuda",
                                    mesh=mesh)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            errs.append(close_errors(torch, lg, want[i])[1])
        made = dk.LAUNCHES["decode_attention_partials"] - n0
        partials += made
        if made != MESH_DEC_STEPS * L * n or max(errs) > MESH_DEC_TOL:
            raise AssertionError(f"decode on {n} sequence shards: {made} "
                                 f"partials launches, worst relative L2 "
                                 f"{max(errs):.3g}")
        print(f"[mesh decode] {cfg.arch_id} B={DEC_B}, prefill of "
              f"{DEC_PROMPT} tokens under a mesh ({L} flash launches), "
              f"{MESH_DEC_STEPS} steps on {n} sequence shard(s) of cuda:0: "
              f"{made // MESH_DEC_STEPS} partials launches a step; logits vs "
              f"the unsharded cuda decode worst relative L2 {max(errs):.3g} "
              f"(tolerance {MESH_DEC_TOL}); host ms a step median "
              f"{statistics.median(ms):.2f} (unsharded "
              f"{statistics.median(base_ms):.2f}) | {smi}")
        del c
    del start
    free_card(torch)

    # (d) long_500k: one row, a seeded cache of 524,288 positions
    from repro_torch.distributed.collectives import \
        seq_sharded_decode_attention

    S = LM_SHAPES["long_500k"].seq_len
    gen = torch.Generator(device=dev).manual_seed(21)
    shape = (L, 1, S, cfg.n_kv_heads, cfg.hd)
    k = torch.empty(shape, dtype=torch.bfloat16, device=dev)
    v = torch.empty(shape, dtype=torch.bfloat16, device=dev)
    for i in range(L):
        k[i].normal_(generator=gen)
        v[i].normal_(generator=gen)
    first = S - LONG_STEPS
    one = tfm.KVCache(k, v, torch.full((1,), first, dtype=torch.int32,
                                       device=dev))
    sharded = clone(one)
    tok = torch.randint(0, cfg.vocab, (1,), dtype=torch.int32, device=dev,
                        generator=gen)
    mesh = model_mesh(torch, (1, LONG_SHARDS))
    toks, want, ms1 = [tok], [], []
    for _ in range(LONG_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a, one = tfm.decode_step(params, one, toks[-1], cfg, backend="cuda")
        torch.cuda.synchronize()
        ms1.append((time.perf_counter() - t0) * 1e3)
        want.append(a)
        toks.append(a.argmax(-1).to(torch.int32))
    errs, ms = [], []
    n0 = dk.LAUNCHES["decode_attention_partials"]
    for i in range(LONG_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b, sharded = tfm.decode_step(params, sharded, toks[i], cfg,
                                     backend="cuda", mesh=mesh)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        errs.append(close_errors(torch, b, want[i])[1])
    made = dk.LAUNCHES["decode_attention_partials"] - n0
    partials += made
    del sharded
    # the noise floor of one bf16 row: the torch backend from the same
    # cache (each step rewrites the row it then attends to)
    torch_errs, one = [], tfm.KVCache(k, v, torch.full_like(one.length,
                                                            first))
    for i in range(LONG_STEPS):
        c, one = tfm.decode_step(params, one, toks[i], cfg, backend="torch")
        torch_errs.append(close_errors(torch, c, want[i])[1])
    bar = max(MESH_DEC_TOL, 2 * max(torch_errs))
    # every layer's sharded attention against the unsharded kernel
    q = torch.randn((1, cfg.n_heads, cfg.hd), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    valid = torch.full((1,), S, dtype=torch.int32, device=dev)
    att = [attention_errors(torch, seq_sharded_decode_attention(
        q, k[i], v[i], mesh, kv_valid_len=valid, backend="cuda"),
        dk.decode_attention(q, k[i], v[i], valid, bs=S), DEC_KERNEL_TOL)
        for i in range(L)]
    kv_gb = 2 * k.nbytes / 1e9
    if (made != LONG_STEPS * L * LONG_SHARDS or max(errs) > bar
            or not all(a[3] for a in att)):
        raise AssertionError(f"long_500k on {LONG_SHARDS} shards: {made} "
                             f"partials launches, worst relative L2 "
                             f"{max(errs):.3g} (bar {bar:.3g}), attention "
                             f"within DEC_KERNEL_TOL {[a[3] for a in att]}")
    print(f"[mesh long_500k] B=1 cache of {S} positions ({kv_gb:.2f} GB of "
          f"bf16 KV, seeded), {LONG_STEPS} steps on {LONG_SHARDS} sequence "
          f"shards vs unsharded: {made // LONG_STEPS} partials launches a "
          f"step; logits relative L2 by step "
          + ", ".join(f"{e:.4f}" for e in errs)
          + " (torch backend vs cuda, the noise floor of one bf16 row: "
          + ", ".join(f"{e:.4f}" for e in torch_errs)
          + f"; bar {bar:.4f}, the larger of {MESH_DEC_TOL} and twice that); "
          f"each of the {L} layers' sharded attention vs the unsharded "
          f"kernel worst relative L2 {max(a[2] for a in att):.3g} within "
          f"DEC_KERNEL_TOL; host ms a step median {statistics.median(ms):.2f}"
          f" (unsharded {statistics.median(ms1):.2f}) | {smi}")
    return flash, partials


def mesh_gin(torch, smi):
    """(e) gin-tu at its published widths: full_graph_sm on the card
    against the port's CPU forward and partitioned over GIN_SHARDS node
    shards; ogb_products' size replicated against partitioned."""
    import copy

    import numpy as np

    from repro_torch.configs import GNN_SHAPES, get_config
    from repro_torch.models import gnn, sampler

    dev = torch.device("cuda")
    cfg = get_config("gin-tu")
    mesh = model_mesh(torch, (GIN_SHARDS, 1))

    def rel_err(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))

    sm = GNN_SHAPES["full_graph_sm"]
    g = sampler.synthetic_power_law_graph(sm.n_nodes, sm.n_edges,
                                          d_feat=sm.d_feat,
                                          n_classes=cfg.n_classes, seed=0)
    recv = np.repeat(np.arange(sm.n_nodes), np.diff(g.indptr)).astype(
        np.int32)
    model = gnn.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                            sm.d_feat, device=dev)
    on_cpu = gnn.Graph(torch.as_tensor(g.node_feats),
                       torch.as_tensor(g.indices), torch.as_tensor(recv))
    want = gnn.forward(copy.deepcopy(model).to("cpu"), on_cpu, cfg)
    feats = on_cpu.node_feats.to(dev)
    got = gnn.forward(model, gnn.Graph(feats, on_cpu.senders.to(dev),
                                       on_cpu.receivers.to(dev)), cfg)
    ps, pr = gnn.partition_edges(g.indices, recv, sm.n_nodes, GIN_SHARDS)
    part = gnn.forward_partitioned(model, gnn.Graph(
        feats, torch.as_tensor(ps, device=dev),
        torch.as_tensor(pr, device=dev)), cfg, mesh)
    e_cpu, e_part = rel_err(got.cpu(), want), rel_err(part, got)
    if e_cpu > GIN_TOL or e_part > GIN_TOL or got.shape != (sm.n_nodes,
                                                            cfg.d_hidden):
        raise AssertionError(f"gin full_graph_sm: card vs CPU {e_cpu:.3g}, "
                             f"partitioned vs replicated {e_part:.3g}")
    print(f"[mesh gin full_graph_sm] {sm.n_nodes} nodes, {g.n_edges} edges "
          f"(power law, sampler copy), d_feat {sm.d_feat}, {cfg.n_layers} "
          f"layers of {cfg.d_hidden}: card vs the port's CPU forward max "
          f"|err| / max |out| {e_cpu:.3g}; partitioned over {GIN_SHARDS} "
          f"node shards vs replicated {e_part:.3g} (tolerance {GIN_TOL})")
    del model, feats

    ob = GNN_SHAPES["ogb_products"]
    n_pad = -(-ob.n_nodes // GIN_SHARDS) * GIN_SHARDS
    gen = torch.Generator(device=dev).manual_seed(20)
    snd, rcv = (torch.randint(0, ob.n_nodes, (ob.n_edges,), generator=gen,
                              device=dev, dtype=torch.int32)
                for _ in range(2))
    feats = torch.zeros((n_pad, ob.d_feat), device=dev)
    feats[:ob.n_nodes].normal_(generator=gen)
    model = gnn.init_params(gen, cfg, ob.d_feat, device=dev)
    out = {}
    for name in ("replicated", "partitioned"):
        if name == "partitioned":
            ps, pr = gnn.partition_edges(snd.cpu().numpy(), rcv.cpu().numpy(),
                                         n_pad, GIN_SHARDS)
            graph = gnn.Graph(feats, torch.as_tensor(ps, device=dev),
                              torch.as_tensor(pr, device=dev))
            del ps, pr
        else:
            graph = gnn.Graph(feats, snd, rcv)
        free_card(torch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = (gnn.forward_partitioned(model, graph, cfg, mesh)
             if name == "partitioned" else gnn.forward(model, graph, cfg))
        torch.cuda.synchronize()
        out[name] = (h[:ob.n_nodes], (time.perf_counter() - t0) * 1e3,
                     torch.cuda.max_memory_allocated() / 1e9)
        del graph, h
    err = rel_err(out["partitioned"][0], out["replicated"][0])
    if err > GIN_TOL or not bool(torch.isfinite(out["replicated"][0]).all()):
        raise AssertionError(f"gin ogb_products: partitioned vs replicated "
                             f"{err:.3g}")
    print(f"[mesh gin ogb_products] {ob.n_nodes} nodes (padded to {n_pad} "
          f"with isolated rows), {ob.n_edges} uniform edges drawn on the "
          f"card, d_feat {ob.d_feat}: replicated forward "
          f"{out['replicated'][1]:.1f} ms, peak {out['replicated'][2]:.2f} "
          f"GB; partitioned over {GIN_SHARDS} node shards "
          f"{out['partitioned'][1]:.1f} ms, peak {out['partitioned'][2]:.2f} "
          f"GB (host wall of one forward, synchronized; the edge partition "
          f"on the host not counted); partitioned vs replicated max |err| / "
          f"max |out| {err:.3g} (tolerance {GIN_TOL}) | {smi}")


def mesh_train(torch, smi):
    """(f) ``launch.train.main`` for gin-tu at its published widths, as a
    user calls it: every loss finite."""
    import contextlib
    import io

    from repro_torch.launch import train as t_train
    from repro_torch.training.optimizer import tree_leaves

    buf = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        params, _ = t_train.main(["--arch", "gin-tu", "--full-config",
                                  "--steps", str(GIN_TRAIN_STEPS),
                                  "--log-every", "1"])
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.splitlines() if line.startswith("[step")]
    check_finite(losses, "gin-tu")
    if len(losses) != GIN_TRAIN_STEPS or not out.rstrip().endswith(
            "[train] done"):
        raise AssertionError(f"gin-tu launcher: {len(losses)} steps logged")
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"[train] gin-tu (launch.train.main --full-config, the sampled "
          f"regime): {n / 1e3:.1f}K params, {GIN_TRAIN_STEPS} steps, loss "
          f"first {losses[0]:.6f} last {losses[-1]:.6f}, host "
          f"{wall / GIN_TRAIN_STEPS * 1e3:.2f} ms/step (mean of the call, "
          f"set-up included), peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB | {smi}")


def phase_mesh(torch, counts):
    """Phase 18: the model-axis mesh and the GNN on the card."""
    from repro_torch.distributed.sharding import constrain
    from repro_torch.launch.mesh import ModelMesh, make_host_mesh

    t_phase = time.perf_counter()
    smi = smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    host = make_host_mesh()
    if host.shape != {"data": 1, "model": 1} or host.device() != torch.device(
            "cuda", 0):
        raise AssertionError(f"make_host_mesh on one card: {host}")
    try:
        constrain(torch.zeros(2, 2, device="cuda"), ("batch", None),
                  "recsys", ModelMesh((1, 2), ("data", "model"),
                                      ("cuda:0", "cpu")))
        raise AssertionError("a mesh over distinct devices was accepted")
    except NotImplementedError as e:
        print(f"[mesh] a mesh over distinct devices refused: {e}")
    path = {"embedding_bag": mesh_wide_deep(torch, smi)}
    free_card(torch)
    mesh_retrieval(torch, smi)
    free_card(torch)
    path["flash_attention"], path["decode_attention_partials"] = \
        mesh_decode(torch, smi)
    free_card(torch)
    mesh_gin(torch, smi)
    free_card(torch)
    mesh_train(torch, smi)
    free_card(torch)
    for k, v in path.items():
        counts[k] = counts.get(k, 0) + v
    print(f"[mesh] phase 18 launches {path} added to the kernels line; "
          f"phase done in {time.perf_counter() - t_phase:.1f}s")



# ------------------------------------------------------------ phase 19
PLAN_BATCH = 4096                  # run_ercache_cell's batch (miss budget /4)
PLAN_SEQ = 64                      # its behaviour-history length
PLAN_STEPS = 8                     # warm replays timed after the capture
PLAN_BOUND_SHARE = 0.95            # no card beats its roofline
CTR = dict(n_users=2000, horizon_h=24.0)  # examples/train_ctr_tower.py
# the plans not ok, with a word of the reason: the reference's shard_map
# of Wide&Deep's row-sharded bag cannot split a batch of 1, on either mesh
PLAN_REFUSED = {("wide-deep", "retrieval_cand", False): "batch 1 ",
                ("wide-deep", "retrieval_cand", True): "batch 1 "}
CTR_NE_RTOL = 1e-5                 # each arm's NE, card vs CPU
CTR_DIFF_ATOL = 1e-4               # each ne_diff_pct, percentage points


def _hide_cards():
    """Pool initializer: the planner's workers trace on meta and never
    touch the card (no CUDA context each)."""
    import os

    os.environ["CUDA_VISIBLE_DEVICES"] = ""


def plan_one(job):
    """One dry-run plan in a worker: (result, the terms line)."""
    import contextlib
    import io

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    arch, shape, multi_pod = job
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = dryrun.run_cell(arch, shape, multi_pod=multi_pod,
                              accounting=get_config(arch).family == "lm")
    return res, buf.getvalue().strip()


def _breakdown(res) -> str:
    """A plan's collectives a device: MB and count by kind, and its
    involuntary gathers."""
    parts = [f"{k} {res['collective_breakdown'][k] / 1e6:.4g} MB "
             f"x{res['collective_counts'][k]}"
             for k in res["collective_breakdown"]
             if res["collective_counts"][k]]
    return (f"collectives {', '.join(parts) or 'none'}; involuntary "
            f"gathers {res['involuntary_gathers']}")


def plan_all(torch):
    """(a) every cell on both production meshes, planned on meta in a
    pool of workers: the plans not ``ok`` are exactly ``PLAN_REFUSED``,
    each for its reason, every other is ``ok``. The LM cells take the
    linear accounting on both meshes (the reference's default takes it on
    the single pod only; the solve equals the direct trace,
    tests/test_torch_launch.py, at a fraction of its time)."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.configs import all_cells
    from repro_torch.launch import dryrun

    cap = dryrun.card_memory_bytes()
    if cap < dryrun.CARD_MEMORY_BYTES:
        raise AssertionError(f"the card holds {cap / 1e9:.2f} GB, less than "
                             f"the workers' {dryrun.CARD_MEMORY_BYTES / 1e9}")
    jobs = [(a, s, mp) for mp in (False, True) for a, s in all_cells()]
    workers = min(8, os.cpu_count() or 1)
    t0 = time.perf_counter()
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"),
            initializer=_hide_cards) as pool:
        done = list(pool.map(plan_one, jobs))
    wall = time.perf_counter() - t0
    results, refused = {}, {}
    for (arch, shape, mp), (res, line) in zip(jobs, done):
        key = f"{arch}|{shape}|{'multipod' if mp else 'singlepod'}"
        results[key] = res
        if res["ok"]:
            print(f"[plan] {line}; {_breakdown(res)}")
        else:
            print(f"[plan] {key} not ok: {res['error']}")
            refused[arch, shape, mp] = res["error"]
    out = ROOT / dryrun.DEFAULT_OUT
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    trace_s = sum(r.get("compile_s", 0.0) for r in results.values())
    print(f"[plan] {len(results)} plans on meta, {len(results) - len(refused)}"
          f" ok, {len(refused)} refused as PLAN_REFUSED names them, in "
          f"{wall:.1f}s wall on {workers} workers ({trace_s:.1f}s of traces;"
          f" per-device memory held to {dryrun.CARD_MEMORY_BYTES / 1e9:.0f} "
          f"GB, the card has {cap / 1e9:.2f} GB) -> {out.relative_to(ROOT)}")
    if set(refused) != set(PLAN_REFUSED) or any(
            PLAN_REFUSED[k] not in refused[k] for k in refused):
        raise AssertionError(f"plans not ok {refused}; want exactly "
                             f"{PLAN_REFUSED}")


def plan_vs_card(torch, counts, smi):
    """(b) the ERCache serve cell planned for a (1, 1) model mesh and one
    cache shard of cuda:0, then run there through ``jit_serve_step`` at
    the plan's widths."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import server as srv
    from repro_torch.core.config import HOUR_MS, MINUTE_MS, CacheConfig
    from repro_torch.core.graph import tensors_of
    from repro_torch.core.hashing import Key64
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import CacheMesh, ModelMesh
    from repro_torch.models import transformer as tfm

    dev = torch.device("cuda", 0)
    mesh = ModelMesh((1, 1), ("data", "model"), (dev,))
    cache_mesh = CacheMesh((dev,))
    cfg = get_config("tinyllama-1.1b")
    free, _ = torch.cuda.mem_get_info()
    for nb in (1 << 22, 1 << 21):
        plan = dryrun.run_ercache_cell(batch=PLAN_BATCH, n_buckets=nb,
                                       seq=PLAN_SEQ, mesh=mesh,
                                       cache_mesh=cache_mesh)
        ms = plan["memory_stats"]
        peak = (ms["argument_bytes"] + ms["output_bytes"] + ms["temp_bytes"]
                - ms["alias_bytes"])
        # the graph's private pool holds a second copy of the step's temps
        if peak + ms["temp_bytes"] <= free:
            break
        print(f"[plan ercache] 2**{nb.bit_length() - 1} buckets need "
              f"{(peak + ms['temp_bytes']) / 1e9:.2f} GB with the graph "
              f"pool, {free / 1e9:.2f} GB free: cut to half")
    else:
        raise AssertionError("the ERCache cell does not fit the card")
    bound_ms = max(plan["compute_s_term"], plan["memory_s_term"]) * 1e3
    print(f"[plan ercache] TinyLlama-1.1B, B={PLAN_BATCH}, miss budget "
          f"{PLAN_BATCH // 4}, seq {PLAN_SEQ}, 2**{nb.bit_length() - 1} x 8"
          f" x {cfg.user_embed_dim} float32 tiers: plan "
          f"{plan['hlo_flops_per_dev']:.4g} FLOPs, "
          f"{plan['hlo_bytes_per_dev']:.4g} bytes -> compute "
          f"{plan['compute_s_term'] * 1e3:.3f} ms, memory "
          f"{plan['memory_s_term'] * 1e3:.3f} ms ({plan['dominant']}-bound"
          f"), arguments {plan['argument_bytes']}, peak {peak / 1e9:.3f} GB,"
          f" traced in {plan['compile_s']}s")

    cache_cfg = CacheConfig(
        model_id=1, model_type="ctr", cache_ttl_ms=5 * MINUTE_MS,
        failover_ttl_ms=1 * HOUR_MS, n_buckets=nb, ways=8,
        value_dim=cfg.user_embed_dim, backend="cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = tfm.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                             dev)
    rng = np.random.default_rng(19)
    # the capture, the timed replays, kernel_ms's warm-up and its timed
    # and profiled replays, one step profiled by kernel group
    n_calls = 1 + PLAN_STEPS + 1 + 2 * (PLAN_STEPS // 2) + 1
    keys = [Key64.from_int(rng.integers(0, 2 ** 62, PLAN_BATCH), device=dev)
            for _ in range(n_calls)]               # all new: every row misses
    toks = [torch.as_tensor(rng.integers(0, cfg.vocab, (PLAN_BATCH,
                                                         PLAN_SEQ)),
                            dtype=torch.int32, device=dev)
            for _ in range(n_calls)]
    # the reference tower's rows now, beside the parameters only: after
    # the tables and the graph's pool the card has no room for its temps
    want = tfm.user_tower_step(params, toks[0][:PLAN_BATCH // 4], cfg,
                               backend="torch").float()
    torch.cuda.empty_cache()
    state = srv.init_server_state(cache_cfg, dtype=torch.float32,
                                  writebuf_capacity=PLAN_BATCH, device=dev,
                                  mesh=cache_mesh)
    torch.cuda.synchronize()
    real = {"params": sum(p.nbytes for p in params.parameters()),
            "state": sum(t.nbytes for t in tensors_of(state)),
            "inputs": keys[0].hi.nbytes + keys[0].lo.nbytes + toks[0].nbytes}
    print(f"[plan ercache] argument bytes plan {plan['argument_bytes']} vs "
          f"allocated {real} (allocator: "
          f"{torch.cuda.memory_allocated() - base} bytes for all "
          f"{n_calls} inputs, params, state and the tower's rows)")
    if real != plan["argument_bytes"]:
        raise AssertionError("the plan's argument bytes differ from the "
                             "card's tensors")

    server = srv.CachedEmbeddingServer(
        cfg=cache_cfg, miss_budget=PLAN_BATCH // 4, mesh=cache_mesh,
        tower_fn=lambda p, t: tfm.user_tower_step(p, t, cfg, backend="cuda",
                                                  mesh=mesh))
    jit = server.jit_serve_step
    calls = iter(range(n_calls))

    def step():
        i = next(calls)
        return jit(params, state, keys[i], toks[i], 1000 * i)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()                    # this path's window
    t0 = time.perf_counter()
    first = step()                               # eager run, then capture
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    measured_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()                     # the eager run's temps
    pool = torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
    err = close_errors(torch, first.embeddings[:PLAN_BATCH // 4], want)
    stats = {k: int(v) for k, v in first.stats.items()
             if k in ("requests", "direct_hits", "tower_inferences",
                      "fallbacks")}
    if (tuple(first.embeddings.shape) != (PLAN_BATCH, cfg.user_embed_dim)
            or not bool(torch.isfinite(first.embeddings).all())
            or stats["tower_inferences"] != PLAN_BATCH // 4
            or stats["direct_hits"] != 0 or err[1] > LM_TOL["rel_l2"]):
        raise AssertionError(f"ERCache step: {stats}, computed rows vs the "
                             f"tower {err}")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(PLAN_STEPS):
        res = step()
    end.record()
    end.synchronize()
    wall_ms = start.elapsed_time(end) / PLAN_STEPS
    busy_ms, host_ms, n_ops = kernel_ms(torch, step, reps=PLAN_STEPS // 2)
    phase_profile(torch, "profile plan ercache", 1, step)
    n = ops.launch_counts()
    if n["cache_probe_dual"] != n_calls or n["flash_attention"] != 0:
        raise AssertionError(f"ERCache launches {n}; want one dual probe a "
                             f"step over {n_calls} steps")
    counts["cache_probe_dual"] = (counts.get("cache_probe_dual", 0)
                                  + n["cache_probe_dual"])
    if int(res.stats["tower_inferences"]) != PLAN_BATCH // 4:
        raise AssertionError("a warm step ran less than the miss budget")
    print(f"[plan ercache] card ({smi}): capture {capture_s:.1f}s; warm "
          f"replays {wall_ms:.3f} ms a step (events), device kernel time "
          f"{busy_ms:.3f} ms a step ({n_ops:.0f} device ops, host wall "
          f"{host_ms:.3f} ms) vs the plan's bound {bound_ms:.3f} ms: ratio "
          f"{busy_ms / bound_ms:.3f}; peak plan {peak / 1e9:.3f} GB vs "
          f"max_memory_allocated {measured_peak / 1e9:.3f} GB (ratio "
          f"{peak / measured_peak:.3f}), the graph's pool {pool / 1e9:.3f}"
          f" GB, {free / 1e9:.2f} GB free at the start; launches {n} (the "
          f"tower's attention at seq {PLAN_SEQ} takes the naive path, "
          f"Sq*Sk <= 2**20); first step's computed rows vs the torch "
          f"tower max |err| {err[0]:.3g}, rel L2 {err[1]:.3g}")
    if busy_ms < PLAN_BOUND_SHARE * bound_ms:
        raise AssertionError(f"the card beat the plan's bound: {busy_ms:.3f}"
                             f" ms < {PLAN_BOUND_SHARE} x {bound_ms:.3f} ms")
    return nb


def ctr_card_vs_cpu(torch, smi):
    """(c) Table 4 at the example's settings on the card and on the CPU,
    in this process."""
    from repro_torch.examples import train_ctr_tower as ex

    out = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        out[device] = ex.run(**CTR, device=device)
        print(f"[table4 {device}] {time.perf_counter() - t0:.1f}s")
    for label, c in out["cuda"].items():
        h = out["cpu"][label]
        print(f"[table4] {label}: card ne_diff {c['ne_diff_pct']:+.5f}% "
              f"(ne {c['ne']:.6f}), CPU {h['ne_diff_pct']:+.5f}% "
              f"(ne {h['ne']:.6f}), paper {c['paper']:+.3f}%")
        if (abs(c["ne_diff_pct"] - h["ne_diff_pct"]) > CTR_DIFF_ATOL
                or abs(c["ne"] - h["ne"]) > CTR_NE_RTOL * h["ne"]
                or abs(c["ne_fresh"] - h["ne_fresh"])
                > CTR_NE_RTOL * h["ne_fresh"]):
            raise AssertionError(f"Table 4 {label}: card {c} vs CPU {h}")
    print(f"[table4] card and CPU agree ({smi}): each arm's NE within "
          f"{CTR_NE_RTOL} relative, each ne_diff within {CTR_DIFF_ATOL} "
          f"points; fresh NE {out['cuda'][label]['ne_fresh']:.6f}")


def phase_plan(torch, counts):
    """Phase 19: the cell planner on meta, its ERCache plan against the
    card, and Table 4 on the card against the CPU."""
    t_phase = time.perf_counter()
    smi = smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    plan_all(torch)
    nb = plan_vs_card(torch, counts, smi)
    free_card(torch)
    ctr_card_vs_cpu(torch, smi)
    print(f"[plan] phase 19 done in {time.perf_counter() - t_phase:.1f}s "
          f"(ERCache tiers 2**{nb.bit_length() - 1} buckets)")


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
    phase_towers(torch)
    print(f"[time] towers and combiner phase done at "
          f"{time.perf_counter() - t0:.1f}s")
    phase_chaos(torch)
    print(f"[time] chaos phase done at {time.perf_counter() - t0:.1f}s")
    phase_regions(torch)
    print(f"[time] regions phase done at {time.perf_counter() - t0:.1f}s")
    phase_restart(torch)
    print(f"[time] restart phase done at {time.perf_counter() - t0:.1f}s")
    phase_train(torch)
    print(f"[time] train phase done at {time.perf_counter() - t0:.1f}s")
    phase_shards(torch, counts)
    print(f"[time] shards phase done at {time.perf_counter() - t0:.1f}s")
    free_card(torch)
    phase_mesh(torch, counts)
    print(f"[time] mesh phase done at {time.perf_counter() - t0:.1f}s")
    free_card(torch)
    phase_plan(torch, counts)
    print(f"[time] plan phase done at {time.perf_counter() - t0:.1f}s")

    kernels = []
    for name in sorted(counts):
        r = dict(results[name])
        r["launches"] = counts[name]
        kernels.append({k: r[k] for k in (
            "name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")})
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
