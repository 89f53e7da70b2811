"""Plan-only dry-run of every (arch x shape x mesh) cell, on the ``meta``
device: it needs no card and allocates nothing.

Twin of ``repro/launch/dryrun.py``, which lowers and compiles each cell
on the 256- or 512-chip production mesh and reads one device's SPMD
module. Here each cell (``launch/specs.py``) is checked spec by spec
against its shapes (a spec that does not divide its dimension fails the
cell, as a sharding mismatch fails the reference's compile; so does a
``shard_map`` of the port's that cannot split its batch) and its step is
traced once on meta tensors under ``launch/layout.py``'s
``LayoutCounter``. It lays every argument out by the cell's specs,
propagates the layouts through each aten op, and counts one device's
share: its FLOPs (XLA's count: products, and one an element-wise output
or reduced input element), its bytes (each op unfused; views move
nothing; index ops move the rows they read or write, not the whole
table), the peak of the live storages the trace creates, and the
collectives the layouts ask for. Those are the reference's derived ones
(a partial sum resolved at a sharding constraint, in its backward, and
again in a checkpointed layer's recompute; the gradients reduced to
their parameters' layouts; the gathers a conflicting layout needs, those
GSPMD calls involuntary counted apart) beside the port's explicit
cross-shard combines (``collectives.record``: the sequence-sharded
decode's merge, the sharded top-k's gathers, the sharded probe's
combine, the row-sharded bag's sum), each through the reference's wire
model (``_wire_factor``). Arguments the step never reads are left out of
the argument bytes, as the reference's ``jit`` prunes them. A cell whose
per-device estimate exceeds one card's memory fails, as the reference's
compile-time OOM does. The roofline terms use the H100's constants
(``launch/mesh.py``):

    compute    = FLOPs a device / peak
    memory     = bytes a device / HBM rate
    collective = collective bytes a device / link rate

Where the counts differ from the reference's by design: XLA counts the
body of the reference's KV-chunk attention scan once, the port all of
it; XLA fuses element-wise chains and reads a gather's whole table; the
reference's decode takes the KV cache through its layer scan where the
port writes it in place. ``scripts/plan_parity.py`` tabulates both. The
reference's HLO-text parser and its ``XLA_FLAGS`` device-count re-exec
have no counterpart.

Usage::

    python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--both-meshes] [--out f.json]
    python -m repro_torch.launch.dryrun --ercache
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.configs import all_cells, get_config, shapes_for
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import Spec
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.layout import LayoutCounter, _key, _tensors
from repro_torch.launch.mesh import (HBM_BW, ICI_BW, PEAK_FLOPS_BF16,
                                     CacheMesh, ModelMesh,
                                     make_production_mesh)

DEFAULT_OUT = "experiments/dryrun_results_torch.json"
CARD_MEMORY_BYTES = 80e9            # one H100 80GB, where no card is present

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def _wire_factor(kind: str, n: int) -> float:
    """Per-device WIRE bytes per operand byte (bidirectional-ring model):
    all-gather sends its shard n-1 times; all-reduce = reduce-scatter +
    all-gather ~ 2(n-1)/n of the full operand; rs/a2a move (n-1)/n;
    collective-permute forwards once."""
    if n <= 1:
        return 0.0
    return {
        "all-gather": float(n - 1),
        "all-reduce": 2.0 * (n - 1) / n,
        "reduce-scatter": (n - 1) / n,
        "all-to-all": (n - 1) / n,
        "collective-permute": 1.0,
    }[kind]


def card_memory_bytes() -> float:
    """One card's memory: the present card's, else ``CARD_MEMORY_BYTES``."""
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return CARD_MEMORY_BYTES


# ------------------------------------------------------------ the counter
def _pairs(args, specs):
    """(tensor, spec) for every tensor leaf of ``args`` under the spec
    tree ``specs`` (a Spec over a subtree applies to each of its
    tensors)."""
    if isinstance(specs, Spec):
        return [(t, specs) for t in _tensors(args)]
    if isinstance(args, dict):
        return [p for k in args for p in _pairs(args[k], specs[k])]
    if isinstance(args, (list, tuple)):
        return [p for a, s in zip(args, specs) for p in _pairs(a, s)]
    return []


def _local_bytes(t: torch.Tensor, spec, mesh) -> int:
    """Bytes of one device's shard of ``t`` laid out by ``spec``."""
    return math.prod(specs_lib.local_shape(t.shape, spec, mesh)) \
        * t.element_size()


def argument_bytes(args, specs, mesh, unused=()) -> int:
    """Per-device argument bytes: every leaf at its local shard shape
    (raises where a spec does not divide its dimension), but the leaves
    (by position) in ``unused``, which the compiled step never reads and
    the reference's ``jit`` prunes."""
    return sum(_local_bytes(t, spec, mesh)
               for i, (t, spec) in enumerate(_pairs(args, specs))
               if i not in set(unused))


def trace(fn, args, specs=None, mesh_shape=None, tally=False) -> Dict:
    """Trace ``fn(*args)`` once under a :class:`LayoutCounter` whose
    arguments are laid out by the spec tree ``specs`` over a mesh of
    ``mesh_shape`` (axis -> size; none: every argument replicated): one
    device's FLOPs, bytes, collective traffic and peak of new storages,
    the outputs' bytes and those aliasing an argument, the involuntary
    gathers, and the seconds the trace took. Partial sums left in the
    outputs are all-reduced, as the reference's replicated outputs. With
    ``tally``, ``counter`` is the counter, holding its diagnosis view."""
    placed = _pairs(args, specs) if specs is not None else []
    arg_keys = {_key(t) for t in _tensors(args)}
    t0 = time.perf_counter()
    counter = LayoutCounter(mesh_shape or {}, placed, tally)
    coll.TRACER = counter
    try:
        with counter, counter.layer_slices():
            out = fn(*args)
            outs = _tensors(out)
            counter.op = "output"
            for t in outs:
                counter.set_layout(t, counter.resolve(
                    t, counter.layout(t)._replace(partial=frozenset())))
    finally:
        coll.TRACER = None
        counter.remove_hooks()
    traffic = counter.traffic
    sizes = {}
    for t in outs:
        sizes.setdefault(_key(t), t.untyped_storage().nbytes()
                         / counter.split(counter.layout(t)))
    res = {"flops": counter.flops, "bytes": counter.bytes,
           "peak": counter.peak, "output_bytes": sum(sizes.values()),
           "alias_bytes": sum(n for k, n in sizes.items() if k in arg_keys),
           "involuntary": counter.involuntary, "traffic": list(traffic),
           "unused": [i for i, (t, _) in enumerate(placed)
                      if _key(t) not in counter.read],
           "seconds": time.perf_counter() - t0}
    if tally:
        res["counter"] = counter
    res["coll"] = 0.0
    for k in _COLLECTIVES:
        res[f"coll_{k}"] = 0.0
        res[f"count_{k}"] = 0
    for kind, operand, n in traffic:
        wire = operand * _wire_factor(kind, n)
        res[f"coll_{kind}"] += wire
        res[f"count_{kind}"] += 1
        res["coll"] += wire
    return res


# --------------------------------------------------------------- the cells
def _on_meta(mesh) -> ModelMesh:
    return ModelMesh(mesh.dims, mesh.axis_names, ("meta",) * mesh.size)


def _production_mesh(multi_pod: bool) -> ModelMesh:
    n = 512 if multi_pod else 256
    return make_production_mesh(multi_pod=multi_pod, devices=["meta"] * n)


def _trace_cell(cell, mesh) -> Dict:
    return trace(cell.fn, cell.args, cell.in_specs, mesh.shape)


def _combine(terms, coeffs) -> Dict[str, float]:
    """Linear combination of measurement dicts; clamps at >= 0."""
    keys = terms[0].keys()
    return {k: max(sum(c * t[k] for c, t in zip(coeffs, terms)), 0.0)
            for k in keys}


_ACCT_KEYS = ("flops", "bytes", "coll", "involuntary") + tuple(
    f"{p}_{k}" for p in ("coll", "count") for k in _COLLECTIVES)
_MEM_KEYS = ("peak", "output_bytes", "alias_bytes")


def lm_accounting(arch: str, shape_name: str, mesh,
                  overrides: Optional[dict] = None) -> Dict[str, float]:
    """The reference's roofline accounting for LM cells: trace small
    variants and solve the linear model

        cost(L, M) = opt_base + L opt_layer + M (tok_base + L tok_layer)

    from 4 points (L in {1,2} x M in {1,2}) for train, 2 points (L in
    {1,2}) for prefill/decode, then evaluate at the real (L, M) (an
    ``n_layers`` override counts as the real L). The reference needs it
    because XLA counts a scan's body once; the port's layers and
    microbatches are Python loops, so the solve reproduces the direct
    trace where the cost is affine, in a fraction of its time: FLOPs,
    collectives, involuntary gathers and bytes, except that from M = 2 on
    the step divides the summed gradients once (its bytes and FLOPs),
    which the solve counts M - 1 times. The traced peak, outputs and
    aliases are affine in L at a fixed microbatch (from M = 2 on a train
    step's peak holds the summed gradients beside one microbatch's and no
    longer grows with M): they come from the two points at min(M, 2)
    microbatches. Also returns ``seconds``, the variants' trace time, and
    ``unused``, the argument leaves the step never reads."""
    overrides = dict(overrides or {})
    cfg = get_config(arch)
    L = overrides.get("n_layers", cfg.n_layers)
    shape = shapes_for(cfg)[shape_name]
    seconds = []

    def meas(n_layers, micro=None, batch=None):
        ov = dict(overrides)
        ov.update(n_layers=n_layers, unroll_scans=True)
        if micro is not None:
            ov["microbatches"] = micro
        if batch is not None:
            ov["global_batch"] = batch
        cell = specs_lib.build_cell(arch, shape_name, mesh, ov)
        res = _trace_cell(cell, mesh)
        seconds.append(res["seconds"])
        return res

    def pick(keys, *pts):
        return [{k: p[k] for k in keys} for p in pts]

    if shape.kind == "train":
        M = overrides.get("microbatches", specs_lib.TRAIN_MICRO[arch])
        B = overrides.get("global_batch", shape.global_batch)
        bm = B // M
        pts = (meas(1, 1, bm), meas(2, 1, bm), meas(1, 2, 2 * bm),
               meas(2, 2, 2 * bm))
        A, Bv, C, D = pick(_ACCT_KEYS, *pts)
        l_t = _combine([D, C, Bv, A], [1, -1, -1, 1])
        tok = _combine([C, A, l_t], [1, -1, -1])
        l_o = _combine([Bv, A, l_t], [1, -1, -1])
        o1 = _combine([A, l_o, tok, l_t], [1, -1, -1, -1])
        out = _combine([o1, l_o, tok, l_t], [1, L, M, M * L])
        one, two = pick(_MEM_KEYS, *(pts[2:] if M >= 2 else pts[:2]))
    else:
        pts = (meas(1), meas(2))
        A, Bv = pick(_ACCT_KEYS, *pts)
        out = _combine([A, _combine([Bv, A], [1, -1])], [1, L - 1])
        one, two = pick(_MEM_KEYS, *pts)
    out.update(_combine([one, _combine([two, one], [1, -1])], [1, L - 1]))
    out["seconds"] = sum(seconds)
    out["unused"] = pts[0]["unused"]
    return out


def _mesh_label(mesh) -> str:
    return ("x".join(str(d) for d in mesh.dims)
            + f" ({','.join(mesh.axis_names)})")


def _result(arch, shape_name, mesh_label, n_chips, meas, arg_bytes,
            model_flops, note) -> Dict:
    """The reference's result keys from one cell's per-device
    measurements, and the count of involuntary gathers."""
    flops = meas["flops"]
    bytes_accessed = meas["bytes"]
    coll_total = meas["coll"]
    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = bytes_accessed / HBM_BW
    collective_s = coll_total / ICI_BW
    dominant = max(
        (("compute", compute_s), ("memory", memory_s),
         ("collective", collective_s)), key=lambda kv: kv[1])[0]
    out_b = meas["output_bytes"]
    alias_b = meas["alias_bytes"]
    # the traced peak holds the new outputs too: temp is the rest of it,
    # so arguments + outputs + temp - aliases = arguments + peak
    temp_b = max(meas["peak"] - (out_b - alias_b), 0.0)
    peak_b = arg_bytes + out_b + temp_b - alias_b
    cap = card_memory_bytes()
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_label,
        "n_chips": n_chips,
        "compile_s": round(meas["seconds"], 1),
        "hlo_flops_per_dev": flops,
        "hlo_bytes_per_dev": bytes_accessed,
        "collective_bytes_per_dev": coll_total,
        "collective_breakdown": {k: meas[f"coll_{k}"] for k in _COLLECTIVES},
        "collective_counts": {k: meas[f"count_{k}"] for k in _COLLECTIVES},
        "compute_s_term": compute_s,
        "memory_s_term": memory_s,
        "collective_s_term": collective_s,
        "dominant": dominant,
        "model_flops_total": model_flops,
        "useful_flops_ratio": (model_flops / n_chips / flops
                               if flops else 0.0),
        "involuntary_gathers": int(meas["involuntary"]),
        "memory_stats": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_b,
            "temp_bytes": temp_b,
            "alias_bytes": alias_b,
            "peak_estimate_gb": round(peak_b / 2**30, 3),
        },
        "note": note,
        "ok": peak_b <= cap,
    }
    if not result["ok"]:
        result["error"] = (f"per-device estimate {peak_b / 1e9:.2f} GB "
                           f"exceeds one card's {cap / 1e9:.2f} GB")
    return result


def _print(tag, result) -> None:
    print(f"[{tag} x {result['mesh']}] trace {result['compile_s']}s  "
          f"compute {result['compute_s_term']*1e3:.2f}ms  "
          f"memory {result['memory_s_term']*1e3:.2f}ms  "
          f"collective {result['collective_s_term']*1e3:.2f}ms  "
          f"-> {result['dominant']}-bound  useful "
          f"{100*result['useful_flops_ratio']:.0f}%  mem "
          f"{result['memory_stats']['peak_estimate_gb']}GB/dev  "
          f"{'ok' if result['ok'] else 'FAILED: ' + result['error']}")


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             verbose: bool = True, overrides: Optional[dict] = None,
             accounting: Optional[bool] = None) -> Dict:
    """Plan one cell on the production mesh of meta devices. A spec that
    does not divide its dimension gives ``ok: false`` with the reason; so
    does a per-device estimate above one card's memory."""
    mesh = _production_mesh(multi_pod)
    n_chips = mesh.size
    cell = specs_lib.build_cell(arch, shape_name, mesh, overrides)
    # LM cells on the single pod (the reference's default): the variants'
    # linear decomposition stands for the direct trace, which it equals
    if accounting is None:
        accounting = get_config(arch).family == "lm" and not multi_pod
    try:
        argument_bytes(cell.args, cell.in_specs, mesh)
        if accounting:
            meas = lm_accounting(arch, shape_name, mesh, overrides)
        else:
            meas = _trace_cell(cell, mesh)
        arg_bytes = argument_bytes(cell.args, cell.in_specs, mesh,
                                   meas["unused"])
    except ValueError as e:     # a spec or a shard_map that cannot divide
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "mesh": _mesh_label(mesh), "ok": False,
                "error": f"sharding mismatch: {e}"}
    result = _result(arch, shape_name, _mesh_label(mesh), n_chips, meas,
                     arg_bytes, cell.model_flops, cell.note)
    if verbose:
        _print(f"{arch} x {shape_name}", result)
    return result


def run_ercache_cell(arch: str = "tinyllama-1.1b", batch: int = 4096,
                     multi_pod: bool = False, verbose: bool = True, *,
                     n_buckets: int = 1 << 22, seq: int = 64,
                     mesh=None, cache_mesh=None) -> Dict:
    """BEYOND the 40 cells: the paper's own technique at scale. Plans
    ``CachedEmbeddingServer.serve_step``: the dual probe of the
    bucket-sharded tier, the miss-budget-compacted tower (the full LM
    config, ``user_tower_step``, ``miss_budget = batch // 4``, a
    ``seq``-token history) with the failover and fallback, and the
    write-ring append. The reference's tier: 5 min / 1 h TTLs,
    ``n_buckets`` x 8 ways x ``user_embed_dim`` float32 per table.

    ``mesh`` (a ModelMesh) and ``cache_mesh`` (a CacheMesh) give the
    layout: by default the production mesh and a cache mesh of as many
    shards; any devices they name are replaced by meta ones. Returns the
    reference's keys plus ``argument_bytes`` split into ``params`` and
    ``state``."""
    from repro_torch.core import server as srv_lib
    from repro_torch.core.config import CacheConfig, HOUR_MS, MINUTE_MS
    from repro_torch.core.hashing import Key64
    from repro_torch.models import transformer as tfm

    mesh = _production_mesh(multi_pod) if mesh is None else _on_meta(mesh)
    n_shards = mesh.size if cache_mesh is None else cache_mesh.n_shards
    cache_mesh = CacheMesh(("meta",) * n_shards)
    cfg = get_config(arch)
    cache_cfg = CacheConfig(
        model_id=1, model_type="ctr",
        cache_ttl_ms=5 * MINUTE_MS, failover_ttl_ms=1 * HOUR_MS,
        n_buckets=n_buckets, ways=8, value_dim=cfg.user_embed_dim,
        backend="torch")
    skeleton = tfm.LMTower(cfg, device="meta")

    def tower_fn(params, tokens):
        return tfm.user_tower_step(tfm.bind_tree(skeleton, params), tokens,
                                   cfg, backend="torch", mesh=mesh)

    server = srv_lib.CachedEmbeddingServer(
        cfg=cache_cfg, tower_fn=tower_fn, miss_budget=batch // 4,
        mesh=cache_mesh)
    params_abs = tfm.abstract_params(cfg)
    param_specs = specs_lib._tree_specs(tfm.param_logical_axes(cfg),
                                        params_abs, "lm", mesh)
    state_abs = srv_lib.init_server_state(
        cache_cfg, dtype=torch.float32, writebuf_capacity=batch,
        device="meta", mesh=cache_mesh)
    # the argument bytes of the state: its unsharded twin under the tier's
    # specs (each shard holds 1/N of every table, the rings whole)
    flat_state = srv_lib.init_server_state(
        cache_cfg, dtype=torch.float32, writebuf_capacity=batch,
        device="meta")
    bspec = specs_lib._batch_spec(mesh)
    keys_abs = Key64(hi=specs_lib._sds((batch,), torch.int32),
                     lo=specs_lib._sds((batch,), torch.int32))
    toks_abs = specs_lib._sds((batch, seq), torch.int32)
    param_bytes = argument_bytes(params_abs, param_specs, mesh)
    state_bytes = argument_bytes(
        flat_state, specs_lib.cache_tier_specs(flat_state), cache_mesh)
    io_bytes = argument_bytes((keys_abs, toks_abs),
                              (Key64(hi=Spec(bspec), lo=Spec(bspec)),
                               Spec(bspec, None)), mesh)

    def fn(params, state, keys, tokens):
        res = server.serve_step(params, state, keys, tokens, 0)
        return res.embeddings, res.source, res.stats, res.state

    # each table slab is one cache shard's local share: replicated
    meas = trace(fn, (params_abs, state_abs, keys_abs, toks_abs),
                 (param_specs, Spec(),
                  Key64(hi=Spec(bspec), lo=Spec(bspec)), Spec(bspec, None)),
                 mesh.shape)
    # useful work: the tower over the miss budget's rows
    useful = specs_lib._lm_flops(cfg, batch // 4 * seq, False, seq // 2)
    result = _result(f"ercache-serve[{arch}]", f"batch{batch}",
                     _mesh_label(mesh) + f" + {n_shards} cache shards",
                     mesh.size, meas, param_bytes + state_bytes + io_bytes,
                     useful, f"n_buckets={n_buckets} seq={seq}")
    result["argument_bytes"] = {"params": param_bytes, "state": state_bytes,
                                "inputs": io_bytes}
    if verbose:
        _print(f"ERCACHE serve x {arch}", result)
    return result


def _load(path: str) -> dict:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--ercache", action="store_true",
                    help="plan the ERCache serve_step cell instead")
    args = ap.parse_args(argv)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = _load(args.out)

    if args.ercache:
        for mp in meshes:
            key = f"ercache|{args.arch or 'tinyllama-1.1b'}|" + \
                ("multipod" if mp else "singlepod")
            results[key] = run_ercache_cell(
                args.arch or "tinyllama-1.1b", multi_pod=mp)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
        return results

    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    cells = all_cells() if args.all else [(args.arch, args.shape)]
    for arch, shape in cells:
        for mp in meshes:
            key = f"{arch}|{shape}|{'multipod' if mp else 'singlepod'}"
            if results.get(key, {}).get("ok"):
                print(f"[skip] {key} (cached)")
                continue
            try:
                results[key] = run_cell(arch, shape, multi_pod=mp)
            except Exception as e:
                traceback.print_exc()
                results[key] = {"arch": arch, "shape": shape,
                                "multi_pod": mp, "ok": False,
                                "error": f"{type(e).__name__}: {e}"}
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results.values() if r.get("ok"))
    print(f"\n{n_ok}/{len(results)} cells OK -> {args.out}")
    return results


if __name__ == "__main__":
    main()
