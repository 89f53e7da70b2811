"""Warm restarts for the serving tier: snapshot/restore of the cache state.

Twin of ``repro/ft/snapshot.py``, in the same format: a snapshot written by
either package restores in the other. The cache's value is its contents: a
deploy or crash that cold-starts the table burns exactly the tower FLOPs
the cache exists to save (paper §3.6–3.7).

* :func:`snapshot_server` drains the write/touch rings into the tables
  (the server's eager ``flush``, which works IN PLACE and returns the same
  state, so graphs captured on it stay valid) and writes ``{direct,
  failover, budget}`` (plus ``home`` for a regional server) through
  ``ft/checkpoint``'s atomic save, with a self-describing metadata record
  (schema, geometry, counters, clock).
* :func:`restore_server` rebuilds a server state from the latest committed
  snapshot, in NEW tensors on the target device (a compiled entry point
  keys its graphs on tensor addresses, so the restored state captures its
  own graphs). Three outcomes, in order of preference:

  - **bitexact**: the snapshot geometry matches the target server's; the
    arrays load straight in.
  - **rehash**: the geometry differs (grown/shrunk ``n_buckets`` or
    ``ways``, single <-> M=1 multi): live unexpired entries are
    re-bucketed through the elastic rehash (``ft/elastic.py``) on the
    device, with write timestamps and recency preserved.
  - **cold**: a missing, foreign, torn, corrupt or incompatible snapshot:
    log and return a cold state. Reading a snapshot is fail-open and never
    raises into the serve path. The cold state is allocated first, outside
    that boundary, and the device work (the load onto the device, the
    rehash and its kernels) runs after it: a missing card or a kernel that
    fails to build or launch raises.

* Counters provenance: the snapshot carries the accumulated
  :class:`ServingCounters`; the restore hands them back so the ledger
  resumes additively across the kill/restore boundary.

* Placement: a bucket-sharded server (``server.mesh`` set) snapshots its
  GLOBAL planes (``server.cache_image`` gathers the shards), so its
  manifest and bytes equal the unsharded server's; a restore targets the
  server's placement as well as its geometry, building the state on the
  mesh's first device and splitting it over the mesh at the end, on all
  three outcomes. A snapshot taken on N shards restores onto M.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Optional

import torch

from repro_torch.core import cache as cache_lib
from repro_torch.core import regional as regional_lib
from repro_torch.core import server as server_lib
from repro_torch.core.metrics import ServingCounters
from repro_torch.core.ratelimit import InferBudget
from repro_torch.distributed import sharding as shard_lib
from repro_torch.ft import checkpoint as ckpt
from repro_torch.ft import elastic

log = logging.getLogger(__name__)

SCHEMA = "ercache-snapshot/1"


def _np_dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype (``torch.float32`` -> ``"float32"``),
    as the reference's metadata records it."""
    return str(dtype).removeprefix("torch.")


def _shape_meta(server, state) -> Dict[str, Any]:
    """The snapshot's geometry fingerprint. Restore compares the stored
    fingerprint against the target's: equality means a bit-exact load,
    anything else an elastic rehash. Per-model bucket counts come from the
    CONFIGS (the capacity masks), not the stack allocation."""
    if isinstance(state, regional_lib.RegionalState):
        # the inner stacked tier's fingerprint plus the regional axes; a
        # changed region count (or home-table size) restores cold
        shapes = _shape_meta(server.inner, state.inner)
        shapes["n_regions"] = int(server.n_regions)
        shapes["n_users"] = int(state.home.shape[0])
        return shapes
    if isinstance(state, server_lib.MultiServerState):
        cfgs = list(server.cfgs)
        return {
            "n_models": len(cfgs),
            "direct_nb": [c.n_buckets for c in cfgs],
            "direct_ways": int(state.direct.ways),
            "failover_nb": [c.resolved_failover_n_buckets() for c in cfgs],
            "failover_ways": int(state.failover.ways),
        }
    cfg = server.cfg
    return {
        "direct_nb": int(cfg.n_buckets),
        "direct_ways": int(state.direct.ways),
        "failover_nb": int(cfg.resolved_failover_n_buckets()),
        "failover_ways": int(state.failover.ways),
    }


def snapshot_server(directory: str, step: int, server, state, now_ms: int,
                    counters: Optional[ServingCounters] = None,
                    retain_last_k: Optional[int] = None):
    """Drain the rings and write one atomic snapshot; returns the drained
    state, whose tensors are the ones passed in (the flush works in
    place)."""
    state = server.flush(state, now_ms)
    if isinstance(state, regional_lib.RegionalState):
        kind, image = "regional", regional_lib.cache_image(state)
    elif isinstance(state, server_lib.MultiServerState):
        kind, image = "multi", server_lib.cache_image(state)
    else:
        kind, image = "single", server_lib.cache_image(state)
    meta = {
        "schema": SCHEMA,
        "kind": kind,
        "now_ms": int(now_ms),
        "value_dim": int(image["direct"].dim),
        "dtype": _np_dtype_name(image["direct"].values.dtype),
        "shapes": _shape_meta(server, state),
        "counters": None if counters is None else counters.as_dict(),
    }
    ckpt.save(directory, step, image, meta=meta,
              retain_last_k=retain_last_k)
    return state


@dataclasses.dataclass
class RestoreResult:
    """What :func:`restore_server` hands the serving tier."""

    state: Any                    # ServerState | MultiServerState | Regional
    counters: ServingCounters     # resumed ledger (fresh on cold)
    mode: str                     # "bitexact" | "rehash" | "cold"
    step: Optional[int]           # snapshot step restored from (None: cold)
    detail: str = ""


def _as_stack(single: cache_lib.CacheState) -> cache_lib.MultiCacheState:
    """A single table viewed as an M=1 stacked tier (single <-> multi
    conversion on restore)."""
    return cache_lib.MultiCacheState(*(t[None] for t in single))


class _Cold(Exception):
    """A snapshot the target cannot restore from (restores cold)."""


def _read_image(directory: str, step: int, server, cold, regional: bool,
                multi: bool, dtype):
    """Read and check snapshot ``step`` against the target: the image on
    the host at its ORIGINAL geometry (shape-checked against the metadata,
    so a manifest/meta mismatch raises), its kind and geometry, and the
    counters. Raises :class:`_Cold` for a snapshot the target cannot
    take."""
    cold_tier = cold.inner if regional else cold
    meta = ckpt.read_meta(directory, step)
    if not meta or meta.get("schema") != SCHEMA:
        raise _Cold(f"step {step}: not an ercache snapshot "
                    f"(schema={None if not meta else meta.get('schema')!r})")
    if int(meta.get("value_dim", -1)) != int(cold_tier.direct.dim):
        raise _Cold(f"step {step}: value_dim {meta.get('value_dim')} != "
                    f"target {cold_tier.direct.dim}")
    kind = meta.get("kind")
    shapes = meta["shapes"]
    dim = int(meta["value_dim"])
    # the original geometry as meta tensors (shapes and dtypes, no
    # storage): ckpt.restore checks the manifest against them
    like = dict(device="meta", dtype=dtype)

    # Regional snapshots restore BIT-EXACT or not at all: the home plane
    # has no meaningful rehash across a changed region count, so any
    # fingerprint drift (and a kind mismatch either way) restores cold.
    if regional or kind == "regional":
        if not regional:
            raise _Cold(f"step {step}: regional snapshot into a "
                        "non-regional server")
        if kind != "regional":
            raise _Cold(f"step {step}: {kind!r} snapshot into a regional "
                        "server")
        if shapes != _shape_meta(server, cold):
            raise _Cold(
                f"step {step}: regional geometry changed (snapshot "
                f"{shapes.get('n_regions')} regions x "
                f"{shapes.get('n_models')} slots, {shapes.get('n_users')} "
                f"users; target {server.n_regions} regions x "
                f"{server.inner.n_models} slots, {server.n_users} users) — "
                "regional restore is bit-exact only")
        n_old = int(shapes["n_models"])
        extra = {"home": torch.empty((int(shapes["n_users"]),),
                                     dtype=torch.int32, device="meta")}
    elif kind in ("multi", "single"):
        n_old = int(shapes["n_models"]) if kind == "multi" else 1
        extra = {}
    else:
        raise _Cold(f"step {step}: unknown kind {kind!r}")
    init = (cache_lib.init_multi_cache if kind != "single"
            else cache_lib.init_cache)
    image = ckpt.restore(directory, step, dict(
        extra,
        direct=init(shapes["direct_nb"], shapes["direct_ways"], dim, **like),
        failover=init(shapes["failover_nb"], shapes["failover_ways"], dim,
                      **like),
        budget=InferBudget(tokens=torch.empty((n_old,), dtype=torch.float32,
                                              device="meta"))),
        device="cpu")
    counters = (ServingCounters.from_dict(meta["counters"])
                if meta.get("counters") else ServingCounters())
    if regional:
        return kind, shapes, image, counters
    # the model-count checks of a resized restore
    same = (kind == "multi") == multi and shapes == _shape_meta(server, cold)
    if not same and multi and kind == "single" and server.n_models != 1:
        raise _Cold(f"step {step}: single-model snapshot into a "
                    f"{server.n_models}-model tier")
    if not same and multi and kind == "multi" and n_old != server.n_models:
        raise _Cold(f"step {step}: snapshot has {n_old} models, target has "
                    f"{server.n_models}")
    if not same and not multi and kind == "multi" and n_old != 1:
        raise _Cold(f"step {step}: {n_old}-model snapshot into a "
                    "single-model server")
    return kind, shapes, image, counters


def restore_server(directory: str, server, now_ms: int,
                   dtype=torch.float32, writebuf_capacity: int = 4096,
                   touchbuf_capacity: Optional[int] = None,
                   step: Optional[int] = None,
                   device="cuda") -> RestoreResult:
    """Rebuild a server state from the latest committed snapshot in
    ``directory`` (or ``step``), targeting ``server``'s CURRENT geometry,
    in new tensors on ``device`` (a ``RegionalServer`` uses its own
    ``device``). A snapshot that cannot be read or does not fit restores
    cold (logged, never raised); ``now_ms`` is the stream clock used to
    drop already-expired entries during a rehash, whose recency lookups run
    the target's backend. A sharded server's state is built on its mesh's
    first device (``device`` must agree with it in kind) and split over
    the mesh."""
    regional = isinstance(server, regional_lib.RegionalServer)
    multi = isinstance(server, server_lib.MultiModelServer)
    mesh = getattr(server, "mesh", None)
    if mesh is not None:
        device = shard_lib.mesh_device(device, mesh)
    if regional:
        cold = server.init_state(dtype, writebuf_capacity,
                                 touchbuf_capacity)
    elif multi:
        cold = server_lib.init_multi_server_state(
            server.cfgs, dtype, writebuf_capacity, touchbuf_capacity,
            device=device)
    else:
        cold = server_lib.init_server_state(
            server.cfg, dtype, writebuf_capacity, touchbuf_capacity,
            device=device)
    device = cold.home.device if regional else cold.direct.key_hi.device

    def place(st):
        """The server's placement: split over its mesh, if it has one."""
        return st if mesh is None else shard_lib.place_server_state(st, mesh)

    def cold_result(detail: str, at: Optional[int] = None) -> RestoreResult:
        log.warning("cache restore fell back to cold init: %s", detail)
        return RestoreResult(state=place(cold), counters=ServingCounters(),
                             mode="cold", step=at, detail=detail)

    try:
        if step is None:
            step = ckpt.latest_step(directory)
        if step is None:
            return cold_result(f"no committed checkpoint in {directory!r}")
        kind, shapes, image, counters = _read_image(
            directory, step, server, cold, regional, multi, dtype)
    except _Cold as e:
        return cold_result(str(e), step)
    except Exception as e:                       # noqa: BLE001 — fail-open
        return cold_result(f"step {step}: {type(e).__name__}: {e}", step)

    # -- past the fail-open boundary: device work, whose failures raise
    image = {k: ckpt._map_leaves(lambda _, t: t.to(device), v)
             for k, v in image.items()}
    if regional:
        return RestoreResult(
            state=regional_lib.with_cache_image(cold, image),
            counters=counters, mode="bitexact", step=step,
            detail=f"loaded step {step} in place")

    # carry the admission tokens whenever the registry width agrees; the
    # first refill clamps any excess to the burst
    budget = cold.budget
    if image["budget"].tokens.shape == cold.budget.tokens.shape:
        budget = image["budget"]
    if (kind == "multi") == multi and shapes == _shape_meta(server, cold):
        state = place(server_lib.with_cache_image(cold, dict(image,
                                                             budget=budget)))
        return RestoreResult(state=state, counters=counters,
                             mode="bitexact", step=step,
                             detail=f"loaded step {step} in place")

    # geometry changed: elastic rehash of live unexpired entries
    if multi:
        if kind == "single":
            old_dm, old_fm = _as_stack(image["direct"]), \
                _as_stack(image["failover"])
            nb_d, nb_f = [shapes["direct_nb"]], [shapes["failover_nb"]]
        else:
            old_dm, old_fm = image["direct"], image["failover"]
            nb_d, nb_f = shapes["direct_nb"], shapes["failover_nb"]
        cfgs = list(server.cfgs)
        lru = [c.eviction == "lru" for c in cfgs]
        new_d, cnt_d = elastic.rehash_multi_cache(
            old_dm, nb_d, cold.direct, [c.n_buckets for c in cfgs], now_ms,
            [c.cache_ttl_ms for c in cfgs], evict_lru=lru,
            backend=server.backend)
        new_f, cnt_f = elastic.rehash_multi_cache(
            old_fm, nb_f, cold.failover,
            [c.resolved_failover_n_buckets() for c in cfgs], now_ms,
            [c.resolved_failover_relax_ttl_ms() for c in cfgs],
            evict_lru=lru, backend=server.backend)
        n_dir, n_fo = sum(cnt_d), sum(cnt_f)
    else:
        if kind == "multi":
            old_d1 = image["direct"].model_view(
                0, int(shapes["direct_nb"][0]))
            old_f1 = image["failover"].model_view(
                0, int(shapes["failover_nb"][0]))
        else:
            old_d1, old_f1 = image["direct"], image["failover"]
        cfg = server.cfg
        lru1 = cfg.eviction == "lru"
        new_d, n_dir = elastic.rehash_cache(
            old_d1, cold.direct, now_ms, cfg.cache_ttl_ms, evict_lru=lru1,
            backend=cfg.backend)
        new_f, n_fo = elastic.rehash_cache(
            old_f1, cold.failover, now_ms,
            cfg.resolved_failover_relax_ttl_ms(), evict_lru=lru1,
            backend=cfg.backend)
    state = place(cold._replace(direct=new_d, failover=new_f,
                                budget=budget))
    detail = (f"rehashed step {step}: {n_dir} direct + {n_fo} failover "
              "live entries into new geometry")
    log.info("cache restore: %s", detail)
    return RestoreResult(state=state, counters=counters, mode="rehash",
                         step=step, detail=detail)
