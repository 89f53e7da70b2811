"""Fused ERCache bucket probes: the cache read as hand-written CUDA kernels.

Twin of ``repro/kernels/cache_probe.py``. One source,
``csrc/cache_probe.cu``, with four entries:

* :func:`cache_probe_tiled` (alias :func:`cache_probe`) probes one table;
* :func:`cache_probe_dual` probes the direct AND failover tables for the
  same queries in ONE launch; the single-model ``serve_step`` makes
  exactly one per step;
* :func:`cache_probe_dual_multi` is the dual probe of a stacked
  multi-model tier, each query at its own model's TTLs; the multi-model
  ``serve_step`` makes exactly one per step;
* :func:`cache_probe_perquery` is the reference's one-query-per-grid-step
  probe, the dispatch baseline of the probe shootout: (hit, value, age),
  no way, and the value as the reference's masked sum (the winning row +
  0.0, so a stored -0.0 comes back +0.0).

All four run one kernel body: a warp per query, eight queries a CTA,
three dependent HBM round trips, rows copied in the widest aligned unit.

All follow ``ref.cache_probe_ref`` (the per-query probe
``ref.cache_probe_perquery_ref``) bit for bit. On a CPU tensor a wrapper
runs that plain version; on a CUDA tensor it launches the kernel (and
counts the launch in :data:`LAUNCHES`) or raises. The Pallas tile padding
of the reference is a TPU artefact and has no counterpart here: the kernel
masks the ragged edge itself. The bucket indices must lie in
``[0, n_buckets)`` (``hashing.bucket_index`` guarantees it).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

# One increment per kernel launch, nowhere else: the reference's four keys.
LAUNCHES = {"tiled": 0, "dual": 0, "dual_multi": 0, "perquery": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "ercache_probe_tiled": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I,
                            _I, _P, _P, _P, _P, _P],
    "ercache_probe_dual": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P,
                           _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                           _P, _P, _P, _P, _P],
    "ercache_probe_dual_multi": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I,
                                 _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "ercache_probe_perquery": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I,
                               _I, _I, _P, _P, _P, _P],
}


def _entry(name: str):
    lib = build.load("cache_probe")
    fn = getattr(lib, name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return lib, fn


def _check_table(key_hi, key_lo, write_ts, values, device) -> None:
    nb, w = key_hi.shape
    for name, t in (("key_hi", key_hi), ("key_lo", key_lo),
                    ("write_ts", write_ts)):
        if t.dtype != torch.int32 or tuple(t.shape) != (nb, w):
            raise ValueError(f"{name} must be int32 of shape {(nb, w)}")
    if values.dim() != 3 or tuple(values.shape[:2]) != (nb, w):
        raise ValueError(f"values must have shape ({nb}, {w}, D)")
    if values.element_size() not in (2, 4):
        raise ValueError(f"unsupported value dtype {values.dtype}")
    if not 1 <= w <= 32:
        raise ValueError(f"ways={w}: the probe puts one lane on each way of "
                         "a warp, so 1 <= ways <= 32")
    for t in (key_hi, key_lo, write_ts, values):
        if t.device != device or not t.is_contiguous():
            raise ValueError("cache tables must be contiguous and on the "
                             f"queries' device {device}")


def _check_queries(q_hi, q_lo, buckets, device, **more):
    B = q_hi.shape[0]
    for name, t in (("q_hi", q_hi), ("q_lo", q_lo), ("buckets", buckets),
                    *more.items()):
        if (t.dtype != torch.int32 or tuple(t.shape) != (B,)
                or t.device != device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({B},) int32 "
                             f"tensor on {device}")


def _now_tensor(now_ms, device) -> torch.Tensor:
    """The clock as a 0-d int32 tensor on the device: the kernel reads it
    from device memory, so a device-resident clock never syncs the host."""
    now = torch.as_tensor(now_ms, dtype=torch.int32, device=device)
    if now.dim() != 0:
        raise ValueError("now_ms must be a scalar")
    return now


def _outputs(B: int, values: torch.Tensor):
    dev = values.device
    return (torch.empty((B,), dtype=torch.bool, device=dev),
            torch.empty((B, values.shape[-1]), dtype=values.dtype,
                        device=dev),
            torch.empty((B,), dtype=torch.int32, device=dev),
            torch.empty((B,), dtype=torch.int32, device=dev))


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def _probe_one_table(entry, key_hi, key_lo, write_ts, values, q_hi, q_lo,
                     buckets, now_ms, ttl_ms, with_way):
    """Launch the one-table entry ``ercache_probe_<entry>`` on the card:
    (hit, value, age) and, ``with_way``, the way."""
    dev = q_hi.device
    _check_queries(q_hi, q_lo, buckets, dev)
    _check_table(key_hi, key_lo, write_ts, values, dev)
    B = q_hi.shape[0]
    res = _outputs(B, values)[:4 if with_way else 3]
    if B == 0:
        return res
    now = _now_tensor(now_ms, dev)
    lib, fn = _entry(f"ercache_probe_{entry}")
    code = fn(*_ptrs(key_hi, key_lo, write_ts, values), key_hi.shape[1],
              *_ptrs(q_hi, q_lo, buckets, now), int(ttl_ms), B,
              values.shape[-1], values.element_size(), *_ptrs(*res),
              torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, "ercache_probe_strerror", code, f"cache_probe_{entry}")
    LAUNCHES[entry] += 1
    return res


def cache_probe_tiled(key_hi, key_lo, write_ts, values, q_hi, q_lo, buckets,
                      now_ms, ttl_ms):
    """Probe one table. Same contract as ``ref.cache_probe_ref``:
    returns (hit (B,) bool, value (B, D), age (B,) int32, way (B,) int32,
    -1 on a miss)."""
    if not q_hi.is_cuda:
        return ref.cache_probe_ref(key_hi, key_lo, write_ts, values, q_hi,
                                   q_lo, buckets, now_ms, ttl_ms)
    return _probe_one_table("tiled", key_hi, key_lo, write_ts, values, q_hi,
                            q_lo, buckets, now_ms, ttl_ms, with_way=True)


def cache_probe(key_hi, key_lo, write_ts, values, q_hi, q_lo, buckets,
                now_ms, ttl_ms):
    """Alias of :func:`cache_probe_tiled` (the serving probe)."""
    return cache_probe_tiled(key_hi, key_lo, write_ts, values, q_hi, q_lo,
                             buckets, now_ms, ttl_ms)


def cache_probe_perquery(key_hi, key_lo, write_ts, values, q_hi, q_lo,
                         buckets, now_ms, ttl_ms):
    """The reference's one-query-per-grid-step probe. On the card it runs
    the tiled probe's body (a warp per query, eight a CTA; the TPU's two
    schedules are one here) with no way output and each element of the
    copied row passed through +0.0. Same contract as
    ``ref.cache_probe_perquery_ref``: returns (hit (B,) bool, value (B, D)
    with -0.0 read back as +0.0, age (B,) int32, -1 on a miss)."""
    if not q_hi.is_cuda:
        return ref.cache_probe_perquery_ref(key_hi, key_lo, write_ts, values,
                                            q_hi, q_lo, buckets, now_ms,
                                            ttl_ms)
    return _probe_one_table("perquery", key_hi, key_lo, write_ts, values,
                            q_hi, q_lo, buckets, now_ms, ttl_ms,
                            with_way=False)


def cache_probe_dual(d_key_hi, d_key_lo, d_write_ts, d_values,
                     f_key_hi, f_key_lo, f_write_ts, f_values,
                     q_hi, q_lo, buckets_d, buckets_f,
                     now_ms, ttl_direct_ms, ttl_failover_ms):
    """Probe the direct and failover tables for the same queries in ONE
    launch. Returns ((hit_d, value_d, age_d, way_d), (hit_f, value_f,
    age_f, way_f)), each half bit-identical to :func:`cache_probe_tiled`
    on its table. The tables may differ in buckets and ways."""
    if not q_hi.is_cuda:
        return (ref.cache_probe_ref(d_key_hi, d_key_lo, d_write_ts,
                                    d_values, q_hi, q_lo, buckets_d, now_ms,
                                    ttl_direct_ms),
                ref.cache_probe_ref(f_key_hi, f_key_lo, f_write_ts,
                                    f_values, q_hi, q_lo, buckets_f, now_ms,
                                    ttl_failover_ms))
    dev = q_hi.device
    _check_queries(q_hi, q_lo, buckets_d, dev)
    _check_queries(q_hi, q_lo, buckets_f, dev)
    _check_table(d_key_hi, d_key_lo, d_write_ts, d_values, dev)
    _check_table(f_key_hi, f_key_lo, f_write_ts, f_values, dev)
    if (d_values.shape[-1] != f_values.shape[-1]
            or d_values.dtype != f_values.dtype):
        raise ValueError("direct and failover values must share dim and "
                         "dtype")
    B = q_hi.shape[0]
    out_d, out_f = _outputs(B, d_values), _outputs(B, f_values)
    if B == 0:
        return out_d, out_f
    now = _now_tensor(now_ms, dev)
    lib, fn = _entry("ercache_probe_dual")
    code = fn(*_ptrs(d_key_hi, d_key_lo, d_write_ts, d_values),
              d_key_hi.shape[1],
              *_ptrs(f_key_hi, f_key_lo, f_write_ts, f_values),
              f_key_hi.shape[1],
              *_ptrs(q_hi, q_lo, buckets_d, buckets_f, now),
              int(ttl_direct_ms), int(ttl_failover_ms), B,
              d_values.shape[-1], d_values.element_size(),
              *_ptrs(*out_d), *_ptrs(*out_f),
              torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, "ercache_probe_strerror", code, "cache_probe_dual")
    LAUNCHES["dual"] += 1
    return out_d, out_f


def cache_probe_dual_multi(d_key_hi, d_key_lo, d_write_ts, d_values,
                           f_key_hi, f_key_lo, f_write_ts, f_values,
                           q_hi, q_lo, slots, buckets_d, buckets_f,
                           policy, now_ms):
    """Probe the pooled direct and failover tiers of a multi-model stack
    for a MIXED-model batch in ONE launch.

    ``d_*``/``f_*`` are the pooled (M*Nb, W[, D]) views of the stacked
    tables, ``slots`` (B,) int32 assigns each query its model,
    ``buckets_*`` already carry the slot offset
    (``core.cache.pooled_buckets``), ``policy`` is the (M, 2) int32
    [direct_ttl, failover_ttl] table and ``now_ms`` the clock. The policy
    and the clock stay on the device (no host sync). Precondition, not
    checked (checking would sync): every slot lies in [0, M). Returns
    ((hit_d, value_d, age_d, way_d), (hit_f, value_f, age_f, way_f)),
    equal to ``ref.cache_probe_dual_multi_ref``."""
    if not q_hi.is_cuda:
        return ref.cache_probe_dual_multi_ref(
            d_key_hi, d_key_lo, d_write_ts, d_values, f_key_hi, f_key_lo,
            f_write_ts, f_values, q_hi, q_lo, slots, buckets_d, buckets_f,
            policy, now_ms)
    dev = q_hi.device
    _check_queries(q_hi, q_lo, buckets_d, dev, slots=slots,
                   buckets_f=buckets_f)
    _check_table(d_key_hi, d_key_lo, d_write_ts, d_values, dev)
    _check_table(f_key_hi, f_key_lo, f_write_ts, f_values, dev)
    if (d_values.shape[-1] != f_values.shape[-1]
            or d_values.dtype != f_values.dtype):
        raise ValueError("direct and failover values must share dim and "
                         "dtype")
    if (policy.dtype != torch.int32 or policy.dim() != 2
            or policy.shape[1] != 2 or policy.device != dev
            or not policy.is_contiguous()):
        raise ValueError(f"policy must be a contiguous (M, 2) int32 tensor "
                         f"on {dev}")
    B = q_hi.shape[0]
    out_d, out_f = _outputs(B, d_values), _outputs(B, f_values)
    if B == 0:
        return out_d, out_f
    now = _now_tensor(now_ms, dev)
    lib, fn = _entry("ercache_probe_dual_multi")
    code = fn(*_ptrs(d_key_hi, d_key_lo, d_write_ts, d_values),
              d_key_hi.shape[1],
              *_ptrs(f_key_hi, f_key_lo, f_write_ts, f_values),
              f_key_hi.shape[1],
              *_ptrs(q_hi, q_lo, slots, buckets_d, buckets_f, policy, now),
              B, d_values.shape[-1], d_values.element_size(),
              *_ptrs(*out_d), *_ptrs(*out_f),
              torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, "ercache_probe_strerror", code, "cache_probe_dual_multi")
    LAUNCHES["dual_multi"] += 1
    return out_d, out_f
