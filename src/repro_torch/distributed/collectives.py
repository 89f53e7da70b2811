"""Collectives of the port: the decode attention, the sharded top-k and
the bucket-sharded cache tier.

Twin of ``repro/distributed/collectives.py``:

* ``_local_decode_partials`` and ``decode_attention_local``: one query
  token per batch row against a KV cache, as plain torch.
  ``transformer.decode_step`` attends through :func:`decode_attention_local`
  with ``backend="torch"``. The query heads are grouped as (B, Hkv, n_rep,
  hd) against the (B, S, Hkv, hd) cache without repeating it, so a long
  cache never grows n_rep-fold. :func:`combine_decode_partials` is the
  online-softmax merge, which the split decode kernel
  (``csrc/decode_attention.cu``) also runs across the splits of one card.
* The model-axis shard loops over a
  :class:`~repro_torch.launch.mesh.ModelMesh`. The reference runs each body
  under one ``shard_map``; here one controller runs the shards in
  row-major order of the named axes (:func:`_combined_axis_index`), all on
  the mesh's one device, and combines their results in the order of the
  reference's collectives:

  - :func:`seq_sharded_decode_attention`: shard s holds keys ``[s*Sl,
    (s+1)*Sl)`` and gives (m, l, acc) partials, ``_local_decode_partials``
    on the torch backend or one ``decode_attention_partials`` launch on
    the cuda backend; :func:`combine_decode_partials` merges them;
  - :func:`sharded_topk_scores`: a local float32 product and :func:`top_k`
    a shard, ids offset by the shard's first row, the winners concatenated
    in the reference's gather order, then a final :func:`top_k`.

  :func:`top_k` is ``jax.lax.top_k``'s result: ``torch.topk`` promises no
  order among equal scores, so its output is repaired to put the lower
  index first, at the k-th boundary too.
* The cache half: the probe and the flush of a cache tier split by bucket
  range over the shards of a :class:`~repro_torch.launch.mesh.CacheMesh`
  (``distributed/sharding.py`` places the tables). The reference runs each
  under one ``shard_map``; here one controller loops over the shards in
  order, each shard's work on its own device:

  - the probe runs the unsharded probe on every shard's slabs at the
    shard's LOCAL buckets (one ``cache_probe_dual`` or
    ``cache_probe_dual_multi`` launch a shard on the cuda backend, the
    reference's single-launch contract applied to each device), then
    :func:`_combine_probe` masks each result to the rows the shard owns
    and sums them over the shards in shard order on the first device,
    the counterpart of the reference's one-hot ``psum``;
  - the flush needs no combine: each shard applies the ordinary insert
    plan to the ring records it owns, in place on its slab.

  Every output and plane equals the unsharded path's bit for bit, with
  one exception the reference has too: its ``psum`` over two or more
  devices adds the owner's -0.0 to the other shards' +0.0, so a stored
  -0.0 value reads back +0.0 at N >= 2 (N = 1 and the unsharded probe
  keep the sign). :func:`_combine_probe` sums the same way.

The reference's ``cache_pspec`` becomes :func:`bucket_axis`: the bucket
axis is axis 0 of a ``CacheState`` leaf and axis 1 (behind the model axis)
of a ``MultiCacheState`` leaf. ``distributed/compat.py``, the reference's
``shard_map`` shim across JAX versions, has no counterpart.
"""
from __future__ import annotations

import itertools
import math
from typing import Iterator, Optional, Sequence, Tuple, Union

import torch

NEG_INF = -1e30
BACKENDS = ("torch", "cuda")

AxisNames = Union[str, Tuple[str, ...]]


def _as_tuple(axis: AxisNames) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _combined_axis_index(mesh, axes: Sequence[str], coords) -> int:
    """Row-major linear index over several mesh axes of the shard at
    ``coords`` (axis name -> index), as the reference's
    ``_combined_axis_index`` reads it inside a ``shard_map``."""
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + coords[a]
    return idx


def _shard_coords(mesh, axes: Sequence[str]) -> Iterator[dict]:
    """The coordinates over ``axes`` of every shard, in row-major order
    (the first axis slowest)."""
    for idx in itertools.product(*(range(mesh.shape[a]) for a in axes)):
        yield dict(zip(axes, idx))


def _axes_size(mesh, axes: Sequence[str]) -> int:
    return math.prod(mesh.shape[a] for a in axes)


# A logical name and spec entry that leaves its dim as the tensor has it
# (``jax.sharding.PartitionSpec.UNCONSTRAINED``).
UNCONSTRAINED = "unconstrained"

# The planner's counter (``launch/layout.py``'s ``LayoutCounter``) while it
# traces a cell, None otherwise. It keeps the collectives ``record`` logs
# and the layouts the hooks below give; none of them does anything
# without it, and none imports the planner.
TRACER = None


def record(kind: str, operand_bytes: float, group: int) -> None:
    """Count, for the planner, the collective the reference runs where a
    cross-shard combine of the port stands: ``kind`` in its HLO's words
    ("all-reduce", "all-gather", "reduce-scatter"), the operand's bytes a
    device, the group's size. Nothing when the planner is off or the group
    is one shard."""
    if TRACER is not None:
        TRACER.op = "explicit combine"
        TRACER.explicit(kind, operand_bytes, int(group))


def shard_range(n: int) -> Iterator[int]:
    """The shards of a model-axis shard loop, in order: ``range(n)``, or
    under the planner's trace the first shard only (one device's share
    of the work, the SPMD program the reference compiles)."""
    if TRACER is None:
        yield from range(n)
        return
    with TRACER.shard_loop():
        yield 0


def placed(x: torch.Tensor, spec) -> torch.Tensor:
    """``x`` itself; under the planner's trace ``x`` is laid out by
    ``spec`` (a shard loop's combined result, whose collective the loop
    records itself)."""
    if TRACER is not None:
        TRACER.place(x, spec)
    return x


class _Reshard(torch.autograd.Function):
    """Under the planner's trace: a view of ``x`` resharded to ``spec``,
    whose gradient the backward reshards to ``spec`` too (a sharding
    constraint and its transpose; ``LayoutCounter.reshard`` records what
    each takes)."""

    @staticmethod
    def forward(ctx, x, spec):
        ctx.spec = spec
        y = x.view_as(x)
        TRACER.reshard(x, y, spec)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.view_as(grad)
        if TRACER is not None:
            TRACER.reshard(grad, g, ctx.spec)
        return g, None


def reshard(x: torch.Tensor, spec) -> torch.Tensor:
    """``x`` itself, or under the planner's trace a view of it resharded
    to ``spec`` (``sharding.constrain``'s constraint)."""
    return x if TRACER is None else _Reshard.apply(x, spec)


def top_k(scores: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis of (B, N) scores: the k largest
    descending, equal scores lower index first, and at the k-th value the
    lowest indices taken. Returns (values, int64 ids).

    ``torch.topk`` gives the right values but any of the tied ids, in any
    order. The repair: its k + 1 largest are taken, the first k ordered by
    (value descending, index ascending), two stable sorts of k. Where the
    (k+1)-th value equals the k-th, more scores tie at the k-th value than
    there are slots: only for such a batch are the scores above it
    counted and one more ``topk`` over the tied positions picks their
    lowest indices. No full sort of the N scores is made. Scores on the
    ``meta`` device (the planner's trace) hold no values: they take the
    tie-free path."""
    n = scores.shape[-1]
    vals, idx = torch.topk(scores, min(k + 1, n), dim=-1)
    crowded = (bool((vals[:, k] == vals[:, k - 1]).any())
               if n > k and not scores.is_meta else False)
    vals, idx = vals[:, :k], idx[:, :k]
    order = torch.argsort(idx, dim=-1)                 # ids are distinct
    vals, idx = vals.gather(-1, order), idx.gather(-1, order)
    order = torch.argsort(vals, dim=-1, descending=True, stable=True)
    vals, idx = vals.gather(-1, order), idx.gather(-1, order)
    if crowded:
        kth = vals[:, -1:]
        n_above = (scores > kth).sum(dim=-1, keepdim=True)
        dt = torch.int32 if n < 2 ** 31 else torch.int64
        rev = torch.arange(n - 1, -1, -1, dtype=dt, device=scores.device)
        low = (n - 1) - torch.topk(torch.where(scores == kth, rev, -1), k,
                                   dim=-1).values.long()   # ascending ids
        j = torch.arange(k, device=scores.device)[None, :]
        idx = torch.where(j < n_above, idx,
                          low.gather(-1, (j - n_above).clamp(min=0)))
    return vals, idx


def _local_decode_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, kv_len_mask: Optional[torch.Tensor]
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """One-token attention partials over a local KV slice.

    q: (B, Hq, hd); k, v: (B, Sl, Hkv, hd); kv_len_mask (B, Sl) bool or
    None. Returns (m, l, acc): m, l (B, Hq) float32; acc (B, Hq, hd)
    float32. Query head h reads KV head h // n_rep.
    """
    B, Sl, Hkv, hd = k.shape
    n_rep = q.shape[1] // Hkv
    qg = (q.to(torch.float32) * hd ** -0.5).reshape(B, Hkv, n_rep, hd)
    s = torch.einsum("bknd,bskd->bkns", qg, k.to(torch.float32))
    s = s.reshape(B, Hkv * n_rep, Sl)
    if kv_len_mask is not None:
        s = torch.where(kv_len_mask[:, None, :], s, NEG_INF)
    m = s.amax(dim=-1)                                     # (B, Hq)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkns,bskd->bknd", p.reshape(B, Hkv, n_rep, Sl),
                       v.to(torch.float32))
    return m, l, acc.reshape(B, Hkv * n_rep, hd)


def decode_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_valid_len: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """q (B, Hq, hd); k, v (B, S, Hkv, hd); kv_valid_len (B,) masks the
    positions at and after it -> (B, Hq, hd) in q's dtype. A row with
    ``kv_valid_len == 0`` gives the mean of v, as in the reference (the
    Pallas kernel gives zeros there; the decode step always has
    ``valid >= 1``)."""
    mask = None
    if kv_valid_len is not None:
        mask = (torch.arange(k.shape[1], device=k.device)[None, :]
                < kv_valid_len[:, None])
    _, l, acc = _local_decode_partials(q, k, v, kv_len_mask=mask)
    return (acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype)


def combine_decode_partials(m: torch.Tensor, l: torch.Tensor,
                            acc: torch.Tensor, dtype: torch.dtype
                            ) -> torch.Tensor:
    """The online-softmax merge of ``seq_sharded_decode_attention``'s
    shards: m, l (N, B, Hq) and acc (N, B, Hq, hd) float32 partials of N
    key ranges -> (B, Hq, hd) in ``dtype``. The max of the partial maxima,
    then the partial sums and accumulators scaled by exp(m - max)."""
    m_g = m.amax(dim=0)
    corr = torch.exp(m - m_g)
    l_g = (l * corr).sum(dim=0)
    acc_g = (acc * corr[..., None]).sum(dim=0)
    return (acc_g / torch.clamp(l_g[..., None], min=1e-30)).to(dtype)


def batch_shard_axes(mesh, seq_axes: Sequence[str],
                     batch_axes: Optional[AxisNames], batch: int
                     ) -> Tuple[str, ...]:
    """The reference's rule for the axes that split the decode batch:
    ``batch_axes`` (default every mesh axis not in ``seq_axes``), kept in
    order while their running product divides ``batch``."""
    if batch_axes is None:
        batch_axes = tuple(a for a in mesh.axis_names if a not in seq_axes)
    keep, prod = [], 1
    for a in _as_tuple(batch_axes):
        if batch % (prod * mesh.shape[a]) == 0:
            keep.append(a)
            prod *= mesh.shape[a]
    return tuple(keep)


def seq_sharded_decode_attention(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, mesh,
                                 seq_axes: AxisNames = "model",
                                 batch_axes: Optional[AxisNames] = None,
                                 kv_valid_len: Optional[torch.Tensor] = None,
                                 *, backend: str = "cuda") -> torch.Tensor:
    """Decode attention with the KV cache sequence-sharded over
    ``seq_axes``: q (B, Hq, hd); k, v (B, S, Hkv, hd), S split into equal
    key ranges, shard s (row-major over ``seq_axes``) holding ``[s*Sl,
    (s+1)*Sl)`` -> (B, Hq, hd) in q's dtype.

    Each shard's float32 (m, l, acc) over its range, positions offset by
    ``s*Sl`` against ``kv_valid_len``, then the merge in shard order
    (:func:`combine_decode_partials`: the reference's pmax and psums).
    ``backend="torch"`` takes ``_local_decode_partials`` (a row with
    ``kv_valid_len == 0`` gives the mean of v, as the reference);
    ``"cuda"`` makes one ``decode_attention_partials`` launch a shard on
    views of the cache (no copy), whose empty ranges carry l = 0, acc = 0,
    so such a row gives zeros. The batch axes (:func:`batch_shard_axes`)
    split rows only, which changes no value: the one controller computes
    every row."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    seq_axes = _as_tuple(seq_axes)
    mesh.device()                       # refuses a mesh of distinct devices
    rows = q.shape[0] // _axes_size(
        mesh, batch_shard_axes(mesh, seq_axes, batch_axes, q.shape[0]))
    n = _axes_size(mesh, seq_axes)
    # the reference's pmax of m, psums of l and acc: float32 partials of a
    # device's rows
    for width in (1, 1, q.shape[-1]):
        record("all-reduce", rows * q.shape[1] * width * 4, n)
    S = k.shape[1]
    if S % n:
        raise ValueError(f"a cache of {S} positions does not split over "
                         f"{n} sequence shards")
    sl = S // n
    from repro_torch.kernels.decode_attention import \
        decode_attention_partials

    parts = []
    for s in shard_range(n):
        lo = s * sl
        k_l, v_l = k[:, lo:lo + sl], v[:, lo:lo + sl]
        if backend == "cuda":
            parts.append(decode_attention_partials(q, k_l, v_l,
                                                   kv_valid_len, lo))
            continue
        mask = None
        if kv_valid_len is not None:
            pos = lo + torch.arange(sl, device=k.device)
            mask = pos[None, :] < kv_valid_len[:, None]
        parts.append(tuple(t[None] for t in _local_decode_partials(
            q, k_l, v_l, kv_len_mask=mask)))
    m, l, acc = (torch.cat(t) for t in zip(*parts))
    out = combine_decode_partials(m, l, acc, q.dtype)
    baxes = batch_shard_axes(mesh, seq_axes, batch_axes, q.shape[0])
    return placed(out, (baxes or None,))


def sharded_topk_scores(query: torch.Tensor, candidates: torch.Tensor,
                        k_top: int, mesh,
                        cand_axes: AxisNames = ("data", "model")
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Retrieval scoring with the (N, D) candidates row-sharded over
    ``cand_axes`` (those the mesh has): shard s (row-major) scores rows
    ``[s*Nl, (s+1)*Nl)`` against the (B, D) queries in float32 and keeps
    its :func:`top_k`, ids offset by ``s*Nl``; then a final
    :func:`top_k` over the winners. Returns (values (B, k) float32, ids
    (B, k) int32).

    The winners are concatenated in the order the reference's gathers
    leave them: it all-gathers one axis after another, so the LAST axis
    is outermost (model-major for ``("data", "model")``) while the ids
    are offset data-major; equal scores resolve by that block order."""
    cand_axes = tuple(a for a in _as_tuple(cand_axes)
                      if a in mesh.axis_names)
    mesh.device()                       # refuses a mesh of distinct devices
    n = _axes_size(mesh, cand_axes)
    if candidates.shape[0] % n:
        raise ValueError(f"{candidates.shape[0]} candidates do not split "
                         f"over {n} shards")
    nl = candidates.shape[0] // n
    with torch.no_grad():
        q = query.to(torch.float32)
        local = {}
        for s in shard_range(n):            # row-major over cand_axes
            rows = candidates[s * nl:(s + 1) * nl].to(torch.float32)
            vals, idx = top_k(q @ rows.T, k_top)
            local[s] = (vals, idx + s * nl)
        width = k_top
        for a in cand_axes:            # the reference's all_gathers in turn
            for _ in ("vals", "ids"):  # float32 and int32 (B, width)
                record("all-gather", q.shape[0] * width * 4, mesh.shape[a])
            width *= mesh.shape[a]
        order = [_combined_axis_index(mesh, cand_axes, c)
                 for c in _shard_coords(mesh, cand_axes[::-1])]
        order = [s for s in order if s in local]   # one under the planner
        vals_g = torch.cat([local[s][0] for s in order], dim=-1)
        idx_g = torch.cat([local[s][1] for s in order], dim=-1)
        vals, pos = top_k(vals_g, k_top)
    return vals, idx_g.gather(-1, pos).to(torch.int32)


# ============================================================ cache tier
# Imported here, below the decode half: ``kernels/ref.py`` imports that
# half, and ``core/cache.py`` imports ``kernels/ref.py``.
from repro_torch.core import cache as cache_lib  # noqa: E402
from repro_torch.core import writebuf as wb_lib  # noqa: E402
from repro_torch.core.hashing import Key64, bucket_index  # noqa: E402
from repro_torch.launch.mesh import SHARD_AXIS  # noqa: E402


def bucket_axis(state) -> int:
    """The axis a table's leaves are split along: the bucket axis, 0 of a
    ``CacheState`` leaf, 1 (behind the model axis) of a
    ``MultiCacheState`` leaf."""
    return 1 if isinstance(state, cache_lib.MultiCacheState) else 0


def _on(x, dev: torch.device):
    """A tensor, or a NamedTuple of tensors, on ``dev`` (no copy where it
    is already there)."""
    if isinstance(x, torch.Tensor):
        return x if x.device == dev else x.to(dev)
    if isinstance(x, tuple):
        return type(x)(*(_on(t, dev) for t in x))
    return x


def _combine_probe(results, owned, global_bucket: torch.Tensor,
                   n_shards: int) -> cache_lib.LookupResult:
    """Per-shard probe results -> one result on the first shard's device.
    At most one shard owns a query's bucket, so masking each shard's
    result to its owned hits and summing over the shards in shard order
    reassembles the owner's row. The miss sentinels (age and way -1,
    zero values) are imposed after the sum; the reported bucket is the
    GLOBAL one, so the touch ring stays shard-agnostic. With one shard the
    masked result is returned as it is (a stored -0.0 keeps its sign);
    with more, the sum turns it into +0.0, as the reference's ``psum``."""
    dev = global_bucket.device
    B, D = results[0].values.shape
    for nbytes in (4 * B, B * D * results[0].values.element_size(), 4 * B,
                   4 * B):              # psums of hit, values, age, way
        record("all-reduce", nbytes, n_shards)
    total = None
    for res, own in zip(results, owned):
        hitc = _on(res.hit & own, dev)
        part = (hitc,
                torch.where(hitc[:, None], _on(res.values, dev),
                            torch.zeros((), dtype=res.values.dtype,
                                        device=dev)),
                torch.where(hitc, _on(res.age_ms, dev), 0),
                torch.where(hitc, _on(res.way, dev), 0))
        total = part if total is None else (
            total[0] | part[0], total[1] + part[1], total[2] + part[2],
            total[3] + part[3])
    hit, values, age, way = total
    return cache_lib.LookupResult(
        hit=hit, values=values, age_ms=torch.where(hit, age, -1),
        bucket=global_bucket, way=torch.where(hit, way, -1))


def _shard_keys(keys: Key64, dev: torch.device) -> Key64:
    return Key64(hi=_on(keys.hi, dev), lo=_on(keys.lo, dev))


def _shards(mesh, tier):
    """(shard count, local buckets) of a table split over ``mesh``."""
    n = mesh.shape[SHARD_AXIS]
    if tier.n_shards != n:
        raise ValueError(f"a table of {tier.n_shards} shards on a mesh of "
                         f"{n}")
    return n, cache_lib.shard_local_buckets(tier.n_buckets, n)


def _probe_shards(mesh, direct, failover, g_d, g_f, probe):
    """Probe every shard at its local buckets: ``probe(d, f, dev, loc_d,
    loc_f)`` gives one shard's (direct, failover) results; the combine
    reassembles them with the global buckets ``g_d`` / ``g_f``."""
    n, nbl_d = _shards(mesh, direct)
    _, nbl_f = _shards(mesh, failover)
    res_d, res_f, own_d, own_f = [], [], [], []
    for s in shard_range(n):
        d, f = direct.shards[s], failover.shards[s]
        dev = d.key_hi.device
        od, ld = cache_lib.route_buckets(_on(g_d, dev), s,
                                         direct.n_buckets, nbl_d)
        of, lf = cache_lib.route_buckets(_on(g_f, dev), s,
                                         failover.n_buckets, nbl_f)
        rd, rf = probe(d, f, dev, ld, lf)
        res_d.append(rd)
        res_f.append(rf)
        own_d.append(od)
        own_f.append(of)
    return (_combine_probe(res_d, own_d, g_d, n),
            _combine_probe(res_f, own_f, g_f, n))


def sharded_lookup_dual(mesh, direct, failover, keys: Key64, now_ms,
                        direct_ttl_ms, failover_ttl_ms, *,
                        backend: str = "cuda"):
    """``cache.lookup_dual`` across a bucket-sharded pair of tables
    (``ShardedCacheState``): one dual probe a shard at its local buckets
    (one ``cache_probe_dual`` launch a shard on the cuda backend), then
    the combine. Returns (LookupResult_direct, LookupResult_failover) on
    the first shard's device, buckets global."""
    return _probe_shards(
        mesh, direct, failover, bucket_index(keys, direct.n_buckets),
        bucket_index(keys, failover.n_buckets),
        lambda d, f, dev, ld, lf: cache_lib.lookup_dual(
            d, f, _shard_keys(keys, dev), _on(now_ms, dev), direct_ttl_ms,
            failover_ttl_ms, backend=backend, buckets_d=ld, buckets_f=lf))


def sharded_lookup_dual_multi(mesh, direct, failover,
                              policy: cache_lib.ModelPolicy, slots,
                              keys: Key64, now_ms, *, backend: str = "cuda"):
    """``cache.lookup_dual_multi`` across bucket-sharded stacked tiers:
    the pooled bucket ids are computed once on the first device (a pure
    function of slot, key and policy), routed to each shard and probed
    against the shard's local pooled view (one ``cache_probe_dual_multi``
    launch a shard on the cuda backend); the combine as in
    :func:`sharded_lookup_dual`."""
    slots = torch.as_tensor(slots, dtype=torch.int32, device=keys.hi.device)
    return _probe_shards(
        mesh, direct, failover,
        cache_lib.pooled_buckets(slots, keys, policy.bucket_mask_d,
                                 direct.n_buckets),
        cache_lib.pooled_buckets(slots, keys, policy.bucket_mask_f,
                                 failover.n_buckets),
        lambda d, f, dev, ld, lf: cache_lib.lookup_dual_multi(
            d, f, _on(policy, dev), _on(slots, dev), _shard_keys(keys, dev),
            _on(now_ms, dev), backend=backend, buckets_d=ld, buckets_f=lf))


def _touch_local(state, tb: wb_lib.TouchBuffer, bucket, way, nb_global: int,
                 nb_local: int, shard: int, enabled=None):
    """One cache's deferred recency bumps routed to ``shard`` (the ring
    holds global coordinates, -1 for "no hit in that cache")."""
    own, loc = cache_lib.route_buckets(bucket, shard, nb_global, nb_local)
    live = wb_lib._gate(wb_lib._touch_live(tb) & (bucket >= 0) & own,
                        enabled)
    return cache_lib.touch(state, loc, way, tb.ts_ms, live=live)


def _flush_tier(mesh, tier, g, ring, now_ms, ttl_ms, evict_lru, touchbuf,
                coords, enabled, salt=None) -> None:
    """One table's share of a sharded flush, IN PLACE: on each shard the
    touches it owns are scatter-maxed into its recency plane, then the
    ring records it owns are inserted (``write_mask = live & owned`` at
    the local buckets). ``g`` holds the records' global (or pooled)
    buckets, ``ring`` the unrolled ring (keys, values, ts, live),
    ``coords`` the touch ring's (bucket, way) fields of this table; a
    stacked tier's slabs are written through their pooled views."""
    _, nbl = _shards(mesh, tier)
    keys, values, ts, live = ring
    for s, st in enumerate(tier.shards):
        dev = st.key_hi.device
        on = _on(enabled, dev)
        if isinstance(st, cache_lib.MultiCacheState):
            st = st.flat()
        if touchbuf is not None:
            tb = _on(touchbuf, dev)
            _touch_local(st, tb, getattr(tb, coords[0]),
                         getattr(tb, coords[1]), tier.n_buckets, nbl, s, on)
        own, loc = cache_lib.route_buckets(_on(g, dev), s, tier.n_buckets,
                                           nbl)
        cache_lib.insert(st, _shard_keys(keys, dev), _on(values, dev),
                         _on(now_ms, dev), _on(ttl_ms, dev),
                         write_mask=wb_lib._gate(_on(live, dev) & own, on),
                         ts_ms=_on(ts, dev), evict_lru=_on(evict_lru, dev),
                         buckets=loc, dedupe_salt=_on(salt, dev))


_DIRECT, _FAILOVER = ("bucket_d", "way_d"), ("bucket_f", "way_f")


def _reset_rings(buf, touchbuf, enabled) -> None:
    if touchbuf is not None:
        wb_lib._reset(touchbuf.count, enabled)
    wb_lib._reset(buf.count, enabled)


def sharded_flush(mesh, buf: wb_lib.WriteBuffer, state, now_ms, ttl_ms,
                  evict_lru=False, touchbuf=None, enabled=None):
    """``writebuf.flush`` (the direct tier only) across a bucket-sharded
    table: each shard applies the touches and the ring records it owns,
    IN PLACE on its slab. Returns (state, buf, touchbuf)."""
    keys, values, ts, live, _ = wb_lib._ring_order(buf)
    _flush_tier(mesh, state, bucket_index(keys, state.n_buckets),
                (keys, values, ts, live), now_ms, ttl_ms, evict_lru,
                touchbuf, _DIRECT, enabled)
    _reset_rings(buf, touchbuf, enabled)
    return state, buf, touchbuf


def sharded_flush_dual(mesh, buf: wb_lib.WriteBuffer, direct, failover,
                       now_ms, direct_ttl_ms, failover_ttl_ms,
                       evict_lru=False, touchbuf=None, enabled=None):
    """``writebuf.flush_dual`` across a bucket-sharded pair of tables.

    The two tiers hash at different bucket counts, so a record's direct
    and failover rows may live on DIFFERENT shards: each tier is routed
    and inserted on its own, two plain inserts a shard (the unsharded
    flush's shared plan equals two independent inserts, and a plan
    restricted to the rows one shard owns equals the global plan's
    restriction, because all occurrences of a key share its bucket).
    Returns (direct, failover, buf, touchbuf)."""
    keys, values, ts, live, _ = wb_lib._ring_order(buf)
    for tier, ttl, coords in ((direct, direct_ttl_ms, _DIRECT),
                              (failover, failover_ttl_ms, _FAILOVER)):
        _flush_tier(mesh, tier, bucket_index(keys, tier.n_buckets),
                    (keys, values, ts, live), now_ms, ttl, evict_lru,
                    touchbuf, coords, enabled)
    _reset_rings(buf, touchbuf, enabled)
    return direct, failover, buf, touchbuf


def sharded_flush_dual_multi(mesh, buf: wb_lib.WriteBuffer, direct,
                             failover, policy: cache_lib.ModelPolicy,
                             now_ms, touchbuf=None, enabled=None):
    """``writebuf.flush_dual_multi`` across bucket-sharded stacked tiers:
    the ring records carry model slots, whose pooled bucket ids are
    computed once from the policy (as the unsharded flush does) and
    routed to each shard; each record keeps its model's TTLs, eviction
    policy and slot-salted dedupe, and only the table writes are local.
    Returns (direct, failover, buf, touchbuf)."""
    keys, values, ts, live, slots = wb_lib._ring_order(buf)
    s_idx = slots.long()
    for tier, mask, ttl, coords in (
            (direct, policy.bucket_mask_d, policy.ttl_ms, _DIRECT),
            (failover, policy.bucket_mask_f, policy.failover_ttl_ms,
             _FAILOVER)):
        _flush_tier(mesh, tier,
                    cache_lib.pooled_buckets(slots, keys, mask,
                                             tier.n_buckets),
                    (keys, values, ts, live), now_ms, ttl[s_idx],
                    policy.evict_lru[s_idx], touchbuf, coords, enabled,
                    salt=slots)
    _reset_rings(buf, touchbuf, enabled)
    return direct, failover, buf, touchbuf
