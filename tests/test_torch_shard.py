"""repro_torch's bucket-sharded cache tier against the JAX package, on the
CPU.

The port's sharded probe, flush, servers, launchers and snapshots, with
every shard on the CPU, are held against the JAX package's UNSHARDED
functions (``tests/test_shard_parity.py`` holds the JAX sharded paths to
those at 1, 2, 4 and 8 shards): every integer output and every table
plane bit for bit, probe values bitwise through an int32 view. The one
stated exception is the reference's own: its ``psum`` over two or more
devices reads a stored -0.0 back as +0.0, and the port's combine does the
same; with one shard (and unsharded) the sign stays.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import assert_exact, to_np  # noqa: E402
from repro.core import cache as JC  # noqa: E402
from repro.core import server as JS  # noqa: E402
from repro.core import writebuf as JW  # noqa: E402
from repro.core.config import CacheConfig as JCfg  # noqa: E402
from repro.core.config import (  # noqa: E402
    multi_model_tier_configs as j_tier)
from repro.core.hashing import Key64 as JKey  # noqa: E402
from repro.ft import snapshot as j_snap  # noqa: E402
from repro.launch import serve as j_launch  # noqa: E402
from repro_torch.core import cache as TC  # noqa: E402
from repro_torch.core import server as TS  # noqa: E402
from repro_torch.core import writebuf as TW  # noqa: E402
from repro_torch.core.config import CacheConfig as TCfg  # noqa: E402
from repro_torch.core.config import (  # noqa: E402
    multi_model_tier_configs as t_tier)
from repro_torch.core.hashing import Key64 as TKey  # noqa: E402
from repro_torch.distributed import collectives as coll  # noqa: E402
from repro_torch.distributed import sharding as shard_lib  # noqa: E402
from repro_torch.ft import snapshot as t_snap  # noqa: E402
from repro_torch.launch import serve as t_launch  # noqa: E402
from repro_torch.launch.mesh import make_cache_mesh  # noqa: E402

DIM = 8
MIN = 60_000
NB_D, W_D, NB_F, W_F = 64, 4, 32, 2
NOW, TTL_D, TTL_F = 3 * MIN, MIN, 10 * MIN
MINUS_ZERO = np.int32(-0x80000000)     # the bits of float32 -0.0


def cpu_mesh(n):
    return make_cache_mesh(n, devices=["cpu"] * n)


def jkeys(ids):
    return JKey.from_int(np.asarray(ids, np.int64))


def tkeys(ids):
    return TKey.from_int(np.asarray(ids, np.int64), device="cpu")


def bits(x):
    return to_np(x).view(np.int32)


def clone(tree):
    return type(tree)(*(t.clone() for t in tree))


def assert_planes(got, want, what=""):
    """Two tables (NamedTuples of planes) equal bit for bit, values too."""
    for name, g, w in zip(want._fields, got, want):
        assert_exact(bits(g) if g.is_floating_point() else g,
                     bits(w) if np.asarray(w).dtype == np.float32 else w,
                     f"{what}.{name}")


# ---------------------------------------------------------------- routing
@pytest.mark.parametrize("nb,n", [(64, 1), (64, 4), (32, 8), (16, 16)])
def test_route_buckets_match_jax(nb, n, rng):
    """Plain ids, pooled ids (slot * Nb + within, three slots) and the -1
    sentinels: ownership and local ids equal JAX's on every shard, and
    every valid id is owned by exactly one shard."""
    nbl = TC.shard_local_buckets(nb, n)
    assert nbl == JC.shard_local_buckets(nb, n)
    ids = np.concatenate([rng.integers(0, nb, 40),
                          rng.integers(0, 3 * nb, 40), [-1, -1, 0, nb - 1]]
                         ).astype(np.int32)
    owners = np.zeros(ids.shape, np.int32)
    for s in range(n):
        jo, jl = JC.route_buckets(jnp.asarray(ids), s, nb, nbl)
        to, tl = TC.route_buckets(torch.as_tensor(ids), s, nb, nbl)
        assert_exact(to, jo, f"owned {s}")
        assert_exact(tl, jl, f"local {s}")
        owners += to_np(to)
    assert_exact(owners, (ids >= 0).astype(np.int32))


def test_indivisible_bucket_count_raises_the_reference_error():
    with pytest.raises(ValueError) as want:
        JC.shard_local_buckets(64, 3)
    with pytest.raises(ValueError) as got:
        TC.shard_local_buckets(64, 3)
    assert str(got.value) == str(want.value)
    cfg = TCfg(model_id=1, model_type="ctr", n_buckets=64, value_dim=DIM,
               backend="torch")
    with pytest.raises(ValueError) as got:
        TS.init_server_state(cfg, device="cpu", mesh=cpu_mesh(3))
    assert str(got.value) == str(want.value)


def test_place_server_state_splits_by_bucket_range_once(rng):
    """``place_server_state``: shard s holds buckets [s*nb/N, (s+1)*nb/N)
    of both tiers (a gather gives the planes back), the rings and budget
    stay where they are on the CPU, placing a placed state is a no-op,
    and a state placed on 4 shards places onto 2 through its global
    planes; ``cache_image`` / ``with_cache_image`` gather and split."""
    d, f, _ = populated_pair(rng)
    cfg = TCfg(model_id=1, model_type="ctr", n_buckets=NB_D, ways=W_D,
               failover_n_buckets=NB_F, failover_ways=W_F, value_dim=DIM,
               backend="torch")
    flat = TS.init_server_state(cfg, device="cpu")._replace(direct=d,
                                                           failover=f)
    four = shard_lib.place_server_state(flat, cpu_mesh(4))
    for ring in ("writebuf", "touchbuf", "budget"):
        assert all(a is b for a, b in zip(getattr(four, ring),
                                          getattr(flat, ring)))
    for tier, whole in ((four.direct, d), (four.failover, f)):
        assert tier.n_shards == 4 and tier.n_buckets == whole.n_buckets
        assert_planes(tier.shards[1], type(whole)(*(
            t[whole.n_buckets // 4: whole.n_buckets // 2] for t in whole)))
        assert_planes(tier.gather(), whole)
    assert shard_lib.place_server_state(four, cpu_mesh(4)).direct is \
        four.direct
    two = shard_lib.place_server_state(four, cpu_mesh(2))
    assert two.direct.n_shards == 2
    assert_planes(two.failover.gather(), f)
    # cache_image gathers, with_cache_image splits over the target's shards
    cold = TS.init_server_state(cfg, device="cpu", mesh=cpu_mesh(2))
    grafted = TS.with_cache_image(cold, TS.cache_image(four))
    assert grafted.direct.n_shards == 2
    assert_planes(grafted.direct.gather(), d)


# -------------------------------------------------------------- the probe
def populated_pair(rng):
    """Unsharded port tables: fresh, expired and empty slots (probed at NOW
    with TTL_D), every fifth fresh user's value row holding -0.0 in two
    columns. Returns (direct, failover, query ids, planted mask (B, D))."""
    d = TC.init_cache(NB_D, W_D, DIM, device="cpu")
    f = TC.init_cache(NB_F, W_F, DIM, device="cpu")
    fresh = np.arange(70, dtype=np.int64) * 7 + 3
    stale = np.arange(30, dtype=np.int64) * 13 + 10_000
    for ids, t in ((stale, 0), (fresh, 5 * MIN // 2)):
        vals = torch.as_tensor(rng.standard_normal((ids.size, DIM)),
                               dtype=torch.float32)
        vals[::5, 1:3] = -0.0
        TC.insert_dual(d, f, tkeys(ids), vals, t, TTL_D, TTL_F)
    q = rng.choice(np.concatenate([fresh, stale, np.arange(20) + 10 ** 6]),
                   size=96)
    return d, f, q


@pytest.fixture(scope="module")
def probe_case():
    """The port's unsharded tables, the queries, and JAX's unsharded
    lookup_dual of them (one compile, shared by every shard count)."""
    d, f, q = populated_pair(np.random.default_rng(11))
    jd, jf = JC.CacheState(*map(to_np, d)), JC.CacheState(*map(to_np, f))
    want = jax.jit(lambda a, b, k: JC.lookup_dual(
        a, b, k, NOW, TTL_D, TTL_F, backend="jnp"))(jd, jf, jkeys(q))
    return d, f, q, jax.device_get(want)


def assert_probe(got, want, n_shards, what):
    """Integer outputs exact; values bitwise, but at n_shards >= 2 exactly
    the stored -0.0 entries of the hit rows read +0.0."""
    for name in ("hit", "age_ms", "bucket", "way"):
        assert_exact(getattr(got, name), getattr(want, name),
                     f"{what}.{name}")
    g, w = bits(got.values), bits(want.values)
    minus = (w == MINUS_ZERO) & to_np(want.hit)[:, None]
    assert minus.any(), "the case must probe a stored -0.0"
    if n_shards == 1:
        assert_exact(g, w, f"{what}.values")
    else:
        assert_exact(g != w, minus, f"{what}: the entries that differ")
        assert (g[minus] == 0).all(), f"{what}: -0.0 reads +0.0"


PSUM_SCRIPT = textwrap.dedent("""
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.distributed.compat import shard_map
    import numpy as np
    def body(x):
        owned = jax.lax.axis_index("shard") == 0
        return jax.lax.psum(jnp.where(owned, x, jnp.zeros_like(x)),
                            "shard")
    for n in (1, 2):
        mesh = Mesh(np.asarray(jax.devices()[:n]), ("shard",))
        out = shard_map(body, mesh=mesh, in_specs=P(), out_specs=P(),
                        check_vma=False)(jnp.full((4,), -0.0, jnp.float32))
        print(int(np.signbit(np.asarray(out)).all()))
""")


@pytest.mark.parametrize("n_shards", [1, 2, 4, "jax-psum"])
def test_sharded_lookup_dual_matches_jax(n_shards, probe_case):
    """``sharded_lookup_dual`` at N shards against JAX's unsharded
    ``lookup_dual``; the ``jax-psum`` case pins the reference's side of
    the sign rule: a one-hot ``psum`` of -0.0 over a two-device mesh gives
    +0.0 and over a one-device mesh -0.0."""
    if n_shards == "jax-psum":
        env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
            "--xla_force_host_platform_device_count=2"))
        out = subprocess.run([sys.executable, "-c", PSUM_SCRIPT], env=env,
                             capture_output=True, text=True, check=True)
        assert out.stdout.split() == ["1", "0"]   # -0.0 on 1, +0.0 on 2
        return
    d, f, q, want = probe_case
    mesh = cpu_mesh(n_shards)
    sd, sf = (shard_lib.split_cache(t, mesh.devices) for t in (d, f))
    got = coll.sharded_lookup_dual(mesh, sd, sf, tkeys(q), NOW, TTL_D,
                                   TTL_F, backend="torch")
    for g, w, tier in zip(got, want, ("direct", "failover")):
        assert_probe(g, w, n_shards, tier)


def multi_configs():
    """The 8-model registry at 16 buckets (retrieval models 32): per-model
    TTLs, LRU and capacities, failover tiers half the size."""
    kw = dict(value_dim=DIM, n_buckets=16, ways=4, failover_n_buckets=16)
    return (j_tier(**kw),
            [dataclasses.replace(c, backend="torch") for c in t_tier(**kw)])


def populated_multi(rng, tcs):
    """Unsharded stacked port tiers written at two times, -0.0 planted."""
    d = TC.init_multi_cache([c.n_buckets for c in tcs], 4, DIM,
                            device="cpu")
    f = TC.init_multi_cache([c.resolved_failover_n_buckets() for c in tcs],
                            4, DIM, device="cpu")
    pol = TC.policy_from_configs(tcs, device="cpu")
    for t in (0, 2 * MIN):
        ids = rng.integers(0, 150, 120)
        slots = torch.as_tensor(rng.integers(0, len(tcs), 120),
                                dtype=torch.int32)
        vals = torch.as_tensor(rng.standard_normal((120, DIM)),
                               dtype=torch.float32)
        vals[::4, 0] = -0.0
        TC.insert_dual_multi(d, f, pol, slots, tkeys(ids), vals, t)
    return d, f, pol


@pytest.fixture(scope="module")
def multi_probe_case():
    rng = np.random.default_rng(5)
    jcs, tcs = multi_configs()
    d, f, pol = populated_multi(rng, tcs)
    q = rng.integers(0, 200, 96)
    slots = rng.integers(0, len(tcs), 96).astype(np.int32)
    jd = JC.MultiCacheState(*map(to_np, d))
    jf = JC.MultiCacheState(*map(to_np, f))
    want = jax.jit(lambda a, b, s, k, now: JC.lookup_dual_multi(
        a, b, JC.policy_from_configs(jcs), s, k, now))(
        jd, jf, jnp.asarray(slots), jkeys(q), 4 * MIN)
    return d, f, pol, q, slots, jax.device_get(want)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_lookup_dual_multi_matches_jax(n_shards, multi_probe_case):
    d, f, pol, q, slots, want = multi_probe_case
    mesh = cpu_mesh(n_shards)
    sd, sf = (shard_lib.split_cache(t, mesh.devices) for t in (d, f))
    got = coll.sharded_lookup_dual_multi(
        mesh, sd, sf, pol, torch.as_tensor(slots), tkeys(q), 4 * MIN,
        backend="torch")
    for g, w, tier in zip(got, want, ("direct", "failover")):
        assert_probe(g, w, n_shards, tier)


# -------------------------------------------------------------- the flush
def rings(rng, probe, cap=32, mask=None):
    """A wrapped write ring (59 records through 32 slots, duplicates and
    records of users already cached) and a touch ring of one probe's hit
    coordinates. ``probe`` gives (direct, failover) results of ids."""
    buf = TW.init_writebuf(cap, DIM, device="cpu")
    for t in range(3):
        ids = rng.integers(0, 500, 24) * 7 + 3
        vals = torch.as_tensor(rng.standard_normal((24, DIM)),
                               dtype=torch.float32)
        live = torch.as_tensor(rng.uniform(size=24) < 0.85)
        slots = torch.as_tensor(rng.integers(0, 8, 24), dtype=torch.int32)
        TW.append(buf, tkeys(ids), vals, 2 * MIN + 1000 * t, live,
                  model_ids=slots if mask is not None else None)
    tb = TW.init_touchbuf(cap, device="cpu")
    for t in range(2):
        rd, rf = probe(rng.integers(0, 120, 40) * 7 + 3)
        TW.touch_append(tb, rd, rf, 2 * MIN + 500 * t, mask=mask)
    return buf, tb


FLUSHES = ["flush", "flush_dual_ttl", "flush_dual_lru", "flush_dual_multi"]


def _flush_inputs(kind):
    """The port's unsharded pre-flush state and rings of one flush kind."""
    rng = np.random.default_rng(FLUSHES.index(kind))
    if kind == "flush_dual_multi":
        _, tcs = multi_configs()
        d, f, pol = populated_multi(rng, tcs)
        probe = lambda ids: TC.lookup_dual_multi(
            d, f, pol, torch.as_tensor(np.arange(ids.size) % 8,
                                       dtype=torch.int32), tkeys(ids),
            2 * MIN, backend="torch")
        buf, tb = rings(rng, probe, mask=pol.touch[torch.arange(40) % 8])
        return d, f, pol, buf, tb
    d, f, _ = populated_pair(rng)
    buf, tb = rings(rng, lambda ids: TC.lookup_dual(
        d, f, tkeys(ids), 2 * MIN, TTL_D, TTL_F, backend="torch"))
    return d, f, None, buf, tb


def _jax_flush(kind, d, f, buf, tb):
    """JAX's unsharded flush of the same inputs (one jit compile)."""
    jd, jf = (type(x).__name__ for x in (d, f))
    jd = getattr(JC, jd)(*map(to_np, d))
    jf = getattr(JC, jf)(*map(to_np, f))
    jb, jt = JW.WriteBuffer(*map(to_np, buf)), JW.TouchBuffer(*map(to_np, tb))
    if kind == "flush":
        fn = lambda b, a, t: JW.flush(b, a, NOW, TTL_D, touchbuf=t)[0]
        return jax.device_get(jax.jit(fn)(jb, jd, jt)), None
    if kind == "flush_dual_multi":
        jcs, _ = multi_configs()
        fn = lambda b, a, c, t: JW.flush_dual_multi(
            b, a, c, JC.policy_from_configs(jcs), NOW, touchbuf=t)[:2]
        return jax.device_get(jax.jit(fn)(jb, jd, jf, jt))
    lru = kind == "flush_dual_lru"
    fn = lambda b, a, c, t: JW.flush_dual(b, a, c, NOW, TTL_D, TTL_F,
                                          evict_lru=lru, touchbuf=t)[:2]
    return jax.device_get(jax.jit(fn)(jb, jd, jf, jt))


@pytest.fixture(scope="module")
def flush_cases():
    """Per flush kind, computed once: the inputs and JAX's result."""
    memo = {}

    def get(kind):
        if kind not in memo:
            inputs = _flush_inputs(kind)
            memo[kind] = inputs, _jax_flush(kind, inputs[0], inputs[1],
                                            inputs[3], inputs[4])
        return memo[kind]

    return get


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("kind", FLUSHES)
def test_sharded_flush_matches_jax(kind, n_shards, flush_cases):
    """``flush`` (direct tier), ``flush_dual`` (TTL and LRU victims) and
    ``flush_dual_multi``, all with touches, through ``mesh=`` at N shards:
    every plane of the gathered tables equals JAX's unsharded flush, the
    rings are reset and the shards are written in place."""
    (d, f, pol, buf, tb), (want_d, want_f) = flush_cases(kind)
    mesh = cpu_mesh(n_shards)
    sd, sf = (shard_lib.split_cache(t, mesh.devices) for t in (d, f))
    ptrs = [t.data_ptr() for s in sd.shards for t in s]
    buf, tb = clone(buf), clone(tb)
    if kind == "flush":
        out = TW.flush(buf, sd, NOW, TTL_D, touchbuf=tb, mesh=mesh)
        got = (out[0],)
    elif kind == "flush_dual_multi":
        out = TW.flush_dual_multi(buf, sd, sf, pol, NOW, touchbuf=tb,
                                  mesh=mesh)
        got = out[:2]
    else:
        out = TW.flush_dual(buf, sd, sf, NOW, TTL_D, TTL_F,
                            evict_lru=kind == "flush_dual_lru",
                            touchbuf=tb, mesh=mesh)
        got = out[:2]
    assert out[0] is sd and [t.data_ptr() for s in sd.shards
                             for t in s] == ptrs
    assert int(buf.count) == 0 and int(tb.count) == 0
    for g, w, tier in zip(got, (want_d, want_f), ("direct", "failover")):
        assert_planes(g.gather(), w, tier)


# -------------------------------------------------------- the slice whole
LAUNCH = dict(minutes=6, users=300, batch=64, failure_rate=0.05,
              chunk_steps=4, log=lambda *_: None)
CLOCK_KEYS = {"wall_s", "req_per_s", "n_shards"}


@pytest.mark.parametrize("entry,n_shards,opts", [
    ("run_serving", 4, dict(n_buckets=64, eviction="lru", coalesce=True)),
    ("run_serving_multi", 2, dict(n_buckets=32))],
    ids=["single-4", "multi-2"])
def test_launcher_sharded_matches_jax_unsharded(entry, n_shards, opts):
    """The launchers at ``n_shards`` against the JAX launcher unsharded:
    every report key equal but ``n_shards`` and the clock keys."""
    want = getattr(j_launch, entry)(backend="jnp", **LAUNCH, **opts)
    got = getattr(t_launch, entry)(backend="torch", device="cpu",
                                   n_shards=n_shards, **LAUNCH, **opts)
    assert want["n_shards"] == 1 and got["n_shards"] == n_shards
    for k in set(want) - CLOCK_KEYS:
        assert got[k] == want[k], k
    assert got["requests"] > 0 and got["hit_rate"] > 0


SHARD_REFUSED = [["--shards", "2", "--restart"],
                 ["--shards", "2", "--overload"],
                 ["--shards", "2", "--no-cache"],
                 ["--shards", "2", "--chaos", "cascade"],
                 ["--shards", "2", "--regions", "2"]]


@pytest.mark.parametrize("args", SHARD_REFUSED,
                         ids=[" ".join(a) for a in SHARD_REFUSED])
def test_shards_cli_refuses_what_the_reference_refuses(args, capsys,
                                                       monkeypatch):
    """The same refusal, word for word. The reference's launcher re-execs
    itself for forced host devices before some of these checks; that
    re-exec is stubbed out (the port has none)."""
    monkeypatch.setattr(sys, "argv", ["serve", *args])
    monkeypatch.setattr(j_launch, "ensure_shard_devices", lambda n: None)
    with pytest.raises(SystemExit) as ref_exit:
        j_launch.main()
    ref_err = capsys.readouterr().err.splitlines()[-1]
    with pytest.raises(SystemExit) as exc:
        t_launch.main(args)
    err = capsys.readouterr().err.splitlines()[-1]
    assert exc.value.code == ref_exit.value.code == 2
    assert err == ref_err and "--shards" in err


# ------------------------------------------------------------- snapshots
SNAP_STREAM = ((np.arange(40), 1000), (np.arange(20, 60), 5 * MIN))
SNAP_NOW = SNAP_STREAM[-1][1]
T_EYE = torch.eye(DIM)


def snap_cfg(**kw):
    base = dict(model_id=1, model_type="ctr", n_buckets=64, ways=4,
                value_dim=DIM, cache_ttl_ms=30 * MIN,
                failover_ttl_ms=2 * 60 * MIN, eviction="lru")
    return (JCfg(**{**base, **kw}),
            TCfg(**{**base, **kw, "backend": "torch"}))


def feats(ids):
    ids = np.asarray(ids, np.int64)
    return torch.as_tensor((((ids[:, None] * 31 + np.arange(DIM)) % 97)
                            .astype(np.float32) / 97.0))


def t_server(n_shards, **kw):
    _, tc = snap_cfg(**kw)
    mesh = None if n_shards is None else cpu_mesh(n_shards)
    return TS.CachedEmbeddingServer(cfg=tc, tower_fn=lambda p, f: f @ p,
                                    miss_budget=40, mesh=mesh)


def t_restore(directory, srv, **kw):
    return t_snap.restore_server(directory, srv, now_ms=SNAP_NOW + 1000,
                                 writebuf_capacity=80, device="cpu", **kw)


@pytest.fixture(scope="module")
def snaps(tmp_path_factory):
    """A port server on 4 shards served two batches and snapshotted at
    step 5 (``tdir``); JAX's restore of it (unsharded), snapshotted again
    by JAX at step 5 (``jdir``)."""
    tmp = tmp_path_factory.mktemp("shard_snap")
    srv = t_server(4)
    st = TS.init_server_state(srv.cfg, writebuf_capacity=80, device="cpu",
                              mesh=srv.mesh)
    for i, (ids, now) in enumerate(SNAP_STREAM):
        if i:
            st = srv.flush(st, now)
        st = srv.serve_step(T_EYE, st, tkeys(ids), feats(ids), now).state
    tdir, jdir = str(tmp / "torch"), str(tmp / "jax")
    st = t_snap.snapshot_server(tdir, 5, srv, st, SNAP_NOW)
    jc, _ = snap_cfg()
    jsrv = JS.CachedEmbeddingServer(cfg=jc, tower_fn=lambda p, f: f @ p,
                                    miss_budget=40)
    r = j_snap.restore_server(tdir, jsrv, now_ms=SNAP_NOW + 1000,
                              writebuf_capacity=80)
    assert (r.mode, r.step) == ("bitexact", 5)
    j_snap.snapshot_server(jdir, 5, jsrv, r.state, SNAP_NOW)
    return srv, st, r.state, tdir, jdir


def assert_image(t_state, j_state, what):
    ti, ji = TS.cache_image(t_state), JS.cache_image(j_state)
    for tier in ("direct", "failover"):
        assert_planes(ti[tier], jax.device_get(ji[tier]), f"{what} {tier}")
    assert_exact(bits(ti["budget"].tokens), bits(ji["budget"].tokens))


def manifest(directory):
    import json

    with open(os.path.join(directory, "step_00000005",
                           "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("case", ["same-manifest", "torch4-to-jax",
                                  "torch4-to-torch2", "jax-to-torch4",
                                  "rehash-to-torch2", "cold-on-torch2"])
def test_snapshots_cross_packages_and_shard_counts(case, snaps, tmp_path):
    """A snapshot of a 4-shard port server holds the global planes: both
    packages write the same manifest for it, JAX restores it bit for bit
    (unsharded), the port onto 2 shards; a JAX snapshot restores onto 4
    shards. Into a grown geometry on 2 shards it rehashes exactly as the
    unsharded port does; with no snapshot a 2-shard state comes up
    cold."""
    srv, st, jstate, tdir, jdir = snaps
    if case == "same-manifest":
        tm, jm = manifest(tdir), manifest(jdir)
        assert tm["leaves"] == jm["leaves"] and tm["shards"] == jm["shards"]
        assert tm["user_meta"] == jm["user_meta"]
        assert_image(st, jstate, case)
    elif case == "torch4-to-jax":
        assert_image(st, jstate, case)
    elif case in ("torch4-to-torch2", "jax-to-torch4"):
        n, src = (2, tdir) if case == "torch4-to-torch2" else (4, jdir)
        r = t_restore(src, t_server(n))
        assert (r.mode, r.step) == ("bitexact", 5)
        assert r.state.direct.n_shards == n
        assert int(r.state.writebuf.count) == 0
        assert_image(r.state, jstate, case)
    elif case == "rehash-to-torch2":
        r = t_restore(tdir, t_server(2, n_buckets=128))
        flat = t_restore(tdir, t_server(None, n_buckets=128))
        assert r.mode == flat.mode == "rehash" and r.detail == flat.detail
        assert r.state.direct.n_shards == 2
        for tier in ("direct", "failover"):
            assert_planes(getattr(r.state, tier).gather(),
                          getattr(flat.state, tier), f"{case} {tier}")
    else:
        r = t_restore(str(tmp_path / "none"), t_server(2))
        assert r.mode == "cold" and r.state.failover.n_shards == 2
        assert not bool(r.state.direct.gather().write_ts.ne(
            TC.TS_EMPTY).any())


# ----------------------------------------------------- compiled entry points
def test_jit_entry_points_of_a_sharded_server():
    """On the CPU the compiled entry points of a 2-shard server return the
    eager results and the state passed in; a state over two devices (the
    CPU and ``meta``) raises the named NotImplementedError."""
    srv = t_server(2)
    ids = np.arange(48).reshape(3, 16) % 23
    keys = tkeys(ids)
    key0 = TKey(keys.hi[0], keys.lo[0])
    fs = torch.stack([feats(r) for r in ids])
    nows = torch.as_tensor([1000, 2000, 3000], dtype=torch.int32)

    def run(jit):
        st = TS.init_server_state(srv.cfg, writebuf_capacity=64,
                                  device="cpu", mesh=srv.mesh)
        many = srv.jit_serve_many if jit else srv.serve_many
        st2, acc, ys = many(T_EYE, st, keys, fs, nows)
        assert st2.direct.shards[0].key_hi is st.direct.shards[0].key_hi
        one = (srv.jit_serve_step if jit else srv.serve_step)(
            T_EYE, st2, key0, fs[0], 4000)
        st3 = (srv.jit_flush if jit else srv.flush)(one.state, 4000)
        return st3, TS.fetch_counters(acc), ys, one

    (a, ca, ya, oa), (b, cb, yb, ob) = run(True), run(False)
    assert ca == cb
    for x, y in zip(ya + (oa.source, oa.age_ms, oa.embeddings),
                    yb + (ob.source, ob.age_ms, ob.embeddings)):
        assert torch.equal(x, y)
    for tier in ("direct", "failover"):
        assert_planes(getattr(a, tier).gather(),
                      getattr(b, tier).gather(), tier)
    mesh = make_cache_mesh(2, devices=["cpu", "meta"])
    split = dataclasses.replace(srv, mesh=mesh)
    st = TS.init_server_state(srv.cfg, writebuf_capacity=64, device="cpu",
                              mesh=mesh)
    calls = (lambda: split.jit_serve_step(T_EYE, st, key0, fs[0], 0),
             lambda: split.jit_serve_many(T_EYE, st, keys, fs, nows),
             lambda: split.jit_flush(st, 0))
    for call in calls:
        with pytest.raises(NotImplementedError, match="distinct cards"):
            call()
