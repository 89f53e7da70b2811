"""repro_torch's checkpoints, elastic rehash and warm restarts against the
JAX package, on the CPU.

One snapshot format: a snapshot written by either package restores bit for
bit in the other (single, M=2 multi and R=3 regional servers), and both
write the same manifest (leaf names, shapes, dtypes, crc32s, shards and
metadata) for one state. The port's rehash equals the reference's on every
plane, every fail-open case gives the reference's mode and step, the
checkpoint cases of ``tests/test_ft.py`` hold, and ``run_serving_restart``
reports what the reference's does. Everything is exact: integer planes,
copied values (the tower is ``feats @ eye``) and counters.
"""
import dataclasses
import glob
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import assert_exact  # noqa: E402
from repro.core import regional as JRG  # noqa: E402
from repro.core import server as JS  # noqa: E402
from repro.core import cache as JC  # noqa: E402
from repro.core.config import CacheConfig as JCfg  # noqa: E402
from repro.core.hashing import Key64 as JKey  # noqa: E402
from repro.core.metrics import ServingCounters as JCounters  # noqa: E402
from repro.core.ratelimit import InferBudget as JBudget  # noqa: E402
from repro.ft import checkpoint as j_ckpt  # noqa: E402
from repro.ft import elastic as j_el  # noqa: E402
from repro.ft import snapshot as j_snap  # noqa: E402
from repro.launch import serve as j_launch  # noqa: E402
from repro_torch.core import cache as TC  # noqa: E402
from repro_torch.core import regional as TRG  # noqa: E402
from repro_torch.core import server as TS  # noqa: E402
from repro_torch.core.config import CacheConfig as TCfg  # noqa: E402
from repro_torch.core.graph import tensors_of  # noqa: E402
from repro_torch.core.hashing import Key64 as TKey  # noqa: E402
from repro_torch.core.metrics import ServingCounters as TCounters  # noqa: E402
from repro_torch.core.ratelimit import InferBudget as TBudget  # noqa: E402
from repro_torch.ft import checkpoint as t_ckpt  # noqa: E402
from repro_torch.ft import elastic as t_el  # noqa: E402
from repro_torch.ft import snapshot as t_snap  # noqa: E402
from repro_torch.launch import serve as t_launch  # noqa: E402

DIM = 8
MIN = 60_000
HOUR = 60 * MIN
BASE = dict(model_id=1, model_type="ctr", n_buckets=64, ways=4,
            value_dim=DIM, cache_ttl_ms=30 * MIN, failover_ttl_ms=2 * HOUR)
# two serve batches with a flush between: the second re-reads half of the
# first (hits feeding the recency plane) and writes 20 new users
STREAM = ((np.arange(40), 1000), (np.arange(20, 60), 5 * MIN))
NOW = STREAM[-1][1]
COUNTERS = dict(requests=80, direct_hits=20, tower_inferences=60)
J_EYE, T_EYE = jnp.eye(DIM, dtype=jnp.float32), torch.eye(DIM)


def cfgs(**kw):
    """(JAX config, port config) of BASE with ``kw``."""
    return (JCfg(**{**BASE, **kw}),
            TCfg(**{**BASE, **kw, "backend": "torch"}))


def feats_np(ids):
    ids = np.asarray(ids, np.int64)
    return (((ids[:, None] * 31 + np.arange(DIM)[None, :]) % 97)
            .astype(np.float32) / 97.0)


def tower(p, f):
    return f @ p


def jkeys(ids):
    return JKey.from_int(np.asarray(ids, np.int64))


def tkeys(ids):
    return TKey.from_int(np.asarray(ids, np.int64), device="cpu")


def j_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in flat]


def t_leaves(tree):
    return [(k, v.cpu().numpy()) for k, v in t_ckpt._leaf_paths(tree)]


def assert_same_image(t_tree, j_tree, what=""):
    """Two cache images: the same leaf names, every leaf bit for bit."""
    got, want = t_leaves(t_tree), j_leaves(j_tree)
    assert [k for k, _ in got] == [k for k, _ in want], what
    for (k, g), (_, w) in zip(got, want):
        assert_exact(g, w, f"{what} {k}")


def t_image(state):
    if isinstance(state, TRG.RegionalState):
        return TRG.cache_image(state)
    return TS.cache_image(state)


def j_image(state):
    if isinstance(state, JRG.RegionalState):
        return JRG.cache_image(state)
    return JS.cache_image(state)


def manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)


# ------------------------------------------------------- served snapshots
@dataclasses.dataclass
class Served:
    """One state served the same way by both packages, snapshotted by each
    at step 5: the servers, the drained states and both directories."""
    jsrv: object
    tsrv: object
    jstate: object
    tstate: object
    jdir: str
    tdir: str


def _snapshot_both(tmp, jsrv, tsrv, jst, tst, now):
    jdir, tdir = str(tmp / "jax"), str(tmp / "torch")
    jst = j_snap.snapshot_server(jdir, 5, jsrv, jst, now,
                                 counters=JCounters(**COUNTERS))
    tst = t_snap.snapshot_server(tdir, 5, tsrv, tst, now,
                                 counters=TCounters(**COUNTERS))
    return Served(jsrv, tsrv, jst, tst, jdir, tdir)


def multi_cfgs(make):
    """The M=2 registry: model 2 at half the buckets, 5 min TTL, LRU."""
    return (make(model_id=1), make(model_id=2, n_buckets=32,
                                   cache_ttl_ms=5 * MIN, eviction="lru"))


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The single-model server with admission and LRU touches."""
    jc, tc = cfgs(eviction="lru", infer_budget_per_step=30.0)
    jsrv = JS.CachedEmbeddingServer(cfg=jc, tower_fn=tower, miss_budget=40)
    tsrv = TS.CachedEmbeddingServer(cfg=tc, tower_fn=tower, miss_budget=40)
    jst = JS.init_server_state(jc, writebuf_capacity=80)
    tst = TS.init_server_state(tc, writebuf_capacity=80, device="cpu")
    for i, (ids, now) in enumerate(STREAM):
        if i:
            jst, tst = jsrv.flush(jst, now), tsrv.flush(tst, now)
        jst = jsrv.serve_step(J_EYE, jst, jkeys(ids),
                              jnp.asarray(feats_np(ids)), now).state
        tst = tsrv.serve_step(T_EYE, tst, tkeys(ids),
                              torch.as_tensor(feats_np(ids)), now).state
    return _snapshot_both(tmp_path_factory.mktemp("single"), jsrv, tsrv,
                          jst, tst, NOW)


@pytest.fixture(scope="module")
def multi(tmp_path_factory):
    jcs = multi_cfgs(lambda **kw: JCfg(**{**BASE, **kw}))
    tcs = multi_cfgs(lambda **kw: TCfg(**{**BASE, **kw, "backend": "torch"}))
    jsrv = JS.MultiModelServer(cfgs=jcs, tower_fn=tower, miss_budget=40)
    tsrv = TS.MultiModelServer(cfgs=tcs, tower_fn=tower, miss_budget=40,
                               device="cpu")
    jst = JS.init_multi_server_state(jcs, writebuf_capacity=80)
    tst = TS.init_multi_server_state(tcs, writebuf_capacity=80,
                                     device="cpu")
    for i, (ids, now) in enumerate(STREAM):
        if i:
            jst, tst = jsrv.flush(jst, now), tsrv.flush(tst, now)
        slots = (np.arange(ids.size) % 2).astype(np.int32)
        jst = jsrv.serve_step(J_EYE, jst, jnp.asarray(slots), jkeys(ids),
                              jnp.asarray(feats_np(ids)), now).state
        tst = tsrv.serve_step(T_EYE, tst, torch.as_tensor(slots), tkeys(ids),
                              torch.as_tensor(feats_np(ids)), now).state
    return _snapshot_both(tmp_path_factory.mktemp("multi"), jsrv, tsrv,
                          jst, tst, NOW)


def regional_servers(n_regions=3, n_users=50):
    jc, tc = cfgs()
    kw = dict(n_regions=n_regions, n_users=n_users, tower_fn=tower,
              miss_budget=8, locality=0.9, seed=3)
    return (JRG.RegionalServer(cfgs=(jc,), **kw),
            TRG.RegionalServer(cfgs=(tc,), device="cpu", **kw))


@pytest.fixture(scope="module")
def regional(tmp_path_factory):
    jsrv, tsrv = regional_servers()
    steps, batch = 4, 8
    uids = np.random.default_rng(7).integers(
        0, 50, size=(steps, batch)).astype(np.int32)
    feats = feats_np(uids.reshape(-1)).reshape(steps, batch, DIM)
    nows = (np.arange(steps) * 10_000).astype(np.int32)
    slots = np.zeros_like(uids)
    jdr, jep = JRG.stage_drain_schedule(steps, 3, [(2, "drain", 1)])
    tdr, tep = TRG.stage_drain_schedule(steps, 3, [(2, "drain", 1)],
                                        device="cpu")
    jst, _, _ = jsrv.jit_serve_many(
        J_EYE, jsrv.init_state(writebuf_capacity=64), uids, slots,
        JKey.from_int(uids), jnp.asarray(feats), nows, jdr, jep,
        JRG.event_bases(0, steps, batch))
    tst, _, _ = tsrv.serve_many(
        T_EYE, tsrv.init_state(writebuf_capacity=64), torch.as_tensor(uids),
        torch.as_tensor(slots), TKey.from_int(uids, device="cpu"),
        torch.as_tensor(feats), torch.as_tensor(nows), tdr, tep,
        TRG.event_bases(0, steps, batch, device="cpu"))
    return _snapshot_both(tmp_path_factory.mktemp("regional"), jsrv, tsrv,
                          jst, tst, int(nows[-1]))


KINDS = ["single", "multi", "regional"]


@pytest.mark.parametrize("kind", KINDS)
def test_both_packages_write_the_same_manifest(kind, request):
    """The same served state, snapshotted by each package: the same leaf
    names in the same order, shapes, numpy dtypes, crc32s and parts, the
    same shard files, and the same metadata (schema, kind, geometry,
    clock, counters)."""
    s = request.getfixturevalue(kind)
    assert_same_image(t_image(s.tstate), j_image(s.jstate), kind)
    jm, tm = manifest(s.jdir, 5), manifest(s.tdir, 5)
    assert list(tm["leaves"]) == list(jm["leaves"])
    assert tm["leaves"] == jm["leaves"]
    assert tm["shards"] == jm["shards"]
    assert tm["user_meta"] == jm["user_meta"]
    assert tm["user_meta"]["kind"] == kind
    assert tm["user_meta"]["dtype"] == "float32"


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
@pytest.mark.parametrize("kind", KINDS)
def test_snapshot_restores_bitexact_across_packages(kind, direction,
                                                    request):
    """A snapshot written by one package restores bit-exact in the other:
    every plane of both tiers, the budget tokens (and the home table),
    with the counters resumed and the rings empty."""
    s = request.getfixturevalue(kind)
    if direction == "jax_to_torch":
        r = t_snap.restore_server(s.jdir, s.tsrv, now_ms=NOW + 1000,
                                  writebuf_capacity=80, device="cpu")
        got, want = r.state, s.jstate
        assert r.counters == TCounters(**COUNTERS)
        tier = r.state.inner if kind == "regional" else r.state
        assert int(tier.writebuf.count) == 0
    else:
        r = j_snap.restore_server(s.tdir, s.jsrv, now_ms=NOW + 1000,
                                  writebuf_capacity=80)
        got, want = s.tstate, r.state
        assert r.counters == JCounters(**COUNTERS)
    assert (r.mode, r.step) == ("bitexact", 5)
    assert_same_image(t_image(got), j_image(want), f"{kind} {direction}")


def _rehash_targets():
    """(name, snapshot fixture, JAX server, port server, restore clock)."""
    def single_srv(**kw):
        jc, tc = cfgs(eviction="lru", infer_budget_per_step=30.0, **kw)
        return (JS.CachedEmbeddingServer(cfg=jc, tower_fn=tower,
                                         miss_budget=40),
                TS.CachedEmbeddingServer(cfg=tc, tower_fn=tower,
                                         miss_budget=40))

    def multi_srv(scale=1, n=2, ways=4):
        grow = lambda c: dataclasses.replace(c, n_buckets=c.n_buckets * scale,
                                             ways=ways)
        jcs = multi_cfgs(lambda **kw: JCfg(**{**BASE, **kw}))[:n]
        tcs = multi_cfgs(lambda **kw: TCfg(**{**BASE, **kw,
                                               "backend": "torch"}))[:n]
        return (JS.MultiModelServer(cfgs=tuple(map(grow, jcs)),
                                    tower_fn=tower, miss_budget=40),
                TS.MultiModelServer(cfgs=tuple(map(grow, tcs)),
                                    tower_fn=tower, miss_budget=40,
                                    device="cpu"))

    later = NOW + 1000
    # 1000 + 30 min + 1: the first batch's direct entries have expired
    expired = 1000 + 30 * MIN + 1
    return {
        "grow": ("single", single_srv(n_buckets=128), later),
        "shrink": ("single", single_srv(n_buckets=16), later),
        "fewer_ways": ("single", single_srv(ways=2), later),
        "expired_dropped": ("single", single_srv(n_buckets=128), expired),
        "single_into_m1_multi": ("single", multi_srv(n=1), later),
        "multi_grow": ("multi", multi_srv(scale=2), later),
        "multi_fewer_ways_expired": ("multi", multi_srv(ways=2), expired),
    }


@pytest.mark.parametrize("case", list(_rehash_targets()))
def test_rehash_restore_matches_jax(case, request):
    """A resized restore of the JAX-written snapshot in both packages:
    the same mode, step and detail (candidate counts), and every plane of
    both rehashed tiers and the budget bit for bit."""
    kind, (jsrv, tsrv), now = _rehash_targets()[case]
    s = request.getfixturevalue(kind)
    jr = j_snap.restore_server(s.jdir, jsrv, now_ms=now, writebuf_capacity=80)
    tr = t_snap.restore_server(s.jdir, tsrv, now_ms=now, writebuf_capacity=80,
                               device="cpu")
    assert (tr.mode, tr.step, tr.detail) == (jr.mode, jr.step, jr.detail)
    assert tr.mode == "rehash"
    assert_same_image(t_image(tr.state), j_image(jr.state), case)


def test_multi_m1_snapshot_rehashes_into_single_like_jax(single, tmp_path):
    """An M=1 multi snapshot (the single snapshot restored into an M=1
    tier, snapshotted by JAX) restored into a single-model server of
    another geometry, in both packages."""
    jc, tc = cfgs(eviction="lru", infer_budget_per_step=30.0)
    jm1 = JS.MultiModelServer(cfgs=(jc,), tower_fn=tower, miss_budget=40)
    r = j_snap.restore_server(single.jdir, jm1, now_ms=NOW,
                              writebuf_capacity=80)
    assert r.mode == "rehash"
    d = str(tmp_path)
    j_snap.snapshot_server(d, 9, jm1, r.state, NOW)
    jc2, tc2 = cfgs(n_buckets=32, eviction="lru")
    jr = j_snap.restore_server(d, JS.CachedEmbeddingServer(
        cfg=jc2, tower_fn=tower, miss_budget=40), now_ms=NOW + 1,
        writebuf_capacity=80)
    tr = t_snap.restore_server(d, TS.CachedEmbeddingServer(
        cfg=tc2, tower_fn=tower, miss_budget=40), now_ms=NOW + 1,
        writebuf_capacity=80, device="cpu")
    assert (tr.mode, tr.step, tr.detail) == (jr.mode, jr.step, jr.detail)
    assert tr.mode == "rehash"
    assert_same_image(t_image(tr.state), j_image(jr.state), "m1 -> single")


# ------------------------------------------------- rehash_cache, direct
def _old_table():
    """A 16 x 4 table of 60 inserted keys: write timestamps with ties, a
    quarter of them older than the TTL, and recency bumps on a third."""
    rng = np.random.default_rng(3)
    ids = rng.choice(10_000, 60, replace=False)
    wts = (1000 + rng.integers(0, 8, 60) * 500).astype(np.int32)
    wts[:15] = 10                                 # expired at the clock
    old = JC.init_cache(16, 4, DIM)
    old = JC.insert(old, jkeys(ids), jnp.asarray(feats_np(ids)),
                    now_ms=5000, ttl_ms=HOUR, ts_ms=jnp.asarray(wts))
    res = JC.lookup(old, jkeys(ids), 5000, 100 * HOUR)
    lats = jnp.asarray(np.where(np.arange(60) % 3 == 0, 9000, 0), jnp.int32)
    return JC.touch(old, res.bucket, res.way, lats,
                    live=jnp.asarray(np.arange(60) % 3 == 0))


REHASH_CASES = {   # name: (n_buckets, ways, now, ttl, evict_lru, chunk)
    "grow": (64, 4, 5000, HOUR, None, 16),
    "shrink": (4, 4, 5000, HOUR, None, 16),
    "fewer_ways": (16, 2, 5000, HOUR, None, 7),
    "expired_dropped": (32, 4, 10 + HOUR + 1, HOUR, None, 16),
    "lru_shrink": (4, 4, 5000, HOUR, True, 16),
    "lru_grow_one_chunk": (64, 8, 5000, HOUR, True, 4096),
}


@pytest.mark.parametrize("case", list(REHASH_CASES))
def test_rehash_cache_matches_jax(case):
    """``rehash_cache`` of one table in both packages, in padded chunks
    (several, or one of 4096): the candidate count and every plane of the
    new table, recency included; the old table is left as it was."""
    nb, ways, now, ttl, lru, chunk = REHASH_CASES[case]
    jold = _old_table()
    told = TC.CacheState(*(torch.as_tensor(np.array(x)) for x in jold))
    before = [t.clone() for t in told]
    jnew, jn = j_el.rehash_cache(jold, JC.init_cache(nb, ways, DIM), now,
                                 ttl, evict_lru=lru, chunk=chunk)
    tnew = TC.init_cache(nb, ways, DIM, device="cpu")
    got, tn = t_el.rehash_cache(told, tnew, now, ttl, evict_lru=lru,
                                chunk=chunk, backend="torch")
    assert got is tnew and tn == jn > 0
    for name in jnew._fields:
        assert_exact(getattr(got, name), getattr(jnew, name), name)
    for a, b in zip(told, before):
        assert torch.equal(a, b)


# ----------------------------------------------------------- fail-open
def _corrupt(d):
    shard = sorted(glob.glob(os.path.join(d, "step_00000005", "*.npz")))[0]
    with open(shard, "wb") as f:
        f.write(b"garbage")


def _bitrot(d):
    """One value perturbed inside a valid npz: only the manifest's crc32
    can catch it."""
    shard = sorted(glob.glob(os.path.join(d, "step_00000005", "*.npz")))[0]
    with np.load(shard) as z:
        arrs = {k: z[k].copy() for k in z.files}
    key = max(arrs, key=lambda k: arrs[k].size)
    flat = arrs[key].reshape(-1)
    flat[0] = (np.bitwise_xor(flat[0], 1) if flat.dtype.kind in "iu"
               else flat[0] + 1)
    np.savez(shard, **arrs)


def _torn(d):
    os.makedirs(os.path.join(d, "step_00000009"))
    with open(os.path.join(d, "step_00000009", "manifest.json"), "w") as f:
        f.write("{")


def _foreign(d):
    j_ckpt.save(d, 7, {"x": np.ones(3, np.float32)},
                meta={"schema": "training/1"})


FAIL_OPEN = {  # name: (snapshot, edit of the directory, target, mode, step)
    "missing_dir": ("single", "missing", "single", "cold", None),
    "foreign_schema": ("single", _foreign, "single", "cold", 7),
    "value_dim": ("single", None, "wide", "cold", 5),
    "corrupt_shard": ("single", _corrupt, "single", "cold", 5),
    "bitrot_checksum": ("single", _bitrot, "single", "cold", 5),
    "torn_step_skipped": ("single", _torn, "single", "bitexact", 5),
    "model_count": ("multi", None, "multi_one", "cold", 5),
    "region_count": ("regional", None, "regions_5", "cold", 5),
    "regional_into_multi": ("regional", None, "multi_one", "cold", 5),
}


def _fail_open_targets(s, target):
    if target == "single":
        return s.jsrv, s.tsrv
    if target == "wide":
        jc, tc = cfgs(value_dim=2 * DIM)
        return (JS.CachedEmbeddingServer(cfg=jc, tower_fn=tower,
                                         miss_budget=8),
                TS.CachedEmbeddingServer(cfg=tc, tower_fn=tower,
                                         miss_budget=8))
    if target == "multi_one":
        jc, tc = cfgs()
        return (JS.MultiModelServer(cfgs=(jc,), tower_fn=tower,
                                    miss_budget=8),
                TS.MultiModelServer(cfgs=(tc,), tower_fn=tower,
                                    miss_budget=8, device="cpu"))
    return regional_servers(n_regions=5)


@pytest.mark.parametrize("case", list(FAIL_OPEN))
def test_fail_open_matches_jax(case, request, tmp_path):
    """A missing, foreign, corrupt or bit-rotted snapshot, a value_dim, a
    model-count or a region-count mismatch restores cold in both packages
    at the same step (a torn step is skipped): never an exception, and
    the port's cold state is empty."""
    kind, edit, target, mode, step = FAIL_OPEN[case]
    s = request.getfixturevalue(kind)
    d = str(tmp_path / "snap")
    if edit == "missing":
        d = str(tmp_path / "nope")
    else:
        shutil.copytree(s.jdir, d)
        if edit is not None:
            edit(d)
    if case == "bitrot_checksum":
        for ckpt in (j_ckpt, t_ckpt):
            with pytest.raises(ckpt.ChecksumError):
                ckpt.restore_raw(d, 5)
    jsrv, tsrv = _fail_open_targets(s, target)
    jr = j_snap.restore_server(d, jsrv, now_ms=NOW, writebuf_capacity=64)
    tr = t_snap.restore_server(d, tsrv, now_ms=NOW, writebuf_capacity=64,
                               device="cpu")
    assert (jr.mode, jr.step) == (mode, step)
    assert (tr.mode, tr.step) == (jr.mode, jr.step)
    if mode == "cold":
        assert tr.counters == TCounters()
        tier = tr.state.inner if target == "regions_5" else tr.state
        assert bool((tier.direct.write_ts == TC.TS_EMPTY).all())
        if case == "bitrot_checksum":
            assert "ChecksumError" in tr.detail
    else:
        assert_same_image(t_image(tr.state), j_image(jr.state), case)


# ------------------------------------------- checkpoint cases (test_ft)
def ft_trees():
    """test_ft's tree in each package, plus a NamedTuple and a list."""
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    c = np.ones(5, np.int32)
    tok = np.array([1.5, -2.0], np.float32)
    jt = {"a": a, "b": {"c": c, "d": np.float32(2.5)},
          "n": JBudget(tokens=tok), "l": [np.arange(3, dtype=np.int32), c[:2]]}
    tt = {"l": [torch.arange(3, dtype=torch.int32), torch.as_tensor(c[:2])],
          "b": {"d": torch.tensor(2.5), "c": torch.as_tensor(c)},
          "n": TBudget(tokens=torch.as_tensor(tok)), "a": torch.as_tensor(a)}
    return jt, tt


def test_checkpoint_roundtrip_and_same_format(tmp_path):
    """Save/restore in the port; the manifest equals the one JAX writes
    for the same tree (leaf order, keystr names, dtypes, crc32s, shards);
    each package restores the other's checkpoint."""
    jt, tt = ft_trees()
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    j_ckpt.save(jd, 5, jt)
    t_ckpt.save(td, 5, tt)
    assert manifest(td, 5) == manifest(jd, 5)
    assert list(manifest(td, 5)["leaves"]) == [
        "['a']", "['b']['c']", "['b']['d']", "['l'][0]", "['l'][1]",
        "['n'].tokens"]
    for d in (jd, td):
        out = t_ckpt.restore(d, 5, tt)
        assert [k for k, _ in t_ckpt._leaf_paths(out)] == [
            k for k, _ in t_ckpt._leaf_paths(tt)]
        for (_, x), (_, y) in zip(t_ckpt._leaf_paths(out),
                                  t_ckpt._leaf_paths(tt)):
            assert x.dtype == y.dtype and torch.equal(x, y)
        assert float(out["b"]["d"]) == 2.5
        assert isinstance(out["n"], TBudget)
    like = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(np.shape(x), np.asarray(x).dtype), jt)
    back = j_ckpt.restore(td, 5, like)
    for (_, x), (_, y) in zip(j_leaves(back), j_leaves(jt)):
        assert_exact(x, y)


def test_torn_checkpoint_skipped(tmp_path):
    d = str(tmp_path)
    t_ckpt.save(d, 5, ft_trees()[1])
    os.makedirs(os.path.join(d, "step_00000009"))
    with open(os.path.join(d, "step_00000009", "manifest.json"), "w") as f:
        f.write("{}")
    assert t_ckpt.latest_step(d) == 5 == j_ckpt.latest_step(d)


def test_gc_keeps_last_k_and_orphans(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, ".tmp-deadbeef"))      # a crashed save
    for s in (1, 2, 3, 4):
        t_ckpt.save(d, s, ft_trees()[1])
    assert not glob.glob(os.path.join(d, ".tmp-*"))
    t_ckpt.gc_old(d, keep_last=2)
    assert t_ckpt.latest_step(d) == 4
    assert sorted(int(n.split("_")[1]) for n in os.listdir(d)) == [3, 4]
    t_ckpt.save(d, 5, ft_trees()[1], retain_last_k=1)
    assert os.listdir(d) == ["step_00000005"]


@pytest.mark.parametrize("max_shard_bytes", [100_000, 256 << 20])
def test_row_split_large_leaf(tmp_path, max_shard_bytes):
    """A leaf beyond ``max_shard_bytes`` splits into row ranges, one shard
    each, exactly as JAX splits it, and reassembles (one crc32 a leaf)."""
    big = np.arange(300_000, dtype=np.float32).reshape(300, 1000)
    small = np.arange(7, dtype=np.int32)
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    j_ckpt.save(jd, 1, {"t": big, "s": small},
                max_shard_bytes=max_shard_bytes)
    t_ckpt.save(td, 1, {"t": torch.as_tensor(big),
                        "s": torch.as_tensor(small)},
                max_shard_bytes=max_shard_bytes)
    assert manifest(td, 1) == manifest(jd, 1)
    n_parts = len(manifest(td, 1)["leaves"]["['t']"]["parts"])
    assert n_parts == (12 if max_shard_bytes == 100_000 else 1)
    out = t_ckpt.restore(jd, 1, {"t": torch.empty(300, 1000, device="meta"),
                                 "s": torch.empty(7, dtype=torch.int32,
                                                  device="meta")},
                         device="cpu")
    assert_exact(out["t"], big)
    assert_exact(out["s"], small)


def test_checkpoint_manager(tmp_path):
    """Saves on its cadence, keeps the newest ``keep_last``, resumes the
    latest on the device asked for (the like tree's shapes and dtypes)."""
    d = str(tmp_path)
    m = t_ckpt.CheckpointManager(d, every_steps=2, keep_last=2,
                                 device="cpu")
    like = {"w": torch.zeros(3), "step": torch.zeros((), dtype=torch.int32)}
    assert m.restore_latest(like) == (None, like)
    for step in range(1, 8):
        tree = {"w": torch.full((3,), float(step)),
                "step": torch.tensor(step, dtype=torch.int32)}
        assert (m.maybe_save(step, tree) is None) == (step % 2 == 1)
    assert sorted(os.listdir(d)) == ["step_00000004", "step_00000006"]
    step, out = m.restore_latest(like)
    assert step == 6 and int(out["step"]) == 6
    assert torch.equal(out["w"], torch.full((3,), 6.0))


# ------------------------------------------------- the port's own claims
def test_restore_allocates_new_tensors(single):
    """A restored state shares no tensor with the state that was served
    and snapshotted, so serving it (``jit_serve_many``; on the card a new
    graph keyed on the new addresses) leaves the old state untouched and
    equals the eager ``serve_many`` on a second restore."""
    before = [t.clone() for t in tensors_of(single.tstate)]
    old_ptrs = {t.data_ptr() for t in tensors_of(single.tstate)}
    runs = []
    for jit in (True, False):
        r = t_snap.restore_server(single.tdir, single.tsrv, now_ms=NOW,
                                  writebuf_capacity=80, device="cpu")
        assert r.mode == "bitexact"
        assert not old_ptrs & {t.data_ptr() for t in tensors_of(r.state)}
        ids = np.arange(30, 70).reshape(2, 20)
        run = single.tsrv.jit_serve_many if jit else single.tsrv.serve_many
        st, acc, ys = run(T_EYE, r.state, tkeys(ids),
                          torch.as_tensor(feats_np(ids.reshape(-1))
                                          .reshape(2, 20, DIM)),
                          torch.tensor([NOW + 10, NOW + 20],
                                       dtype=torch.int32))
        runs.append((TS.fetch_counters(acc), ys, tensors_of(st)))
    for a, b in zip(tensors_of(single.tstate), before):
        assert torch.equal(a, b)
    (ca, ya, sa), (cb, yb, sb) = runs
    assert ca == cb
    for a, b in zip(list(ya) + sa, list(yb) + sb):
        assert torch.equal(a, b)


def test_device_work_past_the_fail_open_boundary_raises(single, tmp_path):
    """A rehash whose lookup needs the card (a cuda-backend server over
    CPU tensors) raises out of the restore instead of restoring cold; so
    does a restore into a multi tier with the same mistake."""
    _, tc = cfgs(n_buckets=128)
    srv = TS.CachedEmbeddingServer(cfg=dataclasses.replace(tc,
                                                           backend="cuda"),
                                   tower_fn=tower, miss_budget=8)
    with pytest.raises(ValueError, match="backend='cuda'"):
        t_snap.restore_server(single.jdir, srv, now_ms=NOW, device="cpu")
    msrv = TS.MultiModelServer(cfgs=(dataclasses.replace(
        tc, backend="cuda"),), tower_fn=tower, miss_budget=8, device="cpu")
    with pytest.raises(ValueError, match="backend='cuda'"):
        t_snap.restore_server(single.jdir, msrv, now_ms=NOW, device="cpu")


# ----------------------------------------------------------- the launcher
RESTART_SMALL = dict(pre_steps=40, recovery_steps=20, users=200, batch=32,
                     checkpoint_every=10, n_buckets=64, chunk_steps=10)


def test_run_serving_restart_matches_jax(tmp_path):
    """The kill/restore harness at a small size: every report key equal to
    the reference's (modes, restored steps, recovery curves and tower
    inferences, the parity block, the ledger), apart from ``wall_s``,
    ``workdir`` and the backend's name."""
    jrep = j_launch.run_serving_restart(workdir=str(tmp_path / "j"),
                                        log=lambda s: None, **RESTART_SMALL)
    trep = t_launch.run_serving_restart(workdir=str(tmp_path / "t"),
                                        backend="torch", device="cpu",
                                        log=lambda s: None, **RESTART_SMALL)
    strip = lambda r: {k: v for k, v in r.items()
                       if k not in ("wall_s", "workdir", "backend")}
    assert strip(trep) == strip(jrep)
    assert (trep["backend"], jrep["backend"]) == ("torch", "jnp")
    assert [v["mode"] for v in trep["variants"].values()] == [
        "bitexact", "rehash", "rehash", "cold"]
    assert trep["parity"]["pass"] and trep["torn_step_skipped"]
    assert trep["ledger_continuous"] and trep["warm_vs_cold_gain"] > 0
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j"))


@pytest.mark.parametrize("argv", [
    ["--restart", "--multi"], ["--restart", "--overload"],
    ["--restart", "--no-cache"], ["--restart", "--coalesce"],
    ["--restart", "--chaos", "incident"], ["--restart", "--regions", "2"]])
def test_restart_cli_refusals(argv):
    """The reference's refusals: --restart drives the single-model cache
    tier, and --chaos / --regions are scenarios of their own."""
    with pytest.raises(SystemExit) as e:
        t_launch.main(argv)
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        j_launch_main(argv)
    assert e.value.code == 2


def j_launch_main(argv):
    import sys

    saved = sys.argv
    sys.argv = ["serve", *argv]
    try:
        j_launch.main()
    finally:
        sys.argv = saved


# ---------------------------------------------------------- the copies
def test_mesh_plan_copies_match_original():
    """plan_mesh and elastic_transition over a grid of device counts,
    batches, model-parallel floors and preferred widths."""
    for n in (1, 2, 3, 4, 6, 8, 12, 16, 60, 128, 240, 256):
        for batch in (1, 8, 96, 512, 1000):
            for mp_min in (1, 2, 8):
                for prefer in (1, 4, 16):
                    got = t_el.plan_mesh(n, batch, mp_min, prefer)
                    want = j_el.plan_mesh(n, batch, mp_min, prefer)
                    assert dataclasses.asdict(got) == dataclasses.asdict(
                        want)
                    for now in (n, max(n - 16, 1), 2 * n):
                        tt = t_el.elastic_transition(got, now, batch, mp_min)
                        jt = j_el.elastic_transition(want, now, batch,
                                                     mp_min)
                        assert dataclasses.asdict(tt.pop("new_plan")) == \
                            dataclasses.asdict(jt.pop("new_plan"))
                        assert tt == jt


def test_bfloat16_leaves_are_refused(tmp_path):
    """No snapshot path holds a bfloat16 table, and neither package
    round-trips one: the reference saves it but its restore raises
    (numpy cannot cast the stored bytes back); the port refuses it at
    save (numpy has no bfloat16 without ml_dtypes)."""
    jd = str(tmp_path / "j")
    j_ckpt.save(jd, 1, {"x": jnp.arange(4, dtype=jnp.bfloat16)})
    with pytest.raises(ValueError):
        j_ckpt.restore(jd, 1, {"x": jnp.arange(4, dtype=jnp.bfloat16)})
    with pytest.raises(TypeError):
        t_ckpt.save(str(tmp_path / "t"), 1,
                    {"x": torch.arange(4, dtype=torch.bfloat16)})
