"""repro_torch's model-axis sharding against the JAX package, on the CPU.

The logical-axis rules, specs and meshes are held against the JAX
functions in-process: every rule set on the (1, 1), (4, 2) and (2, 16, 16)
layouts, exactly. Every ``mesh=`` path is held against JAX on a (1, 1) JAX
mesh (the one CPU device builds it). The port's meshes of 2, 4 and 8
shards (all on the CPU) are held against JAX's UNSHARDED functions, and,
where the shard order decides the answer, against JAX's sharded functions
run once in a subprocess with 8 forced host devices (the sharded bag in
float32 and bfloat16 with a -0.0 row, the sharded top-k with planted ties,
the seq-sharded decode with an all-masked shard), which writes one
``.npz``.

Tolerances: specs, ids and every top-k order exact; the sharded bag
float32 atol 1e-5 (``tests/test_distributed.py``'s bar), bfloat16 within
one bfloat16 rounding of each shard's partial and of the sum, the sign of
zero exact; the seq-sharded decode float32 atol 2e-5; towers and the LM at
the suite's tower tolerance.
"""
import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import assert_exact, assert_float, to_np  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.distributed import collectives as JC  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.kernels import ops as JK  # noqa: E402
from repro.launch import mesh as JMESH  # noqa: E402
from repro.models import recsys as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.distributed import collectives as TC  # noqa: E402
from repro_torch.distributed import sharding as TSH  # noqa: E402
from repro_torch.kernels import decode_attention as TDA  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.models import recsys as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUTS = {"(1, 1)": ((1, 1), ("data", "model")),
           "(4, 2)": ((4, 2), ("data", "model")),
           "(2, 16, 16)": ((2, 16, 16), ("pod", "data", "model"))}
BAG_ATOL, DECODE_ATOL = 1e-5, 2e-5
# (B, scatter_batch) on the (4, 2) pin: the batch axes (4) do not divide
# 1, 3, 6; with the scatter 4 x 2 do not divide 4; 4 and 8 split
BAG_BATCHES = [(1, False), (3, False), (6, False), (4, True), (4, False),
               (8, True)]
TOPK = 8
MINUS_ZERO = np.int32(-0x80000000)     # the bits of float32 -0.0


def cpu_mesh(dims=(1, 1), axes=("data", "model")):
    return TM.ModelMesh(dims, axes, ("cpu",) * int(np.prod(dims)))


def jax_like(dims, axes):
    """What the JAX spec functions read of a mesh: its names and sizes."""
    return types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, dims)))


@pytest.fixture(scope="module")
def jmesh():
    """JAX's (1, 1) host mesh, its axes Auto (sharding constraints refuse
    the Explicit axes ``jax.make_mesh`` gives by default)."""
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(
        jax.sharding.AxisType.Auto,) * 2)


# ------------------------------------------------------ the 8-device pin
SUB = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
assert len(jax.devices()) == 8, jax.devices()
from repro.distributed import collectives as C
from repro.models import recsys as R
x = dict(np.load(sys.argv[1]))
mesh = jax.make_mesh((4, 2), ("data", "model"))
BAG_BATCHES = [(int(b), bool(s)) for b, s in x["bag_batches"]]
bag = jax.jit(lambda t, i, s: R.sharded_field_embedding_bag(
    t, i, mesh, scatter_batch=s), static_argnums=2)
t, i = jnp.asarray(x["bag_tables"]), jnp.asarray(x["bag_ids"])
out = {"bag_f32": bag(t, i, False), "bag_f32_scatter": bag(t, i, True),
       "bag_bf16": bag(t.astype(jnp.bfloat16), i, False).astype(jnp.float32),
       "bag_nz": bag(jnp.asarray(x["nz_tables"]), jnp.asarray(x["nz_ids"]),
                     False)}
# the batches the shard_map (psum_scatter) refuses: 1 where it raises
for b, s in BAG_BATCHES:
    try:
        out[f"bag_b{b}_{int(s)}"] = bag(t, i[:b], s)
    except ValueError:
        out[f"bag_b{b}_{int(s)}_refused"] = np.int32(1)
k = int(x["k"])
out["topk_vals"], out["topk_ids"] = jax.jit(
    lambda q, c: C.sharded_topk_scores(q, c, k, mesh))(
    jnp.asarray(x["topk_q"]), jnp.asarray(x["topk_c"]))
for name, axes in (("decode_model", ("model",)),
                   ("decode_all", ("data", "model"))):
    out[name] = jax.jit(lambda q, kk, v, vl: C.seq_sharded_decode_attention(
        q, kk, v, mesh, seq_axes=axes, kv_valid_len=vl))(
        jnp.asarray(x["dec_q"]), jnp.asarray(x["dec_k"]),
        jnp.asarray(x["dec_v"]), jnp.asarray(x["dec_vl"]))
np.savez(sys.argv[2], **{n: np.asarray(v) for n, v in out.items()})
"""


def tie_scores_inputs(rng, b=3, n=512, d=8):
    """Integer-valued queries and candidates (every dot product exact in
    any order, so many exact ties), with planted duplicate and zero
    candidate rows across shards."""
    q = rng.integers(-2, 3, (b, d)).astype(np.float32)
    c = rng.integers(-2, 3, (n, d)).astype(np.float32)
    c[17] = 2 * np.sign(q[0])                  # query 0's best row ...
    c[[5, 70, 200, 300, 450]] = c[17]          # ... six times, 5 shards
    c[[1, 64, 129, 333, 511]] = 0.0            # zero rows
    return q, c


def decode_inputs(rng):
    B, S, Hq, Hkv, hd = 4, 64, 8, 2, 16
    q = rng.standard_normal((B, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    # 10: the second model shard (keys 32..63) and six of the eight
    # (data, model) shards all masked; 0: every shard masked
    vl = np.asarray([10, 64, 33, 0], np.int32)
    return q, k, v, vl


@pytest.fixture(scope="module")
def pin(tmp_path_factory):
    rng = np.random.default_rng(7)
    d = tmp_path_factory.mktemp("pin")
    x = {"bag_tables": rng.standard_normal((5, 64, 8)).astype(np.float32),
         "bag_ids": rng.integers(-1, 64, (16, 5, 3)).astype(np.int32),
         "bag_batches": np.asarray(BAG_BATCHES, np.int32),
         "k": np.int32(TOPK)}
    nz = np.ones((2, 64, 4), np.float32)
    nz[0, 3, 1] = nz[1, 40, 2] = -0.0
    x["nz_tables"] = nz
    x["nz_ids"] = np.asarray([[[3], [40]], [[3], [-1]], [[0], [40]],
                              [[-1], [-1]]] * 2, np.int32)
    x["topk_q"], x["topk_c"] = tie_scores_inputs(rng)
    x["dec_q"], x["dec_k"], x["dec_v"], x["dec_vl"] = decode_inputs(rng)
    np.savez(d / "in.npz", **x)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
               + " --xla_force_host_platform_device_count=8")
    res = subprocess.run([sys.executable, "-c", SUB, str(d / "in.npz"),
                          str(d / "out.npz")], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return x, dict(np.load(d / "out.npz"))


# ------------------------------------------------------------ rules, specs
def test_rule_sets_are_the_reference_rule_sets():
    assert TSH.RULES_BY_FAMILY == JSH.RULES_BY_FAMILY
    assert set(TSH.RULES_BY_FAMILY) == {"lm", "recsys", "gnn"}


def _logical_trees():
    """Every logical-axis tuple the models name, plus names that are no
    rule's and repeated mesh axes."""
    trees = [JT.param_logical_axes(j_config(a, smoke=True)) for a in
             ("tinyllama-1.1b", "granite-moe-1b-a400m", "arctic-480b")]
    trees.append(tuple(JT.kv_cache_logical_axes()))
    extra = [("batch", "seq", "heads", None), ("batch", "seq", "embed"),
             ("batch", None), ("batch", "ffn"), ("batch", "seq", None),
             ("edges", None), ("nodes", None), (None, None),
             ("candidates", "embed"), ("rows", "embed"), ("heads", "ffn"),
             ("expert", "expert_ffn", "kv_seq"), ("batch", "nodes"),
             ("unknown", "vocab")]
    out = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, tuple) and all(isinstance(e, tuple) for e in t):
            for v in t:
                walk(v)
        else:
            out.append(t)
    for t in trees:
        walk(t)
    return out + extra


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("family", ["lm", "recsys", "gnn"])
def test_logical_to_spec_matches_jax(family, layout):
    dims, axes = LAYOUTS[layout]
    rules = TSH.RULES_BY_FAMILY[family]
    for lg in _logical_trees():
        got = TSH.logical_to_spec(lg, rules, axes)
        want = JSH.logical_to_spec(lg, JSH.RULES_BY_FAMILY[family], axes)
        assert isinstance(got, TSH.Spec)
        assert tuple(got) == tuple(want), (lg, got, want)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tree_spec_and_sharding_match_jax(layout):
    dims, axes = LAYOUTS[layout]
    mesh = cpu_mesh(dims, axes)
    for arch in ("tinyllama-1.1b", "granite-moe-1b-a400m"):
        tl = TT.param_logical_axes(t_config(arch))
        jl = JT.param_logical_axes(j_config(arch))
        got = TSH.tree_spec(tl, "lm", mesh)
        want = JSH.tree_spec(jl, "lm", jax_like(dims, axes))
        flat = lambda t: {k: (flat(v) if isinstance(v, dict) else tuple(v))
                          for k, v in t.items()}
        assert flat(got) == flat(want)
        placed = TSH.tree_sharding(tl, "lm", mesh)
        assert placed["layers"]["wq"] == (mesh, got["layers"]["wq"])
    kv = TSH.tree_spec(TT.kv_cache_logical_axes(), "lm", mesh)
    assert isinstance(kv, TT.KVCache)
    jkv = JT.kv_cache_logical_axes()
    assert tuple(kv.k) == tuple(JSH.logical_to_spec(
        jkv.k, JSH.LM_RULES, axes))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_divisible_or_replicate_matches_jax(layout):
    """Divisible and indivisible dims (56 heads on 16, 3 rows on 2, 1
    batch row on a pod of 2), specs shorter than the shape."""
    dims, axes = LAYOUTS[layout]
    mesh, jm = cpu_mesh(dims, axes), jax_like(dims, axes)
    cases = [(("batch", "seq", "heads", None), (1, 7, 56, 64)),
             (("batch", "seq", "heads", None), (64, 8, 32, 8)),
             (("vocab", "embed"), (32000, 2048)), (("rows",), (3, 8)),
             (("batch", "ffn"), (6, 1024)), (("batch",), (512, 4, 4))]
    for family in ("lm", "recsys"):
        for lg, shape in cases:
            spec = TSH.logical_to_spec(lg, TSH.RULES_BY_FAMILY[family], axes)
            jspec = JSH.logical_to_spec(lg, JSH.RULES_BY_FAMILY[family],
                                        axes)
            got = TSH.divisible_or_replicate(spec, shape, mesh)
            want = JSH.divisible_or_replicate(jspec, shape, jm)
            assert tuple(got) == tuple(want), (family, lg, shape, got, want)


def test_constrain_returns_its_input_and_checks_it(jmesh):
    x = torch.arange(24.0).reshape(4, 6)
    mesh = cpu_mesh((4, 2))
    assert TSH.constrain(x, ("batch", "ffn"), "recsys", mesh) is x
    assert TSH.constrain(x, ("batch", "ffn"), "recsys", None) is x
    with pytest.raises(ValueError, match="logical axes"):
        TSH.constrain(x, ("batch", "seq", "ffn"), "recsys", mesh)
    with pytest.raises(KeyError):
        TSH.constrain(x, ("batch",), "cnn", mesh)


# ------------------------------------------------------------------ meshes
@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12])
def test_make_host_mesh_picks_the_reference_model_axis(n):
    mesh = TM.make_host_mesh(devices=["cpu"] * n)
    model = next(m for m in (4, 2, 1) if n % m == 0)
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": n // model, "model": model}
    assert mesh.size == len(mesh.devices) == n
    assert mesh.device() == torch.device("cpu")


def test_make_host_mesh_on_the_one_jax_device_is_the_same_shape():
    jm = JMESH.make_host_mesh()
    tm = TM.make_host_mesh(devices=["cpu"] * len(jax.devices()))
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.shape == dict(jm.shape)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_make_production_mesh_shapes_and_refusals(multi_pod):
    dims, axes = LAYOUTS["(2, 16, 16)" if multi_pod else "(4, 2)"]
    if not multi_pod:
        dims = (16, 16)
    n = int(np.prod(dims))
    mesh = TM.make_production_mesh(multi_pod=multi_pod,
                                   devices=["cpu"] * (n + 3))
    assert mesh.dims == dims and mesh.axis_names == axes
    assert mesh.size == n
    with pytest.raises(ValueError, match=f"needs {n} devices"):
        TM.make_production_mesh(multi_pod=multi_pod,
                                devices=["cpu"] * (n - 1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card|none is"):
            TM.make_production_mesh(multi_pod=multi_pod)
        with pytest.raises(RuntimeError, match="none is"):
            TM.make_host_mesh()


def test_a_mesh_over_distinct_devices_is_refused_everywhere():
    mesh = TM.ModelMesh((1, 2), ("data", "model"), ("cpu", "meta"))
    x = torch.zeros(4, 6)
    with pytest.raises(NotImplementedError, match="distinct devices"):
        TSH.constrain(x, ("batch", None), "recsys", mesh)
    with pytest.raises(NotImplementedError, match="distinct devices"):
        TR.sharded_field_embedding_bag(torch.zeros(2, 8, 4),
                                       torch.zeros(3, 2, 1, dtype=torch.int32),
                                       mesh, impl="torch")
    with pytest.raises(NotImplementedError, match="distinct devices"):
        TC.sharded_topk_scores(torch.zeros(2, 4), torch.zeros(8, 4), 2, mesh)
    with pytest.raises(NotImplementedError, match="distinct devices"):
        TC.seq_sharded_decode_attention(
            torch.zeros(1, 2, 8), torch.zeros(1, 8, 1, 8),
            torch.zeros(1, 8, 1, 8), mesh, backend="torch")
    with pytest.raises(ValueError, match="devices for a mesh"):
        TM.ModelMesh((2, 2), ("data", "model"), ("cpu",) * 3)


# ------------------------------------------------------------------ top-k
@pytest.mark.parametrize("k", [1, 5, 8, 40, 300])
def test_top_k_matches_jax_under_ties(k, rng):
    """Few distinct scores: ties inside the top k and across its
    boundary, and rows with none; k = N takes every score."""
    scores = rng.integers(-3, 4, (6, 300)).astype(np.float32)
    scores[0] = 1.0                                # one value everywhere
    scores[1] = rng.permutation(300).astype(np.float32)   # no ties
    scores[2, 100:] = scores[2].max()              # the top tied late
    got_v, got_i = TC.top_k(torch.as_tensor(scores), k)
    want_v, want_i = jax.lax.top_k(jnp.asarray(scores), k)
    assert_exact(got_i, np.asarray(want_i).astype(np.int64))
    assert_exact(got_v, want_v)


@pytest.mark.parametrize("arch", ["bst", "mind"])
def test_retrieval_step_returns_jax_ids_in_order_under_ties(arch, rng):
    """Duplicate and zero candidate rows across the k boundary, and
    integer-valued queries (exact scores): ids and order are
    ``jax.lax.top_k``'s, MIND's max over interests included."""
    jcfg, tcfg = j_config(arch, smoke=True), t_config(arch, smoke=True)
    d = tcfg.user_embed_dim if arch == "mind" else tcfg.embed_dim
    q = rng.integers(-2, 3, (4, d)).astype(np.float32)
    cands = rng.integers(-1, 2, (500, tcfg.embed_dim)).astype(np.float32)
    cands[::7] = cands[3]
    cands[1::11] = 0.0
    want_v, want_i = JR.retrieval_step(jnp.asarray(q), jnp.asarray(cands),
                                       jcfg, k_top=TOPK * 4)
    got_v, got_i = TR.retrieval_step(torch.as_tensor(q),
                                     torch.as_tensor(cands), tcfg,
                                     k_top=TOPK * 4)
    assert got_i.dtype == torch.int32
    assert_exact(got_i, want_i)
    assert_exact(got_v, want_v)


@pytest.mark.parametrize("dims", [(1, 1), (1, 2), (4, 2), (2, 4)])
def test_sharded_topk_matches_dense_values(dims, pin):
    """Every shard count gives the dense top-k's values; at (4, 2) the
    ids are JAX's sharded ones, ties resolved by its gather order
    (model-major blocks, data-major id offsets)."""
    x, out = pin
    q, c = x["topk_q"], x["topk_c"]
    vals, ids = TC.sharded_topk_scores(torch.as_tensor(q),
                                       torch.as_tensor(c), TOPK,
                                       cpu_mesh(dims))
    dense_v, dense_i = jax.lax.top_k(jnp.asarray(q @ c.T), TOPK)
    assert_exact(vals, dense_v)
    np.testing.assert_array_equal((q @ c.T)[np.arange(3)[:, None],
                                            to_np(ids)], to_np(vals))
    if dims == (4, 2):
        assert_exact(ids, out["topk_ids"])
        assert_exact(vals, out["topk_vals"])
        # the trap: concatenating data-major would pick other ids
        assert not np.array_equal(to_np(ids), np.asarray(dense_i))
    if dims == (1, 1):
        assert_exact(ids, dense_i)


def test_retrieval_step_on_a_mesh_matches_jax(jmesh, rng):
    jcfg, tcfg = j_config("bst", smoke=True), t_config("bst", smoke=True)
    q, c = tie_scores_inputs(rng, d=tcfg.embed_dim)
    want = JR.retrieval_step(jnp.asarray(q), jnp.asarray(c), jcfg,
                             mesh=jmesh, k_top=TOPK)
    got = TR.retrieval_step(torch.as_tensor(q), torch.as_tensor(c), tcfg,
                            k_top=TOPK, mesh=cpu_mesh())
    for g, w in zip(got, want):
        assert_exact(g, w)
    vals, ids = TR.retrieval_step(torch.as_tensor(q), torch.as_tensor(c),
                                  tcfg, k_top=TOPK, mesh=cpu_mesh((2, 2)))
    assert_exact(vals, want[0])


# ------------------------------------------------------------- the bag
def _bag_l1(tables, ids):
    """sum over a bag's valid ids of |row|: the scale of its rounding."""
    rows = np.abs(tables)[np.arange(tables.shape[0])[None, :, None],
                          np.maximum(ids, 0)]
    return np.where(ids[..., None] >= 0, rows, 0).sum(axis=2)


@pytest.mark.parametrize("dims", [(1, 1), (1, 2), (1, 4), (4, 2)])
def test_sharded_bag_matches_jax_unsharded_float32(dims, pin):
    x, out = pin
    t, i = x["bag_tables"], x["bag_ids"]
    want = JR.field_embedding_bag(jnp.asarray(t), jnp.asarray(i))
    for scatter in (False, True):
        got = TR.sharded_field_embedding_bag(
            torch.as_tensor(t), torch.as_tensor(i), cpu_mesh(dims),
            scatter_batch=scatter, impl="torch")
        assert got.dtype == torch.float32
        assert_float(got, want, f"{dims} scatter={scatter}", atol=BAG_ATOL,
                     rtol=0)
    if dims == (4, 2):
        assert_float(got, out["bag_f32"], atol=BAG_ATOL, rtol=0)
        assert_float(got, out["bag_f32_scatter"], atol=BAG_ATOL, rtol=0)


@pytest.mark.parametrize("dims", [(1, 1), (1, 2), (1, 4), (4, 2)])
def test_sharded_bag_bfloat16_within_a_rounding_of_each_partial(dims, pin):
    x, out = pin
    t, i = x["bag_tables"], x["bag_ids"]
    tb = jnp.asarray(t).astype(jnp.bfloat16)
    t32 = np.asarray(tb, np.float32)
    want = np.asarray(JR.field_embedding_bag(tb, jnp.asarray(i)), np.float32)
    got = TR.sharded_field_embedding_bag(
        torch.as_tensor(t32).to(torch.bfloat16), torch.as_tensor(i),
        cpu_mesh(dims), impl="torch")
    assert got.dtype == torch.bfloat16
    bound = 3 * 2.0 ** -8 * _bag_l1(t32, i) + 1e-6
    err = np.abs(to_np(got.float()) - want)
    assert (err <= bound).all(), float((err - bound).max())
    if dims == (4, 2):
        err = np.abs(to_np(got.float()) - out["bag_bf16"])
        assert (err <= bound).all()


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_bag_reads_minus_zero_back_plus_zero(n, pin):
    """A -0.0 element read alone comes back +0.0 at every shard count.
    At two shards or more that is the reference's psum (pinned at its
    (4, 2) mesh: two row shards); at one, the port's bag sums from +0.0
    as the Pallas kernel does, where the reference's jnp bag keeps the
    sign (a difference inside the reference)."""
    x, out = pin
    got = TR.sharded_field_embedding_bag(
        torch.as_tensor(x["nz_tables"]), torch.as_tensor(x["nz_ids"]),
        cpu_mesh((1, n)), impl="torch")
    bits = to_np(got).view(np.int32)
    assert (bits != MINUS_ZERO).all()
    assert_exact(bits, out["bag_nz"].view(np.int32))
    jnp_bag = np.asarray(JR.field_embedding_bag(
        jnp.asarray(x["nz_tables"]), jnp.asarray(x["nz_ids"])))
    assert jnp_bag.view(np.int32)[0, 0, 1] == MINUS_ZERO
    kernel = np.asarray(JK.embedding_bag(jnp.asarray(x["nz_tables"][0]),
                                         jnp.asarray(x["nz_ids"][:, 0])))
    assert_exact(bits[:, 0], kernel.view(np.int32))


@pytest.mark.parametrize("b,scatter", BAG_BATCHES,
                         ids=[f"B{b}{'-scatter' if s else ''}"
                              for b, s in BAG_BATCHES])
def test_sharded_bag_refuses_the_batches_the_reference_refuses(b, scatter,
                                                               pin):
    """Where the reference's shard_map (or its tiled psum_scatter)
    raises on the (4, 2) mesh, the port raises and names B and the
    divisor; where it returns, the port's bags are its bags bit for bit."""
    x, out = pin
    tables = torch.tensor(x["bag_tables"])
    ids = torch.tensor(x["bag_ids"][:b])
    mesh = cpu_mesh((4, 2))
    key = f"bag_b{b}_{int(scatter)}"
    if key + "_refused" in out:
        split = 4 * 2 if scatter else 4
        with pytest.raises(ValueError, match=f"batch {b} .*{split} shards"):
            TR.sharded_field_embedding_bag(tables, ids, mesh,
                                           scatter_batch=scatter,
                                           impl="torch")
        return
    got = TR.sharded_field_embedding_bag(tables, ids, mesh,
                                         scatter_batch=scatter, impl="torch")
    assert_exact(to_np(got).view(np.int32), out[key].view(np.int32))


def test_sharded_bag_refusals():
    mesh = cpu_mesh((1, 3))
    with pytest.raises(ValueError, match="do not split"):
        TR.sharded_field_embedding_bag(torch.zeros(2, 8, 4),
                                       torch.zeros(3, 2, 1, dtype=torch.int32),
                                       mesh, impl="torch")


# ------------------------------------------------------------ recsys towers
def _tower(arch, seed=3, **kw):
    jcfg = dataclasses.replace(j_config(arch, smoke=True), **kw)
    tcfg = dataclasses.replace(t_config(arch, smoke=True), **kw)
    params = JR.init_params(jax.random.PRNGKey(seed), jcfg)
    model = TR.load_jax_params(jax.tree_util.tree_map(np.asarray, params),
                               device="cpu")
    return jcfg, tcfg, params, model


def _feats(cfg, rng, batch=8):
    if cfg.arch_id.startswith("wide-deep"):
        ids = rng.integers(-1, cfg.vocab, (batch, cfg.n_sparse,
                                           cfg.nnz_per_field))
        return {"sparse_ids": ids.astype(np.int32)}
    seq = rng.integers(0, cfg.vocab, (batch, cfg.seq_len))
    seq[:, :2] = -1
    return {"seq": seq.astype(np.int32),
            "target": rng.integers(0, cfg.vocab, batch).astype(np.int32)}


@pytest.mark.parametrize("scatter", [False, True])
def test_wide_deep_on_meshes_matches_jax(scatter, jmesh, rng):
    """The tower and the score on JAX's (1, 1) mesh, and the port's
    (1, 2), (2, 2) and (1, 4) meshes against JAX unsharded."""
    jcfg, tcfg, params, model = _tower("wide-deep", serve_scatter=scatter)
    f = _feats(tcfg, rng)
    jf = {k: jnp.asarray(v) for k, v in f.items()}
    tf = {k: torch.as_tensor(v) for k, v in f.items()}
    want, tower, flat = jax.jit(lambda p, f: (
        JR.wide_deep_score(p, f, jcfg, mesh=jmesh),
        JR.wide_deep_tower(p, f, jcfg, jmesh),
        JR.wide_deep_score(p, f, jcfg)))(params, jf)
    got = TR.wide_deep_score(model, tf, tcfg, impl="torch", mesh=cpu_mesh())
    assert_float(got, want, "score (1, 1)")
    assert_float(TR.tower_step(model, tf, tcfg, "torch", mesh=cpu_mesh()),
                 tower, "tower")
    for dims in ((1, 2), (2, 2), (1, 4)):
        got = TR.wide_deep_score(model, tf, tcfg, impl="torch",
                                 mesh=cpu_mesh(dims))
        assert_float(got, flat, f"score {dims}")


@pytest.mark.parametrize("arch", ["sasrec", "bst", "mind"])
def test_sequence_towers_on_a_mesh_match_jax(arch, jmesh, rng):
    jcfg, tcfg, params, model = _tower(arch)
    f = _feats(tcfg, rng)
    jf = {k: jnp.asarray(v) for k, v in f.items()}
    tf = {k: torch.as_tensor(v) for k, v in f.items()}
    want = jax.jit(lambda p, f: JR.tower_step(p, f, jcfg, mesh=jmesh))(
        params, jf)
    assert_float(TR.tower_step(model, tf, tcfg, "torch", mesh=cpu_mesh()),
                 want, "tower")
    assert_float(TR.tower_step(model, tf, tcfg, "torch",
                               mesh=cpu_mesh((2, 2))), want, "tower (2, 2)")
    if arch == "bst":
        assert_float(TR.bst_score(model, tf, tcfg, "torch", mesh=cpu_mesh()),
                     jax.jit(lambda p, f: JR.bst_score(p, f, jcfg, jmesh))(
                         params, jf), "score")


@pytest.mark.parametrize("arch", ["wide-deep", "mind"])
def test_train_step_on_a_mesh_matches_jax(arch, jmesh):
    """loss_fn and one AdamW step of make_train_step on meshes: JAX's
    (1, 1) mesh against the port's (1, 2) (Wide&Deep's bag row-sharded
    under autograd into the one tables tensor)."""
    from repro.launch import train as j_train
    from repro_torch.launch import train as t_train

    jcfg, tcfg, params, model = _tower(arch, seed=0)
    b = next(j_train.recsys_batches(jcfg, 16))
    tb = next(t_train.recsys_batches(tcfg, 16, device="cpu"))
    mesh = cpu_mesh((1, 2))
    jo, to = JO.for_config(jcfg), TO.for_config(tcfg)
    tree = TO.trainable(TR.param_tree(model))
    jl = jax.jit(lambda p, b: JR.loss_fn(p, b, jcfg, jmesh))(params, b)
    tl = TR.loss_fn(TR.bind_tree(model, tree), tb, tcfg, mesh=mesh)
    assert_float(tl, jl, "loss", atol=0, rtol=1e-5)
    jstate, tstate = jo.init(params), to.init(tree)
    params, jstate, jm = jax.jit(JR.make_train_step(jcfg, jo, jmesh))(
        params, jstate, b)
    tables = tree["tables" if arch == "wide-deep" else "item_emb"]
    tree, tstate, tm = TR.make_train_step(tcfg, to, mesh)(tree, tstate, tb)
    assert tree["tables" if arch == "wide-deep" else "item_emb"] is tables
    assert_float(tm["loss"], jm["loss"], "step loss", atol=0, rtol=1e-5)
    key = "tables" if arch == "wide-deep" else "item_emb"
    assert_float(tree[key], params[key], "trained table", atol=1e-6,
                 rtol=1e-5)


@pytest.mark.parametrize("arch", ["wide-deep", "sasrec", "bst", "mind"])
def test_recsys_abstract_params_match_jax(arch):
    jcfg, tcfg = j_config(arch), t_config(arch)
    want = JR.abstract_params(jcfg)
    got = TR.abstract_params(tcfg)
    jl = jax.tree_util.tree_leaves_with_path(want)
    tl = TO.tree_leaves(got)
    assert len(jl) == len(tl)
    for (path, w), g in zip(jl, tl):
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype)[6:] == str(w.dtype), path


def test_sharded_bag_config_defaults_match_jax():
    for arch in ("wide-deep", "sasrec"):
        assert t_config(arch).sharded_bag is j_config(arch).sharded_bag
        assert t_config(arch).serve_scatter is j_config(arch).serve_scatter


# ------------------------------------------------------- seq-sharded decode
@pytest.mark.parametrize("case", ["(1, 1)", "(1, 2)", "(1, 4)",
                                  "(4, 2) model", "(4, 2) data+model"])
def test_seq_sharded_decode_matches_jax(case, pin):
    """torch backend against JAX's decode_attention_local (an all-masked
    shard; valid_len 0 gives the mean of v on both) and, at (4, 2),
    against JAX's sharded function. The cuda backend's plain partials
    give the same but zeros at valid_len 0, as the kernel."""
    x, out = pin
    q, k, v, vl = (torch.as_tensor(x[n]) for n in
                   ("dec_q", "dec_k", "dec_v", "dec_vl"))
    want = JC.decode_attention_local(*(jnp.asarray(x[n]) for n in
                                       ("dec_q", "dec_k", "dec_v")),
                                     kv_valid_len=jnp.asarray(x["dec_vl"]))
    dims = (4, 2) if case.startswith("(4, 2)") else eval(case)
    axes = ("data", "model") if "data+" in case else ("model",)
    mesh = cpu_mesh(dims)
    got = TC.seq_sharded_decode_attention(q, k, v, mesh, seq_axes=axes,
                                          kv_valid_len=vl, backend="torch")
    assert_float(got, want, case, atol=DECODE_ATOL, rtol=0)
    if dims == (4, 2):
        name = "decode_all" if "data+" in case else "decode_model"
        assert_float(got, out[name], case, atol=DECODE_ATOL, rtol=0)
    card = TC.seq_sharded_decode_attention(q, k, v, mesh, seq_axes=axes,
                                           kv_valid_len=vl, backend="cuda")
    assert_float(card[:3], want[:3], case, atol=DECODE_ATOL, rtol=0)
    assert not card[3].any()
    with pytest.raises(ValueError, match="backend"):
        TC.seq_sharded_decode_attention(q, k, v, mesh, backend="pallas")


def test_seq_sharded_decode_refuses_an_indivisible_cache():
    with pytest.raises(ValueError, match="sequence shards"):
        TC.seq_sharded_decode_attention(
            torch.zeros(1, 2, 8), torch.zeros(1, 10, 1, 8),
            torch.zeros(1, 10, 1, 8), cpu_mesh((1, 4)), backend="torch")


def test_batch_shard_axes_follow_the_reference_rule():
    mesh = cpu_mesh((2, 4, 2), ("pod", "data", "model"))
    assert TC.batch_shard_axes(mesh, ("model",), None, 16) == ("pod", "data")
    assert TC.batch_shard_axes(mesh, ("model",), None, 2) == ("pod",)
    assert TC.batch_shard_axes(mesh, ("model",), None, 1) == ()
    assert TC.batch_shard_axes(mesh, ("model",), ("data",), 4) == ("data",)


@pytest.mark.parametrize("n_split", [1, 3])
def test_decode_partials_plain_version_against_jax_partials(n_split, rng):
    """The partials entry's plain version on a key range at an offset:
    a live range equals JAX's _local_decode_partials over it; an empty
    range is m = -1e30 exactly, l = 0, acc = 0 (JAX: l = its length)."""
    B, S, Hq, Hkv, hd, off = 3, 128, 8, 2, 16, 64
    q = rng.standard_normal((B, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    vl = np.asarray([40, 100, 192], np.int32)
    n, split_len = TDA.splits_of(S, n_split)
    m, l, acc = TDA.decode_attention_partials(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        torch.as_tensor(vl), off, n_split=n_split)
    assert m.shape == (n, B, Hq) and acc.shape == (n, B, Hq, hd)
    for i in range(n):
        lo, hi = i * split_len, min((i + 1) * split_len, S)
        pos = off + np.arange(lo, hi)
        jm, jl, jacc = JC._local_decode_partials(
            jnp.asarray(q), jnp.asarray(k[:, lo:hi]), jnp.asarray(v[:, lo:hi]),
            kv_len_mask=jnp.asarray(pos[None, :] < vl[:, None]))
        live = vl > off + lo
        assert_float(m[i][live], np.asarray(jm)[live], atol=1e-5, rtol=0)
        assert_float(l[i][live], np.asarray(jl)[live], atol=1e-5, rtol=1e-5)
        assert_float(acc[i][live], np.asarray(jacc)[live], atol=1e-4,
                     rtol=1e-5)
        assert (to_np(m[i][~live]) == np.float32(-1e30)).all()
        assert not l[i][~live].any() and not acc[i][~live].any()
        assert (np.asarray(jl)[~live] == hi - lo).all()


# ------------------------------------------------------------ transformer
@pytest.fixture(scope="module")
def lm():
    jcfg = dataclasses.replace(j_config("tinyllama-1.1b", smoke=True),
                               dtype="float32")
    tcfg = dataclasses.replace(t_config("tinyllama-1.1b", smoke=True),
                               dtype="float32")
    params = JT.init_params(jax.random.PRNGKey(1), jcfg)
    model = TT.load_jax_params(jax.tree_util.tree_map(np.asarray, params),
                               tcfg, device="cpu")
    return jcfg, tcfg, params, model


def test_lm_forward_prefill_and_decode_on_meshes_match_jax(lm, jmesh):
    """forward_hidden, user_tower_step, prefill_step and three decode
    steps: JAX on its (1, 1) mesh against the port on (1, 1), and the
    port's decode sequence-sharded over 2 and 4 shards."""
    jcfg, tcfg, params, model = lm
    rng = np.random.default_rng(2)
    tok = rng.integers(0, tcfg.vocab, (2, 16)).astype(np.int32)
    jt, tt = jnp.asarray(tok), torch.as_tensor(tok)
    jx, ju, (jl, jc) = jax.jit(lambda p, t: (
        JT.forward_hidden(p, t, jcfg, jmesh)[0],
        JT.user_tower_step(p, t, jcfg, jmesh),
        JT.prefill_step(p, t, jcfg, jmesh)))(params, jt)
    assert_float(TT.forward_hidden(model, tt, tcfg, "torch",
                                   mesh=cpu_mesh()), jx, "hidden")
    assert_float(TT.user_tower_step(model, tt, tcfg, "torch",
                                    mesh=cpu_mesh()), ju, "user tower")
    # the reference's cache is as long as the prompt: pad both to 32
    pad = lambda a: jnp.pad(a, ((0, 0), (0, 0), (0, 16), (0, 0), (0, 0)))
    jcache = JT.KVCache(pad(jc.k), pad(jc.v), jc.length)
    jdecode = jax.jit(lambda p, c, t: JT.decode_step(p, c, t, jcfg, jmesh))
    toks, logits = [np.array(jnp.argmax(jl, -1), np.int32)], []
    for _ in range(3):
        jlog, jcache = jdecode(params, jcache, jnp.asarray(toks[-1]))
        logits.append(jlog)
        toks.append(np.array(jnp.argmax(jlog, -1), np.int32))
    for dims in ((1, 1), (1, 2), (1, 4)):
        mesh = cpu_mesh(dims)
        tl, tc = TT.prefill_step(model, tt, tcfg, "torch", max_seq=32,
                                 mesh=mesh)
        assert_float(tl, jl, f"prefill {dims}")
        for step, jlog in enumerate(logits):
            tlog, tc = TT.decode_step(model, tc, torch.as_tensor(toks[step]),
                                      tcfg, "torch", mesh=mesh)
            assert_float(tlog, jlog, f"decode {dims} step {step}")


def test_lm_loss_and_train_step_on_a_mesh_match_jax(lm, jmesh):
    jcfg, tcfg, params, model = lm
    rng = np.random.default_rng(3)
    tok = rng.integers(0, tcfg.vocab, (2, 17)).astype(np.int32)
    b = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    jloss, _ = jax.jit(lambda p, t, lab: JT.lm_loss(p, t, lab, jcfg, jmesh))(
        params, jnp.asarray(b["tokens"]), jnp.asarray(b["labels"]))
    tloss, _ = TT.lm_loss(model, torch.as_tensor(b["tokens"]),
                          torch.as_tensor(b["labels"]), tcfg, mesh=cpu_mesh())
    assert_float(tloss, jloss, "loss", atol=0, rtol=1e-5)
    jo, to = JO.for_config(jcfg), TO.for_config(tcfg)
    js = JT.TrainState(params, jo.init(params), jnp.int32(0))
    tree = TT.param_tree(TT.load_jax_params(
        jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu"))
    ts = TT.TrainState(tree, to.init(tree), torch.zeros((), dtype=torch.int32))
    js, jm = jax.jit(JT.make_train_step(jcfg, jo, jmesh))(
        js, {k: jnp.asarray(v) for k, v in b.items()})
    ts, tm = TT.make_train_step(tcfg, to, mesh=cpu_mesh((2, 2)))(
        ts, {k: torch.as_tensor(v) for k, v in b.items()})
    assert_float(tm["loss"], jm["loss"], "step loss", atol=0, rtol=1e-5)
    assert_float(tm["grad_norm"], jm["grad_norm"], "grad norm", atol=0,
                 rtol=1e-4)


def test_embed_tokens_sign_of_zero_against_the_one_hot_form(lm, jmesh):
    """The one difference of the gather from the reference's one-hot
    matmul under a mesh: a stored -0.0 reads back +0.0 there and keeps
    its sign here; every other bit is equal."""
    jcfg, tcfg, params, model = lm
    emb = np.asarray(params["embed"]).copy()
    emb[5, 3] = -0.0
    jp = dict(params, embed=jnp.asarray(emb))
    with torch.no_grad():
        model.embed[5, 3] = -0.0
    tok = np.asarray([[5, 6, 5]], np.int32)
    want = np.array(JT._embed_tokens(jp, jnp.asarray(tok), jcfg, jmesh))
    got = to_np(TT._embed_tokens(model, torch.as_tensor(tok)))
    assert want.view(np.int32)[0, 0, 3] == 0
    assert got.view(np.int32)[0, 0, 3] == MINUS_ZERO
    want.view(np.int32)[0, [0, 2], 3] = MINUS_ZERO
    assert_exact(got.view(np.int32), want.view(np.int32))
    with torch.no_grad():
        model.embed[5, 3] = float(np.asarray(params["embed"])[5, 3])


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "granite-moe-1b-a400m",
                                  "arctic-480b"])
def test_lm_logical_axes_and_abstract_params_match_jax(arch):
    jcfg, tcfg = j_config(arch), t_config(arch)
    assert TT.param_logical_axes(tcfg) == JT.param_logical_axes(jcfg)
    assert tuple(TT.kv_cache_logical_axes()) == tuple(
        JT.kv_cache_logical_axes())
    want = JT.abstract_params(jcfg)
    got = TT.abstract_params(tcfg)
    jl = jax.tree_util.tree_leaves_with_path(want)
    tl = TO.tree_leaves(got)
    assert len(jl) == len(tl)
    for (path, w), g in zip(jl, tl):
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype)[6:] == str(w.dtype), path
    specs = TT._param_shardings(tcfg, got, cpu_mesh((16, 16)))
    jspecs = JSH.tree_spec(JT.param_logical_axes(jcfg), "lm",
                           jax_like((16, 16), ("data", "model")))
    wq = JSH.divisible_or_replicate(jspecs["layers"]["wq"],
                                    want["layers"]["wq"].shape,
                                    jax_like((16, 16), ("data", "model")))
    assert tuple(specs["layers"]["wq"].spec) == tuple(wq)
