"""repro_torch's GNN (GIN-TU) against the JAX package, on the CPU.

The configs, the numpy sampler copy and ``partition_edges`` are held to
the reference exactly; the GIN forward in its three regimes (full,
sampled, batched), both aggregators and the padding contract, the
edge-cut partitioned forward on (4, 2) and (8,) meshes, and the train
step at 1 and 2 steps from the same carried weights, in float32 at atol
1e-4 (``tests/test_distributed.py``'s bar for the partitioned forward);
losses at rtol 1e-5. The launcher trains ``--arch gin-tu`` on the CPU and
resumes from its checkpoint.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import assert_exact, assert_float, to_np  # noqa: E402
from repro import configs as j_configs  # noqa: E402
from repro.launch import train as j_train  # noqa: E402
from repro.models import gnn as JG  # noqa: E402
from repro.models import sampler as JS  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.ft import checkpoint as t_ckpt  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import gnn as TG  # noqa: E402
from repro_torch.models import sampler as TS  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402

GIN_ATOL = 1e-4
LOSS_RTOL = 1e-5


def cpu_mesh(dims, axes):
    return TM.ModelMesh(dims, axes, ("cpu",) * int(np.prod(dims)))


def smoke(**kw):
    return (dataclasses.replace(j_configs.get_config("gin-tu", smoke=True),
                                **kw),
            dataclasses.replace(t_configs.get_config("gin-tu", smoke=True),
                                **kw))


def gin(jcfg, d_feat, seed=0):
    params = JG.init_params(jax.random.PRNGKey(seed), jcfg, d_feat)
    model = TG.load_jax_params(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return params, model


def both_graphs(feats, s, r, graph_ids=None):
    j = JG.Graph(jnp.asarray(feats), jnp.asarray(s), jnp.asarray(r),
                 None if graph_ids is None else jnp.asarray(graph_ids))
    t = TG.Graph(torch.as_tensor(feats), torch.as_tensor(s),
                 torch.as_tensor(r),
                 None if graph_ids is None else torch.as_tensor(graph_ids))
    return j, t


# ----------------------------------------------------------------- configs
def test_gnn_configs_shapes_and_cells_match_reference():
    for smoke_ in (False, True):
        assert dataclasses.asdict(t_configs.get_config(
            "gin-tu", smoke=smoke_)) == dataclasses.asdict(
            j_configs.get_config("gin-tu", smoke=smoke_))
    cfg = t_configs.get_config("gin-tu")
    assert cfg.param_count(1433) == j_configs.get_config(
        "gin-tu").param_count(1433)
    assert {k: dataclasses.asdict(v) for k, v in
            t_configs.GNN_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in j_configs.GNN_SHAPES.items()}
    assert t_configs.all_cells() == j_configs.all_cells()
    assert len(t_configs.all_cells()) == 40
    for arch in t_configs.list_archs():
        assert list(t_configs.shapes_for(t_configs.get_config(arch))) == \
            list(j_configs.shapes_for(j_configs.get_config(arch)))


# ----------------------------------------------------------------- sampler
def test_sampler_copy_gives_the_reference_arrays():
    jg = JS.synthetic_power_law_graph(300, 1500, d_feat=6, n_classes=5,
                                      seed=3)
    tg = TS.synthetic_power_law_graph(300, 1500, d_feat=6, n_classes=5,
                                      seed=3)
    for f in ("indptr", "indices", "node_feats", "labels"):
        assert_exact(getattr(tg, f), getattr(jg, f), f)
    assert tg.n_nodes == jg.n_nodes and tg.n_edges == jg.n_edges
    rng = np.random.default_rng(1)
    s, r = rng.integers(0, 40, 90), rng.integers(0, 40, 90)
    a, b = (JS.CSRGraph.from_edge_list(s, r, 40),
            TS.CSRGraph.from_edge_list(s, r, 40))
    assert_exact(b.indptr, a.indptr)
    assert_exact(b.indices, a.indices)
    js = JS.NeighborSampler(jg, fanout=(4, 3), batch_nodes=16, seed=5)
    ts = TS.NeighborSampler(tg, fanout=(4, 3), batch_nodes=16, seed=5)
    assert (ts.max_nodes, ts.max_edges) == (js.max_nodes, js.max_edges)
    seeds = np.random.default_rng(2)
    for _ in range(3):
        pick = seeds.choice(300, 16, replace=False)
        want, got = js.sample(pick), ts.sample(pick)
        assert set(got) == set(want)
        for k in want:
            assert_exact(got[k], want[k], k)


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_partition_edges_matches_reference(n_shards, rng):
    s = rng.integers(0, 64, 700).astype(np.int32)
    r = rng.integers(0, 64, 700).astype(np.int32)
    for g, w in zip(TG.partition_edges(s, r, 64, n_shards),
                    JG.partition_edges(s, r, 64, n_shards)):
        assert_exact(g, w)


# ----------------------------------------------------------------- forward
@pytest.mark.parametrize("aggregator", ["sum", "max"])
def test_gin_full_sampled_and_batched_regimes_match_jax(aggregator):
    """The reference's three regimes (``tests/test_arch_smoke.py``): the
    full graph, a sampled padded subgraph, and 4 disjoint molecules with
    a graph readout; node logits, user embeddings, graph embeddings."""
    jcfg, tcfg = smoke(aggregator=aggregator)
    params, model = gin(jcfg, 16)
    g = TS.synthetic_power_law_graph(128, 512, d_feat=16,
                                     n_classes=tcfg.n_classes)
    recv = np.repeat(np.arange(128), np.diff(g.indptr)).astype(np.int32)
    jgr, tgr = both_graphs(g.node_feats, g.indices, recv)
    want = JG.node_logits(params, jgr, jcfg)
    assert_float(TG.node_logits(model, tgr, tcfg), want, "full",
                 atol=GIN_ATOL, rtol=0)
    assert_float(TG.user_tower_step(model, tgr, tcfg),
                 JG.user_tower_step(params, jgr, jcfg), "tower",
                 atol=GIN_ATOL, rtol=0)
    sub = TS.NeighborSampler(g, fanout=(4, 3), batch_nodes=16).sample(
        np.random.default_rng(0).choice(128, 16, replace=False))
    jgr, tgr = both_graphs(sub["node_feats"], sub["senders"],
                           sub["receivers"])
    assert_float(TG.forward(model, tgr, tcfg),
                 JG.forward(params, jgr, jcfg), "sampled", atol=GIN_ATOL,
                 rtol=0)
    nrng = np.random.default_rng(0)
    G, nodes, edges = 4, 10, 20
    feats = nrng.standard_normal((G * nodes, 16)).astype(np.float32)
    off = np.repeat(np.arange(G), edges) * nodes
    s = (nrng.integers(0, nodes, G * edges) + off).astype(np.int32)
    r = (nrng.integers(0, nodes, G * edges) + off).astype(np.int32)
    gid = np.repeat(np.arange(G), nodes).astype(np.int32)
    jgr, tgr = both_graphs(feats, s, r, gid)
    got = TG.graph_embeddings(model, tgr, tcfg, G)
    assert got.shape == (G, tcfg.d_hidden)
    assert_float(got, JG.graph_embeddings(params, jgr, jcfg, G), "batched",
                 atol=GIN_ATOL, rtol=0)


@pytest.mark.parametrize("aggregator", ["sum", "max"])
def test_gin_padding_edges_are_inert(aggregator, rng):
    jcfg, tcfg = smoke(aggregator=aggregator, learnable_eps=False)
    params, model = gin(jcfg, 8)
    assert model.layers[0].eps is None
    feats = rng.standard_normal((32, 8)).astype(np.float32)
    s = rng.integers(0, 32, 64).astype(np.int32)
    r = rng.integers(0, 32, 64).astype(np.int32)
    s2 = np.concatenate([s, np.full(16, -1, np.int32)])
    r2 = np.concatenate([r, np.zeros(16, np.int32)])
    h1 = TG.forward(model, both_graphs(feats, s, r)[1], tcfg)
    h2 = TG.forward(model, both_graphs(feats, s2, r2)[1], tcfg)
    assert_exact(h2, h1)
    assert_float(h2, JG.forward(params, both_graphs(feats, s2, r2)[0], jcfg),
                 atol=GIN_ATOL, rtol=0)


@pytest.mark.parametrize("dims,axes", [((4, 2), ("data", "model")),
                                       ((8,), ("data",)),
                                       ((2, 2, 2), ("pod", "data", "model"))])
def test_forward_partitioned_matches_replicated(dims, axes, rng):
    """Node shards over the mesh's (pod, data) axes: (4, 2) -> 4 shards,
    (8,) -> 8, (2, 2, 2) -> 4; node_axes=("data", "model") at (4, 2) ->
    8, as ``tests/test_distributed.py``. The port's own forward and the
    JAX unsharded forward."""
    jcfg, tcfg = smoke()
    N, E, Fd = 64, 256, 8
    feats = rng.standard_normal((N, Fd)).astype(np.float32)
    snd = rng.integers(0, N, E).astype(np.int32)
    rcv = rng.integers(0, N, E).astype(np.int32)
    params, model = gin(jcfg, Fd)
    want = JG.forward(params, both_graphs(feats, snd, rcv)[0], jcfg)
    mesh = cpu_mesh(dims, axes)
    node_axes = [("pod", "data")] + ([("data", "model")] if dims == (4, 2)
                                      else [])
    for na in node_axes:
        n = int(np.prod([mesh.shape[a] for a in na if a in axes]))
        ps, pr = TG.partition_edges(snd, rcv, N, n)
        g = TG.Graph(torch.as_tensor(feats), torch.as_tensor(ps),
                     torch.as_tensor(pr))
        got = TG.forward_partitioned(model, g, tcfg, mesh, node_axes=na)
        assert_float(got, want, f"{dims} {na}", atol=GIN_ATOL, rtol=0)
    with pytest.raises(AssertionError):
        TG.forward_partitioned(model, TG.Graph(
            torch.zeros(N + 2, Fd), torch.as_tensor(ps), torch.as_tensor(pr)),
            tcfg, mesh)


def test_gin_init_and_abstract_params_match_reference():
    jcfg, tcfg = j_configs.get_config("gin-tu"), t_configs.get_config(
        "gin-tu")
    model = TG.init_params(torch.Generator().manual_seed(0), tcfg, 100,
                           device="cpu")
    want = JG.abstract_params(jcfg, 100)
    got = TG.abstract_params(tcfg, 100)
    for tree in (got, TG.param_tree(model)):
        jl = jax.tree_util.tree_leaves_with_path(want)
        tl = TO.tree_leaves(tree)
        assert len(jl) == len(tl) == 5 * 5 + 1
        for (path, w), g in zip(jl, tl):
            assert tuple(g.shape) == tuple(w.shape), path
    assert all(t.device.type == "meta" for t in TO.tree_leaves(got))
    w1 = model.layers[0].w1
    assert abs(float(w1.std()) - 100 ** -0.5) < 0.01
    assert not model.layers[0].eps.any() and not model.layers[2].b2.any()


# ------------------------------------------------------------------- train
@pytest.mark.parametrize("kind", ["node", "node-fixed-eps", "graph",
                                  "partitioned"])
def test_gin_train_steps_match_jax(kind):
    """Two AdamW steps of make_train_step from the same carried weights
    (the launcher's sampled batches, with eps learnable or not (a None
    leaf), or 4 molecules, or the full graph partitioned over 4 node
    shards): each step's loss and the trained leaves."""
    jcfg, tcfg = smoke(learnable_eps=kind != "node-fixed-eps")
    kind = kind.split("-")[0]
    d_feat = t_train.GNN_D_FEAT if kind == "node" else 8
    params, model = gin(jcfg, d_feat)
    jo, to = JO.for_config(jcfg), TO.for_config(tcfg)
    tree = TO.trainable(TG.param_tree(model))
    jstate, tstate = jo.init(params), to.init(tree)
    if kind == "node":
        jb = [next(j_train.gnn_batches(jcfg))]
        jb.append(next(j_train.gnn_batches(jcfg, seed=1)))
        tb = [next(t_train.gnn_batches(tcfg, device="cpu"))]
        tb.append(next(t_train.gnn_batches(tcfg, seed=1, device="cpu")))
        for k in jb[0]:
            assert_exact(tb[0][k], jb[0][k], k)
        jstep = jax.jit(JG.make_train_step(jcfg, jo, kind="node"))
        tstep = TG.make_train_step(tcfg, to, kind="node")
    else:
        rng = np.random.default_rng(4)
        G, nodes, edges = 4, 10, 20
        feats = rng.standard_normal((G * nodes, d_feat)).astype(np.float32)
        off = np.repeat(np.arange(G), edges) * nodes
        s = (rng.integers(0, nodes, G * edges) + off).astype(np.int32)
        r = (rng.integers(0, nodes, G * edges) + off).astype(np.int32)
        b = {"node_feats": feats, "senders": s, "receivers": r}
        if kind == "graph":
            b.update(graph_ids=np.repeat(np.arange(G), nodes).astype(
                np.int32), labels=np.arange(G, dtype=np.int32) % 4)
        else:
            b["senders"], b["receivers"] = TG.partition_edges(s, r, G * nodes,
                                                              4)
            b.update(labels=rng.integers(0, 4, G * nodes).astype(np.int32),
                     mask=rng.uniform(size=G * nodes) < 0.5)
        jb = [{k: jnp.asarray(v) for k, v in b.items()}] * 2
        tb = [{k: torch.as_tensor(v) for k, v in b.items()}] * 2
        if kind == "graph":
            jb = [dict(x, n_graphs=G) for x in jb]
            tb = [dict(x, n_graphs=G) for x in tb]
            jstep = JG.make_train_step(jcfg, jo, kind="graph")
            tstep = TG.make_train_step(tcfg, to, kind="graph")
        else:
            jstep = JG.make_train_step(jcfg, jo, kind="node")
            tstep = TG.make_train_step(tcfg, to, kind="node", partitioned=True,
                                       mesh=cpu_mesh((4,), ("data",)))
    for i in range(2):
        params, jstate, jm = jstep(params, jstate, jb[i])
        tree, tstate, tm = tstep(tree, tstate, tb[i])
        assert_float(tm["loss"], jm["loss"], f"step {i}", atol=0,
                     rtol=LOSS_RTOL)
        for g, (path, w) in zip(TO.tree_leaves(tree),
                                jax.tree_util.tree_leaves_with_path(params)):
            assert_float(g, w, f"step {i} {path}", atol=GIN_ATOL, rtol=0)


def test_launcher_trains_gin_tu_on_cpu_and_resumes(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    argv = ["--arch", "gin-tu", "--steps", "4", "--ckpt-dir", ck,
            "--ckpt-every", "2", "--log-every", "1", "--device", "cpu"]
    params, opt_state = t_train.main(argv)
    assert int(opt_state["step"]) == 4 and t_ckpt.latest_step(ck) == 4
    out = capsys.readouterr().out
    assert out.count("[step ") == 4 and out.rstrip().endswith("[train] done")
    loss = [float(line.split("loss=")[1].split()[0])
            for line in out.splitlines() if line.startswith("[step")]
    assert all(np.isfinite(loss))
    params, opt_state = t_train.main(argv[:3] + ["6"] + argv[4:])
    out = capsys.readouterr().out
    assert "[resume] from checkpoint step 4" in out
    assert "[step 5]" in out and "[step 4]" not in out
    assert int(opt_state["step"]) == 6 and t_ckpt.latest_step(ck) == 6
    assert len(params["layers"]) == 2 and params["layers"][0][
        "eps"].shape == ()
    assert to_np(params["layers"][0]["w1"]).shape == (t_train.GNN_D_FEAT, 16)
