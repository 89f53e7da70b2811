"""repro_torch's Wide&Deep, BST and MIND towers, their serving scores,
``retrieval_step`` and the one-launch field bag against the JAX package,
on the CPU.

Parameters are drawn by the JAX package and carried over by
``load_jax_params``; inputs are made with numpy from a seed and given to
both. Towers and scores compare at atol 2e-5 / rtol 1e-4 (XLA and torch
sum matmuls, softmax and layer norm in different orders); the field bags
at atol 1e-6 (nnz=4 float32 sums in another order); the launchers'
counters exactly (no counter depends on the towers' weights).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import assert_exact, assert_float, to_np  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.launch import serve as j_launch  # noqa: E402
from repro.models import recsys as JR  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.core import server as TS  # noqa: E402
from repro_torch.core.metrics import ServingCounters  # noqa: E402
from repro_torch.launch import serve as t_launch  # noqa: E402
from repro_torch.models import recsys as TR  # noqa: E402

ARCHS = ("wide-deep", "bst", "mind")
# a narrow variant of each tower beside its SMOKE config: two MLP layers
# over three fields of nnz 3; two non-causal blocks of 4 heads; three
# routing iterations over three capsules
NARROW = {
    "wide-deep": dict(embed_dim=6, n_sparse=3, mlp=(24, 12), vocab=200,
                      nnz_per_field=3),
    "bst": dict(embed_dim=16, seq_len=7, n_blocks=2, n_heads=4,
                mlp=(24, 12), vocab=300),
    "mind": dict(embed_dim=12, n_interests=3, capsule_iters=3, seq_len=9,
                 vocab=300),
}
BAG_ATOL = 1e-6


def configs(arch, narrow=False):
    jcfg, tcfg = j_config(arch, smoke=True), t_config(arch, smoke=True)
    if narrow:
        jcfg = dataclasses.replace(jcfg, **NARROW[arch])
        tcfg = dataclasses.replace(tcfg, **NARROW[arch])
    return jcfg, tcfg


def towers(arch, narrow=False, seed=3):
    jcfg, tcfg = configs(arch, narrow)
    params = JR.init_params(jax.random.PRNGKey(seed), jcfg)
    model = TR.load_jax_params(jax.tree_util.tree_map(np.asarray, params),
                               device="cpu")
    return jcfg, tcfg, params, model


def inputs_of(cfg, rng, batch=11, pad=0.3):
    """Features with -1 pads: Wide&Deep's field ids (B, F, nnz) (one bag
    all pads), the sequences' (B, S) behaviours (left padding)."""
    if cfg.arch_id.startswith("wide-deep"):
        ids = rng.integers(0, cfg.vocab, (batch, cfg.n_sparse,
                                          cfg.nnz_per_field))
        ids[rng.uniform(size=ids.shape) < pad] = -1
        ids[0, 0] = -1
        return {"sparse_ids": ids.astype(np.int32)}
    seq = rng.integers(0, cfg.vocab, (batch, cfg.seq_len))
    seq[:, :3][rng.uniform(size=(batch, 3)) < 0.5] = -1
    return {"seq": seq.astype(np.int32),
            "target": rng.integers(0, cfg.vocab, batch).astype(np.int32)}


def both(feats):
    return ({k: jnp.asarray(v) for k, v in feats.items()},
            {k: torch.as_tensor(v) for k, v in feats.items()})


# ----------------------------------------------------------- field bags
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_field_embedding_bag_matches_jax(mode, rng):
    """One bag over the (F*V, D) view with field offsets equals the
    reference's per-field vmap, -1 pads included (a bag of pads is 0)."""
    tables = rng.standard_normal((5, 37, 6)).astype(np.float32)
    ids = rng.integers(0, 37, (11, 5, 4)).astype(np.int32)
    ids[rng.uniform(size=ids.shape) < 0.3] = -1
    ids[2, 3] = -1
    want = JR.field_embedding_bag(jnp.asarray(tables), jnp.asarray(ids),
                                  mode=mode)
    got = TR.field_embedding_bag(torch.as_tensor(tables),
                                 torch.as_tensor(ids), mode=mode,
                                 impl="torch")
    assert got.shape == (11, 5, 6)
    assert_float(got, want, atol=BAG_ATOL, rtol=1e-6)
    assert not to_np(got)[2, 3].any()


def test_field_embedding_bag_reads_its_own_field_only():
    """Field f's id v reads row f*V + v of the view, never a neighbour
    field's row; pads never shift into a real row; non-contiguous tables
    are refused (the view is never a copy)."""
    F_, V, D = 4, 10, 3
    tables = torch.arange(F_ * V * D, dtype=torch.float32).view(F_, V, D)
    ids = torch.tensor([[[9], [0], [-1], [5]]], dtype=torch.int32)
    got = TR.field_embedding_bag(tables, ids, impl="torch")
    assert torch.equal(got[0, 0], tables[0, 9])
    assert torch.equal(got[0, 1], tables[1, 0])
    assert torch.equal(got[0, 2], torch.zeros(D))
    assert torch.equal(got[0, 3], tables[3, 5])
    with pytest.raises(ValueError):
        TR.field_embedding_bag(tables.transpose(0, 1), ids, impl="torch")
    with pytest.raises(ValueError):
        TR.field_embedding_bag(tables, ids, impl="cuda")


# --------------------------------------------------------------- towers
@pytest.mark.parametrize("narrow", [False, True], ids=["smoke", "narrow"])
@pytest.mark.parametrize("arch", ARCHS)
def test_tower_matches_jax(arch, narrow, rng):
    jcfg, tcfg, params, model = towers(arch, narrow)
    jf, tf = both(inputs_of(jcfg, rng))
    want = JR.tower_step(params, jf, jcfg)
    got = TR.tower_step(model, tf, tcfg, impl="torch")
    assert got.shape == (11, tcfg.user_embed_dim)
    assert got.dtype == torch.float32
    assert_float(got, want)


@pytest.mark.parametrize("arch", ["wide-deep", "bst"])
def test_score_matches_jax(arch, rng):
    """``wide_deep_score`` (deep head + the wide part's one-launch field
    bag) and ``bst_score`` (the target item attended to, a -1 target
    masked) against the reference, at SMOKE and narrow widths."""
    fn = {"wide-deep": (JR.wide_deep_score, TR.wide_deep_score),
          "bst": (JR.bst_score, TR.bst_score)}[arch]
    for narrow in (False, True):
        jcfg, tcfg, params, model = towers(arch, narrow, seed=5)
        feats = inputs_of(jcfg, rng)
        if arch == "bst":
            feats["target"][1] = -1
        jf, tf = both(feats)
        got = fn[1](model, tf, tcfg, impl="torch")
        assert got.shape == (11,)
        assert_float(got, fn[0](params, jf, jcfg))


def test_load_jax_params_refuses_a_tree_of_no_tower():
    """A tree is matched to a tower by its exact keys: a SASRec tree with
    one key more, or one less, names no tower and raises."""
    params = towers("sasrec")[2]
    tree = jax.tree_util.tree_map(np.asarray, params)
    with pytest.raises(ValueError, match="no recsys tower"):
        TR.load_jax_params({**tree, "head": tree["ln_w"]}, device="cpu")
    del tree["ln_b"]
    with pytest.raises(ValueError, match="no recsys tower"):
        TR.load_jax_params(tree, device="cpu")


@pytest.mark.parametrize("arch", ["mind", "bst"])
def test_retrieval_step_matches_jax(arch, rng):
    """Top-100 of 700 candidates, scored by the tower's own queries scaled
    to unit norm (MIND: the max over its interests). Scores match; ids
    match where the neighbouring scores differ (ties may be ordered
    differently)."""
    jcfg, tcfg, params, model = towers(arch)
    jf, tf = both(inputs_of(jcfg, rng, batch=6))
    user = np.array(JR.tower_step(params, jf, jcfg))
    user /= np.linalg.norm(user, axis=1, keepdims=True)   # unit queries
    cand = rng.standard_normal((700, jcfg.embed_dim)).astype(np.float32)
    ws, wi = JR.retrieval_step(jnp.asarray(user), jnp.asarray(cand), jcfg)
    gs, gi = TR.retrieval_step(torch.as_tensor(user), torch.as_tensor(cand),
                               tcfg)
    assert gs.shape == (6, 100) and gi.dtype == torch.int32
    assert_float(gs, ws)
    ws, wi, gi = np.asarray(ws), np.asarray(wi), to_np(gi)
    gap = np.diff(ws, axis=1)
    distinct = np.ones_like(ws, bool)
    distinct[:, 1:] &= gap < -1e-5
    distinct[:, :-1] &= gap < -1e-5
    assert distinct.mean() > 0.9
    np.testing.assert_array_equal(gi[distinct], wi[distinct])


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_shapes_and_scales_match_reference(arch):
    """Shapes equal the reference's abstract params, weights are frozen,
    and the draws have the reference's scales."""
    tcfg = t_config(arch, smoke=True)
    model = TR.init_params(torch.Generator().manual_seed(0), tcfg,
                           device="cpu")
    want = jax.tree_util.tree_map(
        lambda a: tuple(a.shape), JR.abstract_params(j_config(arch,
                                                              smoke=True)))
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    flat = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): shape
            for path, shape in jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: isinstance(x, tuple))[0]}
    assert got == flat
    assert not any(p.requires_grad for p in model.parameters())
    emb = model.tables if arch == "wide-deep" else model.item_emb
    assert abs(float(emb.std()) - 0.01) < 1e-3
    if arch == "mind":
        assert abs(float(model.S.std()) - tcfg.embed_dim ** -0.5) < 0.05
    else:
        w = model.mlp_w[0]
        assert abs(float(w.std()) - w.shape[0] ** -0.5) < 0.05
        assert float(model.mlp_b[0].abs().max()) == 0.0
    if arch == "bst":
        blk = model.blocks[0]
        assert not blk.causal and tuple(blk.w1.shape) == (8, 32)
        assert float(blk.ln1_w.min()) == 1.0


def test_registry_dispatches_every_recsys_arch():
    assert set(TR.TOWERS) == {"wide-deep", "sasrec", "bst", "mind"}
    for arch in TR.TOWERS:
        assert TR.get_arch_fns(arch + "-smoke") is TR.TOWERS[arch]
        assert t_config(arch).arch_id == arch
    with pytest.raises(ValueError):
        TR.get_arch_fns("tinyllama-1.1b")


# -------------------------------------------------------------- launcher
@pytest.mark.parametrize("arch", ["wide-deep", "sasrec", "bst", "mind"])
def test_build_tower_features_match_reference(arch):
    """The launcher's synthesizer draws the reference's features (so both
    packages stage identical ids), and its tower serves them."""
    _, _, _, j_feats = j_launch.build_tower(arch)
    cfg, params, tower_fn, t_feats = t_launch.build_tower(
        arch, backend="torch", device="cpu")
    users = np.arange(13)
    want, got = j_feats(users, 123_456), t_feats(users, 123_456)
    assert set(got) == set(want)
    for k in want:
        assert_exact(got[k], np.asarray(want[k]), k)
    out = tower_fn(params, {k: torch.as_tensor(v) for k, v in got.items()})
    assert out.shape == (13, cfg.user_embed_dim)


def test_stage_chunk_stages_field_ids():
    """(S, B, F, nnz) field ids flow through ``_stage_chunk`` and the
    server's ``take_rows`` unchanged."""
    cfg, _, _, feats_of = t_launch.build_tower("wide-deep", backend="torch",
                                               device="cpu")
    uids = np.arange(40) * 3
    times = np.arange(40, dtype=np.int64) * 1000
    keys, feats, nows, fails = t_launch._stage_chunk(
        uids, times, feats_of, 0, 3, 8, torch.device("cpu"))
    ids = feats["sparse_ids"]
    assert ids.shape == (3, 8, cfg.n_sparse, cfg.nnz_per_field)
    assert ids.dtype == torch.int32 and fails is None
    for s in range(3):
        assert_exact(ids[s], feats_of(uids[8 * s:8 * s + 8],
                                      int(nows[s]))["sparse_ids"])
    sel = torch.tensor([5, 0, 5])
    assert torch.equal(TS.take_rows({"sparse_ids": ids[1]}, sel)[
        "sparse_ids"], ids[1][sel])


def test_run_serving_multi_wide_deep_counters_match_jax():
    """The --multi launcher fronting Wide&Deep: every counter and the
    per-model report equal the JAX launcher's on the same stream."""
    common = dict(arch="wide-deep", minutes=6, users=200, batch=64,
                  failure_rate=0.05, chunk_steps=6, n_buckets=64,
                  log=lambda *_: None)
    want = j_launch.run_serving_multi(backend="jnp", **common)
    got = t_launch.run_serving_multi(backend="torch", device="cpu",
                                     **common)
    for k in dataclasses.fields(ServingCounters):
        assert got[k.name] == want[k.name], k.name
    assert got["per_model"] == want["per_model"]
    assert got["requests"] > 0 and got["direct_hits"] > 0


def test_run_serving_overload_mind_matches_jax():
    """The overload arm fronting MIND: the budget and every per-phase
    counter equal the JAX launcher's."""
    common = dict(arch="mind", minutes=8, users=300, batch=64,
                  chunk_steps=4, failure_rate=0.05, failure_burst_rate=0.3,
                  log=lambda *_: None)
    want = j_launch.run_serving_overload(backend="jnp", **common)
    got = t_launch.run_serving_overload(backend="torch", device="cpu",
                                        **common)
    assert got["budget_per_step"] == want["budget_per_step"]
    for p, w in want["phases"].items():
        for f in dataclasses.fields(ServingCounters):
            assert got["phases"][p][f.name] == w[f.name], (p, f.name)
    assert got["phases"]["outage"]["deferred"] > 0
