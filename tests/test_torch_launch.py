"""repro_torch's cell planner (``launch/specs.py``, ``launch/dryrun.py``)
against the JAX package, on the CPU.

Every one of the 40 cells on both production meshes is built by both
packages (JAX's on an ``AbstractMesh``, which needs no devices; the
port's on a mesh of meta devices): spec trees, argument shapes and
dtypes, donation and notes equal leaf for leaf, ``model_flops`` to a
relative 1e-12. The dry-run is held to what it promises: argument bytes
exact from the local shard shapes, the linear accounting equal to the
direct trace, the collective counter equal to its formula, the
reference's result keys.
"""
import collections
import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec  # noqa: E402

from repro.configs import all_cells as j_all_cells  # noqa: E402
from repro.core import config as j_config  # noqa: E402
from repro.core import server as j_server  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.launch import dryrun as j_dryrun  # noqa: E402
from repro.launch import specs as j_specs  # noqa: E402
from repro_torch.configs import all_cells, get_config, list_archs  # noqa: E402
from repro_torch.core import config as t_config  # noqa: E402
from repro_torch.core import server as t_server  # noqa: E402
from repro_torch.distributed import collectives as coll  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.sharding import Spec  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs as specs_lib  # noqa: E402
from repro_torch.launch.mesh import (CacheMesh, ModelMesh,  # noqa: E402
                                     PRODUCTION_SHAPES,
                                     make_production_mesh)
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models import recsys as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

MESHES = [False, True]


def meta_mesh(multi_pod):
    dims, _ = PRODUCTION_SHAPES[multi_pod]
    return make_production_mesh(multi_pod=multi_pod,
                                devices=["meta"] * math.prod(dims))


def _flat(tree, path=""):
    """(path, leaf) pairs in JAX's order: specs as tuples, arrays as
    (shape, dtype name); dict keys sorted, None an empty subtree."""
    if isinstance(tree, (PartitionSpec, Spec)):
        yield path, tuple(tree)
    elif isinstance(tree, jax.ShapeDtypeStruct):
        yield path, (tuple(tree.shape), np.dtype(tree.dtype).name)
    elif isinstance(tree, torch.Tensor):
        yield path, (tuple(tree.shape), str(tree.dtype).split(".")[1])
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}/{i}")
    elif tree is not None:
        yield path, tree


# -------------------------------------------------------------- the cells
def test_all_cells_is_40():
    assert all_cells() == j_all_cells()
    assert len(all_cells()) == 40
    assert len({a for a, _ in all_cells()}) == 10


@pytest.mark.parametrize("multi_pod", MESHES,
                         ids=["singlepod", "multipod"])
@pytest.mark.parametrize("arch,shape", all_cells(),
                         ids=[f"{a}|{s}" for a, s in all_cells()])
def test_build_cell_matches_reference(arch, shape, multi_pod):
    dims, names = PRODUCTION_SHAPES[multi_pod]
    jc = j_specs.build_cell(arch, shape, AbstractMesh(dims, names))
    tc = specs_lib.build_cell(arch, shape, meta_mesh(multi_pod))
    assert list(_flat(tc.in_specs)) == list(_flat(jc.in_specs))
    assert list(_flat(tc.args)) == list(_flat(jc.args))
    assert all(t.is_meta for t in dryrun._tensors(tc.args))
    assert tc.donate_argnums == jc.donate_argnums
    assert tc.note == jc.note
    assert tc.model_flops == pytest.approx(jc.model_flops, rel=1e-12)


# ----------------------------------------------- test_launch.py's cases
def test_logical_to_spec_respects_mesh_axes():
    for axes in (("data", "model"), ("pod", "data", "model")):
        got = shd.logical_to_spec(("batch", "seq", "heads"), shd.LM_RULES,
                                  axes)
        want = JSH.logical_to_spec(("batch", "seq", "heads"), JSH.LM_RULES,
                                   axes)
        assert tuple(got) == tuple(want)
    assert shd.logical_to_spec(("batch", "seq", "heads"), shd.LM_RULES,
                               ("data", "model")) == Spec("data", None,
                                                          "model")
    # expert and ffn both map to model: the second one drops
    assert shd.logical_to_spec(("expert", "ffn"), shd.LM_RULES,
                               ("data", "model")) == Spec("model", None)


def test_divisible_or_replicate_56_heads():
    fake = type("M", (), {"shape": {"data": 16, "model": 16}})()
    assert shd.divisible_or_replicate(Spec(None, "model"), (100, 56),
                                      fake) == Spec(None, None)
    assert shd.divisible_or_replicate(Spec(None, "model"), (100, 64),
                                      fake) == Spec(None, "model")


def test_opt_state_specs_shape_matching():
    params = {"w": torch.empty((256, 512), device="meta")}
    pspecs = {"w": Spec("model", "data")}
    opt_state = {"step": torch.empty((), dtype=torch.int32, device="meta"),
                 "v": {"w": {"vr": torch.empty((256,), device="meta"),
                             "vc": torch.empty((512,), device="meta")}},
                 "m": {"w": torch.empty((256, 512), device="meta")}}
    specs = specs_lib._opt_state_specs(opt_state, params, pspecs)
    assert specs["m"]["w"] == Spec("model", "data")
    assert specs["v"]["w"]["vr"] == Spec("model")  # row factor drops last
    assert specs["v"]["w"]["vc"] == Spec("data")   # col factor drops -2
    assert specs["step"] == Spec()
    j_params = {"w": jax.ShapeDtypeStruct((256, 512), jnp.float32)}
    j_opt = {"step": jax.ShapeDtypeStruct((), jnp.int32),
             "v": {"w": {"vr": jax.ShapeDtypeStruct((256,), jnp.float32),
                         "vc": jax.ShapeDtypeStruct((512,), jnp.float32)}},
             "m": {"w": jax.ShapeDtypeStruct((256, 512), jnp.float32)}}
    want = j_specs._opt_state_specs(j_opt, j_params,
                                    {"w": PartitionSpec("model", "data")})
    assert list(_flat(specs)) == list(_flat(want))


@pytest.mark.parametrize("kind", dryrun._COLLECTIVES)
@pytest.mark.parametrize("n", [1, 2, 4, 16, 512])
def test_wire_factor_matches_reference(kind, n):
    assert dryrun._wire_factor(kind, n) == j_dryrun._wire_factor(kind, n)


@pytest.mark.parametrize("arch", list_archs())
def test_lm_flops_positive_and_scaled(arch):
    cfg = get_config(arch)
    if cfg.family != "lm":
        assert cfg.family in ("gnn", "recsys")
        return
    f_train = specs_lib._lm_flops(cfg, 1024, True, 2048)
    f_inf = specs_lib._lm_flops(cfg, 1024, False, 2048)
    assert f_train > f_inf > 0
    assert f_train / f_inf == pytest.approx(3.0, rel=0.01)
    assert cfg.active_param_count() <= cfg.param_count()


# -------------------------------------------------------------- cache tier
def test_cache_tier_specs_match_reference():
    kw = dict(model_id=1, model_type="ctr", n_buckets=64, ways=4,
              value_dim=8)
    j_state = jax.eval_shape(lambda: j_server.init_server_state(
        j_config.CacheConfig(**kw), writebuf_capacity=16))
    t_state = t_server.init_server_state(t_config.CacheConfig(**kw),
                                         writebuf_capacity=16,
                                         device="meta")
    want = list(_flat(j_specs.cache_tier_specs(j_state)))
    assert list(_flat(specs_lib.cache_tier_specs(t_state))) == want
    assert want[0][1] == ("shard",)
    # a sharded state gets its unsharded type's specs
    sharded = t_server.init_server_state(
        t_config.CacheConfig(**kw), writebuf_capacity=16, device="meta",
        mesh=CacheMesh(("meta",) * 4))
    assert list(_flat(specs_lib.cache_tier_specs(sharded))) == want
    # the multi-model tier (M=2): the bucket axis behind the model axis
    j_cfgs = j_config.multi_model_tier_configs(value_dim=8,
                                               n_buckets=64)[:2]
    t_cfgs = t_config.multi_model_tier_configs(value_dim=8,
                                               n_buckets=64)[:2]
    j_multi = jax.eval_shape(lambda: j_server.init_multi_server_state(
        j_cfgs, writebuf_capacity=16))
    t_multi = t_server.init_multi_server_state(t_cfgs, writebuf_capacity=16,
                                               device="meta")
    want = list(_flat(j_specs.cache_tier_specs(j_multi)))
    assert list(_flat(specs_lib.cache_tier_specs(t_multi))) == want
    assert want[0][1] == (None, "shard")


def test_to_shardings_and_local_shape():
    mesh = meta_mesh(False)
    tree = {"a": Spec("data", None), "b": [Spec(), Spec(("data", "model"))]}
    placed = specs_lib.to_shardings(mesh, tree)
    assert placed["a"] == shd.Placement(mesh, Spec("data", None))
    assert placed["b"][1].spec == Spec(("data", "model"))
    assert specs_lib.local_shape((512, 7), Spec(("data", "model"), None),
                                 mesh) == (2, 7)
    assert specs_lib.local_shape((32, 64), Spec(None, "model"),
                                 mesh) == (32, 4)
    with pytest.raises(ValueError):
        specs_lib.local_shape((8, 3), Spec("data"), mesh)


# ------------------------------------------------------------- the dry-run
def test_counter_moves_rows_not_tables():
    """A gather reads the rows it takes and an in-place scatter writes the
    rows it writes, not the (meta) table; a view moves nothing; an
    element-wise op reads its inputs and writes its output; the peak
    counts the storages the trace creates while they live."""
    table = torch.empty((1 << 20, 8, 256), device="meta")      # 8.6 GB
    idx = torch.empty((64,), dtype=torch.int64, device="meta")
    rows = torch.empty((64, 8, 256), device="meta")

    def fn(table, idx, rows):
        got = table[idx]                            # 64 rows read, written
        table[idx] = rows                           # 64 rows written
        view = got.view(64, -1)                     # nothing moves
        return (view * 2.0).sum()

    res = dryrun.trace(fn, (table, idx, rows))
    row = 8 * 256 * 4
    assert res["bytes"] == (2 * 64 * row + 64 * 8            # gather
                            + 64 * row + 64 * 8 + 64 * row   # index_put_
                            + 2 * 64 * row                   # mul
                            + 64 * row + 4)                  # sum
    # XLA's count: one FLOP an output element of the mul, one an input
    # element of the sum; the gather and the scatter none
    assert res["flops"] == 2 * 64 * 8 * 256
    assert res["peak"] == 2 * 64 * row + 4           # got, got * 2, the sum
    assert res["output_bytes"] == 4 and res["alias_bytes"] == 0


# ------------------------------------------------- placements (layout.py)
MESH_24 = ModelMesh((2, 4), ("data", "model"), ("meta",) * 8)
B_, D_, F_ = 8, 16, 32


def _megatron(x, w1, w2):
    """Column- then row-parallel MLP under the reference's constraints."""
    x = shd.constrain(x, ("batch", None), "recsys", MESH_24)
    h = torch.relu(x @ w1)
    h = shd.constrain(h, ("batch", "ffn"), "recsys", MESH_24)
    return shd.constrain(h @ w2, ("batch", None), "recsys", MESH_24)


def _megatron_args(grad=False):
    x = torch.empty((B_, D_), device="meta", requires_grad=grad)
    w1 = torch.empty((D_, F_), device="meta", requires_grad=grad)
    w2 = torch.empty((F_, D_), device="meta", requires_grad=grad)
    return (x, w1, w2), (Spec("data", None), Spec(None, "model"),
                         Spec("model", None))


def _on(traffic, group):
    return [(k, b) for k, b, n in traffic if n == group]


def test_megatron_mlp_forward_all_reduces_its_output_once():
    """The row-parallel product leaves a partial sum over ``model``; its
    constraint all-reduces the output's local (B/2, D) float32 bytes, the
    one collective of the forward."""
    args, specs = _megatron_args()
    res = dryrun.trace(_megatron, args, specs, MESH_24.shape)
    assert res["traffic"] == [("all-reduce", B_ // 2 * D_ * 4, 4)]
    assert res["involuntary"] == 0
    # per device: each product over its (B/2) rows and (F/4) columns
    mm = 2 * B_ * D_ * F_ / 8
    relu = B_ * F_ / 8
    assert res["flops"] == 2 * mm + relu


def test_megatron_mlp_train_step_adds_the_transposed_all_reduce():
    """In a train step the input's gradient is the transposed partial sum
    over ``model``, all-reduced by its constraint's backward; the weights'
    gradients are partial over ``data`` and all-reduced to their layout."""
    from repro_torch.training.optimizer import leaf_grads

    def step(x, w1, w2):
        loss = _megatron(x, w1, w2).sum()
        return leaf_grads(loss, {"x": x, "w1": w1, "w2": w2})

    args, specs = _megatron_args(grad=True)
    res = dryrun.trace(step, args, specs, MESH_24.shape)
    row = ("all-reduce", B_ // 2 * D_ * 4)
    assert _on(res["traffic"], 4) == [row, row]
    assert sorted(_on(res["traffic"], 2)) == [
        ("all-reduce", D_ * F_ // 4 * 4)] * 2


def test_constrain_to_replicated_all_gathers_the_split_dim():
    x = torch.empty((B_, F_), device="meta")

    def fn(x):
        return shd.constrain(x, (None, None), "recsys", MESH_24) * 1.0

    res = dryrun.trace(fn, (x,), (Spec(None, "model"),), MESH_24.shape)
    assert res["traffic"] == [("all-gather", B_ * F_ // 4 * 4, 4)]


def _moved_to_dim1(x, y):
    return shd.constrain(x, (None, "batch"), "recsys", MESH_24) * 1.0


def _added_to_dim1(x, y):
    return y + x                       # y, the larger, lays the output out


@pytest.mark.parametrize("fn", [_moved_to_dim1, _added_to_dim1],
                         ids=["constrain", "elementwise"])
def test_moving_an_axis_to_another_dim_is_one_all_to_all(fn):
    """A (B, F) float32 tensor split on dim 0 over ``data`` and resharded
    to dim 1 (by a constraint, or by an element-wise op with an operand
    split so) moves ``data`` in one all-to-all of its local B*F/2*4 bytes
    over the 2 devices of ``data``, as GSPMD does; nothing is gathered."""
    x = torch.empty((B_, F_), device="meta")
    y = torch.empty((2 * B_, B_, F_), device="meta")
    res = dryrun.trace(fn, (x, y), (Spec("data", None),
                                    Spec(None, None, "data")),
                       MESH_24.shape)
    assert res["traffic"] == [("all-to-all", B_ * F_ // 2 * 4, 2)]
    assert res["count_all-gather"] == 0 and res["involuntary"] == 0


@pytest.mark.parametrize("spec,moved", [
    (Spec("data", None), 0), (Spec("model", None), 1)],
    ids=["kept", "moved"])
def test_unconstrained_entry_keeps_the_dims_split(spec, moved):
    """``constrain(x, (UNCONSTRAINED, "ffn"))`` on a (B, F) float32 tensor:
    dim 0 keeps its split and dim 1 takes ``model`` for free; where dim 0
    held ``model`` itself, ``model`` moves to dim 1 in one all-to-all of
    the local B*F/4*4 bytes over its 4 devices."""
    x = torch.empty((B_, F_), device="meta")

    def fn(x):
        return shd.constrain(x, (shd.UNCONSTRAINED, "ffn"), "recsys",
                             MESH_24) * 1.0

    res = dryrun.trace(fn, (x,), (spec,), MESH_24.shape)
    assert res["traffic"] == [("all-to-all", B_ * F_ // 4 * 4, 4)] * moved
    split = 2 * 4 if not moved else 4
    assert res["flops"] == B_ * F_ / split


def test_repeated_and_widened_copy_is_gathered_as_its_source():
    """GQA's repeat: a (B, S, H, d) bf16 tensor split on d over ``model``,
    repeated 4 times over its heads and cast to float32, then gathered
    whole: one all-gather over the 4 devices of ``model`` of the source's
    local B*S*H*d/4*2 bytes (the reference gathers its KV chunks before
    the repeat and the cast), not the copy's 4*2 times that."""
    from repro_torch.models.layers import repeat_kv
    B, S, H, d = 2, 8, 2, 16
    x = torch.empty((B, S, H, d), device="meta", dtype=torch.bfloat16)

    def fn(x):
        y = repeat_kv(x, 4).to(torch.float32)
        return shd.constrain(y, (None, None, None, None), "lm", MESH_24)

    res = dryrun.trace(fn, (x,), (Spec(None, None, None, "model"),),
                       MESH_24.shape)
    assert res["traffic"] == [("all-gather", B * S * H * d // 4 * 2, 4)]


def test_kv_chunks_are_gathered_before_the_gqa_repeat():
    """Chunked attention of 8 query heads over 2 KV heads on the (2, 4)
    mesh, bf16, the queries' heads and the KV's hd over ``model`` (as
    their projections leave them): each of the 4 chunks of K and of V is
    all-gathered over ``model`` at its own bf16 bytes, B*16*Hkv*hd/8*2,
    before the repeat and the cast, so the gathers sum to K's and V's
    local bytes (the reference gathers them once, before its chunk scan),
    not 4*2 times that."""
    from repro_torch.models.layers import chunked_attention
    B, S, Hq, Hkv, hd, ch = 2, 64, 8, 2, 16, 16
    q, k, v = (torch.empty((B, S, h, hd), device="meta",
                           dtype=torch.bfloat16) for h in (Hq, Hkv, Hkv))
    res = dryrun.trace(
        lambda q, k, v: chunked_attention(q, k, v, causal=True,
                                          kv_chunk=ch), (q, k, v),
        (Spec("data", None, "model", None),
         Spec("data", None, None, "model"),
         Spec("data", None, None, "model")), MESH_24.shape, tally=True)
    gathers = [(b, g) for kind, b, g, *_ in res["counter"].records
               if kind == "all-gather"]
    assert gathers == [(B * ch * Hkv * hd // 8 * 2, 4)] * (2 * S // ch)
    assert res["coll_all-gather"] == 2 * B * S * Hkv * hd // 8 * 2 * 3


def test_split_back_of_a_merge_is_kept_on_its_own_storage():
    """A (4, 8) tensor split on dim 1 over ``model`` and merged to (32,)
    splits back to (4, 8) with ``model`` on dim 1, where it came from; an
    unrelated (32,) tensor split over ``model`` splits to (4, 8) with it
    on dim 0 (contiguous tiles), whatever the merge of the other."""
    from repro_torch.launch.layout import LayoutCounter
    x = torch.empty((4, 8), device="meta")
    z = torch.empty((32,), device="meta")
    counter = LayoutCounter(MESH_24.shape, [(x, Spec(None, "model")),
                                            (z, Spec("model"))])
    with counter:
        back = x.reshape(32).reshape(4, 8)
        other = z.reshape(4, 8)
    assert counter.layout(back).dims == ((), ("model",))
    assert counter.layout(other).dims == (("model",), ())


def test_smoke_granite_moe_dispatch_and_combine_collectives():
    """The smoke Granite MoE FFN and its residual add on the (2, 4) mesh,
    a decode-like batch of T = 8 tokens over ``data`` in one group (C =
    T, dropless), the E = 8 experts over ``model`` as the weights' (E, D,
    F) split (experts on ``model``, D on ``data``) and the dispatch's
    constraint (the experts on the expert axis) lay them out:

    * the dispatch contracts the tokens: its (E, C, D) float32 output,
      E/4 * C * D * 4 bytes a device, is all-reduced over ``data`` once,
      where the expert products meet the weights' D split;
    * the combine gathers its (G, T, E*C) weights' token dim, the smaller
      operand (T/2 * E*C/4 * 4 bytes over ``data``; the output's hidden
      dim, split over ``data`` by the down projection, wants it whole),
      then all-reduces its (T, D) output over ``model``, T * D/2 * 4
      bytes a device, the experts contracted;
    * the residual add moves ``data`` from the hidden dim back to the
      tokens: one all-to-all of those T * D/2 * 4 bytes over ``data``."""
    cfg = get_config("granite-moe-1b-a400m", smoke=True)
    D, F, E, T = cfg.d_model, cfg.d_ff, cfg.moe.n_experts, 8
    C = T

    def layer(x, router, wg, wu, wd):
        y, _ = moe_lib.moe_ffn(x, {"router": router, "wg": wg, "wu": wu,
                                   "wd": wd}, cfg.moe, cfg.moe_group_size,
                               mesh=MESH_24)
        return x + y

    def m(*shape):
        return torch.empty(shape, device="meta")

    res = dryrun.trace(layer, (m(T, 1, D), m(D, E), m(E, D, F), m(E, D, F),
                               m(E, F, D)),
                       (Spec("data", None, None), Spec(),
                        Spec("model", "data", None),
                        Spec("model", "data", None),
                        Spec("model", None, "data")),
                       MESH_24.shape, tally=True)
    rec = [(k, b, g, shp) for k, b, g, _, _, shp in res["counter"].records]
    assert [r for r in rec if r[0] == "all-to-all"] == [
        ("all-to-all", T * D // 2 * 4, 2, (T, 1, D))]
    assert ("all-reduce", E // 4 * C * D * 4, 2, (E, C, D)) in rec
    assert ("all-gather", T // 2 * E * C // 4 * 4, 2, (1, T, E * C)) in rec
    assert ("all-reduce", T * D // 2 * 4, 4, (T, 1, D)) in rec
    assert res["count_all-to-all"] == 1


@pytest.mark.parametrize("spec,share", [(Spec(), 1), (Spec("data", "model"),
                                                       8)])
def test_elementwise_op_counts_one_devices_share(spec, share):
    """Replicated, every device computes the whole op: one FLOP an output
    element, its bytes read and written whole."""
    x = torch.empty((B_, D_), device="meta")
    res = dryrun.trace(lambda x: x * 2.0, (x,), (spec,), MESH_24.shape)
    assert res["flops"] == B_ * D_ / share
    assert res["bytes"] == 2 * B_ * D_ * 4 / share
    assert res["traffic"] == []


def smoke_overrides(arch):
    """The SMOKE config's widths as overrides of the published config."""
    full, smoke = get_config(arch), get_config(arch, smoke=True)
    return {f.name: getattr(smoke, f.name)
            for f in dataclasses.fields(full)
            if f.name != "arch_id"
            and getattr(smoke, f.name) != getattr(full, f.name)}


def unread_leaves(cell):
    """The argument leaves a cell's step never reads, which the
    reference's ``jit`` prunes: an LM's user head outside training (only
    the ERCache tower reads it) and the inputs a retrieval tower ignores
    (MIND's target and negatives)."""
    skip = []
    params = cell.args[0]
    if isinstance(params, dict) and "user_head" in params \
            and cell.shape_name != "train_4k":
        skip.append(params["user_head"])
    if cell.shape_name == "retrieval_cand" and cell.arch.startswith("mind"):
        skip += [cell.args[1]["target"], cell.args[1]["neg"]]
    return skip


def expected_argument_bytes(cell, mesh):
    """Each argument leaf's bytes over the product of its spec's axes,
    but the leaves the step never reads."""
    total = 0
    skip = unread_leaves(cell)
    for t, spec in dryrun._pairs(cell.args, cell.in_specs):
        if any(t is u for u in skip):
            continue
        n = 1
        for e in spec:
            for a in (() if e is None else e if isinstance(e, tuple)
                      else (e,)):
                n *= mesh.shape[a]
        total += t.numel() * t.element_size() // n
    return total


SMOKE_CELLS = [("tinyllama-1.1b", "train_4k"),
               ("granite-moe-1b-a400m", "prefill_32k"),
               ("tinyllama-1.1b", "decode_32k"),
               ("gin-tu", "full_graph_sm"), ("gin-tu", "minibatch_lg"),
               ("gin-tu", "molecule"),
               ("wide-deep", "train_batch"), ("bst", "serve_p99"),
               ("mind", "retrieval_cand"), ("wide-deep", "retrieval_cand")]
# the reference's shard_map refuses Wide&Deep's row-sharded bag at B = 1
REFUSED_CELLS = {("wide-deep", "retrieval_cand"): "batch 1 "}


@pytest.mark.parametrize("arch,shape", SMOKE_CELLS,
                         ids=[f"{a}|{s}" for a, s in SMOKE_CELLS])
def test_run_cell_plans_each_family_and_kind(arch, shape):
    ov = smoke_overrides(arch)
    res = dryrun.run_cell(arch, shape, verbose=False, overrides=ov)
    if (arch, shape) in REFUSED_CELLS:
        assert res["ok"] is False
        assert "sharding mismatch" in res["error"]
        assert REFUSED_CELLS[arch, shape] in res["error"]
        return
    assert res["ok"], res
    for k in ("compute_s_term", "memory_s_term", "collective_s_term",
              "hlo_flops_per_dev", "hlo_bytes_per_dev"):
        assert math.isfinite(res[k]) and res[k] >= 0, (k, res[k])
    assert res["memory_s_term"] > 0
    assert res["dominant"] in ("compute", "memory", "collective")
    cell = specs_lib.build_cell(arch, shape, meta_mesh(False), ov)
    assert res["memory_stats"]["argument_bytes"] == expected_argument_bytes(
        cell, meta_mesh(False))


def test_run_cell_argument_bytes_by_hand():
    """GIN's parameters and optimizer state are replicated; its node and
    edge arrays split over the 16 data shards."""
    res = dryrun.run_cell("gin-tu", "molecule", verbose=False)
    cfg = get_config("gin-tu")
    n_params = cfg.param_count(16) + cfg.n_layers             # + each eps
    N, E = specs_lib._pad_to(128 * 30), specs_lib._pad_to(128 * 64)
    want = (3 * 4 * n_params + 4                      # params, m, v, step
            + (N * 16 * 4 + 2 * E * 4 + N * 4) // 16   # feats, edges, ids
            + 128 * 4)                                  # labels, replicated
    assert res["memory_stats"]["argument_bytes"] == want


def test_run_cell_fails_a_spec_that_cannot_divide():
    res = dryrun.run_cell("tinyllama-1.1b", "prefill_32k", verbose=False,
                          overrides=dict(smoke_overrides("tinyllama-1.1b"),
                                         global_batch=8))
    assert res["ok"] is False
    assert "sharding mismatch" in res["error"] and "16" in res["error"]


def test_run_cell_fails_above_the_card_memory(monkeypatch):
    monkeypatch.setattr(dryrun, "card_memory_bytes", lambda: 1e3)
    res = dryrun.run_cell("gin-tu", "molecule", verbose=False)
    assert res["ok"] is False and "exceeds one card's" in res["error"]


@pytest.mark.parametrize("shape,ov", [
    ("train_4k", {"n_layers": 3, "microbatches": 2}),
    ("prefill_32k", {"n_layers": 3}),
    ("decode_32k", {"n_layers": 3})], ids=["train", "prefill", "decode"])
def test_lm_accounting_equals_direct_trace(shape, ov):
    """The solve from L in {1, 2} (x M in {1, 2}) extrapolated to L = 3
    equals the direct trace: FLOPs, bytes, collectives and counts exactly
    (to float rounding), the traced peak within 1% (the first layer's
    allocation order differs by a few scalars to 1 MB)."""
    ov = dict(smoke_overrides("tinyllama-1.1b"), **ov)
    mesh = meta_mesh(False)
    acct = dryrun.lm_accounting("tinyllama-1.1b", shape, mesh, ov)
    cell = specs_lib.build_cell("tinyllama-1.1b", shape, mesh, ov)
    direct = dryrun._trace_cell(cell, mesh)
    for k in dryrun._ACCT_KEYS + ("output_bytes", "alias_bytes"):
        assert acct[k] == pytest.approx(direct[k], rel=1e-12, abs=1e-6), k
    assert acct["peak"] == pytest.approx(direct["peak"], rel=1e-2)
    assert direct["flops"] > 0 and direct["bytes"] > 0


def test_lm_accounting_counts_the_gradient_division_per_microbatch():
    """At M = 4 the solve counts the one division of the summed gradients
    M - 1 times: its bytes exceed the direct trace's by 2 (M - 2) x the
    gradients' bytes on one device, its FLOPs by (M - 2) x their elements;
    collectives stay exact."""
    ov = dict(smoke_overrides("tinyllama-1.1b"), n_layers=2)
    mesh = meta_mesh(False)
    acct = dryrun.lm_accounting("tinyllama-1.1b", "train_4k", mesh, ov)
    cell = specs_lib.build_cell("tinyllama-1.1b", "train_4k", mesh, ov)
    direct = dryrun._trace_cell(cell, mesh)
    M = specs_lib.TRAIN_MICRO["tinyllama-1.1b"]
    pairs = dryrun._pairs(cell.args[0].params, cell.in_specs[0].params)
    grad_bytes = dryrun.argument_bytes(cell.args[0].params,
                                       cell.in_specs[0].params, mesh)
    grad_elems = sum(math.prod(specs_lib.local_shape(t.shape, sp, mesh))
                     for t, sp in pairs)
    # and its FLOPs, one an element of the division, M - 2 times too many
    assert acct["flops"] - direct["flops"] == (M - 2) * grad_elems
    assert acct["coll"] == pytest.approx(direct["coll"], rel=1e-12)
    assert acct["bytes"] - direct["bytes"] == 2 * (M - 2) * grad_bytes


def test_collective_counter_sharded_bag_formula():
    mesh = ModelMesh((1, 4), ("data", "model"), ("meta",) * 4)
    B, F, V, D, nnz = 64, 6, 1024, 8, 4
    tables = torch.empty((F, V, D), device="meta")
    ids = torch.empty((B, F, nnz), dtype=torch.int32, device="meta")

    def both(tables, ids):
        TR.sharded_field_embedding_bag(tables, ids, mesh, impl="torch")
        TR.sharded_field_embedding_bag(tables, ids, mesh, impl="torch",
                                       scatter_batch=True)

    got = dryrun.trace(both, (tables, ids), None, mesh.shape)["traffic"]
    assert got == [("all-reduce", B * F * D * 4, 4),
                   ("reduce-scatter", B * F * D * 4, 4)]
    # and nothing is recorded when the counter is off
    assert coll.TRACER is None
    TR.sharded_field_embedding_bag(tables, ids, mesh, impl="torch")


def test_collective_counter_gradient_all_reduce():
    """GIN's parameters are replicated: each gradient is all-reduced over
    the 16 data shards once a leaf (its partial sum over the batch), 2 x
    15/16 of its bytes on the wire. Beside them, exactly: each layer
    all-gathers the (N/16, width) node rows its messages read and
    all-reduces its partial (N, width) aggregate at its constraint; the
    backward all-gathers each aggregate's row-split gradient there, but
    the first layer's (its input needs none); and the loss all-reduces
    its count of labelled nodes and its sum, 4 bytes each."""
    mesh = meta_mesh(False)
    cell = specs_lib.build_cell("gin-tu", "full_graph_sm", mesh)
    res = dryrun._trace_cell(cell, mesh)
    cfg = get_config("gin-tu")
    leaves = dryrun._tensors(cell.args[0])
    assert sum(t.numel() for t in leaves) == cfg.param_count(1433) \
        + cfg.n_layers
    N, feat = cell.args[2].shape
    widths = [feat] + [cfg.d_hidden] * (cfg.n_layers - 1)
    grads = collections.Counter(("all-reduce", float(t.numel() * 4), 16)
                                for t in leaves)
    layers = collections.Counter()
    for i, w in enumerate(widths):
        layers["all-gather", float(N // 16 * w * 4), 16] += 1 + (i > 0)
        layers["all-reduce", float(N * w * 4), 16] += 1
    layers["all-reduce", 4.0, 16] += 2
    assert collections.Counter(res["traffic"]) == grads + layers
    assert res["count_all-reduce"] == len(leaves) + cfg.n_layers + 2
    assert res["coll_all-reduce"] == pytest.approx(
        sum(b * n for (k, b, _), n in (grads + layers).items()
            if k == "all-reduce") * 2 * 15 / 16, rel=1e-12)
    assert res["coll"] == pytest.approx(
        sum(b * dryrun._wire_factor(k, g) * n
            for (k, b, g), n in (grads + layers).items()), rel=1e-12)


REFERENCE_KEYS = {"arch", "shape", "mesh", "n_chips", "compile_s",
                  "hlo_flops_per_dev", "hlo_bytes_per_dev",
                  "collective_bytes_per_dev", "collective_breakdown",
                  "collective_counts", "compute_s_term", "memory_s_term",
                  "collective_s_term", "dominant", "model_flops_total",
                  "useful_flops_ratio", "memory_stats", "note", "ok"}
PORT_KEYS = {"involuntary_gathers"}      # the port's count, beside them


def test_main_writes_the_reference_keys(tmp_path, capsys):
    out = tmp_path / "plans.json"
    dryrun.main(["--arch", "gin-tu", "--shape", "molecule", "--out",
                 str(out)])
    results = json.loads(out.read_text())
    assert list(results) == ["gin-tu|molecule|singlepod"]
    res = results["gin-tu|molecule|singlepod"]
    assert set(res) == REFERENCE_KEYS | PORT_KEYS and res["ok"]
    assert set(res["memory_stats"]) == {
        "argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
        "peak_estimate_gb"}
    assert res["mesh"] == "16x16 (data,model)" and res["n_chips"] == 256
    assert "gin-tu x molecule" in capsys.readouterr().out
    dryrun.main(["--arch", "gin-tu", "--shape", "molecule", "--out",
                 str(out)])                       # an ok cell is kept
    assert "[skip] gin-tu|molecule|singlepod" in capsys.readouterr().out


def test_run_ercache_cell_plans_the_reference_tier(monkeypatch):
    """The reference's 2**22 x 8 x 256 float32 tables, planned on meta
    (a (1, 4) model mesh and 4 cache shards keep the trace short)."""
    mesh = ModelMesh((1, 4), ("data", "model"), ("cpu",) * 4)
    combines = []
    combine = coll._combine_probe

    def spy(results, owned, bucket, n_shards):
        combines.append(n_shards)
        return combine(results, owned, bucket, n_shards)
    monkeypatch.setattr(coll, "_combine_probe", spy)
    res = dryrun.run_ercache_cell(verbose=False, mesh=mesh,
                                  cache_mesh=CacheMesh(("cpu",) * 4))
    assert res["ok"] and res["note"] == "n_buckets=4194304 seq=64"
    nb, W, D, B = 1 << 22, 8, 256, 4096
    table = nb * W * (4 * 4 + D * 4)                 # 4 int32 planes + values
    rings = B * (4 * 3 + D * 4 + 4) + 4 + B * 5 * 4 + 4 + 4
    assert res["argument_bytes"]["state"] == 2 * table // 4 + rings
    assert res["argument_bytes"]["inputs"] == B * 2 * 4 + B * 64 * 4
    params = sum(t.numel() * t.element_size() for t in dryrun._tensors(
        TT.abstract_params(get_config("tinyllama-1.1b"))))
    assert res["argument_bytes"]["params"] < params        # sharded
    assert res["hlo_flops_per_dev"] > 0
    # the probe's combine: 4 psums per tier over the 4 cache shards; the
    # tower's vocab-split embedding all-reduces its partial rows once; each
    # layer's heads stay split over model through the attention (the
    # einsums' merged (rows, heads) dims split back onto the dims they came
    # from), so its output projection and its FFN's down projection each
    # leave a partial sum, all-reduced at the residual add (Megatron's two
    # all-reduces a layer); nothing is gathered
    assert combines == [4, 4]
    n_layers = get_config("tinyllama-1.1b").n_layers
    assert res["collective_counts"] == {
        "all-reduce": 8 + 1 + 2 * n_layers, "all-gather": 0,
        "reduce-scatter": 0, "all-to-all": 0, "collective-permute": 0}
