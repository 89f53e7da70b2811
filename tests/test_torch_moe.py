"""repro_torch's MoE FFN (``models/moe.py``) and the MoE LMs (Granite,
Arctic) against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
parameters come from the JAX ``init_params`` / ``init_moe_params``
through ``load_jax_params``. Tolerances: expert ids, capacities, dispatch
and combine tensors exactly (dispatch and combine given the same ids and
gates; ties broken toward the lower expert id in both); gates and router
probabilities at atol 1e-6 (XLA and torch round a softmax's last ulp
differently); the MoE block, its aux loss and the towers' outputs at
atol 2e-5 / rtol 1e-4 (``TOWER_*``: matmuls summed in other orders); the
prefill and decode logits and caches at atol 1e-4 (float32 over two
layers, as ``test_torch_decode.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import assert_exact, assert_float  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.configs.base import MoEConfig as JMoE  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.configs.base import MoEConfig as TMoE  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

MOE_LMS = ["granite-moe-1b-a400m", "arctic-480b"]
GATE_ATOL = 1e-6
ATOL = 1e-4

_j_prefill = jax.jit(JT.prefill_step, static_argnums=(2,))
_j_decode = jax.jit(JT.decode_step, static_argnums=(3,))
_j_gating = jax.jit(JM.top_k_gating, static_argnums=(1,))
_j_dispatch = jax.jit(JM.dispatch_combine_tensors, static_argnums=(2, 3))
_j_moe_ffn = jax.jit(JM.moe_ffn, static_argnums=(2, 3))
_j_tower = jax.jit(JT.user_tower_step, static_argnums=(2,))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """SMOKE-sized torch ops on one thread: the suite runs several
    workers, and torch's thread pools oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_configs_registered_and_equal_to_reference():
    """The reference's 10 archs (gin-tu included since the GNN was
    ported), the MoE configs field for field; an unknown arch raises."""
    from repro.configs import list_archs as j_list_archs

    assert list_archs() == j_list_archs() and len(list_archs()) == 10
    for arch in MOE_LMS:
        for smoke in (False, True):
            j, t = j_config(arch, smoke), t_config(arch, smoke)
            assert dataclasses.asdict(t) == dataclasses.asdict(j), arch
            assert t.param_count() == j.param_count()
    with pytest.raises(ValueError, match="unknown arch"):
        t_config("gin-tu-xl")


def test_group_size_and_capacity_match_reference():
    for n_experts, top_k in ((8, 4), (32, 8), (128, 2)):
        jm, tm = JMoE(n_experts, top_k), TMoE(n_experts, top_k)
        for n_tokens in (1, 7, 64, 65, 80, 128, 1000, 1024, 4096):
            for max_group in (16, 64, 512):
                g = JM.pick_group_size(n_tokens, max_group)
                assert TM.pick_group_size(n_tokens, max_group) == g
                assert TM.capacity_for(g, tm) == JM.capacity_for(g, jm)


def _tied_logits(rng, G, T, E):
    """float32 router logits with tied rows: every 5th token all equal,
    every 7th with its first 4 experts equal to the next 4."""
    lg = rng.standard_normal((G, T, E)).astype(np.float32)
    lg[:, ::5] = 0.5
    lg[:, 1::7, :4] = lg[:, 1::7, 4:8]
    return lg


@pytest.mark.parametrize("G,T,E,k", [(2, 80, 8, 4), (3, 100, 16, 2),
                                     (1, 64, 32, 8)])
def test_gating_and_dispatch_match_reference(G, T, E, k):
    rng = np.random.default_rng(G * 1000 + T)
    lg = _tied_logits(rng, G, T, E)
    jg, ji, jp = _j_gating(jnp.asarray(lg), k)
    tg, ti, tp = TM.top_k_gating(torch.as_tensor(lg), k)
    assert_exact(ti, np.asarray(ji).astype(np.int64), "expert ids")
    assert_float(tg, jg, "gates", atol=GATE_ATOL, rtol=0)
    assert_float(tp, jp, "probs", atol=GATE_ATOL, rtol=0)
    # on a tied row the lower ids win, in order
    assert ti[0, 0].tolist() == list(range(k))
    C = JM.capacity_for(T, JMoE(E, k))
    jd, jc = _j_dispatch(ji, jg, E, C)
    td, tc = TM.dispatch_combine_tensors(
        torch.as_tensor(np.asarray(ji)).long(),
        torch.as_tensor(np.asarray(jg)), E, C)
    assert_exact(td, jd, "dispatch")
    assert_exact(tc, jc, "combine")
    # the port's own ids dispatch the same tokens
    assert_exact(TM.dispatch_combine_tensors(ti, tg, E, C)[0], jd,
                 "dispatch from the port's gating")
    if T > 64:
        assert float(td.sum()) < G * T * k          # the capacity drops


@pytest.mark.parametrize("k", [1, 2, 8])
def test_slot_by_slot_dispatch_is_bit_exact_with_drops(k):
    """The port adds one top-k slot's (G, T, E, C) share at a time where
    the reference sums a (G, T, K, E, C) product over K: a token's experts
    are distinct, so each element takes one slot's value or none, and the
    two agree bit for bit (the float32 words compared), capacity drops
    included (the low experts favoured, so they overflow)."""
    G, T, E = 2, 96, 16
    rng = np.random.default_rng(k)
    favour = np.linspace(4.0, 1.0, E)
    favour /= favour.sum()
    ids = np.array([[rng.choice(E, k, replace=False, p=favour)
                     for _ in range(T)] for _ in range(G)], np.int32)
    gates = rng.random((G, T, k)).astype(np.float32)
    gates /= gates.sum(-1, keepdims=True)
    C = JM.capacity_for(T, JMoE(E, k))
    jd, jc = _j_dispatch(jnp.asarray(ids), jnp.asarray(gates), E, C)
    td, tc = TM.dispatch_combine_tensors(torch.as_tensor(ids).long(),
                                         torch.as_tensor(gates), E, C)
    for got, want, what in ((td, jd, "dispatch"), (tc, jc, "combine")):
        assert_exact(got.numpy().view(np.int32),
                     np.asarray(want).view(np.int32), what)
    assert float(td.sum()) < G * T * k            # slots were dropped


def _favoured_routing(G, T, E, k):
    """Distinct expert ids a token drawn with the low experts favoured (so
    they overflow their capacity) and renormalised gates, as numpy."""
    rng = np.random.default_rng(k)
    favour = np.linspace(4.0, 1.0, E)
    favour /= favour.sum()
    ids = np.array([[rng.choice(E, k, replace=False, p=favour)
                     for _ in range(T)] for _ in range(G)], np.int32)
    gates = rng.random((G, T, k)).astype(np.float32)
    return ids, gates / gates.sum(-1, keepdims=True)


def _dense_from_index(dest, weights, G, T, E, C):
    """``index_routing``'s rows and weights scattered into (G, T, E, C)
    dispatch (1.0) and combine (the weight) tensors; the dump row's
    assignments are left out."""
    K = dest.shape[-1]
    kept = dest < E * G * C
    e, gc = dest // (G * C), dest % (G * C)
    gg, tt = torch.meshgrid(torch.arange(G), torch.arange(T), indexing="ij")
    gg, tt = (a[..., None].expand(G, T, K) for a in (gg, tt))
    assert torch.equal(gc[kept] // C, gg[kept])      # its own group's rows
    at = (gg[kept], tt[kept], e[kept], gc[kept] % C)
    disp = torch.zeros(G, T, E, C).index_put_(at, torch.tensor(1.0))
    comb = torch.zeros(G, T, E, C).index_put_(at, weights[kept])
    return disp, comb


@pytest.mark.parametrize("case", ["tied-2-80-8-4", "tied-3-100-16-2",
                                  "tied-1-64-32-8", "favoured-k1",
                                  "favoured-k2", "favoured-k8"])
def test_index_routing_is_the_dense_dispatch_bit_for_bit(case):
    """``index_routing``'s rows and weights, scattered into (G, T, E, C)
    tensors, are the reference's ``dispatch_combine_tensors`` bit for bit
    (the float32 words compared), capacity drops included: the tied
    gating cases of ``test_gating_and_dispatch_match_reference`` and the
    drop-heavy favoured-expert ones."""
    kind, *dims = case.split("-")
    if kind == "tied":
        G, T, E, k = map(int, dims)
        lg = _tied_logits(np.random.default_rng(G * 1000 + T), G, T, E)
        jg, ji, _ = _j_gating(jnp.asarray(lg), k)
        ids, gates = np.asarray(ji), np.asarray(jg)
    else:
        G, T, E, k = 2, 96, 16, int(dims[0][1:])
        ids, gates = _favoured_routing(G, T, E, k)
    C = JM.capacity_for(T, JMoE(E, k))
    jd, jc = _j_dispatch(jnp.asarray(ids), jnp.asarray(gates), E, C)
    dest, w = TM.index_routing(torch.as_tensor(ids).long(),
                               torch.as_tensor(gates), E, C)
    assert dest.shape == ids.shape and w.dtype == torch.float32
    td, tc = _dense_from_index(dest, w, G, T, E, C)
    for got, want, what in ((td, jd, "dispatch"), (tc, jc, "combine")):
        assert_exact(got.numpy().view(np.int32),
                     np.asarray(want).view(np.int32), what)
    if T > 64:
        assert bool((dest == E * G * C).any())        # slots were dropped


def test_indexed_moe_ffn_holds_no_dense_tensor_and_matches_dense():
    """``moe_ffn`` without a mesh (counted ``indexed``) at a shape that
    drops slots: no op of the forward or the backward outputs G*T*E*C
    elements or more (the dense path does), and its output, aux loss and
    the router's and experts' gradients are the dense path's (a one-device
    mesh) at the tower tolerances."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.launch.mesh import ModelMesh

    class Sizes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.most = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    self.most = max(self.most, t.numel())
            return out

    G, T, D, Fw = 2, 96, 32, 48
    cfg = TMoE(16, 4)
    E, C = cfg.n_experts, TM.capacity_for(T, cfg)
    gen = torch.Generator().manual_seed(3)
    params = TM.init_moe_params(gen, D, Fw, cfg)
    params["router"][:, :4] += 0.3              # the low experts overflow
    x = torch.randn(G, T, D, generator=gen)
    _, idx, _ = TM.top_k_gating(x @ params["router"], cfg.top_k)
    assert bool((TM.slot_positions(idx, E) >= C).any())

    mesh = ModelMesh((1, 1), ("data", "model"), ("cpu",))
    runs = {}
    for name, m in (("indexed", None), ("dense", mesh)):
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        n0 = TM.ROUTES[name]
        with Sizes() as sizes:
            y, aux = TM.moe_ffn(x, p, cfg, T, mesh=m)
            (y.square().sum() + aux).backward()
        assert TM.ROUTES[name] == n0 + 1
        runs[name] = (sizes.most, y.detach(), aux.detach(),
                      {k: v.grad for k, v in p.items()})
    assert runs["indexed"][0] < G * T * E * C <= runs["dense"][0]
    (_, y, aux, grads), (_, y_d, aux_d, grads_d) = (runs["indexed"],
                                                    runs["dense"])
    assert_float(y, y_d, "moe out")
    assert_float(aux, aux_d, "aux")
    for k in grads:
        assert_float(grads[k], grads_d[k], f"grad {k}")


@pytest.mark.parametrize("group_size", [512, 32], ids=["drops", "dropless"])
@pytest.mark.parametrize("arch", MOE_LMS)
def test_moe_ffn_matches_jax(arch, group_size, rng):
    """One 80-token group (capacity below T*k/E*1.25 drops slots) or
    groups of 20 (dropless): output and aux loss."""
    jcfg = j_config(arch, smoke=True)
    tcfg = t_config(arch, smoke=True)
    D, F = jcfg.d_model, jcfg.d_ff
    p = JM.init_moe_params(jax.random.PRNGKey(1), D, F, jcfg.moe,
                           jnp.float32)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in p.items()}
    x = rng.standard_normal((2, 40, D)).astype(np.float32)
    jy, jaux = _j_moe_ffn(jnp.asarray(x), p, jcfg.moe, group_size)
    ty, taux = TM.moe_ffn(torch.as_tensor(x), tp, tcfg.moe, group_size)
    assert ty.shape == x.shape and taux.dtype == torch.float32
    assert_float(ty, jy, "moe out")
    assert_float(taux, jaux, "aux")


def test_init_moe_params_shapes_and_scales():
    cfg = t_config("granite-moe-1b-a400m", smoke=True)
    p = TM.init_moe_params(torch.Generator().manual_seed(0), 64, 256,
                           cfg.moe, torch.bfloat16)
    j = JM.init_moe_params(jax.random.PRNGKey(0), 64, 256, cfg.moe,
                           jnp.bfloat16)
    for k in j:
        assert tuple(p[k].shape) == j[k].shape, k
        assert str(p[k].dtype).split(".")[1] == str(j[k].dtype), k
    assert abs(float(p["wd"].float().std()) - 256 ** -0.5) < 5e-3
    assert abs(float(p["router"].std()) - 64 ** -0.5) < 5e-3


def _models(arch, seed=0):
    jcfg, tcfg = j_config(arch, smoke=True), t_config(arch, smoke=True)
    params = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    model = TT.load_jax_params(jax.tree_util.tree_map(np.asarray, params),
                               tcfg, device="cpu")
    return jcfg, tcfg, params, model


@pytest.mark.parametrize("arch", MOE_LMS)
def test_moe_init_params_cover_the_reference_leaves(arch):
    cfg = t_config(arch, smoke=True)
    model = TT.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    jshapes = jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype)),
        JT.abstract_params(j_config(arch, smoke=True)))
    tree = TT.param_tree(model)
    got = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).split(".")[1]), tree)
    assert got == jshapes
    assert tree["layers"]["router"].dtype == torch.float32
    E, D, F = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    assert model.layers[1].moe_wd.shape == (E, F, D)
    assert abs(float(model.stack["moe_wd"].std()) - F ** -0.5) < 0.01


@pytest.mark.parametrize("arch", MOE_LMS)
def test_moe_tower_prefill_decode_match_jax(arch, rng):
    """user_tower_step over 80 tokens a row (one group of 160: capacity
    drops), prefill of 12 tokens into a cache padded to 16, then 3
    chained decode steps (3 tokens: dropless)."""
    jcfg, tcfg, params, model = _models(arch)
    toks = rng.integers(0, jcfg.vocab, (2, 80)).astype(np.int32)
    want = _j_tower(params, jnp.asarray(toks), jcfg)
    got = TT.user_tower_step(model, torch.as_tensor(toks), tcfg,
                             backend="torch")
    assert_float(got, want, "user tower")

    toks = rng.integers(0, jcfg.vocab, (3, 12)).astype(np.int32)
    jl, jc = _j_prefill(params, jnp.asarray(toks), jcfg)
    w = ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0))
    jc = JT.KVCache(k=jnp.pad(jc.k, w), v=jnp.pad(jc.v, w), length=jc.length)
    tl, tc = TT.prefill_step(model, torch.as_tensor(toks), tcfg,
                             backend="torch", max_seq=16)
    assert_float(tl, jl, "prefill logits", atol=ATOL, rtol=0)
    nxt = toks[:, 0]
    for step in range(3):
        jl, jc = _j_decode(params, jc, jnp.asarray(nxt), jcfg)
        tl, tc = TT.decode_step(model, tc, torch.as_tensor(nxt), tcfg,
                                backend="torch")
        assert_float(tl, jl, f"decode logits {step}", atol=ATOL, rtol=0)
        assert_float(tc.k, jc.k, f"cache k {step}", atol=ATOL, rtol=0)
        assert_float(tc.v, jc.v, f"cache v {step}", atol=ATOL, rtol=0)
        nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    assert tc.length.tolist() == [15] * 3
