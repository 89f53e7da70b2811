"""repro_torch's training slice against the JAX package, on the CPU: the
optimizers, ``lm_loss`` and its gradients, the LM and recsys train
steps, NE, the train loop's checkpoints in both directions, the launcher
and the guards that keep a gradient from being lost or a run from
quietly leaving the card.

Inputs are made with numpy from a seed and handed to both packages;
parameters come from the JAX ``init_params`` through ``load_jax_params``.
Tolerances: optimizer updates and new states at rtol 1e-6, with an
absolute floor of 1e-6 of the leaf's largest magnitude (float32 element
arithmetic; the global norm is summed in another order, so the clip scale
may differ by one ulp, which an update that cancels to near 0 in its
second step amplifies);
losses at rtol 1e-4 (the towers' matmuls summed in other orders, through
a few steps); gradients at atol 1e-5 / rtol 1e-4; parameters after one
SGD step at atol 1e-6; NE at rtol 1e-6 (float32) and exactly (the numpy
accumulator, a copy).
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import assert_float  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.ft import checkpoint as j_ckpt  # noqa: E402
from repro.launch import train as j_train  # noqa: E402
from repro.models import recsys as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import ne as j_ne  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training import train_loop as j_loop  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.examples import train_lm as t_example  # noqa: E402
from repro_torch.ft import checkpoint as t_ckpt  # noqa: E402
from repro_torch.kernels import decode_attention as TDA  # noqa: E402
from repro_torch.kernels import embedding_bag as TEB  # noqa: E402
from repro_torch.kernels import flash_attention as TFA  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import recsys as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.training import ne as t_ne  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.training import train_loop as t_loop  # noqa: E402

OPT_RTOL = 1e-6
LOSS_RTOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
SGD_PARAM_ATOL = 1e-6
DENSE, MOE = "tinyllama-1.1b", "granite-moe-1b-a400m"
RECSYS = ["wide-deep", "sasrec", "bst", "mind"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """SMOKE-sized torch ops on one thread: the suite runs several
    workers, and torch's thread pools oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _assert_trees(got, want, what, atol, rtol):
    """Leaf by leaf; ``atol=None`` takes ``rtol`` of the leaf's largest
    magnitude as the absolute floor."""
    g, w = TO.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w), (what, len(g), len(w))
    for i, (a, b) in enumerate(zip(g, w)):
        assert tuple(a.shape) == tuple(b.shape), (what, i)
        b = np.asarray(b, np.float64)
        floor = rtol * np.abs(b).max(initial=0.0) if atol is None else atol
        np.testing.assert_allclose(_np(a), b, atol=floor, rtol=rtol,
                                   err_msg=f"{what} leaf {i}")


# ------------------------------------------------- satellite: the guards
@pytest.mark.parametrize("kernel", ["embedding_bag", "flash_attention",
                                    "decode_attention"])
def test_hand_kernels_refuse_inputs_that_need_a_gradient(kernel):
    """A kernel's output has no grad_fn: the wrappers raise before any
    device branch while autograd records, and run under no_grad."""
    g = torch.Generator().manual_seed(0)
    if kernel == "embedding_bag":
        table = torch.randn(10, 4, generator=g, requires_grad=True)
        call = lambda: TEB.embedding_bag(table, torch.zeros(
            (3, 2), dtype=torch.int32))
    elif kernel == "flash_attention":
        q = torch.randn(1, 128, 4, 8, generator=g, requires_grad=True)
        k = torch.randn(1, 128, 2, 8, generator=g)
        call = lambda: TFA.flash_attention(q, k, k)
    else:
        q = torch.randn(2, 4, 8, generator=g)
        k = torch.randn(2, 16, 2, 8, generator=g, requires_grad=True)
        call = lambda: TDA.decode_attention(q, k, k)
    with pytest.raises(RuntimeError, match="no backward.*ref\\."):
        call()
    with torch.no_grad():
        assert call().grad_fn is None


# ------------------------------------------------------------ optimizers
def _opt_case(rng):
    """Params, two rounds of grads: a stacked (L, 128, 128) leaf and a
    (200, 130) leaf (both factored by Adafactor), a (4, 64) and a bias
    (not), in float32 and one bfloat16 leaf."""
    shapes = {"stacked": (3, 128, 128), "wide": (200, 130), "small": (4, 64),
              "bias": (64,)}
    mk = lambda: {k: rng.standard_normal(s).astype(np.float32)
                  for k, s in shapes.items()}
    return mk(), [mk(), mk()]


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


@pytest.mark.parametrize("name", ["sgd", "sgd_momentum", "adamw",
                                  "adamw_wd", "adafactor",
                                  "adamw_cosine_noclip"])
def test_optimizer_updates_match_reference(name, rng):
    """Two updates from identical grads and state: the updates and every
    state leaf; ``apply`` (in place) gives ``update``'s parameters."""
    ctor = {
        "sgd": lambda m: m.sgd(lr=0.1),
        "sgd_momentum": lambda m: m.sgd(lr=0.1, momentum=0.9),
        "adamw": lambda m: m.adamw(lr=1e-2),
        "adamw_wd": lambda m: m.adamw(lr=1e-2, weight_decay=0.1,
                                      clip_norm=5.0),
        "adafactor": lambda m: m.adafactor(lr=1e-2),
        "adamw_cosine_noclip": lambda m: m.adamw(
            lr=m.cosine_schedule(1e-2, 1, 4), clip_norm=None),
    }[name]
    jo, to = ctor(JO), ctor(TO)
    params, grads = _opt_case(rng)
    jp, tp, tp2 = _j(params), _t(params), _t(params)
    js, ts, ts2 = jo.init(jp), to.init(tp), to.init(tp2)
    for g in grads:
        ju, js = jo.update(_j(g), js, jp)
        tu, ts = to.update(_t(g), ts, tp)
        _assert_trees(tu, ju, f"{name} updates", None, OPT_RTOL)
        _assert_trees(ts, js, f"{name} state", None, OPT_RTOL)
        assert ts["step"].dtype == torch.int32
        jp = jax.tree_util.tree_map(jnp.add, jp, ju)
        tp = {k: tp[k] + tu[k] for k in tp}
        ts2 = to.apply(_t(g), ts2, tp2)
        for k in tp:
            assert torch.equal(tp2[k], tp[k]), (name, k)
    _assert_trees(tp, jp, f"{name} params", None, OPT_RTOL)


@pytest.mark.parametrize("name", ["sgd_momentum", "adamw_wd"])
def test_optimizer_row_blocks_give_the_same_numbers(name, monkeypatch, rng):
    """AdamW and SGD apply a large leaf a block of rows at a time (10 GB
    tables): with blocks of 50 elements the parameters and the state are
    those of the whole-leaf update, bit for bit (without the global-norm
    clip, whose sum over a blocked leaf runs block by block)."""
    make = {"sgd_momentum": lambda: TO.sgd(lr=0.1, momentum=0.9),
            "adamw_wd": lambda: TO.adamw(lr=1e-2, weight_decay=0.1,
                                         clip_norm=None)}[name]
    params, grads = _opt_case(rng)
    whole, blocks = _t(params), _t(params)
    s_whole = make().init(whole)
    for g in grads:
        s_whole = make().apply(_t(g), s_whole, whole)
    monkeypatch.setattr(TO, "CHUNK_ELEMS", 50)
    s_blocks = make().init(blocks)
    for g in grads:
        s_blocks = make().apply(_t(g), s_blocks, blocks)
    for a, b in zip(TO.tree_leaves((blocks, s_blocks)),
                    TO.tree_leaves((whole, s_whole))):
        assert torch.equal(a, b)


def test_adafactor_clips_a_stacked_leaf_as_one():
    """The RMS clip spans the whole stacked leaf: per-layer slices give
    other updates (why the LM holds its layer leaves stacked). The second
    step's grads are 100x the first in layer 0 (its RMS alone would clip)
    and 1/100 of them in the others."""
    rng = np.random.default_rng(1)
    g1 = rng.standard_normal((3, 128, 128)).astype(np.float32)
    g2 = rng.standard_normal((3, 128, 128)).astype(np.float32)
    g2[0] *= 100.0
    g2[1:] *= 0.01
    p = np.zeros_like(g1)

    def two_steps(mod, arr, sl):
        opt = mod.adafactor(lr=1.0)
        w = {"w": arr(p[sl])}
        st = opt.init(w)
        _, st = opt.update({"w": arr(g1[sl])}, st, w)
        return opt.update({"w": arr(g2[sl])}, st, w)[0]["w"]

    u = two_steps(TO, torch.tensor, slice(None))
    assert_float(u, two_steps(JO, jnp.asarray, slice(None)), atol=0,
                 rtol=OPT_RTOL)
    split = torch.stack([two_steps(TO, torch.tensor, i) for i in range(3)])
    assert not torch.allclose(split, u, rtol=1e-3)


def test_schedules_and_clip_match_reference(rng):
    for warmup, total in ((0, 10), (3, 10), (100, 10_000)):
        jl, tl = (JO.cosine_schedule(3e-4, warmup, total),
                  TO.cosine_schedule(3e-4, warmup, total))
        for s in (0, 1, 2, 3, 5, 9, 10, 11, 5000, 20_000):
            np.testing.assert_allclose(
                float(tl(torch.tensor(s, dtype=torch.int32))),
                float(jl(jnp.int32(s))), rtol=OPT_RTOL)
    tree = {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": rng.standard_normal(9).astype(np.float32)}
    assert_float(TO.global_norm(_t(tree)), JO.global_norm(_j(tree)),
                 atol=0, rtol=OPT_RTOL)
    _assert_trees(TO.clip_by_global_norm(_t(tree), 0.5),
                  JO.clip_by_global_norm(_j(tree), 0.5), "clip", None,
                  OPT_RTOL)
    for cfg in (t_config(DENSE, True), t_config(MOE, True),
                t_config("sasrec", True)):
        jcfg = j_config(cfg.arch_id.replace("-smoke", ""), True)
        t_keys = set(TO.for_config(cfg).init({"w": torch.zeros(2, 2)}))
        j_keys = set(JO.for_config(jcfg).init({"w": jnp.zeros((2, 2))}))
        assert t_keys == j_keys


# --------------------------------------------------------------- LM loss
def _lm(arch, seed=0, **over):
    jcfg = dataclasses.replace(j_config(arch, smoke=True), **over)
    tcfg = dataclasses.replace(t_config(arch, smoke=True), **over)
    params = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    model = TT.load_jax_params(jax.tree_util.tree_map(np.asarray, params),
                               tcfg, device="cpu")
    return jcfg, tcfg, params, model


def _lm_batch(rng, cfg, batch=4, seq=16):
    toks = rng.integers(0, cfg.vocab, (batch, seq + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1                              # masked positions
    return {"tokens": toks[:, :-1], "labels": labels}


@pytest.mark.parametrize("arch", [DENSE, MOE])
def test_lm_loss_and_grads_match_jax(arch, rng):
    jcfg, tcfg, params, model = _lm(arch)
    b = _lm_batch(rng, jcfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(JT.lm_loss, has_aux=True),
                           static_argnums=(3,))(
        params, jnp.asarray(b["tokens"]), jnp.asarray(b["labels"]), jcfg)
    tree = TO.trainable(TT.param_tree(model))
    tl, tm = TT.lm_loss(TT.bind_tree(model, tree),
                        torch.as_tensor(b["tokens"]),
                        torch.as_tensor(b["labels"]), tcfg)
    tg = TO.leaf_grads(tl, tree)
    assert_float(tl, jl, "loss", atol=0, rtol=LOSS_RTOL)
    assert_float(tm["ce"], jm["ce"], "ce", atol=0, rtol=LOSS_RTOL)
    assert_float(tm["aux"], jm["aux"], "aux", atol=1e-6, rtol=LOSS_RTOL)
    _assert_trees(tg, jg, "grads", GRAD_ATOL, GRAD_RTOL)
    assert float(tg["user_head"].abs().sum()) == 0.0  # unused: zeros


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("arch", [DENSE, MOE])
def test_train_step_sgd_params_match_jax(arch, micro, rng):
    """One SGD step: metrics, and every parameter after it, tight."""
    jcfg, tcfg, params, model = _lm(arch, microbatches=micro, remat=False)
    b = _lm_batch(rng, jcfg)
    jo, to = JO.sgd(lr=0.05), TO.sgd(lr=0.05)
    js = JT.TrainState(params, jo.init(params), jnp.int32(0))
    tree = TT.param_tree(model)
    ts = TT.TrainState(tree, to.init(tree), torch.zeros((), dtype=torch.int32))
    js, jm = jax.jit(JT.make_train_step(jcfg, jo))(js, _j(b))
    ts, tm = TT.make_train_step(tcfg, to)(ts, _t(b))
    for k in ("loss", "ce", "grad_norm"):
        assert_float(tm[k], jm[k], k, atol=0, rtol=LOSS_RTOL)
    assert int(ts.step) == 1 and ts.step.dtype == torch.int32
    _assert_trees(ts.params, js.params, "params", SGD_PARAM_ATOL, 0)
    assert ts.params["embed"] is model.embed          # updated in place
    if micro == 2:
        with pytest.raises(ValueError, match="microbatches"):
            TT.make_train_step(tcfg, to)(ts, _t({k: v[:3]
                                                 for k, v in b.items()}))


_J_STEPS = {}


def _j_step(cfg, opt, key):
    if key not in _J_STEPS:
        _J_STEPS[key] = jax.jit(JT.make_train_step(cfg, opt))
    return _J_STEPS[key]


@pytest.mark.parametrize("arch", [DENSE, MOE])
def test_train_step_three_steps_match_jax(arch, rng):
    """The launcher's optimizer (AdamW + cosine for the dense LM,
    Adafactor for the MoE) and two microbatches with remat: three steps,
    the metrics of each."""
    jcfg, tcfg, params, model = _lm(arch, microbatches=2)
    jo, to = JO.for_config(jcfg, 10), TO.for_config(tcfg, 10)
    js = JT.TrainState(params, jo.init(params), jnp.int32(0))
    tree = TT.param_tree(model)
    ts = TT.TrainState(tree, to.init(tree), torch.zeros((), dtype=torch.int32))
    jstep, tstep = _j_step(jcfg, jo, arch), TT.make_train_step(tcfg, to)
    for i in range(3):
        b = _lm_batch(rng, jcfg)
        js, jm = jstep(js, _j(b))
        ts, tm = tstep(ts, _t(b))
        for k in ("loss", "ce", "grad_norm"):
            assert_float(tm[k], jm[k], f"step {i} {k}", atol=0,
                         rtol=LOSS_RTOL)


# ----------------------------------------------------------------- recsys
def _recsys(arch, seed=0):
    jcfg, tcfg = j_config(arch, smoke=True), t_config(arch, smoke=True)
    params = JR.init_params(jax.random.PRNGKey(seed), jcfg)
    model = TR.load_jax_params(jax.tree_util.tree_map(np.asarray, params),
                               device="cpu")
    return jcfg, tcfg, params, model


@pytest.mark.parametrize("arch", RECSYS)
def test_recsys_loss_and_train_step_match_jax(arch):
    """loss_fn and its gradients on one batch, then three AdamW steps of
    make_train_step (the launcher's batches, drawn by both packages'
    generators from one seed)."""
    jcfg, tcfg, params, model = _recsys(arch)
    jb = j_train.recsys_batches(jcfg, 32)
    tb = t_train.recsys_batches(tcfg, 32, device="cpu")
    b = next(jb)
    tbatch = next(tb)
    for k in b:
        np.testing.assert_array_equal(_np(tbatch[k]), np.asarray(b[k]))
    jl, jg = jax.jit(jax.value_and_grad(JR.loss_fn),
                     static_argnums=(2,))(params, b, jcfg)
    tree = TO.trainable(TR.param_tree(model))
    tl = TR.loss_fn(TR.bind_tree(model, tree), tbatch, tcfg)
    assert_float(tl, jl, "loss", atol=0, rtol=LOSS_RTOL)
    _assert_trees(TO.leaf_grads(tl, tree), jg, "grads", GRAD_ATOL,
                  GRAD_RTOL)
    jo, to = JO.for_config(jcfg), TO.for_config(tcfg)
    jstate, tstate = jo.init(params), to.init(tree)
    jstep = jax.jit(JR.make_train_step(jcfg, jo))
    tstep = TR.make_train_step(tcfg, to)
    for i in range(3):
        b, tbatch = next(jb), next(tb)
        params, jstate, jm = jstep(params, jstate, b)
        tree, tstate, tm = tstep(tree, tstate, tbatch)
        assert_float(tm["loss"], jm["loss"], f"step {i}", atol=0,
                     rtol=LOSS_RTOL)
    assert TR.param_tree(model)["item_emb" if arch != "wide-deep"
                                else "tables"] is tree[
        "item_emb" if arch != "wide-deep" else "tables"]


# --------------------------------------------------------------------- NE
def test_ne_matches_reference(rng):
    labels = (rng.uniform(size=500) < 0.3).astype(np.float32)
    preds = np.clip(rng.uniform(size=500), 0, 1).astype(np.float32)
    preds[:3] = [0.0, 1.0, 0.5]
    want = j_ne.ne_jnp(jnp.asarray(labels), jnp.asarray(preds))
    got = t_ne.ne(torch.as_tensor(labels), torch.as_tensor(preds))
    assert_float(got, want, atol=0, rtol=1e-6)
    ja, ta = j_ne.NEAccumulator(), t_ne.NEAccumulator()
    assert np.isnan(ta.ne) and np.isnan(ja.ne)
    for lo in range(0, 500, 125):
        ja.add(labels[lo:lo + 125], preds[lo:lo + 125])
        ta.add(labels[lo:lo + 125], preds[lo:lo + 125])
    assert dataclasses.asdict(ta) == dataclasses.asdict(ja)
    assert ta.ne == ja.ne
    assert t_ne.ne_diff_pct(0.81, 0.8) == j_ne.ne_diff_pct(0.81, 0.8)


# ------------------------------------- satellite: checkpoints both ways
def _recorder(step_fn, out):
    def step(state, batch):
        state, m = step_fn(state, batch)
        out.append(float(m["loss"]))
        return state, m
    return step


def _manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}",
                           "manifest.json")) as f:
        import json
        return {k: (v["shape"], v["dtype"])
                for k, v in json.load(f)["leaves"].items()}


def test_train_checkpoints_resume_across_packages(tmp_path):
    """The reference trains tinyllama-1.1b-smoke (AdamW) 2 steps with a
    checkpoint at step 2 and goes on to step 4; the port's loop resumes
    from that step-2 checkpoint and runs steps 3-4 to the same losses.
    Then the reverse: the port writes step 2, the reference resumes.
    Both packages' step-2 manifests hold the same leaves."""
    jcfg, tcfg, params, model = _lm(DENSE)
    jo, to = JO.for_config(jcfg, 4), TO.for_config(tcfg, 4)
    jstep = _j_step(jcfg, jo, "ckpt")
    lc = dict(log_every=1, ckpt_every=2, keep_last=5)
    quiet = lambda *_: None

    # reference writes, the port resumes
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t_from_j")
    js = JT.TrainState(params, jo.init(params), jnp.int32(0))
    jl = []
    j_loop.run_train_loop(_recorder(jstep, jl), js, j_train.lm_batches(
        jcfg, 4, 16), j_loop.LoopConfig(total_steps=2, ckpt_dir=jdir, **lc),
        log_fn=quiet)
    shutil.copytree(jdir, tdir)
    j_loop.run_train_loop(_recorder(jstep, jl), js, j_train.lm_batches(
        jcfg, 4, 16), j_loop.LoopConfig(total_steps=4, ckpt_dir=jdir, **lc),
        log_fn=quiet)
    assert len(jl) == 4
    tl, logs = [], []
    like = t_train.lm_train_state(tcfg, to, device="cpu")
    t_loop.run_train_loop(
        _recorder(TT.make_train_step(tcfg, to), tl), like,
        t_train.lm_batches(tcfg, 4, 16, device="cpu"),
        t_loop.LoopConfig(total_steps=4, ckpt_dir=tdir, **lc),
        log_fn=logs.append)
    assert logs[0] == "[resume] from checkpoint step 2"
    assert logs[1].startswith("[step 3] loss=") and "ms/step avg)" in logs[1]
    np.testing.assert_allclose(tl, jl[2:], rtol=LOSS_RTOL)
    assert t_ckpt.latest_step(tdir) == 4

    # the port writes, the reference resumes
    tdir2, jdir2 = str(tmp_path / "t"), str(tmp_path / "j_from_t")
    ts = TT.TrainState(TT.param_tree(model), to.init(TT.param_tree(model)),
                       torch.zeros((), dtype=torch.int32))
    tl2 = []
    tstep = _recorder(TT.make_train_step(tcfg, to), tl2)
    ts = t_loop.run_train_loop(tstep, ts, t_train.lm_batches(
        tcfg, 4, 16, device="cpu"), t_loop.LoopConfig(
        total_steps=2, ckpt_dir=tdir2, **lc), log_fn=quiet)
    shutil.copytree(tdir2, jdir2)
    assert _manifest(tdir2, 2) == _manifest(jdir, 2)
    t_loop.run_train_loop(tstep, ts, t_train.lm_batches(
        tcfg, 4, 16, device="cpu"), t_loop.LoopConfig(
        total_steps=4, ckpt_dir=tdir2, **lc), log_fn=quiet)
    jl2 = []
    j_loop.run_train_loop(_recorder(jstep, jl2), js, j_train.lm_batches(
        jcfg, 4, 16), j_loop.LoopConfig(total_steps=4, ckpt_dir=jdir2, **lc),
        log_fn=quiet)
    assert len(tl2) == 4 and len(jl2) == 2
    np.testing.assert_allclose(jl2, tl2[2:], rtol=LOSS_RTOL)
    restored = j_ckpt.restore(jdir2, 2, js)
    _assert_trees(
        t_ckpt.restore(tdir2, 2, ts, device="cpu").params, restored.params,
        "restored params", 0, 0)


def test_recsys_checkpoint_leaves_match_reference(tmp_path):
    """The recsys loop state (params, opt_state) saves with the
    reference's leaf names, shapes and dtypes."""
    jcfg, tcfg, params, model = _recsys("sasrec")
    jo, to = JO.for_config(jcfg), TO.for_config(tcfg)
    j_ckpt.save(str(tmp_path / "j"), 1, (params, jo.init(params)))
    tree = TR.param_tree(model)
    t_ckpt.save(str(tmp_path / "t"), 1, (tree, to.init(tree)))
    assert _manifest(str(tmp_path / "t"), 1) == _manifest(
        str(tmp_path / "j"), 1)


# ----------------------------------------------------- the entry points
def test_launcher_trains_checkpoints_and_resumes_on_cpu(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    argv = ["--arch", MOE, "--steps", "4", "--batch", "4", "--seq", "16",
            "--ckpt-dir", ck, "--ckpt-every", "2", "--log-every", "1",
            "--device", "cpu"]
    state = t_train.main(argv)
    assert int(state.step) == 4
    assert t_ckpt.latest_step(ck) == 4
    out = capsys.readouterr().out
    assert out.count("[step ") == 4 and out.rstrip().endswith("[train] done")
    state = t_train.main(argv[:3] + ["6"] + argv[4:])
    out = capsys.readouterr().out
    assert "[resume] from checkpoint step 4" in out
    assert "[step 5]" in out and "[step 4]" not in out
    assert int(state.step) == 6 and t_ckpt.latest_step(ck) == 6
    loss = [float(line.split("loss=")[1].split()[0])
            for line in out.splitlines() if line.startswith("[step")]
    assert all(np.isfinite(loss))
    state = t_train.main(["--arch", "bst", "--steps", "2", "--batch", "16",
                          "--device", "cpu"])
    assert int(state[1]["step"]) == 2


def test_example_config_is_the_reference_llama_100m():
    """The example's model: ``examples/train_lm.py``'s replace() of
    TinyLlama, field for field (70.5M parameters)."""
    want = dataclasses.replace(
        j_config("tinyllama-1.1b"), arch_id="llama-100m", n_layers=12,
        d_model=512, n_heads=8, n_kv_heads=4, d_ff=1536, vocab=32000,
        dtype="float32", microbatches=2, user_embed_dim=64)
    cfg = t_example.llama_100m_config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert cfg.param_count() == want.param_count() == 70_529_536


@pytest.mark.parametrize("entry", ["main", "lm_batches", "recsys_batches",
                                   "lm_train_state", "recsys_train_state",
                                   "example"])
def test_training_entry_points_raise_without_card(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where no CUDA card is present")
    cfg = t_config(DENSE, smoke=True)
    ck = str(tmp_path)
    t_ckpt.save(ck, 1, {"w": torch.zeros(2)})
    calls = {
        "main": lambda: t_train.main(["--arch", DENSE, "--steps", "1"]),
        "lm_batches": lambda: next(t_train.lm_batches(cfg, 2, 4)),
        "recsys_batches": lambda: next(t_train.recsys_batches(
            t_config("mind", smoke=True), 2)),
        "lm_train_state": lambda: t_train.lm_train_state(cfg, TO.sgd()),
        "recsys_train_state": lambda: t_train.recsys_train_state(
            t_config("mind", smoke=True), TO.adamw()),
        "example": lambda: t_example.main(["--steps", "1", "--ckpt-dir", ck]),
    }
    with pytest.raises(RuntimeError, match="no CUDA card"):
        calls[entry]()
