"""repro_torch's LM user tower against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
tower's parameters come from the JAX ``init_params`` through
``load_jax_params``. Tolerances: the layers and the plain flash attention
in float32 at atol 2e-5 (the JAX kernel suite's bar, XLA and torch sum in
other orders); bfloat16 attention compared in float32 at atol 2e-2 (about
one bfloat16 ulp at |o| <= 4); bfloat16 element-wise layers at one
bfloat16 ulp (XLA may keep float32 between fused bfloat16 ops); the whole
tower at rtol = atol = 1e-4 in float32 (22 kinds of op summed in other
orders) and 5e-2 in bfloat16. Counters, sources and ages are exact.
"""
import contextlib
import dataclasses
import io
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import assert_exact, assert_float, to_np  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.core import server as JS  # noqa: E402
from repro.core.config import CacheConfig as JCfg  # noqa: E402
from repro.core.config import HOUR_MS, MINUTE_MS  # noqa: E402
from repro.core.hashing import Key64 as JKey  # noqa: E402
from repro.data.access_patterns import (FIG6_KNOTS,  # noqa: E402
                                        InterArrivalDist, StreamConfig,
                                        generate_stream_fast)
from repro.ft.failure import FailureInjector  # noqa: E402
from repro.kernels import ref as JREF  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as j_flash  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.examples import serve_lm_tower as t_example  # noqa: E402
from repro_torch.kernels import flash_attention as TFA  # noqa: E402
from repro_torch.kernels import ref as TREF  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LMS = ["tinyllama-1.1b", "yi-6b", "llama3-8b"]
FLASH_ATOL, BF16_ATOL = 2e-5, 2e-2
TOWER_TOL, TOWER_BF16_TOL = 1e-4, 5e-2


def _bf16_np(a):
    """A JAX bfloat16 array as float32 numpy (lossless)."""
    return np.asarray(a, np.float32)


def _pair(a, dtype):
    """One numpy array as a (JAX, torch) pair of ``dtype``."""
    j = jnp.asarray(a).astype(dtype)
    t = torch.tensor(np.asarray(j, np.float32)).to(
        getattr(torch, jnp.dtype(dtype).name))
    return j, t


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", LMS)
def test_lm_configs_match_reference(arch):
    for smoke in (False, True):
        want = dataclasses.asdict(j_config(arch, smoke=smoke))
        got = dataclasses.asdict(t_config(arch, smoke=smoke))
        assert got == want
    assert t_config(arch).hd == j_config(arch).hd


# -------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_swiglu_match_jax(dtype, rng):
    x = rng.standard_normal((3, 5, 32))
    w = rng.standard_normal(32)
    (jx, tx), (jw, tw) = _pair(x, dtype), _pair(w, dtype)
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert_float(TL.rms_norm(tx, tw, 1e-5).float(),
                 _bf16_np(JL.rms_norm(jx, jw, 1e-5)), atol=tol, rtol=tol)
    ws = [rng.standard_normal(s) / np.sqrt(s[0])
          for s in ((32, 48), (32, 48), (48, 32))]
    jws, tws = zip(*(_pair(a, dtype) for a in ws))
    tol = 2e-5 if dtype == "float32" else 5e-2
    assert_float(TL.swiglu(tx, *tws).float(),
                 _bf16_np(JL.swiglu(jx, *jws)), atol=tol, rtol=tol)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_jax(theta, dtype, rng):
    hd, S = 16, 40
    pos = np.arange(S) + 3
    jc, js = JL.rope_tables(jnp.asarray(pos), hd, theta)
    tc, ts = TL.rope_tables(torch.as_tensor(pos), hd, theta)
    assert tc.dtype == torch.float32
    assert_float(tc, jc, atol=1e-6, rtol=1e-6)
    assert_float(ts, js, atol=1e-6, rtol=1e-6)
    x = rng.standard_normal((2, S, 3, hd))
    jx, tx = _pair(x, dtype)
    got = TL.apply_rope(tx, tc, ts)
    assert got.dtype == tx.dtype
    tol = 1e-6 if dtype == "float32" else 1e-2
    assert_float(got.float(), _bf16_np(JL.apply_rope(jx, jc, js)),
                 atol=tol, rtol=tol)


@pytest.mark.parametrize("case", [
    dict(Sq=64, Sk=64, causal=True, q_offset=0, chunk=16),
    dict(Sq=64, Sk=64, causal=False, q_offset=0, chunk=32),
    dict(Sq=16, Sk=64, causal=True, q_offset=48, chunk=16),
    dict(Sq=40, Sk=40, causal=True, q_offset=0, chunk=16),   # ragged: 1
], ids=["causal", "full", "offset", "ragged"])
def test_chunked_attention_matches_jax(case, rng):
    q = rng.standard_normal((2, case["Sq"], 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, case["Sk"], 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, case["Sk"], 2, 8)).astype(np.float32)
    kw = dict(causal=case["causal"], q_offset=case["q_offset"],
              kv_chunk=case["chunk"])
    got = TL.chunked_attention(*map(torch.as_tensor, (q, k, v)), **kw)
    want = JL.chunked_attention(*map(jnp.asarray, (q, k, v)), **kw)
    assert_float(got, want, atol=FLASH_ATOL, rtol=1e-5)


# ---------------------------------------------------- flash attention
FLASH_SWEEP = [  # (Hq, Hkv, causal, Sq, Sk, q_offset, dtype)
    (4, 4, True, 256, 256, 0, "float32"),
    (8, 2, True, 256, 256, 0, "float32"),
    (8, 1, True, 256, 256, 0, "float32"),
    (4, 4, False, 256, 256, 0, "float32"),
    (8, 2, False, 256, 256, 0, "float32"),
    (8, 1, False, 256, 256, 0, "float32"),
    (8, 2, True, 128, 256, 128, "float32"),
    (4, 1, True, 100, 100, 0, "float32"),
    (8, 2, True, 128, 128, 0, "bfloat16"),
    (4, 1, True, 128, 256, 128, "bfloat16"),
]


@pytest.mark.parametrize("hq,hkv,causal,sq,sk,q_offset,dtype", FLASH_SWEEP)
def test_flash_attention_plain_matches_jax_kernel(hq, hkv, causal, sq, sk,
                                                  q_offset, dtype, rng):
    """The port's flash_attention on CPU tensors (its plain version)
    against the JAX Pallas kernel in interpret mode."""
    B, hd = 2, 32
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.standard_normal(s), dtype)
        for s in ((B, sq, hq, hd), (B, sk, hkv, hd), (B, sk, hkv, hd)))
    got = TFA.flash_attention(tq, tk, tv, causal=causal, q_offset=q_offset)
    want = j_flash(jq, jk, jv, causal=causal, q_offset=q_offset,
                   interpret=True)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    atol = FLASH_ATOL if dtype == "float32" else BF16_ATOL
    assert_float(got.float(), _bf16_np(want), atol=atol, rtol=0)
    # the plain version is the whole-batch reference formula, row by row
    whole = JREF.flash_attention_ref(jq, jk, jv, causal=causal,
                                     q_offset=q_offset)
    assert_float(TREF.flash_attention_ref(tq, tk, tv, causal=causal,
                                          q_offset=q_offset).float(),
                 _bf16_np(whole), atol=atol, rtol=0)


@pytest.mark.parametrize("sq,sk", [(192, 256), (256, 320), (130, 130)])
def test_flash_attention_refuses_what_reference_refuses(sq, sk, rng):
    q = rng.standard_normal((1, sq, 2, 8)).astype(np.float32)
    k = rng.standard_normal((1, sk, 1, 8)).astype(np.float32)
    with pytest.raises(AssertionError):
        j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                interpret=True)
    with pytest.raises(ValueError):
        TFA.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                            torch.as_tensor(k))


def test_attention_dispatch_reaches_flash_above_2_20(rng, monkeypatch):
    """``attention(impl="flash_kernel")`` reaches flash_attention exactly
    when Sq*Sk > 2**20 (the reference's rule), naive attention otherwise;
    ``backend="torch"`` reaches the kernel's plain version instead."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(TFA, "flash_attention",
                        spy("flash", TFA.flash_attention))
    monkeypatch.setattr(TREF, "flash_attention_ref",
                        spy("plain", TREF.flash_attention_ref))
    monkeypatch.setattr(TL, "naive_attention",
                        spy("naive", TL.naive_attention))
    monkeypatch.setattr(TL, "chunked_attention",
                        spy("chunked", TL.chunked_attention))
    for sq, sk, impl, backend, want in [
            (1024, 1024, "flash_kernel", "cuda", ["naive"]),
            (1024, 1152, "flash_kernel", "cuda", ["flash", "plain"]),
            (1152, 1152, "flash_kernel", "torch", ["plain"]),
            (1024, 1152, "chunked", "cuda", ["chunked"]),
            (1152, 1152, "naive", "cuda", ["naive"])]:
        q = torch.as_tensor(rng.standard_normal((1, sq, 2, 8)),
                            dtype=torch.float32)
        k = torch.as_tensor(rng.standard_normal((1, sk, 1, 8)),
                            dtype=torch.float32)
        calls.clear()
        out = TL.attention(q, k, k, causal=True, impl=impl, backend=backend)
        assert calls == want, (sq, sk, impl, backend)
        assert out.shape == q.shape
    with pytest.raises(ValueError):
        TL.attention(q, k, k, causal=True, impl="pallas")


# ------------------------------------------------------------ tower
def _towers(arch, dtype="float32", seed=0):
    jcfg = dataclasses.replace(j_config(arch, smoke=True),
                               attn_impl="flash_kernel", dtype=dtype)
    tcfg = dataclasses.replace(t_config(arch, smoke=True),
                               attn_impl="flash_kernel", dtype=dtype)
    params = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    model = TT.load_jax_params(jax.tree_util.tree_map(np.asarray, params),
                               tcfg, device="cpu")
    return jcfg, tcfg, params, model


@pytest.mark.parametrize("seq", [32, 1152], ids=["naive", "flash"])
@pytest.mark.parametrize("arch", LMS)
def test_user_tower_matches_jax(arch, seq, rng):
    """The SMOKE towers with attn_impl="flash_kernel": at S=32 attention
    takes the naive path, at S=1152 (the smallest multiple of 128 above
    1024) the flash kernel's (its plain version here; the Pallas kernel in
    interpret mode in JAX)."""
    jcfg, tcfg, params, model = _towers(arch)
    tokens = rng.integers(0, jcfg.vocab, (3, seq)).astype(np.int32)
    want = JT.user_tower_step(params, jnp.asarray(tokens), jcfg)
    got = TT.user_tower_step(model, torch.as_tensor(tokens), tcfg,
                             backend="torch")
    assert got.shape == (3, tcfg.user_embed_dim)
    assert_float(got, want, atol=TOWER_TOL, rtol=TOWER_TOL)


def test_user_tower_bf16_matches_jax(rng):
    jcfg, tcfg, params, model = _towers("tinyllama-1.1b", "bfloat16")
    assert model.layers[0].wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        model.layers[1].wd.float().numpy(),
        _bf16_np(params["layers"]["wd"][1]))          # lossless load
    tokens = rng.integers(0, jcfg.vocab, (2, 1152)).astype(np.int32)
    want = JT.user_tower_step(params, jnp.asarray(tokens), jcfg)
    got = TT.user_tower_step(model, torch.as_tensor(tokens), tcfg,
                             backend="torch")
    assert got.dtype == torch.bfloat16
    assert_float(got.float(), _bf16_np(want), atol=TOWER_BF16_TOL,
                 rtol=TOWER_BF16_TOL)


def test_init_params_shapes_and_scales_match_reference():
    cfg = t_config("tinyllama-1.1b", smoke=True)
    model = TT.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    jshapes = jax.tree_util.tree_map(
        lambda a: tuple(a.shape), JT.abstract_params(j_config(
            "tinyllama-1.1b", smoke=True)))
    for name in ("embed", "final_norm", "user_head", "unembed"):
        assert tuple(getattr(model, name).shape) == jshapes[name], name
    assert set(jshapes) == {"embed", "final_norm", "user_head", "unembed",
                            "layers"}
    assert len(model.layers) == cfg.n_layers
    for name, shape in jshapes["layers"].items():
        assert tuple(getattr(model.layers[0], name).shape) == shape[1:], name
    assert abs(float(model.embed.std()) - 0.02) < 2e-3
    assert abs(float(model.layers[0].wg.std()) - cfg.d_model ** -0.5) < 0.02
    assert abs(float(model.unembed.std()) - cfg.d_model ** -0.5) < 0.02
    assert float(model.layers[1].ffn_norm.min()) == 1.0
    assert not any(p.requires_grad for p in model.parameters())
    with pytest.raises(ValueError):
        TT.user_tower_step(model, torch.zeros((1, 4), dtype=torch.int32),
                           cfg, backend="jnp")


# ---------------------------------------------------------- example
def _jax_example_steps(params, cfg, n_steps, minutes=90, users=1200):
    """The loop of ``examples/serve_lm_tower.py`` (its deployment, its
    tokens_of, one jit_serve_step + jit_flush per step), stopped after
    ``n_steps``."""
    seq, batch = 32, 64
    cache_cfg = JCfg(model_id=7, model_type="ctr",
                     cache_ttl_ms=5 * MINUTE_MS, failover_ttl_ms=1 * HOUR_MS,
                     n_buckets=1 << 12, ways=8, value_dim=cfg.user_embed_dim)
    server = JS.CachedEmbeddingServer(
        cfg=cache_cfg, tower_fn=lambda p, t: JT.user_tower_step(p, t, cfg),
        miss_budget=int(batch * 0.75))
    state = JS.init_server_state(cache_cfg, writebuf_capacity=batch * 4)
    times_ms, uids = generate_stream_fast(
        StreamConfig(n_users=users, horizon_s=minutes * 60.0, seed=0),
        InterArrivalDist(FIG6_KNOTS))
    injector = FailureInjector(base_rate=0.02, seed=0)
    out = []
    for lo in range(0, batch * n_steps, batch):
        ids = uids[lo:lo + batch]
        now = int(times_ms[lo + batch - 1])
        tokens = jnp.asarray([(np.arange(seq) * (7 + i)) % cfg.vocab
                              for i in ids], jnp.int32)
        res = server.jit_serve_step(params, state, JKey.from_int(ids),
                                    tokens, now,
                                    jnp.asarray(injector.mask(batch, now)))
        state = server.jit_flush(res.state, now)
        # host copies: the next step donates (deletes) these planes
        planes = jax.tree_util.tree_map(
            np.asarray, {"direct": state.direct,
                         "failover": state.failover})
        out.append((res, jax.device_get(res.stats), planes))
    return out


def test_example_loop_matches_jax_example():
    """The port's example loop (bare (B, S) token features) against the
    JAX example's loop, step by step, with the same SMOKE weights:
    sources, ages and counters exact, embeddings and cached values at
    the tower tolerance."""
    n_steps = 6
    jcfg, tcfg, params, model = _towers("tinyllama-1.1b")
    want = _jax_example_steps(params, jcfg, n_steps)
    got = t_example.serve_steps(tcfg, model, device="cpu", backend="torch")
    hits = 0
    for step, ((jres, jstats, jstate), (tres, tstats, tstate)) in enumerate(
            zip(want, got)):
        assert_exact(tres.source, jres.source, f"source {step}")
        assert_exact(tres.age_ms, jres.age_ms, f"age {step}")
        assert_float(tres.embeddings, jres.embeddings, f"emb {step}",
                     atol=TOWER_TOL, rtol=TOWER_TOL)
        assert set(tstats) == set(jstats)
        for k, v in jstats.items():
            if np.asarray(v).dtype == np.float32:
                np.testing.assert_allclose(tstats[k], v, rtol=1e-6,
                                           err_msg=k)
            else:
                assert tstats[k] == int(v), (step, k)
        for tier in ("direct", "failover"):
            tt, jt = getattr(tstate, tier), jstate[tier]
            for name in jt._fields:
                if name == "values":
                    assert_float(getattr(tt, name), getattr(jt, name),
                                 atol=TOWER_TOL, rtol=TOWER_TOL)
                else:
                    assert_exact(getattr(tt, name), getattr(jt, name),
                                 f"{tier}.{name} {step}")
        hits += tstats["direct_hits"]
    assert step == n_steps - 1 and hits > 0


def test_example_report_matches_jax_example(monkeypatch):
    """Both examples as a user runs them (their own random weights, which
    no counter depends on): the printed reports are identical."""
    argv = ["serve_lm_tower.py", "--minutes", "12", "--users", "200",
            "--failure-rate", "0.05"]
    monkeypatch.setattr(sys, "argv", argv)
    want = io.StringIO()
    with contextlib.redirect_stdout(want):
        runpy.run_path(str(ROOT / "examples" / "serve_lm_tower.py"),
                       run_name="__main__")
    got = io.StringIO()
    with contextlib.redirect_stdout(got):
        totals = t_example.run(minutes=12, users=200, failure_rate=0.05,
                               device="cpu", backend="torch")
    assert got.getvalue() == want.getvalue()
    assert totals["requests"] > 0 and totals["hits"] > 0
    assert "direct hit rate" in got.getvalue()


def test_tokens_of_matches_reference():
    ids = np.array([0, 5, 1199, 77])
    want = np.asarray([(np.arange(32) * (7 + i)) % 256 for i in ids],
                      np.int32)
    got = t_example.tokens_of(ids, 32, 256, "cpu")
    assert got.dtype == torch.int32
    assert_exact(got, want)
    assert to_np(got).shape == (4, 32)
