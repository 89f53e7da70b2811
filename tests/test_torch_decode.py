"""repro_torch's LM generation path (prefill -> decode) and the last two
kernels' plain versions against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
models' parameters come from the JAX ``init_params`` through
``load_jax_params``. The Pallas kernels run in interpret mode.
Tolerances: float32 at atol 1e-4 (XLA and torch sum in other orders over
a few layers); bfloat16 attention at atol 2e-2 (the reference's own
decode-vs-forward bar, about one bfloat16 ulp at |o| < 2); the bfloat16
model's logits and cache at atol = rtol = 5e-2, the bfloat16 tower's bar
in ``test_torch_lm.py`` (logits reach |x| ~ 4, where one bfloat16 ulp is
1/64, and the two frameworks round a layer's ops at other places); the
probe's values, hits and ages, and every length, exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import assert_exact, assert_float  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.core.hashing import EMPTY_HI  # noqa: E402
from repro.distributed import collectives as JCOL  # noqa: E402
from repro.kernels import cache_probe as JPK  # noqa: E402
from repro.kernels.decode_attention import \
    decode_attention as j_decode  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.distributed import collectives as TCOL  # noqa: E402
from repro_torch.kernels import cache_probe as TPK  # noqa: E402
from repro_torch.kernels import decode_attention as TDA  # noqa: E402
from repro_torch.kernels import ref as TREF  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

LMS = ["tinyllama-1.1b", "yi-6b", "llama3-8b"]
ATOL, BF16_ATOL, BF16_MODEL_TOL = 1e-4, 2e-2, 5e-2
TS_EMPTY = -2 ** 31

_j_prefill = jax.jit(JT.prefill_step, static_argnums=(2,))
_j_decode = jax.jit(JT.decode_step, static_argnums=(3,))


def _np32(a):
    """A JAX (possibly bfloat16) array as float32 numpy (lossless)."""
    return np.asarray(a, np.float32)


def _pair(a, dtype):
    """One numpy array as a (JAX, torch) pair of ``dtype``."""
    j = jnp.asarray(a).astype(dtype)
    t = torch.tensor(np.asarray(j, np.float32)).to(
        getattr(torch, jnp.dtype(dtype).name))
    return j, t


def _bits(x):
    """Raw bits of a float tensor or array, as int numpy (sign of zero
    included)."""
    if isinstance(x, torch.Tensor):
        it = torch.int32 if x.element_size() == 4 else torch.int16
        return x.view(it).numpy()
    x = np.asarray(x)
    return x.view(np.int32 if x.dtype.itemsize == 4 else np.int16)


# ------------------------------------------------------ decode attention
DECODE_SWEEP = [  # (bs, n_rep, hd, dtype)
    (64, 1, 8, "float32"), (128, 2, 16, "float32"), (256, 4, 8, "float32"),
    (64, 4, 16, "float32"), (128, 1, 16, "float32"), (256, 2, 8, "float32"),
    (128, 4, 16, "bfloat16"),
]


@pytest.mark.parametrize("bs,n_rep,hd,dtype", DECODE_SWEEP)
def test_decode_attention_plain_matches_jax_kernel(bs, n_rep, hd, dtype,
                                                   rng):
    """The port's decode_attention on CPU tensors (its plain version)
    against the Pallas kernel in interpret mode, with valid_len 0 (zeros in
    both), 1, inside a block, one past a block and all of S."""
    B, S, Hkv = 5, 512, 2
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.standard_normal(s), dtype)
        for s in ((B, Hkv * n_rep, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
    vl = np.array([0, 1, 37, bs + 1, S], np.int32)
    want = j_decode(jq, jk, jv, jnp.asarray(vl), bs=bs, interpret=True)
    got = TDA.decode_attention(tq, tk, tv, torch.as_tensor(vl), bs=bs)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    atol = ATOL if dtype == "float32" else BF16_ATOL
    assert_float(got.float(), _np32(want), atol=atol, rtol=0)
    assert not np.any(_np32(want)[0]) and not bool(got[0].any())
    assert TDA.LAUNCHES["decode_attention"] == 0      # no kernel on the CPU


@pytest.mark.parametrize("lens", ["valid", "none"])
def test_decode_attention_local_matches_jax(lens, rng):
    B, S, Hq, Hkv, hd = 3, 96, 8, 2, 16
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
    vl = np.array([1, 50, 96], np.int32) if lens == "valid" else None
    want = JCOL.decode_attention_local(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_valid_len=None if vl is None else jnp.asarray(vl))
    got = TCOL.decode_attention_local(
        *map(torch.as_tensor, (q, k, v)),
        kv_valid_len=None if vl is None else torch.as_tensor(vl))
    assert_float(got, want, atol=ATOL, rtol=0)
    # the kernel's plain version agrees wherever valid_len >= 1
    assert_float(TREF.decode_attention_ref(
        *map(torch.as_tensor, (q, k, v)),
        None if vl is None else torch.as_tensor(vl)), want, atol=ATOL,
        rtol=0)


def test_decode_valid_len_zero_is_zeros_in_kernel_mean_in_oracles(rng):
    """The reference's own difference, unreachable from its decode path
    (valid = pos + 1 >= 1): at valid_len 0 the Pallas kernel (and the
    port's kernel and plain version) give zeros, its jnp oracles the mean
    of v."""
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((1, 4, 8), (1, 64, 2, 8), (1, 64, 2, 8)))
    vl = np.zeros(1, np.int32)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    kernel = np.asarray(j_decode(*args, jnp.asarray(vl), bs=64,
                                 interpret=True))
    local = np.asarray(JCOL.decode_attention_local(*args, jnp.asarray(vl)))
    mean_v = np.repeat(v.mean(axis=1), 2, axis=1)       # (1, Hq, hd)
    assert not kernel.any()
    np.testing.assert_allclose(local, mean_v, atol=1e-5)
    t = TREF.decode_attention_ref(*map(torch.as_tensor, (q, k, v)),
                                  torch.as_tensor(vl))
    assert not bool(t.any())
    assert_float(TCOL.decode_attention_local(
        *map(torch.as_tensor, (q, k, v)), torch.as_tensor(vl)), mean_v,
        atol=1e-5, rtol=0)


@pytest.mark.parametrize("s,bs,hq", [(320, 256, 4), (192, 128, 4),
                                     (520, 512, 4), (512, 512, 3)])
def test_decode_attention_refuses_what_reference_refuses(s, bs, hq, rng):
    q = rng.standard_normal((1, hq, 8)).astype(np.float32)
    k = rng.standard_normal((1, s, 2, 8)).astype(np.float32)
    if hq % 2 == 0:
        with pytest.raises(AssertionError):
            j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), bs=bs,
                     interpret=True)
    with pytest.raises(ValueError):
        TDA.decode_attention(torch.as_tensor(q), torch.as_tensor(k),
                             torch.as_tensor(k), bs=bs)


# ------------------------------------------------------- per-query probe
def _tier(rng, nb, ways, dim, batch, now, ttl):
    """Tables with fresh, expired and empty slots, a -0.0 value column,
    and queries that hit, find an expired key or miss."""
    key_hi = np.full((nb, ways), EMPTY_HI, np.int32)
    key_lo = np.zeros((nb, ways), np.int32)
    ts = np.full((nb, ways), TS_EMPTY, np.int32)
    live = rng.uniform(size=(nb, ways)) < 0.7
    key_hi[live] = rng.integers(0, 2 ** 31 - 1, live.sum())
    key_lo[live] = rng.integers(-2 ** 31, 2 ** 31 - 1, live.sum())
    ts[live] = now - rng.integers(0, 2 * ttl, live.sum())
    dup = rng.integers(0, nb, nb // 4)             # same key in two ways
    key_hi[dup, 1], key_lo[dup, 1] = key_hi[dup, 0], key_lo[dup, 0]
    values = rng.standard_normal((nb, ways, dim)).astype(np.float32)
    values[..., 2] = -0.0
    rows = rng.integers(0, nb, batch)
    cols = rng.integers(0, ways, batch)
    q_hi, q_lo = key_hi[rows, cols].copy(), key_lo[rows, cols].copy()
    miss = rng.uniform(size=batch) < 0.3
    q_hi[miss] = rng.integers(0, 2 ** 31 - 1, miss.sum())
    return (key_hi, key_lo, ts, values), (q_hi, q_lo, rows.astype(np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_perquery_plain_matches_jax_kernel(dtype, rng):
    """The port's per-query probe on CPU tensors against the Pallas kernel
    in interpret mode, bit for bit: a stored -0.0 comes back +0.0 from both
    (the masked sum), where the tiled probe keeps the sign bit."""
    now, ttl = 600_000, 60_000
    (khi, klo, ts, vals), queries = _tier(rng, 16, 4, 6, 40, now, ttl)
    jv, tv = _pair(vals, dtype)
    jargs = (*map(jnp.asarray, (khi, klo, ts)), jv,
             *map(jnp.asarray, queries), now, ttl)
    targs = (*map(torch.as_tensor, (khi, klo, ts)), tv,
             *map(torch.as_tensor, queries), now, ttl)
    jhit, jval, jage = JPK.cache_probe_perquery(*jargs, interpret=True)
    hit, val, age = TPK.cache_probe_perquery(*targs)
    assert_exact(hit, jhit)
    assert_exact(age, jage)
    assert val.dtype == tv.dtype
    assert_exact(_bits(val), _bits(jval))
    h = np.asarray(jhit)
    assert 0 < h.sum() < len(h) and (np.asarray(jage)[~h] == -1).all()
    assert not np.signbit(_np32(jval)[:, 2]).any()
    # the reference's tiled probe keeps -0.0 on the same hits
    tiled = JPK.cache_probe_tiled(*jargs, interpret=True)
    assert np.signbit(_np32(tiled[1])[h, 2]).all()
    np.testing.assert_array_equal(_np32(tiled[1]), _np32(jval))
    assert TPK.LAUNCHES["perquery"] == 0


# ------------------------------------------------------- prefill/decode
def _models(arch, dtype="float32", seed=0):
    jcfg = dataclasses.replace(j_config(arch, smoke=True), dtype=dtype)
    tcfg = dataclasses.replace(t_config(arch, smoke=True), dtype=dtype)
    params = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    model = TT.load_jax_params(jax.tree_util.tree_map(np.asarray, params),
                               tcfg, device="cpu")
    return jcfg, tcfg, params, model


def _pad(cache, pad):
    w = ((0, 0), (0, 0), (0, pad), (0, 0), (0, 0))
    return JT.KVCache(k=jnp.pad(cache.k, w), v=jnp.pad(cache.v, w),
                      length=cache.length)


def _assert_cache(got, want, atol, what="", rtol=0):
    assert_float(got.k.float(), _np32(want.k), f"{what} k", atol=atol,
                 rtol=rtol)
    assert_float(got.v.float(), _np32(want.v), f"{what} v", atol=atol,
                 rtol=rtol)
    assert got.length.dtype == torch.int32
    assert_exact(got.length, want.length, f"{what} length")


@pytest.mark.parametrize("arch", LMS)
def test_prefill_matches_jax(arch, rng):
    """Last-position logits and every KV-cache leaf of prefill_step."""
    jcfg, tcfg, params, model = _models(arch)
    toks = rng.integers(0, jcfg.vocab, (2, 12)).astype(np.int32)
    jl, jc = _j_prefill(params, jnp.asarray(toks), jcfg)
    tl, tc = TT.prefill_step(model, torch.as_tensor(toks), tcfg,
                             backend="torch")
    assert tl.shape == (2, tcfg.vocab)
    assert tc.k.shape == (tcfg.n_layers, 2, 12, tcfg.n_kv_heads, tcfg.hd)
    assert_float(tl, jl, atol=ATOL, rtol=0)
    _assert_cache(tc, jc, ATOL)
    # a longer cache holds the same prefix and zeros after it
    _, tc2 = TT.prefill_step(model, torch.as_tensor(toks), tcfg,
                             backend="torch", max_seq=20)
    _assert_cache(tc2, _pad(jc, 8), ATOL)


@pytest.mark.parametrize("arch,dtype", [(a, "float32") for a in LMS]
                         + [("tinyllama-1.1b", "bfloat16")])
def test_chained_decode_steps_match_jax(arch, dtype, rng):
    """Prefill 12 tokens into a cache padded to 20, then 4 chained
    decode_steps (greedy, JAX's tokens fed to both): logits and every
    cache leaf after each step."""
    jcfg, tcfg, params, model = _models(arch, dtype)
    toks = rng.integers(0, jcfg.vocab, (3, 12)).astype(np.int32)
    _, jc = _j_prefill(params, jnp.asarray(toks), jcfg)
    jc = _pad(jc, 8)
    _, tc = TT.prefill_step(model, torch.as_tensor(toks), tcfg,
                            backend="torch", max_seq=20)
    tol = (ATOL, 0) if dtype == "float32" else (BF16_MODEL_TOL,
                                                 BF16_MODEL_TOL)
    nxt = toks[:, 0]
    for step in range(4):
        jl, jc = _j_decode(params, jc, jnp.asarray(nxt), jcfg)
        tl, tc = TT.decode_step(model, tc, torch.as_tensor(nxt), tcfg,
                                backend="torch")
        assert_float(tl.float(), _np32(jl), f"logits {step}", atol=tol[0],
                     rtol=tol[1])
        _assert_cache(tc, jc, *tol[:1], f"step {step}", rtol=tol[1])
        nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    assert tc.length.tolist() == [16] * 3


def test_decode_past_the_cache_is_dropped(rng):
    """A row at position >= S writes nothing (JAX drops an out-of-range
    ``.at[].set``; torch's index_put_ would raise) and attends to all S
    positions; the other rows write as usual."""
    jcfg, tcfg, params, model = _models("tinyllama-1.1b")
    toks = rng.integers(0, jcfg.vocab, (3, 12)).astype(np.int32)
    _, jc = _j_prefill(params, jnp.asarray(toks), jcfg)
    jc = _pad(jc, 4)
    jc = JT.KVCache(k=jc.k, v=jc.v, length=jnp.asarray([16, 12, 21],
                                                       jnp.int32))
    tc = TT.KVCache(torch.tensor(np.asarray(jc.k)),
                    torch.tensor(np.asarray(jc.v)),
                    torch.tensor(np.asarray(jc.length)))
    before = tc.k.clone()
    nxt = toks[:, 1]
    jl, jc2 = _j_decode(params, jc, jnp.asarray(nxt), jcfg)
    tl, tc2 = TT.decode_step(model, tc, torch.as_tensor(nxt), tcfg,
                             backend="torch")
    assert_float(tl, jl, atol=ATOL, rtol=0)
    _assert_cache(tc2, jc2, ATOL)
    assert torch.equal(tc2.k[:, 0], before[:, 0])     # both rows past S
    assert torch.equal(tc2.k[:, 2], before[:, 2])
    assert not torch.equal(tc2.k[:, 1, 12], before[:, 1, 12])
    assert tc2.length.tolist() == [17, 13, 22]


@pytest.mark.parametrize("arch", LMS)
def test_decode_matches_full_forward(arch):
    """The port's twin of ``tests/test_arch_smoke.py``'s
    prefill/decode consistency: decode at position S matches the full
    forward over S + 1 tokens at the reference's bar."""
    cfg = t_config(arch, smoke=True)
    model = TT.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    B, S = 2, 12
    toks = torch.randint(0, cfg.vocab, (B, S), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    logits, cache = TT.prefill_step(model, toks, cfg, backend="torch",
                                    max_seq=S + 8)
    assert logits.shape == (B, cfg.vocab)
    nxt = toks[:, 0]
    dec, cache2 = TT.decode_step(model, cache, nxt, cfg, backend="torch")
    assert bool((cache2.length == S + 1).all())
    x = TT.forward_hidden(model, torch.cat([toks, nxt[:, None]], dim=1), cfg,
                          backend="torch")
    full = TT.logits_from_hidden(model, x[:, -1])
    assert_float(dec, full, atol=BF16_ATOL, rtol=0)
    # forward_hidden's collected kv is the prefill's cache
    x2, (k, v) = TT.forward_hidden(model, toks, cfg, backend="torch",
                                   collect_kv=True)
    assert torch.equal(k, cache.k[:, :, :S]) and torch.equal(v, cache.v[:, :,
                                                                        :S])


def test_decode_cuda_backend_with_cpu_tensors_raises():
    """backend="cuda" never runs the plain attention on CPU tensors."""
    cfg = t_config("tinyllama-1.1b", smoke=True)
    model = TT.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    toks = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        TT.prefill_step(model, toks, cfg, backend="cuda")
    _, cache = TT.prefill_step(model, toks, cfg, backend="torch",
                               max_seq=12)
    with pytest.raises(ValueError):
        TT.decode_step(model, cache, toks[:, 0], cfg, backend="cuda")
    with pytest.raises(ValueError):
        TT.decode_step(model, cache, toks[:, 0], cfg, backend="jnp")
    assert TDA.LAUNCHES["decode_attention"] == 0
