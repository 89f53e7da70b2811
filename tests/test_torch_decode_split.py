"""The split decode kernel's arithmetic on the CPU: ``split_plan``, the
port's plain split-S reference and its merge against the JAX package.

``ref.decode_attention_split_ref`` computes float32 partials (m, l, acc)
per range of ``split_len`` keys, with the kernel's rule for a range wholly
at or past ``valid_len`` (m = -1e30, l = 0, acc = 0), and merges them with
``collectives.combine_decode_partials``, the twin of the combine inside
``seq_sharded_decode_attention``. Inputs are made with numpy from a seed.
Tolerance: float32 at atol 1e-6 (the same float32 arithmetic summed over
other ranges and merged in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import assert_float  # noqa: E402
from repro.distributed import collectives as JCOL  # noqa: E402
from repro_torch.distributed import collectives as TCOL  # noqa: E402
from repro_torch.kernels import decode_attention as TDA  # noqa: E402
from repro_torch.kernels import ref as TREF  # noqa: E402

SPLIT_ATOL = 1e-6


def _inputs(rng, B, S, Hq, Hkv, hd):
    return (rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))


@pytest.mark.parametrize("n_split,split_len", [
    (1, 320), (2, 192), (3, 128), (5, 64)])
def test_split_ref_matches_jax_decode_local(n_split, split_len, rng):
    """valid_len 1, inside the first range, exactly on a range boundary,
    one past it, inside the last range and all of S: every range at or
    past valid_len is empty and drops out of the merge."""
    B, S, Hq, Hkv, hd = 6, 300, 8, 2, 16
    q, k, v = _inputs(rng, B, S, Hq, Hkv, hd)
    vl = np.array([1, 37, min(split_len, S), min(split_len + 1, S), 299, S],
                  np.int32)
    want = JCOL.decode_attention_local(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v),
                                       kv_valid_len=jnp.asarray(vl))
    got = TREF.decode_attention_split_ref(
        *map(torch.as_tensor, (q, k, v)), torch.as_tensor(vl), n_split,
        split_len)
    assert got.dtype == torch.float32 and got.shape == (B, Hq, hd)
    assert_float(got, np.asarray(want), atol=SPLIT_ATOL, rtol=0)


@pytest.mark.parametrize("n_split,split_len", [(1, 128), (4, 32)])
def test_split_ref_gives_zeros_at_valid_len_zero(n_split, split_len, rng):
    """valid_len 0 and below: every range is empty, the merge gives zeros
    (the Pallas kernel's answer; the JAX oracle gives the mean of v)."""
    q, k, v = map(torch.as_tensor, _inputs(rng, 3, 128, 4, 1, 8))
    vl = torch.tensor([0, -3, 128], dtype=torch.int32)
    got = TREF.decode_attention_split_ref(q, k, v, vl, n_split, split_len)
    assert not bool(got[:2].any())
    torch.testing.assert_close(got, TREF.decode_attention_ref(q, k, v, vl),
                               atol=SPLIT_ATOL, rtol=0)


@pytest.mark.parametrize("shards", [2, 4])
def test_combine_matches_jax_shard_combine(shards, rng):
    """The port's merge of the JAX package's own per-shard partials equals
    the single-device answer, as the pmax/psum combine of
    seq_sharded_decode_attention does (every shard holds a valid key)."""
    B, S, Hq, Hkv, hd = 3, 256, 8, 2, 16
    q, k, v = _inputs(rng, B, S, Hq, Hkv, hd)
    vl = np.array([200, 256, 131], np.int32)
    Sl = S // shards
    parts = []
    for i in range(shards):
        pos = i * Sl + np.arange(Sl)[None, :]
        parts.append(JCOL._local_decode_partials(
            jnp.asarray(q), jnp.asarray(k[:, i * Sl:(i + 1) * Sl]),
            jnp.asarray(v[:, i * Sl:(i + 1) * Sl]),
            kv_len_mask=jnp.asarray(pos < vl[:, None])))
    m, l, acc = (torch.as_tensor(np.stack([np.asarray(p[j]) for p in parts]))
                 for j in range(3))
    got = TCOL.combine_decode_partials(m, l, acc, torch.float32)
    want = JCOL.decode_attention_local(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v),
                                       kv_valid_len=jnp.asarray(vl))
    assert_float(got, np.asarray(want), atol=SPLIT_ATOL, rtol=0)


@pytest.mark.parametrize("B,S,Hkv", [
    (128, 2048, 4), (128, 32768, 4), (1, 524288, 4), (6, 1024, 4),
    (7, 100, 1), (2, 48, 2), (1, 64, 1)])
def test_split_plan_covers_the_cache_in_whole_tiles(B, S, Hkv):
    """Every split is whole 64-key tiles, the last one is not empty, no
    split walks more than SPLIT_MAX keys, and the launch offers at least
    CTAS_PER_SM CTAs per SM wherever S has that many tiles."""
    n_sm = 132
    n_split, split_len = TDA.split_plan(B, S, Hkv, n_sm)
    assert split_len % TDA.TILE == 0 and split_len <= TDA.SPLIT_MAX
    assert (n_split - 1) * split_len < S <= n_split * split_len
    tiles = -(-S // TDA.TILE)
    assert B * Hkv * n_split >= min(TDA.CTAS_PER_SM * n_sm, B * Hkv * tiles)
