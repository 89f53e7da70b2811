"""repro_torch's layers and SASRec tower against the JAX package, on the
CPU, at atol 2e-5 / rtol 1e-4 (XLA and torch sum matmuls, softmax and
layer norm in different orders)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import assert_float  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import recsys as JR  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import recsys as TR  # noqa: E402

NARROW = dict(embed_dim=24, n_blocks=2, n_heads=2, seq_len=10, vocab=300)


def test_layer_norm_and_mlp_match_jax(rng):
    x = rng.standard_normal((4, 6, 24)).astype(np.float32)
    w = rng.standard_normal(24).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    assert_float(TL.layer_norm(*map(torch.as_tensor, (x, w, b))),
                 JL.layer_norm(*map(jnp.asarray, (x, w, b))))
    ws = [rng.standard_normal(s).astype(np.float32)
          for s in ((24, 16), (16, 8))]
    bs = [rng.standard_normal(s[1]).astype(np.float32)
          for s in ((24, 16), (16, 8))]
    assert_float(TL.mlp(torch.as_tensor(x), [torch.as_tensor(a) for a in ws],
                        [torch.as_tensor(a) for a in bs]),
                 JL.mlp(jnp.asarray(x), [jnp.asarray(a) for a in ws],
                        [jnp.asarray(a) for a in bs]))


@pytest.mark.parametrize("heads", [(2, 2), (4, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_naive_attention_matches_jax(heads, causal, rng):
    hq, hkv = heads
    q = rng.standard_normal((2, 9, hq, 8)).astype(np.float32)
    k = rng.standard_normal((2, 9, hkv, 8)).astype(np.float32)
    v = rng.standard_normal((2, 9, hkv, 8)).astype(np.float32)
    got = TL.attention(*map(torch.as_tensor, (q, k, v)), causal=causal)
    want = JL.attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                        impl="naive")
    assert_float(got, want)
    assert_float(TL.repeat_kv(torch.as_tensor(k), hq // hkv),
                 JL.repeat_kv(jnp.asarray(k), hq // hkv))


@pytest.mark.parametrize("narrow", [False, True], ids=["smoke", "2block"])
def test_sasrec_tower_matches_jax(narrow, rng):
    """SMOKE and a 2-block, 2-head narrow config: the JAX parameters go
    through load_jax_params and both towers see the same padded
    sequences."""
    jcfg, tcfg = j_config("sasrec", smoke=True), t_config("sasrec",
                                                          smoke=True)
    if narrow:
        jcfg = dataclasses.replace(jcfg, **NARROW)
        tcfg = dataclasses.replace(tcfg, **NARROW)
    params = JR.init_params(jax.random.PRNGKey(3), jcfg)
    model = TR.load_jax_params(jax.tree_util.tree_map(np.asarray, params),
                               device="cpu")
    seq = rng.integers(0, jcfg.vocab, (11, jcfg.seq_len)).astype(np.int32)
    seq[:, :3][rng.uniform(size=(11, 3)) < 0.5] = -1        # left padding
    want = JR.tower_step(params, {"seq": jnp.asarray(seq)}, jcfg)
    got = TR.tower_step(model, {"seq": torch.as_tensor(seq)}, tcfg,
                        impl="torch")
    assert got.shape == (11, tcfg.user_embed_dim)
    assert_float(got, want)


def test_init_params_shapes_and_scales_match_reference():
    cfg = t_config("sasrec", smoke=True)
    model = TR.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    jshapes = jax.tree_util.tree_map(
        lambda a: tuple(a.shape), JR.abstract_params(j_config("sasrec",
                                                              smoke=True)))
    assert tuple(model.item_emb.shape) == jshapes["item_emb"]
    assert tuple(model.pos_emb.shape) == jshapes["pos_emb"]
    for blk, jb in zip(model.blocks, jshapes["blocks"]):
        for name, shape in jb.items():
            assert tuple(getattr(blk, name).shape) == shape, name
    assert abs(float(model.item_emb.std()) - 0.01) < 1e-3
    assert abs(float(model.blocks[0].wq.std()) - cfg.embed_dim ** -0.5) < 0.05
    assert not any(p.requires_grad for p in model.parameters())
    assert float(model.blocks[0].ln1_w.min()) == 1.0
