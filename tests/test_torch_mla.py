"""The port's DeepSeek-V3 block (Moonlight-16B-A3B), which the JAX package
has no counterpart of: its configuration beside the reference's registry,
the sigmoid router with a selection bias, the shared experts, the dense
first layer, latent attention's RoPE, the flash kernel's plain version at
(192, 128) widths and the entry points that refuse MLA. The SMOKE tower
against the benchmark's float32 reference is
``bench/tests/test_bench_mla.py``."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import all_cells, get_config, list_archs  # noqa: E402
from repro_torch.configs.mla import DeepSeekMoEConfig, MLAConfig  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

SMOKE = get_config("moonlight-16b-a3b", smoke=True)


def _tower(seed=0, bias_std=0.3):
    """SMOKE weights: N(0, 1/fan_in) projections, norms 1 + N(0, 0.05^2),
    the embedding N(0, 0.02^2), a selection bias N(0, bias_std^2)."""
    m = T.MLATower(SMOKE, "cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in m.named_parameters():
            p.normal_(generator=g)
            if p.dim() == 1 or (p.dim() == 2 and "stack" in name and (
                    "norm" in name or "bias" in name)):
                p.mul_(bias_std if "bias" in name else 0.05)
                if "norm" in name:
                    p.add_(1.0)
            else:
                p.mul_(0.02 if name == "embed" else p.shape[-2] ** -0.5)
    return m


def test_moonlight_resolves_beside_the_reference_registry():
    cfg = get_config("moonlight-16b-a3b")
    assert isinstance(cfg, MLAConfig) and isinstance(cfg.moe,
                                                     DeepSeekMoEConfig)
    assert "moonlight-16b-a3b" not in list_archs() and len(list_archs()) == 10
    assert all(a != "moonlight-16b-a3b" for a, _ in all_cells())
    assert len(all_cells()) == 40
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab,
            cfg.qk_head_dim, cfg.v_head_dim, cfg.kv_lora_rank) == (
        27, 2048, 16, 11264, 163840, 192, 128, 512)
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_expert,
            cfg.moe.d_shared, cfg.moe.routed_scale) == (64, 6, 1408, 2816,
                                                        2.446)
    assert abs(cfg.param_count() - 15.96e9) < 0.01e9
    assert (SMOKE.n_layers, SMOKE.first_k_dense, SMOKE.d_model, SMOKE.n_heads,
            SMOKE.kv_lora_rank, SMOKE.qk_nope_head_dim, SMOKE.qk_rope_head_dim,
            SMOKE.v_head_dim, SMOKE.moe.n_experts, SMOKE.moe.top_k,
            SMOKE.moe.n_shared, SMOKE.dtype) == (
        3, 1, 64, 4, 32, 16, 8, 16, 8, 2, 1, "float32")
    # the subclasses keep the reference's fields for what they share
    base = {f.name for f in dataclasses.fields(cfg)} - {
        "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim",
        "first_k_dense"}
    assert base == {f.name for f in dataclasses.fields(get_config(
        "granite-moe-1b-a400m"))}


def test_sigmoid_routing_selects_on_the_bias_and_weighs_without_it():
    """Two tokens whose top-2 the bias changes: expert 2 (score 0.5 + bias
    0.3) displaces expert 1 (0.7); ties go to the lower id; the weights
    are the chosen scores without the bias, renormalised, times the routed
    scale."""
    cfg = DeepSeekMoEConfig(n_experts=4, top_k=2, d_expert=8, n_shared=1,
                            routed_scale=2.5)
    scores = torch.tensor([[[0.9, 0.7, 0.5, 0.1], [0.6, 0.6, 0.2, 0.6]]])
    logits = torch.log(scores / (1 - scores))
    bias = torch.tensor([0.0, 0.0, 0.3, 0.0])
    w, idx, s = M.sigmoid_gating(logits, bias, cfg)
    assert idx.tolist() == [[[0, 2], [0, 1]]]
    torch.testing.assert_close(s, scores)
    want = torch.tensor([[[0.9, 0.5], [0.6, 0.6]]])
    torch.testing.assert_close(w, want / want.sum(-1, keepdim=True) * 2.5)
    w0, idx0, _ = M.sigmoid_gating(logits, torch.zeros(4), cfg)
    assert idx0.tolist() == [[[0, 1], [0, 1]]]
    torch.testing.assert_close(w0[0, 1], w[0, 1])    # same choice, same w


def test_moe_ffn_adds_the_shared_experts_to_the_routed_ones():
    """A dropless group (32 tokens): the routed output equals each token's
    experts summed by a plain loop with the routed scale, and the shared
    SwiGLU is added for every token."""
    g = torch.Generator().manual_seed(3)
    D, E, K, Fe = 16, 4, 2, 8
    cfg = DeepSeekMoEConfig(n_experts=E, top_k=K, d_expert=Fe, n_shared=2,
                            routed_scale=2.446)
    r = lambda *s: torch.randn(*s, generator=g) * 0.3
    p = {"router": r(D, E), "bias": r(E), "wg": r(E, D, Fe),
         "wu": r(E, D, Fe), "wd": r(E, Fe, D), "shared_wg": r(D, 2 * Fe),
         "shared_wu": r(D, 2 * Fe), "shared_wd": r(2 * Fe, D)}
    x = r(1, 32, D)
    y, aux = M.moe_ffn(x, p, cfg, group_size=32)
    assert aux is None
    w, idx, _ = M.sigmoid_gating(x @ p["router"], p["bias"], cfg)
    want = L.swiglu(x, p["shared_wg"], p["shared_wu"], p["shared_wd"])
    for t in range(32):
        for s in range(K):
            e = int(idx[0, t, s])
            want[0, t] += w[0, t, s] * L.swiglu(x[0, t], p["wg"][e],
                                                p["wu"][e], p["wd"][e])
    torch.testing.assert_close(y, want, atol=1e-5, rtol=1e-5)
    no_shared = dict(p, shared_wd=torch.zeros(2 * Fe, D))
    torch.testing.assert_close(
        y - M.moe_ffn(x, no_shared, cfg, group_size=32)[0],
        L.swiglu(x, p["shared_wg"], p["shared_wu"], p["shared_wd"]),
        atol=1e-5, rtol=1e-5)


def test_dense_first_layer_and_moe_layers_are_separate_stacks():
    """Layer 0 is a dense SwiGLU 128 wide and layers 1-2 are MoE: the
    stacks hold their own leaves, and zeroing either stack's FFN output
    moves the embedding."""
    m = _tower()
    assert m.n_dense == 1 and m.n_moe == 2
    assert m.dense_stack["wg"].shape == (1, 64, 128)
    assert "router" not in m.dense_stack and "wg" not in m.moe_stack
    assert m.moe_stack["moe_wg"].shape == (2, 8, 64, 32)
    assert m.moe_stack["shared_wg"].shape == (2, 64, 32)
    assert m.moe_stack["router_bias"].dtype == torch.float32
    tokens = torch.randint(0, SMOKE.vocab, (2, 64),
                           generator=torch.Generator().manual_seed(5))
    base = T.user_tower_step(m, tokens, SMOKE, backend="torch")
    for stack, leaf in ((m.dense_stack, "wd"), (m.moe_stack, "shared_wd")):
        with torch.no_grad():
            saved = stack[leaf].clone()
            stack[leaf].zero_()
            moved = T.user_tower_step(m, tokens, SMOKE, backend="torch")
            stack[leaf].copy_(saved)
        assert float((moved - base).norm() / base.norm()) > 0.05, leaf


def test_mla_rope_rotates_deepseeks_interleaved_pairs():
    """L.deinterleave then apply_rope is DeepSeek's rotation of the pairs
    (x[2i], x[2i+1]) by position x theta^(-2i/d), as complex products,
    laid out as halves: q . k over the heads is the same either way."""
    g = torch.Generator().manual_seed(9)
    S, H, d = 5, 2, 8
    q, k = torch.randn(1, S, H, d, generator=g), torch.randn(1, S, 1, d,
                                                             generator=g)
    cos, sin = L.rope_tables(torch.arange(S), d, 50_000.0)
    got_q = L.apply_rope(L.deinterleave(q), cos, sin)
    got_k = L.apply_rope(L.deinterleave(k), cos, sin)
    freqs = 50_000.0 ** (-torch.arange(0, d, 2, dtype=torch.float32) / d)
    rot = torch.polar(torch.ones(S, d // 2), torch.arange(S)[:, None] * freqs)

    def complex_rope(x):
        z = torch.view_as_complex(x.reshape(*x.shape[:-1], d // 2, 2))
        return torch.view_as_real(z * rot[None, :, None]).flatten(-2)

    want_q, want_k = complex_rope(q), complex_rope(k)
    torch.testing.assert_close(L.deinterleave(want_q), got_q, atol=1e-6,
                               rtol=1e-6)
    torch.testing.assert_close(torch.einsum("bshd,btkd->bhst", got_q, got_k),
                               torch.einsum("bshd,btkd->bhst", want_q, want_k),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("hq,hkv,q_offset", [(4, 4, 0), (4, 2, 128)])
def test_flash_plain_path_at_192_128_matches_naive_and_chunked(hq, hkv,
                                                               q_offset):
    """The kernel's plain version (what a CPU tensor runs) at MLA's widths:
    the output is v's 128 wide, scores scaled by 192 ** -0.5, equal to the
    naive and the chunked attention."""
    g = torch.Generator().manual_seed(hq + q_offset)
    B, Sq, Sk = 1, 256, 256 + q_offset
    q = torch.randn(B, Sq, hq, 192, generator=g)
    k = torch.randn(B, Sk, hkv, 192, generator=g)
    v = torch.randn(B, Sk, hkv, 128, generator=g)
    got = fa.flash_attention(q, k, v, causal=True, q_offset=q_offset)
    assert got.shape == (B, Sq, hq, 128)
    naive = L.naive_attention(q, k, v, causal=True, q_offset=q_offset)
    chunked = L.chunked_attention(q, k, v, causal=True, q_offset=q_offset,
                                  kv_chunk=128)
    torch.testing.assert_close(got, naive, atol=2e-5, rtol=0)
    torch.testing.assert_close(got, chunked, atol=2e-5, rtol=0)
    with pytest.raises(ValueError):        # a v wider than q and k
        fa.flash_attention(v, v, q)
    assert (192, 128) in fa.HEAD_DIMS


def test_mla_tower_binds_its_tensors_and_refuses_the_kv_paths():
    m = _tower()
    tree = {"embed": m.embed.data, "final_norm": m.final_norm.data,
            "user_head": m.user_head.data,
            "dense": {k: p.data for k, p in m.dense_stack.items()},
            "moe": {k: p.data for k, p in m.moe_stack.items()}}
    bound = T.mla_tower_from(SMOKE, tree)
    assert bound.moe_stack["moe_wg"].data_ptr() == \
        m.moe_stack["moe_wg"].data_ptr()
    tokens = torch.randint(0, SMOKE.vocab, (2, 32))
    torch.testing.assert_close(
        T.user_tower_step(bound, tokens, SMOKE, backend="torch"),
        T.user_tower_step(m, tokens, SMOKE, backend="torch"))
    with pytest.raises(ValueError, match="holds"):
        T.mla_tower_from(SMOKE, dict(tree, embed=tree["embed"][:, :8]))
    with pytest.raises(ValueError, match="MLA"):
        T.prefill_step(m, tokens, SMOKE, backend="torch")
    with pytest.raises(ValueError, match="MLA"):
        T.decode_step(m, None, tokens[:, 0], SMOKE, backend="torch")
    with pytest.raises(ValueError, match="MLA"):
        T.lm_loss(m, tokens, tokens, SMOKE)
