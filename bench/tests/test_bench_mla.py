"""The Moonlight-16B-A3B family (``bench/towers/lm_mla.py``) on the CPU:
its float32 reference (``bench/reference/lm_mla.py``) against the
program's plain path at the SMOKE widths, its configuration file against
the published keys, its operations and bytes by hand, and the readers of
the MLA and shared-expert phases."""
import json
import types

import numpy as np
import pytest
import torch

from bench import harness
from bench.reference import lm_mla as ref_mla
from bench.reference import precision
from bench.towers import lm_mla as fam_mla
from repro_torch.configs import get_config
from repro_torch.core import trace

MM = precision.matmul_at("float32")
CONFIG = json.loads((harness.BENCH / "configs"
                     / "moonlight-16b-a3b.json").read_text())


def _rel(a, b):
    return float(((a.double() - b.double()).norm(dim=-1)
                  / b.double().norm(dim=-1)).max())


def smoke_cfg(capacity_factor=1.25, group=128, bias_std=0.3):
    """The published-key configuration of the SMOKE Moonlight, float32."""
    s = get_config("moonlight-16b-a3b", smoke=True)
    return dict(
        CONFIG, arch_id=s.arch_id, hidden_size=s.d_model,
        intermediate_size=s.d_ff, kv_lora_rank=s.kv_lora_rank,
        qk_nope_head_dim=s.qk_nope_head_dim,
        qk_rope_head_dim=s.qk_rope_head_dim, v_head_dim=s.v_head_dim,
        num_attention_heads=s.n_heads, num_key_value_heads=s.n_kv_heads,
        num_hidden_layers=s.n_layers, first_k_dense_replace=s.first_k_dense,
        moe_intermediate_size=s.moe.d_expert,
        n_routed_experts=s.moe.n_experts, n_shared_experts=s.moe.n_shared,
        num_experts_per_tok=s.moe.top_k,
        routed_scaling_factor=s.moe.routed_scale, rms_norm_eps=s.norm_eps,
        rope_theta=s.rope_theta, vocab_size=s.vocab,
        capacity_factor=capacity_factor, moe_group_size=group,
        dtype="float32", user_embed_dim=s.user_embed_dim,
        assumed={"e_score_correction_bias_std": bias_std})


@pytest.mark.parametrize("capacity_factor,group,rows,seq", [
    (1.25, 128, 6, 128), (0.5, 128, 6, 128), (1.25, 32, 3, 64),
    (1.25, 128, 2, 1152)])
def test_lm_mla_reference_matches_the_program_tower(capacity_factor, group,
                                                    rows, seq):
    """The SMOKE Moonlight (1 dense + 2 MoE layers, MLA 4 heads of 16 + 8
    over v 16, 8 experts top-2 and 1 shared, a selection bias that moves
    choices) in float32, with and without drops past capacity, dropless
    groups of 64 or fewer, and at 1,152 tokens the flash kernel's plain
    version at (24, 16) widths: within 1e-4 relative L2, float32 against
    float32 in another summation order (Granite's reads ~1e-6). Leaving
    out the selection bias, the routed scale or the shared experts moves
    these embeddings by 0.3 or more, the dense layer's FFN by 1.8."""
    cfg = smoke_cfg(capacity_factor, group)
    fam = fam_mla.Family(cfg, torch.device("cpu"), "torch")
    w = fam.make_weights(torch.Generator().manual_seed(7))
    params = fam.program_params(w)
    assert params.embed.data_ptr() == w["embed"].data_ptr()   # bound
    tokens = torch.randint(0, cfg["vocab_size"], (rows, seq),
                           generator=torch.Generator().manual_seed(8),
                           dtype=torch.int32)
    got = fam.tower_fn()(params, tokens)
    want = ref_mla.user_embedding(w, tokens, cfg, rows, MM)
    assert _rel(got, want) < 1e-4


def test_config_file_holds_the_published_keys_and_the_family_refuses_others():
    """Every key of the published config.json as the catalog holds it,
    unchanged; a value the program does not run (a q LoRA, softmax
    scores, groups of experts) is refused before any weight is drawn."""
    assert (CONFIG["num_hidden_layers"], CONFIG["hidden_size"],
            CONFIG["kv_lora_rank"], CONFIG["q_lora_rank"],
            CONFIG["n_routed_experts"], CONFIG["num_experts_per_tok"],
            CONFIG["n_shared_experts"], CONFIG["moe_intermediate_size"],
            CONFIG["routed_scaling_factor"], CONFIG["scoring_func"],
            CONFIG["vocab_size"], CONFIG["max_position_embeddings"]) == (
        27, 2048, 512, None, 64, 6, 2, 1408, 2.446, "sigmoid", 163840, 8192)
    fam = fam_mla.Family(CONFIG, torch.device("cpu"), "torch")
    assert fam.lcfg.param_count() == pytest.approx(15.96e9, rel=1e-3)
    for key, bad in (("q_lora_rank", 1536), ("scoring_func", "softmax"),
                     ("n_group", 8), ("routing", "dropless")):
        with pytest.raises(ValueError, match=key):
            fam_mla.Family(dict(CONFIG, **{key: bad}), torch.device("cpu"),
                           "torch")


def test_lm_mla_work_by_hand():
    """Moonlight at 8,192 tokens: ~4.6e13 operations a row (2.8e14 a call
    of 6 rows), and a (192, 128) flash launch of 6 rows 2.06e12 over 1.0
    GB; small widths counted by hand."""
    fam = fam_mla.Family(CONFIG, torch.device("cpu"), "torch")
    assert 4.5e13 < fam.row_flops(8192) < 4.7e13
    n, ops, io = fam.attention(6, 8192)
    assert n == 27 and ops == 2 * 6 * 16 * 320 * (8192 * 8193 // 2)
    assert io == 6 * 8192 * 16 * (2 * 192 + 2 * 128) * 2
    assert fam.attention(6, 1024) is None
    # 1 dense + 2 MoE layers at d 4, 1 head of 2 nope + 2 rope, v 2, latent
    # 2, dense 3, 2 experts top 1 of 3, 1 shared; 2 tokens; user dim 5:
    # projections 2*4*(4 + 2 + 2) + 2*2*1*(2 + 2) + 2*1*2*4 = 96 a token;
    # dense 3*2*4*3 = 72; MoE router 2*4*2 = 16, routed 1*3*2*4*3 = 72,
    # shared 72; attention 2*1*(4 + 2)*3 = 36 a layer; head 2*4*5 = 40
    fam.cfg = dict(CONFIG, hidden_size=4, kv_lora_rank=2,
                   num_attention_heads=1, qk_nope_head_dim=2,
                   qk_rope_head_dim=2, v_head_dim=2, n_routed_experts=2,
                   num_experts_per_tok=1, moe_intermediate_size=3,
                   intermediate_size=3, n_shared_experts=1,
                   first_k_dense_replace=1, num_hidden_layers=3,
                   user_embed_dim=5)
    assert fam.row_flops(2) == 2 * (3 * 96 + 72 + 2 * (16 + 72 + 72)) \
        + 3 * 36 + 40


@pytest.mark.parametrize("metric,phase", [("mla_project_ms.lm", "mla.project"),
                                          ("moe_shared_ms.lm", "moe.shared")])
def test_mla_phase_readers_read_the_mean_outside_the_slice(metric, phase):
    """Nothing without a program trace; with one, the phase's ms a batch
    summed within a batch, over the batches outside the slice."""
    read = harness.metric_reader(metric)
    ctx = types.SimpleNamespace(window=np.array([3, 4, 5]),
                                outside=np.array([True, False, True]),
                                slice=None)
    assert read(ctx) is None
    ph = lambda name, a, b, call: trace.Phase(name, a, b, "entry", call, True)
    ctx.program = trace.Drained([], [
        ph(phase, 0, 2_000_000, 3), ph(phase, 5_000_000, 6_000_000, 3),
        ph(phase, 0, 9_000_000, 4), ph(phase, 0, 1_000_000, 5),
        ph("moe.route", 0, 7_000_000, 5)])
    assert read(ctx) == pytest.approx((3.0 + 1.0) / 2)
