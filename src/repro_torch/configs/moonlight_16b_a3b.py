"""moonlight-16b-a3b — DeepSeek-V3 block: MLA, 64 routed experts top-6
with 2 shared, one leading dense layer
[hf:moonshotai/Moonlight-16B-A3B config.json, model_type deepseek_v3].

27L d_model=2048 16H, MLA kv_lora 512 (no q LoRA), qk 128 nope + 64 rope,
v 128; layer 0 dense d_ff=11264, layers 1-26 MoE 64e top-6 of width 1408
+ 2 shared, sigmoid scores with a selection bias, routed x 2.446;
rope_theta 50,000, rms eps 1e-5, vocab 163840, 8,192 positions.

A port-only arch (``configs/mla.py``): ``get_config`` resolves it, but it
is not among ``list_archs()``, whose ten archs are the reference's.
"""
import dataclasses

from repro_torch.configs.mla import DeepSeekMoEConfig, MLAConfig

CONFIG = MLAConfig(
    arch_id="moonlight-16b-a3b",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=11264, vocab=163840,
    moe=DeepSeekMoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
                          routed_scale=2.446),
    rope_theta=50_000.0, norm_eps=1e-5, attn_impl="flash_kernel",
    kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
    v_head_dim=128, first_k_dense=1,
)

SMOKE = dataclasses.replace(
    CONFIG, arch_id="moonlight-16b-a3b-smoke",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
    moe=DeepSeekMoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=1,
                          routed_scale=2.446),
    kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    user_embed_dim=32, dtype="float32",
)
