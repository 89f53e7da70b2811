"""The DeepSeek-V3 block's settings, which the port runs and the JAX
package has no counterpart of: multi-head latent attention (MLA), shared
experts beside sigmoid-scored routed ones, and leading dense layers.

Subclasses of the reference's dataclasses, so a config of this block is an
``LMConfig`` wherever the port takes one, while the reference's own
configs keep their fields and ``dataclasses.asdict`` exactly.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import LMConfig, MoEConfig


@dataclasses.dataclass(frozen=True)
class DeepSeekMoEConfig(MoEConfig):
    """DeepSeek-V3's expert block (``noaux_tc`` with one group):
    ``scores = sigmoid(x W_r)`` in float32; the top ``top_k`` experts of
    ``scores + bias`` (the layer's ``router_bias`` leaf, HF's
    ``e_score_correction_bias``), weighted by their UNbiased scores,
    renormalised when ``norm_topk_prob``, times ``routed_scale``; each
    routed expert a SwiGLU ``d_expert`` wide; ``n_shared`` shared experts
    as one SwiGLU ``n_shared * d_expert`` wide, added for every token."""
    d_expert: int = 0             # moe_intermediate_size
    n_shared: int = 0             # n_shared_experts
    routed_scale: float = 1.0     # routed_scaling_factor
    norm_topk_prob: bool = True

    @property
    def d_shared(self) -> int:
        return self.n_shared * self.d_expert

    def gate(self, logits, params):
        """``models.moe.sigmoid_gating`` on the layer's ``params["bias"]``,
        with no probabilities: the port serves this block and keeps no
        load-balance loss for it."""
        from repro_torch.models.moe import sigmoid_gating

        gates, idx, _ = sigmoid_gating(logits, params["bias"], self)
        return gates, idx, None

    def shared(self, x, params):
        """The shared experts' SwiGLU over every token (the ``moe.shared``
        phase)."""
        from repro_torch.core import trace
        from repro_torch.models.layers import swiglu

        if trace.on:
            trace.begin("moe.shared", x.device)
        y = swiglu(x, params["shared_wg"], params["shared_wu"],
                   params["shared_wd"])
        if trace.on:
            trace.end("moe.shared")
        return y


@dataclasses.dataclass(frozen=True)
class MLAConfig(LMConfig):
    """A DeepSeek-V3 decoder: ``first_k_dense`` dense SwiGLU layers
    ``d_ff`` wide, then ``n_layers - first_k_dense`` layers whose FFN is
    ``moe`` (a :class:`DeepSeekMoEConfig`); every layer attends with MLA
    without a query LoRA:

    * ``q = x W_q``: ``n_heads`` heads of ``qk_nope_head_dim +
      qk_rope_head_dim``;
    * ``[c, k_pe] = x W_kv_a``, ``kv_lora_rank + qk_rope_head_dim`` wide;
      ``c`` RMS-normed, then ``c W_kv_b`` gives each head's
      ``qk_nope_head_dim`` key dims and ``v_head_dim`` value dims;
    * RoPE (base ``rope_theta``, DeepSeek's interleaved pairs) on q's last
      ``qk_rope_head_dim`` dims and on ``k_pe``, one key shared by all
      heads; scores scaled by ``qk_head_dim ** -0.5``;
    * ``o = attn W_o`` from ``n_heads * v_head_dim``.
    """
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    first_k_dense: int = 1

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def n_moe_layers(self) -> int:
        return self.n_layers - self.first_k_dense

    def param_count(self) -> int:
        """Every leaf, the unembedding included (the published model's
        15.96 B at Moonlight's widths)."""
        d, m = self.d_model, self.moe
        h, r = self.n_heads, self.kv_lora_rank
        attn = (d * h * self.qk_head_dim + d * (r + self.qk_rope_head_dim)
                + r + r * h * (self.qk_nope_head_dim + self.v_head_dim)
                + h * self.v_head_dim * d + 2 * d)   # + the two norms
        dense = attn + 3 * d * self.d_ff
        moe = (attn + d * m.n_experts + m.n_experts
               + 3 * d * (m.n_experts * m.d_expert + m.d_shared))
        return (self.first_k_dense * dense + self.n_moe_layers * moe
                + 2 * self.vocab * d + d)

    def active_param_count(self) -> int:
        """Parameters a token runs through: top_k of the routed experts."""
        m = self.moe
        idle = 3 * self.d_model * (m.n_experts - m.top_k) * m.d_expert
        return self.param_count() - self.n_moe_layers * idle
