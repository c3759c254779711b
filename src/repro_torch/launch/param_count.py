"""Analytic parameter / FLOP counting from an ArchConfig — used by the
smoke tests (scale sanity) and the roofline (MODEL_FLOPS = 6·N·D terms,
with N_active for MoE).

Counterpart of ``src/repro/launch/param_count.py``: pure arithmetic on an
``ArchConfig``, the port's own copy of it."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, LayerSpec


def _block_params(arch: ArchConfig, spec: LayerSpec, active_only=False
                  ) -> int:
    d = arch.d_model
    H, Hk, hd = arch.n_heads, arch.n_kv_heads, arch.hd
    n = 0
    if spec.mixer == "gqa":
        n += d * H * hd + d * 2 * Hk * hd + H * hd * d
        if arch.qkv_bias:
            n += H * hd + 2 * Hk * hd
    elif spec.mixer == "mla":
        dn, dr, dv = arch.mla_qk_nope, arch.mla_qk_rope, arch.mla_v_head
        ql, kl = arch.mla_q_lora, arch.mla_kv_lora
        n += d * ql + ql * H * (dn + dr) + d * (kl + dr) + \
            kl * H * (dn + dv) + H * dv * d
    elif spec.mixer == "ssm":
        d_inner = arch.ssm_expand * d
        Hs = d_inner // arch.ssm_head_dim
        G, N = arch.ssm_groups, arch.ssm_state
        in_dim = 2 * d_inner + 2 * G * N + Hs
        n += d * in_dim + d_inner * d + arch.conv_k * (d_inner + 2 * G * N)
    elif spec.mixer == "rglru":
        D = arch.lru_width
        n += d * 2 * D + D * 2 * D + D * d + arch.conv_k * D
    if spec.ffn == "dense":
        n += d * 2 * arch.d_ff + arch.d_ff * d
    elif spec.ffn == "moe":
        f = arch.d_ff_expert
        per_expert = d * 2 * f + f * d
        n_routed = arch.top_k if active_only else arch.n_experts
        n += n_routed * per_expert + d * arch.n_experts  # + router
        if arch.n_shared_experts:
            fs = f * arch.n_shared_experts
            n += d * 2 * fs + fs * d
    return n


def count_params(arch: ArchConfig, active_only: bool = False) -> int:
    n = arch.vocab * arch.d_model            # embed
    n += arch.d_model * arch.vocab           # head
    for seg in arch.segments:
        for spec in seg.pattern:
            n += seg.repeats * _block_params(arch, spec, active_only)
    if arch.is_encdec:
        enc = LayerSpec(mixer="gqa", ffn="dense", causal=arch.enc_causal)
        n += arch.n_enc_layers * _block_params(arch, enc)
        # decoder cross-attention
        H, Hk, hd = arch.n_heads, arch.n_kv_heads, arch.hd
        d = arch.d_model
        n += arch.n_layers * (d * H * hd + d * 2 * Hk * hd + H * hd * d)
    if arch.mtp:
        n += arch.d_model * arch.d_model
    return n


def model_flops_per_token(arch: ArchConfig, train: bool = True) -> float:
    """MODEL_FLOPS/token = 6·N_active (train) or 2·N_active (inference)."""
    n_active = count_params(arch, active_only=True)
    return (6.0 if train else 2.0) * n_active
