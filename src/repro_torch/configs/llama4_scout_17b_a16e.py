"""llama4-scout-17b-a16e [moe] — hf:meta-llama/Llama-4-Scout-17B-16E.
48L d_model=5120 40H (GQA kv=8) d_ff=8192, MoE 16 experts top-1 (+1 shared),
vocab=202048, early fusion (text-only backbone here)."""
from repro_torch.configs.base import ArchConfig, LayerSpec, Segment

ARCH = ArchConfig(
    name="llama4_scout_17b_a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    head_dim=128,
    n_experts=16,
    top_k=1,
    d_ff_expert=8192,
    n_shared_experts=1,
    rope_theta=500000.0,
    subquadratic=False,
    segments=(
        Segment(pattern=(LayerSpec(mixer="gqa", ffn="moe"),), repeats=48),
    ),
)
