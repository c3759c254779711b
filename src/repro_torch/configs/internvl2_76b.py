"""internvl2-76b [vlm] — arXiv:2404.16821 (InternViT-6B + Llama3-70B LM).
Backbone only: 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
Vision frontend is a STUB: input_specs() provides precomputed patch
embeddings as a 256-token prefix."""
from repro_torch.configs.base import ArchConfig, LayerSpec, Segment

ARCH = ArchConfig(
    name="internvl2_76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    head_dim=128,
    rope_theta=500000.0,
    frontend="vision",
    n_prefix=256,
    subquadratic=False,
    segments=(
        Segment(pattern=(LayerSpec(mixer="gqa", ffn="dense"),), repeats=80),
    ),
)
