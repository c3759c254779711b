"""mamba2-2.7b [ssm] — SSD (state-space duality), arXiv:2405.21060.
64L d_model=2560, attention-free, d_ff=0, vocab=50280, ssm_state=128.
d_inner = 2·d_model = 5120, head_dim 64 → 80 SSD heads."""
from repro_torch.configs.base import ArchConfig, LayerSpec, Segment

ARCH = ArchConfig(
    name="mamba2_2p7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=80,              # SSD heads = d_inner / ssm_head_dim
    n_kv_heads=80,
    d_ff=0,                  # attention-free: no separate FFN
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_expand=2,
    ssm_chunk=256,
    conv_k=4,
    subquadratic=True,
    segments=(
        Segment(pattern=(LayerSpec(mixer="ssm", ffn="none"),), repeats=64),
    ),
)
