"""gemma2-27b [dense] — arXiv:2408.00118. 46L d_model=4608 32H (GQA kv=16)
d_ff=36864 vocab=256000; local(4096)/global alternating 1:1, logit softcaps
(attn 50, final 30)."""
from repro_torch.configs.base import ArchConfig, LayerSpec, Segment

_L = LayerSpec(mixer="gqa", ffn="dense", window=4096)
_G = LayerSpec(mixer="gqa", ffn="dense", window=0)

ARCH = ArchConfig(
    name="gemma2_27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab=256000,
    head_dim=128,
    logit_softcap=30.0,
    attn_softcap=50.0,
    subquadratic=False,      # 1:1 global → long_500k skipped
    segments=(
        Segment(pattern=(_L, _G), repeats=23),
    ),
)
