"""gemma3-4b [dense] — hf:google/gemma-3 family. 34L d_model=2560 8H
(GQA kv=4) d_ff=10240 vocab=262144, 5:1 local(1024):global, 128k context.
34 = 5×(5L+1G) + 4 trailing local layers (remainder segment)."""
from repro_torch.configs.base import ArchConfig, LayerSpec, Segment

_L = LayerSpec(mixer="gqa", ffn="dense", window=1024)
_G = LayerSpec(mixer="gqa", ffn="dense", window=0)

ARCH = ArchConfig(
    name="gemma3_4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_ff=10240,
    vocab=262144,
    head_dim=256,
    rope_theta=1000000.0,
    subquadratic=True,       # SWA-dominant; global layers are
                             # linear-per-step at decode (DESIGN.md §4)
    segments=(
        Segment(pattern=(_L, _L, _L, _L, _L, _G), repeats=5),
        Segment(pattern=(_L, _L, _L, _L), repeats=1),
    ),
)
