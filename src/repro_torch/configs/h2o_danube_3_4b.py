"""h2o-danube-3-4b [dense] — arXiv:2401.16818 (llama+mistral mix, SWA).
24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000, sliding-window
attention (window 4096) on every layer → sub-quadratic-dominant."""
from repro_torch.configs.base import ArchConfig, LayerSpec, Segment

_W = 4096

ARCH = ArchConfig(
    name="h2o_danube_3_4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab=32000,
    head_dim=120,
    subquadratic=True,       # SWA everywhere → 500k decode is bounded
    segments=(
        Segment(pattern=(LayerSpec(mixer="gqa", ffn="dense", window=_W),),
                repeats=24),
    ),
)
