"""recurrentgemma-2b [hybrid] — arXiv:2402.19427 (Griffin). 26L d_model=2560
10H (MQA kv=1) d_ff=7680 vocab=256000; RG-LRU : local-attn at 2:1
(pattern R,R,A ×8 + trailing R,R), window 2048, lru_width=2560."""
from repro_torch.configs.base import ArchConfig, LayerSpec, Segment

_R = LayerSpec(mixer="rglru", ffn="dense")
_A = LayerSpec(mixer="gqa", ffn="dense", window=2048)

ARCH = ArchConfig(
    name="recurrentgemma_2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256000,
    head_dim=256,
    lru_width=2560,
    conv_k=4,
    subquadratic=True,
    segments=(
        Segment(pattern=(_R, _R, _A), repeats=8),
        Segment(pattern=(_R, _R), repeats=1),
    ),
)
