"""whisper-medium [audio] — arXiv:2212.04356.  Enc-dec: 24+24L d_model=1024
16H d_ff=4096 vocab=51865.  Conv frontend is a STUB: input_specs() provides
precomputed frame embeddings (B, seq, d).  Decoder length = seq_len / 8."""
from repro_torch.configs.base import ArchConfig, LayerSpec, Segment

ARCH = ArchConfig(
    name="whisper_medium",
    family="audio",
    n_layers=24,             # decoder layers (encoder listed separately)
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    head_dim=64,
    is_encdec=True,
    enc_causal=False,
    dec_ratio=8,
    frontend="audio",
    subquadratic=False,
    segments=(               # decoder stack (self+cross attention per layer)
        Segment(pattern=(LayerSpec(mixer="gqa", ffn="dense"),), repeats=24),
    ),
)
