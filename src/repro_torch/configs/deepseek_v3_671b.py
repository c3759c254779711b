"""deepseek-v3-671b [moe] — MLA + 1 shared + 256 routed top-8, MTP.
arXiv:2412.19437. 61L d_model=7168 128H (MLA) d_ff_expert=2048
vocab=129280.  First 3 layers dense FFN (d_ff=18432), remaining 58 MoE."""
from repro_torch.configs.base import ArchConfig, LayerSpec, Segment

ARCH = ArchConfig(
    name="deepseek_v3_671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,          # MLA: per-head KV from a shared latent
    d_ff=18432,              # dense layers' FFN width
    vocab=129280,
    n_experts=256,
    top_k=8,
    d_ff_expert=2048,
    n_shared_experts=1,
    mtp=True,
    mla_q_lora=1536,
    mla_kv_lora=512,
    mla_qk_nope=128,
    mla_qk_rope=64,
    mla_v_head=128,
    head_dim=128,
    subquadratic=False,      # full attention → long_500k skipped
    segments=(
        Segment(pattern=(LayerSpec(mixer="mla", ffn="dense"),), repeats=3),
        Segment(pattern=(LayerSpec(mixer="mla", ffn="moe"),), repeats=58),
    ),
)
