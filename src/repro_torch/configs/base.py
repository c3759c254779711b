"""Architecture + shape configuration system.

Counterpart of ``src/repro/configs/base.py``: the same dataclasses, cells
and registry.  Every assigned architecture is an ``ArchConfig``: a
sequence of *segments*, each segment a (pattern of LayerSpecs) × repeats
(the port loops over the repeats; the reference scans them).  Shapes are
the four assigned input-shape cells.  The reference's ``input_specs``
(ShapeDtypeStruct stand-ins for its dry run) belongs to the dry-run
tooling and is not here.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer position inside a segment pattern."""
    mixer: str                  # 'gqa' | 'mla' | 'ssm' | 'rglru' | 'none'
    ffn: str = "dense"          # 'dense' | 'moe' | 'none'
    window: int = 0             # 0 → global attention
    causal: bool = True


@dataclasses.dataclass(frozen=True)
class Segment:
    pattern: Tuple[LayerSpec, ...]
    repeats: int


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # ssm | moe | dense | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    segments: Tuple[Segment, ...]
    head_dim: int = 0           # 0 → d_model // n_heads
    qkv_bias: bool = False
    logit_softcap: float = 0.0      # final-logit softcap (gemma2)
    attn_softcap: float = 0.0       # attention-logit softcap (gemma2)
    rope_theta: float = 10000.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_k: int = 4
    # RG-LRU
    lru_width: int = 0
    # enc-dec (whisper)
    is_encdec: bool = False
    n_enc_layers: int = 0
    enc_causal: bool = False
    dec_ratio: int = 8          # dec_len = seq_len // dec_ratio
    # modality frontend stub
    frontend: str = "none"      # 'none' | 'audio' | 'vision'
    n_prefix: int = 0           # vision: patch-embedding prefix length
    # deepseek extras
    mtp: bool = False
    mla_q_lora: int = 1536
    mla_kv_lora: int = 512
    mla_qk_nope: int = 128
    mla_qk_rope: int = 64
    mla_v_head: int = 128
    # capabilities
    subquadratic: bool = False  # can run the long_500k cell
    # training/runtime
    dtype: str = "bfloat16"     # compute/activation dtype
    n_stat: int = 512           # K-FAC stats tokens
    aux_loss_coef: float = 0.01

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        def shrink_spec(s: LayerSpec) -> LayerSpec:
            return dataclasses.replace(s, window=min(s.window, 16) or s.window)
        segs = tuple(
            Segment(tuple(shrink_spec(s) for s in seg.pattern),
                    repeats=min(seg.repeats, 2))
            for seg in self.segments)
        return dataclasses.replace(
            self, n_layers=sum(len(s.pattern) * s.repeats for s in segs),
            d_model=64, n_heads=4, n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_ff=128, d_ff_expert=64 if self.d_ff_expert else 0,
            vocab=256, head_dim=16, segments=segs,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            n_enc_layers=min(self.n_enc_layers, 2),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=8, ssm_chunk=8, lru_width=64 if self.lru_width else 0,
            mla_q_lora=32, mla_kv_lora=16, mla_qk_nope=16, mla_qk_rope=8,
            mla_v_head=16, n_prefix=min(self.n_prefix, 8),
            n_stat=16, dtype="float32")

    def with_repeats(self, repeats: Tuple[int, ...]) -> "ArchConfig":
        """The same config at full width, cut in depth: segment i
        repeated ``repeats[i]`` times (a segment at 0 is left out)."""
        segs = tuple(dataclasses.replace(seg, repeats=r)
                     for seg, r in zip(self.segments, repeats, strict=True)
                     if r > 0)
        return dataclasses.replace(
            self, segments=segs,
            n_layers=sum(len(s.pattern) * s.repeats for s in segs))


# ---------------------------------------------------------------------------
# the four assigned shape cells
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_applicable(arch: ArchConfig, shape: str) -> Tuple[bool, str]:
    """(runs?, reason).  long_500k only for sub-quadratic archs
    (DESIGN.md §4); every arch here has a decoder, so decode cells run."""
    if shape == "long_500k" and not arch.subquadratic:
        return False, ("skip: pure full-attention arch — 500k decode needs "
                       "sub-quadratic attention (DESIGN.md §4)")
    return True, ""


ARCH_NAMES = (
    "mamba2_2p7b", "deepseek_v3_671b", "llama4_scout_17b_a16e",
    "whisper_medium", "internvl2_76b", "h2o_danube_3_4b", "gemma3_4b",
    "gemma2_27b", "qwen2_72b", "recurrentgemma_2b",
)


def get_arch(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.ARCH
