"""Per-LayerSpec transformer blocks: init, train apply, decode apply,
cache init, and K-FAC tap enumeration.

Counterpart of ``src/repro/models/blocks.py``.  A *block* = (norm → mixer
→ residual) [→ norm → FFN → residual].  Mixers: GQA attention (global /
sliding-window / non-causal / cross), MLA, Mamba-2 SSD, RG-LRU.  FFNs:
gated-SiLU dense, MoE, or none.  Every matmul is K-FAC-tapped; tap names
are local to the block ("attn_q", "ffn_wi", …) and prefixed by the caller
("segments/seg0/p1/attn_q").  Block parameters are the reference's nested
dicts ({"mix": {"wq", …}, "ffn": {"wi", …}}) with the reference's keys.

Decode writes each new cache slot into the cache tensors in place and
returns the same tensors: the reference returns updated copies.

**Tensor parallelism** (``sp.model_parallel``; the collectives and the
roles are ``models/sharding_policy.py``'s): a block gathers the
sequence-sharded residual (``full_seq``), runs its column-parallel
matmuls on the whole input (each rank its output columns), and its
row-parallel ones (``wo``, ``out_proj``, the FFN's ``wo_f``) on its
input columns, whose partial sums :func:`_out` reduce-scatters back into
the residual.  Attention runs on the rank's q heads and the kv heads
they read (GQA groups map local q heads to their kv heads), or on every
head where the model axis does not divide them.  A fused fan-out — wkv
(k heads, then v heads), the FFN's wi and the shared experts' (gate |
up), RG-LRU's wi (x | y) and wg (gx | ga), mamba2's in_proj (z | xBC |
dt), MLA's latents — is split by columns, not by heads, so its output is
gathered over the model axis and each rank takes what its heads or its
hidden block need (the weights keep the reference's layout).  The SSM
and RG-LRU scans run replicated over the model axis.  Decode reads the
cache in the policy's layout: "seq" (the sequence split over the model
axis, or every axis for the long-context decode; each rank attends over
its slots and the partial softmaxes are combined, flash-decoding style;
only the owner of a slot writes it), "heads" (KV heads, replicated by
``kv_rep`` to a multiple of the axis; local writes) or "hd" (the head
dim; the scores are summed over the axis).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers, moe as moe_lib, ssm as ssm_lib
from repro_torch.models.sharding_policy import ShardPolicy

Tensor = torch.Tensor


def tap_dims(d_in: int, d_out: int, extra: tuple = ()):
    """(d_in, d_out, extra_stack) for one tapped matmul family."""
    return (d_in, d_out, extra)


def _gelu(x: Tensor) -> Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

class TapCtx:
    """Carries probes in / activations out through a block application;
    ``sp`` is the model's policy, whose data axes place the taps' rows
    (``layers.tapped_matmul``)."""

    def __init__(self, probes: Dict, n_stat: int, prefix: str = "",
                 sp: Optional[ShardPolicy] = None):
        self.probes = probes or {}
        self.acts: Dict[str, Tensor] = {}
        self.n_stat = n_stat
        self.prefix = prefix
        self.sp = sp

    def mm(self, name: str, W: Tensor, x: Tensor,
           partial: bool = False) -> Tensor:
        full = f"{self.prefix}{name}"
        y, act = layers.tapped_matmul(W, x, self.probes.get(full),
                                      self.n_stat, self.sp, partial)
        self.acts[full] = act
        return y


def _tp(sp: Optional[ShardPolicy]) -> bool:
    return sp is not None and sp.model_parallel


def _row(tc: TapCtx, sp, name: str, W: Tensor, x: Tensor, d_in: int):
    """A tapped row-parallel matmul → (y, partial): ``W`` holds the
    rank's rows when the model axis shards it, and then ``x`` (whole or
    already the rank's columns) enters as the rank's columns and y is a
    partial sum."""
    partial = _tp(sp) and W.shape[0] != d_in
    if partial and x.shape[-1] == d_in:
        x = sp.block(x, -1)
    return tc.mm(name, W, x, partial), partial


def _out(sp, h: Tensor, y: Tensor, partial: bool) -> Tensor:
    """h + y in the residual's layout: a partial sum reduced into it, a
    whole y cut to the rank's T-block."""
    if partial:
        y = sp.residual_reduce(y)
    elif _tp(sp):
        y = sp.residual(y)
    return h + y.to(h.dtype)


def _rowmm(sp, x: Tensor, W: Tensor, d_in: int) -> Tensor:
    """Decode's untapped row-parallel product, summed over the model
    axis (in fp32 from the operands' dtype) and returned in x's dtype."""
    if not (_tp(sp) and W.shape[0] != d_in):
        return x @ W.to(x.dtype)
    if x.shape[-1] == d_in:
        x = sp.block(x, -1)
    if x.dtype != torch.float32:
        y = x.to(torch.float32) @ W.to(x.dtype).to(torch.float32)
    else:
        y = x @ W
    return sp.tp_sum(y).to(x.dtype)


def _bias(b: Tensor, y: Tensor, sp) -> Tensor:
    """A replicated bias's block matching a column-parallel output."""
    if _tp(sp):
        lo, hi = sp.block_range(b.shape[-1], y.shape[-1])
        b = b[lo:hi]
    return y + b.to(y.dtype)


def _gqa_heads(sp, H: int, Hk: int, q_cols: int, hd: int):
    """(h0, h1, k0, k1): the rank's q heads and the kv heads they read,
    when the model axis shards wq by whole heads and the GQA groups map
    them to a kv block; else every head (0, H, 0, Hk)."""
    n = sp.tp_size if _tp(sp) else 1
    if n == 1 or q_cols == H * hd or H % n:
        return 0, H, 0, Hk
    Hl, G = H // n, H // Hk
    h0 = sp.tp_index * Hl
    if Hl % G == 0:
        return h0, h0 + Hl, h0 // G, (h0 + Hl) // G
    if G % Hl == 0:
        return h0, h0 + Hl, h0 // G, h0 // G + 1
    return 0, H, 0, Hk


def _mixer_dims(arch: ArchConfig):
    return arch.n_heads, arch.n_kv_heads, arch.hd


def _zeros(d: int, generator: torch.Generator) -> Tensor:
    return torch.zeros((d,), dtype=torch.float32,
                       device=layers.init_device(generator))


# ---------------------------------------------------------------------------
# GQA attention sub-block
# ---------------------------------------------------------------------------

def init_gqa(g: torch.Generator, arch: ArchConfig, cross: bool = False,
             dtype=torch.float32):
    H, Hk, hd = _mixer_dims(arch)
    d = arch.d_model
    p = {
        "wq": layers.dense_init(g, d, H * hd, dtype=dtype),
        "wkv": layers.dense_init(g, d, 2 * Hk * hd, dtype=dtype),
        "wo": layers.dense_init(g, H * hd, d, dtype=dtype),
        "ln": _zeros(d, g),
    }
    if arch.qkv_bias:
        p["bq"] = _zeros(H * hd, g)
        p["bkv"] = _zeros(2 * Hk * hd, g)
    if cross:
        p["x_wq"] = layers.dense_init(g, d, H * hd, dtype=dtype)
        p["x_wkv"] = layers.dense_init(g, d, 2 * Hk * hd, dtype=dtype)
        p["x_wo"] = layers.dense_init(g, H * hd, d, dtype=dtype)
        p["x_ln"] = _zeros(d, g)
    return p


def gqa_taps(arch: ArchConfig, cross: bool = False) -> Dict[str, tuple]:
    H, Hk, hd = _mixer_dims(arch)
    d = arch.d_model
    t = {"attn_q": tap_dims(d, H * hd), "attn_kv": tap_dims(d, 2 * Hk * hd),
         "attn_o": tap_dims(H * hd, d)}
    if cross:
        t.update({"x_attn_q": tap_dims(d, H * hd),
                  "x_attn_kv": tap_dims(d, 2 * Hk * hd),
                  "x_attn_o": tap_dims(H * hd, d)})
    return t


def _attend(arch, tc: TapCtx, sp, x, kv_in, wq, wkv, wo, names,
            positions, causal: bool, window: int, softcap: float,
            bq=None, bkv=None):
    """One GQA attention of a (B, T) query sequence over ``kv_in``'s →
    (y, partial): the q and kv fan-outs, the rank's heads, the
    blockwise attention and the tapped output projection."""
    H, Hk, hd = _mixer_dims(arch)
    B, T, _ = x.shape
    Tk = kv_in.shape[1]
    q = tc.mm(names[0], wq, x)
    kv = tc.mm(names[1], wkv, kv_in)
    if bq is not None:
        q, kv = _bias(bq, q, sp), _bias(bkv, kv, sp)
    kv = sp.gather_cols(kv, 2 * Hk * hd)
    h0, h1, k0, k1 = _gqa_heads(sp, H, Hk, q.shape[-1], hd)
    if h1 - h0 == H:
        q = sp.gather_cols(q, H * hd)
    q = q.reshape(B, T, h1 - h0, hd)
    k, v = torch.chunk(kv.reshape(B, Tk, 2 * Hk, hd), 2, dim=2)
    k, v = k[:, :, k0:k1], v[:, :, k0:k1]
    if positions is not None:
        q = layers.rope(q, positions, arch.rope_theta)
        k = layers.rope(k, positions, arch.rope_theta)
    o = attn_lib.blockwise_attention(
        q, k, v, causal=causal, window=window, softcap=softcap,
        q_block=512, kv_block=512)
    return _row(tc, sp, names[2], wo, o.reshape(B, T, (h1 - h0) * hd),
                H * hd)


def apply_gqa(spec: LayerSpec, arch: ArchConfig, p, h, tc: TapCtx,
              positions, sp: ShardPolicy, memory: Optional[Tensor] = None):
    """Self-attention (+ optional cross-attention when memory given; under
    tensor parallelism ``memory`` is whole on every rank)."""
    x = sp.full_seq(layers.rms_norm(h, p["ln"]))
    bias = (p["bq"], p["bkv"]) if arch.qkv_bias else (None, None)
    o, partial = _attend(arch, tc, sp, x, x, p["wq"], p["wkv"], p["wo"],
                         ("attn_q", "attn_kv", "attn_o"), positions,
                         spec.causal, spec.window, arch.attn_softcap, *bias)
    h = _out(sp, h, o, partial)
    if memory is not None:
        x = sp.full_seq(layers.rms_norm(h, p["x_ln"]))
        o, partial = _attend(arch, tc, sp, x, memory, p["x_wq"], p["x_wkv"],
                             p["x_wo"], ("x_attn_q", "x_attn_kv", "x_attn_o"),
                             None, False, 0, 0.0)
        h = _out(sp, h, o, partial)
    return h


def gqa_cache_init(arch: ArchConfig, B: int, S: int, dtype, device,
                   cross_len: int = 0, spec: Optional[LayerSpec] = None,
                   window_caches: bool = False, kv_rep: int = 1):
    """KV cache.  ``window_caches``: sliding-window layers keep only a
    ``window``-slot ring buffer; ``kv_rep``: KV heads replicated ×kv_rep
    (the reference's "heads" cache layout)."""
    H, Hk, hd = _mixer_dims(arch)
    Hc = Hk * kv_rep
    S_eff = S
    if window_caches and spec is not None and spec.window > 0:
        S_eff = min(S, spec.window)
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    c = {"k": z(B, S_eff, Hc, hd), "v": z(B, S_eff, Hc, hd)}
    if cross_len:
        c["xk"] = z(B, cross_len, Hc, hd)
        c["xv"] = z(B, cross_len, Hc, hd)
    return c


def _kv_len(sp, S_cache: int, window: int, cross: bool = False) -> int:
    """A decode cache's global number of slots (the policy's ``kv_lens``
    when a mesh splits it, else the tensor's)."""
    S, S_cross, ring = sp.kv_lens if sp is not None else (0, 0, False)
    if cross:
        return S_cross or S_cache
    if not S:
        return S_cache
    return min(S, window) if ring and window > 0 else S


def _seq_split(sp, S_glob: int, S_cache: int):
    """(shards, this rank's shard) of a cache's sequence, checked
    against the block the rank holds."""
    n, idx = ((1, 0) if sp is None or not sp.active
              else sp.kv_seq_block(S_glob))
    if S_glob // n != S_cache:
        raise ValueError(f"a decode cache block of {S_cache} slots is not "
                         f"1/{n} of its {S_glob}")
    return n, idx


def _write_slot(buf: Tensor, new: Tensor, w, idx: int, S_loc: int) -> None:
    """Write ``new`` (B, 1, …) into slot ``w`` (a host int or (B,)
    per-row slots, global) of a rank's block ``idx`` of ``S_loc`` slots:
    only the owner of the slot writes."""
    if isinstance(w, torch.Tensor):
        rows = torch.arange(buf.shape[0], device=buf.device)
        lw = w - idx * S_loc
        mine = (lw >= 0) & (lw < S_loc)
        buf[rows[mine], lw[mine]] = new[:, 0][mine].to(buf.dtype)
    elif idx * S_loc <= w < (idx + 1) * S_loc:
        lw = w - idx * S_loc
        buf[:, lw:lw + 1] = new.to(buf.dtype)


def _cache_attend(arch, sp, q, k, v, t, window: int, softcap: float,
                  S_glob: int):
    """One decode attention of q (B, 1, H, hd), every head, over a cache
    split over its sequence (or whole) → (B, 1, H·hd)."""
    B, H, hd = q.shape[0], q.shape[2], q.shape[3]
    n, idx = _seq_split(sp, S_glob, k.shape[1])
    if n == 1:
        o = attn_lib.decode_attention(q, k, v, window=window,
                                      softcap=softcap, t=t)
        return o.reshape(B, 1, H * hd)
    m, l, o = attn_lib.decode_partial(q, k, v, window=window,
                                      softcap=softcap, t=t,
                                      offset=idx * k.shape[1])
    o = attn_lib.combine_partials(m, l, o, sp.mesh, sp.cache_axes())
    return o.reshape(B, 1, H * hd).to(v.dtype)


def decode_gqa(spec: LayerSpec, arch: ArchConfig, p, h_t, cache, t,
               sp: ShardPolicy):
    """One-token step. h_t: (B, 1, d); t: a host int, or a (B,) integer
    tensor of per-row positions (each row's rope, cache write, validity
    mask and window at its own position).  Under tensor parallelism the
    cache is the rank's block in the policy's layout (module
    docstring)."""
    B = h_t.shape[0]
    H, Hk, hd = _mixer_dims(arch)
    tp = _tp(sp)
    x = layers.rms_norm(h_t, p["ln"])
    per_row = isinstance(t, torch.Tensor)
    pos = (t.reshape(B, 1) if per_row
           else torch.full((B, 1), t, device=h_t.device))
    q = x @ p["wq"].to(x.dtype)
    kv = x @ p["wkv"].to(x.dtype)
    if arch.qkv_bias:
        q, kv = _bias(p["bq"], q, sp), _bias(p["bkv"], kv, sp)
    kv = sp.gather_cols(kv, 2 * Hk * hd)
    k_new, v_new = torch.chunk(kv.reshape(B, 1, 2 * Hk, hd), 2, dim=2)
    k_new = layers.rope(k_new, pos, arch.rope_theta)
    k, v = cache["k"], cache["v"]
    S_cache, Hc, hd_c = k.shape[1], k.shape[2], k.shape[3]
    layout = sp.kv_cache_layout if tp and not sp.shard_kv_seq else "seq"
    if layout == "hd" and hd_c == hd:
        raise ValueError("the 'hd' decode layout takes the cache's head-dim "
                         "block (launch/steps.py: in_shardings)")
    if layout == "heads":
        Hc = Hc * sp.tp_size            # the rank holds a block of heads
    if Hc != Hk:        # "heads" layout: KV heads replicated to Hc
        rep = Hc // Hk
        k_new = torch.repeat_interleave(k_new, rep, dim=2)
        v_new = torch.repeat_interleave(v_new, rep, dim=2)
    if layout == "heads":
        k_new, v_new = sp.heads(k_new), sp.heads(v_new)
        q_heads = q.shape[-1] // hd
    else:
        q = sp.gather_cols(q, H * hd)
        q_heads = H
    q = layers.rope(q.reshape(B, 1, q_heads, hd), pos, arch.rope_theta)
    if layout == "hd":
        q, k_new, v_new = (sp.block(z, -1) for z in (q, k_new, v_new))
    S_glob, idx = S_cache, 0
    if layout == "seq":
        S_glob = _kv_len(sp, S_cache, spec.window)
        _, idx = _seq_split(sp, S_glob, S_cache)
    # ring-buffer write: for full caches t < S_glob so this is slot t
    w = t % S_glob
    _write_slot(k, k_new, w, idx, S_cache)
    _write_slot(v, v_new, w, idx, S_cache)
    k, v = sp.kv_cache(k), sp.kv_cache(v)
    window, tt = spec.window, t
    if spec.window > 0 and S_glob <= spec.window:
        # ring buffer: every written slot is within the window by
        # construction; mask only unwritten slots (t < S_glob)
        window = 0
        tt = (torch.clamp(t, max=S_glob - 1) if per_row
              else min(t, S_glob - 1))
    if layout == "hd":
        o = attn_lib.decode_attention(
            q, k, v, window=window, softcap=arch.attn_softcap, t=tt,
            hd_full=hd, score_sum=lambda sc: sp.tp_sum(sc))
        o = sp.gather_cols(o, hd).reshape(B, 1, H * hd)
    elif layout == "heads":
        o = attn_lib.decode_attention(q, k, v, window=window,
                                      softcap=arch.attn_softcap, t=tt)
        o = o.reshape(B, 1, q_heads * hd)
    else:
        o = _cache_attend(arch, sp, q, k, v, tt, window, arch.attn_softcap,
                          S_glob)
    h_t = h_t + _rowmm(sp, o, p["wo"], H * hd).to(h_t.dtype)
    new_cache = dict(cache, k=k, v=v)
    if "xk" in cache:  # cross-attention over a precomputed memory cache
        x = layers.rms_norm(h_t, p["x_ln"])
        q = x @ p["x_wq"].to(x.dtype)
        xk, xv = cache["xk"], cache["xv"]
        if layout == "heads":
            o = attn_lib.decode_attention(
                q.reshape(B, 1, q.shape[-1] // hd, hd), xk, xv, t=None)
        else:
            q = sp.gather_cols(q, H * hd).reshape(B, 1, H, hd)
            if layout == "hd":
                o = attn_lib.decode_attention(
                    sp.block(q, -1), xk, xv, t=None, hd_full=hd,
                    score_sum=lambda sc: sp.tp_sum(sc))
                o = sp.gather_cols(o, hd)
            else:
                o = _cache_attend(arch, sp, q, xk, xv, None, 0, 0.0,
                                  _kv_len(sp, xk.shape[1], 0, cross=True))
        o = o.reshape(B, 1, -1)
        h_t = h_t + _rowmm(sp, o, p["x_wo"], H * hd).to(h_t.dtype)
    return h_t, new_cache


# ---------------------------------------------------------------------------
# MLA sub-block (deepseek)
# ---------------------------------------------------------------------------

def _mla_dims(arch: ArchConfig) -> attn_lib.MlaDims:
    return attn_lib.MlaDims(arch.n_heads, arch.mla_q_lora, arch.mla_kv_lora,
                            arch.mla_qk_nope, arch.mla_qk_rope,
                            arch.mla_v_head)


def init_mla(g: torch.Generator, arch: ArchConfig, dtype=torch.float32):
    d = arch.d_model
    dims = _mla_dims(arch)
    H = dims.n_heads
    return {
        "ln": _zeros(d, g),
        "wq_a": layers.dense_init(g, d, dims.q_lora, dtype=dtype),
        "wq_b": layers.dense_init(g, dims.q_lora,
                                  H * (dims.qk_nope + dims.qk_rope),
                                  dtype=dtype),
        "wkv_a": layers.dense_init(g, d, dims.kv_lora + dims.qk_rope,
                                   dtype=dtype),
        "wkv_b": layers.dense_init(g, dims.kv_lora,
                                   H * (dims.qk_nope + dims.v_head),
                                   dtype=dtype),
        "wo": layers.dense_init(g, H * dims.v_head, d, dtype=dtype),
    }


def mla_taps(arch: ArchConfig) -> Dict[str, tuple]:
    d = arch.d_model
    H = arch.n_heads
    dn, dr, dv = arch.mla_qk_nope, arch.mla_qk_rope, arch.mla_v_head
    ql, kl = arch.mla_q_lora, arch.mla_kv_lora
    return {"wq_a": tap_dims(d, ql), "wq_b": tap_dims(ql, H * (dn + dr)),
            "wkv_a": tap_dims(d, kl + dr),
            "wkv_b": tap_dims(kl, H * (dn + dv)),
            "wo": tap_dims(H * dv, d)}


def apply_mla(spec, arch: ArchConfig, p, h, tc: TapCtx, positions,
              sp: ShardPolicy):
    x = sp.full_seq(layers.rms_norm(h, p["ln"]))
    probes = {"mla/" + k[len(tc.prefix):]: v for k, v in tc.probes.items()
              if k.startswith(tc.prefix)}
    acts: Dict[str, Tensor] = {}
    o, partial = attn_lib.mla_train_attention(
        x, p, _mla_dims(arch), probes, acts, "mla", tc.n_stat, positions,
        tc.sp)
    # re-prefix the acts recorded by the mla helper
    for k, v in acts.items():
        tc.acts[f"{tc.prefix}{k.split('/', 1)[1]}"] = v
    return _out(sp, h, o, partial)


def mla_cache_init(arch: ArchConfig, B: int, S: int, dtype, device):
    return {"c_kv": torch.zeros((B, S, arch.mla_kv_lora), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((B, S, arch.mla_qk_rope), dtype=dtype,
                                  device=device)}


def decode_mla(spec, arch: ArchConfig, p, h_t, cache, t,
               sp: ShardPolicy):
    x = layers.rms_norm(h_t, p["ln"])
    o, new_cache = attn_lib.mla_decode_attention(
        x, p, _mla_dims(arch), cache, t, sp,
        _kv_len(sp, cache["c_kv"].shape[1], 0))
    return h_t + o.to(h_t.dtype), new_cache


# ---------------------------------------------------------------------------
# Mamba-2 SSD sub-block
# ---------------------------------------------------------------------------

def _ssd_dims(arch: ArchConfig):
    d_inner = arch.ssm_expand * arch.d_model
    H = d_inner // arch.ssm_head_dim
    G, N = arch.ssm_groups, arch.ssm_state
    conv_dim = d_inner + 2 * G * N
    in_dim = 2 * d_inner + 2 * G * N + H
    return d_inner, H, G, N, conv_dim, in_dim


def init_ssm(g: torch.Generator, arch: ArchConfig, dtype=torch.float32):
    d = arch.d_model
    d_inner, H, G, N, conv_dim, in_dim = _ssd_dims(arch)
    dev = layers.init_device(g)
    return {
        "ln": _zeros(d, g),
        "in_proj": layers.dense_init(g, d, in_dim, dtype=dtype),
        "conv_w": torch.randn((arch.conv_k, conv_dim), generator=g,
                              device=dev) * 0.1,
        "A_log": _zeros(H, g),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.full((H,), -2.0, dtype=torch.float32, device=dev),
        "out_norm": _zeros(d_inner, g),
        "out_proj": layers.dense_init(g, d_inner, d, dtype=dtype),
    }


def ssm_taps(arch: ArchConfig) -> Dict[str, tuple]:
    d = arch.d_model
    d_inner, H, G, N, conv_dim, in_dim = _ssd_dims(arch)
    return {"ssm_in": tap_dims(d, in_dim), "ssm_out": tap_dims(d_inner, d)}


def _ssd_split(arch, xz):
    d_inner, H, G, N, conv_dim, _ = _ssd_dims(arch)
    z = xz[..., :d_inner]
    xBC = xz[..., d_inner: d_inner + conv_dim]
    dt = xz[..., d_inner + conv_dim:]
    return z, xBC, dt


def apply_ssm(spec, arch: ArchConfig, p, h, tc: TapCtx, positions,
              sp: ShardPolicy):
    B, T, d = h.shape
    d_inner, H, G, N, conv_dim, _ = _ssd_dims(arch)
    P_dim = arch.ssm_head_dim
    f32 = torch.float32
    x = sp.full_seq(layers.rms_norm(h, p["ln"]))
    B, T = x.shape[:2]
    xz = sp.gather_cols(tc.mm("ssm_in", p["in_proj"], x), _ssd_dims(arch)[5])
    z, xBC, dt = _ssd_split(arch, xz)
    xBC = F.silu(ssm_lib.causal_conv1d(xBC, p["conv_w"]))
    xs = xBC[..., :d_inner].reshape(B, T, H, P_dim)
    Bm = xBC[..., d_inner: d_inner + G * N].reshape(B, T, G, N)
    Cm = xBC[..., d_inner + G * N:].reshape(B, T, G, N)
    dt = F.softplus(dt.to(f32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y = ssm_lib.ssd_chunked(xs.to(f32), dt, A, Bm.to(f32), Cm.to(f32),
                            chunk=min(arch.ssm_chunk, T))
    y = y + p["D"][None, None, :, None] * xs.to(f32)
    y = y.reshape(B, T, d_inner)
    y = layers.rms_norm(y * F.silu(z.to(f32)), p["out_norm"]).to(h.dtype)
    o, partial = _row(tc, sp, "ssm_out", p["out_proj"], y, d_inner)
    return _out(sp, h, o, partial)


def ssm_cache_init(arch: ArchConfig, B: int, S: int, dtype, device):
    d_inner, H, G, N, conv_dim, _ = _ssd_dims(arch)
    return {"conv": torch.zeros((B, arch.conv_k - 1, conv_dim), dtype=dtype,
                                device=device),
            "state": torch.zeros((B, H, N, arch.ssm_head_dim),
                                 dtype=torch.float32, device=device)}


def decode_ssm(spec, arch: ArchConfig, p, h_t, cache, t,
               sp: ShardPolicy):
    B = h_t.shape[0]
    d_inner, H, G, N, conv_dim, _ = _ssd_dims(arch)
    P_dim = arch.ssm_head_dim
    f32 = torch.float32
    x = layers.rms_norm(h_t, p["ln"])
    xz = sp.gather_cols((x @ p["in_proj"].to(x.dtype))[:, 0],
                        _ssd_dims(arch)[5])
    z, xBC, dt = _ssd_split(arch, xz)
    xBC, conv_buf = ssm_lib.causal_conv1d_step(
        xBC.to(cache["conv"].dtype), cache["conv"], p["conv_w"])
    xBC = F.silu(xBC)
    xs = xBC[..., :d_inner].reshape(B, H, P_dim).to(f32)
    Bm = xBC[..., d_inner: d_inner + G * N].reshape(B, G, N)
    Cm = xBC[..., d_inner + G * N:].reshape(B, G, N)
    dt = F.softplus(dt.to(f32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, state = ssm_lib.ssd_decode_step(xs, dt, A, Bm.to(f32), Cm.to(f32),
                                       cache["state"])
    y = y + p["D"][None, :, None] * xs
    y = y.reshape(B, d_inner)
    y = layers.rms_norm(y * F.silu(z.to(f32)), p["out_norm"]).to(h_t.dtype)
    o = _rowmm(sp, y[:, None, :], p["out_proj"], d_inner)
    return h_t + o.to(h_t.dtype), {"conv": conv_buf, "state": state}


# ---------------------------------------------------------------------------
# RG-LRU sub-block (recurrentgemma)
# ---------------------------------------------------------------------------

def init_rglru(g: torch.Generator, arch: ArchConfig, dtype=torch.float32):
    d, D = arch.d_model, arch.lru_width
    dev = layers.init_device(g)
    return {
        "ln": _zeros(d, g),
        "wi": layers.dense_init(g, d, 2 * D, dtype=dtype),
        "conv_w": torch.randn((arch.conv_k, D), generator=g,
                              device=dev) * 0.1,
        "wg": layers.dense_init(g, D, 2 * D, dtype=dtype),
        "lam": torch.full((D,), 0.5, dtype=torch.float32, device=dev),
        "wo": layers.dense_init(g, D, d, dtype=dtype),
    }


def rglru_taps(arch: ArchConfig) -> Dict[str, tuple]:
    d, D = arch.d_model, arch.lru_width
    return {"lru_in": tap_dims(d, 2 * D), "lru_gates": tap_dims(D, 2 * D),
            "lru_out": tap_dims(D, d)}


def apply_rglru(spec, arch: ArchConfig, p, h, tc: TapCtx, positions,
                sp: ShardPolicy):
    D = arch.lru_width
    x0 = sp.full_seq(layers.rms_norm(h, p["ln"]))
    xy = sp.gather_cols(tc.mm("lru_in", p["wi"], x0), 2 * D)
    x, y = xy[..., :D], xy[..., D:]
    x = ssm_lib.causal_conv1d(x, p["conv_w"])
    gates = sp.gather_cols(tc.mm("lru_gates", p["wg"], x), 2 * D)
    gx, ga = gates[..., :D], gates[..., D:]
    hseq = ssm_lib.rglru(x, gx, ga, p["lam"])
    out, partial = _row(tc, sp, "lru_out", p["wo"], hseq * _gelu(y), D)
    return _out(sp, h, out, partial)


def rglru_cache_init(arch: ArchConfig, B: int, S: int, dtype, device):
    D = arch.lru_width
    return {"conv": torch.zeros((B, arch.conv_k - 1, D), dtype=dtype,
                                device=device),
            "h": torch.zeros((B, D), dtype=torch.float32, device=device)}


def decode_rglru(spec, arch: ArchConfig, p, h_t, cache, t,
                 sp: ShardPolicy):
    D = arch.lru_width
    x0 = layers.rms_norm(h_t, p["ln"])
    xy = sp.gather_cols((x0 @ p["wi"].to(x0.dtype))[:, 0], 2 * D)
    x, y = xy[..., :D], xy[..., D:]
    x, conv_buf = ssm_lib.causal_conv1d_step(x.to(cache["conv"].dtype),
                                             cache["conv"], p["conv_w"])
    gates = sp.gather_cols(x @ p["wg"].to(x.dtype), 2 * D)
    gx, ga = gates[..., :D], gates[..., D:]
    hn, hstate = ssm_lib.rglru_step(x, gx, ga, p["lam"], cache["h"])
    out = _rowmm(sp, (hn * _gelu(y))[:, None, :].to(h_t.dtype), p["wo"], D)
    return h_t + out.to(h_t.dtype), {"conv": conv_buf, "h": hstate}


# ---------------------------------------------------------------------------
# FFN sub-blocks
# ---------------------------------------------------------------------------

def _moe_dims(arch: ArchConfig) -> moe_lib.MoeDims:
    return moe_lib.MoeDims(d_model=arch.d_model, d_ff=arch.d_ff_expert,
                           n_experts=arch.n_experts, top_k=arch.top_k,
                           n_shared=arch.n_shared_experts)


def init_ffn(g: torch.Generator, arch: ArchConfig, spec: LayerSpec,
             dtype=torch.float32):
    d = arch.d_model
    if spec.ffn == "dense":
        f = arch.d_ff
        return {"ln2": _zeros(d, g),
                "wi": layers.dense_init(g, d, 2 * f, dtype=dtype),
                "wo_f": layers.dense_init(g, f, d, dtype=dtype)}
    if spec.ffn == "moe":
        p = moe_lib.init_moe_params(g, _moe_dims(arch), dtype)
        p["ln2"] = _zeros(d, g)
        return p
    return {}


def ffn_taps(arch: ArchConfig, spec: LayerSpec) -> Dict[str, tuple]:
    d = arch.d_model
    if spec.ffn == "dense":
        return {"ffn_wi": tap_dims(d, 2 * arch.d_ff),
                "ffn_wo": tap_dims(arch.d_ff, d)}
    if spec.ffn == "moe":
        f = arch.d_ff_expert
        t = {"moe_wi": tap_dims(d, 2 * f, (arch.n_experts,)),
             "moe_wo": tap_dims(f, d, (arch.n_experts,))}
        if arch.n_shared_experts:
            fs = f * arch.n_shared_experts
            t["shared_wi"] = tap_dims(d, 2 * fs)
            t["shared_wo"] = tap_dims(fs, d)
        return t
    return {}


def apply_ffn(spec: LayerSpec, arch: ArchConfig, p, h, tc: TapCtx,
              sp: ShardPolicy) -> Tuple[Tensor, Tensor]:
    """Returns (h, aux_loss)."""
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    if spec.ffn == "none":
        return h, zero
    x = sp.full_seq(layers.rms_norm(h, p["ln2"]))
    if spec.ffn == "dense":
        f = arch.d_ff
        u = sp.gather_cols(tc.mm("ffn_wi", p["wi"], x), 2 * f)
        gate, up = torch.chunk(u, 2, dim=-1)
        if _tp(sp) and p["wo_f"].shape[0] != f:
            gate, up = sp.ffn_hidden(gate), sp.ffn_hidden(up)
        y, partial = _row(tc, sp, "ffn_wo", p["wo_f"], F.silu(gate) * up, f)
        return _out(sp, h, y, partial), zero
    # MoE
    probes = {"moe/" + k[len(tc.prefix):]: v for k, v in tc.probes.items()
              if k.startswith(tc.prefix)}
    acts: Dict[str, Tensor] = {}
    y, aux = moe_lib.moe_block(x, p, _moe_dims(arch), probes, acts, "moe",
                               tc.n_stat, tc.sp)
    for k, v in acts.items():
        tc.acts[f"{tc.prefix}{k.split('/', 1)[1]}"] = v
    return _out(sp, h, y, _tp(sp)), aux


# ---------------------------------------------------------------------------
# whole-block dispatch
# ---------------------------------------------------------------------------

_MIXERS = {
    "gqa": (init_gqa, apply_gqa, decode_gqa, gqa_cache_init, gqa_taps),
    "mla": (init_mla, apply_mla, decode_mla, mla_cache_init, mla_taps),
    "ssm": (init_ssm, apply_ssm, decode_ssm, ssm_cache_init, ssm_taps),
    "rglru": (init_rglru, apply_rglru, decode_rglru, rglru_cache_init,
              rglru_taps),
}


def init_block(g: torch.Generator, arch: ArchConfig, spec: LayerSpec,
               cross=False, dtype=torch.float32):
    init_fn = _MIXERS[spec.mixer][0]
    mix = (init_fn(g, arch, cross=cross, dtype=dtype)
           if spec.mixer == "gqa" else init_fn(g, arch, dtype=dtype))
    return {"mix": mix, "ffn": init_ffn(g, arch, spec, dtype=dtype)}


def block_taps(arch: ArchConfig, spec: LayerSpec, cross=False
               ) -> Dict[str, tuple]:
    taps_fn = _MIXERS[spec.mixer][4]
    t = dict(taps_fn(arch, cross=cross) if spec.mixer == "gqa"
             else taps_fn(arch))
    t.update(ffn_taps(arch, spec))
    return t


def apply_block(arch: ArchConfig, spec: LayerSpec, p, h, tc: TapCtx,
                positions, sp: ShardPolicy, memory=None):
    apply_fn = _MIXERS[spec.mixer][1]
    if spec.mixer == "gqa":
        h = apply_fn(spec, arch, p["mix"], h, tc, positions, sp,
                     memory=memory)
    else:
        h = apply_fn(spec, arch, p["mix"], h, tc, positions, sp)
    return apply_ffn(spec, arch, p["ffn"], h, tc, sp)


def block_cache_init(arch: ArchConfig, spec: LayerSpec, B, S, dtype, device,
                     cross_len=0, window_caches=False, kv_rep=1):
    fn = _MIXERS[spec.mixer][3]
    if spec.mixer == "gqa":
        return fn(arch, B, S, dtype, device, cross_len=cross_len, spec=spec,
                  window_caches=window_caches, kv_rep=kv_rep)
    return fn(arch, B, S, dtype, device)


def decode_block(arch: ArchConfig, spec: LayerSpec, p, h_t, cache, t,
                 sp: ShardPolicy):
    h_t, new_cache = _MIXERS[spec.mixer][2](spec, arch, p["mix"], h_t,
                                            cache, t, sp)
    p = p["ffn"]
    if spec.ffn == "dense":
        f = arch.d_ff
        x = layers.rms_norm(h_t, p["ln2"])
        u = sp.gather_cols(x @ p["wi"].to(x.dtype), 2 * f)
        gate, up = torch.chunk(u, 2, dim=-1)
        y = _rowmm(sp, F.silu(gate) * up, p["wo_f"], f)
        h_t = h_t + y.to(h_t.dtype)
    elif spec.ffn == "moe":
        dims = _moe_dims(arch)
        B = h_t.shape[0]
        x = layers.rms_norm(h_t, p["ln2"]).reshape(B, -1)
        w, idx, _ = moe_lib.route(x, p["router"], dims)
        # decode: tiny token count — dense "all experts" dispatch
        cap = max(8, min(B * dims.top_k, B))
        buffers, info = moe_lib.dispatch(x, idx, dims, cap)
        E_loc = p["wi"].shape[0]        # the rank's experts (EP)
        e0 = sp.block_range(dims.n_experts, E_loc)[0] if _tp(sp) else 0
        buffers = buffers[e0:e0 + E_loc]
        u = torch.matmul(buffers, p["wi"].to(buffers.dtype))
        g, up2 = torch.chunk(u, 2, dim=-1)
        out = torch.matmul(F.silu(g) * up2, p["wo"].to(buffers.dtype))
        if E_loc != dims.n_experts:
            out = torch.cat([out.new_zeros((e0,) + out.shape[1:]), out,
                             out.new_zeros((dims.n_experts - e0 - E_loc,)
                                           + out.shape[1:])])
        elif _tp(sp):
            out = sp.as_partial(out)
        y = moe_lib.combine(out, w, info, B)
        if dims.n_shared:
            fs = dims.d_ff * dims.n_shared
            u = sp.gather_cols(x @ p["shared_wi"].to(x.dtype), 2 * fs)
            g, up2 = torch.chunk(u, 2, dim=-1)
            sw = p["shared_wo"]
            if _tp(sp) and sw.shape[0] != fs:
                g, up2 = sp.block(g, -1), sp.block(up2, -1)
                y = y + (F.silu(g) * up2).to(torch.float32) @ sw.to(
                    x.dtype).to(torch.float32)
            else:
                y = y + sp.as_partial(((F.silu(g) * up2) @ sw.to(
                    x.dtype)).to(torch.float32))
        y = sp.tp_sum(y)
        h_t = h_t + y.reshape(h_t.shape).to(h_t.dtype)
    return h_t, new_cache
