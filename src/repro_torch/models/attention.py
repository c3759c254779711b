"""Attention flavors for the assigned architectures, in plain PyTorch.

Counterpart of ``src/repro/models/attention.py``.  Every variant is the
reference's blockwise online softmax over q and kv blocks (fp32 running
max ``m``, output ``o`` and sum ``l``; masks from absolute positions;
the logit softcap; masked scores at ``NEG_INF``) and supports

  * GQA / MQA / MHA        (n_kv_heads ≤ n_heads)
  * causal + sliding-window (local) masking, logit softcap (gemma2/3)
  * MLA (deepseek-v3): latent-compressed KV with decoupled RoPE dims;
    decode uses the *absorbed* formulation (attention in latent space)
  * decode with a KV cache (one new token).

``F.scaled_dot_product_attention`` is not used: it cannot apply a softcap,
and its fully masked rows differ from ``NEG_INF``'s.  A (q block, kv
block) pair whose every score is masked is skipped: its partial has
``l = 0`` and is absorbed by the combine with weight ``exp(-1e29 - m) =
0``, so skipping it changes no value.  Products of bf16 operands are
taken in fp32 (the reference's ``preferred_element_type``).

Shapes: q (B, Tq, H, hd); k, v (B, Tk, Hk, hd).

Under tensor parallelism (``models/blocks.py``) the blockwise attention
runs on a rank's q heads and the kv heads they read; a decode cache split
over its sequence is attended block by block (:func:`decode_partial`,
each rank its slots at their global positions) and the blocks' partial
softmaxes are combined over the cache's axes (:func:`combine_partials`:
one max, one packed sum); a cache split over its head dim sums the
partial scores (``decode_attention(score_sum=)``).  MLA's latent
fan-outs are gathered and a rank runs its heads.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.models import layers

Tensor = torch.Tensor
NEG_INF = -1e30


def _scores_mask(q_pos: Tensor, k_pos: Tensor, causal: bool, window: int
                 ) -> Tensor:
    """(Tq, Tk) boolean validity mask from absolute positions."""
    valid = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                       device=q_pos.device)
    if causal:
        valid &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        valid &= q_pos[:, None] - k_pos[None, :] < window
    return valid


def _block_live(q0: int, q1: int, k0: int, k1: int, causal: bool,
                window: int) -> bool:
    """Whether any (q, k) with q in [q0, q1), k in [k0, k1) is valid."""
    if causal and k0 > q1 - 1:
        return False
    if window > 0 and q0 - (k1 - 1) >= window:
        return False
    return True


def _sdp_block(q, k, v, valid, softcap: float):
    """One (q-block × kv-block) online-softmax partial.

    q: (B, Tq, Hk, G, hd), k/v: (B, Tk, Hk, hd), valid: (Tq, Tk).
    Returns (scores_max, exp_scores@v, exp_sum), all fp32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqkgh,bskh->bqkgs", q.float(), k.float()) * scale
    if softcap > 0:
        s = layers.softcap(s, softcap)
    mask = valid[None, :, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    m = torch.amax(s, dim=-1)
    m_safe = torch.clamp(m, min=-1e29)          # guard fully-masked rows
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(mask, p, 0.0)
    o = torch.einsum("bqkgs,bskh->bqkgh", p.to(v.dtype).float(), v.float())
    l = torch.sum(p, dim=-1)
    return m_safe, o, l


def _combine(m1, o1, l1, m2, o2, l2):
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return m, o1 * a1[..., None] + o2 * a2[..., None], l1 * a1 + l2 * a2


def blockwise_attention(q: Tensor, k: Tensor, v: Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0, q_block: int = 1024,
                        kv_block: int = 1024, q_offset: int = 0,
                        k_offset: int = 0) -> Tensor:
    """Memory-efficient attention; O(q_block·kv_block) live scores.
    GQA grouping handled internally; Tq % q_block == Tk % kv_block == 0
    is arranged by the callers.  Offsets are host ints."""
    B, Tq, H, hd = q.shape
    _, Tk, Hk, _ = k.shape
    hd_v = v.shape[-1]          # MLA: value head dim may differ from q/k
    G = H // Hk
    q = q.reshape(B, Tq, Hk, G, hd)
    q_block = min(q_block, Tq)
    kv_block = min(kv_block, Tk)
    nq, nk = Tq // q_block, Tk // kv_block
    dev = q.device
    q_pos = torch.arange(Tq, device=dev) + q_offset
    k_pos = torch.arange(Tk, device=dev) + k_offset
    outs = []
    for i in range(nq):
        qs = slice(i * q_block, (i + 1) * q_block)
        qb, qp = q[:, qs], q_pos[qs]
        m = torch.full((B, q_block, Hk, G), NEG_INF, dtype=torch.float32,
                       device=dev)
        o = torch.zeros((B, q_block, Hk, G, hd_v), dtype=torch.float32,
                        device=dev)
        l = torch.zeros((B, q_block, Hk, G), dtype=torch.float32,
                        device=dev)
        for j in range(nk):
            k0 = j * kv_block
            if not _block_live(i * q_block + q_offset,
                               (i + 1) * q_block + q_offset,
                               k0 + k_offset, k0 + kv_block + k_offset,
                               causal, window):
                continue
            ks = slice(k0, k0 + kv_block)
            valid = _scores_mask(qp, k_pos[ks], causal, window)
            m2, o2, l2 = _sdp_block(qb, k[:, ks], v[:, ks], valid, softcap)
            m, o, l = _combine(m, o, l, m2, o2, l2)
        outs.append(o / torch.clamp(l, min=1e-30)[..., None])
    out = torch.cat(outs, dim=1).reshape(B, Tq, H, hd_v)
    return out.to(v.dtype)


def _valid_upto(S: int, t, window: int, device, offset: int = 0) -> Tensor:
    """Cache slots a query at position ``t`` attends: (S,) for a host int,
    (B, S) for a (B,) tensor of per-row positions; the slots are global
    positions ``offset .. offset + S - 1`` (a rank's block of a cache
    sharded over its sequence)."""
    pos = torch.arange(S, device=device) + offset
    if isinstance(t, Tensor):
        pos, t = pos[None, :], t[:, None]
    valid = pos <= t
    if window > 0:
        valid &= pos > t - window
    return valid


def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor, *,
                     window: int = 0, softcap: float = 0.0,
                     t=None, hd_full: Optional[int] = None,
                     score_sum=None) -> Tensor:
    """One-token attention over a cache.  q: (B, 1, H, hd);
    k/v_cache: (B, S, Hk, hd); t = current absolute position (for masking
    unwritten cache slots and the sliding window): a host int, or a (B,)
    tensor of per-row positions.  A cache whose head dim is split over
    the model axis (the "hd" layout) passes the rank's block of q's head
    dim, the whole head dim ``hd_full`` (the scale's) and ``score_sum``,
    which sums the partial scores over the axis; o is then the rank's
    block of the head dim."""
    B, S, Hk, hd = k_cache.shape
    H = q.shape[2]
    G = H // Hk
    qg = q.reshape(B, Hk, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.to(k_cache.dtype).float(),
                     k_cache.float())
    if score_sum is not None:
        s = score_sum(s)
    s = s / math.sqrt(hd_full or hd)
    if softcap > 0:
        s = layers.softcap(s, softcap)
    if t is None:
        valid = torch.ones((S,), dtype=torch.bool, device=q.device)
    else:
        valid = _valid_upto(S, t, window, q.device)
    # (S,) → (1, 1, 1, S); per row (B, S) → (B, 1, 1, S)
    valid = valid.reshape(valid.shape[:-1] + (1, 1, S)) if valid.dim() == 2 \
        else valid[None, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, H, hd).to(v_cache.dtype)


def decode_partial(q: Tensor, k_cache: Tensor, v_cache: Tensor, *,
                   window: int = 0, softcap: float = 0.0, t=None,
                   offset: int = 0):
    """:func:`decode_attention` over one block of a cache split over its
    sequence (flash-decoding): the slots are global positions ``offset
    ..``; → the block's (max m, sum l, unnormalised output o), fp32, for
    :func:`combine_partials`.  A block with no valid slot gives l = 0
    and o = 0 at m = -1e29, which the combine weighs by 0."""
    B, S, Hk, hd = k_cache.shape
    H = q.shape[2]
    G = H // Hk
    qg = q.reshape(B, Hk, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.to(k_cache.dtype).float(),
                     k_cache.float()) / math.sqrt(hd)
    if softcap > 0:
        s = layers.softcap(s, softcap)
    if t is None:
        valid = torch.ones((S,), dtype=torch.bool, device=q.device)
    else:
        valid = _valid_upto(S, t, window, q.device, offset)
    valid = valid.reshape(valid.shape[:-1] + (1, 1, S)) if valid.dim() == 2 \
        else valid[None, None, None, :]
    m, l, o = _partial_softmax(s, valid, v_cache, "bkgs,bskh->bkgh")
    return m, l, o.reshape(B, H, v_cache.shape[-1])


def _partial_softmax(s, valid, v, eq):
    s = torch.where(valid, s, NEG_INF)
    m = torch.clamp(torch.amax(s, dim=-1), min=-1e29)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    o = torch.einsum(eq, p.to(v.dtype).float(), v.float())
    return m.reshape(m.shape[0], -1), torch.sum(p, dim=-1).reshape(
        m.shape[0], -1), o


def combine_partials(m: Tensor, l: Tensor, o: Tensor, mesh, axes
                     ) -> Tensor:
    """The softmax-weighted output from every block's (m (B, H), l
    (B, H), o (B, H, d)) over ``axes``: one max and one packed sum."""
    from repro_torch.distributed import collectives as coll
    M = coll.all_reduce_max(m, mesh, axes)
    a = torch.exp(m - M)
    buf = torch.cat([o * a[..., None], (l * a)[..., None]], dim=-1)
    coll.all_reduce(buf, mesh, axes)
    return buf[..., :-1] / torch.clamp(buf[..., -1:], min=1e-30)


# ---------------------------------------------------------------------------
# MLA (deepseek-v3) — latent-compressed attention
# ---------------------------------------------------------------------------

class MlaDims(NamedTuple):
    n_heads: int
    q_lora: int = 1536
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128


def mla_train_attention(x, p, dims: MlaDims, probes, acts, tag, n_stat,
                        positions, sp=None):
    """Training-path MLA: materialize per-head K/V from the latent →
    (y, partial): ``partial`` when ``wo`` is row-parallel over the model
    axis and y the rank's partial sum.

    Params p: wq_a (d, q_lora), wq_b (q_lora, H*(nope+rope)),
    wkv_a (d, kv_lora + rope), wkv_b (kv_lora, H*(nope+v)), wo (H*v, d).
    """
    B, T, d = x.shape
    H, dn, dr, dv = dims.n_heads, dims.qk_nope, dims.qk_rope, dims.v_head
    tp = sp is not None and sp.model_parallel

    def mm(name, W, inp, partial=False):
        y, act = layers.tapped_matmul(W, inp, probes.get(f"{tag}/{name}"),
                                      n_stat, sp, partial)
        acts[f"{tag}/{name}"] = act
        return y

    # tensor parallelism (x whole on every rank): the latents' fan-outs
    # are gathered; the rank runs its heads when the model axis divides
    # them, else every head on gathered up-projections
    full = (lambda y, n: sp.gather_cols(y, n)) if tp else (lambda y, n: y)
    local = tp and H % sp.tp_size == 0
    Hl = H // sp.tp_size if local else H
    q = mm("wq_b", p["wq_b"], full(mm("wq_a", p["wq_a"], x), dims.q_lora))
    if not local:
        q = full(q, H * (dn + dr))
    q = q.reshape(B, T, Hl, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    kv = full(mm("wkv_a", p["wkv_a"], x), dims.kv_lora + dr)
    c_kv, k_rope = kv[..., :dims.kv_lora], kv[..., dims.kv_lora:]
    kvu = mm("wkv_b", p["wkv_b"], c_kv)
    if not local:
        kvu = full(kvu, H * (dn + dv))
    kvu = kvu.reshape(B, T, Hl, dn + dv)
    k_nope, v = kvu[..., :dn], kvu[..., dn:]
    q_rope = layers.rope(q_rope, positions)
    k_rope = layers.rope(k_rope[..., None, :], positions)  # (B,T,1,dr)
    k = torch.cat([k_nope, k_rope.expand(B, T, Hl, dr)], dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    o = blockwise_attention(qf, k, v, causal=True)
    o = o.reshape(B, T, Hl * dv)
    if not tp:
        return mm("wo", p["wo"], o), False
    partial = p["wo"].shape[0] != H * dv
    if partial and o.shape[-1] == H * dv:
        o = sp.block(o, -1)
    return mm("wo", p["wo"], o, partial), partial


def _pmm(a: Tensor, b: Tensor) -> Tensor:
    """a @ b at the promoted dtype of the two (jnp's mixed-dtype rule:
    a bf16 activation times an fp32 weight is an fp32 product)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def mla_decode_attention(x_t, p, dims: MlaDims, cache, t, sp=None,
                         S_glob: Optional[int] = None):
    """Absorbed-MLA decode: attention runs in the kv_lora latent space, so
    the cache stores only (c_kv, k_rope).  The new slot ``t`` (a host int,
    or a (B,) tensor of per-row positions) is written into the cache
    tensors in place.

    cache: dict(c_kv (B,S,kv_lora), k_rope (B,S,dr)). x_t: (B,1,d).

    Under tensor parallelism (``sp``) the latents' fan-outs are gathered
    and the rank absorbs its heads' block of ``wkv_b`` (every head's,
    gathered, where the model axis does not divide them); a cache split
    over its sequence (``S_glob`` slots in all) is written by the owner
    of slot t only, and its partial softmaxes, over every head, are
    combined over the cache's axes."""
    B = x_t.shape[0]
    H, dn, dr, dv = dims.n_heads, dims.qk_nope, dims.qk_rope, dims.v_head
    L = dims.kv_lora
    tp = sp is not None and sp.model_parallel
    full = (lambda y, n: sp.gather_cols(y, n)) if tp else (lambda y, n: y)
    local = tp and H % sp.tp_size == 0
    Hl = H // sp.tp_size if local else H
    q = _pmm(full(_pmm(x_t, p["wq_a"]), dims.q_lora), p["wq_b"])
    if not local:
        q = full(q, H * (dn + dr))
    q = q.reshape(B, Hl, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    kv = full(_pmm(x_t, p["wkv_a"]), L + dr)              # (B,1,L+dr)
    c_new, kr_new = kv[..., :L], kv[..., L:]
    per_row = isinstance(t, Tensor)
    pos_t = (t.reshape(B, 1) if per_row
             else torch.full((B, 1), t, device=x_t.device))
    q_rope = layers.rope(q_rope[:, None, :, :], pos_t)[:, 0]
    kr_new = layers.rope(kr_new[:, :, None, :], pos_t)[:, :, 0]
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    S = c_kv.shape[1]
    n, idx = ((1, 0) if sp is None or not sp.active
              else sp.kv_seq_block(S_glob or S))
    lo = idx * S
    if per_row:
        rows = torch.arange(B, device=c_kv.device)
        lw = t - lo
        mine = (lw >= 0) & (lw < S)
        c_kv[rows[mine], lw[mine]] = c_new[:, 0][mine].to(c_kv.dtype)
        k_rope[rows[mine], lw[mine]] = kr_new[:, 0][mine].to(k_rope.dtype)
    elif lo <= t < lo + S:
        c_kv[:, t - lo:t - lo + 1] = c_new.to(c_kv.dtype)
        k_rope[:, t - lo:t - lo + 1] = kr_new.to(k_rope.dtype)
    # absorb W_uk into q: wkv_b reshaped (L, H, dn+dv)
    wkv_b = p["wkv_b"]
    if not local:
        wkv_b = full(wkv_b, H * (dn + dv))
    wkv_b = wkv_b.reshape(L, Hl, dn + dv)
    w_uk = wkv_b[..., :dn]                                # (L,H,dn)
    w_uv = wkv_b[..., dn:]                                # (L,H,dv)
    q_lat = torch.einsum("bhn,lhn->bhl", q_nope.float(),
                         w_uk.to(q_nope.dtype).float())   # (B,H,L)
    if n > 1 and Hl != H:           # every head attends over the block
        q_lat = sp.gather_cols(q_lat, H, dim=1)
        q_rope = sp.gather_cols(q_rope, H, dim=1)
    s = (torch.einsum("bhl,bsl->bhs", q_lat.to(c_kv.dtype).float(),
                      c_kv.float())
         + torch.einsum("bhr,bsr->bhs", q_rope.to(k_rope.dtype).float(),
                        k_rope.float()))
    s = s / math.sqrt(dn + dr)
    valid = _valid_upto(S, t, 0, x_t.device, lo)
    valid = valid[:, None, :] if per_row else valid[None, None, :]
    if n > 1:
        m, l, o_lat = _partial_softmax(s, valid, c_kv, "bhs,bsl->bhl")
        o_lat = combine_partials(m, l, o_lat, sp.mesh, sp.cache_axes())
        if Hl != H:
            o_lat = sp.block(o_lat, 1)
    else:
        s = torch.where(valid, s, NEG_INF)
        pattn = torch.softmax(s, dim=-1)
        o_lat = torch.einsum("bhs,bsl->bhl", pattn.to(c_kv.dtype).float(),
                             c_kv.float())
    o = torch.einsum("bhl,lhv->bhv", o_lat.to(w_uv.dtype).float(),
                     w_uv.float())
    o = o.reshape(B, 1, Hl * dv).to(x_t.dtype)
    if tp and p["wo"].shape[0] != H * dv:
        if o.shape[-1] == H * dv:
            o = sp.block(o, -1)
        return sp.tp_sum(_pmm(o, p["wo"])), dict(c_kv=c_kv, k_rope=k_rope)
    return _pmm(o, p["wo"]), dict(c_kv=c_kv, k_rope=k_rope)
