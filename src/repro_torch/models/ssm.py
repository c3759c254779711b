"""State-space / linear-recurrence mixers: Mamba-2 SSD and RG-LRU.

Counterpart of ``src/repro/models/ssm.py``, in plain PyTorch.

Mamba-2 (SSD, arXiv:2405.21060): the chunked state-space-duality
algorithm — an intra-chunk quadratic term plus inter-chunk recurrent
state passing.  The reference scans the chunks with ``lax.scan``; here the
sequential part is a Python loop over the T/chunk chunks.

RG-LRU (RecurrentGemma / Griffin, arXiv:2402.19427): gated diagonal linear
recurrence h_t = a_t ⊙ h_{t-1} + √(1−a_t²) ⊙ (i_t ⊙ x_t).  The reference
runs ``lax.associative_scan`` over T; here a log-depth (Hillis–Steele)
scan in fp32 computes the same function (another order of the same
products, so agreement is to fp32 rounding), and decode takes one step.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# depthwise causal conv1d (both mixers use a short temporal conv)
# ---------------------------------------------------------------------------

def causal_conv1d(x: Tensor, w: Tensor) -> Tensor:
    """x: (B, T, C), w: (K, C) depthwise. Causal (pads left)."""
    K = w.shape[0]
    T = x.shape[1]
    # y_t = Σ_i w[i] * x_{t-(K-1-i)}
    y = None
    for i in range(K):
        p = F.pad(x, (0, 0, K - 1 - i, i))[:, :T]
        term = p * w[i][None, None, :]
        y = term if y is None else y + term
    return y


def causal_conv1d_step(x_t: Tensor, buf: Tensor, w: Tensor
                       ) -> Tuple[Tensor, Tensor]:
    """Decode step. x_t: (B, C); buf: (B, K-1, C) past inputs."""
    window = torch.cat([buf, x_t[:, None, :]], dim=1)   # (B,K,C)
    dt = torch.promote_types(window.dtype, w.dtype)
    y = torch.einsum("bkc,kc->bc", window.to(dt), w.to(dt))
    return y, window[:, 1:]


# ---------------------------------------------------------------------------
# Mamba-2 SSD
# ---------------------------------------------------------------------------

class SsdDims(NamedTuple):
    d_model: int
    d_inner: int          # = expand * d_model (expand = 2)
    n_heads: int          # = d_inner // head_dim
    head_dim: int = 64
    d_state: int = 128
    n_groups: int = 1
    conv_k: int = 4
    chunk: int = 256


def ssd_chunked(xh: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor,
                chunk: int) -> Tensor:
    """Chunked SSD scan.

    xh: (B, T, H, P) inputs; dt: (B, T, H) positive step sizes;
    A: (H,) negative decay rates; Bm, Cm: (B, T, G, N) input/output maps
    (G groups broadcast over H). Returns (B, T, H, P).
    """
    Bsz, T, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = T // chunk
    rep = H // G
    dA = dt * A[None, None, :]                          # (B,T,H) ≤ 0
    xh = xh.reshape(Bsz, nc, chunk, H, P)
    dt_c = dt.reshape(Bsz, nc, chunk, H)
    dA_c = dA.reshape(Bsz, nc, chunk, H)
    B_c = torch.repeat_interleave(Bm.reshape(Bsz, nc, chunk, G, N), rep,
                                  dim=3)
    C_c = torch.repeat_interleave(Cm.reshape(Bsz, nc, chunk, G, N), rep,
                                  dim=3)

    cum = torch.cumsum(dA_c, dim=2)                     # (B,nc,c,H)
    seg_end = cum[:, :, -1]                             # (B,nc,H)

    # ---- intra-chunk (quadratic within the chunk, causal) ----
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,nc,s,t,H)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=xh.device))
    Lmat = torch.where(causal[None, None, :, :, None], torch.exp(diff), 0.0)
    CB = torch.einsum("bcshn,bcthn->bcsth", C_c, B_c)       # (B,nc,s,t,H)
    y_intra = torch.einsum("bcsth,bcsth,bcth,bcthp->bcshp",
                           CB, Lmat, dt_c, xh)

    # ---- chunk states + inter-chunk recurrence ----
    decay_to_end = torch.exp(seg_end[:, :, None, :] - cum)  # (B,nc,c,H)
    states = torch.einsum("bcthn,bcth,bcth,bcthp->bchnp",
                          B_c, dt_c, decay_to_end, xh)      # (B,nc,H,N,P)
    st = torch.zeros_like(states[:, 0])
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * torch.exp(seg_end[:, c])[..., None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                  # (B,nc,H,N,P)

    y_inter = torch.einsum("bcthn,bcth,bchnp->bcthp",
                           C_c, torch.exp(cum), prev_states)
    return (y_intra + y_inter).reshape(Bsz, T, H, P)


def ssd_decode_step(x_t: Tensor, dt_t: Tensor, A: Tensor, B_t: Tensor,
                    C_t: Tensor, state: Tensor) -> Tuple[Tensor, Tensor]:
    """One-token SSD update.  x_t: (B,H,P), dt_t: (B,H), B_t/C_t: (B,G,N),
    state: (B,H,N,P) → (y_t, new_state)."""
    H = x_t.shape[1]
    G = B_t.shape[1]
    rep = H // G
    Bh = torch.repeat_interleave(B_t, rep, dim=1)           # (B,H,N)
    Ch = torch.repeat_interleave(C_t, rep, dim=1)
    decay = torch.exp(dt_t * A[None, :])                    # (B,H)
    upd = torch.einsum("bhn,bh,bhp->bhnp", Bh, dt_t, x_t)
    state = state * decay[..., None, None] + upd
    y = torch.einsum("bhn,bhnp->bhp", Ch, state)
    return y, state


def ssd_reference(xh, dt, A, Bm, Cm):
    """O(T²) dense SSD oracle (tests only):
    y_s = Σ_{t≤s} C_s·exp(ΣdA)·B_t dt_t x_t."""
    Bsz, T, H, P = xh.shape
    G = Bm.shape[2]
    rep = H // G
    Bh = torch.repeat_interleave(Bm, rep, dim=2)
    Ch = torch.repeat_interleave(Cm, rep, dim=2)
    dA = dt * A[None, None, :]
    cum = torch.cumsum(dA, dim=1)                           # (B,T,H)
    diff = cum[:, :, None, :] - cum[:, None, :, :]          # (B,s,t,H)
    tril = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                 device=xh.device))
    L = torch.where(tril[None, :, :, None], torch.exp(diff), 0.0)
    CB = torch.einsum("bshn,bthn->bsth", Ch, Bh)
    return torch.einsum("bsth,bsth,bth,bthp->bshp", CB, L, dt, xh)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

_C_RGLRU = 8.0


def _linear_scan(a: Tensor, b: Tensor) -> Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1 (h_{-1} = 0), by a log-depth
    scan of the pairs (a, b) under (a1, b1)∘(a2, b2) = (a1 a2, b1 a2 + b2)."""
    T = a.shape[1]
    k = 1
    while k < T:
        b = torch.cat([b[:, :k], b[:, :-k] * a[:, k:] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, :-k] * a[:, k:]], dim=1)
        k *= 2
    return b


def rglru(x: Tensor, gate_x: Tensor, gate_a: Tensor, lam: Tensor) -> Tensor:
    """RG-LRU over a sequence.  x, gates: (B, T, D); lam: (D,) raw Λ.
    a_t = exp(−c·softplus(Λ)·σ(gate_a));
    h_t = a_t h_{t-1} + √(1−a_t²)·(σ(gate_x)⊙x)."""
    log_a = -_C_RGLRU * F.softplus(lam)[None, None, :] * \
        torch.sigmoid(gate_a.to(torch.float32))
    a = torch.exp(log_a)
    gated = torch.sigmoid(gate_x.to(torch.float32)) * x.to(torch.float32)
    inp = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * gated
    return _linear_scan(a, inp).to(x.dtype)


def rglru_step(x_t, gate_x, gate_a, lam, h_prev):
    """One-token RG-LRU.  x_t, gates: (B, D); h_prev: (B, D)."""
    log_a = -_C_RGLRU * F.softplus(lam)[None, :] * \
        torch.sigmoid(gate_a.to(torch.float32))
    a = torch.exp(log_a)
    gated = torch.sigmoid(gate_x.to(torch.float32)) * \
        x_t.to(torch.float32)
    h = a * h_prev + torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * gated
    return h.to(x_t.dtype), h
