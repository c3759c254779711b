"""Mixture-of-Experts layer (deepseek-v3: 256 routed top-8 + 1 shared;
llama4-scout: 16 routed top-1).

Counterpart of ``src/repro/models/moe.py``, in plain PyTorch.  Dispatch is
sort-based and capacity-bounded: the expanded (token, expert) assignments
are stably sorted by expert (``torch.argsort(stable=True)``, the
reference's ``jnp.argsort(stable=True)``), positions within each expert
come from segment offsets, and an assignment past its expert's capacity
writes to the sentinel row ``E*C``, which is then dropped.  The only large
intermediates are the (E, C, d) expert buffers.

``torch.topk`` and ``jax.lax.top_k`` may order tied router probabilities
differently; on continuous random inputs ties do not occur.

K-FAC taps: each expert matmul is tapped with an (E,)-stacked tap whose
activations are the first n_stat rows of each expert's buffer (the
reference's per-expert ``tapped_matmul`` on the flat (C, d) buffer, here
batched over the experts).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers

Tensor = torch.Tensor


class MoeDims(NamedTuple):
    d_model: int
    d_ff: int             # per-expert hidden
    n_experts: int
    top_k: int
    n_shared: int = 0     # shared-expert count (d_ff each)
    capacity_factor: float = 1.25
    router_softcap: float = 0.0


def capacity(N: int, dims: MoeDims) -> int:
    """Per-expert buffer rows for N tokens (reference ``moe.py:125``)."""
    c = int(N * dims.top_k / dims.n_experts * dims.capacity_factor + 1)
    return max(8, min(c, N))


def route(x: Tensor, w_router: Tensor, dims: MoeDims
          ) -> Tuple[Tensor, Tensor, Tensor]:
    """Router: returns (weights (N,k), expert_idx (N,k), aux_loss)."""
    logits = x.to(torch.float32) @ w_router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                    # (N, E)
    w, idx = torch.topk(probs, dims.top_k, dim=-1)
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    # load-balance auxiliary loss (Switch-style)
    E = dims.n_experts
    me = torch.mean(probs, dim=0)                            # (E,)
    fe = torch.mean(F.one_hot(idx[:, 0], E).to(torch.float32), dim=0)
    aux = E * torch.sum(me * fe)
    return w.to(torch.float32), idx, aux


def dispatch(x: Tensor, idx: Tensor, dims: MoeDims, capacity: int):
    """Scatter tokens into per-expert buffers.

    x: (N, d); idx: (N, k). Returns (buffers (E, C, d), scatter_info)."""
    N, d = x.shape
    k = idx.shape[1]
    E, C = dims.n_experts, capacity
    flat_e = idx.reshape(-1)                                 # (N*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.bincount(flat_e, minlength=E)
    starts = torch.cumsum(counts, dim=0) - counts            # (E,)
    pos_in_e = torch.arange(N * k, device=x.device) - starts[sorted_e]
    keep = pos_in_e < C
    buf_idx = torch.where(keep, sorted_e * C + pos_in_e,
                          torch.full_like(pos_in_e, E * C))
    token_of = order // k                                    # (N*k,)
    buffers = torch.zeros((E * C + 1, d), dtype=x.dtype,
                          device=x.device).index_put((buf_idx,), x[token_of])
    buffers = buffers[: E * C].reshape(E, C, d)
    return buffers, (order, token_of, buf_idx, keep)


def combine(expert_out: Tensor, weights: Tensor, scatter_info, N: int
            ) -> Tensor:
    """Gather expert outputs back to token order with router weights."""
    order, token_of, buf_idx, keep = scatter_info
    E, C, d = expert_out.shape
    flat = torch.cat([expert_out.reshape(E * C, d),
                      expert_out.new_zeros((1, d))], dim=0)
    gathered = flat[buf_idx]                                 # (N*k, d)
    w_sorted = weights.reshape(-1)[order] * keep
    contrib = gathered.to(torch.float32) * w_sorted[:, None]
    return torch.zeros((N, d), dtype=torch.float32,
                       device=expert_out.device).index_add(0, token_of,
                                                           contrib)


def _expert_matmul(W: Tensor, buf: Tensor, probe, n_stat: int):
    """Per-expert ``tapped_matmul`` on flat (C, d) buffers, batched over
    E: y = buf @ W; act the first n_stat rows (zero-padded); the probe
    added to the same rows of y."""
    y = torch.matmul(buf, W.to(buf.dtype))                   # (E, C, f)
    E, C, d_in = buf.shape
    n = min(n_stat, C)
    act = buf[:, :n]
    if n < n_stat:
        act = F.pad(act, (0, 0, 0, n_stat - n))
    if probe is not None:
        y = torch.cat([y[:, :n] + probe[:, :n].to(y.dtype), y[:, n:]], dim=1)
    return y, act


def expert_ffn(buffers: Tensor, p: Dict, probes, acts, tag: str,
               n_stat: int) -> Tensor:
    """Gated-SiLU FFN over experts, with (E,)-stacked taps.

    buffers: (E, C, d). Params p: wi (E, d, 2*d_ff), wo (E, d_ff, d)."""
    h, acts[f"{tag}/moe_wi"] = _expert_matmul(
        p["wi"], buffers, probes.get(f"{tag}/moe_wi"), n_stat)
    gate, up = torch.chunk(h, 2, dim=-1)
    h = F.silu(gate) * up
    y, acts[f"{tag}/moe_wo"] = _expert_matmul(
        p["wo"], h, probes.get(f"{tag}/moe_wo"), n_stat)
    return y


def moe_block(x: Tensor, p: Dict, dims: MoeDims, probes, acts, tag: str,
              n_stat: int) -> Tuple[Tensor, Tensor]:
    """Full MoE FFN. x: (B, T, d) → (y, aux_loss)."""
    B, T, d = x.shape
    N = B * T
    xf = x.reshape(N, d)
    w, idx, aux = route(xf, p["router"], dims)
    buffers, info = dispatch(xf, idx, dims, capacity(N, dims))
    expert_out = expert_ffn(buffers, p, probes, acts, tag, n_stat)
    y = combine(expert_out, w, info, N)
    if dims.n_shared > 0:
        h, acts[f"{tag}/shared_wi"] = layers.tapped_matmul(
            p["shared_wi"], xf, probes.get(f"{tag}/shared_wi"), n_stat)
        gate, up = torch.chunk(h, 2, dim=-1)
        h = F.silu(gate) * up
        sy, acts[f"{tag}/shared_wo"] = layers.tapped_matmul(
            p["shared_wo"], h, probes.get(f"{tag}/shared_wo"), n_stat)
        y = y + sy.to(torch.float32)
    return y.reshape(B, T, d).to(x.dtype), aux


def init_moe_params(generator: torch.Generator, dims: MoeDims,
                    dtype=torch.float32) -> Dict[str, Tensor]:
    """The reference's shapes and scales, drawn from ``generator`` on its
    device (the numbers are not the reference's)."""
    E, d, f = dims.n_experts, dims.d_model, dims.d_ff
    dev = layers.init_device(generator)
    p = {
        "router": layers.dense_init(generator, d, E),
        "wi": (torch.randn((E, d, 2 * f), generator=generator, device=dev)
               / math.sqrt(d)).to(dtype),
        "wo": (torch.randn((E, f, d), generator=generator, device=dev)
               / math.sqrt(f)).to(dtype),
    }
    if dims.n_shared > 0:
        fs = f * dims.n_shared
        p["shared_wi"] = layers.dense_init(generator, d, 2 * fs, dtype=dtype)
        p["shared_wo"] = layers.dense_init(generator, fs, d, dtype=dtype)
    return p
