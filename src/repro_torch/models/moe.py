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

**Data parallelism** (a policy ``sp`` with ``sp.data_parallel``): the
reference routes the global batch's N tokens, so the capacity comes from
the global N, and a token's slot in its expert from the stable sort over
all tokens, which orders them by rank.  Rank r's tokens of expert e thus
take the slots after those of ranks < r: one all-gather of the ranks'
(E,) counts gives each rank its offsets, and a token past the capacity
drops exactly as in the reference.  A rank's buffer holds only its kept
tokens, in slot order from 0 (its capacity is its largest kept count),
so each rank runs the experts on its own tokens (its capacity read from
the device: a host read; a policy with ``moe_capacity="even"`` takes
⌈C / data ranks⌉ instead, the reference's GSPMD block of the global
buffer, which reads nothing and drops a rank's tokens past it, as the
meta-tensor dry-run needs); the expert taps place
the rank's rows at their global slots (``layers.tapped_matmul``'s rule). The
Switch loss ``E·Σ me·fe`` is a product of two global means: both sums are
summed over the data axes before it (``me``'s differentiably), so every
rank's router gets its share of the global gradient.

**Expert parallelism** (a tensor-parallel ``sp``, experts on the model
axis): the router stays replicated, and every model rank routes the
whole (gathered) token set exactly as one device does, the global
capacity over the data axes included; each rank then keeps its experts'
buffers (``dispatch``'s sentinel takes the others' tokens), runs them,
and its combine is a partial sum over the model axis, which the block
reduces into the residual.  The shared experts are column- then
row-parallel.  The (E,)-stacked taps hold the rank's experts;
``models/lm.py`` gathers their acts along the stack dim.
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


def route(x: Tensor, w_router: Tensor, dims: MoeDims, sp=None
          ) -> Tuple[Tensor, Tensor, Tensor]:
    """Router: returns (weights (N,k), expert_idx (N,k), aux_loss).  With
    a data-parallel ``sp`` the load-balance loss is the global batch's."""
    logits = x.to(torch.float32) @ w_router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                    # (N, E)
    w, idx = torch.topk(probs, dims.top_k, dim=-1)
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    # load-balance auxiliary loss (Switch-style)
    E = dims.n_experts
    onehot = F.one_hot(idx[:, 0], E).to(torch.float32)
    if sp is not None and sp.data_parallel:
        n = x.shape[0] * sp.dp_size
        me = sp.dp_sum_grad(torch.sum(probs, dim=0)) / n
        fe = sp.dp_sum(torch.sum(onehot, dim=0)) / n
    else:
        me = torch.mean(probs, dim=0)                        # (E,)
        fe = torch.mean(onehot, dim=0)
    aux = E * torch.sum(me * fe)
    return w.to(torch.float32), idx, aux


def dispatch(x: Tensor, idx: Tensor, dims: MoeDims, capacity: int,
             sp=None):
    """Scatter tokens into per-expert buffers.

    x: (N, d); idx: (N, k). Returns (buffers (E, C, d), scatter_info).
    With a data-parallel ``sp``, ``capacity`` is the global one and the
    buffers hold this rank's kept tokens (see the module docstring); the
    info then ends with each expert's first global slot on this rank
    (E,), else with None."""
    N, d = x.shape
    k = idx.shape[1]
    E, C = dims.n_experts, capacity
    flat_e = idx.reshape(-1)                                 # (N*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # bincount's count, by a scatter-add (which also runs on meta tensors)
    counts = torch.zeros(E, dtype=torch.int64, device=x.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=0) - counts            # (E,)
    pos_in_e = torch.arange(N * k, device=x.device) - starts[sorted_e]
    offs = None
    if sp is not None and sp.data_parallel:
        every = sp.dp_gather(counts[None])                   # (ranks, E)
        offs = torch.sum(every[:sp.dp_index], dim=0)         # (E,)
        keep = pos_in_e + offs[sorted_e] < C
        if sp.moe_capacity == "even":
            C = -(-C // sp.dp_size)
            keep = keep & (pos_in_e < C)
        else:
            kept = torch.clamp(torch.minimum(counts, C - offs), min=0)
            C = max(1, int(kept.max()))
    else:
        keep = pos_in_e < C
    buf_idx = torch.where(keep, sorted_e * C + pos_in_e,
                          torch.full_like(pos_in_e, E * C))
    token_of = order // k                                    # (N*k,)
    buffers = torch.zeros((E * C + 1, d), dtype=x.dtype,
                          device=x.device).index_put((buf_idx,), x[token_of])
    buffers = buffers[: E * C].reshape(E, C, d)
    return buffers, (order, token_of, buf_idx, keep, offs)


def combine(expert_out: Tensor, weights: Tensor, scatter_info, N: int
            ) -> Tensor:
    """Gather expert outputs back to token order with router weights."""
    order, token_of, buf_idx, keep = scatter_info[:4]
    E, C, d = expert_out.shape
    flat = torch.cat([expert_out.reshape(E * C, d),
                      expert_out.new_zeros((1, d))], dim=0)
    gathered = flat[buf_idx]                                 # (N*k, d)
    w_sorted = weights.reshape(-1)[order] * keep
    contrib = gathered.to(torch.float32) * w_sorted[:, None]
    return torch.zeros((N, d), dtype=torch.float32,
                       device=expert_out.device).index_add(0, token_of,
                                                           contrib)


def _expert_matmul(W: Tensor, buf: Tensor, probe, n_stat: int, offs=None):
    """Per-expert ``tapped_matmul`` on flat (C, d) buffers, batched over
    E: y = buf @ W; act the first n_stat rows (zero-padded); the probe
    added to the same rows of y.  ``offs`` (E,), under data parallelism:
    each expert's local slot 0 is its global slot ``offs[e]``, and act
    holds this rank's rows at their global slots, zeros elsewhere."""
    y = torch.matmul(buf, W.to(buf.dtype))                   # (E, C, f)
    E, C, d_in = buf.shape
    if offs is None:
        offs = torch.zeros((E,), dtype=torch.int64, device=buf.device)
    zero = torch.zeros((), dtype=buf.dtype, device=buf.device)
    src = torch.arange(n_stat, device=buf.device)[None, :] - offs[:, None]
    mine = (src >= 0) & (src < C)                            # (E, n_stat)
    act = torch.where(mine[..., None], torch.gather(
        buf, 1, src.clamp(0, C - 1)[..., None].expand(E, n_stat, d_in)),
        zero)
    if probe is not None:
        dst = offs[:, None] + torch.arange(C, device=buf.device)
        pr = torch.gather(probe, 1, dst.clamp(max=n_stat - 1)[
            ..., None].expand(E, C, probe.shape[-1]))
        y = y + torch.where((dst < n_stat)[..., None], pr.to(y.dtype),
                            zero.to(y.dtype))
    return y, act


def expert_ffn(buffers: Tensor, p: Dict, probes, acts, tag: str,
               n_stat: int, offs=None) -> Tensor:
    """Gated-SiLU FFN over experts, with (E,)-stacked taps.

    buffers: (E, C, d). Params p: wi (E, d, 2*d_ff), wo (E, d_ff, d).
    ``offs``: ``dispatch``'s global slot offsets under data parallelism."""
    h, acts[f"{tag}/moe_wi"] = _expert_matmul(
        p["wi"], buffers, probes.get(f"{tag}/moe_wi"), n_stat, offs)
    gate, up = torch.chunk(h, 2, dim=-1)
    h = F.silu(gate) * up
    y, acts[f"{tag}/moe_wo"] = _expert_matmul(
        p["wo"], h, probes.get(f"{tag}/moe_wo"), n_stat, offs)
    return y


def _local_experts(buffers: Tensor, info, sp):
    """The rank's experts of ``dispatch``'s buffers and scatter info
    (``sp.moe_buffers``' block): the other experts' assignments go to the
    sentinel and leave ``keep``."""
    order, token_of, buf_idx, keep, offs = info
    E, C = buffers.shape[:2]
    buffers = sp.moe_buffers(buffers)
    El = buffers.shape[0]
    e0 = sp.block_range(E, El)[0]
    loc = (buf_idx >= e0 * C) & (buf_idx < (e0 + El) * C)
    buf_idx = torch.where(loc, buf_idx - e0 * C,
                          torch.full_like(buf_idx, El * C))
    offs = offs[e0:e0 + El] if offs is not None else None
    return buffers, (order, token_of, buf_idx, keep & loc, offs)


def moe_block(x: Tensor, p: Dict, dims: MoeDims, probes, acts, tag: str,
              n_stat: int, sp=None) -> Tuple[Tensor, Tensor]:
    """Full MoE FFN. x: (B, T, d) → (y, aux_loss); with a data-parallel
    ``sp``, x is this rank's rows and the capacity, the slots, the taps'
    rows and the aux loss are the global batch's.  Under tensor
    parallelism (module docstring) y is the rank's fp32 partial sum over
    the model axis."""
    B, T, d = x.shape
    N = B * T
    tp = sp is not None and sp.model_parallel
    xf = x.reshape(N, d)
    w, idx, aux = route(xf, p["router"], dims, sp)
    n_all = N * (sp.dp_size if sp is not None else 1)
    buffers, info = dispatch(xf, idx, dims, capacity(n_all, dims), sp)
    El = p["wi"].shape[0]
    if El != dims.n_experts:
        e0 = sp.block_range(dims.n_experts, El)[0]
        buffers, info = _local_experts(buffers, info, sp)
        probes = dict(probes)
        for name in ("moe_wi", "moe_wo"):
            if f"{tag}/{name}" in probes:
                probes[f"{tag}/{name}"] = probes[f"{tag}/{name}"][e0:e0 + El]
    expert_out = expert_ffn(buffers, p, probes, acts, tag, n_stat, info[4])
    y = combine(expert_out, w, info, N)
    if tp and El == dims.n_experts:
        y = sp.as_partial(y)
    if dims.n_shared > 0:
        fs = dims.d_ff * dims.n_shared
        h, acts[f"{tag}/shared_wi"] = layers.tapped_matmul(
            p["shared_wi"], xf, probes.get(f"{tag}/shared_wi"), n_stat, sp)
        if tp:
            h = sp.gather_cols(h, 2 * fs)
        gate, up = torch.chunk(h, 2, dim=-1)
        partial = tp and p["shared_wo"].shape[0] != fs
        if partial:
            gate, up = sp.block(gate, -1), sp.block(up, -1)
        h = F.silu(gate) * up
        sy, acts[f"{tag}/shared_wo"] = layers.tapped_matmul(
            p["shared_wo"], h, probes.get(f"{tag}/shared_wo"), n_stat, sp,
            partial)
        sy = sy.to(torch.float32)
        y = y + (sy if partial or not tp else sp.as_partial(sy))
    if tp:
        return y.reshape(B, T, d), aux
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
