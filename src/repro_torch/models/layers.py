"""Building-block layers with K-FAC taps.

Counterpart of ``src/repro/models/layers.py``.  A *tap* instruments ``y = x @ W``: the first ``n_stat`` rows of
the input are emitted as the forward-factor square root, and a zero
*probe* with ``requires_grad`` is added to the same rows of the output,
so ∂L/∂probe is the backward-factor square root.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _stat_rows(xr: Tensor, yr: Tensor, probe: Optional[Tensor], off: int,
              n_stat: int, add: bool = True) -> Tuple[Tensor, Tensor]:
    """A rank's part of a tap: ``xr`` (L, d_in) and ``yr`` (L, d_out) are
    rows ``off .. off + L - 1`` of the global statistics order → (act,
    yr): act (n_stat, d_in) holds those of them below ``n_stat`` at their
    global places and zeros elsewhere (summing the ranks' acts gives the
    global slice, zero-padded); the probe's matching rows are added to
    ``yr``, so ∂L/∂probe is nonzero only on this rank's rows.  At
    ``off = 0`` with every row this is the one-device tap."""
    k = max(0, min(xr.shape[0], n_stat - off))
    lead = min(off, n_stat)
    act = F.pad(xr[:k], (0, 0, lead, n_stat - lead - k))
    if probe is not None and k > 0 and add:
        yr = torch.cat([yr[:k] + probe[off:off + k].to(yr.dtype), yr[k:]],
                       dim=0)
    elif probe is not None:     # no row of this rank: the probe's grad is 0
        yr = yr + probe[:0].sum().to(yr.dtype)
    return yr, act


def tapped_matmul(W: Tensor, x: Tensor, probe: Optional[Tensor],
                  n_stat: int, sp=None, partial: bool = False
                  ) -> Tuple[Tensor, Tensor]:
    """y = x @ W with K-FAC instrumentation → (y, act).

    Flat inputs (…, d_in): act is the first n_stat rows (zero-padded when
    fewer).  Sequence inputs (B, T, d_in): the stats rows are the first
    ceil(n_stat/B) tokens of every sequence, as in the reference.

    With a data-parallel policy ``sp`` (``models/sharding_policy.py``) x
    holds this rank's rows of the global batch, and the rows are those of
    the global batch: B in ceil(n_stat/B) is the global batch, this
    rank's rows are block ``sp.dp_index`` of the global slice in batch
    order (on the flat path, of the global flat order, so they may all sit
    on rank 0), and the truncation to n_stat and the padding apply to the
    global rows.  The act and the probe's gradient then hold this rank's
    rows at their global places and zeros elsewhere: summed over the data
    axes they are the reference's.

    Under tensor parallelism (``sp.model_parallel``) a column-parallel
    ``W`` (the rank's output columns: fewer than the probe's) takes the
    probe's block of columns, so ∂L/∂probe holds the rank's columns; a
    row-parallel one (``partial``: ``x`` is the rank's input columns and
    ``W`` its rows) gives a partial sum, in fp32 from the operands' dtype
    (the sum over the model axis is then rounded once, as one device's
    product is), and the probe is added on model rank 0 only, so the sum
    of the ranks' probe gradients is ∂L/∂y once.  act is then the rank's
    input columns; ``models/lm.py`` gathers the acts over the model axis
    and ``train/loop.py::kfac_grads`` gathers the column blocks of the
    probe gradients and sums the row-parallel ones."""
    if partial and x.dtype != torch.float32:
        y = x.to(torch.float32) @ W.to(x.dtype).to(torch.float32)
    else:
        y = x @ W.to(x.dtype)
    d_in = x.shape[-1]
    d_out = y.shape[-1]
    add = True
    if sp is not None and sp.model_parallel and probe is not None:
        if probe.shape[-1] != d_out:
            lo, hi = sp.block_range(probe.shape[-1], d_out)
            probe = probe[..., lo:hi]
        add = not partial or sp.tp_index == 0
    n_dp, idx = (1, 0) if sp is None else (sp.dp_size, sp.dp_index)
    if x.dim() == 3:
        B, T = x.shape[0], x.shape[1]
        n_per = min(T, max(1, -(-n_stat // (B * n_dp))))
        rows = B * n_per
        yr, act = _stat_rows(x[:, :n_per, :].reshape(rows, d_in),
                            y[:, :n_per, :].reshape(rows, d_out), probe,
                            idx * rows, n_stat, add)
        if probe is not None:
            y = torch.cat([yr.reshape(B, n_per, d_out), y[:, n_per:, :]],
                          dim=1)
        return y, act
    xf = x.reshape(-1, d_in)
    yf, act = _stat_rows(xf, y.reshape(-1, d_out), probe,
                        idx * xf.shape[0], n_stat, add)
    return yf.reshape(y.shape), act


def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(x.dtype)


def layer_norm(x: Tensor, scale: Tensor, bias: Tensor, eps: float = 1e-5
               ) -> Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(x.dtype)


def init_device(generator: Optional[torch.Generator]) -> torch.device:
    """The device an init draws on: its generator's, or the meta device
    for a shapes-only init (``generator=None``, which ``torch.randn``
    takes as the default generator and meta never consumes)."""
    return generator.device if generator is not None else torch.device(
        "meta")


def dense_init(generator: Optional[torch.Generator], d_in: int, d_out: int,
               scale: Optional[float] = None, device=None,
               dtype=torch.float32) -> Tensor:
    """N(0, 1)·scale (default 1/√d_in), drawn in fp32 on ``device`` (the
    generator's device by default), then cast to ``dtype``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return (torch.randn((d_in, d_out), generator=generator,
                        device=device or init_device(generator))
            * scale).to(dtype)


def softcap(x: Tensor, cap: float) -> Tensor:
    """Gemma2-style logit soft-capping."""
    return cap * torch.tanh(x / cap)


def rope(x: Tensor, positions: Tensor, theta: float = 10000.0) -> Tensor:
    """Rotary embeddings in the reference's half-split layout (the first
    and second halves of the head dim rotate together), angles in fp32.
    x: (..., T, H, hd), positions: (..., T)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device),
                      -torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def make_probes(taps: Dict, device=None, dtype=torch.float32
                ) -> Dict[str, Tensor]:
    """Zero probes {name: (*stack, n_stat, d_out)} with requires_grad."""
    return {name: torch.zeros(tuple(t.stack) + (t.n_stat, t.d_out),
                              dtype=dtype, device=device, requires_grad=True)
            for name, t in taps.items()}
