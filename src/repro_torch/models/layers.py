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


def tapped_matmul(W: Tensor, x: Tensor, probe: Optional[Tensor],
                  n_stat: int) -> Tuple[Tensor, Tensor]:
    """y = x @ W with K-FAC instrumentation → (y, act).

    Flat inputs (…, d_in): act is the first n_stat rows (zero-padded when
    fewer).  Sequence inputs (B, T, d_in): the stats rows are the first
    ceil(n_stat/B) tokens of every sequence, as in the reference."""
    y = x @ W.to(x.dtype)
    d_in = x.shape[-1]
    d_out = y.shape[-1]
    if x.dim() == 3:
        B, T = x.shape[0], x.shape[1]
        n_per = min(T, max(1, -(-n_stat // B)))
        rows = B * n_per
        act = x[:, :n_per, :].reshape(rows, d_in)
        act = act[:n_stat] if rows >= n_stat else F.pad(
            act, (0, 0, 0, n_stat - rows))
        if probe is not None:
            pr = probe.to(y.dtype)
            pr = F.pad(pr, (0, 0, 0, rows - n_stat)) if rows > n_stat \
                else pr[:rows]
            y = torch.cat([y[:, :n_per, :] + pr.reshape(B, n_per, d_out),
                           y[:, n_per:, :]], dim=1)
        return y, act
    xf = x.reshape(-1, d_in)
    n = min(n_stat, xf.shape[0])
    act = xf[:n]
    if n < n_stat:
        act = F.pad(act, (0, 0, 0, n_stat - n))
    if probe is not None:
        yf = y.reshape(-1, d_out)
        yf = torch.cat([yf[:n] + probe[:n].to(y.dtype), yf[n:]], dim=0)
        y = yf.reshape(y.shape)
    return y, act


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
