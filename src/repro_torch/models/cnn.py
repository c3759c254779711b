"""Conv nets with K-FAC taps — the paper's VGG16_bn experiment.

Counterpart of ``src/repro/models/cnn.py``.  Convolutions are im2col
patches × a tapped matmul (the K-FAC conv approximation), kept in the
reference's NHWC layout at every public function so weights carry across
unchanged.  ``make_vgg`` builds the paper's *modified* VGG16_bn: 2×1
pooling keeps the width, so FC0 is 16384-in × 2048-out at full width.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch import device as device_lib
from repro_torch.core.kfac import TapInfo
from repro_torch.models import layers

Tensor = torch.Tensor


def im2col(x: Tensor, k: int) -> Tensor:
    """(B, H, W, C) → (B, H, W, k·k·C) "SAME" patches, stride 1, in the
    reference's channel-major feature order (c, kh, kw)."""
    B, H, W, _ = x.shape
    cols = F.unfold(x.permute(0, 3, 1, 2), k, padding=k // 2)
    return cols.transpose(1, 2).reshape(B, H, W, -1)


def batch_norm(x: Tensor, scale: Tensor, bias: Tensor, eps: float = 1e-5
               ) -> Tensor:
    """Batch statistics over (B, H, W), biased variance."""
    mu = x.mean(dim=(0, 1, 2), keepdim=True)
    var = x.var(dim=(0, 1, 2), unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def max_pool(x: Tensor, pool: Tuple[int, int]) -> Tensor:
    """"VALID" max pool with window = stride = pool, NHWC."""
    B, H, W, C = x.shape
    ph, pw = pool
    x = x[:, :H // ph * ph, :W // pw * pw]
    return x.reshape(B, H // ph, ph, W // pw, pw, C).amax(dim=(2, 4))


@dataclasses.dataclass(frozen=True)
class VggConfig:
    stages: Tuple[int, ...] = (16, 32, 64)
    n_classes: int = 10
    fc_hidden: int = 512
    n_stat: int = 256
    pool: Tuple[int, int] = (2, 1)   # the paper's 2×1 pooling trick
    img: int = 32


class Vgg(nn.Module):
    """The parameters of the modified VGG16_bn, and its loss.

    ``params()`` is the flat {"conv0_0/w": Parameter, …} dict the optimizer
    works on; ``loss(params, probes, batch)`` reads the weights from the
    dict it is given (the reference's functional signature), so passing
    ``params()`` trains this module's own tensors."""

    def __init__(self, cfg: VggConfig, conv_specs, flat_dim: int,
                 device: torch.device, seed: int):
        super().__init__()
        self.cfg = cfg
        self.conv_names = [name for name, _, _ in conv_specs]
        g = torch.Generator(device=device).manual_seed(seed)
        for name, d_in, c_out in conv_specs:
            self.add_module(name, nn.ParameterDict({
                "w": layers.dense_init(g, d_in, c_out, device=device),
                "b": torch.zeros(c_out, device=device),
                "bn_s": torch.ones(c_out, device=device),
                "bn_b": torch.zeros(c_out, device=device)}))
        self.fc0 = nn.ParameterDict({
            "w": layers.dense_init(g, flat_dim, cfg.fc_hidden, device=device),
            "b": torch.zeros(cfg.fc_hidden, device=device)})
        self.fc1 = nn.ParameterDict({
            "w": layers.dense_init(g, cfg.fc_hidden, cfg.n_classes,
                                   device=device),
            "b": torch.zeros(cfg.n_classes, device=device)})

    def params(self) -> Dict[str, nn.Parameter]:
        return {name.replace(".", "/"): p
                for name, p in self.named_parameters()}

    @torch.no_grad()
    def load_params(self, values: Dict[str, Tensor]) -> None:
        own = self.params()
        if set(own) != set(values):
            raise ValueError(f"parameter names differ: "
                             f"{sorted(set(own) ^ set(values))}")
        for k, p in own.items():
            if tuple(values[k].shape) != tuple(p.shape):
                raise ValueError(f"{k}: shape {tuple(values[k].shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(values[k])

    def forward(self, params, probes, x: Tensor):
        """x: (B, img, img, 3) NHWC → (logits, acts)."""
        cfg = self.cfg
        acts: Dict[str, Tensor] = {}
        h = x
        names = iter(self.conv_names)
        for _ in cfg.stages:
            for _ in range(2):
                name = next(names)
                p = im2col(h, 3)
                B, H, W, D = p.shape
                y, acts[name] = layers.tapped_matmul(
                    params[f"{name}/w"], p.reshape(B * H * W, D),
                    probes.get(name), cfg.n_stat)
                h = (y + params[f"{name}/b"]).reshape(B, H, W, -1)
                h = batch_norm(h, params[f"{name}/bn_s"],
                               params[f"{name}/bn_b"])
                h = torch.relu(h)
            h = max_pool(h, cfg.pool)
        h = h.reshape(h.shape[0], -1)
        h, acts["fc0"] = layers.tapped_matmul(params["fc0/w"], h,
                                              probes.get("fc0"), cfg.n_stat)
        h = torch.relu(h + params["fc0/b"])
        logits, acts["fc1"] = layers.tapped_matmul(
            params["fc1/w"], h, probes.get("fc1"), cfg.n_stat)
        return logits + params["fc1/b"], acts

    def loss(self, params, probes, batch):
        x, y = batch
        logits, acts = self.forward(params, probes, x)
        ll = F.log_softmax(logits, dim=-1)
        return -ll.gather(1, y[:, None].long()).mean(), acts

    @torch.no_grad()
    def accuracy(self, params, batch) -> Tensor:
        x, y = batch
        logits, _ = self.forward(params, {}, x)
        return (logits.argmax(-1) == y).to(torch.float32).mean()


def make_vgg(cfg: VggConfig, device=None, seed: int = 0
             ) -> Tuple[Vgg, Dict[str, TapInfo]]:
    """Returns (model, taps).  ``device=None`` means the card."""
    device = device_lib.resolve(device)
    conv_specs: List[Tuple[str, int, int]] = []
    c_in = 3
    for s, c in enumerate(cfg.stages):
        for j in range(2):
            conv_specs.append((f"conv{s}_{j}", 9 * c_in, c))
            c_in = c
    h = cfg.img // (cfg.pool[0] ** len(cfg.stages))
    w = cfg.img // (cfg.pool[1] ** len(cfg.stages))
    flat_dim = h * w * cfg.stages[-1]
    taps: Dict[str, TapInfo] = {
        name: TapInfo(param_path=f"{name}/w", d_in=d_in, d_out=c_out,
                      n_stat=cfg.n_stat)
        for name, d_in, c_out in conv_specs}
    taps["fc0"] = TapInfo(param_path="fc0/w", d_in=flat_dim,
                          d_out=cfg.fc_hidden, n_stat=cfg.n_stat)
    taps["fc1"] = TapInfo(param_path="fc1/w", d_in=cfg.fc_hidden,
                          d_out=cfg.n_classes, n_stat=cfg.n_stat)
    return Vgg(cfg, conv_specs, flat_dim, device, seed), taps
