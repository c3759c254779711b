"""Parameters from the reference package, for the parity tests.

``params_from_jax`` turns a nested parameter tree of the JAX package (the
VGG's {"conv0_0": {"w", "b", "bn_s", "bn_b"}, …}, the quickstart MLP's
{"fc0": {"w"}, …} or the LM's {"embed", "segments": {"0": {"p0": {"mix":
{"wq", …}}}}, "head": {"w"}, …}), with its leaves already converted to
numpy arrays by the caller, into the port's flat {"conv0_0/w": tensor, …}
dict ("segments/0/p0/mix/wq", with the segment's stacked repeats still
its leading axis).  Layouts are shared (weights (d_in, d_out), NHWC
activations, channel-major im2col), so no leaf is transposed.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch import device as device_lib


def params_from_jax(np_tree: Mapping, device=None, prefix: str = ""
                    ) -> Dict[str, torch.Tensor]:
    device = device_lib.resolve(device)
    out: Dict[str, torch.Tensor] = {}
    for key in sorted(np_tree):
        leaf = np_tree[key]
        path = f"{prefix}{key}"
        if isinstance(leaf, Mapping):
            out.update(params_from_jax(leaf, device, prefix=path + "/"))
        else:
            out[path] = torch.as_tensor(
                np.array(leaf, dtype=np.float32), device=device)
    return out
