"""The port's device rule: entry points run on the card unless the caller
asks for another device, and the arithmetic is full fp32."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` means ``cuda``; a host with no card then raises rather than
    carrying on on the CPU.  Also turns TF32 off for matmuls and cuDNN:
    the reference computes in fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the GPU by default; "
                "pass device=torch.device('cpu') to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
