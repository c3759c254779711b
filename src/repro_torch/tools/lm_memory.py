"""Device memory of the LM path at gemma3-4b's full width: the
cross-entropy's backward (``models/lm.py::_ce_loss``) at the path's
logits, and one B-KFAC training step of ``chip_smoke.py``'s ``slice_lm``
model with and without remat.

    PYTHONPATH=src python -m repro_torch.tools.lm_memory [--layers 2,1]

``--layers`` gives the repeats of gemma3-4b's two segments (2,1: 16 of
its 34 layers, as ``slice_lm``).  Each case prints one JSON line with its
peak device memory above what was allocated before it (an out-of-memory
failure is printed with the peak it reached, not raised).  It needs one
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from repro_torch.configs.base import get_arch
from repro_torch.core import kfac as kfac_lib
from repro_torch.data.synthetic import TokenStream
from repro_torch.examples.train_lm_kfac import kfac_config
from repro_torch.models import lm as lm_lib
from repro_torch.train import loop

GB = 1e9


def _peak(fn):
    """(peak bytes above the current allocation while ``fn`` runs, error
    text or None)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    err = None
    try:
        fn()
        torch.cuda.synchronize()
    except torch.OutOfMemoryError as e:
        err = str(e).splitlines()[0]
    return torch.cuda.max_memory_allocated() - base, err


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", default="2,1")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = get_arch("gemma3_4b")
    B, T = args.batch, args.seq

    def ce():
        logits = torch.randn((B, T, g.vocab), device=dev,
                             dtype=torch.bfloat16, requires_grad=True)
        tgt = torch.randint(0, g.vocab, (B, T), device=dev)
        loss = lm_lib._ce_loss(logits[:, :-1], tgt[:, 1:])
        torch.autograd.grad(loss, logits)
    peak, err = _peak(ce)
    print(json.dumps({"case": "ce", "logits": [B, T, g.vocab],
                      "peak_gb": peak / GB, "oom": err}), flush=True)

    arch = g.with_repeats(tuple(int(r) for r in args.layers.split(",")))
    batch = TokenStream(vocab=arch.vocab, batch=B, seq_len=T, seed=0,
                        device=dev).batch_at(0)
    for remat in (True, False):
        lm = lm_lib.LM(arch, remat=remat, device=dev)
        params = lm.init(torch.Generator(device=dev).manual_seed(0))
        opt = kfac_lib.Kfac(kfac_config(), lm.taps, device=dev)
        rng = torch.Generator(device=dev).manual_seed(1)
        state = loop.TrainState(params=params, opt=opt.init(params),
                                rng=rng)
        step = loop.make_scheduled_kfac_step(lm.loss_fn, opt,
                                             n_tokens=B * T)
        work = opt.scheduler().work(0)
        held = torch.cuda.memory_allocated()
        peak, err = _peak(lambda: step(state, batch, work))
        print(json.dumps({"case": "step", "remat": remat,
                          "n_layers": arch.n_layers, "batch": [B, T],
                          "held_gb": held / GB,
                          "peak_gb": (held + peak) / GB, "oom": err}),
              flush=True)
        del lm, params, opt, state, step
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
