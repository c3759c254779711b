"""End-to-end LM training with the B-KFAC hybrid optimizer.

Counterpart of ``examples/train_lm_kfac.py``:

    PYTHONPATH=src python -m repro_torch.examples.train_lm_kfac \
        --preset tiny --steps 30 [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.train_lm_kfac \
        --preset 100m --steps 300

``tiny`` is gemma3-4b's ``reduced()`` config; ``100m`` a gemma3-family
config of ~115M parameters (8 layers, d_model 512, vocab 32768).  The
optimizer settings are the reference's (r 64, max_dense_dim 2048, T_updt =
T_brand = 2, T_inv = T_rsvd = T_corct = 10, lr 0.02, damping 0.1, weight
decay 1e-4, clip 0.5, fallback lr 3e-3), stepped through
``make_scheduled_kfac_step``; on the card the factor and preconditioning
work goes through the CUDA kernels.  A checkpoint goes to ``--ckpt-dir``
every 10 steps, and a rerun resumes from the newest one there — the
reference's checkpoints too: the restore template is ``{"params",
"opt"}``, the leaves both packages share.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.configs.base import LayerSpec, Segment, get_arch
from repro_torch.core import kfac as kfac_lib
from repro_torch.core import policy as policy_lib
from repro_torch.data.synthetic import TokenStream
from repro_torch.models.lm import LM
from repro_torch.optim import base as optbase
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop


def preset_arch(name: str):
    g = get_arch("gemma3_4b")
    if name == "tiny":
        return g.reduced()
    # ~115M params: 8 layers, d=512, vocab=32k
    spec = LayerSpec(mixer="gqa", ffn="dense", window=256)
    return dataclasses.replace(
        g, n_layers=8, d_model=512, n_heads=8, n_kv_heads=4, d_ff=1536,
        vocab=32768, head_dim=64, n_stat=128, dtype="float32",
        segments=(Segment((spec,), 8),))


def kfac_config(optimizer: str = "bkfac", stagger: bool = False,
                stagger_splits: int = 4,
                use_kernels: bool = True) -> kfac_lib.KfacConfig:
    """The reference example's optimizer settings."""
    return kfac_lib.KfacConfig(
        policy=policy_lib.PolicyConfig(variant=optimizer, r=64,
                                       max_dense_dim=2048),
        lr=optbase.constant(0.02), damping_phi=optbase.constant(0.1),
        weight_decay=1e-4, clip=0.5,
        T_updt=2, T_inv=10, T_brand=2, T_rsvd=10, T_corct=10,
        stagger=stagger, stagger_splits=stagger_splits,
        use_kernels=use_kernels, fallback_lr=optbase.constant(3e-3))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="tiny", choices=("tiny", "100m"))
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--optimizer", default="bkfac",
                    choices=list(policy_lib.VARIANTS))
    ap.add_argument("--stagger", action="store_true",
                    help="phase heavy factor work across the T_inv window "
                         "(flat per-step cost instead of periodic spikes)")
    ap.add_argument("--stagger-splits", type=int, default=4)
    ap.add_argument("--ckpt-dir", default="lm_ckpt")
    ap.add_argument("--device", default=None,
                    help="default: cuda (a host without a card raises)")
    args = ap.parse_args(argv)

    dev = device_lib.resolve(args.device)
    arch = preset_arch(args.preset)
    lm = LM(arch, remat=False, device=dev)
    opt = kfac_lib.Kfac(kfac_config(args.optimizer, args.stagger,
                                    args.stagger_splits), lm.taps,
                        device=dev)
    sched = opt.scheduler()
    if args.stagger:
        print(f"scheduler: {sched.describe()}")

    stream = TokenStream(vocab=arch.vocab, batch=args.batch,
                         seq_len=args.seq, seed=0, device=dev)
    params = lm.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(x.numel() for x in params.values())
    print(f"arch={arch.name}({args.preset})  params={n_params / 1e6:.1f}M  "
          f"optimizer={args.optimizer}  device={dev}")

    state = loop.TrainState(params=params, opt=opt.init(params),
                            rng=torch.Generator(device=dev).manual_seed(1))
    start = ckpt.latest_step(args.ckpt_dir)
    if start is not None:
        got, _ = ckpt.restore(args.ckpt_dir,
                              {"params": state.params, "opt": state.opt})
        state = loop.TrainState(params=got["params"], opt=got["opt"],
                                rng=state.rng)
        print(f"resumed from checkpoint step {start}")
    k0 = 0 if start is None else start + 1

    step_fn = loop.make_scheduled_kfac_step(
        lm.loss_fn, opt, n_tokens=args.batch * args.seq)
    ck = ckpt.AsyncCheckpointer(args.ckpt_dir, keep=2)
    t0 = time.time()
    losses = []
    for k in range(k0, args.steps):
        state, loss = step_fn(state, stream.batch_at(k), sched.work(k))
        losses.append(float(loss))
        if k % 10 == 0:
            print(f"step {k:4d}  loss {float(loss):.4f}  "
                  f"({time.time() - t0:.0f}s)", flush=True)
            ck.submit(k, state)
    ck.close()
    uniform = np.log(arch.vocab)
    if losses:
        print(f"final loss {np.mean(losses[-5:]):.4f} "
              f"(uniform={uniform:.2f})")
    return state, losses


if __name__ == "__main__":
    main()
