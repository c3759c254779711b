"""Batched serving demo: the continuous-batching engine over a small LM.

Counterpart of ``examples/serve_demo.py``:

    PYTHONPATH=src python -m repro_torch.examples.serve_demo [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import device as device_lib
from repro_torch.configs.base import get_arch
from repro_torch.models.lm import LM
from repro_torch.serve.engine import Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: cuda (a host without a card raises)")
    device = device_lib.resolve(ap.parse_args(argv).device)
    arch = get_arch("gemma3_4b").reduced()
    lm = LM(arch, remat=False, device=device)
    params = lm.init(torch.Generator(device=device).manual_seed(0))
    engine = Engine(lm, params, batch_slots=4, max_len=64)

    prompts = [[1, 5, 9], [2, 4], [7, 7, 7, 7], [3], [8, 1, 2], [9, 9]]
    for i, p in enumerate(prompts):
        engine.submit(Request(uid=i, prompt=p, max_new=8))
    t0 = time.time()
    ticks = engine.run_until_drained()
    dt = time.time() - t0
    done = sorted(engine.completed)
    print(f"served {len(done)}/{len(prompts)} requests in {ticks} ticks "
          f"({dt:.1f}s, {ticks / dt:.1f} ticks/s, {device.type})")
    for uid in done:
        r = engine.completed[uid]
        print(f"  req {uid}: prompt={r.prompt} -> {r.out_tokens}")
    if len(done) != len(prompts):
        raise SystemExit(f"served {len(done)}/{len(prompts)} requests")
    print("OK")


if __name__ == "__main__":
    main()
