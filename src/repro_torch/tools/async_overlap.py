"""Where the async pipeline's lag window spends its time on the card.

    PYTHONPATH=src python -m repro_torch.tools.async_overlap

B-R-KFAC on the paper's full-width VGG16_bn (batch 128, T_rsvd 25,
heavy_lag 5, the ``slice_async`` path of ``chip_smoke.py``), one CUDA
card.  Prints one JSON line per measurement:

- ``heavy``: the step-25 launch ranges' heavy ops through an
  ``AsyncInverseRunner`` while nothing else runs, and the same ops in
  the main thread; wall ms (host clock after ``torch.cuda.synchronize()``),
  twice each;
- ``window``: 31 training steps, synchronous and async: the wall ms of
  steps 24–30 and each heavy range's start and end on the same clock;
- ``window`` ``spin``: the async run where every heavy range first spins
  the Python interpreter for 30 ms — work that holds the interpreter
  lock and never touches the card, so what it adds to the training
  steps is the lock's share.

The heavy ranges are traced by wrapping ``kfactor.heavy_from_snapshot``,
which the runner looks up on the module at each call; a run whose trace
does not hold one span per launched range fails.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import time

import torch

from repro_torch.core import kfac as kfac_lib
from repro_torch.core import kfactor
from repro_torch.examples.train_vgg_kfac import build
from repro_torch.train import loop

STEPS = 31
LAG = 5
SPIN_S = 0.030


def _setup(async_heavy: bool):
    dev = torch.device("cuda")
    model, opt, stream = build("paper", "brkfac", batch=128, device=dev,
                               use_kernels=True)
    cfg = dataclasses.replace(opt.cfg, async_heavy=async_heavy,
                              heavy_lag=LAG if async_heavy else 0)
    return model, kfac_lib.Kfac(cfg, opt.taps, device=dev), stream


def window(label: str, async_heavy: bool, spin_s: float = 0.0) -> None:
    model, opt, stream = _setup(async_heavy)
    batches = [stream.batch_at(i) for i in range(STEPS)]
    runner = loop.AsyncInverseRunner.for_opt(opt) if async_heavy else None
    spans, ends = [], []
    heavy = kfactor.heavy_from_snapshot

    def traced(spec, buf, lo, hi):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < spin_s:
            pass
        out = heavy(spec, buf, lo, hi)
        spans.append((t0, time.perf_counter()))
        return out

    def cb(k, state, loss):
        torch.cuda.current_stream().synchronize()
        ends.append(time.perf_counter())

    kfactor.heavy_from_snapshot = traced
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop.run_kfac_training(model.loss, opt, model.params(), batches,
                               n_tokens=128, seed=0, callback=cb,
                               device=opt.device, overlap=runner or False)
    finally:
        kfactor.heavy_from_snapshot = heavy
    if runner is not None and len(spans) != runner.health["launched"]:
        raise AssertionError(f"{label}: {len(spans)} heavy spans traced for "
                             f"{runner.health['launched']} launched ranges")
    ms = lambda t: (t - t0) * 1e3
    walls = [ms(b) - ms(a) for a, b in zip(ends[23:], ends[24:])]
    print(json.dumps({
        "measure": "window", "label": label, "spin_ms": spin_s * 1e3,
        "steps": list(range(24, STEPS)), "wall_ms": walls,
        "heavy_spans_ms": [(ms(a), ms(b)) for a, b in spans],
        "step_ends_ms": [ms(t) for t in ends[23:]],
        "health": runner.health if runner else None}), flush=True)


def heavy_alone() -> None:
    model, opt, stream = _setup(True)
    batches = [stream.batch_at(i) for i in range(LAG * 5 + 1)]
    state, _ = loop.run_kfac_training(model.loss, opt, model.params(),
                                      batches, n_tokens=128, seed=0,
                                      device=opt.device)
    work = opt.scheduler().work(LAG * 5)
    ranges = [(bi, lo, hi) for bi, r in enumerate(work.launch)
              for lo, hi in r]
    for rep in range(2):
        runner = loop.AsyncInverseRunner.for_opt(opt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.launch(state.opt, work)
        runner.landing(dataclasses.replace(work, land=work.launch))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        runner.close()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for bi, lo, hi in ranges:
            kfactor.heavy_from_snapshot(opt.factor_buckets[bi].spec,
                                        state.opt.inflight[str(bi)], lo, hi)
        torch.cuda.synchronize()
        print(json.dumps({"measure": "heavy", "rep": rep, "ranges":
                          len(ranges), "runner_wall_ms": wall,
                          "runner_range_ms": [d * 1e3
                                              for d in runner.durations],
                          "health": runner.health, "inline_wall_ms":
                          (time.perf_counter() - t0) * 1e3}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("async_overlap: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"device": smi,
                      "stream_priorities": torch.cuda.Stream
                      .priority_range()}), flush=True)
    heavy_alone()
    for _ in range(2):
        window("sync", async_heavy=False)
        window("async", async_heavy=True)
    window("spin", async_heavy=True, spin_s=SPIN_S)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
