"""Which precision the path's small eighs need, on the CPU and on the card.

    PYTHONPATH=src python -m repro_torch.tools.eigh_precision [--no-cuda]

Every small eigh of the training path goes through ``kernels.ref.eigh``
(the Brand middle matrix, the two CholeskyQR2 Grams, the RSVD projection,
the dense EVD factors).  This script records the matrices handed to it in
three runs of 40 steps (a heavy step 0, a light step every fifth) — the
paper preset at batch 128 on the card, and the small preset at batch 8
(fewer rows than n_stat, so the stats carry zero rows) on the card and on
the CPU — and solves each recorded stack again in fp32 on the CPU and on
the card.  Per run and shape it prints one JSON line: the fp32 failures
(an error or a non-finite result) and the steps they came from, and the
worst eigenvalue error, residual
|M V − V Λ| and orthogonality |VᵀV − I| against float64, each relative to
max |M|; on the card also the time of one fp32 and one float64 solve
(CUDA events, mean of 20).  Last, it runs the paper preset's first 11
steps with the eigh in float64 and in fp32 on the card, in the order
float64, fp32, fp32, float64, and prints each run's step wall times by
kind and its losses.  ``--no-cuda`` does the CPU part only.
"""
from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import torch

from repro_torch.core import brand, kfactor, rsvd
from repro_torch.examples.train_vgg_kfac import build
from repro_torch.kernels import ref
from repro_torch.train import loop

_MODULES = (ref, brand, kfactor, rsvd)   # each holds its own ``eigh`` name
_FLOAT64 = ref.eigh                      # the path's eigh (float64 inside)


def _eigh_fp32(M):
    return torch.linalg.eigh(M)


def _patch(fn) -> None:
    for mod in _MODULES:
        mod.eigh = fn


def run_path(preset: str, batch: int, device, steps: int,
             eigh_fn=_FLOAT64, record=None):
    """``steps`` steps of the preset; returns (losses, per-step wall
    seconds, step kinds).  With ``record`` (a list), every matrix handed
    to the eigh is kept, as (step, matrix)."""
    walls, t = [], [0.0]

    def hooked(M):
        if record is not None:
            record.append((len(walls), M.detach().clone()))
        return eigh_fn(M)
    _patch(hooked)
    try:
        model, opt, stream = build(preset, "bkfac", batch=batch,
                                   device=device)
        batches = [stream.batch_at(i) for i in range(steps)]
        sched = opt.scheduler()
        kinds = [sched.work(k).label for k in range(steps)]

        def cb(k, state, loss):
            if device.type == "cuda":
                torch.cuda.synchronize()
            now = time.perf_counter()
            walls.append(now - t[0])
            t[0] = now
        t[0] = time.perf_counter()
        _, losses = loop.run_kfac_training(
            model.loss, opt, model.params(), batches, n_tokens=batch,
            seed=0, callback=cb, device=device)
    finally:
        _patch(_FLOAT64)
    return losses, walls, kinds


def _errors(M, dev):
    """fp32 eigh of the stack M on ``dev`` against float64 on the CPU:
    (failed, eig_err, residual, orth), each error relative to max |M|."""
    M64 = M.to("cpu", torch.float64)
    try:
        vals, vecs = torch.linalg.eigh(M.to(dev, torch.float32))
        vals, vecs = vals.to("cpu", torch.float64), vecs.to("cpu",
                                                            torch.float64)
    except RuntimeError:
        return True, None, None, None
    if not (torch.isfinite(vals).all() and torch.isfinite(vecs).all()):
        return True, None, None, None
    scale = float(M64.abs().max()) or 1.0
    want = torch.linalg.eigvalsh(M64)
    eye = torch.eye(M.shape[-1], dtype=torch.float64)
    return (False, float((vals - want).abs().max()) / scale,
            float((M64 @ vecs - vecs * vals[..., None, :]).abs().max())
            / scale,
            float((vecs.mT @ vecs - eye).abs().max()))


def _time_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def report(name: str, mats, with_cuda: bool) -> None:
    by_shape = defaultdict(list)
    for step, M in mats:
        by_shape[tuple(M.shape)].append((step, M))
    devs = ["cpu"] + (["cuda"] if with_cuda else [])
    for shape, group in sorted(by_shape.items(), key=lambda kv: kv[0][-1]):
        row = {"run": name, "shape": list(shape), "calls": len(group)}
        for dev in devs:
            errs = [(k, _errors(M, torch.device(dev))) for k, M in group]
            ok = [e for _, e in errs if not e[0]]
            row[f"{dev}_fp32_failures"] = len(errs) - len(ok)
            row[f"{dev}_fp32_failed_steps"] = sorted(
                {k for k, e in errs if e[0]})
            for i, key in ((1, "eig_err"), (2, "residual"), (3, "orth")):
                row[f"{dev}_fp32_{key}"] = (max(e[i] for e in ok)
                                            if ok else None)
        if with_cuda:
            M = group[0][1].to("cuda", torch.float32)
            row["cuda_ms_fp32"] = _time_ms(lambda: _eigh_fp32(M))
            row["cuda_ms_float64"] = _time_ms(lambda: _FLOAT64(M))
        print(json.dumps(row), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-cuda", action="store_true")
    args = ap.parse_args(argv)
    with_cuda = not args.no_cuda
    if with_cuda and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --no-cuda for the CPU part)")
    runs = [("small/batch8/cpu", "small", 8, torch.device("cpu"))]
    if with_cuda:
        smi = torch.cuda.get_device_name(0)
        print(json.dumps({"device": smi, "torch": torch.__version__,
                          "cuda": torch.version.cuda}), flush=True)
        runs = [("paper/batch128/cuda", "paper", 128, torch.device("cuda")),
                ("small/batch8/cuda", "small", 8, torch.device("cuda"))
                ] + runs
    for name, preset, batch, dev in runs:
        mats = []
        run_path(preset, batch, dev, 40, record=mats)
        report(name, mats, with_cuda)
    if with_cuda:
        dev = torch.device("cuda")
        for label, fn in (("float64", _FLOAT64), ("fp32", _eigh_fp32),
                          ("fp32", _eigh_fp32), ("float64", _FLOAT64)):
            losses, walls, kinds = run_path("paper", 128, dev, 11,
                                            eigh_fn=fn)
            by_kind = defaultdict(list)
            for kind, w in zip(kinds, walls):
                by_kind[kind].append(w)
            print(json.dumps({"run": "paper/batch128/cuda", "eigh": label,
                              "wall_s_by_kind": by_kind,
                              "losses": losses}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
