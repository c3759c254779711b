#!/usr/bin/env python3
"""Quickest proof that the PyTorch port starts and is right on one GPU.

    python3 chip_smoke.py                 # every phase, one CUDA card

Phases, run in this order (each prints one JSON line):
  device   card name and power limit (nvidia-smi), torch and CUDA versions
  build    the CUDA kernels built by nvcc for sm_90a from the checkout
  kernels  every kernel body (and cholqr2 as a whole) at the shapes of the
           main path, held against its plain PyTorch version on the card,
           timed with CUDA events beside its bound and one PyTorch call
  agree    a small VGG trained a few steps on the card through the kernels
           and on the CPU through the plain versions, from the same
           weights, batches and random draws: the losses must agree
  slice    the main path: B-KFAC training of the paper's full-width
           VGG16_bn (batch 128, 11 steps: heavy, 4 idle, light, 4 idle,
           light) with every launch count reset just before and read just
           after
then the ``kernels`` line and, last, the ``ok`` line.  Any failure raises:
the script exits nonzero and prints no ``ok`` line.  It has no CPU path.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(flops: float, nbytes: float):
    t_ops = flops / PEAK_FP32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back launches."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return smi


def phase_build():
    from repro_torch.kernels import _build
    seconds = _build.build_timed()
    emit({"phase": "build", "seconds": seconds,
          "library": str(_build.library_path().relative_to(ROOT)),
          "nvcc_flags": " ".join(_build.NVCC_FLAGS)})


def _rel_err(got, want) -> tuple:
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    return err, err / max(scale, 1e-30)


def phase_kernels():
    """Each kernel body at the path's shapes against its plain version."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import brand_panel as bp
    from repro_torch.kernels import cholqr as cq
    from repro_torch.kernels import ea_syrk as ea
    from repro_torch.kernels import precond_fused as pf

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)

    def orth(b, d, w):
        return torch.linalg.qr(rnd(b, d, w))[0].contiguous()

    def inv_diag(b, w):
        # (D + λ)⁻¹ − 1/λ for a descending spectrum, λ = 0.1·max D
        D = torch.sort(rnd(b, w).abs() + 0.01, dim=-1, descending=True)[0]
        lam = 0.1 * D[:, 0]
        return 1.0 / (D + lam[:, None]) - 1.0 / lam[:, None], lam

    # tolerance: fp32 in, fp32 accumulate, another summation order over K
    # up to 16384 — error relative to the largest entry of the plain result
    TOL = 2e-4
    TOL_CHOLQR = 1e-3   # two eigh-based roots in the chain
    results = {}

    def record(name, source, replaces, cases, kernel, plain, library, fl_by,
               tol=TOL):
        worst = 0.0
        worst_abs = 0.0
        for args in cases:
            got, want = kernel(*args), plain(*args)
            pairs = got if isinstance(got, tuple) else (got,)
            wants = want if isinstance(want, tuple) else (want,)
            for a, b in zip(pairs, wants):
                if not bool(torch.isfinite(a).all()):
                    raise AssertionError(f"{name}: non-finite kernel output")
                e_abs, e_rel = _rel_err(a, b)
                worst, worst_abs = max(worst, e_rel), max(worst_abs, e_abs)
            if worst > tol:
                raise AssertionError(f"{name}: rel err {worst:.3g} > {tol} "
                                     f"at shapes "
                                     f"{[tuple(x.shape) for x in args]}")
        big = cases[0]
        flops, nbytes = fl_by(*big)
        bms, by = bound_ms(flops, nbytes)
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "max_abs_err": worst_abs,
               "max_rel_err": worst, "tol_rel": tol,
               "shape": [list(x.shape) for x in big],
               "ms": time_ms(lambda: kernel(*big)),
               "plain_ms": time_ms(lambda: plain(*big)),
               "library_ms": (time_ms(lambda: library(*big))
                              if library is not None else None),
               "bound_ms": bms, "bound_by": by}
        row["bound_share"] = row["bound_ms"] / row["ms"]
        emit({"phase": "kernels", **row})
        results[name] = row

    F = 4  # bytes per fp32
    csrc = "src/repro_torch/kernels/csrc/"

    # ea_syrk: largest bucket (RSVD d=256, B=2) first, then d = 27 and 10
    keep, coef = 0.95, 1.0 - 0.95
    sym = lambda b, d: (lambda m: (m + m.mT) / 2)(rnd(b, d, d)).contiguous()
    record("ea_syrk", csrc + "ea_syrk.cu", "src/repro/kernels/ea_syrk.py:53",
           [(sym(2, 256), rnd(2, 256, 256)), (sym(1, 27), rnd(1, 27, 256)),
            (sym(1, 10), rnd(1, 10, 256))],
           lambda M, X: ea.ea_syrk_batched(M, X, keep, coef),
           lambda M, X: ref.ea_syrk(M, X, 0.95, False),
           lambda M, X: torch.baddbmm(M, X, X.mT, beta=keep, alpha=coef),
           # X Xᵀ is symmetric: n·d·(d+1) FLOP for one triangle
           lambda M, X: (X.shape[0] * X.shape[2] * X.shape[1]
                         * (X.shape[1] + 1),
                         F * (2 * M.numel() + X.numel())))

    # Brand panel: fc0's bucket (d = 16384, B = 1) and the d = 512, B = 4
    brand = [(orth(1, 16384, 230), rnd(1, 16384, 256)),
             (orth(4, 512, 230), rnd(4, 512, 256))]
    record("ut_a", csrc + "brand_panel.cu",
           "src/repro/kernels/brand_panel.py:58", brand,
           bp.ut_a_batched, ref.ut_a, lambda U, A: torch.bmm(U.mT, A),
           lambda U, A: (2 * U.shape[0] * U.shape[1] * U.shape[2]
                         * A.shape[2],
                         F * (U.numel() + A.numel()
                              + U.shape[0] * U.shape[2] * A.shape[2])))
    perp = [(A, U, ref.ut_a(U, A).contiguous()) for U, A in brand]
    record("a_perp", csrc + "brand_panel.cu",
           "src/repro/kernels/brand_panel.py:82", perp,
           bp.a_perp_batched, ref.a_perp,
           lambda A, U, C: torch.baddbmm(A, U, C, alpha=-1.0),
           lambda A, U, C: (2 * U.shape[0] * U.shape[1] * U.shape[2]
                            * A.shape[2],
                            F * (2 * A.numel() + U.numel() + C.numel())))

    # CholeskyQR2 passes: fc0's A⊥ (1, 16384, 256) and the step-0 RSVD
    # range finder's (2, 256, 240)
    panels = [(rnd(1, 16384, 256),), (rnd(2, 256, 240),)]
    record("syrk_tn", csrc + "cholqr.cu", "src/repro/kernels/cholqr.py:74",
           panels, cq.syrk_tn_batched, ref.syrk_tn,
           lambda A: torch.bmm(A.mT, A),
           # AᵀA is symmetric: d·n·(n+1) FLOP for one triangle
           lambda A: (A.shape[0] * A.shape[1] * A.shape[2]
                      * (A.shape[2] + 1),
                      F * (A.numel() + A.shape[0] * A.shape[2] ** 2)))
    roots = [(A, ref.gram_inv_sqrt(ref.syrk_tn(A), ref.CHOLQR_FLOOR_RESOLVE,
                                   "tr")[1].contiguous())
             for (A,) in panels]
    record("rinv_apply", csrc + "cholqr.cu",
           "src/repro/kernels/cholqr.py:95", roots,
           cq.rinv_apply_batched, ref.rinv_apply, torch.bmm,
           lambda A, R: (2 * A.shape[0] * A.shape[1] * A.shape[2] ** 2,
                         F * (2 * A.numel() + R.numel())))

    # precond: fc0 in parameter layout (J 16384×2048, w = 486 both sides),
    # then conv0_0 (27×64, w 27 / 64) and fc1 (2048×10, w 486 / 10)
    def pcase(b, p, d, wg, wa):
        s_g, lam_g = inv_diag(b, wg)
        s_a, lam_a = inv_diag(b, wa)
        return (rnd(b, p, d), orth(b, p, wg), s_g, 1.0 / lam_g,
                orth(b, d, wa), s_a, 1.0 / lam_a)

    pc = [pcase(1, 16384, 2048, 486, 486), pcase(1, 27, 64, 27, 64),
          pcase(1, 2048, 10, 486, 10)]
    record("precond_panel", csrc + "precond_fused.cu",
           "src/repro/kernels/precond_fused.py:122",
           [(Ug, J, sg) for J, Ug, sg, _, _, _, _ in pc],
           pf.precond_panel_batched, ref.precond_panel, None,
           lambda Ug, J, sg: (2 * J.numel() * Ug.shape[2],
                              F * (Ug.numel() + J.numel() + sg.numel()
                                   + Ug.shape[0] * Ug.shape[2]
                                   * J.shape[2])))
    apply_cases = [(J, Ug, ref.precond_panel(Ug, J, sg).contiguous(), Ua, sa,
                    ilg, ila) for J, Ug, sg, ilg, Ua, sa, ila in pc]
    record("precond_apply", csrc + "precond_fused.cu",
           "src/repro/kernels/precond_fused.py:140", apply_cases,
           pf.precond_apply_batched,
           lambda J, Ug, Cg, Ua, sa, ilg, ila: ref.precond_apply(
               J, Ug, Cg, Ua, sa, 1.0 / ilg, 1.0 / ila),
           None,
           lambda J, Ug, Cg, Ua, sa, ilg, ila: (
               2 * J.numel() * (Ug.shape[2] + 2 * Ua.shape[2]),
               F * (2 * J.numel() + Ug.numel() + Cg.numel() + Ua.numel()
                    + sa.numel() + 2 * ilg.numel())))

    # cholqr2 as a whole (kernels + the two small eighs) — not a kernel
    # entry of its own, so it is reported but not listed
    A = panels[0][0]
    got, want = cq.cholqr2_batched(A), ref.cholqr2(A)
    errs = [_rel_err(a, b) for a, b in zip(got, want)]
    orth_err = float((got[0].mT @ got[0]
                      - torch.eye(A.shape[-1], device=dev)).abs().max())
    if max(e for _, e in errs) > TOL_CHOLQR or orth_err > 1e-3:
        raise AssertionError(f"cholqr2: rel err {errs}, orth {orth_err}")
    emit({"phase": "kernels", "name": "cholqr2", "shape": list(A.shape),
          "max_rel_err_Q": errs[0][1], "max_rel_err_R": errs[1][1],
          "tol_rel": TOL_CHOLQR, "orth_err": orth_err,
          "ms": time_ms(lambda: cq.cholqr2_batched(A)),
          "plain_ms": time_ms(lambda: ref.cholqr2(A))})
    return results


def numpy_draws(opt, seed: int):
    """The heavy ops' random inputs made with numpy from (seed, step,
    bucket), so the card and the CPU runs consume the same draws."""
    import numpy as np
    import torch
    from repro_torch.core import kfactor

    sched = opt.scheduler()

    def draws(step):
        work, out = sched.work(step), {}
        for bi, b in enumerate(opt.factor_buckets):
            s = b.spec
            if not (work.heavy[bi] and kfactor.needs_draws(s)):
                continue
            rs = np.random.default_rng([seed, step, bi])
            if s.mode is kfactor.Mode.BRAND_CORR:
                keys = rs.random((b.total, s.r))
                out[bi] = torch.from_numpy(np.argsort(keys, -1)[:, :s.n_crc])
            else:
                k = min(s.r + s.r_o, s.d)
                out[bi] = torch.from_numpy(rs.standard_normal(
                    (b.total, s.d, k)).astype(np.float32))
        return out
    return draws


def phase_agree():
    """Small VGG: kernel route on the card vs plain route on the CPU."""
    import numpy as np
    import torch
    from repro_torch.core import kfac as kfac_lib
    from repro_torch.core import policy as policy_lib
    from repro_torch.data.synthetic import ImageStream
    from repro_torch.models.cnn import VggConfig, make_vgg
    from repro_torch.optim import base as optbase
    from repro_torch.train import loop

    cfg = VggConfig(stages=(8, 16), fc_hidden=64, n_stat=32)
    # a step size at which fp32 rounding does not grow from step to step
    # (see tests/test_torch_vgg.py: the spectrum continuation and Adam on
    # pre-batch-norm biases amplify rounding, so both are kept quiet)
    kcfg = kfac_lib.KfacConfig(
        policy=policy_lib.PolicyConfig(variant="bkfac", r=16,
                                       max_dense_dim=1024),
        lr=optbase.constant(0.03), damping_phi=optbase.constant(0.1),
        clip=0.1, spectrum_continuation=False, T_updt=2, T_inv=4,
        T_brand=2, T_rsvd=4, T_corct=4, use_kernels=True,
        fallback_lr=optbase.constant(1e-3))
    cpu = torch.device("cpu")
    batches = [ImageStream(batch=16, seed=1, device=cpu).batch_at(i)
               for i in range(6)]
    losses, weights = {}, None
    for dev in (cpu, torch.device("cuda")):
        model, taps = make_vgg(cfg, device=dev, seed=3)
        if weights is None:
            weights = {k: v.detach().clone()
                       for k, v in model.params().items()}
        model.load_params(weights)
        opt = kfac_lib.Kfac(kcfg, taps, device=dev)
        _, losses[dev.type] = loop.run_kfac_training(
            model.loss, opt, model.params(),
            [(x.to(dev), y.to(dev)) for x, y in batches], n_tokens=16,
            seed=0, device=dev, draws=numpy_draws(opt, seed=5))
    a, b = np.asarray(losses["cuda"]), np.asarray(losses["cpu"])
    err = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-6)))
    # tolerance: the card and the CPU sum in other orders and their eighs
    # and SVDs come from other libraries; over 6 steps that stays < 1e-3
    # (measured 3e-5 at step 6 on an H100; it grows ~10x a step after)
    if not (np.all(np.isfinite(a)) and err < 1e-3):
        raise AssertionError(f"agree: card {a} vs cpu {b} (rel {err:.3g})")
    emit({"phase": "agree", "losses_cuda": a.tolist(),
          "losses_cpu": b.tolist(), "max_rel_err": err, "tol_rel": 1e-3})


def phase_slice():
    """The main path at full width; returns the launch counts."""
    import torch
    from repro_torch.examples.train_vgg_kfac import build
    from repro_torch.kernels import _build
    from repro_torch.train import loop

    dev = torch.device("cuda")
    steps = 11
    model, opt, stream = build("paper", "bkfac", batch=128, device=dev,
                               use_kernels=True)
    batches = [stream.batch_at(i) for i in range(steps)]
    sched = opt.scheduler()
    kinds = [sched.work(k).label for k in range(steps)]
    n_params = sum(p.numel() for p in model.params().values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    t_prev = [time.perf_counter()]

    def cb(k, state, loss):
        torch.cuda.synchronize()
        now = time.perf_counter()
        walls.append(now - t_prev[0])
        t_prev[0] = now

    _build.reset_launch_counts()
    t_prev[0] = time.perf_counter()
    _, losses = loop.run_kfac_training(model.loss, opt, model.params(),
                                       batches, n_tokens=128, seed=0,
                                       callback=cb, device=dev)
    counts = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if not all(map(lambda v: v == v and abs(v) < float("inf"), losses)):
        raise AssertionError(f"slice: non-finite loss {losses}")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"slice: kernels never launched: {missing}")
    for k in range(steps):
        emit({"phase": "slice", "step": k, "kind": kinds[k],
              "loss": losses[k], "wall_s": walls[k]})
    by_kind = {}
    for kind, w in zip(kinds, walls):
        by_kind.setdefault(kind, []).append(w)
    emit({"phase": "slice", "summary": True, "params": n_params,
          "steps": steps, "kinds": kinds,
          "wall_s_by_kind": {k: v for k, v in by_kind.items()},
          "peak_mem_bytes": peak, "launches": counts,
          "buckets": [f"d={b.spec.d} {b.spec.mode.value} B={b.total}"
                      for b in opt.factor_buckets]})
    return counts


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    phase_build()
    kernels = phase_kernels()
    phase_agree()
    counts = phase_slice()
    rows = []
    for name, row in kernels.items():
        rows.append({k: row[k] for k in (
            "name", "route", "source", "replaces")} | {
            "launches": counts[name]} | {k: row[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
