#!/usr/bin/env python3
"""Quickest proof that the PyTorch port starts and is right on one GPU.

    python3 chip_smoke.py                 # every phase, one CUDA card

Phases, run in this order (each prints one JSON line):
  device   card name and power limit (nvidia-smi), torch and CUDA versions
  build    the CUDA kernels built by nvcc for sm_90a from the checkout
  kernels  every kernel body (and cholqr2 as a whole) at the shapes of the
           main path, held against its plain PyTorch version on the card
           (the tensor-core kernels also against float64), timed with CUDA
           events beside its bound and one PyTorch call
  agree    a small VGG trained a few steps on the card through the kernels
           and on the CPU through the plain versions, from the same
           weights, batches and random draws: the losses must agree
           (B-KFAC, NS-KFAC, and B-KFAC with linear-apply taps)
  slice    path 1: B-KFAC training of the paper's full-width VGG16_bn
           (batch 128, 11 steps: heavy, 4 idle, light, 4 idle, light)
  slice_nskfac
           path 2: NS-KFAC on the same model and batch, 11 steps (heavy,
           4 idle, stats, 4 idle, stats): the Newton–Schulz kernel and,
           on fc0 and the conv4 bucket, lowrank_apply
  slice_linear
           path 3: B-KFAC with fc0 and fc1 as Alg-8 linear-apply taps, 11
           steps: lowrank_apply on every step
Each path is driven with every launch count reset just before and read
just after; then the ``kernels`` line (launches summed over the three
paths) and, last, the ``ok`` line.  Any failure raises:
the script exits nonzero and prints no ``ok`` line.  It has no CPU path.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, TF32 on them (dense), and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(flops: float, nbytes: float, tc_k: int = 0):
    """The least time for ``flops`` fp32 operations and ``nbytes`` of
    traffic on the route a kernel runs on: fp32 FMA, or (``tc_k``, the
    contraction length) the tensor cores at TF32, three products an fp32
    one (3xTF32), four where the contraction is one k-step of
    csrc/tc_gemm.cuh."""
    from repro_torch.kernels import _build
    products = 4 if tc_k <= _build.TC_BK else 3
    t_ops = (products * flops / PEAK_TF32_FLOPS if tc_k
             else flops / PEAK_FP32_FLOPS)
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


def graph_ms(fn, side, reps: int = 20) -> float:
    """Mean device time of ``fn`` over ``reps`` launches replayed from one
    CUDA graph captured on the stream ``side``: the device's time without
    the host's launch overhead, which back-to-back eager calls of a small
    kernel measure instead.  Every call takes the same ``side``: cuBLAS
    keeps a workspace for each stream it has run on."""
    import torch
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):   # warm up on the capture stream (its workspaces)
            fn()
    # capture_begin/end directly: torch.cuda.graph() would also empty the
    # allocator's cache, and the paths after this phase would then pay for
    # every cudaMalloc again in their first step
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin()
        for _ in range(reps):
            fn()
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
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
          "nvcc_flags": " ".join(_build.NVCC_FLAGS),
          # blocks of the pipelined GEMM resident at once, by cluster size
          "pipe_resident_blocks": {
              f"{c}x{per_sm}": _build.resident_blocks(c, per_sm)
              for c in range(1, 9) for per_sm in (1, 2)},
          # blocks of the tensor-core GEMM resident at once, by cluster size
          "tc_resident_blocks": {c: _build.tc_resident_blocks(c)
                                 for c in range(1, 9)}})


def _rel_err(got, want) -> tuple:
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    return err, err / max(scale, 1e-30)


def phase_kernels():
    """Each kernel body at the path's shapes against its plain version."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import brand_panel as bp
    from repro_torch.kernels import cholqr as cq
    from repro_torch.kernels import ea_syrk as ea
    from repro_torch.kernels import lowrank_apply as la
    from repro_torch.kernels import ns_inverse as ns
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
    # (the tensor-core rows: fp32-accurate 3xTF32, the same tolerance, and
    # F64_RATIO against a float64 product)
    TOL = 2e-4
    TOL_CHOLQR = 1e-3   # two eigh-based roots in the chain
    results = {}
    side = torch.cuda.Stream()   # the graph timings' capture stream

    def shapes(args):
        return [list(x.shape) for x in args if isinstance(x, torch.Tensor)]

    def record(name, source, replaces, cases, kernel, plain, library, fl_by,
               tol=TOL, bitwise=False, graph=False, exact=None, tc_k=None):
        """Check every case against the plain version (and, with
        ``bitwise``, that a second launch gives the same bits; with
        ``exact``, the float64 result, that the kernel's largest error
        against it is at most F64_RATIO times the plain version's), then
        time every case (with ``graph``, also the device time of the
        kernel and of the library call, replayed from a CUDA graph); the
        row's own numbers are the first case's.  A row with ``tc_k`` (the
        contraction length of a case) runs on the tensor cores: its bound
        is the TF32 route's, and each case also prints the fp32-FMA
        bound."""
        worst = 0.0
        worst_abs = 0.0
        f64 = []
        for args in cases:
            got, want = kernel(*args), plain(*args)
            if bitwise and not torch.equal(got, kernel(*args)):
                raise AssertionError(f"{name}: two launches differ at shapes "
                                     f"{shapes(args)}")
            pairs = got if isinstance(got, tuple) else (got,)
            wants = want if isinstance(want, tuple) else (want,)
            for a, b in zip(pairs, wants):
                if not bool(torch.isfinite(a).all()):
                    raise AssertionError(f"{name}: non-finite kernel output")
                e_abs, e_rel = _rel_err(a, b)
                worst, worst_abs = max(worst, e_rel), max(worst_abs, e_abs)
            if worst > tol:
                raise AssertionError(f"{name}: rel err {worst:.3g} > {tol} "
                                     f"at shapes {shapes(args)}")
            if exact is not None:
                ref64 = exact(*args)
                e_k = float((got.double() - ref64).abs().max())
                e_p = float((want.double() - ref64).abs().max())
                f64.append({"f64_err": e_k, "plain_f64_err": e_p,
                            "f64_ratio": e_k / max(e_p, 1e-300)})
                del ref64
                if not e_k <= F64_RATIO * e_p:
                    raise AssertionError(
                        f"{name}: error against float64 {e_k:.3g} > "
                        f"{F64_RATIO} × the plain version's {e_p:.3g} at "
                        f"shapes {shapes(args)}")
        timed = []
        for i, args in enumerate(cases):
            fl, nb = fl_by(*args)
            bms, by = bound_ms(fl, nb, tc_k=tc_k(*args) if tc_k else 0)
            t = {"shape": shapes(args),
                 "ms": time_ms(lambda: kernel(*args)),
                 "plain_ms": time_ms(lambda: plain(*args)),
                 "library_ms": (time_ms(lambda: library(*args))
                                if library is not None else None),
                 "bound_ms": bms, "bound_by": by}
            t["bound_share"] = t["bound_ms"] / t["ms"]
            if tc_k is not None:
                t["bound_fp32_ms"] = bound_ms(fl, nb)[0]
            if f64:
                t.update(f64[i])
            if t["library_ms"] is not None:
                t["vs_library"] = t["ms"] / t["library_ms"]
            if graph:
                t["device_ms"] = graph_ms(lambda: kernel(*args), side)
                t["device_bound_share"] = t["bound_ms"] / t["device_ms"]
                t["library_device_ms"] = graph_ms(lambda: library(*args),
                                                  side)
                t["vs_library_device"] = (t["device_ms"]
                                          / t["library_device_ms"])
            timed.append(t)
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "max_abs_err": worst_abs,
               "max_rel_err": worst, "tol_rel": tol, **timed[0],
               "cases": timed} | ({"bitwise_repeat": True} if bitwise else {})
        if f64:
            row["max_f64_ratio"] = max(c["f64_ratio"] for c in f64)
        emit({"phase": "kernels", **row})
        results[name] = row

    F = 4  # bytes per fp32
    csrc = "src/repro_torch/kernels/csrc/"

    # ea_syrk (3xTF32 on the tensor cores, one triangle of X Xᵀ): B-KFAC's
    # largest dense bucket (RSVD d = 256, B = 2) first, then every dense
    # bucket of the two paths (B-KFAC's d ≤ 256 are NS-KFAC's smallest
    # five), X (B, d, 256) with its n = 256 stats rows; keep and coef as
    # ops.ea_syrk computes them in fp32
    keep = float(np.float32(0.95))
    coef = float(np.float32(1.0) - np.float32(0.95))
    sym = lambda b, d: (lambda m: (m + m.mT) / 2)(rnd(b, d, d)).contiguous()
    record("ea_syrk", csrc + "ea_syrk.cu", "src/repro/kernels/ea_syrk.py:53",
           [(sym(b, d), rnd(b, d, 256))
            for b, d in ((2, 256),) + tuple(x for x in NS_BUCKETS
                                            if x != (2, 256))],
           lambda M, X: ea.ea_syrk_batched(M, X, keep, coef),
           lambda M, X: ref.ea_syrk(M, X, 0.95, False),
           lambda M, X: torch.baddbmm(M, X, X.mT, beta=keep, alpha=coef),
           # X Xᵀ is symmetric: n·d·(d+1) FLOP for one triangle
           lambda M, X: (X.shape[0] * X.shape[2] * X.shape[1]
                         * (X.shape[1] + 1),
                         F * (2 * M.numel() + X.numel())),
           bitwise=True, graph=True,
           exact=lambda M, X: (keep * M.double()
                               + coef * (X.double() @ X.double().mT)),
           tc_k=lambda M, X: X.shape[2])

    # Brand panel: fc0's bucket (d = 16384, B = 1) and the d = 512, B = 4
    brand = [(orth(1, 16384, 230), rnd(1, 16384, 256)),
             (orth(4, 512, 230), rnd(4, 512, 256))]
    # ut_a at fc0 with a contiguous U, then at every Brand bucket of the
    # path with U as the path passes it: the [..., :230] column slice of
    # the (B, d, 486) state (row stride 486: 8-byte aligned rows)
    ut_a_cases = [brand[0]] + [
        (orth(b, d, 486)[..., :230], rnd(b, d, 256))
        for b, d in BRAND_BUCKETS]
    record("ut_a", csrc + "brand_panel.cu",
           "src/repro/kernels/brand_panel.py:58", ut_a_cases,
           bp.ut_a_batched, ref.ut_a, lambda U, A: torch.bmm(U.mT, A),
           lambda U, A: (2 * U.shape[0] * U.shape[1] * U.shape[2]
                         * A.shape[2],
                         F * (U.numel() + A.numel()
                              + U.shape[0] * U.shape[2] * A.shape[2])),
           bitwise=True, graph=True)
    # a_perp (3xTF32 on the tensor cores) at fc0 with a contiguous U, then
    # at every Brand bucket with the path's U, as ut_a above
    perp = [(A, U, ref.ut_a(U, A).contiguous()) for U, A in ut_a_cases]
    record("a_perp", csrc + "brand_panel.cu",
           "src/repro/kernels/brand_panel.py:82", perp,
           bp.a_perp_batched, ref.a_perp,
           lambda A, U, C: torch.baddbmm(A, U, C, alpha=-1.0),
           lambda A, U, C: (2 * U.shape[0] * U.shape[1] * U.shape[2]
                            * A.shape[2],
                            F * (2 * A.numel() + U.numel() + C.numel())),
           bitwise=True, graph=True,
           exact=lambda A, U, C: A.double() - U.double() @ C.double(),
           tc_k=lambda A, U, C: U.shape[2])

    # CholeskyQR2 passes: fc0's A⊥ (1, 16384, 256), every other Brand
    # bucket's (B, d, 256) and the step-0 RSVD range finder's (2, 256, 240)
    panels = ([(rnd(1, 16384, 256),)]
              + [(rnd(b, d, 256),) for b, d in BRAND_BUCKETS[:-1]]
              + [(rnd(2, 256, 240),)])
    record("syrk_tn", csrc + "cholqr.cu", "src/repro/kernels/cholqr.py:74",
           panels, cq.syrk_tn_batched, ref.syrk_tn,
           lambda A: torch.bmm(A.mT, A),
           # AᵀA is symmetric: d·n·(n+1) FLOP for one triangle
           lambda A: (A.shape[0] * A.shape[1] * A.shape[2]
                      * (A.shape[2] + 1),
                      F * (A.numel() + A.shape[0] * A.shape[2] ** 2)),
           bitwise=True, graph=True,
           exact=lambda A: A.double().mT @ A.double(),
           tc_k=lambda A: A.shape[1])
    # rinv_apply at fc0's A⊥, then every Brand bucket's (B, d, 256) and the
    # RSVD range finder's (2, 256, 240)
    roots = [(A, ref.gram_inv_sqrt(ref.syrk_tn(A), ref.CHOLQR_FLOOR_RESOLVE,
                                   "tr")[1].contiguous())
             for (A,) in panels]
    record("rinv_apply", csrc + "cholqr.cu",
           "src/repro/kernels/cholqr.py:95", roots,
           cq.rinv_apply_batched, ref.rinv_apply, torch.bmm,
           lambda A, R: (2 * A.shape[0] * A.shape[1] * A.shape[2] ** 2,
                         F * (2 * A.numel() + R.numel())),
           graph=True)

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

    # Newton–Schulz GEMM update (3xTF32 on the tensor cores) at every
    # (B, d) of NS-KFAC's path, the largest bucket (d = 2304, B = 2) first,
    # both launches of a step: T = M̂X (α, β = 0, 1; C not read) and
    # X' = 2X − XT (α, β = 2, −1).  baddbmm computes the same function.
    def ns_cases(b, d):
        Mh = (lambda a: a @ a.mT / d)(rnd(b, d, d)).contiguous()
        Xn = 0.1 * rnd(b, d, d)
        Tn = (Mh @ Xn).contiguous()
        return [(Xn, Mh, Xn, 0.0, 1.0), (Xn, Xn, Tn, 2.0, -1.0)]

    record("ns_gemm_update", csrc + "ns_inverse.cu",
           "src/repro/kernels/ns_inverse.py:54",
           [c for b, d in NS_BUCKETS[::-1] for c in ns_cases(b, d)],
           ns.gemm_update_batched, ref.gemm_update,
           lambda C, A, B, al, be: torch.baddbmm(C, A, B, beta=al, alpha=be),
           lambda C, A, B, al, be: (
               2 * A.shape[0] * A.shape[1] * A.shape[2] * B.shape[2],
               F * (A.numel() + B.numel() + C.numel()
                    + (C.numel() if al != 0 else 0))),
           bitwise=True, graph=True,
           exact=lambda C, A, B, al, be: (be * (A.double() @ B.double())
                                          + al * C.double()),
           tc_k=lambda C, A, B, al, be: A.shape[2])

    # lowrank_apply: NS-KFAC's fc0 (X = (J U_G)ᵀ, 2048×16384, w = 486),
    # its conv4 bucket (3 × 512×4608), and the Alg-8 fc0 A side (the 256
    # stats rows of the activations, 16384 wide).  No one PyTorch call
    # computes it.
    def lcase(b, p, d, w):
        s, lam = inv_diag(b, w)
        return (rnd(b, p, d), orth(b, d, w), s, 1.0 / lam)

    record("lowrank_apply", csrc + "lowrank_apply.cu",
           "src/repro/kernels/lowrank_apply.py:61",
           [lcase(1, 2048, 16384, 486), lcase(3, 512, 4608, 486),
            lcase(1, 256, 16384, 486)],
           la.lowrank_apply_batched,
           lambda X, U, s, il: ref.lowrank_apply(X, U, s, 1.0 / il), None,
           lambda X, U, s, il: (4 * X.numel() * U.shape[2],
                                F * (2 * X.numel() + U.numel() + s.numel()
                                     + il.numel())))
    # the left application hands ops.lowrank_apply a transposed view of
    # fc0's (16384, 2048) J U_G; ops._flat copies it to contiguous rows
    Jt = rnd(1, 16384, 2048).mT
    emit({"phase": "kernels", "name": "lowrank_apply_operand_copy",
          "shape": list(Jt.shape), "ms": time_ms(lambda: Jt.contiguous()),
          "bound_ms": bound_ms(0, 2 * F * Jt.numel())[0]})

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


def phase_agree(variant: str = "bkfac", linear_taps=()):
    """Small VGG: kernel route on the card vs plain route on the CPU, for
    one variant (nskfac: fc0's 4096-wide A side is a gated BRAND factor
    beside an NS G side, so lowrank_apply and the NS kernel both run) and
    optionally with Alg-8 linear-apply taps."""
    import dataclasses
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
        policy=policy_lib.PolicyConfig(variant=variant, r=16,
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
        taps = {n: dataclasses.replace(t, linear_apply=n in linear_taps)
                for n, t in taps.items()}
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
        raise AssertionError(f"agree {variant} {linear_taps}: card {a} vs "
                             f"cpu {b} (rel {err:.3g})")
    emit({"phase": "agree", "variant": variant,
          "linear_apply_taps": list(linear_taps), "losses_cuda": a.tolist(),
          "losses_cpu": b.tolist(), "max_rel_err": err, "tol_rel": 1e-3})


#: (stack, d) of the Brand buckets of a B-KFAC light step on the paper's
#: VGG16_bn (a bucket runs the Brand update when d > r + n_stat = 486);
#: fc0's (1, 16384) last
BRAND_BUCKETS = ((4, 512), (2, 576), (2, 1152), (2, 2048), (2, 2304),
                 (3, 4608), (1, 16384))

#: (stack, d) of the NS buckets of NS-KFAC on the paper's VGG16_bn
#: (max_dense_dim 4096: every factor with d ≤ 2304 is NS)
NS_BUCKETS = ((1, 10), (1, 27), (2, 64), (2, 128), (2, 256), (4, 512),
              (2, 576), (2, 1152), (2, 2048), (2, 2304))

#: the tensor-core kernels' largest error against a float64 product may be
#: at most this many times the plain fp32 version's (cuBLAS)
F64_RATIO = 4.0

#: kernels each path must launch (the others may stay at 0 there)
PATH_KERNELS = {
    "slice": ("ea_syrk", "ut_a", "a_perp", "syrk_tn", "rinv_apply",
              "precond_panel", "precond_apply"),
    "slice_nskfac": ("ea_syrk", "ns_gemm_update", "lowrank_apply"),
    "slice_linear": ("ea_syrk", "ut_a", "a_perp", "syrk_tn", "rinv_apply",
                     "precond_panel", "precond_apply", "lowrank_apply"),
}


@contextlib.contextmanager
def calls_by_shape():
    """Count the wrapper calls of ea_syrk, ut_a, a_perp, syrk_tn,
    rinv_apply and ns_gemm_update by operand shape (and U's row stride)
    while the block runs; the launch counters are left to the wrappers."""
    from repro_torch.kernels import brand_panel as bp
    from repro_torch.kernels import cholqr as cq
    from repro_torch.kernels import ea_syrk as ea
    from repro_torch.kernels import ns_inverse as ns
    seen = {}

    def counted(mod, fn_name, key):
        fn = getattr(mod, fn_name)

        def wrapper(*args):
            k = f"{fn_name.split('_batched')[0]} {key(*args)}"
            seen[k] = seen.get(k, 0) + 1
            return fn(*args)
        setattr(mod, fn_name, wrapper)
        return fn

    fmt = lambda t: "x".join(map(str, t.shape))
    saved = [
        (ea, "ea_syrk_batched", counted(
            ea, "ea_syrk_batched",
            lambda M, X, keep, coef: f"X {fmt(X)}")),
        (cq, "syrk_tn_batched", counted(
            cq, "syrk_tn_batched", lambda A: f"A {fmt(A)}")),
        (bp, "ut_a_batched", counted(
            bp, "ut_a_batched",
            lambda U, A: f"U {fmt(U)} ld {U.stride(1)} A {fmt(A)}")),
        (bp, "a_perp_batched", counted(
            bp, "a_perp_batched",
            lambda A, U, C: f"U {fmt(U)} ld {U.stride(1)} A {fmt(A)}")),
        (cq, "rinv_apply_batched", counted(
            cq, "rinv_apply_batched",
            lambda A, R: f"A {fmt(A)} B {fmt(R)}")),
        (ns, "gemm_update_batched", counted(
            ns, "gemm_update_batched",
            lambda C, A, B, al, be: f"A {fmt(A)} alpha {al:g}"))]
    try:
        yield seen
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def phase_path(phase: str, optimizer: str, linear_taps=()):
    """One path at full width, 11 steps at batch 128; returns the launch
    counts of that run."""
    import dataclasses
    import torch
    from repro_torch.core import kfac as kfac_lib
    from repro_torch.core import kfactor
    from repro_torch.examples.train_vgg_kfac import build
    from repro_torch.kernels import _build
    from repro_torch.train import loop

    dev = torch.device("cuda")
    steps = 11
    model, opt, stream = build("paper", optimizer, batch=128, device=dev,
                               use_kernels=True)
    if linear_taps:
        taps = {n: dataclasses.replace(t, linear_apply=n in linear_taps)
                for n, t in opt.taps.items()}
        opt = kfac_lib.Kfac(opt.cfg, taps, device=dev)
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
    with calls_by_shape() as by_shape:
        state, losses = loop.run_kfac_training(
            model.loss, opt, model.params(), batches, n_tokens=128, seed=0,
            callback=cb, device=dev)
    counts = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if not all(map(lambda v: v == v and abs(v) < float("inf"), losses)):
        raise AssertionError(f"{phase}: non-finite loss {losses}")
    # NS refreshes: the final residual ‖I − M̂X‖_F and λ̂ of every NS
    # factor (a slot at or above _NS_RES_MAX took the LU inverse instead)
    ns_aux = {f"{name}.{side}": getattr(state.opt.factors[name], side).aux
              for name in sorted(opt.taps) for side in "AG"
              if opt.specs[name][side].mode is kfactor.Mode.NS}
    ns_res = {k: float(a[..., kfactor.AUX_RES].max())
              for k, a in ns_aux.items()}
    missing = [k for k in PATH_KERNELS[phase] if counts[k] == 0]
    if missing:
        raise AssertionError(f"{phase}: kernels never launched: {missing}")
    for k in range(steps):
        emit({"phase": phase, "step": k, "kind": kinds[k],
              "loss": losses[k], "wall_s": walls[k]})
    by_kind = {}
    for kind, w in zip(kinds, walls):
        by_kind.setdefault(kind, []).append(w)
    emit({"phase": phase, "summary": True, "optimizer": optimizer,
          "linear_apply_taps": list(linear_taps), "params": n_params,
          "steps": steps, "kinds": kinds,
          "wall_s_by_kind": {k: v for k, v in by_kind.items()},
          "peak_mem_bytes": peak, "launches": counts,
          "calls_by_shape": by_shape,
          "buckets": [f"d={b.spec.d} {b.spec.mode.value} B={b.total}"
                      for b in opt.factor_buckets]}
         | ({"ns_res_max": max(ns_res.values()),
             "ns_lu_factors": {
                 k: {"res": r,
                     "lam": float(ns_aux[k][..., kfactor.AUX_LAM].max())}
                 for k, r in ns_res.items()
                 if not r < kfactor._NS_RES_MAX}}
            if ns_res else {}))
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
    phase_agree("bkfac")
    phase_agree("nskfac")
    phase_agree("bkfac", linear_taps=("fc0", "fc1"))
    by_path = {"slice": phase_path("slice", "bkfac"),
               "slice_nskfac": phase_path("slice_nskfac", "nskfac"),
               "slice_linear": phase_path("slice_linear", "bkfac",
                                          linear_taps=("fc0", "fc1"))}
    rows = []
    for name, row in kernels.items():
        rows.append({k: row[k] for k in (
            "name", "route", "source", "replaces")} | {
            "launches": sum(c[name] for c in by_path.values()),
            "launches_by_path": {p: c[name] for p, c in by_path.items()}}
            | {k: row[k] for k in (
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
