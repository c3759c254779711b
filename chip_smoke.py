#!/usr/bin/env python3
"""Quickest proof that the PyTorch port starts and is right on one GPU.

    python3 chip_smoke.py                 # every phase, one CUDA card

Phases, run in this order (each prints one JSON line):
  device   card name and power limit (nvidia-smi), torch and CUDA versions
  build    the CUDA kernels built by nvcc for sm_90a from the checkout
  kernels  every kernel body (and cholqr2 as a whole) at the shapes of the
           main path, held against its plain PyTorch version on the card
           (the tensor-core kernels also against float64), timed with CUDA
           events (and from a CUDA graph) beside its bound and one PyTorch
           call; lowrank_apply must take the left application's
           transposed operand without a copy
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
  agree    (async) the small VGG under B-R-KFAC with the async heavy
           pipeline (T_updt = T_brand = 1, T_rsvd = 2, heavy_lag = 1: two
           launches and two landings in 6 steps): card vs CPU, and on the
           card the runner's overlapped landing vs the in-line one
  agree    (baselines) the small VGG under SGD and under SENG (a refresh
           every 2 steps), at the settings of paths 6 and 7: card vs CPU
  slice_brkfac
           path 4: B-R-KFAC on the full-width VGG16_bn, 31 steps (RSVD
           overwrites inline at steps 0 and 25; T_rsvd = 25)
  slice_async
           path 5: the same with the async heavy pipeline (heavy_lag 5,
           overlap=True): the step-25 overwrite launches on a CUDA side
           stream in the runner's worker thread and lands at step 30
  slice_sgd, slice_seng
           paths 6 and 7: the baselines SGD and SENG (T_fim = 5) on the
           same model and batch, 11 steps each; the first 6 steps are
           replayed on the host's CPU and printed beside the card's
  agree_state
           the small VGG under B-KFAC on the card, at the settings of the
           B-KFAC agree phase: health guards on and metrics on (a flush
           every 2 steps) each bit for bit the plain run; a checkpoint
           after 3 steps restored into a fresh state continues as the
           uninterrupted run, and restored on the CPU continues within
           the agree tolerance
  slice_resilient
           path 8: B-KFAC on the full-width VGG16_bn (the settings of
           ``slice``) through run_kfac_training with all four specs —
           telemetry (events, metrics every 5 steps), checkpoints every 5
           steps, health guards and chaos — 16 healthy steps with steps
           4–6 profiled (the first traced breakdown of a step), the
           step-15 snapshot truncated on disk; a resume from step 10
           against steps 11–15; then six NaN batches drive the ladder
           (skip, damping escalation, forced refresh, a rollback that
           walks past the truncated snapshot to step 10) and five healthy
           steps recover
  agree_lm the LM stack's ten architectures at their reduced configs
           (B = 2, T = 32): weights made on the CPU, then forward logits,
           loss, every tap's act and probe gradient and two B-KFAC steps on
           the card (kernels) against the CPU (plain versions); 8 decoded
           tokens against the forward for gemma3, mamba2, recurrentgemma
  slice_lm path 9: gemma3-4b at full width (d_model 2560, 8 × 256 heads,
           4 KV heads, d_ff 10240, vocab 262144, bf16 activations), cut
           from 34 to 16 layers, batch 4 × 2048 from TokenStream(seed=0),
           11 B-KFAC steps at examples/train_lm_kfac.py's settings (every
           factor a Brand one: light on even steps, idle on odd), every
           kernel call at a shape the ``kernels`` phase held; then a 64-token
           prompt and 16 greedy tokens decoded against the forward
  agree_serve
           gemma3's reduced config under the multi-tenant TenantService,
           two tenants, run_load's traffic (2 waves of 2 requests and 4
           fine-tunes): the card (kernels) against the CPU (plain
           versions) from the same weights — greedy tokens equal, losses
           and each parameter's change within 1e-3; then stacked
           TenantBank updates at N = 1, 2 and 4 tenants, whose kernel
           launches must be equal (two optimizer configs, three steps)
  slice_serve
           path 10: two gemma3-4b tenants at full width, cut from 34 to 10
           layers, in one TenantService: B-KFAC fine-tuning at
           serve/load.py's cadence (r 256: every factor a Brand one, the
           tenant axis joined to each bucket's batch) and continuous-
           batching decode under each request's tenant, through
           run_load's traffic with 2 waves; every kernel call at a shape
           the ``kernels`` phase held; wall time per tick by kind, kernel
           launches per bank update, p50/p99, steps, memory
  agree_launch
           the trainer CLI (``repro_torch.launch.train``) at --reduced
           --compress on gemma3's reduced config with a vocabulary of 1024
           (so the rank-8 compression acts on the embedding and head), 1
           and 4 steps, card against CPU from the same weights and
           batches, the CPU run's spectrum-continuation shifts replayed on
           the card (where the card's own part is printed): the losses,
           the compressed gradients, every parameter's change after one
           step; one call of each step builder (build_train_step,
           build_prefill_step, build_decode_step) at the reduced config,
           card against CPU
  slice_launch
           path 11: the trainer CLI at gemma3-4b's full width with its
           defaults (batch 4 × 64, default_kfac_config: every factor
           BRAND, use_kernels=False as in the reference's CLI, so no
           kernel launches) and --compress --telemetry-dir, cut from 34 to
           22 layers, 6 steps; wall time a step by kind, compression's
           seconds a step, memory; then one build_train_step step at the
           same cut, build_prefill_step at 1 × 2048 and build_decode_step
           held to a prefill of the same tokens
  launch_reduced
           the CLI's other branches on the card at --reduced: B-R-KFAC
           with health guards, checkpoints every 2 steps and the async
           pipeline (lag 2) on its side stream, 12 steps, then a rerun
           that resumes from the step-10 snapshot, held to an
           uninterrupted run; its EA-absorb and CholeskyQR2 calls at
           shapes the ``kernels`` phase held
  agree_dist
           the distributed curvature engine: (a) the small VGG under
           B-R-KFAC with the engine on a one-member ``nccl`` mesh in this
           process against the same run without it; then four ranks of
           this card (processes of this script, ``gloo``): (b) the CPU
           tests' tap set on (4,) and a (2, 2) curv × rows mesh —
           synchronous, async at lag 0 and 2 — each against the same
           case in one process at 1e-3, the rank-8 compressed gather
           within its reference bound of the raw one, the small VGG at
           1e-3; (c) the CLI at --reduced --mesh 2x2 --mesh-axes
           data,curv against --mesh none in this process at 1e-4
  slice_dist
           path 12, on the same four ranks: slice_brkfac's full-width
           VGG16_bn, weights, batches and 31 steps through
           run_kfac_training(dist=…), slots on curv, dense-M rows on
           rows; wall time and gather seconds a step per rank, held M
           bytes against m_bytes(), launches and calls by shape (each at
           a shape the ``kernels`` phase held); then the same steps
           replayed, each step's update and new state (M, U·D·Uᵀ, aux,
           momentum) held at 1e-3 to the one-process optimizer's from
           the same gathered state; the free-running losses held to
           slice_brkfac's at 1e-3 over steps 0-3, and later to 10 times
           the drift of a witness: slice_brkfac again in this process
           from weights one ulp apart (rounding alone parts runs at this
           width)
Each path is driven with every launch count reset just before and read
just after (lowrank_apply's shapes there must be ones the ``kernels``
phase checked; on paths 4, 5, 8, 9, 10, 11, 12 and launch_reduced every
kernel's); then a ``seconds`` line (each phase's wall seconds), the
``kernels`` line (launches summed over the paths) and, last, the ``ok``
line.  Any failure
raises: the script exits nonzero and prints no ``ok`` line.  It has no CPU
path.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import subprocess
import sys
import threading
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


def bound_ms(flops, nbytes: float, tc_k=0):
    """The least time for ``flops`` fp32 operations and ``nbytes`` of
    traffic on the route a kernel runs on: fp32 FMA, or (``tc_k``, the
    contraction length) the tensor cores at TF32, three products an fp32
    one (3xTF32), four where the contraction is one k-step of
    csrc/tc_gemm.cuh.  A kernel that is a chain of products gives
    ``flops`` and ``tc_k`` as sequences, one entry a product."""
    from repro_torch.kernels import _build
    chain = isinstance(flops, (list, tuple))
    fl = flops if chain else (flops,)
    ks = tc_k if chain else (tc_k,)
    t_ops = (sum((4 if k <= _build.TC_BK else 3) * f
                 for f, k in zip(fl, ks)) / PEAK_TF32_FLOPS if tc_k
             else sum(fl) / PEAK_FP32_FLOPS)
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
    from repro_torch.kernels import ops
    from repro_torch.tools.tc_shapes import LOWRANK_CASES, PRECOND_BUCKETS

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)

    def orth(b, d, w):
        if d < w:
            # a factor's row block of fewer rows than U has columns (the
            # rows of tp_kernels' U): scaled noise of its shape
            return (rnd(b, d, w) / d ** 0.5).contiguous()
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

    def columns(args):
        """Positions of the operands passed by columns (a transposed view
        of a tensor with contiguous rows)."""
        return [i for i, x in enumerate(a for a in args
                                        if isinstance(a, torch.Tensor))
                if x.dim() >= 2 and la.columns(x)]

    def record(name, source, replaces, cases, kernel, plain, library, fl_by,
               tol=TOL, bitwise=False, graph=False, exact=None, tc_k=None):
        """Check each case against the plain version (and, with
        ``bitwise``, that a second launch gives the same bits; with
        ``exact``, the float64 result, that the kernel's largest error
        against it is at most F64_RATIO times the plain version's), then
        time it (with ``graph``, also the device time of the kernel and
        of the library call if any, replayed from a CUDA graph); the
        row's own numbers are the first case's.  A case is its arguments
        or a function that makes them: those are made when their turn
        comes and dropped after it, so the largest paths' cases are not
        all held at once.  A row with ``tc_k`` (the contraction length of
        a case, or one a product of a chain) runs on the tensor cores:
        its bound is the TF32 route's, and each case also prints the
        fp32-FMA bound."""
        worst = 0.0
        worst_abs = 0.0
        f64 = []
        timed = []
        keys = set()
        for case in cases:
            args = case() if callable(case) else case
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
            fl, nb = fl_by(*args)
            if exact is not None:
                # a case of more than GRAPH_BIG_BYTES is held to float64
                # on its first stack element (each element is its own
                # product): its float64 copies would not fit beside it
                one = nb > GRAPH_BIG_BYTES
                first = (lambda x: x[:1] if isinstance(x, torch.Tensor)
                         else x) if one else (lambda x: x)
                ref64 = exact(*map(first, args))
                e_k = float((first(got).double() - ref64).abs().max())
                e_p = float((first(want).double() - ref64).abs().max())
                f64.append({"f64_err": e_k, "plain_f64_err": e_p,
                            "f64_ratio": e_k / max(e_p, 1e-300)})
                del ref64
                if not e_k <= F64_RATIO * e_p:
                    raise AssertionError(
                        f"{name}: error against float64 {e_k:.3g} > "
                        f"{F64_RATIO} × the plain version's {e_p:.3g} at "
                        f"shapes {shapes(args)}")
            del got, want, pairs, wants
            bms, by = bound_ms(fl, nb, tc_k=tc_k(*args) if tc_k else 0)
            t = {"shape": shapes(args),
                 **({"columns": columns(args)} if columns(args) else {}),
                 "ms": time_ms(lambda: kernel(*args)),
                 "plain_ms": time_ms(lambda: plain(*args)),
                 "library_ms": (time_ms(lambda: library(*args))
                                if library is not None else None),
                 "bound_ms": bms, "bound_by": by}
            t["bound_share"] = t["bound_ms"] / t["ms"]
            if tc_k is not None:
                t["bound_fp32_ms"] = bound_ms(fl, nb)[0]
            if f64:
                t.update(f64[-1])
            if t["library_ms"] is not None:
                t["vs_library"] = t["ms"] / t["library_ms"]
            big = nb > GRAPH_BIG_BYTES
            if graph:
                # a graph keeps every call's output in its private pool
                # until it goes: a case that moves gigabytes (slice_lm's)
                # replays two calls, and its pool is released after
                reps = 2 if big else 20
                t["device_ms"] = graph_ms(lambda: kernel(*args), side, reps)
                t["device_bound_share"] = t["bound_ms"] / t["device_ms"]
                if library is not None:
                    t["library_device_ms"] = graph_ms(
                        lambda: library(*args), side, reps)
                    t["vs_library_device"] = (t["device_ms"]
                                              / t["library_device_ms"])
            timed.append(t)
            # the calls_by_shape keys of the cases held here
            keys.add(call_key(name, *args))
            del args
            if big:
                torch.cuda.empty_cache()
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "max_abs_err": worst_abs,
               "max_rel_err": worst, "tol_rel": tol, **timed[0],
               "cases": timed} | ({"bitwise_repeat": True} if bitwise else {})
        if f64:
            row["max_f64_ratio"] = max(c["f64_ratio"] for c in f64)
        emit({"phase": "kernels", **row})
        row["checked"] = keys
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
    # launch_reduced's dense buckets, X (B, d, n_stat = 16)
    launch_dense, launch_panels = launch_kernel_shapes()
    # slice_dist's, per rank: ⌈B/2⌉ slots of each bucket on the curvature
    # axis (the row-sharded buckets absorb outside any kernel)
    dist_dense, dist_brand, dist_panels = dist_kernel_shapes()
    # dp_reduced's, per rank: ⌈B/4⌉ slots of each bucket on the data axis
    dp_dense, dp_panels = dp_kernel_shapes()
    # tp_reduced's, per rank: ⌈B/2⌉ slots on the data axis of (2, 2)
    _, tp_panels = dp_kernel_shapes(TP_REDUCED["data"], TP_REDUCED["steps"])
    # and its M rows' (the absorb's row-block form; the same in its
    # use_kernels step), the Brand passes on the factor rows of its
    # slots, the precondition passes on the tap groups' rows
    tp_rows, tp_brand, tp_precond = tp_kernel_shapes()

    def dense_rows(b, rb, d, n):
        # a rank's rows [rb, 2·rb) of the factor: the second model rank's
        X = rnd(b, d, n)
        return (rnd(b, rb, d), X, X[:, rb:2 * rb]) if rb < d else (
            sym(b, d), X)
    record("ea_syrk", csrc + "ea_syrk.cu", "src/repro/kernels/ea_syrk.py:53",
           [(sym(b, d), rnd(b, d, 256))
            for b, d in ((2, 256),) + tuple(x for x in NS_BUCKETS
                                            if x != (2, 256))]
           + [(sym(b, d), rnd(b, d, n)) for b, d, n in launch_dense]
           + [(sym(b, d), rnd(b, d, n)) for b, d, n in dist_dense]
           + [(sym(b, d), rnd(b, d, n)) for b, d, n in dp_dense]
           + [lambda c=c: dense_rows(*c) for c in tp_rows
              if c[1] < c[2] or (c[0], c[2], c[3]) not in dp_dense],
           lambda M, X, Xr=None: ea.ea_syrk_batched(M, X, keep, coef, Xr),
           lambda M, X, Xr=None: ref.ea_syrk(M, X, 0.95, False, Xr),
           lambda M, X, Xr=None: torch.baddbmm(
               M, X if Xr is None else Xr, X.mT, beta=keep, alpha=coef),
           # X Xᵀ is symmetric: n·d·(d+1) FLOP for one triangle; a row
           # block X_rows Xᵀ is not: 2·rb·d·n
           lambda M, X, Xr=None: (
               X.shape[0] * X.shape[2] * X.shape[1] * (X.shape[1] + 1)
               if Xr is None else 2 * X.shape[0] * M.shape[1] * X.shape[1]
               * X.shape[2], F * (2 * M.numel() + X.numel())),
           bitwise=True, graph=True,
           exact=lambda M, X, Xr=None: (
               keep * M.double() + coef * ((X if Xr is None else Xr).double()
                                           @ X.double().mT)),
           tc_k=lambda M, X, Xr=None: X.shape[2])

    # Brand panel: fc0's bucket (d = 16384, B = 1) and the d = 512, B = 4
    brand = [(orth(1, 16384, 230), rnd(1, 16384, 256)),
             (orth(4, 512, 230), rnd(4, 512, 256))]
    # ut_a at fc0 with a contiguous U, then at every Brand bucket of the
    # path with U as the path passes it: the [..., :230] column slice of
    # the (B, d, 486) state (row stride 486: 8-byte aligned rows)
    ut_a_cases = [brand[0]] + [
        (orth(b, d, 486)[..., :230], rnd(b, d, 256))
        for b, d in BRAND_BUCKETS]
    # slice_lm's Brand buckets (gemma3-4b at full width): U the [..., :r]
    # slice of the (B, d, r + n_stat) state, the stats panel (B, d, n_stat)
    lm_brand, lm_precond, (lm_r, lm_n) = lm_kernel_shapes()
    ut_a_cases += [(orth(b, d, lm_r + lm_n)[..., :lm_r], rnd(b, d, lm_n))
                   for b, d in lm_brand]
    # slice_serve's: the two tenants' Brand buckets widened by the tenant
    # axis, r = 256 of the (B, d, r + n_stat) state, n_stat = 512
    sv_brand, sv_precond, (sv_r, sv_n) = serve_kernel_shapes()
    ut_a_cases += [(orth(b, d, sv_r + sv_n)[..., :sv_r], rnd(b, d, sv_n))
                   for b, d in sv_brand]
    # slice_dist's: each rank's ⌈B/2⌉ slots of a Brand bucket; and
    # tp_kernels': those of tp_reduced's engine, on the factor rows
    ut_a_cases += [(orth(b, d, w)[..., :r], rnd(b, d, n))
                   for b, d, w, r, n in dist_brand + tp_brand]
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
    # the cases of every path held at once would not leave room for the
    # precond cases below: each list goes once its rows are recorded
    del brand, ut_a_cases, perp
    torch.cuda.empty_cache()

    # CholeskyQR2 passes: fc0's A⊥ (1, 16384, 256), every other Brand
    # bucket's (B, d, 256), the step-0 RSVD range finder's (2, 256, 240),
    # and B-R-KFAC's RSVD panels (B, d, 240) of every Brand bucket that
    # holds M (d ≤ 4096), which the async path runs on its side stream
    panels = ([(rnd(1, 16384, 256),)]
              + [(rnd(b, d, 256),) for b, d in BRAND_BUCKETS[:-1]]
              + [(rnd(2, 256, 240),)]
              + [(rnd(b, d, 240),) for b, d in BRAND_BUCKETS if d <= 4096]
              + [(rnd(b, d, lm_n),) for b, d in lm_brand]
              + [(rnd(b, d, sv_n),) for b, d in sv_brand]
              # launch_reduced's RSVD panels (count, d, r + r_o)
              + [(rnd(c, d, k),) for c, d, k in launch_panels]
              # slice_dist's per rank: the A⊥ panels of its ⌈B/2⌉ slots,
              # and its RSVD panels (a heavy range's chunk on each row
              # member)
              + [(rnd(b, d, n),) for b, d, _, _, n in dist_brand]
              + [(rnd(c, d, k),) for c, d, k in dist_panels]
              # dp_reduced's per rank (its local rows of each range)
              + [(rnd(c, d, k),) for c, d, k in dp_panels]
              # tp_reduced's per rank, as dp_reduced's on two members
              + [(rnd(c, d, k),) for c, d, k in tp_panels
                 if (c, d, k) not in dp_panels]
              # tp_kernels' A⊥ panels on the factor rows
              + [(rnd(b, d, n),) for b, d, _, _, n in tp_brand])
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
    del roots
    panels = panels[:1]     # fc0's, for cholqr2 below
    torch.cuda.empty_cache()

    # both precond passes (four 3xTF32 products on the tensor cores) at
    # every precond bucket of B-KFAC, fc0 in parameter layout first (J
    # 16384×2048, w = 486 both sides).  No one PyTorch call computes
    # either pass.
    def pcase(b, p, d, wg, wa):
        s_g, lam_g = inv_diag(b, wg)
        s_a, lam_a = inv_diag(b, wa)
        return (rnd(b, p, d), orth(b, p, wg), s_g, 1.0 / lam_g,
                orth(b, d, wa), s_a, 1.0 / lam_a)

    # each case made at its turn (slice_lm's and slice_serve's are tens of
    # gigabytes together)
    pc = PRECOND_BUCKETS + lm_precond + sv_precond + tuple(tp_precond)

    def panel_case(c):
        J, Ug, sg = pcase(*c)[:3]
        return Ug, J, sg

    def apply_case(c):
        J, Ug, sg, ilg, Ua, sa, ila = pcase(*c)
        return (J, Ug, ref.precond_panel(Ug, J, sg).contiguous(), Ua, sa,
                ilg, ila)

    record("precond_panel", csrc + "precond_fused.cu",
           "src/repro/kernels/precond_fused.py:122",
           [lambda c=c: panel_case(c) for c in pc],
           pf.precond_panel_batched, ref.precond_panel, None,
           lambda Ug, J, sg: (2 * J.numel() * Ug.shape[2],
                              F * (Ug.numel() + J.numel() + sg.numel()
                                   + Ug.shape[0] * Ug.shape[2]
                                   * J.shape[2])),
           bitwise=True, graph=True,
           exact=lambda Ug, J, sg: ((Ug.double().mT @ J.double())
                                    * sg.double()[..., :, None]),
           tc_k=lambda Ug, J, sg: Ug.shape[1])

    def apply_f64(J, Ug, Cg, Ua, sa, ilg, ila):
        W = Ug.double() @ Cg.double() + ilg.double()[:, None, None] * J
        Ua = Ua.double()
        return (((W @ Ua) * sa.double()[:, None, :]) @ Ua.mT
                + ila.double()[:, None, None] * W)

    # the apply is three products: W = U_g Cg (K = w_g), W U_a (K = d),
    # Tw U_aᵀ (K = w_a)
    record("precond_apply", csrc + "precond_fused.cu",
           "src/repro/kernels/precond_fused.py:140",
           [lambda c=c: apply_case(c) for c in pc],
           pf.precond_apply_batched,
           lambda J, Ug, Cg, Ua, sa, ilg, ila: ref.precond_apply(
               J, Ug, Cg, Ua, sa, 1.0 / ilg, 1.0 / ila),
           None,
           lambda J, Ug, Cg, Ua, sa, ilg, ila: (
               (2 * J.numel() * Ug.shape[2], 2 * J.numel() * Ua.shape[2],
                2 * J.numel() * Ua.shape[2]),
               F * (2 * J.numel() + Ug.numel() + Cg.numel() + Ua.numel()
                    + sa.numel() + 2 * ilg.numel())),
           bitwise=True, graph=True, exact=apply_f64,
           tc_k=lambda J, Ug, Cg, Ua, sa, ilg, ila: (
               Ug.shape[2], J.shape[2], Ua.shape[2]))

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

    # lowrank_apply (two 3xTF32 products on the tensor cores) at every
    # launch of the paths (LOWRANK_CASES), each in the path's layout:
    # NS-KFAC's fc0 first (X = (J U_G)ᵀ, the transposed view of a
    # contiguous 16384×2048, w = 486), its conv4 bucket (3 × 512×4608, by
    # columns too), then the Alg-8 taps' stats rows (256 × 16384, 256 ×
    # 2048, 256 × 10 with w = 10).  No one PyTorch call computes it.
    def lcase(b, p, d, w, cols):
        s, lam = inv_diag(b, w)
        X = rnd(b, d, p).mT if cols else rnd(b, p, d)
        return (X, orth(b, d, w), s, 1.0 / lam)

    def lowrank_f64(X, U, s, il):
        X, U = X.double(), U.double()
        return ((X @ U) * s.double()[:, None, :]) @ U.mT + (
            il.double()[:, None, None] * X)

    record("lowrank_apply", csrc + "lowrank_apply.cu",
           "src/repro/kernels/lowrank_apply.py:61",
           [lcase(*c) for c in LOWRANK_CASES],
           la.lowrank_apply_batched,
           lambda X, U, s, il: ref.lowrank_apply(X, U, s, 1.0 / il), None,
           lambda X, U, s, il: ((2 * X.numel() * U.shape[2],
                                 2 * X.numel() * U.shape[2]),
                                F * (2 * X.numel() + U.numel() + s.numel()
                                     + il.numel())),
           bitwise=True, graph=True, exact=lowrank_f64,
           # X U over d, then T Uᵀ (or U C) over w
           tc_k=lambda X, U, s, il: (U.shape[1], U.shape[2]))
    # the left application hands ops.lowrank_apply a transposed view of
    # fc0's (16384, 2048) J U_G: the kernel must read it where it lies and
    # return Y as the transposed view of a contiguous (16384, 2048), with
    # no copy of X on the way (which would take another X's worth of
    # memory beside Y's)
    (Jt, U, s, il) = lcase(*LOWRANK_CASES[0])
    handed = []
    wrapper = la.lowrank_apply_batched

    def spy(X, *rest):
        handed.append(X)
        return wrapper(X, *rest)
    la.lowrank_apply_batched = spy
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        Y = ops.lowrank_apply(Jt, U, s, 1.0 / il)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
    finally:
        la.lowrank_apply_batched = wrapper
    nbytes = F * Jt.numel()
    # (the batch stride of a stack of one is not compared: it is never read)
    if not (len(handed) == 1 and handed[0].data_ptr() == Jt.data_ptr()
            and handed[0].stride()[1:] == Jt.stride()[1:]
            and Y.mT.is_contiguous() and extra < 2 * nbytes):
        raise AssertionError(
            f"lowrank_apply copied its columns operand: strides handed "
            f"{[x.stride() for x in handed]} vs {Jt.stride()}, result "
            f"strides {Y.stride()}, {extra} bytes taken for {nbytes} of X")
    emit({"phase": "kernels", "name": "lowrank_apply_no_copy",
          "shape": list(Jt.shape), "x_strides": list(Jt.stride()),
          "y_strides": list(Y.stride()), "peak_extra_bytes": extra,
          "x_bytes": nbytes})
    del Jt, U, s, il, Y, handed

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


def lm_kernel_shapes():
    """slice_lm's kernel shapes from its optimizer's buckets: the Brand
    buckets (stack, d), the precond buckets (stack, p, d, w_g, w_a) in
    parameter layout (p = d_in, U_g the A side's), and (r, n_stat)."""
    import torch
    _, opt = lm_slice_opt(torch.device("cpu"))
    brand = [(b.total, b.spec.d) for b in opt.factor_buckets]
    spec = opt.factor_buckets[0].spec
    precond = [(b.total, b.spec_a.d, b.spec_g.d, b.spec_a.width,
                b.spec_g.width) for b in opt.precond_buckets]
    return brand, tuple(precond), (spec.r, spec.n_stat)


def serve_kernel_shapes():
    """slice_serve's kernel shapes from its optimizer's buckets, each
    widened by the tenant axis (both tenants step in every fine-tune
    tick of its traffic): as ``lm_kernel_shapes``."""
    import torch
    _, opt = serve_slice_opt(torch.device("cpu"))
    n = SERVE_SLICE["tenants"]
    brand = [(n * b.total, b.spec.d) for b in opt.factor_buckets]
    spec = opt.factor_buckets[0].spec
    precond = [(n * b.total, b.spec_a.d, b.spec_g.d, b.spec_a.width,
                b.spec_g.width) for b in opt.precond_buckets]
    return brand, tuple(precond), (spec.r, spec.n_stat)


def numpy_draws(opt, seed: int):
    """The heavy ops' random inputs made with numpy from (seed, step,
    bucket), so the card and the CPU runs consume the same draws: for
    every bucket that fires a heavy range or launches one."""
    import numpy as np
    import torch
    from repro_torch.core import kfactor

    sched = opt.scheduler()

    def draws(step):
        work, out = sched.work(step), {}
        for bi, b in enumerate(opt.factor_buckets):
            s = b.spec
            if not ((work.heavy[bi] or work.launch[bi])
                    and kfactor.needs_draws(s)):
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


def agree_model(dev):
    """The agree phases' small VGG on ``dev`` from weights made on the CPU
    (seed 3), its taps and six batches (seed 1, batch 16) on ``dev`` →
    (model, taps, batches)."""
    import torch
    from repro_torch.data.synthetic import ImageStream
    from repro_torch.models.cnn import VggConfig, make_vgg

    cfg = VggConfig(stages=(8, 16), fc_hidden=64, n_stat=32)
    cpu = torch.device("cpu")
    batches = [ImageStream(batch=16, seed=1, device=cpu).batch_at(i)
               for i in range(6)]
    weights = {k: v.detach().clone() for k, v in make_vgg(
        cfg, device=cpu, seed=3)[0].params().items()}
    model, taps = make_vgg(cfg, device=dev, seed=3)
    model.load_params({k: v.to(dev) for k, v in weights.items()})
    return model, taps, [(x.to(dev), y.to(dev)) for x, y in batches]


def agree_setup(variant: str, dev, linear_taps=(), **periods):
    """The agree phases' small VGG (``agree_model``) and its optimizer on
    ``dev`` → (model, Kfac, batches)."""
    import dataclasses
    from repro_torch.core import kfac as kfac_lib
    from repro_torch.core import policy as policy_lib
    from repro_torch.optim import base as optbase

    # a step size at which fp32 rounding does not grow from step to step
    # (see tests/test_torch_vgg.py: the spectrum continuation and Adam on
    # pre-batch-norm biases amplify rounding, so both are kept quiet)
    kcfg = kfac_lib.KfacConfig(
        policy=policy_lib.PolicyConfig(variant=variant, r=16,
                                       max_dense_dim=1024),
        lr=optbase.constant(0.03), damping_phi=optbase.constant(0.1),
        clip=0.1, spectrum_continuation=False,
        **({"T_updt": 2, "T_inv": 4, "T_brand": 2, "T_rsvd": 4,
            "T_corct": 4} | periods),
        use_kernels=True, fallback_lr=optbase.constant(1e-3))
    model, taps, batches = agree_model(dev)
    taps = {n: dataclasses.replace(t, linear_apply=n in linear_taps)
            for n, t in taps.items()}
    return model, kfac_lib.Kfac(kcfg, taps, device=dev), batches


def agree_losses(variant: str, dev, linear_taps=(), overlap=False,
                 **periods):
    """Six steps of the small VGG (``agree_setup``, numpy draws seed 5) on
    ``dev`` through ``run_kfac_training`` → (losses, the async runner when
    ``overlap``)."""
    from repro_torch.train import loop
    model, opt, batches = agree_setup(variant, dev, linear_taps, **periods)
    runner = loop.AsyncInverseRunner.for_opt(opt) if overlap else None
    _, losses = loop.run_kfac_training(
        model.loss, opt, model.params(), batches, n_tokens=16,
        seed=0, device=dev, draws=numpy_draws(opt, seed=5),
        overlap=runner or False)
    return losses, runner


def _max_rel(a, b) -> float:
    import numpy as np
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-6)))


def phase_agree(variant: str = "bkfac", linear_taps=()):
    """Small VGG: kernel route on the card vs plain route on the CPU, for
    one variant (nskfac: fc0's 4096-wide A side is a gated BRAND factor
    beside an NS G side, so lowrank_apply and the NS kernel both run) and
    optionally with Alg-8 linear-apply taps."""
    import numpy as np
    import torch
    losses = {dev.type: agree_losses(variant, dev, linear_taps)[0]
              for dev in (torch.device("cpu"), torch.device("cuda"))}
    a, b = np.asarray(losses["cuda"]), np.asarray(losses["cpu"])
    err = _max_rel(a, b)
    # tolerance: the card and the CPU sum in other orders and their eighs
    # and SVDs come from other libraries; over 6 steps that stays < 1e-3
    # (measured 3e-5 at step 6 on an H100; it grows ~10x a step after)
    if not (np.all(np.isfinite(a)) and err < 1e-3):
        raise AssertionError(f"agree {variant} {linear_taps}: card {a} vs "
                             f"cpu {b} (rel {err:.3g})")
    emit({"phase": "agree", "variant": variant,
          "linear_apply_taps": list(linear_taps), "losses_cuda": a.tolist(),
          "losses_cpu": b.tolist(), "max_rel_err": err, "tol_rel": 1e-3})


#: the async agree phase's schedule: light steps every step, an RSVD
#: firing every 2 and a lag of 1, so steps 2 and 4 launch, 3 and 5 land
ASYNC_AGREE = dict(T_updt=1, T_brand=1, T_rsvd=2, async_heavy=True,
                   heavy_lag=1)


def phase_agree_async():
    """Small VGG, B-R-KFAC with the async heavy pipeline: the card's
    overlapped run (the heavy op on the runner's side stream) against the
    CPU's (tolerance 1e-3, as the other agree phases), and on the card
    against the in-line landing (rtol 1e-6 / atol 1e-7, the reference's
    overlapped-landing tolerance); the runner must land every range it
    launched and miss none."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    cuda = torch.device("cuda")
    cpu, _ = agree_losses("brkfac", torch.device("cpu"), **ASYNC_AGREE)
    inline, _ = agree_losses("brkfac", cuda, **ASYNC_AGREE)
    _build.reset_launch_counts()
    over, runner = agree_losses("brkfac", cuda, overlap=True, **ASYNC_AGREE)
    side = {k: v for k, v in _build.side_launch_counts().items() if v}
    err = _max_rel(over, cpu)
    h = runner.health
    ok_lanes = h["launched"] == h["landed"] >= 1 and h["missed"] == 0
    same = bool(np.allclose(over, inline, rtol=1e-6, atol=1e-7))
    emit({"phase": "agree", "variant": "brkfac", "async": ASYNC_AGREE,
          "losses_cuda": over, "losses_cuda_inline": inline,
          "losses_cpu": cpu, "max_rel_err": err, "tol_rel": 1e-3,
          "overlap_vs_inline_max_abs": float(np.max(np.abs(
              np.asarray(over) - np.asarray(inline)))),
          "overlap_equals_inline": same, "runner_health": h,
          "heavy_s": runner.durations, "side_launches": side})
    if not (np.all(np.isfinite(over)) and err < 1e-3 and same and ok_lanes
            and side.get("syrk_tn", 0) > 0):
        raise AssertionError(f"agree async: card {over} vs cpu {cpu} (rel "
                             f"{err:.3g}), in line {inline}, runner {h}, "
                             f"side-stream launches {side}")


#: (stack, d) of the Brand buckets of a B-KFAC light step on the paper's
#: VGG16_bn (a bucket runs the Brand update when d > r + n_stat = 486);
#: fc0's (1, 16384) last
BRAND_BUCKETS = ((4, 512), (2, 576), (2, 1152), (2, 2048), (2, 2304),
                 (3, 4608), (1, 16384))

#: (stack, d) of the NS buckets of NS-KFAC on the paper's VGG16_bn
#: (max_dense_dim 4096: every factor with d ≤ 2304 is NS)
NS_BUCKETS = ((1, 10), (1, 27), (2, 64), (2, 128), (2, 256), (4, 512),
              (2, 576), (2, 1152), (2, 2048), (2, 2304))

#: a kernels-phase case moving more bytes than this is replayed twice, not
#: 20 times, in its CUDA graph (see ``record``)
GRAPH_BIG_BYTES = 1e9

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
    "slice_brkfac": ("ea_syrk", "ut_a", "a_perp", "syrk_tn", "rinv_apply",
                     "precond_panel", "precond_apply"),
    "slice_async": ("ea_syrk", "ut_a", "a_perp", "syrk_tn", "rinv_apply",
                    "precond_panel", "precond_apply"),
    "slice_resilient": ("ea_syrk", "ut_a", "a_perp", "syrk_tn",
                        "rinv_apply", "precond_panel", "precond_apply"),
    # every factor of gemma3-4b at full width is a pure Brand one (d ≥
    # 2048 > r + n_stat): no EA absorb, no heavy op
    "slice_lm": ("ut_a", "a_perp", "syrk_tn", "rinv_apply", "precond_panel",
                 "precond_apply"),
    # the same at the serve path's r = 256 (every factor d ≥ 2048 > 768)
    "slice_serve": ("ut_a", "a_perp", "syrk_tn", "rinv_apply",
                    "precond_panel", "precond_apply"),
    # the trainer CLI at full width: every factor BRAND and, as in the
    # reference's CLI, use_kernels=False (Brand and preconditioning in
    # plain PyTorch): no kernel is launched
    "slice_launch": (),
    # the CLI at --reduced under B-R-KFAC: the EA absorb of its dense M
    # and the RSVD range finder's CholeskyQR2
    "launch_reduced": ("ea_syrk", "syrk_tn", "rinv_apply"),
    # B-R-KFAC on four ranks (slots on curv, M rows on rows): the EA
    # absorb of the one bucket whose d (27) the row axis does not divide
    "slice_dist": ("ea_syrk", "ut_a", "a_perp", "syrk_tn", "rinv_apply",
                   "precond_panel", "precond_apply"),
    # the CLI data-parallel at full width: every factor BRAND under
    # use_kernels=False, as slice_launch
    "slice_dp": (),
    # the CLI data-parallel at --reduced under B-R-KFAC, on every rank
    "dp_reduced": ("ea_syrk", "syrk_tn", "rinv_apply"),
    # the CLI tensor-parallel at full width: BRAND under use_kernels=False
    "slice_tp": (),
    # the CLI tensor-parallel at --reduced under B-R-KFAC, on every rank:
    # the EA absorb of its M rows (every factor's d divides the model
    # axis: ea_syrk's row-block form) and the RSVD range finder's
    # CholeskyQR2 on the gathered M rows
    "tp_reduced": ("ea_syrk", "syrk_tn", "rinv_apply"),
    # tp_reduced's step with use_kernels=True, on every rank: the absorb,
    # the Brand update's passes and the preconditioning's on the factor
    # rows
    "tp_kernels": ("ea_syrk", "ut_a", "a_perp", "syrk_tn", "rinv_apply",
                   "precond_panel", "precond_apply"),
}

#: each path's wall seconds a step by kind (``phase_path``), for the
#: comparisons of later paths
PATH_WALLS = {}

#: each path's per-step losses (``phase_path``): slice_dist is held to
#: slice_brkfac's
PATH_LOSSES = {}


def lowrank_key(b, p, d, w, cols) -> str:
    """calls_by_shape's key of a lowrank_apply launch (after the kernel's
    name): X (b, p, d) by rows or columns, U (b, d, w)."""
    return f"X {b}x{p}x{d} {'columns' if cols else 'rows'} U {b}x{d}x{w}"


def _fmt(t) -> str:
    return "x".join(map(str, t.shape))


def _lowrank_shape_key(X, U, s, il) -> str:
    from repro_torch.kernels import lowrank_apply as la
    return lowrank_key(*X.shape, U.shape[2], la.columns(X))


#: kernel → (module of repro_torch.kernels, wrapper, key of a call from
#: the wrapper's arguments: operand shapes, U's row stride, X's layout)
WRAPPERS = {
    "ea_syrk": ("ea_syrk", "ea_syrk_batched",
                lambda M, X, *_: f"X {_fmt(X)}" + (
                    f" rows {M.shape[1]}" if M.shape[1] != X.shape[1]
                    else "")),
    "syrk_tn": ("cholqr", "syrk_tn_batched", lambda A: f"A {_fmt(A)}"),
    "ut_a": ("brand_panel", "ut_a_batched",
             lambda U, A: f"U {_fmt(U)} ld {U.stride(1)} A {_fmt(A)}"),
    "a_perp": ("brand_panel", "a_perp_batched",
               lambda A, U, C: f"U {_fmt(U)} ld {U.stride(1)} A {_fmt(A)}"),
    "rinv_apply": ("cholqr", "rinv_apply_batched",
                   lambda A, R: f"A {_fmt(A)} B {_fmt(R)}"),
    "ns_gemm_update": ("ns_inverse", "gemm_update_batched",
                       lambda C, A, B, al, be: f"A {_fmt(A)} alpha {al:g}"),
    "precond_panel": ("precond_fused", "precond_panel_batched",
                      lambda Ug, J, sg: f"J {_fmt(J)} U_g {_fmt(Ug)}"),
    "precond_apply": ("precond_fused", "precond_apply_batched",
                      lambda J, Ug, Cg, Ua, *_: f"J {_fmt(J)} U_g "
                                                f"{_fmt(Ug)} U_a {_fmt(Ua)}"),
    "lowrank_apply": ("lowrank_apply", "lowrank_apply_batched",
                      _lowrank_shape_key),
}


def call_key(kernel: str, *args) -> str:
    """calls_by_shape's key of one call of ``kernel``'s wrapper."""
    _, fn_name, key = WRAPPERS[kernel]
    return f"{fn_name.split('_batched')[0]} {key(*args)}"


@contextlib.contextmanager
def calls_by_shape():
    """Count the wrapper calls of every kernel in ``WRAPPERS`` by
    ``call_key`` while the block runs — from any thread: the async
    pipeline's worker calls them too; the launch counters are left to the
    wrappers."""
    import importlib
    seen = {}
    lock = threading.Lock()
    saved = []
    for kernel, (mod_name, fn_name, _) in WRAPPERS.items():
        mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
        fn = getattr(mod, fn_name)

        def wrapper(*args, _fn=fn, _kernel=kernel):
            k = call_key(_kernel, *args)
            with lock:
                seen[k] = seen.get(k, 0) + 1
            return _fn(*args)
        setattr(mod, fn_name, wrapper)
        saved.append((mod, fn_name, fn))
    try:
        yield seen
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def step_kind(work) -> str:
    """A step's kind: StepWork.label, with a landing without an inline
    heavy range told apart as ``land``."""
    return ("land" if any(work.land) and not work.any_heavy
            else work.label)


def phase_path(phase: str, optimizer: str, linear_taps=(), steps: int = 11,
               lag=None, checked=None):
    """One path at full width at batch 128, ``steps`` steps; returns the
    launch counts of that run.  ``lag`` (an int) turns on the async heavy
    pipeline with that heavy_lag and runs it through an
    ``AsyncInverseRunner`` (the heavy op on a CUDA side stream); the
    runner must land every range it launched, miss none, and launch
    CholeskyQR2 kernels from the side stream.  With ``checked`` (the call
    keys the ``kernels`` phase held), every kernel call of the path must
    be at one of them; otherwise only lowrank_apply's are checked."""
    import dataclasses
    import torch
    from repro_torch.core import kfac as kfac_lib
    from repro_torch.core import kfactor
    from repro_torch.examples.train_vgg_kfac import build
    from repro_torch.kernels import _build
    from repro_torch.tools.tc_shapes import LOWRANK_CASES
    from repro_torch.train import loop

    dev = torch.device("cuda")
    model, opt, stream = build("paper", optimizer, batch=128, device=dev,
                               use_kernels=True)
    if linear_taps or lag is not None:
        taps = {n: dataclasses.replace(t, linear_apply=n in linear_taps)
                for n, t in opt.taps.items()}
        cfg = opt.cfg if lag is None else dataclasses.replace(
            opt.cfg, async_heavy=True, heavy_lag=lag)
        opt = kfac_lib.Kfac(cfg, taps, device=dev)
    batches = [stream.batch_at(i) for i in range(steps)]
    sched = opt.scheduler()
    kinds = [step_kind(sched.work(k)) for k in range(steps)]
    n_params = sum(p.numel() for p in model.params().values())
    runner = loop.AsyncInverseRunner.for_opt(opt) if lag is not None \
        else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()   # what earlier phases left
    walls = []
    t_prev = [time.perf_counter()]

    def cb(k, state, loss):
        # the training stream only: the runner's side stream runs on
        torch.cuda.current_stream().synchronize()
        now = time.perf_counter()
        walls.append(now - t_prev[0])
        t_prev[0] = now

    _build.reset_launch_counts()
    t_prev[0] = time.perf_counter()
    with calls_by_shape() as by_shape:
        state, losses = loop.run_kfac_training(
            model.loss, opt, model.params(), batches, n_tokens=128, seed=0,
            callback=cb, device=dev, overlap=runner or False)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    side_counts = {k: v for k, v in _build.side_launch_counts().items()
                   if v}
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
    if checked is None:
        checked = {"lowrank_apply " + lowrank_key(*c) for c in LOWRANK_CASES}
        unchecked = [k for k in by_shape
                     if k.startswith("lowrank_apply ") and k not in checked]
    else:
        unchecked = [k for k in by_shape if k not in checked]
    if unchecked:
        raise AssertionError(f"{phase}: kernels launched at shapes the "
                             f"kernels phase did not check: {unchecked}")
    if runner is not None:
        h = runner.health
        if not (h["launched"] == h["landed"] >= 1 and h["missed"] == 0
                and side_counts.get("syrk_tn", 0) > 0
                and side_counts.get("rinv_apply", 0) > 0):
            raise AssertionError(f"{phase}: runner {h}, side-stream "
                                 f"launches {side_counts}, error "
                                 f"{runner.last_error!r}")
    for k in range(steps):
        emit({"phase": phase, "step": k, "kind": kinds[k],
              "loss": losses[k], "wall_s": walls[k]})
    by_kind = {}
    for kind, w in zip(kinds, walls):
        by_kind.setdefault(kind, []).append(w)
    PATH_WALLS[phase] = by_kind
    PATH_LOSSES[phase] = losses
    emit({"phase": phase, "summary": True, "optimizer": optimizer,
          "linear_apply_taps": list(linear_taps), "params": n_params,
          "steps": steps, "kinds": kinds,
          "wall_s_by_kind": {k: v for k, v in by_kind.items()},
          "peak_mem_bytes": peak, "base_mem_bytes": base,
          "launches": counts,
          "calls_by_shape": by_shape,
          "buckets": [f"d={b.spec.d} {b.spec.mode.value} B={b.total}"
                      for b in opt.factor_buckets]}
         | ({"ns_res_max": max(ns_res.values()),
             "ns_lu_factors": {
                 k: {"res": r,
                     "lam": float(ns_aux[k][..., kfactor.AUX_LAM].max())}
                 for k, r in ns_res.items()
                 if not r < kfactor._NS_RES_MAX}}
            if ns_res else {})
         | ({"heavy_lag": lag, "runner_health": runner.health,
             "runner_heavy_s": runner.durations,
             "side_launches": side_counts,
             "async_buckets": {str(b): n for b, n in
                               opt._async_buckets.items()}}
            if runner is not None else {}))
    return counts


def baseline_run(phase: str, model, taps, batches, dev, n_tokens: int,
                 T_fim: int = 5, before=None):
    """Train ``model`` in place over ``batches`` on ``dev`` with SGD
    (``slice_sgd``: lr 0.05, momentum 0.9, wd 7e-4, as the reference's
    train_quality) through ``make_baseline_step``, or with SENG
    (``slice_seng``: damping 2.0, momentum 0.9, wd 1e-2, fallback lr 3e-3,
    a refresh every ``T_fim`` steps) → (losses, step kinds, wall seconds a
    step); ``before()`` runs once the optimizer state exists."""
    import torch
    from repro_torch.models import layers
    from repro_torch.optim import base as optbase
    from repro_torch.optim import seng as seng_lib
    from repro_torch.optim import sgd as sgd_lib
    from repro_torch.train import loop

    if phase == "slice_sgd":
        opt = sgd_lib.sgd(optbase.constant(0.05), momentum=0.9,
                          weight_decay=7e-4)
        base_step = loop.make_baseline_step(model.loss, opt)
        step = lambda state, batch, k: base_step(state, batch)
        kinds = ["sgd"] * len(batches)
    else:
        opt = seng_lib.Seng(seng_lib.SengConfig(
            lr=optbase.constant(0.05), damping=2.0, momentum=0.9,
            weight_decay=1e-2, T_fim=T_fim,
            fallback_lr=optbase.constant(3e-3)), taps, device=dev)

        def step(state, batch, k):
            probes = layers.make_probes(opt.taps, device=dev)
            loss, acts, gp, gprobe = loop.kfac_grads(
                model.loss, state.params, probes, batch)
            upd, ost = opt.update(gp, state.opt, state.params, acts=acts,
                                  probe_grads=gprobe, n_tokens=n_tokens,
                                  do_fim=opt.cfg.flags(k)["do_fim"])
            optbase.apply_updates(state.params, upd)
            return loop.TrainState(state.params, ost, state.rng), loss
        kinds = ["fim" if opt.cfg.flags(k)["do_fim"] else "cached"
                 for k in range(len(batches))]
    params = model.params()
    state = loop.TrainState(params=params, opt=opt.init(params),
                            rng=torch.Generator(device=dev).manual_seed(0))
    sync = torch.cuda.synchronize if dev.type == "cuda" else lambda: None
    if before is not None:
        before()
    losses, walls = [], []
    for k, batch in enumerate(batches):
        t0 = time.perf_counter()
        state, loss = step(state, batch, k)
        losses.append(float(loss))
        sync()
        walls.append(time.perf_counter() - t0)
    return losses, kinds, walls


def phase_agree_baseline(phase: str):
    """Small VGG (``agree_model``), SGD or SENG at the full-width paths'
    settings, with a refresh every 2 steps for SENG so that both its
    refreshing and its cached steps run: the card's six losses against
    the CPU's, tolerance 1e-3 as the other agree phases."""
    import numpy as np
    import torch
    losses = {}
    for dev in (torch.device("cpu"), torch.device("cuda")):
        model, taps, batches = agree_model(dev)
        losses[dev.type], kinds, _ = baseline_run(
            phase, model, taps, batches, dev, n_tokens=16, T_fim=2)
    a, b = np.asarray(losses["cuda"]), np.asarray(losses["cpu"])
    err = _max_rel(a, b)
    emit({"phase": "agree", "variant": phase, "kinds": kinds,
          "losses_cuda": a.tolist(), "losses_cpu": b.tolist(),
          "max_rel_err": err, "tol_rel": 1e-3})
    if not (np.all(np.isfinite(a)) and err < 1e-3):
        raise AssertionError(f"agree {phase}: card {a} vs cpu {b} (rel "
                             f"{err:.3g})")


#: steps of a full-width baseline path that are replayed on the CPU
WITNESS_STEPS = 6


def phase_baseline(phase: str, steps: int = 11):
    """SGD (``slice_sgd``) or SENG (``slice_seng``, T_fim 5) training the
    full-width VGG16_bn at batch 128 (``baseline_run``); returns the
    launch counts (no kernel: the reference runs these in jnp).  The first
    ``WITNESS_STEPS`` steps are then replayed on the host's CPU from the
    same weights and batches, and both trajectories printed: a witness of
    whether the path's loss at these settings comes from the settings or
    from the card (the agree phases hold the card to the CPU)."""
    import torch
    from repro_torch.examples.train_vgg_kfac import build
    from repro_torch.kernels import _build

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    model, kopt, stream = build("paper", "bkfac", batch=128, device=dev)
    batches = [stream.batch_at(i) for i in range(steps)]
    init = {k: v.detach().to(cpu, copy=True)
            for k, v in model.params().items()}
    mem = {}

    def before():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem["base"] = torch.cuda.memory_allocated()  # earlier phases' too
        _build.reset_launch_counts()

    losses, kinds, walls = baseline_run(phase, model, kopt.taps, batches,
                                        dev, n_tokens=128, before=before)
    counts = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if not all(map(lambda v: v == v and abs(v) < float("inf"), losses)):
        raise AssertionError(f"{phase}: non-finite loss {losses}")
    for k in range(steps):
        emit({"phase": phase, "step": k, "kind": kinds[k],
              "loss": losses[k], "wall_s": walls[k]})
    by_kind = {}
    for kind, w in zip(kinds, walls):
        by_kind.setdefault(kind, []).append(w)
    del model, kopt
    cpu_model, cpu_kopt, _ = build("paper", "bkfac", batch=128, device=cpu)
    cpu_model.load_params(init)
    witness, _, cpu_walls = baseline_run(
        phase, cpu_model, cpu_kopt.taps,
        [(x.to(cpu), y.to(cpu)) for x, y in batches[:WITNESS_STEPS]], cpu,
        n_tokens=128)
    emit({"phase": phase, "summary": True, "steps": steps, "kinds": kinds,
          "wall_s_by_kind": by_kind, "peak_mem_bytes": peak,
          "base_mem_bytes": mem["base"], "launches": counts,
          "cpu_witness": {"losses_cuda": losses[:WITNESS_STEPS],
                          "losses_cpu": witness,
                          "rel_err": [abs(x - y) / max(abs(y), 1e-6)
                                      for x, y in zip(losses, witness)],
                          "cpu_s": sum(cpu_walls)}})
    return counts


def phase_agree_state():
    """Small VGG under B-KFAC at the B-KFAC agree phase's settings, on the
    card: health guards on, then metrics on (a flush every 2 steps), each
    bit for bit the plain run; a checkpoint after 3 of the 6 steps,
    restored into a fresh state, continues with steps 4–6 of the
    uninterrupted run (largest gap printed, and whether it is exactly 0;
    at most 1e-6 relative); the same checkpoint restored on the CPU
    continues within the agree phases' 1e-3."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch import specs
    from repro_torch.obs import events
    from repro_torch.train import checkpoint as ck
    from repro_torch.train import loop

    cuda, cpu = torch.device("cuda"), torch.device("cpu")

    def run(dev, part=slice(None), state=None, **kw):
        model, opt, batches = agree_setup("bkfac", dev)
        st, losses = loop.run_kfac_training(
            model.loss, opt, None if state is not None else model.params(),
            batches[part], n_tokens=16, seed=0, device=dev,
            draws=numpy_draws(opt, seed=5), state=state, **kw)
        return st, losses

    def same(a, b):
        (sa, la), (sb, lb) = a, b
        return la == lb and all(torch.equal(sa.params[k], sb.params[k])
                                for k in sa.params)

    def template(dev, with_rng=True):
        model, opt, _ = agree_setup("bkfac", dev)
        params = model.params()
        if not with_rng:
            return {"params": params, "opt": opt.init(params)}
        return loop.TrainState(params=params, opt=opt.init(params),
                               rng=torch.Generator(device=dev))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_state_") as tmp:
        off = run(cuda)
        health_on = run(cuda, resilience=specs.ResilienceSpec(health=True))
        path = f"{tmp}/events.jsonl"
        with events.TelemetryWriter(path, console=False) as w:
            metrics_on = run(cuda, obs=specs.ObsSpec(writer=w,
                                                     metrics_every=2))
        windows = [e["window_steps"] for e in events.read_events(path)
                   if e["type"] == "metrics"]
        mid, head = run(cuda, slice(0, 3))
        ck.save(tmp, 3, mid)
        restored, _ = ck.restore(tmp, template(cuda), step=3)
        _, tail = run(cuda, slice(3, 6), state=restored)
        got, _ = ck.restore(tmp, template(cpu, with_rng=False), step=3)
        _, tail_cpu = run(cpu, slice(3, 6), state=loop.TrainState(
            params=got["params"], opt=got["opt"],
            rng=torch.Generator(device=cpu)))
    a, b = np.asarray(tail), np.asarray(off[1][3:])
    gap = float(np.max(np.abs(a - b)))
    err_cpu = _max_rel(tail_cpu, tail)
    ok = {"health_on_bitwise": same(health_on, off),
          "metrics_on_bitwise": same(metrics_on, off),
          "metrics_windows_ok": windows == [2, 2, 2],
          "resume": head == off[1][:3] and _max_rel(a, b) <= 1e-6,
          "cpu_continues": bool(np.all(np.isfinite(tail_cpu)))
          and err_cpu < 1e-3}
    emit({"phase": "agree_state", "variant": "bkfac",
          "losses_cuda": off[1], "losses_resumed": tail,
          "losses_resumed_cpu": tail_cpu, "resume_max_abs_gap": gap,
          "resume_exact": gap == 0.0, "cpu_vs_cuda_max_rel_err": err_cpu,
          "tol_rel": 1e-3, "metrics_windows": windows} | ok)
    if not all(ok.values()):
        raise AssertionError(f"agree_state: {ok}")


#: names of the port's profiler ranges (they also show on the device's
#: timeline as annotations, which are not device work)
_SPAN_PREFIXES = ("kfac/", "async/", "ProfilerStep")


def _profile_breakdown(prof) -> dict:
    """One profiled step (a StepProfiler window).  Device work is every
    device event that is not a range annotation: kernels (those of
    ``libkfac_kernels.so`` too, which no PyTorch op launches), copies and
    sets.  For each kfac/* span: the device time of the work that ran
    inside the span's range on the device's timeline, that range's length,
    and the span's host time; then the ten device ops that took the most
    device time, the device time of all of them, and the share of it in
    the port's own kernels."""
    from torch.autograd import DeviceType
    evs = prof.events()
    dev = [e for e in evs if e.device_type == DeviceType.CUDA]
    work = [e for e in dev if not e.name.startswith(_SPAN_PREFIXES)]
    ranges = [e for e in dev if e.name.startswith("kfac/")]
    spans, extent, host, ops = {}, {}, {}, {}
    for e in evs:
        if e.device_type == DeviceType.CPU and e.name.startswith("kfac/"):
            host[e.name] = host.get(e.name, 0.0) + e.cpu_time_total / 1e3
    for r in ranges:
        lo, hi = r.time_range.start, r.time_range.end
        inside = sum(w.time_range.elapsed_us() for w in work
                     if w.time_range.start >= lo and w.time_range.end <= hi)
        spans[r.name] = spans.get(r.name, 0.0) + inside / 1e3
        extent[r.name] = extent.get(r.name, 0.0) + (hi - lo) / 1e3
    for w in work:
        n, t = ops.get(w.name, (0, 0.0))
        ops[w.name] = (n + 1, t + w.time_range.elapsed_us() / 1e3)
    top = sorted(ops.items(), key=lambda kv: -kv[1][1])[:10]
    own = [t for name, (_, t) in ops.items()
           if "tc_gemm_kernel" in name or "gemm_pipe_kernel" in name]
    return {"span_device_ms": dict(sorted(spans.items())),
            "span_range_ms": dict(sorted(extent.items())),
            "span_host_ms": dict(sorted(host.items())),
            "device_ms": sum(t for _, t in ops.values()),
            "own_kernels": {"launches": sum(
                c for name, (c, _) in ops.items()
                if "tc_gemm_kernel" in name or "gemm_pipe_kernel" in name),
                "ms": sum(own)},
            "top_device_ops": [{"name": n[:120], "calls": c, "ms": t}
                               for n, (c, t) in top]}


def phase_resilient(checked, steps: int = 16, faulty: int = 6,
                    recover: int = 5):
    """Path 8: B-KFAC on the full-width VGG16_bn through run_kfac_training
    with telemetry (an event log, metrics every 5 steps), checkpoints
    every 5 steps (keep 3), health guards and chaos.  ``steps`` healthy
    steps (saves at 0, 5, 10, 15; the step-15 snapshot truncated on disk
    right after its save; steps 4–6 profiled, one window a step, and
    timed apart), a resume from the step-10 snapshot against steps
    11–15, then ``faulty`` NaN batches (skip, escalation, forced refresh,
    and a rollback that must walk past step 15 to step 10) and
    ``recover`` healthy steps.  Every kernel call at a shape the
    ``kernels`` phase checked; returns the launch counts."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch import specs
    from repro_torch.examples.train_vgg_kfac import build
    from repro_torch.kernels import _build
    from repro_torch.obs import events, summary, trace
    from repro_torch.train import checkpoint as ck
    from repro_torch.train import health, loop
    from repro_torch.train.chaos import ChaosMonkey, Fault

    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_resilient_")
    ckpt_dir, ev_path = f"{tmp}/ckpt", f"{tmp}/events.jsonl"
    prof = trace.StepProfiler(f"{tmp}/trace", first=4, steps=3)
    timed = {"save": [], "restore": [], "prune": []}
    orig = {"save": ck.save, "restore": ck.restore, "prune": ck.prune}

    def timer(name):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ok = False
            try:
                out = orig[name](*a, **kw)
                ok = True
                return out
            finally:
                timed[name].append({
                    "step": (a[1] if name == "save" else kw.get("step")
                             if name == "restore" else None),
                    "ok": ok, "s": time.perf_counter() - t0})
        return wrapper

    def clock(walls, profiler=None, hook=None):
        t_prev = [time.perf_counter()]

        def cb(k, state, loss):
            torch.cuda.current_stream().synchronize()
            walls.append(time.perf_counter() - t_prev[0])
            if hook is not None:
                hook(k, state)
            if profiler is not None:
                profiler.tick(k + 1)
            t_prev[0] = time.perf_counter()
        return cb, t_prev

    model, opt, stream = build("paper", "bkfac", batch=128, device=dev,
                               use_kernels=True)
    n_all = steps + faulty + recover
    batches = [stream.batch_at(i) for i in range(n_all)]
    sched = opt.scheduler()
    kinds1 = [step_kind(sched.work(k)) for k in range(steps)]
    walls1, walls2, walls3 = [], [], []
    ck.save, ck.restore, ck.prune = (timer("save"), timer("restore"),
                                     timer("prune"))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _build.reset_launch_counts()
        with calls_by_shape() as by_shape, \
                events.TelemetryWriter(ev_path, console=False) as writer:
            obs = specs.ObsSpec(writer=writer, metrics_every=5)
            ckpt = specs.CkptSpec(dir=ckpt_dir, every=5, keep=3)
            # 1) healthy steps, the last snapshot torn on disk
            chaos1 = ChaosMonkey((Fault(steps - 1, "truncate_ckpt"),))
            cb, t_prev = clock(walls1, prof)
            t_prev[0] = time.perf_counter()
            state, losses1 = loop.run_kfac_training(
                model.loss, opt, model.params(), batches[:steps],
                n_tokens=128, seed=0, callback=cb, device=dev, obs=obs,
                ckpt=ckpt, resilience=specs.ResilienceSpec(
                    health=True, chaos=chaos1))
            prof.close()
            n_saves1 = len(timed["save"])
            # 2) resume: the step-10 snapshot into a fresh template
            model2, opt2, _ = build("paper", "bkfac", batch=128, device=dev,
                                    use_kernels=True)
            p2 = model2.params()
            restored, _ = ck.restore(ckpt_dir, loop.TrainState(
                params=p2, opt=opt2.init(p2),
                rng=torch.Generator(device=dev)), step=10)
            del p2
            cb, t_prev = clock(walls2)
            t_prev[0] = time.perf_counter()
            _, losses2 = loop.run_kfac_training(
                model2.loss, opt2, None, batches[11:steps], n_tokens=128,
                callback=cb, device=dev, state=restored)
            del model2, opt2, restored
            # 3) NaN batches through the ladder, then recovery
            policy = health.RemediationPolicy(writer=writer)
            before = {k: p.detach().clone() for k, p in state.params.items()}
            first_skip = {}

            def hook(k, st):
                if k == 0:
                    first_skip["params_equal"] = all(
                        torch.equal(p, before[n])
                        for n, p in st.params.items())
            chaos3 = ChaosMonkey(tuple(Fault(k, "nan_grad")
                                       for k in range(faulty)))
            cb, t_prev = clock(walls3, hook=hook)
            t_prev[0] = time.perf_counter()
            state, losses3 = loop.run_kfac_training(
                model.loss, opt, None, batches[steps:], n_tokens=128,
                callback=cb, device=dev, state=state, obs=obs, ckpt=ckpt,
                resilience=specs.ResilienceSpec(policy=policy,
                                                chaos=chaos3))
            del before
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        with np.load(f"{ckpt_dir}/step_{10:09d}/arrays.npz") as z:
            n_bytes = sum(z[k].nbytes for k in z.files)
        valid = summary.main([ev_path, "--validate"]) == 0
        evs = list(events.read_events(ev_path))
        report = summary.summarize(ev_path)
        breakdown = {k: _profile_breakdown(p) for k, p in
                     prof.windows.items()}
    finally:
        ck.save, ck.restore, ck.prune = (orig["save"], orig["restore"],
                                         orig["prune"])
        shutil.rmtree(tmp, ignore_errors=True)

    steps3 = [e for e in evs if e["type"] == "step"][-len(losses3):]
    kinds3 = [e["phase"] for e in steps3]
    ladder = [(e["step"], e["action"]) for e in evs
              if e["type"] == "remediation"]
    restores = [e for e in evs if e["type"] == "ckpt_restore"]
    trips = sum(e["values"]["health/guard_trips"] for e in evs
                if e["type"] == "metrics")
    resume_gap = float(np.max(np.abs(np.asarray(losses2)
                                     - np.asarray(losses1[11:]))))
    # a step that saved a checkpoint is timed without the save and the
    # prune after it (run 1 prunes after each save)
    saves1 = {e["step"]: e["s"] + p["s"] for e, p in zip(
        timed["save"][:n_saves1], timed["prune"][:n_saves1])}
    steady = [w - saves1.get(k, 0.0) for k, w in enumerate(walls1)]
    for k in range(steps):
        emit({"phase": "slice_resilient", "run": "healthy", "step": k,
              "kind": kinds1[k], "loss": losses1[k], "wall_s": walls1[k],
              "wall_s_less_ckpt": steady[k],
              "profiled": k in prof.windows})
    for k in range(len(losses3)):
        emit({"phase": "slice_resilient", "run": "faults", "step": k,
              "kind": kinds3[k], "loss": losses3[k], "wall_s": walls3[k]})
    # steady steps: neither profiled nor the one whose snapshot chaos
    # truncates on disk (timed apart)
    apart = set(prof.windows) | {steps - 1}
    by_kind = {}
    for k, (kind, w) in enumerate(zip(kinds1, steady)):
        if k not in apart:
            by_kind.setdefault(kind, []).append(w)
    slice_walls = PATH_WALLS.get("slice", {})
    actions = [a for _, a in ladder]
    order = [actions.index(a) for a in ("skip", "escalate", "refresh",
                                        "rollback", "restored")
             if a in actions]
    ok = {
        "finite_healthy": bool(np.all(np.isfinite(losses1))),
        "resume_matches": _max_rel(losses2, losses1[11:]) <= 1e-4,
        "truncated": chaos1.summary() == {"truncate_ckpt": 1},
        "skip_keeps_params": first_skip.get("params_equal") is True,
        "nan_steps_skipped": bool(np.all(np.isnan(losses3[:faulty]))),
        "recovered": bool(np.all(np.isfinite(losses3[faulty:]))),
        "ladder": ([actions.count(a) for a in (
            "skip", "escalate", "refresh", "rollback", "restored",
            "deescalate")] == [faulty, 2, 1, 1, 1, 1]
            and order == sorted(order) and len(order) == 5),
        "rollback_walked_past": [(e["step"], e.get("skipped_corrupt"))
                                 for e in restores] == [(10, [steps - 1])],
        "guard_trips": trips == faulty,
        "events_valid": valid,
        "damping_back_to_1": policy.damping_scale == 1.0,
    }
    missing = [k for k in PATH_KERNELS["slice_resilient"] if counts[k] == 0]
    unchecked = [k for k in by_shape if k not in checked]
    emit({"phase": "slice_resilient", "summary": True, "steps": steps,
          "kinds": kinds1, "wall_s_by_kind": by_kind,
          "profiled_wall_s": {k: walls1[k] for k in sorted(prof.windows)},
          "truncating_step_wall_s": steady[steps - 1],
          "slice_wall_s_by_kind": slice_walls,
          "overhead_vs_slice": {
              kind: float(np.median(by_kind[kind])
                          / np.median(slice_walls[kind]) - 1.0)
              for kind in ("idle", "light")
              if kind in by_kind and kind in slice_walls},
          "resume_wall_s": walls2, "resume_losses": losses2,
          "resume_max_abs_gap": resume_gap, "resume_exact": resume_gap == 0,
          "faults_kinds": kinds3, "faults_wall_s": walls3,
          "ladder": ladder, "ckpt_restore_events": restores,
          "health_guard_trips": trips, "policy_damping": policy.damping_scale,
          "ckpt_bytes": n_bytes, "ckpt_save_s": timed["save"],
          "ckpt_prune_s": timed["prune"], "ckpt_restore_s": timed["restore"],
          "peak_mem_bytes": peak, "base_mem_bytes": base,
          "launches": counts, "calls_by_shape": by_shape,
          "telemetry_summary": report} | {"checks": ok})
    for k in sorted(breakdown):
        emit({"phase": "slice_resilient", "trace_step": k,
              "kind": kinds1[k], "wall_s": walls1[k]} | breakdown[k])
    if not all(ok.values()) or missing or unchecked:
        raise AssertionError(f"slice_resilient: checks {ok}, kernels never "
                             f"launched {missing}, calls at unchecked shapes "
                             f"{unchecked}")
    return counts


# ---------------------------------------------------------------------------
# the LM stack: agree_lm (all ten architectures, reduced) and slice_lm
# ---------------------------------------------------------------------------

#: agree_lm's batch (the CPU parity tests' B and T)
LM_AGREE_B, LM_AGREE_T = 2, 32
#: decode against forward: the reference's bf16 tolerance
#: (tests/test_arch_smoke.py)
DECODE_TOL = 2e-2
#: slice_lm: gemma3-4b at full width, 34 layers cut to 16 (the first
#: segment, 5 local + 1 global, at 2 repeats of its 5; the 4-local tail
#: kept), batch 4 × 2048 from TokenStream(seed=0), 11 B-KFAC steps at
#: examples/train_lm_kfac.py's settings; remat per repeat (see
#: ``phase_slice_lm``)
LM_SLICE = dict(arch="gemma3_4b", repeats=(2, 1), batch=4, seq=2048,
                steps=11, remat=True, prompt=64, generate=16)


def _lm_batch(arch, dev, seed=0):
    """The CPU parity tests' batch layout for ``arch``, drawn with numpy,
    on ``dev``."""
    import numpy as np
    import torch
    B, T = LM_AGREE_B, LM_AGREE_T
    rs = np.random.default_rng(seed)
    n_tok = T - (arch.n_prefix if arch.frontend == "vision" else 0)
    batch = {"tokens": rs.integers(0, arch.vocab, (B, n_tok)),
             "targets": rs.integers(0, arch.vocab, (B, n_tok))}
    if arch.is_encdec:
        batch["frames"] = (rs.standard_normal((B, T, arch.d_model))
                           * 0.1).astype(np.float32)
        batch["tokens"] = batch["tokens"][:, : T // arch.dec_ratio]
        batch["targets"] = batch["targets"][:, : T // arch.dec_ratio]
    if arch.frontend == "vision":
        batch["embeds"] = (rs.standard_normal((B, arch.n_prefix,
                                               arch.d_model))
                           * 0.1).astype(np.float32)
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def _scale_err(got, want) -> float:
    """``_rel_err``'s relative error of two tensors on any devices."""
    return _rel_err(got.detach().double().cpu(),
                    want.detach().double().cpu())[1]


def _lm_run(name, dev, weights, steps=2):
    """Reduced ``name`` on ``dev`` from ``weights`` (CPU tensors): the
    forward's logits, loss, acts and probe gradients, then ``steps``
    B-KFAC steps (examples/train_lm_kfac.py's settings, the kernels on
    the card) → dict of CPU tensors and the step losses."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.core import kfac as kfac_lib
    from repro_torch.examples.train_lm_kfac import kfac_config
    from repro_torch.models import layers
    from repro_torch.models.lm import LM
    from repro_torch.train import loop

    arch = get_arch(name).reduced()
    lm = LM(arch, remat=False, device=dev)
    fresh = lambda: {k: v.detach().to(dev, copy=True).requires_grad_()
                     for k, v in weights.items()}
    batch = _lm_batch(arch, dev)
    params = fresh()
    probes = layers.make_probes(lm.taps, device=dev)
    with torch.no_grad():
        logits = lm.forward(params, batch, probes, train=True)[0]
    loss, acts, _, gprobe = loop.kfac_grads(lm.loss_fn, params, probes,
                                            batch)
    opt = kfac_lib.Kfac(kfac_config(), lm.taps, device=dev)
    _, losses = loop.run_kfac_training(
        lm.loss_fn, opt, fresh(), [batch] * steps,
        n_tokens=batch["tokens"].numel(), seed=0, device=dev)
    cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}
    return dict(logits=logits.cpu(), loss=loss.cpu(), acts=cpu(acts),
                probe_grads=cpu(gprobe), step_losses=losses,
                opt=opt, lm=lm)


def _decode_vs_forward(lm, params, tokens):
    """Teacher-forced decode of ``tokens`` (B, n) with ``decode_step``
    against ``forward(train=False)`` on the same tokens →
    (largest |Δ| over the forward's largest |logit|, allclose at
    DECODE_TOL, ms a token)."""
    import torch
    with torch.no_grad():
        full = lm.forward(params, {"tokens": tokens, "targets": tokens},
                          train=False)[0]
        cache = lm.init_cache(tokens.shape[0], tokens.shape[1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = []
        for t in range(tokens.shape[1]):
            lg, cache = lm.decode_step(params, cache, tokens[:, t:t + 1], t)
            outs.append(lg[:, 0])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / tokens.shape[1]
        dec = torch.stack(outs, 1)
    ok = bool(torch.allclose(dec.float(), full.float(), atol=DECODE_TOL,
                             rtol=DECODE_TOL))
    return _scale_err(dec.float(), full.float()), ok, ms


def phase_agree_lm():
    """Every architecture at its ``reduced()`` config, B = 2, T = 32:
    weights made on the CPU from a seed, then on the card (kernels) and
    on the CPU (plain versions) — forward logits, loss, every tap's act
    and probe gradient, and two B-KFAC steps' losses — held to the agree
    phases' 1e-3 (of each tensor's largest entry; losses relative); for
    gemma3, mamba2 and recurrentgemma, 8 tokens decoded on the card
    against the card's forward at DECODE_TOL."""
    import torch
    from repro_torch.configs.base import ARCH_NAMES, get_arch
    from repro_torch.kernels import _build
    from repro_torch.models.lm import LM

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    tol = 1e-3
    failed = []
    for name in ARCH_NAMES:
        weights = LM(get_arch(name).reduced(), device=cpu).init(
            torch.Generator().manual_seed(0))
        weights = {k: v.detach() for k, v in weights.items()}
        _build.reset_launch_counts()
        card = _lm_run(name, cuda, weights)
        launches = {k: v for k, v in _build.launch_counts().items() if v}
        host = _lm_run(name, cpu, weights)
        errs = {"logits": _scale_err(card["logits"], host["logits"]),
                "loss": _scale_err(card["loss"], host["loss"]),
                "acts": max(_scale_err(card["acts"][n], host["acts"][n])
                            for n in host["acts"]),
                "probe_grads": max(_scale_err(card["probe_grads"][n],
                                              host["probe_grads"][n])
                                   for n in host["probe_grads"]),
                "step_losses": max(abs(a - b) / max(abs(b), 1e-6)
                                   for a, b in zip(card["step_losses"],
                                                   host["step_losses"]))}
        line = {"phase": "agree_lm", "arch": name, "errors": errs,
                "tol": tol, "losses_cuda": card["step_losses"],
                "losses_cpu": host["step_losses"], "launches": launches,
                "buckets": [f"d={b.spec.d} {b.spec.mode.value} B={b.total}"
                            for b in card["opt"].factor_buckets]}
        bad = [k for k, e in errs.items() if not e <= tol]
        if not launches.get("precond_panel"):
            bad.append("no kernel launched")
        if name in ("gemma3_4b", "mamba2_2p7b", "recurrentgemma_2b"):
            lm = card["lm"]
            params = {k: v.to(cuda) for k, v in weights.items()}
            tokens = torch.randint(0, lm.arch.vocab, (LM_AGREE_B, 8),
                                   generator=torch.Generator().manual_seed(3)
                                   ).to(cuda)
            err, ok, ms = _decode_vs_forward(lm, params, tokens)
            line["decode"] = {"max_err_of_scale": err, "allclose": ok,
                              "tol": DECODE_TOL, "ms_per_token": ms}
            if not ok:
                bad.append("decode")
        emit(line)
        if bad:
            failed.append((name, bad))
    if failed:
        raise AssertionError(f"agree_lm: {failed}")


def lm_slice_arch():
    """gemma3-4b at full width, cut in depth as LM_SLICE says."""
    from repro_torch.configs.base import get_arch
    return get_arch(LM_SLICE["arch"]).with_repeats(LM_SLICE["repeats"])


def lm_slice_opt(dev):
    """slice_lm's model (no weights yet) and optimizer."""
    from repro_torch.core import kfac as kfac_lib
    from repro_torch.examples.train_lm_kfac import kfac_config
    from repro_torch.models.lm import LM
    lm = LM(lm_slice_arch(), remat=LM_SLICE["remat"], device=dev)
    return lm, kfac_lib.Kfac(kfac_config(), lm.taps, device=dev)


def phase_slice_lm(checked):
    """Path 9: gemma3-4b at full width (LM_SLICE), 11 B-KFAC steps through
    ``run_kfac_training`` with the kernels; every kernel call at a shape
    the ``kernels`` phase held; then greedy decoding of a 64-token prompt
    (and 16 generated tokens) on the trained model against its forward:
    with fp32 activations at the reference's 2e-2 (its decode test is
    fp32), and with the configured bf16 ones no farther from the fp32
    forward than twice the bf16 forward is (both printed, with whether
    the bf16 pair meets 2e-2).  Returns the launch counts of the training
    run."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import _build
    from repro_torch.launch.param_count import count_params
    from repro_torch.models.lm import LM
    from repro_torch.train import loop

    dev = torch.device("cuda")
    lm, opt = lm_slice_opt(dev)
    arch = lm.arch
    torch.cuda.synchronize()
    # the earlier phases leave the allocator's cache in pieces; this path's
    # backward takes one 16 GiB block
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()   # what earlier phases left
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.values())
    stream = TokenStream(vocab=arch.vocab, batch=LM_SLICE["batch"],
                         seq_len=LM_SLICE["seq"], seed=0, device=dev)
    batches = [stream.batch_at(k) for k in range(LM_SLICE["steps"])]
    sched = opt.scheduler()
    kinds = [step_kind(sched.work(k)) for k in range(LM_SLICE["steps"])]
    walls = []
    t_prev = [0.0]

    def cb(k, state, loss):
        torch.cuda.synchronize()
        now = time.perf_counter()
        walls.append(now - t_prev[0])
        t_prev[0] = now

    _build.reset_launch_counts()
    t_prev[0] = time.perf_counter()
    with calls_by_shape() as by_shape:
        _, losses = loop.run_kfac_training(
            lm.loss_fn, opt, params, batches,
            n_tokens=LM_SLICE["batch"] * LM_SLICE["seq"], seed=0,
            callback=cb, device=dev)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    del batches
    # decode: the prompt teacher-forced, then greedy tokens, each logit row
    # against the forward over the whole sequence
    prompt = stream.batch_at(LM_SLICE["steps"])["tokens"][:1,
                                                         :LM_SLICE["prompt"]]
    with torch.no_grad():
        cache = lm.init_cache(1, LM_SLICE["prompt"] + LM_SLICE["generate"])
        seq = prompt
        for t in range(LM_SLICE["prompt"] - 1):
            lm.decode_step(params, cache, prompt[:, t:t + 1], t)
        for t in range(LM_SLICE["prompt"] - 1,
                       LM_SLICE["prompt"] + LM_SLICE["generate"] - 1):
            lg, cache = lm.decode_step(params, cache, seq[:, t:t + 1], t)
            seq = torch.cat([seq, lg[:, -1].argmax(-1)[:, None]], dim=1)
    # the configured bf16 activations: decode and forward each round in
    # their own order, so both are also held against the fp32 forward of
    # the same weights; the reference's own decode test (and its 2e-2) is
    # fp32, as this model with fp32 activations
    err, ok, ms = _decode_vs_forward(lm, params, seq)
    lm32 = LM(dataclasses.replace(arch, dtype="float32"), remat=False,
              device=dev)
    err32, ok32, ms32 = _decode_vs_forward(lm32, params, seq)
    with torch.no_grad():
        batch = {"tokens": seq, "targets": seq}
        f32 = lm32.forward(params, batch, train=False)[0]
        f16 = lm.forward(params, batch, train=False)[0].float()
        cache = lm.init_cache(1, seq.shape[1])
        d16 = torch.stack([lm.decode_step(params, cache, seq[:, t:t + 1],
                                          t)[0][:, 0].float()
                           for t in range(seq.shape[1])], 1)
    fwd_vs_f32, dec_vs_f32 = _scale_err(f16, f32), _scale_err(d16, f32)
    # the bf16 decode as close to the fp32 model as twice the bf16
    # forward's own rounding (floored at fp32's: with fp32 activations
    # the two forwards are one)
    near = dec_vs_f32 <= max(2.0 * fwd_vs_f32, 1e-4)
    del params, cache, f32, f16, d16
    missing = [k for k in PATH_KERNELS["slice_lm"] if counts[k] == 0]
    unchecked = [k for k in by_shape if k not in checked]
    for k in range(LM_SLICE["steps"]):
        emit({"phase": "slice_lm", "step": k, "kind": kinds[k],
              "loss": losses[k], "wall_s": walls[k]})
    by_kind = {}
    for kind, w in zip(kinds, walls):
        by_kind.setdefault(kind, []).append(w)
    PATH_WALLS["slice_lm"] = by_kind
    full = get_arch(LM_SLICE["arch"])
    finite = bool(np.all(np.isfinite(losses)))
    emit({"phase": "slice_lm", "summary": True, "arch": arch.name,
          "d_model": arch.d_model, "n_heads": arch.n_heads,
          "n_kv_heads": arch.n_kv_heads, "head_dim": arch.hd,
          "d_ff": arch.d_ff, "vocab": arch.vocab, "dtype": arch.dtype,
          "params": n_params, "params_count": count_params(arch),
          "reduced": {"n_layers": [arch.n_layers, full.n_layers],
                      "repeats": [[s.repeats for s in arch.segments],
                                  [s.repeats for s in full.segments]],
                      "params": [n_params, count_params(full)],
                      "remat": LM_SLICE["remat"]},
          "batch": [LM_SLICE["batch"], LM_SLICE["seq"]],
          "steps": LM_SLICE["steps"], "kinds": kinds, "losses": losses,
          "finite": finite, "wall_s_by_kind": by_kind, "init_s": init_s,
          "peak_mem_bytes": peak, "base_mem_bytes": base,
          "launches": counts, "calls_by_shape": by_shape,
          "buckets": [f"d={b.spec.d} {b.spec.mode.value} B={b.total}"
                      for b in opt.factor_buckets],
          "decode": {"prompt": LM_SLICE["prompt"],
                     "generated": LM_SLICE["generate"], "tol": DECODE_TOL,
                     "fp32": {"max_err_of_scale": err32, "allclose": ok32,
                              "ms_per_token": ms32},
                     "bf16": {"max_err_of_scale": err, "allclose": ok,
                              "ms_per_token": ms,
                              "forward_vs_fp32": fwd_vs_f32,
                              "decode_vs_fp32": dec_vs_f32,
                              "within_2x_forward": near}}})
    if not finite or missing or unchecked or not ok32 or not near:
        raise AssertionError(f"slice_lm: finite {finite}, kernels never "
                             f"launched {missing}, calls at unchecked shapes "
                             f"{unchecked}, fp32 decode allclose {ok32}, bf16 "
                             f"decode vs fp32 {dec_vs_f32:.3g} against the "
                             f"forward's {fwd_vs_f32:.3g}")
    return counts


#: agree_serve: gemma3's reduced config, two tenants, run_load's traffic
#: cut to 2 waves of 2 requests and 4 fine-tunes, 2 ticks apart
AGREE_SERVE = dict(waves=2, infer_per_wave=2, ft_per_wave=4,
                   ticks_between=2, max_len=32)
#: slice_serve: two gemma3-4b tenants at full width, 34 layers cut to 10
#: (the first segment's 5 local + 1 global once, the 4-local tail kept),
#: B-KFAC at serve/load.py's fine-tune cadence, run_load's traffic at its
#: settings with 2 waves (fine-tune batches 2 × 16, prompts of 2–5 tokens,
#: 4 new tokens each, 4 lanes of 48 positions)
SERVE_SLICE = dict(arch="gemma3_4b", repeats=(1, 1), tenants=2, waves=2,
                   infer_per_wave=4, ft_per_wave=4, ticks_between=4,
                   ft_batch=2, ft_seq=16, batch_slots=4, max_len=48)


def _serve_run(dev, weights):
    """agree_serve's service on ``dev`` from ``weights`` (CPU tensors)
    through its traffic → the service."""
    from repro_torch.configs.base import get_arch
    from repro_torch.core import kfac as kfac_lib
    from repro_torch.models.lm import LM
    from repro_torch.serve import load
    from repro_torch.serve.service import TenantService

    arch = get_arch("gemma3_4b").reduced()
    lm = LM(arch, remat=False, device=dev)
    opt = kfac_lib.Kfac(load.finetune_kfac_config(arch), lm.taps,
                        device=dev)
    svc = TenantService(lm, opt, {k: v.to(dev) for k, v in weights.items()},
                        2, max_len=AGREE_SERVE["max_len"], seed=0)
    load.run_load(svc, arch.vocab, seed=0, **{
        k: v for k, v in AGREE_SERVE.items() if k != "max_len"})
    return svc


def _bank_launches(cfg, weights):
    """Kernel launches of each of three stacked bank updates on the card
    at N = 1, 2 and 4 tenants: gemma3's reduced LM under ``cfg``, one
    backward's gradients, acts and probe gradients copied to every
    tenant → {N: [launches of step s]}."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.core import kfac as kfac_lib
    from repro_torch.core import tenant
    from repro_torch.kernels import _build
    from repro_torch.models import layers
    from repro_torch.models.lm import LM
    from repro_torch.train import loop

    dev = torch.device("cuda")
    arch = get_arch("gemma3_4b").reduced()
    lm = LM(arch, remat=False, device=dev)
    opt = kfac_lib.Kfac(cfg, lm.taps, device=dev)
    params = {k: v.to(dev).requires_grad_() for k, v in weights.items()}
    batch = _lm_batch(arch, dev)
    _, acts, gp, gprobe = loop.kfac_grads(
        lm.loss_fn, params, layers.make_probes(lm.taps, device=dev), batch)
    sched = opt.scheduler()
    out = {}
    for n in (1, 2, 4):
        stack = lambda d: tenant.tree_stack([d] * n)
        P, G, A, PG = stack(params), stack(gp), stack(acts), stack(gprobe)
        bank = tenant.TenantBank(opt)
        st = bank.init(P)
        out[n] = []
        for s in range(3):
            _build.reset_launch_counts()
            _, st = bank.update(G, st, P, acts=A, probe_grads=PG,
                                n_tokens=batch["tokens"].numel(),
                                work=sched.work(s))
            torch.cuda.synchronize()
            out[n].append({k: v for k, v in _build.launch_counts().items()
                           if v})
    return out


def phase_agree_serve():
    """gemma3's reduced config under ``TenantService`` with two tenants:
    weights made on the CPU, the same traffic on the card (kernels) and
    on the CPU (plain versions); the greedy tokens must be equal, the
    fine-tune losses within the agree phases' 1e-3 (relative) and each
    parameter's change over the run within 1e-3 of the CPU's change
    (plus 1e-6 of the parameter's scale: the change of a rarely hit
    embedding row is a few fp32 roundings of the weight).  Then the kernel
    launches of stacked bank updates at N = 1, 2 and 4, three steps each,
    under the service's optimizer (every factor EVD at this size) and
    under examples/train_lm_kfac.py's (BRAND buckets too): equal at every
    N."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.examples.train_lm_kfac import kfac_config
    from repro_torch.kernels import _build
    from repro_torch.models.lm import LM
    from repro_torch.serve import load

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    tol = 1e-3
    arch = get_arch("gemma3_4b").reduced()
    weights = {k: v.detach() for k, v in LM(arch, device=cpu).init(
        torch.Generator().manual_seed(0)).items()}
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    card = _serve_run(cuda, weights)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = {k: v for k, v in _build.launch_counts().items() if v}
    t0 = time.perf_counter()
    host = _serve_run(cpu, weights)
    host_s = time.perf_counter() - t0
    loss_err = max(abs(card.completed_ft[u].loss - r.loss)
                   / max(abs(r.loss), 1e-6)
                   for u, r in host.completed_ft.items())
    tokens = {u: r.out_tokens for u, r in host.engine.completed.items()}
    same_tokens = tokens == {u: r.out_tokens
                             for u, r in card.engine.completed.items()}
    change = {}
    for k, w in weights.items():
        d_cpu = (host.params[k] - w).double()
        d_card = (card.params[k].cpu() - w).double()
        change[k] = float((d_card - d_cpu).abs().max()) / (
            float(d_cpu.abs().max()) + 1e-6 * float(w.abs().max()) / tol)
    counts = {name: _bank_launches(cfg, weights) for name, cfg in (
        ("service", load.finetune_kfac_config(arch)),
        ("train_lm_kfac", kfac_config()))}
    equal = {name: all(c[n] == c[1] for n in c)
             for name, c in counts.items()}
    line = {"phase": "agree_serve", "arch": arch.name, "tenants": 2,
            "traffic": AGREE_SERVE, "tol": tol, "loss_err": loss_err,
            "param_change_err": max(change.values()),
            "param_change_err_by_key": {k: v for k, v in change.items()
                                        if v > tol / 10},
            "tokens_equal": same_tokens, "tokens": tokens,
            "steps_cuda": card.steps, "steps_cpu": host.steps,
            "losses_cuda": [card.completed_ft[u].loss
                            for u in sorted(card.completed_ft)],
            "losses_cpu": [host.completed_ft[u].loss
                           for u in sorted(host.completed_ft)],
            "wall_s": {"cuda": card_s, "cpu": host_s},
            "launches": launches,
            "bank_launches_by_n": {name: {str(n): v for n, v in c.items()}
                                   for name, c in counts.items()},
            "bank_launches_equal": equal}
    emit(line)
    bad = []
    if not loss_err <= tol:
        bad.append("losses")
    if not same_tokens or card.steps != host.steps:
        bad.append("tokens or steps")
    if not max(change.values()) <= tol:
        bad.append("params")
    if not all(equal.values()):
        bad.append("launches differ with N")
    if not launches.get("precond_panel"):
        bad.append("no kernel launched")
    if bad:
        raise AssertionError(f"agree_serve: {bad}")


def serve_slice_opt(dev):
    """slice_serve's model (no weights yet) and optimizer."""
    from repro_torch.configs.base import get_arch
    from repro_torch.core import kfac as kfac_lib
    from repro_torch.models.lm import LM
    from repro_torch.serve.load import finetune_kfac_config
    arch = get_arch(SERVE_SLICE["arch"]).with_repeats(SERVE_SLICE["repeats"])
    lm = LM(arch, remat=False, device=dev)
    return lm, kfac_lib.Kfac(finetune_kfac_config(arch), lm.taps,
                             device=dev)


def phase_slice_serve(checked):
    """Path 10: two gemma3-4b tenants at full width (SERVE_SLICE) in one
    ``TenantService``, fine-tuned by B-KFAC through its stacked bank and
    served through its engine, under ``serve/load.py::run_load``'s traffic
    (the same waves, submitted here so each tick is timed): every kernel
    call at a shape the ``kernels`` phase held; every request served, each
    tenant's step advanced by its fine-tunes, finite losses.  Prints each
    tick (kind, wall time, its work groups), each bank update's kernel
    launches, and a summary (wall time by tick kind, p50/p99, steps,
    memory after the build and the peaks).  Returns the launch counts of
    the traffic's run."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import _build
    from repro_torch.launch.param_count import count_params
    from repro_torch.serve import load
    from repro_torch.serve.service import TenantService

    S = SERVE_SLICE
    dev = torch.device("cuda")
    lm, opt = serve_slice_opt(dev)
    arch = lm.arch
    n = S["tenants"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # a fine-tune tick peaks at ~70 GB of the card's 85 (tools/
    # serve_memory.py); the caching allocator's fixed segments then
    # leave ~15 GB in pieces none of the tick's 4 GB blocks fits, and
    # expandable segments do not
    set_allocator = getattr(torch._C, "_accelerator_setAllocatorSettings",
                            None) or torch.cuda.memory._set_allocator_settings
    set_allocator("expandable_segments:True")
    base = torch.cuda.memory_allocated()   # what earlier phases left
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    weights = lm.init(torch.Generator(device=dev).manual_seed(0))
    svc = TenantService(lm, opt, weights, n, ft_batch=S["ft_batch"],
                        ft_seq=S["ft_seq"], batch_slots=S["batch_slots"],
                        max_len=S["max_len"], seed=0)
    del weights
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    held = torch.cuda.memory_allocated()
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    st = svc.state
    held_by = {"params": nbytes(svc.params.values()),
               "fallback_moments": nbytes(list(st.fallback.mu.values())
                                          + list(st.fallback.nu.values())),
               "factor_states": nbytes([x for f in st.factors.values()
                                        for s in (f.A, f.G)
                                        for x in (s.U, s.D, s.M, s.aux)])}
    del st
    # each bank update: its tenants, work and kernel launches
    updates = []
    bank_update = svc.bank.update

    def counted(*a, **kw):
        before = dict(_build.launch_counts())
        t_up = time.perf_counter()
        out = bank_update(*a, **kw)
        torch.cuda.synchronize()
        after = _build.launch_counts()
        updates.append({
            "tenants": [i for i in range(n) if kw["active"][i]],
            "work": kw["work"].label,
            "wall_s": time.perf_counter() - t_up,
            "launches": {k: v - before.get(k, 0) for k, v in after.items()
                         if v - before.get(k, 0)}})
        return out
    svc.bank.update = counted
    ticks = []

    def tick():
        decodes = svc.engine._slots.count(None) < svc.engine.B or \
            not svc.engine._queue.empty()
        seen = len(updates)
        torch.cuda.synchronize()
        t_tick = time.perf_counter()
        svc.tick()
        torch.cuda.synchronize()
        groups = [u["tenants"] for u in updates[seen:]]
        kind = "+".join((["finetune"] if groups else [])
                        + (["decode"] if decodes else [])) or "idle"
        ticks.append({"tick": len(ticks), "kind": kind,
                      "wall_s": time.perf_counter() - t_tick,
                      "groups": groups})

    rng = np.random.default_rng(0)
    uid = 0
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    with calls_by_shape() as by_shape:
        for w in range(S["waves"]):
            reqs, uid = load.traffic(svc, arch.vocab, w, rng,
                                     S["infer_per_wave"], S["ft_per_wave"],
                                     uid)
            for r in reqs:
                svc.submit(r)
            for _ in range(S["ticks_between"]):
                tick()
        while svc.pending() and len(ticks) < 200:
            tick()
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    report = svc.latency_report()
    losses = [{"uid": u, "tenant": r.tenant, "step": r.step, "loss": r.loss}
              for u, r in sorted(svc.completed_ft.items())]
    tokens = {u: r.out_tokens for u, r in sorted(svc.engine.completed.items())}
    for t in ticks:
        emit({"phase": "slice_serve", **t})
    for i, u in enumerate(updates):
        emit({"phase": "slice_serve", "bank_update": i, **u})
    by_kind = {}
    for t in ticks:
        by_kind.setdefault(t["kind"], []).append(t["wall_s"])
    full = get_arch(S["arch"])
    n_params = count_params(arch)
    want_ft = S["waves"] * S["ft_per_wave"]
    want_infer = S["waves"] * S["infer_per_wave"]
    finite = bool(np.all(np.isfinite([x["loss"] for x in losses])))
    in_vocab = all(0 <= tok < arch.vocab for ts in tokens.values()
                   for tok in ts)
    emit({"phase": "slice_serve", "summary": True, "arch": arch.name,
          "d_model": arch.d_model, "n_heads": arch.n_heads,
          "n_kv_heads": arch.n_kv_heads, "d_ff": arch.d_ff,
          "vocab": arch.vocab, "dtype": arch.dtype, "tenants": n,
          "params_per_tenant": n_params,
          "reduced": {"n_layers": [arch.n_layers, full.n_layers],
                      "repeats": [[s.repeats for s in arch.segments],
                                  [s.repeats for s in full.segments]],
                      "params": [n_params, count_params(full)]},
          "traffic": {k: v for k, v in S.items()
                      if k not in ("arch", "repeats", "tenants")},
          "ticks": len(ticks), "wall_s_by_kind": by_kind,
          "groups_per_tick": [len(t["groups"]) for t in ticks],
          "bank_updates": len(updates),
          "launches_per_bank_update": [u["launches"] for u in updates],
          "latency": report, "steps": list(svc.steps), "losses": losses,
          "tokens": tokens, "finite": finite, "build_s": build_s,
          "held_after_build_bytes": held, "held_by": held_by,
          "build_peak_bytes": build_peak, "peak_mem_bytes": peak,
          "base_mem_bytes": base, "allocator": "expandable_segments",
          "launches": counts, "calls_by_shape": by_shape,
          "buckets": [f"d={b.spec.d} {b.spec.mode.value} B={b.total}×{n}"
                      for b in opt.factor_buckets]})
    missing = [k for k in PATH_KERNELS["slice_serve"] if counts[k] == 0]
    unchecked = [k for k in by_shape if k not in checked]
    served = (report["infer"].get("requests"),
              report["finetune"].get("requests"))
    per_tenant = [want_ft // n] * n
    if (not finite or not in_vocab or missing or unchecked
            or served != (want_infer, want_ft) or svc.steps != per_tenant):
        raise AssertionError(
            f"slice_serve: finite {finite}, tokens in vocab {in_vocab}, "
            f"kernels never launched {missing}, calls at unchecked shapes "
            f"{unchecked}, served {served} of {(want_infer, want_ft)}, "
            f"steps {svc.steps} (want {per_tenant})")
    # the counting wrapper refers back to the bank: drop it, or the bank's
    # stacked states outlive the phase in a reference cycle
    del svc.bank.update
    del svc
    return counts



# ---------------------------------------------------------------------------
# the launch layer: launch/steps.py's builders and the trainer CLI
# ---------------------------------------------------------------------------

#: agree_launch: the CLI at --reduced --compress, card against CPU, with
#: gemma3's reduced config at a vocabulary of 1024: its embedding and head
#: (64 × 1024) reach CompressConfig's min_size of 65536, so the rank-8
#: compression acts on them (at the reduced vocabulary of 256 it acts on
#: no leaf); then one call of each builder at the reduced config
AGREE_LAUNCH = dict(steps=4, vocab=1024)
#: slice_launch: ``python -m repro_torch.launch.train`` at gemma3-4b's full
#: width with its defaults (batch 4 × 64, default_kfac_config: r 256,
#: every factor BRAND, use_kernels=False) and --compress --telemetry-dir,
#: 6 steps; the depth the card holds with compression's error feedback:
#: 22 of 34 layers (the first segment at 3 of its 5 repeats, the 4-local
#: tail kept; tools/launch_memory.py); then the builders at the same cut:
#: one build_train_step step at the CLI's batch, build_prefill_step at
#: 1 × 2048, and build_decode_step over the prompt's first tokens held to
#: a prefill of the same tokens (fp32 activations, DECODE_TOL)
LAUNCH_SLICE = dict(arch="gemma3_4b", repeats=(3, 1), steps=6, batch=4,
                    seq=64, prefill=2048, decode=8)
#: launch_reduced: the CLI's other branches on the card at --reduced:
#: B-R-KFAC (so the async runner has heavy work: every factor
#: BRAND_RSVD with its dense M, RSVD every 10 steps, staggered), health
#: guards, checkpoints every 2 steps, the async pipeline at lag 2; 12
#: steps, then a rerun to 16 resumes from the newest snapshot (10), held
#: to an uninterrupted 16-step run
LAUNCH_REDUCED = dict(argv=("--reduced", "--variant", "brkfac", "--health",
                            "--ckpt-every", "2", "--async-heavy",
                            "--heavy-lag", "2"),
                      steps=12, resumed=16)


def launch_reduced_opt():
    """launch_reduced's optimizer, on the CPU (statics only)."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.core import kfac as kfac_lib
    from repro_torch.launch import train
    from repro_torch.models.lm import LM
    args = train.parse_args(list(LAUNCH_REDUCED["argv"]))
    lm = LM(get_arch("gemma3_4b").reduced(), device=torch.device("cpu"))
    return kfac_lib.Kfac(train.kfac_config_of(args), lm.taps,
                         device=torch.device("cpu"))


def launch_kernel_shapes():
    """launch_reduced's kernel shapes from its optimizer and schedule: the
    EA absorb's (B, d, n_stat) of each bucket that holds M, and the RSVD
    range finder's panels (count, d, r + r_o) — count a whole bucket (the
    warmup, a forced refresh) or any heavy or launched range of the run's
    steps."""
    from repro_torch.core import kfactor
    opt = launch_reduced_opt()
    sched = opt.scheduler()
    counts = {bi: {b.total} for bi, b in enumerate(opt.factor_buckets)}
    for k in range(LAUNCH_REDUCED["resumed"]):
        work = sched.work(k)
        for bi in counts:
            for lo, hi in work.heavy[bi] + work.launch[bi]:
                counts[bi].add(hi - lo)
    dense, panels = [], []
    for bi, b in enumerate(opt.factor_buckets):
        s = b.spec
        if s.needs_m:
            dense.append((b.total, s.d, s.n_stat))
        if kfactor.has_heavy_op(s):
            panels += [(c, s.d, min(s.r + s.r_o, s.d))
                       for c in sorted(counts[bi])]
    return dense, panels


def _events(directory) -> list:
    import os
    with open(os.path.join(directory, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def _cli(dev, argv, arch=None, weights=None, batches=None):
    """``repro_torch.launch.train`` for ``argv`` on ``dev`` → (state,
    losses), from ``weights`` (CPU tensors) and ``batches`` (CPU batches
    by step) when given."""
    from repro_torch.launch import train
    args = train.parse_args(list(argv) + ["--device", dev.type])
    params = None
    if weights is not None:
        params = {k: v.detach().to(dev, copy=True).requires_grad_()
                  for k, v in weights.items()}
    fetch = None
    if batches is not None:
        fetch = lambda k: {n: t.to(dev) for n, t in batches[k].items()}
    return train.run(args, arch=arch, params=params, batches=fetch)


def _builders_run(arch, dev, weights):
    """One call of each builder at ``arch`` on ``dev`` from ``weights``:
    a build_train_step step on _lm_batch's batch (stats, light and the
    heavy op: every factor of the reduced config is EVD, so without it
    the spectrum stays empty and the clipped update is zero), the
    prefill of its tokens and three decode steps → CPU tensors."""
    import torch
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import steps
    B, T = LM_AGREE_B, LM_AGREE_T
    fresh = lambda: {k: v.detach().to(dev, copy=True).requires_grad_()
                     for k, v in weights.items()}
    batch = _lm_batch(arch, dev)
    tb = steps.build_train_step(arch, cell=ShapeCell("agree", T, B, "train"),
                                flags=dict(do_stats=True, do_light=True,
                                           do_heavy=True), device=dev)
    params = fresh()
    params, _, loss = tb.step_fn(params, tb.opt.init(params), batch,
                                 torch.Generator(device=dev).manual_seed(1))
    pb = steps.build_prefill_step(arch, device=dev, cell=ShapeCell(
        "agree", T, B, "prefill"))
    logits = pb.step_fn(fresh(), {"tokens": batch["tokens"]})
    db = steps.build_decode_step(arch, device=dev, cell=ShapeCell(
        "agree", 16, B, "decode"))
    cache, p0, dec = db.lm.init_cache(B, 16), fresh(), []
    for t in range(3):
        lg, cache = db.step_fn(p0, cache, batch["tokens"][:, t:t + 1], t)
        dec.append(lg)
    cpu = lambda x: x.detach().cpu()
    return dict(loss=cpu(loss), params={k: cpu(v) for k, v in
                                        params.items()},
                logits=cpu(logits), decoded=cpu(torch.stack(dec)))


#: a continuation shift at most this fraction of its row's largest mode is
#: a rounding-level mode's (fp32's epsilon is 1.2e-7)
ROUNDING_MODE = 1e-6


@contextlib.contextmanager
def continuation_replay(shifts=None, prefix=False):
    """Record the spectrum continuation's shift (``core/precond.py``'s min
    over modes with D > 0, per row) at every call while the block runs,
    as CPU tensors in the yielded list; with
    ``shifts`` (another run's record) apply that run's shift of the same
    call in place of this run's own, which is still recorded.  The
    continuation is the one step of the update that is not continuous: a
    rounding-level mode that is positive on one device and not on the
    other moves λ by the smallest real mode there (ROADMAP §3).  Replaying
    one run's shifts in the other holds the rest of the two runs'
    arithmetic to each other.  The block must make as many calls as
    ``shifts`` holds; with ``prefix`` (a record of a run's first step,
    replayed in a longer run) the calls past its end take their own
    shift."""
    import torch
    from repro_torch.core import precond
    orig = precond.spectrum_continuation
    rec = []

    def continuation(D, lam):
        _, own = orig(D, torch.zeros_like(lam))     # λ = 0: own = min D>0
        i = len(rec)
        rec.append(own.detach().cpu())
        if shifts is None or (prefix and i >= len(shifts)):
            return orig(D, lam)
        if i >= len(shifts):
            raise AssertionError(f"continuation_replay: call {i} past the "
                                 f"{len(shifts)} replayed shifts")
        s = shifts[i].to(D.device, D.dtype)
        return torch.clamp(D - s[..., None], min=0.0), lam + s

    precond.spectrum_continuation = continuation
    try:
        yield rec
    finally:
        precond.spectrum_continuation = orig
    if shifts is not None and len(rec) < len(shifts):
        raise AssertionError(f"continuation_replay: {len(rec)} calls "
                             f"replayed {len(shifts)} shifts")


def factor_partings(card_state, host_state) -> list:
    """The K-factors whose own continuation shift parts between two runs'
    final states: a stacked row whose shift (its smallest D > 0) is
    rounding-level (≤ ROUNDING_MODE of its largest mode) in one and not in
    the other, with both shifts of the row's largest mode."""
    import torch
    from repro_torch.core import precond
    out = []
    for name in host_state.opt.factors:
        for side in ("A", "G"):
            ratios = []
            for st in (card_state, host_state):
                D = getattr(st.opt.factors[name], side).D.detach().cpu()
                D = D.reshape(-1, D.shape[-1]).double()
                _, own = precond.spectrum_continuation(
                    D, torch.zeros(D.shape[0], dtype=D.dtype))
                ratios.append(own / D.amax(-1).clamp(min=1e-30))
            for r, (c, h) in enumerate(zip(*ratios)):
                if (c <= ROUNDING_MODE) != (h <= ROUNDING_MODE):
                    out.append({"factor": f"{name}/{side}", "row": r,
                                "cuda": float(c), "cpu": float(h)})
    return out


def phase_agree_launch():
    """The CLI at --reduced --compress (AGREE_LAUNCH) and one call of each
    builder at gemma3's reduced config, card against CPU from the same
    weights and batches.  The CLI, with the CPU run's continuation shifts
    replayed on the card (``continuation_replay``; the factors whose own
    shifts part are printed): over the run, the losses within 1e-4
    relative and the first step's compressed gradients within 1e-4 (the
    same inputs); after one step, every parameter's change within
    agree_lm's 1e-3, but a compressed leaf's that no K-FAC tap owns (the
    embedding), which is held through its gradients: AdamW divides each
    entry by its own size, so an entry that compression leaves at rounding
    level (a token row the batch does not touch) takes a step of either
    sign, and those rows steer the later steps — the run's later
    gradients and its parameter changes are printed.  The builders: the
    step's loss and parameter changes, the prefill logits and three decode
    steps' within 1e-3 (of each tensor's largest entry)."""
    import dataclasses
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.distributed import compress as compress_lib
    from repro_torch.kernels import _build
    from repro_torch.models.lm import LM

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    tol, tight = 1e-3, 1e-4
    A = AGREE_LAUNCH
    red = get_arch("gemma3_4b").reduced()
    arch = dataclasses.replace(red, vocab=A["vocab"])
    lm = LM(arch, device=cpu)
    weights = {k: v.detach() for k, v in lm.init(
        torch.Generator().manual_seed(0)).items()}
    stream = TokenStream(vocab=arch.vocab, batch=4, seq_len=64, seed=0,
                         device=cpu)
    batches = [stream.batch_at(k) for k in range(A["steps"])]
    compress_tree = compress_lib.compress_tree

    def run(dev, steps, shifts=None):
        """The CLI → (state, losses, compressed leaves by step, its
        continuation record)."""
        grads = []

        def recorded(gp, cs, cfg, sp=None):
            out, cs = compress_tree(gp, cs, cfg, sp=sp)
            # copies: the update consumes the step's gradients (an
            # untapped leaf's AdamW update is made in its storage)
            grads.append({k: v.detach().to("cpu", copy=True)
                          for k, v in out.items()
                          if v.dim() >= 2 and v.numel() >= cfg.min_size})
            return out, cs

        argv = ["--reduced", "--compress", "--steps", str(steps),
                "--metrics-every", "0"]
        compress_lib.compress_tree = recorded
        try:
            with continuation_replay(shifts) as rec:
                state, losses = _cli(dev, argv, arch, weights, batches)
        finally:
            compress_lib.compress_tree = compress_tree
        return state, losses, grads, rec

    def changes(card, host):
        return {k: _scale_err(card.params[k].detach().cpu() - weights[k],
                              host.params[k].detach() - weights[k])
                for k in weights}

    host1, _, _, host1_rec = run(cpu, 1)
    card1, _, _, _ = run(cuda, 1, host1_rec)
    first = changes(card1, host1)
    partings = factor_partings(card1, host1)
    del card1, host1
    host, host_losses, host_g, host_rec = run(cpu, A["steps"])
    _build.reset_launch_counts()
    card, card_losses, card_g, _ = run(cuda, A["steps"], host_rec)
    cli_launches = {k: v for k, v in _build.launch_counts().items() if v}
    compressed = set(host_g[0])
    assert len(card_g) == len(host_g) == A["steps"]
    assert all(set(c) == set(h) == compressed
               for c, h in zip(card_g, host_g))
    grad_errs = [max(_scale_err(c[n], h[n]) for n in h)
                 for c, h in zip(card_g, host_g)]
    untapped = compressed - {t.param_path for t in lm.taps.values()}
    errs = {"cli_losses": max(abs(a - b) / max(abs(b), 1e-6)
                              for a, b in zip(card_losses, host_losses,
                                              strict=True)),
            "compressed_grads_step0": grad_errs[0],
            "first_step_changes": max(v for k, v in first.items()
                                      if k not in untapped)}
    run_changes = changes(card, host)
    run_partings = factor_partings(card, host)
    del card, host
    red_w = {k: v.detach() for k, v in LM(red, device=cpu).init(
        torch.Generator().manual_seed(1)).items()}
    _build.reset_launch_counts()
    c = _builders_run(red, cuda, red_w)
    builder_launches = {k: v for k, v in _build.launch_counts().items() if v}
    h = _builders_run(red, cpu, red_w)
    errs["train_loss"] = _scale_err(c["loss"], h["loss"])
    errs["train_params"] = max(_scale_err(c["params"][k] - red_w[k],
                                          h["params"][k] - red_w[k])
                               for k in red_w)
    errs["prefill"] = _scale_err(c["logits"], h["logits"])
    errs["decode"] = _scale_err(c["decoded"], h["decoded"])
    tols = {k: (tight if k in ("cli_losses", "compressed_grads_step0")
                else tol) for k in errs}
    emit({"phase": "agree_launch", "errors": errs, "tols": tols,
          "compressed": sorted(compressed),
          "held_by_gradients": sorted(untapped),
          "compressed_grad_errors_by_step": grad_errs,
          "first_step_change_errors": first,
          "run_change_errors": run_changes,
          "first_step_factor_partings": partings,
          "run_factor_partings": run_partings,
          "losses_cuda": card_losses, "losses_cpu": host_losses,
          "cli_launches": cli_launches,
          "builder_launches": builder_launches})
    bad = [k for k, e in errs.items() if not e <= tols[k]]
    if bad or compressed != {"embed", "head/w"} or untapped != {"embed"}:
        raise AssertionError(f"agree_launch: {bad} beyond their tolerance "
                             f"{tols}: {errs}; compressed {compressed}, "
                             f"held by gradients {untapped}")


def phase_slice_launch(checked):
    """Path 11: the trainer CLI at gemma3-4b's full width (LAUNCH_SLICE)
    with --compress, through its parser and ``run``; its kernel launches
    (none expected: every factor BRAND under use_kernels=False, as the
    reference's CLI runs plain jnp) and any call at a shape the ``kernels``
    phase did not hold; wall time a step by kind from its ``step`` events,
    compression's seconds a step, memory.  Then the builders at the same
    cut (LAUNCH_SLICE).  Returns the launch counts of the CLI run and the
    builders."""
    import dataclasses
    import gc
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeCell, get_arch
    from repro_torch.core import kfac as kfac_lib
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.distributed import compress as compress_lib
    from repro_torch.kernels import _build
    from repro_torch.launch import steps, train
    from repro_torch.launch.param_count import count_params
    from repro_torch.models.lm import LM

    S = LAUNCH_SLICE
    dev = torch.device("cuda")
    arch = get_arch(S["arch"]).with_repeats(S["repeats"])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_launch_")
    argv = ["--compress", "--steps", str(S["steps"]), "--batch",
            str(S["batch"]), "--seq", str(S["seq"]), "--telemetry-dir", tmp,
            "--device", "cuda"]
    args = train.parse_args(argv)
    opt = kfac_lib.Kfac(train.kfac_config_of(args),
                        LM(arch, device=torch.device("meta")).taps,
                        device=torch.device("meta"))
    modes = sorted({b.spec.mode.value for b in opt.factor_buckets})
    # compression's time a step: the CLI's grad_transform looks
    # compress_tree up in its module at each call
    compress_tree, compress_s = compress_lib.compress_tree, []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = compress_tree(*a, **kw)
        torch.cuda.synchronize()
        compress_s.append(time.perf_counter() - t0)
        return out

    # the path needs ~72 GB of the card's 85: collect what earlier phases
    # left in reference cycles before reading the base
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()   # what earlier phases left
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    compress_lib.compress_tree = timed
    t0 = time.perf_counter()
    try:
        with calls_by_shape() as by_shape:
            state, losses = train.run(args, arch=arch)
    finally:
        compress_lib.compress_tree = compress_tree
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    cli_peak = torch.cuda.max_memory_allocated()
    events = _events(tmp)
    shutil.rmtree(tmp, ignore_errors=True)
    walls = [(e["phase"], e["dt_s"]) for e in events if e["type"] == "step"]
    by_kind = {}
    for kind, w in walls:
        by_kind.setdefault(kind, []).append(w)
    PATH_WALLS["slice_launch"] = by_kind
    for k, (kind, w) in enumerate(walls):
        emit({"phase": "slice_launch", "step": k, "kind": kind,
              "loss": losses[k], "wall_s": w, "compress_s": compress_s[k]})
    params = state.params
    del state
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() - base

    # the builders at the same cut, on the CLI's trained parameters
    with calls_by_shape() as builder_shapes:
        torch.cuda.reset_peak_memory_stats()
        tb = steps.build_train_step(arch, device=dev, cell=ShapeCell(
            "card_train", S["seq"], S["batch"], "train"))
        batch = TokenStream(vocab=arch.vocab, batch=S["batch"],
                            seq_len=S["seq"], seed=0,
                            device=dev).batch_at(S["steps"])
        st = tb.opt.init(params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, st, train_loss = tb.step_fn(
            params, st, batch, torch.Generator(device=dev).manual_seed(1))
        train_loss = float(train_loss)
        train_s = time.perf_counter() - t0
        del st, tb
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        prompt = TokenStream(vocab=arch.vocab, batch=1, seq_len=S["prefill"],
                             seed=1, device=dev).batch_at(0)["tokens"]
        pb = steps.build_prefill_step(arch, device=dev, cell=ShapeCell(
            "card_prefill", S["prefill"], 1, "prefill"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = pb.step_fn(params, {"tokens": prompt})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_ok = (tuple(logits.shape) == (1, S["prefill"], arch.vocab)
                      and bool(torch.isfinite(logits).all()))
        # decode over the prompt's first tokens against a prefill of them: fp32
        # activations, the reference's decode test's dtype (bf16 decode and
        # forward each round in their own order, as slice_lm shows)
        n = S["decode"]
        arch32 = dataclasses.replace(arch, dtype="float32")
        db = steps.build_decode_step(arch32, device=dev, cell=ShapeCell(
            "card_decode", n, 1, "decode"))
        want = steps.build_prefill_step(arch32, device=dev, cell=ShapeCell(
            "card_decode", n, 1, "prefill")).step_fn(
                params, {"tokens": prompt[:, :n]})
        cache, dec = db.lm.init_cache(1, n), []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            for t in range(n):
                lg, cache = db.step_fn(params, cache, prompt[:, t:t + 1], t)
                dec.append(lg[:, 0])
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / n
        dec = torch.stack(dec, 1)
        dec_err = _scale_err(dec, want)
        dec_ok = bool(torch.allclose(dec, want, atol=DECODE_TOL,
                                     rtol=DECODE_TOL))
        bf16_err = _scale_err(dec.float(), logits[:, :n].float())
    builders_peak = torch.cuda.max_memory_allocated()
    counts = _build.launch_counts()
    del params, logits, want, dec, cache
    torch.cuda.empty_cache()
    full = get_arch(S["arch"])
    finite = bool(np.all(np.isfinite(losses + [train_loss])))
    n_params = count_params(arch)
    emit({"phase": "slice_launch", "summary": True, "arch": arch.name,
          "d_model": arch.d_model, "n_heads": arch.n_heads,
          "n_kv_heads": arch.n_kv_heads, "head_dim": arch.hd,
          "d_ff": arch.d_ff, "vocab": arch.vocab, "dtype": arch.dtype,
          "params": n_params,
          "reduced": {"n_layers": [arch.n_layers, full.n_layers],
                      "repeats": [[s.repeats for s in arch.segments],
                                  [s.repeats for s in full.segments]],
                      "params": [n_params, count_params(full)]},
          "argv": [a if a != tmp else "<tmpdir>" for a in argv],
          "steps": len(losses),
          "kinds": [k for k, _ in walls], "losses": losses,
          "finite": finite, "wall_s_by_kind": by_kind,
          "compress_s": compress_s, "run_s": run_s,
          "factor_modes": modes, "use_kernels": opt.cfg.use_kernels,
          "cli_peak_mem_bytes": cli_peak, "base_mem_bytes": base,
          "params_held_bytes": held,
          "builders": {"train": {"cell": [S["batch"], S["seq"]],
                                 "loss": train_loss, "wall_s": train_s},
                       "prefill": {"shape": [1, S["prefill"]],
                                   "wall_s": prefill_s, "ok": prefill_ok},
                       "decode": {"tokens": n, "tol": DECODE_TOL,
                                  "fp32_max_err_of_scale": dec_err,
                                  "fp32_allclose": dec_ok,
                                  "ms_per_token": decode_ms,
                                  "vs_bf16_prefill": bf16_err},
                       "peak_mem_bytes": builders_peak},
          "launches": counts, "calls_by_shape": by_shape,
          "builder_calls_by_shape": builder_shapes})
    missing = [k for k in PATH_KERNELS["slice_launch"] if counts[k] == 0]
    unchecked = [k for k in {**by_shape, **builder_shapes}
                 if k not in checked]
    if (not finite or len(losses) != S["steps"] or missing or unchecked
            or not prefill_ok or not dec_ok or modes != ["brand"]):
        raise AssertionError(
            f"slice_launch: finite {finite}, {len(losses)} steps, kernels "
            f"never launched {missing}, calls at unchecked shapes "
            f"{unchecked}, prefill ok {prefill_ok}, fp32 decode allclose "
            f"{dec_ok} ({dec_err:.3g}), factor modes {modes}")
    return counts


def phase_launch_reduced(checked):
    """The CLI's other branches on the card (LAUNCH_REDUCED): B-R-KFAC
    with health guards, checkpoints and the async pipeline on a side
    stream, 12 steps, then a rerun that resumes from the newest snapshot,
    held to an uninterrupted run; every kernel call at a shape the
    ``kernels`` phase held.  Returns the launch counts of the two runs."""
    import os
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.kernels import _build

    R = LAUNCH_REDUCED
    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_launch_reduced_")
    ck, tel = os.path.join(tmp, "ck"), os.path.join(tmp, "tel")
    argv = list(R["argv"]) + ["--ckpt-dir", ck, "--telemetry-dir", tel]
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with calls_by_shape() as by_shape:
        _, first = _cli(dev, argv + ["--steps", str(R["steps"])])
        _, tail = _cli(dev, argv + ["--steps", str(R["resumed"])])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    side = _build.side_launch_counts()
    events = _events(tel)
    _, whole = _cli(dev, [a for a in R["argv"]] + ["--steps",
                                                   str(R["resumed"])])
    shutil.rmtree(tmp, ignore_errors=True)
    types = {}
    for e in events:
        types[e["type"]] = types.get(e["type"], 0) + 1
    restores = [e["step"] for e in events if e["type"] == "ckpt_restore"]
    # the newest snapshot is of the last step a multiple of the cadence
    k0 = (R["steps"] - 1) // 2 * 2 + 1
    err = max(abs(a - b) / max(abs(b), 1e-6)
              for a, b in zip(tail, whole[k0:]))
    emit({"phase": "launch_reduced", "argv": R["argv"],
          "losses": first, "resumed_losses": tail, "restored": restores,
          "uninterrupted_tail": whole[k0:], "resume_err": err,
          "resume_bitwise": tail == whole[k0:], "event_counts": types,
          "run_s": run_s, "launches": counts, "side_launches": side,
          "calls_by_shape": by_shape})
    missing = [k for k in PATH_KERNELS["launch_reduced"] if counts[k] == 0]
    unchecked = [k for k in by_shape if k not in checked]
    finite = bool(np.all(np.isfinite(first + tail)))
    if (not finite or missing or unchecked or restores != [k0 - 1]
            or len(tail) != R["resumed"] - k0 or not err <= 1e-6
            or not types.get("async_land") or types.get("remediation")):
        raise AssertionError(
            f"launch_reduced: finite {finite}, kernels never launched "
            f"{missing}, calls at unchecked shapes {unchecked}, restored "
            f"{restores}, {len(tail)} resumed steps, resume err {err:.3g}, "
            f"events {types}")
    return counts


# ---------------------------------------------------------------------------
# the distributed curvature engine: agree_dist and slice_dist (path 12)
# ---------------------------------------------------------------------------

#: path 12: the paper's full-width VGG16_bn under B-R-KFAC on four ranks of
#: the one card, factor slots on ``curv`` and dense-M rows on ``rows``;
#: 31 steps, as slice_brkfac (the RSVD overwrite at 0 and 25)
DIST = dict(world=4, shape=(2, 2), axes=("curv", "rows"), steps=31,
            timeout=900)

#: slice_dist's limits: each replayed step's update and new state (M,
#: U·diag(D)·Uᵀ, momentum relative to the largest entry; aux absolute),
#: and the free-running losses over the first DIST_HELD steps, against
#: one process's; past those the sharded run's loss drift from
#: slice_brkfac's may be at most DIST_CHAOS times the witness's (the same
#: run from weights one ulp apart), or DIST_TOL's
DIST_TOL = 1e-3
DIST_HELD = 4
DIST_CHAOS = 10.0

#: agree_dist's tap set: the CPU tests' mixed taps (tests/test_torch_dist.py)
DIST_TAPS = (("fc", "fc/w", 48, 32, ()), ("fc2", "fc2/w", 48, 32, ()),
             ("scan", "scan/w", 48, 48, (3,)), ("moe", "moe/w", 48, 32,
                                                (2, 2)))

#: agree_dist's schedules on the taps (the CPU tests' configs): staggered
#: synchronous, the same async at lag 0, lag 2 with step-varying
#: operands, and unstaggered
DIST_CFGS = {
    "sync": dict(momentum=0.9, T_updt=1, T_brand=1, T_inv=3, T_rsvd=3,
                 T_corct=3, stagger=True, stagger_splits=4),
    "lag0": dict(momentum=0.9, T_updt=1, T_brand=1, T_inv=3, T_rsvd=3,
                 T_corct=3, stagger=True, stagger_splits=4,
                 async_heavy=True, heavy_lag=0),
    "lag2": dict(T_updt=1, T_brand=1, T_inv=3, T_rsvd=3, T_corct=3,
                 stagger=True, stagger_splits=2, async_heavy=True,
                 heavy_lag=2),
    "plain": dict(momentum=0.9, T_updt=1, T_brand=1, T_inv=3, T_rsvd=3,
                  T_corct=3)}

#: (name, variant, mesh, schedule, steps, compress_rank); "1d" is (4,)
#: [curv], "2d" DIST's (2, 2) with M rows on ``rows``.  The compressed
#: gather runs at rank 8, the rank of its reference test
#: (tests/test_mesh2d.py:444), whose bound it is held to: at rank 2 these
#: taps' updates move by 0.56 of their norm (CPU, tests/test_torch_dist.py
#: setup), past the bound of 0.5
DIST_AGREE = (("sync_1d", "bkfac", "1d", "sync", 4, None),
              ("sync_2d", "brkfac", "2d", "sync", 4, None),
              ("lag0_1d", "kfac", "1d", "lag0", 4, None),
              ("lag0_2d", "brkfac", "2d", "lag0", 4, None),
              ("lag2_2d", "brkfac", "2d", "lag2", 6, None),
              ("raw_2d", "bkfac", "2d", "plain", 3, None),
              ("compress_2d", "bkfac", "2d", "plain", 3, 8))

#: agree_dist's CLI: the reduced config under B-R-KFAC, 4 steps
DIST_CLI = ("--reduced", "--variant", "brkfac", "--steps", "4")


def dist_slice_opt(dev):
    """slice_dist's model, optimizer and stream: slice_brkfac's."""
    from repro_torch.examples.train_vgg_kfac import build
    return build("paper", "brkfac", batch=128, device=dev, use_kernels=True)


def dist_kernel_shapes():
    """slice_dist's kernel shapes, from its optimizer's buckets and the
    engine's plans: each rank steps ⌈B/2⌉ slots of a bucket.  The EA
    absorb (B_l, d, n_stat) of a bucket whose M the row axis does not
    divide (the others absorb outside any kernel); the Brand panel
    (B_l, d, w, r, n_stat) of each Brand bucket; the RSVD range finder's
    panels (c, d, r + r_o): c = B_l / 2 when the row members split the
    range, else B_l."""
    import numpy as np
    import types
    import torch
    from repro_torch.core import kfactor
    from repro_torch.distributed import curvature
    _, opt, _ = dist_slice_opt(torch.device("cpu"))
    mesh = types.SimpleNamespace(axis_names=DIST["axes"],
                                 devices=np.zeros(DIST["shape"]))
    eng = curvature.CurvatureEngine(mesh, "curv", opt.factor_buckets,
                                    row_axis="rows")
    dense, brand, panels = [], [], []
    for b, plan, rb in zip(opt.factor_buckets, eng.plans, eng.row_blocks):
        s, bl = b.spec, plan.per_device
        if s.needs_m and rb is None:
            dense.append((bl, s.d, s.n_stat))
        if s.mode in kfactor._HAS_BRAND:
            brand.append((bl, s.d, s.width, s.r, s.n_stat))
        if kfactor.needs_draws(s) and s.mode is not kfactor.Mode.BRAND_CORR:
            split = bl >= eng.n_rows and bl % eng.n_rows == 0
            c = bl // eng.n_rows if (rb is not None and split) else bl
            panels.append((c, s.d, min(s.r + s.r_o, s.d)))
    return dense, brand, panels


def _taps_opt(variant, sched, dev):
    from repro_torch.core import kfac as kfac_lib
    from repro_torch.core import policy as policy_lib
    from repro_torch.optim import base as optbase
    taps = {n: kfac_lib.TapInfo(p, di, do, stack=st, n_stat=16)
            for n, p, di, do, st in DIST_TAPS}
    cfg = kfac_lib.KfacConfig(
        policy=policy_lib.PolicyConfig(variant=variant, r=8,
                                       max_dense_dim=8192),
        lr=optbase.constant(0.05), use_kernels=True, **DIST_CFGS[sched])
    return kfac_lib.Kfac(cfg, taps, device=dev)


def _taps_run(variant, sched, steps, dev, dist=None):
    """``Kfac.update`` on the taps, operands made with numpy (seed 0;
    step-varying under lag 2), draws from a card generator seeded 1 →
    the updates of every step."""
    import numpy as np
    import torch
    opt = _taps_opt(variant, sched, dev)
    if dist is not None:
        dist.attach(opt)
    plan = opt.scheduler(align=4)
    rs = np.random.default_rng(0)

    def t(*shape, scale=1.0):
        return torch.as_tensor((rs.standard_normal(shape) * scale).astype(
            np.float32), device=dev)

    def operands():
        return ({f"{n}/w": t(*st, di, do) for n, _, di, do, st in DIST_TAPS},
                {n: t(*st, 16, di) for n, _, di, _, st in DIST_TAPS},
                {n: t(*st, 16, do, scale=1e-3)
                 for n, _, _, do, st in DIST_TAPS})
    params = {f"{n}/w": t(*st, di, do, scale=0.05)
              for n, _, di, do, st in DIST_TAPS}
    fixed = operands()
    st = opt.init(params)
    gen = torch.Generator(device=dev).manual_seed(1)
    out = []
    for k in range(steps):
        grads, acts, pgs = operands() if sched == "lag2" else fixed
        upd, st = opt.update(dict(grads), st, params, acts=acts,
                             probe_grads=pgs, n_tokens=16, rng=gen,
                             work=plan.work(k))
        out.append({n: u.float().cpu() for n, u in upd.items()})
    return out


def _upd_err(a, b) -> float:
    """Largest error over the updates, relative to each tensor's largest
    entry."""
    return max(float((x[n] - y[n]).abs().max())
               / max(float(y[n].abs().max()), 1e-30)
               for x, y in zip(a, b) for n in y)


def _agree_vgg(dev, dist=None):
    """The small VGG of the agree phases under B-R-KFAC, 6 steps, numpy
    draws (seed 5) → losses."""
    from repro_torch.train import loop
    model, opt, batches = agree_setup("brkfac", dev)
    _, losses = loop.run_kfac_training(
        model.loss, opt, model.params(), batches, n_tokens=16, seed=0,
        device=dev, draws=numpy_draws(opt, seed=5), dist=dist)
    return losses


def dist_rank_agree(meshes, dev):
    """agree_dist (b), on this rank: each tap case sharded against the
    same case in one process on this card (1e-3), the compressed gather
    against the raw one at its reference bound, the small VGG's losses."""
    import numpy as np
    from repro_torch import specs
    out = {}
    raw = None
    for name, variant, mesh, sched, steps, q in DIST_AGREE:
        spec = specs.DistSpec(
            mesh=meshes[mesh], curvature_axis="curv",
            row_axis="rows" if mesh == "2d" else None,
            curvature_compress=q)
        got = _taps_run(variant, sched, steps, dev, spec)
        if q is None:
            want = _taps_run(variant, sched, steps, dev)
            out[name] = {"max_rel_err": _upd_err(got, want),
                         "tol_rel": 1e-3}
            if name == "raw_2d":
                raw = got
        else:
            ratio = max(float(np.linalg.norm((x[n] - y[n]).numpy()))
                        / float(np.linalg.norm(y[n].numpy()))
                        for x, y in zip(got, raw) for n in y)
            out[name] = {"rank": q, "max_norm_ratio": ratio, "bound": 0.5}
    spec = specs.DistSpec(mesh=meshes["2d"], curvature_axis="curv",
                          row_axis="rows")
    a, b = _agree_vgg(dev, spec), _agree_vgg(dev)
    out["vgg_2d"] = {"losses": a, "losses_one": b,
                     "max_rel_err": _max_rel(a, b), "tol_rel": 1e-3}
    return out


def dist_rank_slice(mesh, dev):
    """slice_dist on this rank: slice_brkfac's model, weights, batches and
    draws through ``run_kfac_training(dist=…)`` → per-step losses, kinds
    and walls, the gathers' seconds a step, held and accounted M bytes,
    launches and calls by shape."""
    import torch
    from repro_torch import specs
    from repro_torch.distributed import collectives
    from repro_torch.kernels import _build
    from repro_torch.train import loop
    model, opt, stream = dist_slice_opt(dev)
    steps = DIST["steps"]
    batches = [stream.batch_at(i) for i in range(steps)]
    sched = opt.scheduler(align=4)
    kinds = [step_kind(sched.work(k)) for k in range(steps)]
    spec = specs.DistSpec(mesh=mesh, curvature_axis="curv", row_axis="rows")
    gather_s = [0.0]
    gather = collectives.all_gather

    def timed_gather(*a, **kw):
        t0 = time.perf_counter()
        try:
            return gather(*a, **kw)
        finally:
            gather_s[0] += time.perf_counter() - t0
    walls, gathers = [], []
    t_prev = [0.0]

    def cb(k, state, loss):
        torch.cuda.current_stream().synchronize()
        now = time.perf_counter()
        walls.append(now - t_prev[0])
        gathers.append(gather_s[0])
        gather_s[0] = 0.0
        t_prev[0] = now

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    collectives.all_gather = timed_gather
    _build.reset_launch_counts()
    t_prev[0] = time.perf_counter()
    try:
        with calls_by_shape() as by_shape:
            state, losses = loop.run_kfac_training(
                model.loss, opt, model.params(), batches, n_tokens=128,
                seed=0, callback=cb, device=dev, dist=spec)
        torch.cuda.synchronize()
    finally:
        collectives.all_gather = gather
    counts = _build.launch_counts()
    eng = opt.curvature
    return {"losses": losses, "kinds": kinds, "wall_s": walls,
            "gather_s": gathers, "launches": counts,
            "calls_by_shape": dict(by_shape),
            "held_m_bytes": sum(t.numel() * t.element_size()
                                for t in state.opt.shards.values()),
            "m_bytes": list(eng.m_bytes()),
            "collective_bytes": eng.collective_bytes(),
            "engine": eng.describe(),
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def _state_err(got, want) -> dict:
    """Largest errors of the one-device KfacState ``got`` against
    ``want``: each factor's dense M and U·diag(D)·Uᵀ (the dense inverse U
    where D is all zero) and the momentum, each relative to the tensor's
    largest entry; aux (truncated-mass fractions, residuals) absolute;
    the step counters' mismatches."""
    import torch

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    def udu(st):
        return (st.U * st.D.unsqueeze(-2)) @ st.U.transpose(-1, -2)

    out = {"M": 0.0, "UDU": 0.0, "aux": 0.0, "momentum": 0.0,
           "counters": int(got.step != want.step)
           + int(got.phase != want.phase) + int(got.n_stats != want.n_stats)}
    for name, ts in want.factors.items():
        for side in "AG":
            w, g = getattr(ts, side), getattr(got.factors[name], side)
            if w.M.shape[-1] > 1:
                out["M"] = max(out["M"], rel(g.M, w.M))
            dense_inv = not bool(w.D.abs().max() > 0)
            out["UDU"] = max(out["UDU"], rel(g.U, w.U) if dense_inv
                             else rel(udu(g), udu(w)))
            out["aux"] = max(out["aux"],
                             float((g.aux - w.aux).abs().max()))
    for name, m in (want.momentum or {}).items():
        out["momentum"] = max(out["momentum"], rel(got.momentum[name], m))
    torch.cuda.empty_cache()
    return out


def dist_rank_replay(mesh, dev):
    """slice_dist's numerics, step by step: the same model, weights,
    batches and schedule under the engine, and at every step rank 0 also
    runs the one-process optimizer (no engine) from the same parameters,
    gradients and the engine's state gathered to the one-device layout,
    with the same draws (numpy, seed 5) → each step's largest update
    error relative to each tensor's largest entry, and the errors of the
    engine's new state (gathered) against the state the one-process step
    returns (``_state_err``), on rank 0; and the sharded run's losses.
    Teacher-forced: the run goes on from the sharded update and state, so
    every step's whole transition — update and new state, the row-block
    EA absorb's M included — is held to one process's."""
    import torch
    import torch.distributed as dist
    from repro_torch import specs
    from repro_torch.core import kfac as kfac_lib
    from repro_torch.core import tenant
    from repro_torch.models import layers
    from repro_torch.optim import base as optbase
    from repro_torch.train import loop
    model, opt, stream = dist_slice_opt(dev)
    one = kfac_lib.Kfac(opt.cfg, opt.taps, device=dev)
    eng = specs.DistSpec(mesh=mesh, curvature_axis="curv",
                         row_axis="rows").attach(opt)
    sched = opt.scheduler()
    draws = numpy_draws(opt, seed=5)
    params = model.params()
    state = opt.init(params)
    rank0 = dist.get_rank() == 0
    tapped = {t.param_path for t in opt.taps.values()}
    whole = eng.gather_state(opt, state)
    errs, state_errs, losses = [], [], []
    for k in range(DIST["steps"]):
        work = sched.work(k)
        probes = layers.make_probes(opt.taps, device=dev)
        loss, acts, gp, gprobe = loop.kfac_grads(
            model.loss, params, probes, stream.batch_at(k))
        kw = dict(acts=acts, probe_grads=gprobe, n_tokens=128, rng=None,
                  work=work, draws=draws(k))
        before = tenant.tree_map(
            lambda x: x.clone() if torch.is_tensor(x) else x,
            whole) if rank0 else None
        upd, state = opt.update(dict(gp), state, params, **kw)
        whole = eng.gather_state(opt, state)
        if rank0:
            want, want_state = one.update(dict(gp), before, params, **kw)
            errs.append(max(float((upd[n] - w).abs().max())
                            / max(float(w.abs().max()), 1e-30)
                            for n, w in want.items()))
            state_errs.append(_state_err(whole, want_state))
            del want, want_state
        del before
        optbase.apply_updates(params, upd)
        losses.append(float(loss))
    torch.cuda.synchronize()
    return {"update_rel_err": errs, "state_err": state_errs,
            "losses": losses}


def phase_rounding_witness():
    """slice_dist's witness of how far rounding alone parts a run at this
    width: slice_brkfac's one-process run (model, batches, seed, 31
    steps) again from initial weights each moved by one ulp → its
    per-step losses.  Its launches count toward no path."""
    import math
    import torch
    from repro_torch.train import loop
    dev = torch.device("cuda")
    model, opt, stream = dist_slice_opt(dev)
    params = {k: torch.nextafter(p, torch.full_like(p, math.inf))
              for k, p in model.params().items()}
    batches = [stream.batch_at(i) for i in range(DIST["steps"])]
    t0 = time.perf_counter()
    _, losses = loop.run_kfac_training(model.loss, opt, params, batches,
                                       n_tokens=128, seed=0, device=dev)
    torch.cuda.synchronize()
    return losses, time.perf_counter() - t0


def dist_rank_main(rank: int, world: int, rdv: str, out: str) -> int:
    """One rank of agree_dist (b, c) and slice_dist: joins the world
    through a file rendezvous (gloo: the ranks share the card), finds the
    kernels the parent built, and writes its results as JSON."""
    import traceback
    import torch
    import torch.distributed as dist
    res = {"rank": rank}
    t0 = time.perf_counter()
    try:
        from repro_torch.kernels import _build
        from repro_torch.launch import mesh as mesh_lib
        from repro_torch.launch import train
        dev = mesh_lib.init_process_group(
            None, init_method=f"file://{rdv}", rank=rank, world_size=world)
        _build.load()
        res.update(backend=dist.get_backend(), device=str(dev),
                   init_s=time.perf_counter() - t0)
        meshes = {"1d": mesh_lib.make_mesh((world,), ("curv",)),
                  "2d": mesh_lib.make_mesh(DIST["shape"], DIST["axes"])}
        t1 = time.perf_counter()
        res["agree"] = dist_rank_agree(meshes, dev)
        res["agree_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            state, losses = train.run(train.parse_args(
                list(DIST_CLI) + ["--mesh", "2x2", "--mesh-axes",
                                  "data,curv"]))
        res["cli"] = {"losses": losses, "log": buf.getvalue(),
                      "held_m_bytes": sum(t.numel() * t.element_size() for
                                          t in state.opt.shards.values())}
        del state
        res["cli_s"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        res["slice"] = dist_rank_slice(meshes["2d"], dev)
        res["slice_s"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        res["replay"] = dist_rank_replay(meshes["2d"], dev)
        res["replay_s"] = time.perf_counter() - t1
        dist.barrier()
        rc = 0
    except Exception:
        res["error"] = traceback.format_exc()
        rc = 1
    with open(out, "w") as f:
        json.dump(res, f)
    return rc


def phase_agree_dist_single():
    """agree_dist (a): the small VGG under B-R-KFAC with the engine on a
    one-member ``nccl`` mesh in this process, against the same run with
    no engine."""
    import torch
    import torch.distributed as dist
    from repro_torch import specs
    from repro_torch.launch import mesh as mesh_lib
    dev = torch.device("cuda")
    mesh = mesh_lib.make_mesh((1,), ("curv",))
    spec = specs.DistSpec(mesh=mesh, curvature_axis="curv")
    a, b = _agree_vgg(dev, spec), _agree_vgg(dev)
    err = _max_rel(a, b)
    emit({"phase": "agree_dist", "case": "one_member", "backend":
          dist.get_backend(), "losses": a, "losses_no_engine": b,
          "max_rel_err": err, "tol_rel": 1e-3})
    if not err < 1e-3:
        raise AssertionError(f"agree_dist one member: {a} vs {b}")


def phase_dist(checked):
    """agree_dist (b, c) and slice_dist on ``DIST["world"]`` ranks of the
    one card (processes of this script, joined with a timeout); this
    process meanwhile runs the CLI without a mesh, the oracle of (c).
    Returns slice_dist's launch counts, summed over the ranks."""
    import os
    import tempfile
    import numpy as np
    import torch
    from repro_torch.launch import train
    world = DIST["world"]
    witness, witness_s = phase_rounding_witness()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    rdv = os.path.join(tmp, "rendezvous")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
            for r in range(world)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--dist-rank",
         str(r), str(world), rdv, os.path.join(tmp, f"rank{r}.json")],
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            _, cli_one = train.run(train.parse_args(list(DIST_CLI)))
        deadline = time.perf_counter() + DIST["timeout"]
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    spawn_s = time.perf_counter() - t0
    res = []
    for r in range(world):
        logs[r].seek(0)
        tail = logs[r].read()[-2000:]
        logs[r].close()
        path = os.path.join(tmp, f"rank{r}.json")
        got = json.load(open(path)) if os.path.exists(path) else {}
        if procs[r].returncode != 0 or "error" in got:
            raise AssertionError(f"slice_dist rank {r} failed (rc "
                                 f"{procs[r].returncode}): "
                                 f"{got.get('error', '')[-3000:]}\n{tail}")
        res.append(got)
    # (b): every rank's cases
    for name in res[0]["agree"]:
        rows = [g["agree"][name] for g in res]
        line = {"phase": "agree_dist", "case": name, "ranks": rows}
        emit(line)
        for row in rows:
            ok = (row["max_norm_ratio"] <= row["bound"] if "bound" in row
                  else row["max_rel_err"] < row["tol_rel"])
            if not ok:
                raise AssertionError(f"agree_dist {name}: {rows}")
    # (c): the CLI on the 2 × 2 mesh against --mesh none
    cli_err = max(_max_rel(g["cli"]["losses"], cli_one) for g in res)
    log0 = res[0]["cli"]["log"]
    emit({"phase": "agree_dist", "case": "cli", "losses_one": cli_one,
          "losses": [g["cli"]["losses"] for g in res],
          "max_rel_err": cli_err, "tol_rel": 1e-4,
          "engine_log": [ln for ln in log0.splitlines()
                         if "curvature sharded" in ln or "dense-M" in ln]})
    if not (cli_err < 1e-4 and "curvature sharded on 'curv'" in log0
            and all(not g["cli"]["log"] for g in res[1:])):
        raise AssertionError(f"agree_dist cli: {cli_err}, log {log0}")
    # slice_dist: each step's update and new state against the
    # one-process optimizer's from the same state (the replay, at
    # DIST_TOL), every path kernel launched, every call at a checked
    # shape, M as accounted.  The free-running losses are held to
    # slice_brkfac's at DIST_TOL over the first DIST_HELD steps only: at
    # this width rounding alone parts two runs by more than that later,
    # as the witness shows (slice_brkfac from weights one ulp apart), and
    # the sharded run must part by no more than DIST_CHAOS times the
    # witness does
    sl = [g["slice"] for g in res]
    replay = res[0]["replay"]
    err = max(replay["update_rel_err"])
    want = PATH_LOSSES["slice_brkfac"]
    drift = [abs(a - b) / abs(b) for a, b in zip(sl[0]["losses"], want)]
    w_drift = [abs(a - b) / abs(b) for a, b in zip(witness, want)]
    serr = {f: max(e[f] for e in replay["state_err"])
            for f in replay["state_err"][0]}
    counts = {k: sum(s["launches"][k] for s in sl) for k in sl[0]["launches"]}
    missing = [k for k in PATH_KERNELS["slice_dist"] if counts[k] == 0]
    unchecked = sorted({k for s in sl for k in s["calls_by_shape"]
                        if k not in checked})
    held = [s["held_m_bytes"] for s in sl]
    kinds = sl[0]["kinds"]
    for k in range(DIST["steps"]):
        emit({"phase": "slice_dist", "step": k, "kind": kinds[k],
              "loss": sl[0]["losses"][k],
              "loss_slice_brkfac": want[k], "drift": drift[k],
              "drift_witness": w_drift[k],
              "update_rel_err": replay["update_rel_err"][k],
              "state_err": replay["state_err"][k],
              "wall_s": [round(s["wall_s"][k], 6) for s in sl],
              "gather_s": [round(s["gather_s"][k], 6) for s in sl]})
    by_kind = {}
    for s in sl:
        for kind, w, g in zip(kinds, s["wall_s"], s["gather_s"]):
            by_kind.setdefault(kind, {"wall_s": [], "gather_s": []})
            by_kind[kind]["wall_s"].append(w)
            by_kind[kind]["gather_s"].append(g)
    emit({"phase": "slice_dist", "summary": True, "world": world,
          "mesh": dict(zip(DIST["axes"], DIST["shape"])),
          "backend": res[0]["backend"], "engine": sl[0]["engine"],
          "steps": DIST["steps"], "kinds": kinds,
          "max_update_rel_err": err, "max_state_err": serr,
          "tol": DIST_TOL,
          "loss_drift_held_steps": DIST_HELD,
          "max_loss_drift_held": max(drift[:DIST_HELD]),
          "max_loss_drift_vs_slice_brkfac": max(drift),
          "witness": {"losses": witness, "seconds": witness_s,
                      "max_loss_drift": max(w_drift),
                      "chaos_factor": DIST_CHAOS},
          "wall_s_by_kind": by_kind,
          "held_m_bytes": held, "m_bytes": sl[0]["m_bytes"],
          "collective_bytes": sl[0]["collective_bytes"],
          "peak_mem_bytes": [s["peak_mem_bytes"] for s in sl],
          "launches": counts, "launches_by_rank": [s["launches"]
                                                   for s in sl],
          "calls_by_shape": [s["calls_by_shape"] for s in sl],
          "seconds": {"spawn_to_end": spawn_s,
                      "init": [g["init_s"] for g in res],
                      "agree": [g["agree_s"] for g in res],
                      "cli": [g["cli_s"] for g in res],
                      "slice": [g["slice_s"] for g in res],
                      "replay": [g["replay_s"] for g in res]},
          "note": "four ranks share one card's SMs and memory: these "
                  "times are what the path costs on one H100, not what "
                  "four cards would take"})
    finite = all(np.isfinite(s["losses"]).all() for s in sl)
    state_ok = (serr["counters"] == 0
                and all(serr[f] < DIST_TOL for f in serr if f != "counters"))
    drift_ok = (max(drift[:DIST_HELD]) < DIST_TOL
                and max(drift) <= DIST_CHAOS * max(max(w_drift), DIST_TOL))
    if (not finite or not err < DIST_TOL or not state_ok or not drift_ok
            or missing or unchecked
            or len(replay["update_rel_err"]) != DIST["steps"]
            or len(replay["state_err"]) != DIST["steps"]
            or any(h != sl[0]["m_bytes"][1] for h in held)):
        raise AssertionError(
            f"slice_dist: finite {finite}, update rel err {err}, state "
            f"err {serr}, loss drift {drift} (witness {w_drift}), never "
            f"launched {missing}, calls at unchecked shapes {unchecked}, "
            f"held M {held} vs {sl[0]['m_bytes']}")
    return counts


# ---------------------------------------------------------------------------
# data-parallel execution of the LM: slice_dp (path 13) and dp_reduced
# ---------------------------------------------------------------------------

#: path 13: the trainer CLI at gemma3-4b's full width on ``--mesh 2x1``
#: (data 2, model 1): two ranks of the one card on gloo, each on its 2 of
#: the batch's 4 rows, with the CLI's defaults (batch 4 × 64,
#: default_kfac_config: every factor BRAND, use_kernels=False) and
#: --compress (PowerSGD's panels summed across the ranks; the raw
#: gradient all-reduce would stage several GB a step through host memory
#: over gloo); cut to 4 of 34 layers, gemma3's pattern with its global
#: layer and three of its five local ones (``layers``: positions in the
#: first segment's pattern), where two ranks fit beside this process:
#: a rank holds the whole model, its optimizer state and its own error
#: feedback, 22.4 GB after its build and a 39.9 GB peak at 6 layers
#: (tools/launch_memory.py --ranks 2), which fit alone but not beside
#: this script's earlier phases, and at 10 layers two ranks run the card
#: out of memory; then the prefill (2 × 2048) and fp32 decode builders on
#: the data mesh, each rank's logits held to its rows of one process's
DP_SLICE = dict(arch="gemma3_4b", layers=(0, 1, 2, 5), steps=6, batch=4,
                seq=64, prefill=2048, decode=8, world=2, timeout=900)
#: dp_reduced: B-R-KFAC at --reduced on ``--mesh 4x1`` without --compress
#: (the raw gradient all-reduce), 12 steps (the RSVD overwrites of the
#: staggered T_inv = 10 window), four ranks; then the same steps replayed,
#: each step's update and new state held to the one-process optimizer's
#: from the same gathered state and the same parameters, whose gradients
#: and taps rank 0 computes on the whole batch, with the data-parallel
#: step's continuation shifts replayed (as agree_launch replays the CPU's)
DP_REDUCED = dict(argv=("--reduced", "--variant", "brkfac"), steps=12,
                  world=4, timeout=600)
#: slice_dp's and dp_reduced's limits against one process: the free-running
#: losses over the first DP_HELD steps of slice_dp and every step of
#: dp_reduced, dp_reduced's replayed updates and states
DP_TOL = 1e-3
DP_HELD = 4


def dp_reduced_opt(dev, mesh=None):
    """dp_reduced's model (gemma3 reduced, data-parallel over ``mesh``)
    and optimizer (the engine on the data axis, as --curvature auto picks
    on ``--mesh 4x1``)."""
    from repro_torch import specs
    from repro_torch.configs.base import get_arch
    from repro_torch.core import kfac as kfac_lib
    from repro_torch.launch import steps, train
    from repro_torch.models.lm import LM
    args = train.parse_args(list(DP_REDUCED["argv"]))
    lm = LM(get_arch("gemma3_4b").reduced(), steps.shard_policy_for(mesh),
            remat=False, device=dev)
    opt = kfac_lib.Kfac(train.kfac_config_of(args), lm.taps, device=dev)
    if mesh is not None:
        specs.DistSpec(mesh=mesh, curvature_axis="data").attach(opt)
    return lm, opt


def dp_kernel_shapes(world=None, steps=None):
    """dp_reduced's kernel shapes on each rank: the engine gives a rank
    ⌈B/4⌉ slots of every bucket, so the EA absorb's (⌈B/4⌉, d, n_stat)
    of each bucket that holds M, and the RSVD range finder's panels
    (count, d, r + r_o) — the rank's whole share (the first step) or its
    local rows of each heavy range of the run's steps.  ``world`` (the
    engine's data members) and ``steps`` give another path's: tp_reduced
    runs the engine on the two data members of its 2 × 2 mesh, each
    model rank the slots of its data coordinate."""
    import types
    import numpy as np
    import torch
    from repro_torch.core import buckets, kfactor
    from repro_torch.distributed import curvature
    world = world or DP_REDUCED["world"]
    steps = steps or DP_REDUCED["steps"]
    _, opt = dp_reduced_opt(torch.device("cpu"))
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.zeros((world, 1)))
    eng = curvature.CurvatureEngine(mesh, "data", opt.factor_buckets)
    sched = opt.scheduler(align=world)
    dense, panels = [], []
    for bi, (b, plan) in enumerate(zip(opt.factor_buckets, eng.plans)):
        s, bl = b.spec, plan.per_device
        if s.needs_m:
            dense.append((bl, s.d, s.n_stat))
        if kfactor.has_heavy_op(s):
            counts = {bl}
            for k in range(steps):
                for lo, hi in buckets.localize_ranges(
                        sched.work(k).heavy[bi], b.total, world):
                    counts.add(hi - lo)
            panels += [(c, s.d, min(s.r + s.r_o, s.d))
                       for c in sorted(counts)]
    return dense, panels


def tp_kernel_shapes():
    """tp_reduced's shapes on each rank of its 2 × 2 mesh (the engine's
    ⌈B/2⌉ slots of a bucket on "data", the factor rows d/2 on "model"):
    each dense bucket's EA absorb on its M rows (slots, rows, d,
    n_stat); and of its use_kernels step each Brand bucket's (slots,
    rows, width, r, n_stat) and each precondition launch's (count, p, d,
    w_g, w_a) in the kernels' (J, U_g, U_a) order — a column-parallel
    group on its G rows, a row-parallel one on its A rows, a tap of
    neither whole."""
    import math
    import types
    import numpy as np
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.core import kfac as kfac_lib
    from repro_torch.core import kfactor
    from repro_torch.distributed import curvature
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import train
    from repro_torch.models.lm import LM
    data, model = TP_REDUCED["data"], TP_REDUCED["world"] // TP_REDUCED["data"]
    mesh = types.SimpleNamespace(
        axis_names=("data", "model"), devices=np.zeros((data, model)),
        shape={"data": data, "model": model}, coord=lambda a: 0)
    lm = LM(get_arch("gemma3_4b").reduced(), device=torch.device("meta"))
    opt = kfac_lib.Kfac(train.reduced_kfac_config("brkfac"), lm.taps,
                        device=torch.device("meta"))
    opt.model_shards = shd.ModelShards(
        lm.init(None), mesh, taps={n: t.param_path
                                   for n, t in lm.taps.items()})
    eng = curvature.CurvatureEngine(mesh, "data", opt.factor_buckets)
    dense, brand = [], []
    for b, plan in zip(opt.factor_buckets, eng.plans):
        s = b.spec
        rows, m_rows = opt._factor_rows(s), opt._m_rows(s)
        if s.needs_m:
            dense.append((plan.per_device, m_rows.rb if m_rows else s.d,
                          s.d, s.n_stat))
        if s.mode in kfactor._HAS_BRAND:
            brand.append((plan.per_device, rows.rb if rows else s.d,
                          s.width, s.r, s.n_stat))
    precond = []
    for b in opt.precond_buckets:
        a, g = b.spec_a, b.spec_g
        for kind in ("col", "row"):
            n = sum(math.prod(e.stack) for e in b.entries
                    if opt._precond_kind(e.name) == kind)
            if n:
                p_, o_ = (g, a) if kind == "col" else (a, g)
                precond.append((n, opt._factor_rows(p_).rb, o_.d,
                                p_.width, o_.width))
        precond += [(math.prod(e.stack), a.d, g.d, a.width, g.width)
                    for e in b.entries
                    if opt._precond_kind(e.name) == "whole"]
    return dense, brand, precond


@contextlib.contextmanager
def counted_collectives():
    """Bytes and seconds of every all-reduce and all-gather while the
    block runs ({kind: [bytes, seconds, calls]}, from this process's
    calls; a call over a tuple of axes counts as its per-axis calls)."""
    import torch
    from repro_torch.distributed import collectives as coll
    tally = {"all_reduce": [0, 0.0, 0], "all_gather": [0, 0.0, 0],
             "all_gather_coalesced": [0, 0.0, 0]}
    saved = {k: getattr(coll, k) for k in tally}

    def wrap(kind):
        fn = saved[kind]

        def counted(x, mesh, axis=None, *a, **kw):
            if isinstance(axis, tuple):
                return fn(x, mesh, axis, *a, **kw)
            t0 = time.perf_counter()
            out = fn(x, mesh, axis, *a, **kw)
            xs = x if isinstance(x, list) else [x]
            if any(t.is_cuda for t in xs):
                torch.cuda.current_stream().synchronize()
            row = tally[kind]
            row[0] += sum(t.numel() * t.element_size() for t in xs)
            row[1] += time.perf_counter() - t0
            row[2] += 1
            return out
        return counted
    for k in tally:
        setattr(coll, k, wrap(k))
    try:
        yield tally
    finally:
        for k, fn in saved.items():
            setattr(coll, k, fn)


def _dp_slice_arch():
    """gemma3-4b at full width, cut to DP_SLICE's positions of its first
    segment's pattern, once."""
    import dataclasses
    from repro_torch.configs.base import Segment, get_arch
    full = get_arch(DP_SLICE["arch"])
    pattern = tuple(full.segments[0].pattern[i] for i in DP_SLICE["layers"])
    return dataclasses.replace(full, n_layers=len(pattern),
                               segments=(Segment(pattern, repeats=1),))


def _dp_slice_argv(extra=()):
    S = DP_SLICE
    return ["--compress", "--steps", str(S["steps"]), "--batch",
            str(S["batch"]), "--seq", str(S["seq"]), "--device", "cuda",
            "--metrics-every", "0", *extra]


def dp_rank_slice(rank: int, dev) -> dict:
    """slice_dp on this rank: the CLI on ``--mesh 2x1`` (per step: wall
    time, the all-reduce and all-gather bytes and seconds), launches,
    calls by shape, peak memory; then the prefill and decode builders on
    the data mesh, this rank's logits against its rows of the same
    builders' one-process logits."""
    import dataclasses
    import gc
    import tempfile
    import torch
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps, train
    S = DP_SLICE
    arch = _dp_slice_arch()
    tel = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    args = train.parse_args(_dp_slice_argv(
        ["--mesh", f"{S['world']}x1"]
        + (["--telemetry-dir", tel] if rank == 0 else [])))
    stream = TokenStream(vocab=arch.vocab, batch=S["batch"],
                         seq_len=S["seq"], seed=0, device=dev).batch_at
    marks, tallies = [], []

    def batches(k):
        # a step boundary: the device's work so far is the previous step's
        torch.cuda.current_stream().synchronize()
        marks.append(time.perf_counter())
        tallies.append({kk: list(v) for kk, v in tally.items()})
        return stream(k)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    with calls_by_shape() as by_shape, counted_collectives() as tally:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            state, losses = train.run(args, arch=arch, batches=batches)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        tallies.append({kk: list(v) for kk, v in tally.items()})
    peak = torch.cuda.max_memory_allocated()
    counts = _build.launch_counts()
    kinds = ([e["phase"] for e in _events(tel) if e["type"] == "step"]
             if rank == 0 else None)
    per_step = []
    for k in range(len(losses)):
        row = {"wall_s": marks[k + 1] - marks[k]}
        for kind in ("all_reduce", "all_gather"):
            a, b = tallies[k][kind], tallies[k + 1][kind]
            row[kind] = {"bytes": b[0] - a[0], "s": b[1] - a[1],
                         "calls": b[2] - a[2]}
        per_step.append(row)
    params = {k: v.detach() for k, v in state.params.items()}
    del state
    gc.collect()
    torch.cuda.empty_cache()

    # the builders on the data mesh, against the same builders in one
    # process on the whole batch (this rank's rows)
    mesh = mesh_lib.make_mesh((S["world"], 1), ("data", "model"))
    B, n = S["world"], S["decode"]
    prompt = TokenStream(vocab=arch.vocab, batch=B, seq_len=S["prefill"],
                         seed=1, device=dev).batch_at(0)["tokens"]
    rows = slice(rank, rank + 1)
    out = {}
    for name, mesh_of in (("dp", mesh), ("one", None)):
        pb = steps.build_prefill_step(arch, mesh=mesh_of, device=dev,
                                      cell=ShapeCell("dp_prefill",
                                                     S["prefill"], B,
                                                     "prefill"))
        batch = {"tokens": prompt}
        if mesh_of is not None:
            batch = shd.localize(batch, pb.in_shardings[1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg = pb.step_fn(params, batch)
        torch.cuda.synchronize()
        out[name] = {"prefill_s": time.perf_counter() - t0,
                     "prefill": lg if mesh_of is not None else lg[rows]}
        del lg
        torch.cuda.empty_cache()
        arch32 = dataclasses.replace(arch, dtype="float32")
        db = steps.build_decode_step(arch32, mesh=mesh_of, device=dev,
                                     cell=ShapeCell("dp_decode", n, B,
                                                    "decode"))
        cache, tok = db.lm.init_cache(B, n), prompt
        if mesh_of is not None:
            cache = shd.localize(cache, db.in_shardings[1])
            tok = shd.localize(prompt, db.in_shardings[2])
        dec = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            for t in range(n):
                lg, cache = db.step_fn(params, cache, tok[:, t:t + 1], t)
                dec.append(lg[:, 0])
        torch.cuda.synchronize()
        out[name]["decode_ms"] = (time.perf_counter() - t0) * 1e3 / n
        dec = torch.stack(dec, 1)
        out[name]["decode"] = dec if mesh_of is not None else dec[rows]
        del cache, dec
    prefill_err = _scale_err(out["dp"]["prefill"].float(),
                             out["one"]["prefill"].float())
    decode_err = _scale_err(out["dp"]["decode"], out["one"]["decode"])
    finite = bool(torch.isfinite(out["dp"]["prefill"]).all()
                  and torch.isfinite(out["dp"]["decode"]).all())
    return {"losses": losses, "kinds": kinds, "steps": per_step,
            "log": buf.getvalue() if rank == 0 else "",
            "peak_mem_bytes": peak, "launches": counts,
            "calls_by_shape": dict(by_shape),
            "builders": {"prefill": [B, S["prefill"]], "decode": [B, n],
                         "prefill_err_of_scale": prefill_err,
                         "decode_fp32_err_of_scale": decode_err,
                         "finite": finite,
                         "prefill_s": {k: out[k]["prefill_s"]
                                       for k in out},
                         "decode_ms_per_token": {k: out[k]["decode_ms"]
                                                 for k in out}}}


def dp_rank_reduced(rank: int, dev) -> dict:
    """dp_reduced on this rank: the CLI on ``--mesh 4x1`` (launches, calls
    by shape, per-step collectives), then the replay: every step's
    data-parallel update (of a tapped leaf; the gradient of one the AdamW
    fallback steps) and new state (gathered) against, on rank 0, the
    one-process optimizer's from the same state, with the gradients and
    taps of the whole batch from the same parameters."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import kfac as kfac_lib
    from repro_torch.core import tenant
    from repro_torch.data.synthetic import TokenStream, rank_rows
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train
    from repro_torch.models import layers
    from repro_torch.models.lm import LM
    from repro_torch.optim import base as optbase
    from repro_torch.train import loop
    R = DP_REDUCED
    world = R["world"]
    args = train.parse_args(list(R["argv"]) + [
        "--steps", str(R["steps"]), "--mesh", f"{world}x1", "--device",
        "cuda"])
    _build.reset_launch_counts()
    with calls_by_shape() as by_shape, counted_collectives() as tally:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _, losses = train.run(args)
        torch.cuda.synchronize()
    counts = _build.launch_counts()
    cli_tally = {k: list(v) for k, v in tally.items()}

    mesh = mesh_lib.make_mesh((world, 1), ("data", "model"))
    lm, opt = dp_reduced_opt(dev, mesh)
    one = kfac_lib.Kfac(opt.cfg, opt.taps, device=dev)
    lm1 = LM(lm.arch, remat=False, device=dev)
    eng = opt.curvature
    sp = lm.sp
    sched = opt.scheduler()
    draws = numpy_draws(opt, seed=5)
    params = lm.init(torch.Generator(device=dev).manual_seed(0))
    state = opt.init(params)
    stream = TokenStream(vocab=lm.arch.vocab, batch=args.batch,
                         seq_len=args.seq, seed=0, device=dev)
    n_tokens = args.batch * args.seq
    rank0 = dist.get_rank() == 0
    tapped = {t.param_path for t in opt.taps.values()}
    whole = eng.gather_state(opt, state)
    errs, state_errs, loss_errs, rows, parted, worst = ([], [], [], [], [],
                                                        [])
    for k in range(R["steps"]):
        work = sched.work(k)
        batch = stream.batch_at(k)
        local = rank_rows(batch, sp.dp_index, sp.dp_size)
        rows.append(int(local["tokens"].shape[0]))
        loss, acts, gp, gprobe = loop.kfac_grads(
            lm.loss_fn, params, layers.make_probes(opt.taps, device=dev),
            local, sp)
        kw = dict(n_tokens=n_tokens, rng=None, work=work, draws=draws(k))
        before = tenant.tree_map(
            lambda x: x.clone() if torch.is_tensor(x) else x,
            whole) if rank0 else None
        with continuation_replay() as shifts:
            upd, state = opt.update(dict(gp), state, params, acts=acts,
                                    probe_grads=gprobe, **kw)
        whole = eng.gather_state(opt, state)
        if rank0:
            loss1, acts1, gp1, gprobe1 = loop.kfac_grads(
                lm1.loss_fn, params,
                layers.make_probes(opt.taps, device=dev), batch)
            # the spectrum continuation's shifts of the data-parallel step
            # replayed (ROADMAP §3: a rounding-level mode of a
            # rank-deficient G factor parts it between any two runs);
            # where the one-process step's own shifts part is counted
            with continuation_replay(shifts) as own:
                want, want_state = one.update(gp1, before, params,
                                              acts=acts1,
                                              probe_grads=gprobe1, **kw)
            parted.append(sum(int(((a - b).abs() > 1e-3 * b.abs()).sum())
                              for a, b in zip(shifts, own)))
            # the tapped leaves by their updates; the AdamW fallback's
            # (norm scales, the embedding) by the gradients entering it:
            # AdamW divides each entry by its own size, so a
            # rounding-level gradient entry takes a step anywhere between
            # 0 and the learning rate (ROADMAP §3)
            rel = lambda a, b: (float((a - b).abs().max())
                                / max(float(b.abs().max()), 1e-30))
            by_name = {n: (rel(upd[n], w) if n in tapped
                           else rel(gp[n], gp1[n]))
                       for n, w in want.items()}
            errs.append(max(by_name.values()))
            worst.append(sorted(by_name.items(), key=lambda kv: -kv[1])[:3])
            state_errs.append(_state_err(whole, want_state))
            loss_errs.append(abs(float(loss) - float(loss1))
                             / abs(float(loss1)))
            del want, want_state
        del before
        optbase.apply_updates(params, upd)
    torch.cuda.synchronize()
    return {"losses": losses, "log": buf.getvalue() if rank == 0 else "",
            "launches": counts, "calls_by_shape": dict(by_shape),
            "collectives": cli_tally, "rows": rows,
            "replay": {"update_rel_err": errs, "state_err": state_errs,
                       "loss_rel_err": loss_errs,
                       "continuation_rows_parted": parted,
                       "worst_updates": worst}}


def dp_rank_main(job: str, rank: int, world: int, rdv: str, out: str) -> int:
    """One rank of slice_dp or dp_reduced: joins the world through a file
    rendezvous (gloo: the ranks share the card), finds the kernels the
    parent built, runs ``job`` and writes its results as JSON."""
    import traceback
    import torch.distributed as dist
    res = {"rank": rank}
    t0 = time.perf_counter()
    try:
        from repro_torch.kernels import _build
        from repro_torch.launch import mesh as mesh_lib
        dev = mesh_lib.init_process_group(
            None, init_method=f"file://{rdv}", rank=rank, world_size=world)
        _build.load()
        res.update(backend=dist.get_backend(), device=str(dev),
                   init_s=time.perf_counter() - t0)
        t1 = time.perf_counter()
        run = {"slice": dp_rank_slice, "reduced": dp_rank_reduced,
               "tp_slice": tp_rank_slice, "tp_reduced": tp_rank_reduced}[job]
        res[job] = run(rank, dev)
        res["run_s"] = time.perf_counter() - t1
        dist.barrier()
        rc = 0
    except Exception:
        res["error"] = traceback.format_exc()
        rc = 1
    with open(out, "w") as f:
        json.dump(res, f)
    return rc


def spawn_ranks(job: str, world: int, timeout: float, meanwhile=None,
                env_extra=None):
    """``world`` processes of this script running ``job`` (``--dp-rank``)
    on the one card, joined with a timeout; ``meanwhile()`` runs in this
    process while they do → (its result, the ranks' results, seconds)."""
    import os
    import tempfile
    import torch
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{job}_")
    rdv = os.path.join(tmp, "rendezvous")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
            for r in range(world)]
    t0 = time.perf_counter()
    # the ranks allocate as this process does since slice_serve
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True",
               **(env_extra or {}))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--dp-rank", job,
         str(r), str(world), rdv, os.path.join(tmp, f"rank{r}.json")],
        stdout=logs[r], stderr=subprocess.STDOUT, env=env)
        for r in range(world)]
    mine = None
    try:
        if meanwhile is not None:
            mine = meanwhile()
        deadline = time.perf_counter() + timeout
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    res, failed = [], []
    for r in range(world):
        logs[r].seek(0)
        tail = logs[r].read()[-2000:]
        logs[r].close()
        path = os.path.join(tmp, f"rank{r}.json")
        got = json.load(open(path)) if os.path.exists(path) else {}
        if procs[r].returncode != 0 or "error" in got:
            # every rank's: the first to fail makes the others' collectives
            # fail after it
            failed.append(f"{job} rank {r} failed (rc "
                          f"{procs[r].returncode}): "
                          f"{got.get('error', '')[-2000:]}\n{tail}")
        res.append(got)
    if failed:
        raise AssertionError("\n".join(failed))
    return mine, res, seconds


def _rel_drift(a, b) -> list:
    return [abs(x - y) / abs(y) for x, y in zip(a, b, strict=True)]


def phase_dp_slice(checked):
    """Path 13 (DP_SLICE): the one-process CLI at the cut first (its
    losses and step times), then the same run on ``--mesh 2x1``: two
    ranks of this card, each on its rows, held to it over the first
    DP_HELD steps at DP_TOL; each rank's step time by kind, its
    all-reduce and all-gather bytes and seconds, peak memory, launches;
    the builders' logits on the data mesh against one process's.  Returns
    the launch counts summed over the ranks."""
    import gc
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.launch import train
    from repro_torch.launch.param_count import count_params
    S = DP_SLICE
    arch = _dp_slice_arch()
    tel = tempfile.mkdtemp(prefix="chip_smoke_dp_one_")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        state, one = train.run(train.parse_args(_dp_slice_argv(
            ["--telemetry-dir", tel])), arch=arch)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    one_peak = torch.cuda.max_memory_allocated() - base
    one_walls = [(e["phase"], e["dt_s"]) for e in _events(tel)
                 if e["type"] == "step"]
    shutil.rmtree(tel, ignore_errors=True)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    card_free = torch.cuda.mem_get_info()[0]     # what the two ranks get
    _, res, spawn_s = spawn_ranks("slice", S["world"], S["timeout"])
    sl = [g["slice"] for g in res]
    kinds = sl[0]["kinds"]
    drift = [_rel_drift(s["losses"], one) for s in sl]
    for k in range(S["steps"]):
        emit({"phase": "slice_dp", "step": k, "kind": kinds[k],
              "loss": [s["losses"][k] for s in sl], "loss_one": one[k],
              "drift": [d[k] for d in drift],
              "wall_s": [s["steps"][k]["wall_s"] for s in sl],
              "wall_s_one": one_walls[k][1],
              "all_reduce": [s["steps"][k]["all_reduce"] for s in sl],
              "all_gather": [s["steps"][k]["all_gather"] for s in sl]})
    by_kind = {}
    for s in sl:
        for kind, st in zip(kinds, s["steps"]):
            by_kind.setdefault(kind, []).append(st["wall_s"])
    PATH_WALLS["slice_dp"] = by_kind
    counts = {k: sum(s["launches"][k] for s in sl) for k in sl[0]["launches"]}
    missing = [k for k in PATH_KERNELS["slice_dp"] if counts[k] == 0]
    unchecked = sorted({k for s in sl for k in s["calls_by_shape"]
                        if k not in checked})
    bl = [s["builders"] for s in sl]
    log = [ln for ln in sl[0]["log"].splitlines()
           if "data parallel" in ln or "curvature sharded" in ln]
    emit({"phase": "slice_dp", "summary": True, "arch": arch.name,
          "world": S["world"], "mesh": {"data": S["world"], "model": 1},
          "backend": res[0]["backend"], "params": count_params(arch),
          "reduced": {"n_layers": arch.n_layers,
                      "pattern_positions": list(DP_SLICE["layers"]),
                      "windows": [p.window for p in
                                  arch.segments[0].pattern]},
          "argv": _dp_slice_argv(["--mesh", f"{S['world']}x1"]),
          "kinds": kinds, "losses_one": one,
          "max_drift_held": max(max(d[:DP_HELD]) for d in drift),
          "max_drift": max(max(d) for d in drift), "tol": DP_TOL,
          "held_steps": DP_HELD, "wall_s_by_kind": by_kind,
          "wall_s_one": one_walls, "one_run_s": one_s,
          "one_peak_mem_bytes": one_peak,
          "card_free_bytes_at_spawn": card_free,
          "peak_mem_bytes": [s["peak_mem_bytes"] for s in sl],
          "builders": bl, "engine_log": log,
          "launches": counts, "calls_by_shape": [s["calls_by_shape"]
                                                 for s in sl],
          "seconds": {"spawn_to_end": spawn_s,
                      "init": [g["init_s"] for g in res],
                      "run": [g["run_s"] for g in res]},
          "note": "two ranks share one card's SMs and memory, and their "
                  "collectives go through host memory (gloo)"})
    finite = all(np.isfinite(s["losses"]).all() for s in sl)
    held_ok = all(max(d[:DP_HELD]) < DP_TOL for d in drift)
    build_ok = all(b["finite"] and b["prefill_err_of_scale"] <= DECODE_TOL
                   and b["decode_fp32_err_of_scale"] <= DP_TOL for b in bl)
    if (not finite or not held_ok or not build_ok or missing or unchecked
            or len(kinds) != S["steps"]
            or not any("data parallel over data: 2 ranks" in ln
                       for ln in log)):
        raise AssertionError(
            f"slice_dp: finite {finite}, loss drift {drift}, builders "
            f"{bl}, never launched {missing}, calls at unchecked shapes "
            f"{unchecked}, log {log}")
    return counts


def phase_dp_reduced(checked):
    """dp_reduced (DP_REDUCED) on four ranks of this card; this process
    meanwhile runs the one-process CLI, the oracle of the free-running
    losses.  Every rank must launch each kernel of the path, at shapes
    the ``kernels`` phase held.  Returns the launch counts of the ranks'
    CLI runs, summed."""
    import numpy as np
    import torch
    from repro_torch.launch import train
    R = DP_REDUCED

    def one_process():
        with contextlib.redirect_stdout(io.StringIO()):
            return train.run(train.parse_args(list(R["argv"]) + [
                "--steps", str(R["steps"]), "--device", "cuda"]))[1]
    one, res, spawn_s = spawn_ranks("reduced", R["world"], R["timeout"],
                                    meanwhile=one_process)
    torch.cuda.synchronize()
    sl = [g["reduced"] for g in res]
    drift = [_rel_drift(s["losses"], one) for s in sl]
    replay = sl[0]["replay"]
    err = max(replay["update_rel_err"])
    serr = {f: max(e[f] for e in replay["state_err"])
            for f in replay["state_err"][0]}
    counts = {k: sum(s["launches"][k] for s in sl) for k in sl[0]["launches"]}
    missing = [(r, k) for r, s in enumerate(sl)
               for k in PATH_KERNELS["dp_reduced"] if s["launches"][k] == 0]
    unchecked = sorted({k for s in sl for k in s["calls_by_shape"]
                        if k not in checked})
    for k in range(R["steps"]):
        emit({"phase": "dp_reduced", "step": k,
              "loss": [s["losses"][k] for s in sl], "loss_one": one[k],
              "drift": [d[k] for d in drift],
              "update_rel_err": replay["update_rel_err"][k],
              "state_err": replay["state_err"][k],
              "loss_rel_err": replay["loss_rel_err"][k],
              "continuation_rows_parted":
                  replay["continuation_rows_parted"][k],
              "worst_updates": replay["worst_updates"][k]})
    emit({"phase": "dp_reduced", "summary": True, "argv": R["argv"],
          "world": R["world"], "mesh": {"data": R["world"], "model": 1},
          "backend": res[0]["backend"], "steps": R["steps"],
          "max_drift": max(max(d) for d in drift),
          "max_update_rel_err": err, "max_state_err": serr,
          "tol": DP_TOL, "rows_per_rank": sl[0]["rows"],
          "collectives": [s["collectives"] for s in sl],
          "engine_log": [ln for ln in sl[0]["log"].splitlines()
                         if "data parallel" in ln
                         or "curvature sharded" in ln],
          "launches": counts, "launches_by_rank": [s["launches"]
                                                   for s in sl],
          "calls_by_shape": [s["calls_by_shape"] for s in sl],
          "seconds": {"spawn_to_end": spawn_s,
                      "init": [g["init_s"] for g in res],
                      "run": [g["run_s"] for g in res]}})
    finite = all(np.isfinite(s["losses"]).all() for s in sl)
    state_ok = (serr["counters"] == 0
                and all(serr[f] < DP_TOL for f in serr if f != "counters"))
    if (not finite or max(max(d) for d in drift) >= DP_TOL
            or not err < DP_TOL or not state_ok
            or max(replay["loss_rel_err"]) >= DP_TOL
            or len(replay["update_rel_err"]) != R["steps"]
            or sl[0]["rows"] != [1] * R["steps"]
            or missing or unchecked):
        raise AssertionError(
            f"dp_reduced: finite {finite}, loss drift {drift}, update rel "
            f"err {err}, state err {serr}, replay loss err "
            f"{replay['loss_rel_err']}, never launched (rank, kernel) "
            f"{missing}, calls at unchecked shapes {unchecked}")
    return counts


# ---------------------------------------------------------------------------
# tensor-parallel execution of the LM: slice_tp (path 14) and tp_reduced
# ---------------------------------------------------------------------------

#: slice_tp: the trainer CLI at gemma3-4b's full width on ``--mesh 1x2``
#: (data 1, model 2: two ranks of this card over gloo, each holding its
#: block of every sharded leaf) with ``--compress``, the CLI's defaults
#: (batch 4 x 64, B-KFAC, every factor BRAND), cut to ``repeats`` of its
#: two segments (1, 0: 6 of 34 layers, gemma3's five local layers and
#: its global one), ``steps`` steps, all held.  16 layers are the deepest
#: that two ranks fit alone (35.10 GB peak a rank; 18 run the card out of
#: memory: tools/launch_memory.py --mesh 1x2), and every step gathers
#: each sharded gradient and sums the probe gradients over gloo (~1 GB/s
#: of data moved on one card): at 10 layers 3.41 GB gathered and 1.40 GB
#: summed a rank, 10.5–13.6 s an idle step, so the cut is chosen with the
#: script's time limit in view.  Step 0 is held twice against one
#: process's from the same state, with its continuation shifts replayed:
#: in fp32 (``--steps 1``) at DP_TOL, and in bf16 (the run's first step)
#: at TP_WITNESS_FACTOR times the parting of one process's bf16 step 0
#: from itself with every initial weight one ulp up (the witness).  Then
#: the builders at that cut in fp32: a 2 x 2048 prefill (vocabulary
#: blocks gathered), decode of ``decode`` tokens over a ``cache``-slot
#: cache (past the shard boundary) in each of the "seq", "heads" and "hd"
#: layouts, and the long-context decode (B = 1, ``window_caches``) at
#: ``long`` slots, ``long_tokens`` tokens from just below the middle shard
#: boundary; each against the same builders in one process on rank 0, at
#: TP_FP32_TOL of scale.
TP_SLICE = dict(arch="gemma3_4b", repeats=(1, 0), steps=4, batch=4, seq=64,
                prefill=2048, decode=10, cache=16, long=524288,
                long_tokens=4, world=2, timeout=900)
#: tp_reduced: B-R-KFAC at --reduced on ``--mesh 2x2`` (data 2, model 2)
#: without --compress, 12 steps (the RSVD overwrites of the staggered
#: window), the engine on "data"; then the same steps replayed, each
#: step's update and new state held to the one-process optimizer's from
#: the same gathered state, parameters and batch (rank 0), with the
#: tensor-parallel step's continuation shifts replayed
TP_REDUCED = dict(argv=("--reduced", "--variant", "brkfac"), steps=12,
                  world=4, data=2, timeout=600)
#: slice_tp's step 0 is held on the leaves under these prefixes (the
#: vocabulary-parallel embedding and head, the final norm, a local layer
#: and the global one): a tapped leaf by its update, every leaf by the
#: gradient entering the optimizer; and by the new factors of these taps
TP_HELD = ("embed", "segments/0/p0/", "segments/0/p5/", "final_ln",
           "head/w")
TP_HELD_TAPS = ("segments/seg0/p0/", "segments/seg0/p5/", "head")
#: of the embedding's rows and the head's columns (262,144 each) every
#: TP_VOCAB_STRIDE-th is held: both ranks' blocks, at a host copy of 1/8
TP_VOCAB_STRIDE = 8
#: the fp32 builders' logits against one process's, of scale
TP_FP32_TOL = 1e-4
#: slice_tp's bf16 step 0 parts from one process's by at most this many
#: times the witness's parting (both the largest over the held entries)
TP_WITNESS_FACTOR = 2.0
#: slice_tp's figures with every factor whole on each rank and the
#: sharded gradients gathered whole (PR 25's final run, PERF.md §5; H100
#: 80GB HBM3 at 700 W), printed beside this run's
TP_PR25 = {"idle_step_s": [6.35, 6.61], "grad_gather_gb": 2.59,
           "grad_gather_calls": 118, "grad_gather_s": [4.76, 5.05],
           "probe_gather_gb": 0.46, "probe_gather_calls": 2,
           "peak_gb_a_rank": 26.05, "peak_gb_one_process": 37.97}


def _tp_slice_arch():
    from repro_torch.configs.base import get_arch
    return get_arch(TP_SLICE["arch"]).with_repeats(TP_SLICE["repeats"])


def _tp_slice_argv(extra=()):
    S = TP_SLICE
    return ["--compress", "--steps", str(S["steps"]), "--batch",
            str(S["batch"]), "--seq", str(S["seq"]), "--device", "cuda",
            "--metrics-every", "0", *extra]


def _tp_held(k: str) -> bool:
    return k.startswith(TP_HELD)


def _held_view(k: str, t):
    """The held part of leaf ``k`` (every TP_VOCAB_STRIDE-th vocabulary
    entry of the embedding and the head), as an fp32 host copy (a copy:
    the optimizer makes an untapped leaf's update in its gradient's
    storage)."""
    if k == "embed":
        t = t[::TP_VOCAB_STRIDE]
    elif k == "head/w":
        t = t[:, ::TP_VOCAB_STRIDE]
    return t.detach().contiguous().to("cpu", copy=True).float()


@contextlib.contextmanager
def first_step(keep, at_first=lambda: None):
    """The first step's gradients entering the optimizer (``Kfac.update``)
    of the leaves ``keep`` accepts and its updates (``apply_updates``) of
    the tapped ones among them, each through ``_held_view``, in the
    yielded {"grad": …, "update": …} (``at_first()``'s value at the first
    update under "at")."""
    from repro_torch.core import kfac as kfac_lib
    from repro_torch.optim import base as optbase
    got = {"grad": {}, "update": {}}
    update, apply = kfac_lib.Kfac.update, optbase.apply_updates
    tapped = set()

    def recorded_update(self, grads, *a, **kw):
        if not got["grad"]:
            tapped.update(t.param_path for t in self.taps.values())
            got["grad"].update({k: _held_view(k, v)
                                for k, v in grads.items() if keep(k)})
        return update(self, grads, *a, **kw)

    def recorded_apply(params, updates):
        if "at" not in got:
            got["update"].update({k: _held_view(k, v)
                                  for k, v in updates.items()
                                  if keep(k) and k in tapped})
            got["at"] = at_first()
        return apply(params, updates)
    kfac_lib.Kfac.update, optbase.apply_updates = (recorded_update,
                                                   recorded_apply)
    try:
        yield got
    finally:
        kfac_lib.Kfac.update, optbase.apply_updates = update, apply


def tp_one_step0(arch, argv, shifts=None, params=None):
    """The CLI at slice_tp's settings (``argv`` added) in this process,
    its first step recorded (``first_step``: the held leaves' gradients
    and updates, and that step's continuation shifts under "shifts");
    ``shifts`` replays another run's step 0 in it → (state, losses,
    record)."""
    from repro_torch.launch import train
    with contextlib.redirect_stdout(io.StringIO()), \
            continuation_replay(shifts, prefix=True) as sh, \
            first_step(_tp_held, at_first=lambda: len(sh)) as got:
        state, losses = train.run(train.parse_args(_tp_slice_argv(argv)),
                                  arch=arch, params=params)
    got["shifts"] = sh[:got.pop("at")]
    return state, losses, got


def _step0_errs(got, want, block=lambda k, w: w) -> dict:
    """Each held entry's parting of ``got`` from ``want`` ("grad <leaf>",
    "update <leaf>", "factors <tap>/<side>"): the largest absolute
    difference over the largest entry of ``want`` (of its block where
    ``block`` takes the rank's)."""
    out = {}
    for kind in ("grad", "update", "factors"):
        for k, w in want.get(kind, {}).items():
            w = block(k, w) if kind != "factors" else w
            out[f"{kind} {k}"] = (float((got[kind][k] - w).abs().max())
                                  / max(float(w.abs().max()), 1e-30))
    return out


def _parted(own, shifts) -> int:
    """Rows whose own continuation shift parts from the replayed one."""
    return sum(int(((a - b).abs() > 1e-3 * b.abs()).sum())
               for a, b in zip(own, shifts))


def _factor_ops(factors, prefix: str, whole_u=None) -> dict:
    """Each factor of the taps under ``prefix`` as its operator U·diag(D)·Uᵀ
    applied to a fixed random (d, 16) panel (seeded by d, on the factor's
    device), on the host: the new state compared without forming the
    d × d matrices.  ``whole_u(name, side, U)`` gives U whole from a
    rank's row block (collective)."""
    import torch
    out = {}
    for name, ts in factors.items():
        if not name.startswith(prefix):
            continue
        for side in "AG":
            st = getattr(ts, side)
            if whole_u is not None:
                st = dataclasses.replace(st, U=whole_u(name, side, st.U))
            d = st.U.shape[-2]
            X = torch.randn((d, 16), generator=torch.Generator().manual_seed(
                d)).to(st.U.device)
            Y = st.U @ (st.D[..., None] * (st.U.mT @ X))
            out[f"{name}/{side}"] = Y.float().cpu()
    return out


def _held_blocks(lm, params) -> dict:
    """Every leaf a rank holds is its block: the sharded leaves (each a
    strict block of its whole) and the leaves of another shape."""
    import math
    ms = lm.sp.shards
    sharded = {k: [list(v.shape), list(ms.shapes[k])]
               for k, v in params.items() if ms.sharded(k)}
    wrong = [k for k, v in params.items()
             if tuple(v.shape) != ms.local_shape(k)]
    strict = all(math.prod(a) < math.prod(b) for a, b in sharded.values())
    return {"n_sharded": len(sharded), "n_leaves": len(params),
            "wrong": wrong, "strict": strict,
            "examples": {k: sharded[k] for k in list(sharded)[:4]}}


def tp_rank_slice(rank: int, dev) -> dict:
    """slice_tp on this rank: step 0 in fp32 (its block of the held
    leaves' gradients and updates and the held taps' factors against one
    process's, whose shifts it replays), then the CLI on ``--mesh 1x2``
    in bf16, its step 0 replaying one process's shifts and held likewise
    (per step: wall time, the collectives' bytes, seconds and calls),
    launches, calls by shape, peak memory, the blocks it holds; then the
    builders on the model mesh against the same builders in one process
    on rank 0."""
    import dataclasses
    import gc
    import os
    import tempfile
    import torch
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps, train
    from repro_torch.models.lm import LM
    S = TP_SLICE
    arch = _tp_slice_arch()
    tel = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    args = train.parse_args(_tp_slice_argv(
        ["--mesh", f"1x{S['world']}"]
        + (["--telemetry-dir", tel] if rank == 0 else [])))
    stream = TokenStream(vocab=arch.vocab, batch=S["batch"],
                         seq_len=S["seq"], seed=0, device=dev).batch_at
    marks, tallies, held_mem = [], [], []

    def batches(k):
        torch.cuda.current_stream().synchronize()
        marks.append(time.perf_counter())
        tallies.append({kk: list(v) for kk, v in tally.items()})
        # what the rank holds between steps (parameters, optimizer
        # state, error feedback; the parent's nothing: it holds no tensor
        # on the card then)
        held_mem.append(torch.cuda.memory_allocated())
        return stream(k)
    mesh = mesh_lib.make_mesh((1, S["world"]), ("data", "model"))
    lm = LM(arch, steps.shard_policy_for(mesh), device=torch.device("meta"))
    ms = lm.sp.shards
    block = lambda k, w: ms.block(k, w) if ms.sharded(k) else w
    # one process's step 0 (the parent's), fp32 and bf16, from the same
    # state: its held leaves, new factors (fp32) and continuation shifts
    want = torch.load(os.environ["CHIP_SMOKE_TP_STEP0"], mmap=True)
    arch32 = dataclasses.replace(arch, dtype="float32")
    t_fp32 = time.perf_counter()
    with first_step(_tp_held) as got32, \
            continuation_replay(want["fp32"]["shifts"]) as own32, \
            contextlib.redirect_stdout(io.StringIO()):
        st32, _ = train.run(train.parse_args(_tp_slice_argv(
            ["--mesh", f"1x{S['world']}", "--steps", "1"])), arch=arch32)
    def whole_u(name, side, U):          # the factor's rows gathered
        t = lm.taps[name]
        d = t.d_in if side == "A" else t.d_out
        return (U if U.shape[-2] == d
                else coll.all_gather(U, mesh, "model", U.dim() - 2))
    got32["factors"] = _factor_ops(st32.opt.factors, TP_HELD_TAPS, whole_u)
    del st32
    gc.collect()
    torch.cuda.empty_cache()
    err32 = _step0_errs(got32, want["fp32"], block)
    parted32 = _parted(own32, want["fp32"]["shifts"])
    factors_held = sorted(want["fp32"]["factors"])
    del got32
    t_cli = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    with calls_by_shape() as by_shape, counted_collectives() as tally, \
            first_step(_tp_held) as got16, \
            continuation_replay(want["bf16"]["shifts"], prefix=True) as own16:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            state, losses = train.run(args, arch=arch, batches=batches)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        tallies.append({kk: list(v) for kk, v in tally.items()})
    peak = torch.cuda.max_memory_allocated()
    counts = _build.launch_counts()
    err16 = _step0_errs(got16, want["bf16"], block)
    parted16 = _parted(own16, want["bf16"]["shifts"])
    del got16, want
    kinds = ([e["phase"] for e in _events(tel) if e["type"] == "step"]
             if rank == 0 else None)
    per_step = []
    for k in range(len(losses)):
        row = {"wall_s": marks[k + 1] - marks[k]}
        for kind in tally:
            a, b = tallies[k][kind], tallies[k + 1][kind]
            row[kind] = {"bytes": b[0] - a[0], "s": b[1] - a[1],
                         "calls": b[2] - a[2]}
        per_step.append(row)
    held = _held_blocks(lm, state.params)
    factor_bytes = state.opt.factor_bytes()
    params = {k: v.detach() for k, v in state.params.items()}
    del state
    gc.collect()
    torch.cuda.empty_cache()

    t_builders = time.perf_counter()
    # the builders on the model mesh; rank 0 also runs them in one process
    # on the parameters gathered whole
    whole = shd.globalize(params, lm.param_shardings)
    if rank != 0:
        del whole
        whole = None
    B = 2
    prompt = TokenStream(vocab=arch.vocab, batch=B, seq_len=S["prefill"],
                         seed=1, device=dev).batch_at(0)["tokens"]
    out = {}
    pb = steps.build_prefill_step(arch32, mesh=mesh, device=dev,
                                  cell=ShapeCell("tp_prefill", S["prefill"],
                                                 B, "prefill"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg = pb.step_fn(params, {"tokens": prompt})
    torch.cuda.synchronize()
    out["prefill_s"] = time.perf_counter() - t0
    out["prefill_block"] = list(lg.shape)
    lg = coll.all_gather(lg, mesh, "model", 2)
    if rank == 0:
        one = steps.build_prefill_step(arch32, device=dev, cell=ShapeCell(
            "tp_prefill", S["prefill"], B, "prefill"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = one.step_fn(whole, {"tokens": prompt})
        torch.cuda.synchronize()
        out["prefill_s_one"] = time.perf_counter() - t0
        out["prefill_err_of_scale"] = (float((lg - ref).abs().max())
                                       / float(ref.abs().max()))
        out["finite"] = bool(torch.isfinite(lg).all())
        del ref
    del lg
    torch.cuda.empty_cache()
    decodes = [(layout, "tp_decode", S["cache"], B, 0, S["decode"], False)
               for layout in ("seq", "heads", "hd")]
    decodes.append(("long", "long_500k", S["long"], 1,
                    S["long"] // 2 - S["long_tokens"] // 2,
                    S["long_tokens"], True))
    for name, cell, n_slots, Bd, t0_, n, ring in decodes:
        layout = "seq" if name == "long" else name
        res = {}
        for mode, m in (("tp", mesh), ("one", None)):
            if mode == "one" and rank != 0:
                continue
            db = steps.build_decode_step(
                arch32, mesh=m, device=dev, cache_layout=layout,
                window_caches=ring,
                cell=ShapeCell(cell, n_slots, Bd, "decode"))
            rep = (steps.kv_rep_for(arch32, m)
                   if layout == "heads" and m is not None else 1)
            cache = db.lm.init_cache(Bd, n_slots, window_caches=ring,
                                     kv_rep=rep)
            if m is not None:
                cache = shd.localize(cache, db.in_shardings[1])
            use = params if m is not None else whole
            got = []
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with torch.no_grad():
                for t in range(t0_, t0_ + n):
                    lgd, cache = db.step_fn(use, cache,
                                            prompt[:Bd, t % S["prefill"]:
                                                   t % S["prefill"] + 1], t)
                    got.append(lgd[:, 0])
            torch.cuda.synchronize()
            res[mode] = {"ms": (time.perf_counter() - t1) * 1e3 / n,
                         "logits": torch.stack(got, 1),
                         "cache_k": list(cache["0"]["p0"]["k"].shape)}
            del cache
            torch.cuda.empty_cache()
        row = {"tokens": n, "slots": n_slots, "batch": Bd, "from": t0_,
               "cache_k_block": res["tp"]["cache_k"],
               "ms_per_token": res["tp"]["ms"]}
        if rank == 0:
            row["cache_k_one"] = res["one"]["cache_k"]
            row["ms_per_token_one"] = res["one"]["ms"]
            row["err_of_scale"] = _scale_err(res["tp"]["logits"],
                                             res["one"]["logits"])
            row["finite"] = bool(torch.isfinite(res["tp"]["logits"]).all())
        out[name] = row
        del res
    return {"losses": losses, "kinds": kinds, "steps": per_step,
            "log": buf.getvalue() if rank == 0 else "",
            "peak_mem_bytes": peak, "held_mem_bytes": held_mem,
            "factor_bytes": factor_bytes, "launches": counts,
            "calls_by_shape": dict(by_shape), "held": held,
            "step0_err_fp32": err32, "step0_err_bf16": err16,
            "factors_held": factors_held,
            "shift_rows_parted0": {"fp32": parted32, "bf16": parted16},
            "builders": out,
            "seconds": {"step0_fp32": t_cli - t_fp32,
                        "cli": t_builders - t_cli,
                        "builders": time.perf_counter() - t_builders}}


def tp_rank_reduced(rank: int, dev) -> dict:
    """tp_reduced on this rank: the CLI on ``--mesh 2x2`` (launches, calls
    by shape, collectives), then the replay: every step's tensor-parallel
    update (a tapped leaf's; an AdamW leaf's gradient) and new state
    (gathered) against, on rank 0, the one-process optimizer's from the
    same state, with the gradients and taps of the whole batch from the
    same parameters (gathered whole) and the tensor-parallel step's
    continuation shifts replayed."""
    import torch
    import torch.distributed as dist
    from repro_torch import specs
    from repro_torch.configs.base import get_arch
    from repro_torch.core import kfac as kfac_lib
    from repro_torch.core import tenant
    from repro_torch.data.synthetic import TokenStream, rank_rows
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps, train
    from repro_torch.models import layers
    from repro_torch.models.lm import LM
    from repro_torch.optim import base as optbase
    from repro_torch.train import loop
    import dataclasses
    R = TP_REDUCED
    args = train.parse_args(list(R["argv"]) + [
        "--steps", str(R["steps"]), "--mesh", "2x2", "--device", "cuda"])
    _build.reset_launch_counts()
    with calls_by_shape() as by_shape, counted_collectives() as tally:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            st_cli, losses = train.run(args)
        torch.cuda.synchronize()
    counts = _build.launch_counts()
    cli_tally = {k: list(v) for k, v in tally.items()}

    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"))
    lm = LM(get_arch("gemma3_4b").reduced(), steps.shard_policy_for(mesh),
            remat=False, device=dev)
    held = _held_blocks(lm, st_cli.params)
    del st_cli
    opt = kfac_lib.Kfac(train.kfac_config_of(args), lm.taps, device=dev)
    opt.model_shards = lm.sp.shards
    specs.DistSpec(mesh=mesh, curvature_axis="data").attach(opt)
    one = kfac_lib.Kfac(opt.cfg, opt.taps, device=dev)
    lm1 = LM(lm.arch, remat=False, device=dev)
    eng, sp = opt.curvature, lm.sp
    sched = opt.scheduler()
    draws = numpy_draws(opt, seed=5)
    params = lm.init(torch.Generator(device=dev).manual_seed(0))
    state = opt.init(params)
    stream = TokenStream(vocab=lm.arch.vocab, batch=args.batch,
                         seq_len=args.seq, seed=0, device=dev)
    n_tokens = args.batch * args.seq
    rank0 = dist.get_rank() == 0
    tapped = {t.param_path for t in opt.taps.values()}
    o_sh = train.state_shardings(lm, opt).opt    # the engine's and "model"'s
    whole_state = lambda st: shd.globalize(st, o_sh)
    ms = sp.shards

    def whole_tree(tree):       # a leaf-keyed tree gathered whole, packed
        keys = [k for k in tree if ms.sharded(k)]
        out = {k: v.detach() for k, v in tree.items()}
        out.update(zip(keys, coll.all_gather_coalesced(
            [out[k] for k in keys], mesh, "model",
            [ms.dim(k) for k in keys])))
        return out
    whole = whole_state(state)
    errs, state_errs, loss_errs, parted, worst = [], [], [], [], []
    for k in range(R["steps"]):
        work = sched.work(k)
        batch = stream.batch_at(k)
        local = rank_rows(batch, sp.dp_index, sp.dp_size)
        loss, acts, gp, gprobe = loop.kfac_grads(
            lm.loss_fn, params, layers.make_probes(opt.taps, device=dev),
            local, sp)
        kw = dict(n_tokens=n_tokens, rng=None, work=work, draws=draws(k))
        before = tenant.tree_map(
            lambda x: x.clone() if torch.is_tensor(x) else x,
            whole) if rank0 else None
        wparams, wgp = whole_tree(params), whole_tree(gp)
        with continuation_replay() as shifts:
            upd, state = opt.update(dict(gp), state, params, acts=acts,
                                    probe_grads=gprobe, **kw)
        wupd = whole_tree(upd)
        whole = whole_state(state)
        if rank0:
            wp = {n: v.requires_grad_() for n, v in wparams.items()}
            loss1, acts1, gp1, gprobe1 = loop.kfac_grads(
                lm1.loss_fn, wp, layers.make_probes(opt.taps, device=dev),
                batch)
            with continuation_replay(shifts) as own:
                want, want_state = one.update(gp1, before, wp, acts=acts1,
                                              probe_grads=gprobe1, **kw)
            parted.append(sum(int(((a - b).abs() > 1e-3 * b.abs()).sum())
                              for a, b in zip(shifts, own)))
            rel = lambda a, b: (float((a - b).abs().max())
                                / max(float(b.abs().max()), 1e-30))
            by_name = {n: (rel(wupd[n], w) if n in tapped
                           else rel(wgp[n], gp1[n]))
                       for n, w in want.items()}
            errs.append(max(by_name.values()))
            worst.append(sorted(by_name.items(), key=lambda kv: -kv[1])[:3])
            state_errs.append(_state_err(whole, want_state))
            loss_errs.append(abs(float(loss) - float(loss1))
                             / abs(float(loss1)))
            del want, want_state, wp
        del before, wparams, wgp, wupd
        optbase.apply_updates(params, upd)
    torch.cuda.synchronize()

    # one more step (stats and the Brand update on the factor rows, the
    # preconditioning) with use_kernels=True on the same mesh and state:
    # the row-block kernel route, its launches counted on every rank,
    # against one process's step with use_kernels=True from the same
    # gathered state (rank 0)
    kcfg = dataclasses.replace(opt.cfg, use_kernels=True)
    opt_k = kfac_lib.Kfac(kcfg, lm.taps, device=dev)
    opt_k.model_shards = sp.shards
    specs.DistSpec(mesh=mesh, curvature_axis="data").attach(opt_k)
    one_k = kfac_lib.Kfac(kcfg, opt.taps, device=dev)
    work_k = opt_k.uniform_work(True, True, False)
    batch = stream.batch_at(R["steps"])
    local = rank_rows(batch, sp.dp_index, sp.dp_size)
    loss, acts, gp, gprobe = loop.kfac_grads(
        lm.loss_fn, params, layers.make_probes(opt.taps, device=dev),
        local, sp, keep_blocks=opt_k.probe_blocks())
    kw = dict(n_tokens=n_tokens, rng=None, work=work_k)
    before = tenant.tree_map(lambda x: x.clone() if torch.is_tensor(x)
                             else x, whole) if rank0 else None
    wparams, wgp = whole_tree(params), whole_tree(gp)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    with calls_by_shape() as k_shapes, continuation_replay() as shifts:
        upd, state = opt_k.update(dict(gp), state, params, acts=acts,
                                  probe_grads=gprobe, **kw)
        torch.cuda.synchronize()
    k_counts = _build.launch_counts()
    wupd, whole = whole_tree(upd), whole_state(state)
    kernels_step = {"launches": k_counts, "calls_by_shape": dict(k_shapes)}
    if rank0:
        wp = {n: v.requires_grad_() for n, v in wparams.items()}
        _, acts1, gp1, gprobe1 = loop.kfac_grads(
            lm1.loss_fn, wp, layers.make_probes(opt.taps, device=dev), batch)
        with continuation_replay(shifts):
            want, want_state = one_k.update(gp1, before, wp, acts=acts1,
                                            probe_grads=gprobe1, **kw)
        rel = lambda a, b: (float((a - b).abs().max())
                            / max(float(b.abs().max()), 1e-30))
        by_name = {n: (rel(wupd[n], w) if n in tapped
                       else rel(wgp[n], gp1[n])) for n, w in want.items()}
        kernels_step.update(
            update_rel_err=max(by_name.values()),
            worst=sorted(by_name.items(), key=lambda kv: -kv[1])[:3],
            state_err=_state_err(whole, want_state))
        del want, want_state, wp
    torch.cuda.synchronize()
    return {"losses": losses, "log": buf.getvalue() if rank == 0 else "",
            "launches": counts, "calls_by_shape": dict(by_shape),
            "collectives": cli_tally, "held": held,
            "replay": {"update_rel_err": errs, "state_err": state_errs,
                       "loss_rel_err": loss_errs,
                       "continuation_rows_parted": parted,
                       "worst_updates": worst},
            "kernels_step": kernels_step}


def phase_tp_slice(checked):
    """Path 14 (TP_SLICE): the one-process CLI at the cut first: step 0
    in fp32 (its held leaves' gradients and updates, its continuation
    shifts, the held taps' new factors), the bf16 run (its losses and
    step times, its step 0 recorded likewise), and the witness (bf16 step
    0 again from every initial weight one ulp up, the shifts replayed);
    then the same on ``--mesh 1x2``: two ranks of this card, each holding
    its blocks, the fp32 step 0 at DP_TOL, the bf16 step 0 at
    TP_WITNESS_FACTOR times the witness's parting, the bf16 losses at
    DP_TOL over the DP_HELD steps; each rank's step time by kind, its
    collectives, peak memory, launches; the builders against one
    process's.  Returns the launch counts summed over the ranks."""
    import dataclasses
    import gc
    import math
    import os
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.launch.param_count import count_params
    from repro_torch.models.lm import LM
    S = TP_SLICE
    arch = _tp_slice_arch()
    dev = torch.device("cuda")
    tel = tempfile.mkdtemp(prefix="chip_smoke_tp_one_")

    def free():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    free()
    t_one = time.perf_counter()
    st32, _, f32 = tp_one_step0(dataclasses.replace(arch, dtype="float32"),
                                ["--steps", "1"])
    f32["factors"] = _factor_ops(st32.opt.factors, TP_HELD_TAPS)
    del st32
    free()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    state, one, f16 = tp_one_step0(arch, ["--telemetry-dir", tel])
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    one_peak = torch.cuda.max_memory_allocated() - base
    one_walls = [(e["phase"], e["dt_s"]) for e in _events(tel)
                 if e["type"] == "step"]
    shutil.rmtree(tel, ignore_errors=True)
    del state
    free()
    # the witness: how far rounding alone parts one process's bf16 step 0
    # from itself (PR 23's ``phase_rounding_witness``, with the shifts
    # replayed as the ranks replay them)
    init = LM(arch, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    up = {k: torch.nextafter(v.detach(), torch.full_like(v, math.inf)
                             ).requires_grad_() for k, v in init.items()}
    del init
    _, _, wit = tp_one_step0(arch, ["--steps", "1"], shifts=f16["shifts"],
                             params=up)
    del up
    free()
    witness = _step0_errs(wit, f16)
    del wit
    want_path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_tp_u_"),
                             "step0.pt")
    torch.save({"fp32": f32, "bf16": f16}, want_path)
    del f32, f16
    one_process_s = time.perf_counter() - t_one
    card_free = torch.cuda.mem_get_info()[0]
    _, res, spawn_s = spawn_ranks(
        "tp_slice", S["world"], S["timeout"],
        env_extra={"CHIP_SMOKE_TP_STEP0": want_path})
    shutil.rmtree(os.path.dirname(want_path), ignore_errors=True)
    sl = [g["tp_slice"] for g in res]
    kinds = sl[0]["kinds"]
    drift = [_rel_drift(s["losses"], one) for s in sl]
    for k in range(S["steps"]):
        emit({"phase": "slice_tp", "step": k, "kind": kinds[k],
              "loss": [s["losses"][k] for s in sl], "loss_one": one[k],
              "drift": [d[k] for d in drift],
              "wall_s": [s["steps"][k]["wall_s"] for s in sl],
              "wall_s_one": one_walls[k][1],
              "collectives": [{kind: s["steps"][k][kind] for kind in
                               ("all_reduce", "all_gather",
                                "all_gather_coalesced")} for s in sl]})
    by_kind = {}
    for s in sl:
        for kind, st in zip(kinds, s["steps"]):
            by_kind.setdefault(kind, []).append(st["wall_s"])
    PATH_WALLS["slice_tp"] = by_kind
    counts = {k: sum(s["launches"][k] for s in sl) for k in sl[0]["launches"]}
    missing = [k for k in PATH_KERNELS["slice_tp"] if counts[k] == 0]
    unchecked = sorted({k for s in sl for k in s["calls_by_shape"]
                        if k not in checked})
    bl = [s["builders"] for s in sl]
    err32 = max(max(s["step0_err_fp32"].values()) for s in sl)
    err16 = max(max(s["step0_err_bf16"].values()) for s in sl)
    wit = max(witness.values())
    worst = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:4]
    log = [ln for ln in sl[0]["log"].splitlines()
           if "tensor parallel" in ln or "data parallel" in ln]
    emit({"phase": "slice_tp", "summary": True, "arch": arch.name,
          "world": S["world"], "mesh": {"data": 1, "model": S["world"]},
          "backend": res[0]["backend"], "params": count_params(arch),
          "reduced": {"n_layers": arch.n_layers,
                      "repeats": list(S["repeats"])},
          "argv": _tp_slice_argv(["--mesh", f"1x{S['world']}"]),
          "kinds": kinds, "losses_one": one,
          "max_drift_held": max(max(d[:DP_HELD]) for d in drift),
          "max_drift": max(max(d) for d in drift), "tol": DP_TOL,
          "held_steps": DP_HELD,
          "step0_fp32": {"max_rel_err": err32, "tol": DP_TOL,
                         "worst": [worst(s["step0_err_fp32"]) for s in sl],
                         "by_entry": [s["step0_err_fp32"] for s in sl]},
          "step0_bf16": {"max_rel_err": err16, "witness_max": wit,
                         "limit": TP_WITNESS_FACTOR * wit,
                         "worst": [worst(s["step0_err_bf16"]) for s in sl],
                         "witness_worst": worst(witness),
                         "by_entry": [s["step0_err_bf16"] for s in sl],
                         "witness": witness},
          "shift_rows_parted0": [s["shift_rows_parted0"] for s in sl],
          "held": [s["held"] for s in sl],
          "wall_s_by_kind": by_kind, "wall_s_one": one_walls,
          "one_run_s": one_s, "one_peak_mem_bytes": one_peak,
          "one_process_s": one_process_s,
          "card_free_bytes_at_spawn": card_free,
          "peak_mem_bytes": [s["peak_mem_bytes"] for s in sl],
          "builders": bl, "tp_log": log,
          "launches": counts, "calls_by_shape": [s["calls_by_shape"]
                                                 for s in sl],
          "seconds": {"spawn_to_end": spawn_s,
                      "init": [g["init_s"] for g in res],
                      "run": [g["run_s"] for g in res],
                      "rank": [s["seconds"] for s in sl]},
          "note": "two ranks share one card's SMs and memory, and their "
                  "collectives go through host memory (gloo)"})
    # the factor rows on "model" against PR 25's layout (its run of this
    # phase: every factor whole on each rank, the sharded gradients
    # gathered whole for the preconditioning)
    cost = {}
    for kind in sorted(set(kinds)):
        ks = [k for k, kd in enumerate(kinds) if kd == kind]
        cost[kind] = {
            "wall_s": [[s["steps"][k]["wall_s"] for k in ks] for s in sl],
            "collectives": [{c: {f: [s["steps"][k][c][f] for k in ks]
                                 for f in ("bytes", "s", "calls")}
                             for c in ("all_reduce", "all_gather",
                                       "all_gather_coalesced")}
                            for s in sl]}
    emit({"phase": "slice_tp", "layout_cost": True, "by_kind": cost,
          "held_gb": [[h / 1e9 for h in s["held_mem_bytes"]] for s in sl],
          "peak_gb": [s["peak_mem_bytes"] / 1e9 for s in sl],
          "factor_gb": [s["factor_bytes"] / 1e9 for s in sl],
          "pr25": TP_PR25})
    b0 = bl[0]
    finite = all(np.isfinite(s["losses"]).all() for s in sl)
    held_ok = all(max(d[:DP_HELD]) < DP_TOL for d in drift)
    blocks_ok = all(not s["held"]["wrong"] and s["held"]["strict"]
                    and s["held"]["n_sharded"] > 0 for s in sl)
    decode_ok = all(b0[n]["finite"] and b0[n]["err_of_scale"] <= TP_FP32_TOL
                    for n in ("seq", "heads", "hd", "long"))
    layouts_ok = (b0["seq"]["cache_k_block"][2] * 2
                  == b0["seq"]["cache_k_one"][2]
                  and b0["heads"]["cache_k_block"][3] * 2
                  == b0["heads"]["cache_k_one"][3]
                  and b0["hd"]["cache_k_block"][4] * 2
                  == b0["hd"]["cache_k_one"][4])
    build_ok = (b0["finite"] and b0["prefill_err_of_scale"] <= TP_FP32_TOL
                and b0["prefill_block"][2] * 2 == arch.vocab)
    # every held leaf compared on every rank, in both dtypes, and the
    # held taps' factors in fp32
    entries_ok = len(witness) > 0 and all(
        set(s["step0_err_bf16"]) == set(witness)
        and set(s["step0_err_fp32"]) - set(witness)
        == {f"factors {k}" for k in s["factors_held"]}
        and len(s["factors_held"]) >= 2 * len(TP_HELD_TAPS) for s in sl)
    if (not finite or not held_ok or not blocks_ok or not decode_ok
            or not layouts_ok or not build_ok or not err32 < DP_TOL
            or not err16 <= TP_WITNESS_FACTOR * wit or not entries_ok
            or missing or unchecked or len(kinds) != S["steps"]
            or not any("tensor parallel over model: 2 ranks" in ln
                       for ln in log)):
        raise AssertionError(
            f"slice_tp: finite {finite}, loss drift {drift}, blocks "
            f"{[s['held'] for s in sl]}, step-0 fp32 err {err32}, bf16 "
            f"err {err16} (witness {wit}), held entries {entries_ok}, "
            f"builders {bl}, never launched {missing}, calls at unchecked "
            f"shapes {unchecked}, log {log}")
    return counts


def phase_tp_reduced(checked):
    """tp_reduced (TP_REDUCED) on four ranks of this card; this process
    meanwhile runs the one-process CLI, the oracle of the free-running
    losses.  Every rank must launch each kernel of the path, at shapes
    the ``kernels`` phase held.  Returns the launch counts of the ranks'
    CLI runs, summed."""
    import numpy as np
    import torch
    from repro_torch.launch import train
    R = TP_REDUCED

    def one_process():
        with contextlib.redirect_stdout(io.StringIO()):
            return train.run(train.parse_args(list(R["argv"]) + [
                "--steps", str(R["steps"]), "--device", "cuda"]))[1]
    one, res, spawn_s = spawn_ranks("tp_reduced", R["world"], R["timeout"],
                                    meanwhile=one_process)
    torch.cuda.synchronize()
    sl = [g["tp_reduced"] for g in res]
    drift = [_rel_drift(s["losses"], one) for s in sl]
    replay = sl[0]["replay"]
    err = max(replay["update_rel_err"])
    serr = {f: max(e[f] for e in replay["state_err"])
            for f in replay["state_err"][0]}
    counts = {k: sum(s["launches"][k] for s in sl) for k in sl[0]["launches"]}
    missing = [(r, k) for r, s in enumerate(sl)
               for k in PATH_KERNELS["tp_reduced"] if s["launches"][k] == 0]
    ks = [s["kernels_step"] for s in sl]
    missing += [(r, k) for r, s in enumerate(ks)
                for k in PATH_KERNELS["tp_kernels"] if s["launches"][k] == 0]
    unchecked = sorted({k for s in sl + ks for k in s["calls_by_shape"]
                        if k not in checked})
    k_err = ks[0]["update_rel_err"]
    k_serr = ks[0]["state_err"]
    for k in range(R["steps"]):
        emit({"phase": "tp_reduced", "step": k,
              "loss": [s["losses"][k] for s in sl], "loss_one": one[k],
              "drift": [d[k] for d in drift],
              "update_rel_err": replay["update_rel_err"][k],
              "state_err": replay["state_err"][k],
              "loss_rel_err": replay["loss_rel_err"][k],
              "continuation_rows_parted":
                  replay["continuation_rows_parted"][k],
              "worst_updates": replay["worst_updates"][k]})
    emit({"phase": "tp_reduced", "summary": True, "argv": R["argv"],
          "world": R["world"], "mesh": {"data": 2, "model": 2},
          "backend": res[0]["backend"], "steps": R["steps"],
          "max_drift": max(max(d) for d in drift),
          "max_update_rel_err": err, "max_state_err": serr,
          "tol": DP_TOL, "held": [s["held"] for s in sl],
          "collectives": [s["collectives"] for s in sl],
          "tp_log": [ln for ln in sl[0]["log"].splitlines()
                     if "parallel" in ln or "curvature sharded" in ln],
          "launches": counts, "launches_by_rank": [s["launches"]
                                                   for s in sl],
          "calls_by_shape": [s["calls_by_shape"] for s in sl],
          "seconds": {"spawn_to_end": spawn_s,
                      "init": [g["init_s"] for g in res],
                      "run": [g["run_s"] for g in res]}})
    emit({"phase": "tp_reduced", "kernels_step": True,
          "use_kernels": True, "tol": DP_TOL,
          "update_rel_err": k_err, "worst_updates": ks[0]["worst"],
          "state_err": k_serr,
          "launches_by_rank": [{k: s["launches"][k]
                                for k in PATH_KERNELS["tp_kernels"]}
                               for s in ks],
          "calls_by_shape": [s["calls_by_shape"] for s in ks]})
    finite = all(np.isfinite(s["losses"]).all() for s in sl)
    state_ok = (serr["counters"] == 0
                and all(serr[f] < DP_TOL for f in serr if f != "counters")
                and k_serr["counters"] == 0
                and all(k_serr[f] < DP_TOL for f in k_serr
                        if f != "counters"))
    blocks_ok = all(not s["held"]["wrong"] and s["held"]["strict"]
                    and s["held"]["n_sharded"] > 0 for s in sl)
    if (not finite or max(max(d) for d in drift) >= DP_TOL
            or not err < DP_TOL or not k_err < DP_TOL or not state_ok
            or not blocks_ok
            or max(replay["loss_rel_err"]) >= DP_TOL
            or len(replay["update_rel_err"]) != R["steps"]
            or missing or unchecked):
        raise AssertionError(
            f"tp_reduced: finite {finite}, loss drift {drift}, update rel "
            f"err {err}, state err {serr}, use_kernels step update err "
            f"{k_err} state err {k_serr}, blocks "
            f"{[s['held'] for s in sl]}, replay loss err "
            f"{replay['loss_rel_err']}, never launched (rank, kernel) "
            f"{missing}, calls at unchecked shapes {unchecked}")
    return counts, {k: sum(s["launches"][k] for s in ks)
                    for k in ks[0]["launches"]}


#: each phase's wall seconds in this run (``timed``)
PHASE_SECONDS = {}


def timed(name, fn, *a, **kw):
    """``fn(*a, **kw)``, its wall seconds kept under ``name``."""
    t0 = time.perf_counter()
    try:
        return fn(*a, **kw)
    finally:
        PHASE_SECONDS[name] = time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dist-rank", nargs=4, default=None,
                    metavar=("RANK", "WORLD", "RENDEZVOUS", "OUT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--dp-rank", nargs=5, default=None,
                    metavar=("JOB", "RANK", "WORLD", "RENDEZVOUS", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.dist_rank is not None:
        rank, world, rdv, out = args.dist_rank
        return dist_rank_main(int(rank), int(world), rdv, out)
    if args.dp_rank is not None:
        job, rank, world, rdv, out = args.dp_rank
        return dp_rank_main(job, int(rank), int(world), rdv, out)
    smi = timed("device", phase_device)
    timed("build", phase_build)
    kernels = timed("kernels", phase_kernels)
    timed("agree_bkfac", phase_agree, "bkfac")
    timed("agree_nskfac", phase_agree, "nskfac")
    timed("agree_linear", phase_agree, "bkfac", linear_taps=("fc0", "fc1"))
    timed("agree_async", phase_agree_async)
    timed("agree_sgd", phase_agree_baseline, "slice_sgd")
    timed("agree_seng", phase_agree_baseline, "slice_seng")
    timed("agree_state", phase_agree_state)
    by_path = {}
    by_path["slice"] = timed("slice", phase_path, "slice", "bkfac")
    by_path["slice_nskfac"] = timed("slice_nskfac", phase_path,
                                    "slice_nskfac", "nskfac")
    by_path["slice_linear"] = timed("slice_linear", phase_path,
                                    "slice_linear", "bkfac",
                                    linear_taps=("fc0", "fc1"))
    # B-R-KFAC, 31 steps (the RSVD overwrite inline at 0 and 25), then the
    # same with the step-25 overwrite on the async pipeline's side stream,
    # landing at 30; every kernel call there at a shape checked above
    checked = set().union(*(row["checked"] for row in kernels.values()))
    by_path["slice_brkfac"] = timed("slice_brkfac", phase_path,
                                    "slice_brkfac", "brkfac", steps=31,
                                    checked=checked)
    by_path["slice_async"] = timed("slice_async", phase_path, "slice_async",
                                   "brkfac", steps=31, lag=5,
                                   checked=checked)
    by_path["slice_sgd"] = timed("slice_sgd", phase_baseline, "slice_sgd")
    by_path["slice_seng"] = timed("slice_seng", phase_baseline, "slice_seng")
    # B-KFAC through the whole one-device trainer surface, faults injected
    by_path["slice_resilient"] = timed("slice_resilient", phase_resilient,
                                       checked)
    # the LM stack: all ten architectures reduced, card against CPU; then
    # gemma3-4b at full width under B-KFAC, and its decode
    timed("agree_lm", phase_agree_lm)
    by_path["slice_lm"] = timed("slice_lm", phase_slice_lm, checked)
    # the tenant bank and the serving stack: card against CPU at the
    # reduced config, then two full-width gemma3-4b tenants
    timed("agree_serve", phase_agree_serve)
    by_path["slice_serve"] = timed("slice_serve", phase_slice_serve,
                                   checked)
    # the launch layer: the CLI and the builders card against CPU at the
    # reduced config; the CLI and the builders at gemma3-4b's full width;
    # the CLI's health, checkpoint, async and resume branches reduced
    timed("agree_launch", phase_agree_launch)
    by_path["slice_launch"] = timed("slice_launch", phase_slice_launch,
                                    checked)
    by_path["launch_reduced"] = timed("launch_reduced",
                                      phase_launch_reduced, checked)
    # the distributed curvature engine: one member on nccl, then four
    # ranks of this card on gloo (the taps, the small VGG, the CLI on a
    # 2 × 2 mesh), and B-R-KFAC at full width on a (2, 2) curv × rows mesh
    timed("agree_dist_single", phase_agree_dist_single)
    by_path["slice_dist"] = timed("slice_dist", phase_dist, checked)
    # data-parallel execution of the LM: gemma3-4b at full width on two
    # ranks (--mesh 2x1, --compress), then B-R-KFAC reduced on four ranks
    # with the raw gradient all-reduce
    by_path["slice_dp"] = timed("slice_dp", phase_dp_slice, checked)
    by_path["dp_reduced"] = timed("dp_reduced", phase_dp_reduced, checked)
    # tensor-parallel execution of the LM: gemma3-4b at full width on two
    # ranks (--mesh 1x2, --compress; prefill, decode in each cache layout,
    # the long-context decode), then B-R-KFAC reduced on a 2 × 2 mesh
    by_path["slice_tp"] = timed("slice_tp", phase_tp_slice, checked)
    by_path["tp_reduced"], by_path["tp_kernels"] = timed(
        "tp_reduced", phase_tp_reduced, checked)
    rows = []
    for name, row in kernels.items():
        rows.append({k: row[k] for k in (
            "name", "route", "source", "replaces")} | {
            "launches": sum(c[name] for c in by_path.values()),
            "launches_by_path": {p: c[name] for p, c in by_path.items()}}
            | {k: row[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")})
    emit({"phase": "seconds", "by_phase": PHASE_SECONDS})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
