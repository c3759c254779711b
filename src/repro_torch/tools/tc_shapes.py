"""The tensor-core kernels (``ns_gemm_update``, ``a_perp``, ``ea_syrk``,
``syrk_tn``, ``precond_panel``, ``precond_apply``, ``lowrank_apply``) at
every shape the paper VGG's paths give them, by device time.

    PYTHONPATH=src python -m repro_torch.tools.tc_shapes [--label NAME]
        [--kernels ea_syrk,syrk_tn]

Times the seven wrappers (``ns_inverse.gemm_update_batched``,
``brand_panel.a_perp_batched``, ``ea_syrk.ea_syrk_batched``,
``cholqr.syrk_tn_batched``, ``precond_fused.precond_panel_batched``,
``precond_apply_batched`` and ``lowrank_apply.lowrank_apply_batched``) as
the ``repro_torch`` package on the path builds them: ``ns_gemm_update``
at every NS bucket of NS-KFAC (both launches of a Newton–Schulz step,
T = M̂X and X' = 2X − XT);
``a_perp`` at fc0 with a contiguous U and at every Brand bucket with U as
the path passes it (the ``[..., :230]`` slice of the (B, d, 486) state);
``ea_syrk`` at every dense bucket of both paths, X (B, d, 256); and
``syrk_tn`` at every Brand bucket's A⊥ (B, d, 256) and the RSVD range
finder's (2, 256, 240) panel; both ``precond_fused`` passes at every
precond bucket of B-KFAC (``PRECOND_BUCKETS``: J (B, p, d) in parameter
layout, U_g (B, p, w_g), U_a (B, d, w_a)), the apply pass with the plain
version's Cg; ``lowrank_apply`` at every launch of NS-KFAC and the Alg-8
taps (``LOWRANK_CASES``) in the layout the path hands it, then in the
other layout (a package whose wrapper takes X only by rows gets the
columns cases copied to rows first, as its ``ops.lowrank_apply`` copies
them, and the copy is timed with the kernel).  ``--kernels`` picks some
of them.
Each case: the device time of one call from 20 replayed as one CUDA graph,
and the eager time over 20 back-to-back calls (CUDA events), with the
largest difference from the plain version.  One JSON line per case,
tagged with ``--label``.  The wrappers' signatures are those of every
version of the port since the kernels landed, so the script also times an
older checkout: run it as a file with that checkout's ``src`` first on
``PYTHONPATH``, from the same call, to compare two versions on one card
(old, new, new, old).  It needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels import brand_panel as bp
from repro_torch.kernels import cholqr as cq
from repro_torch.kernels import ea_syrk as ea
from repro_torch.kernels import lowrank_apply as la
from repro_torch.kernels import ns_inverse as ns
from repro_torch.kernels import precond_fused as pf
from repro_torch.kernels import ref
from repro_torch.tools.pipe_splits import graph_ms

#: (stack, d) of NS-KFAC's NS buckets and B-KFAC's Brand buckets on the
#: paper's VGG16_bn (as chip_smoke.py's NS_BUCKETS and BRAND_BUCKETS)
NS_BUCKETS = ((2, 2304), (2, 2048), (2, 1152), (2, 576), (4, 512),
              (2, 256), (2, 128), (2, 64), (1, 27), (1, 10))
BRAND_BUCKETS = ((1, 16384), (3, 4608), (2, 2304), (2, 2048), (2, 1152),
                 (2, 576), (4, 512))
#: (stack, p, d, w_g, w_a) of B-KFAC's precond buckets on the paper's
#: VGG16_bn, J in parameter layout (d_in, d_out), U_g the A side's U (a
#: Brand factor's d × 486, or conv0_0's 27 × 27), U_a the G side's (Brand,
#: EVD or RSVD); fc0 first.  Under Alg 8 (``slice_linear``) fc0 and fc1
#: take lowrank_apply instead.  chip_smoke.py and the tests read it here.
PRECOND_BUCKETS = ((1, 16384, 2048, 486, 486), (3, 4608, 512, 486, 486),
                   (1, 2304, 512, 486, 486), (1, 2304, 256, 486, 230),
                   (1, 1152, 256, 486, 230), (1, 1152, 128, 486, 128),
                   (1, 576, 128, 486, 128), (1, 576, 64, 486, 64),
                   (1, 2048, 10, 486, 10), (1, 27, 64, 27, 64))
#: (stack, p, d, w, columns) of every lowrank_apply launch of the paper's
#: VGG16_bn paths, X (B, p, d), U (B, d, w).  NS-KFAC (``slice_nskfac``,
#: 11 calls each): fc0 and the conv4 bucket, the left application's X,
#: the transposed view of a contiguous (B, d, p) — its columns are
#: contiguous.  The Alg-8 taps (``slice_linear``): fc0's A side (11
#: calls), fc0's G side and fc1's A side (22), fc1's G side (w = 10, 11),
#: X the stats rows with contiguous rows.  chip_smoke.py and the tests
#: read it here.
LOWRANK_CASES = ((1, 2048, 16384, 486, True), (3, 512, 4608, 486, True),
                 (1, 256, 16384, 486, False), (1, 256, 2048, 486, False),
                 (1, 256, 10, 10, False))


def eager_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--kernels", default="ns_gemm_update,a_perp,ea_syrk,"
                    "syrk_tn,precond_panel,precond_apply,lowrank_apply",
                    help="comma-separated kernels to time")
    args = ap.parse_args(argv)
    kernels = set(args.kernels.split(","))
    if not torch.cuda.is_available():
        print("tc_shapes: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    B.load()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    side = torch.cuda.Stream()
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)

    def report(kernel, shape, launch, fn, want):
        err = float((fn() - want).abs().max())
        print(json.dumps({"label": args.label, "kernel": kernel,
                          "shape": shape, "launch": launch,
                          "device_ms": graph_ms(fn, side, reps=20),
                          "ms": eager_ms(fn), "max_abs_err": err}),
              flush=True)

    for b, d in NS_BUCKETS if "ns_gemm_update" in kernels else ():
        Mh = (lambda a: a @ a.mT / d)(rnd(b, d, d)).contiguous()
        X = 0.1 * rnd(b, d, d)
        T = (Mh @ X).contiguous()
        report("ns_gemm_update", [b, d], "T = M̂X",
               lambda: ns.gemm_update_batched(None, Mh, X, 0.0, 1.0),
               ref.gemm_update(None, Mh, X, 0.0, 1.0))
        report("ns_gemm_update", [b, d], "X' = 2X − XT",
               lambda: ns.gemm_update_batched(X, X, T, 2.0, -1.0),
               ref.gemm_update(X, X, T, 2.0, -1.0))
    for i, (b, d) in enumerate(BRAND_BUCKETS + ((1, 16384),)
                               if "a_perp" in kernels else ()):
        contiguous = i == len(BRAND_BUCKETS)
        Q = torch.linalg.qr(rnd(b, d, 230 if contiguous else 486))[0]
        U = Q.contiguous()[..., :230]
        A = rnd(b, d, 256)
        C = ref.ut_a(U, A).contiguous()
        report("a_perp", [b, d], f"U ld {U.stride(1)}",
               lambda: bp.a_perp_batched(A, U, C), ref.a_perp(A, U, C))
    # ea_syrk's keep and coef as ops.ea_syrk computes them in fp32
    keep = float(np.float32(0.95))
    coef = float(np.float32(1.0) - np.float32(0.95))
    for b, d in NS_BUCKETS if "ea_syrk" in kernels else ():
        M = (lambda m: (m + m.mT) / 2)(rnd(b, d, d)).contiguous()
        X = rnd(b, d, 256)
        report("ea_syrk", [b, d], "X (B, d, 256)",
               lambda: ea.ea_syrk_batched(M, X, keep, coef),
               ref.ea_syrk(M, X, 0.95, False))
    for b, d, n in (tuple((b, d, 256) for b, d in BRAND_BUCKETS)
                    + ((2, 256, 240),) if "syrk_tn" in kernels else ()):
        A = rnd(b, d, n)
        report("syrk_tn", [b, d, n], f"n {n}",
               lambda: cq.syrk_tn_batched(A), ref.syrk_tn(A))
    orth = lambda *s: torch.linalg.qr(rnd(*s))[0].contiguous()
    for b, p, d, wg, wa in (PRECOND_BUCKETS if kernels & {
            "precond_panel", "precond_apply"} else ()):
        J, Ug, Ua = rnd(b, p, d), orth(b, p, wg), orth(b, d, wa)
        sg, sa = -rnd(b, wg).abs(), -rnd(b, wa).abs()
        ilg, ila = 1.0 + rnd(b).abs(), 1.0 + rnd(b).abs()
        Cg = ref.precond_panel(Ug, J, sg).contiguous()
        if "precond_panel" in kernels:
            report("precond_panel", [b, p, d], f"w_g {wg}",
                   lambda: pf.precond_panel_batched(Ug, J, sg), Cg)
        if "precond_apply" in kernels:
            report("precond_apply", [b, p, d], f"w_g {wg} w_a {wa}",
                   lambda: pf.precond_apply_batched(J, Ug, Cg, Ua, sa, ilg,
                                                    ila),
                   ref.precond_apply(J, Ug, Cg, Ua, sa, 1.0 / ilg,
                                     1.0 / ila))
    # the path's layout of each launch, then the other
    takes_columns = hasattr(la, "columns")
    for b, p, d, w, cols in (
            LOWRANK_CASES + tuple(c[:4] + (not c[4],) for c in LOWRANK_CASES)
            if "lowrank_apply" in kernels else ()):
        X = rnd(b, d, p).mT if cols else rnd(b, p, d)
        U, s = orth(b, d, w), -rnd(b, w).abs()
        il = 1.0 + rnd(b).abs()
        launch = f"w {w} " + ("columns" if cols else "rows")
        if cols and not takes_columns:
            launch += " (copied to rows)"
            fn = lambda: la.lowrank_apply_batched(X.contiguous(), U, s, il)
        else:
            fn = lambda: la.lowrank_apply_batched(X, U, s, il)
        report("lowrank_apply", [b, p, d], launch, fn,
               ref.lowrank_apply(X, U, s, 1.0 / il))
    return 0


if __name__ == "__main__":
    sys.exit(main())
