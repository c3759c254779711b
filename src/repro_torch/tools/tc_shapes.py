"""``ns_gemm_update`` and ``a_perp`` at every shape the paper VGG's paths
give them, by device time.

    PYTHONPATH=src python -m repro_torch.tools.tc_shapes [--label NAME]

Times the two wrappers (``ns_inverse.gemm_update_batched``,
``brand_panel.a_perp_batched``) as the ``repro_torch`` package on the path
builds them: ``ns_gemm_update`` at every NS bucket of NS-KFAC (both
launches of a Newton–Schulz step, T = M̂X and X' = 2X − XT) and
``a_perp`` at fc0 with a contiguous U and at every Brand bucket with U as
the path passes it (the ``[..., :230]`` slice of the (B, d, 486) state).
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

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels import brand_panel as bp
from repro_torch.kernels import ns_inverse as ns
from repro_torch.kernels import ref
from repro_torch.tools.pipe_splits import graph_ms

#: (stack, d) of NS-KFAC's NS buckets and B-KFAC's Brand buckets on the
#: paper's VGG16_bn (as chip_smoke.py's NS_BUCKETS and BRAND_BUCKETS)
NS_BUCKETS = ((2, 2304), (2, 2048), (2, 1152), (2, 576), (4, 512),
              (2, 256), (2, 128), (2, 64), (1, 27), (1, 10))
BRAND_BUCKETS = ((1, 16384), (3, 4608), (2, 2304), (2, 2048), (2, 1152),
                 (2, 576), (4, 512))


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
    args = ap.parse_args(argv)
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

    for b, d in NS_BUCKETS:
        Mh = (lambda a: a @ a.mT / d)(rnd(b, d, d)).contiguous()
        X = 0.1 * rnd(b, d, d)
        T = (Mh @ X).contiguous()
        report("ns_gemm_update", [b, d], "T = M̂X",
               lambda: ns.gemm_update_batched(None, Mh, X, 0.0, 1.0),
               ref.gemm_update(None, Mh, X, 0.0, 1.0))
        report("ns_gemm_update", [b, d], "X' = 2X − XT",
               lambda: ns.gemm_update_batched(X, X, T, 2.0, -1.0),
               ref.gemm_update(X, X, T, 2.0, -1.0))
    for i, (b, d) in enumerate(BRAND_BUCKETS + ((1, 16384),)):
        contiguous = i == len(BRAND_BUCKETS)
        Q = torch.linalg.qr(rnd(b, d, 230 if contiguous else 486))[0]
        U = Q.contiguous()[..., :230]
        A = rnd(b, d, 256)
        C = ref.ut_a(U, A).contiguous()
        report("a_perp", [b, d], f"U ld {U.stride(1)}",
               lambda: bp.a_perp_batched(A, U, C), ref.a_perp(A, U, C))
    return 0


if __name__ == "__main__":
    sys.exit(main())
