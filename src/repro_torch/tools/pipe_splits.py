"""How the pipelined GEMM's split-K choice plays out on the card.

    PYTHONPATH=src python -m repro_torch.tools.pipe_splits

``ut_a`` and ``rinv_apply`` run on ``csrc/sgemm_pipe.cuh``, which splits a
contraction over ``splits`` blocks grouped into clusters of ``cluster``
(``_build.pipe_split`` picks the pair from the card's cluster occupancy).
This script prints the occupancy table the choice reads (blocks resident
at once, by cluster size, one or two blocks an SM), then times each kernel
at the path's shapes for its chosen pair and a few others (some of which
need a second wave of clusters), each beside one
``torch.bmm`` call computing the same product: device time of 50 launches
replayed from a CUDA graph (no host launch overhead), so the pairs compare
the kernel's own time.  One JSON line per (shape, pair); ``chosen`` marks
the pair the wrappers take.  It needs one CUDA card.
"""
from __future__ import annotations

import json
import sys

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels import brand_panel as bp
from repro_torch.kernels import cholqr as cq
from repro_torch.kernels import ref

#: (splits, cluster) pairs tried beside the chosen one
UT_A_PAIRS = ((64, 8), (56, 8), (60, 4), (28, 4), (32, 2), (12, 6), (8, 8),
              (4, 4))
RINV_PAIRS = ((1, 1), (2, 2), (3, 3), (4, 4), (6, 6), (8, 8))
#: (stack, d) of the Brand buckets of a B-KFAC light step on the paper's
#: VGG16_bn, then the RSVD range finder's panel (rinv_apply only)
BUCKETS = ((1, 16384), (3, 4608), (2, 2304), (2, 2048), (2, 1152),
           (2, 576), (4, 512))


def graph_ms(fn, side: torch.cuda.Stream, reps: int = 50) -> float:
    """Device time of one ``fn`` call, from ``reps`` calls replayed as one
    CUDA graph captured on ``side``."""
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
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


def launcher(kernel, out, args, dims, M, N, batch, splits, cluster):
    """A call of ``kernel``'s C entry point (operand ``args``, then the
    output, workspace and counters, then ``batch``, ``dims``, ``splits``
    and ``cluster``) with its own workspace for an M × N output."""
    tiles = B.pipe_tiles(M, N)
    g = splits // cluster
    ws = torch.empty((g * batch * tiles * B.PIPE_TILE ** 2 if g > 1 else 0,),
                     device=out.device)
    counters = B.arrival_counters(batch * tiles * cluster, out)
    return lambda: kernel(*args, B.ptr(out), B.ptr(ws), counters.data_ptr(),
                          batch, *dims, splits, cluster)


def main() -> int:
    if not torch.cuda.is_available():
        print("pipe_splits: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    B.load()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "resident_blocks": {
                          f"{c}x{k}": B.resident_blocks(c, k)
                          for c in range(1, B.PIPE_MAX_CLUSTER + 1)
                          for k in (1, 2)}}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    side = torch.cuda.Stream()
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)

    def report(name, shape, pairs, chosen, make, want, library):
        lib_ms = graph_ms(library, side)
        for splits, cluster in dict.fromkeys((chosen,) + pairs):
            fn, out = make(splits, cluster)
            fn()
            err = float((out - want).abs().max())
            print(json.dumps({
                "kernel": name, "shape": shape, "splits": splits,
                "cluster": cluster, "chosen": (splits, cluster) == chosen,
                "ms": graph_ms(fn, side), "bmm_ms": lib_ms,
                "max_abs_err": err}), flush=True)

    for b, d in BUCKETS:
        # U as the path passes it: the [..., :230] slice of a (b, d, 486)
        U = torch.linalg.qr(rnd(b, d, 486))[0].contiguous()[..., :230]
        A = rnd(b, d, 256)
        C = torch.empty((b, 230, 256), device=dev)
        pairs = tuple(p for p in UT_A_PAIRS if d // p[0] >= B.PIPE_BK)
        report("ut_a", [b, d, 230, 256], pairs,
               B.pipe_split(230, 256, d, b, B.resident_blocks),
               lambda s, c: (launcher(bp.UT_A, C,
                                      B.mat_args(U) + B.mat_args(A),
                                      (d, 230, 256), 230, 256, b, s, c), C),
               ref.ut_a(U, A), lambda: torch.bmm(U.mT, A))
    for b, d, n in tuple((b, d, 256) for b, d in BUCKETS) + ((2, 256, 240),):
        A = rnd(b, d, n)
        R = rnd(b, n, n) / n ** 0.5
        Q = torch.empty_like(A)
        pairs = tuple(p for p in RINV_PAIRS if n // p[0] >= B.PIPE_BK)
        report("rinv_apply", [b, d, n], pairs,
               B.pipe_split(d, n, n, b, B.resident_blocks),
               lambda s, c: (launcher(cq.RINV_APPLY, Q,
                                      B.mat_args(A) + B.mat_args(R),
                                      (d, n), d, n, b, s, c), Q),
               ref.rinv_apply(A, R), lambda: torch.bmm(A, R))
    return 0


if __name__ == "__main__":
    sys.exit(main())
