"""Build, load and launch the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled by ``nvcc`` for ``sm_90a`` (one process per
source, all started together) and linked into one shared library with a
plain C interface, loaded with ``ctypes``.  The build happens at first use,
into ``_build/<hash of the sources>/`` beside this file (listed in
``.gitignore``), so an edited source rebuilds and an unchanged one loads
the library already there.  Nothing here runs at import time: the CPU
tests import every module of the package on a host with no ``nvcc``.

Each kernel entry point is a :class:`Kernel`: it launches on the current
torch stream, raises if the C function reports a launch error, and counts
its launches (``launch_counts``), so a run can show that its main path
went through the kernels; launches from a stream other than the device's
default stream (the async pipeline's side stream) are also counted apart
(``side_launch_counts``).  The counts are kept under a lock: the async
pipeline launches kernels from a worker thread too.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_ROOT = Path(__file__).with_name("_build")
SOURCES = ("ea_syrk.cu", "brand_panel.cu", "cholqr.cu", "precond_fused.cu",
           "ns_inverse.cu", "lowrank_apply.cu", "tc_products.cu")
HEADERS = ("gemm_common.cuh", "sgemm_pipe.cuh", "tc_gemm.cuh",
           "tc_products.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libkfac_kernels.so"

_lib: Optional[ctypes.CDLL] = None
_LOAD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
KERNELS: Dict[str, "Kernel"] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def build() -> Path:
    """Compile every source in parallel and link the library; returns its
    path.  A library already built from the same sources is reused.
    ``nvcc``'s output (``-Xptxas -v``: registers, shared memory, spills) is
    kept in ``build.log`` beside the library."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # one builder at a time across processes (the ranks of a mesh): the
    # others wait on the lock and find the library built
    with open(out.parent / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            _compile(out)
    return out


def _compile(out: Path) -> None:
    nvcc = _nvcc()
    log = out.parent / "build.log"
    procs = []
    with open(log, "w") as fh:
        for src in SOURCES:
            obj = out.parent / (Path(src).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            fh.write(f"== {src} (rc {proc.returncode})\n{text}\n")
            if proc.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}; see {log}")
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             "-Xcompiler", "-fPIC", *(str(o) for _, o, _ in procs),
             "-o", str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        fh.write(f"== link (rc {link.returncode})\n{link.stdout}\n")
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed; see {log}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _LOAD_LOCK:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
    return _lib


def build_timed() -> float:
    """Build (or find) and load the library; returns the seconds taken."""
    t0 = time.perf_counter()
    load()
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# launching
# ---------------------------------------------------------------------------

P = ctypes.c_void_p      # device pointer or stream
L = ctypes.c_longlong    # stride
I = ctypes.c_int
F = ctypes.c_float


class Kernel:
    """One C entry point of the library, with its launch count."""

    def __init__(self, name: str, symbol: str, argtypes: Sequence):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.side_launches = 0
        self._fn = None
        KERNELS[name] = self

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(load(), self.symbol)
            fn.argtypes = self.argtypes + [P]
            fn.restype = ctypes.c_int
            self._fn = fn
        stream = torch.cuda.current_stream()
        rc = self._fn(*args, stream.cuda_stream)
        if rc != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: "
                               f"cudaError {rc}")
        self.count(stream.cuda_stream
                   != torch.cuda.default_stream(stream.device).cuda_stream)

    def count(self, side: bool) -> None:
        """One launch more (``side``: from a non-default stream)."""
        with _COUNT_LOCK:
            self.launches += 1
            self.side_launches += int(side)


def launch_counts() -> Dict[str, int]:
    with _COUNT_LOCK:
        return {name: k.launches for name, k in KERNELS.items()}


def side_launch_counts() -> Dict[str, int]:
    """Launches from a stream other than the device's default stream."""
    with _COUNT_LOCK:
        return {name: k.side_launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for k in KERNELS.values():
            k.launches = k.side_launches = 0


# ---------------------------------------------------------------------------
# argument checks shared by the wrappers
# ---------------------------------------------------------------------------

def check_stack(kernel: str, batch: int, **mats: torch.Tensor) -> None:
    """Every operand: an fp32 CUDA tensor of shape (batch, rows, cols) whose
    rows are contiguous (stride 1 along the last axis; the row and batch
    strides are passed to the kernel, so column slices and a batch
    stride of 0 — one matrix shared by the stack — need no copy)."""
    for name, t in mats.items():
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{kernel}: {name} must be a tensor")
        if t.dtype != torch.float32:
            raise ValueError(f"{kernel}: {name} must be float32, got "
                             f"{t.dtype}")
        if t.dim() != 3 or t.shape[0] != batch or min(t.shape) == 0:
            raise ValueError(f"{kernel}: {name} must be a non-empty "
                             f"({batch}, rows, cols), got {tuple(t.shape)}")
        if t.shape[2] > 1 and t.stride(2) != 1:
            raise ValueError(f"{kernel}: rows of {name} must be contiguous "
                             f"(strides {t.stride()})")
        if t.device.type != "cuda":
            raise ValueError(f"{kernel}: {name} must be a CUDA tensor, got "
                             f"{t.device}")


def check_vec(kernel: str, batch: int, length: int, **vecs) -> None:
    """Per-element vectors: contiguous fp32 CUDA (batch, length)."""
    for name, t in vecs.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{kernel}: {name} must be float32")
        if tuple(t.shape) != (batch, length) or t.stride(-1) != 1:
            raise ValueError(f"{kernel}: {name} must be a contiguous "
                             f"({batch}, {length}), got {tuple(t.shape)}")
        if t.device.type != "cuda":
            raise ValueError(f"{kernel}: {name} must be a CUDA tensor")


def check_shape(kernel: str, name: str, t: torch.Tensor,
                shape: Sequence[int]) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def mat_args(t: torch.Tensor) -> List[int]:
    """(pointer, row stride, batch stride) of a (B, rows, cols) operand, as
    plain ints (ctypes converts them by the entry point's argtypes)."""
    return [t.data_ptr(), t.stride(1) if t.shape[1] > 1 else t.shape[2],
            t.stride(0) if t.shape[0] > 1 else 0]


TC_TILE = 128       # output tile of the tensor-core GEMM (tc_gemm.cuh)
TC_BK = 32          # its k-step
TC_MAX_SPLIT = 8    # its largest cluster
TC_FIXED = 2        # a block's fixed cost in its k-steps (tc_plan)
PIPE_TILE = 128     # output tile of the pipelined GEMM (sgemm_pipe.cuh)
PIPE_BK = 16        # its k-step
PIPE_MAX_CLUSTER = 8


def pipe_tiles(M: int, N: int) -> int:
    return -(-M // PIPE_TILE) * -(-N // PIPE_TILE)


def pipe_split(M: int, N: int, K: int, batch: int,
               resident: Callable[[int, int], int]) -> Tuple[int, int]:
    """(splits, cluster) of a product on the pipelined GEMM, split over K
    when its output has few 128 × 128 tiles.

    ``resident(c, per_sm)`` is the number of blocks the card holds at once
    in clusters of c blocks with ``per_sm`` (1 or 2) blocks an SM.  A
    cluster must sit within one GPC, so clusters of 3 or more spread over
    fewer SMs (120 of 132 on an H100) and hold two blocks an SM only up to
    a limit; a launch past that packs two blocks on some SMs and not on
    others, or needs a second wave.  The time of a launch is modelled as
    (blocks an SM) × (16-deep k-steps a block), plus the final reduction
    of the G = splits / cluster cluster partials of a tile, which one
    block reads alone (G / cluster, in the same units).  The choice with
    the least modelled time wins, fewer splits on a tie; no split is left
    empty."""
    tiles = pipe_tiles(M, N) * batch

    def ktiles(s: int) -> int:   # k-steps of a split (the kernel's kchunk)
        return -(-(-(-K // s)) // PIPE_BK)

    layers = 1 if tiles <= resident(1, 1) else 2 * -(-tiles // resident(1, 2))
    best = (layers * ktiles(1), 1, 1)
    for cluster in range(2, PIPE_MAX_CLUSTER + 1):
        for s in range(cluster, 65, cluster):
            if -(-K // (ktiles(s) * PIPE_BK)) < s:   # a split would be empty
                break
            blocks = tiles * s
            if blocks <= resident(cluster, 1):
                layers = 1
            elif blocks <= resident(cluster, 2):
                layers = 2
            else:
                break
            cost = layers * ktiles(s) + (s // cluster - 1) / cluster
            best = min(best, (cost, s, cluster))
    return best[1], best[2]


_RESIDENT: Dict[Tuple[int, int, int], int] = {}


def resident_blocks(cluster: int, per_sm: int) -> int:
    """Blocks of the pipelined GEMM the current card holds at once in
    clusters of ``cluster``, ``per_sm`` (1 or 2) an SM
    (cudaOccupancyMaxActiveClusters), cached."""
    key = (torch.cuda.current_device(), cluster, per_sm)
    if key not in _RESIDENT:
        fn = load().kfk_pipe_resident_blocks
        fn.argtypes, fn.restype = [I, I], ctypes.c_int
        n = fn(cluster, per_sm)
        if n <= 0:
            raise RuntimeError(f"cluster occupancy query failed: "
                               f"cudaError {-n}")
        _RESIDENT[key] = n
    return _RESIDENT[key]


_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def arrival_counters(n: int, like: torch.Tensor) -> torch.Tensor:
    """At least ``n`` int32 arrival counters for the split-K of the
    pipelined and the tensor-core GEMM, one buffer per device and stream.
    Zeroed once, when allocated; every launch leaves them at 0 (the last
    block to arrive on a counter resets it), so launches on one stream can
    share them."""
    key = (like.device.index,
           torch.cuda.current_stream(like.device).cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), device=like.device, dtype=torch.int32)
        _COUNTERS[key] = buf
    return buf


@functools.lru_cache(maxsize=None)
def _pipe_split_cached(M: int, N: int, K: int, batch: int,
                       device: int) -> Tuple[int, int]:
    return pipe_split(M, N, K, batch, resident_blocks)


def pipe_launch_args(M: int, N: int, K: int, batch: int,
                     like: torch.Tensor) -> List:
    """[ws, counters, splits, cluster] for a launch of the pipelined GEMM
    on ``like``'s card: the split choice (cached by shape), and the
    workspace (splits / cluster, batch, tiles, 128, 128) and arrival
    counters only when more than one cluster shares a tile (one cluster
    sums in distributed shared memory and writes C itself)."""
    splits, cluster = _pipe_split_cached(M, N, K, batch, like.device.index)
    # the workspace is freed on return, after the launch is queued: the
    # caching allocator hands it out again only to later work on the stream
    if splits == cluster:
        return [0, 0, splits, cluster]
    tiles = pipe_tiles(M, N)
    ws = torch.empty((splits // cluster, batch, tiles, PIPE_TILE, PIPE_TILE),
                     device=like.device, dtype=torch.float32)
    counters = arrival_counters(batch * tiles * cluster, like)
    return [ws.data_ptr(), counters.data_ptr(), splits, cluster]


def tc_tiles(M: int, N: int, sym: bool = False) -> int:
    """Output tiles of a tensor-core GEMM launch: under ``sym`` (M == N)
    only those on or above the diagonal."""
    t = -(-M // TC_TILE)
    return t * (t + 1) // 2 if sym else t * -(-N // TC_TILE)


def tc_plan(M: int, N: int, K: int, batch: int,
            resident: Callable[[int], int],
            sym: bool = False) -> Tuple[int, int]:
    """(splits, cluster) of a product on the tensor-core GEMM: K split over
    ``splits`` blocks in clusters of ``cluster`` ≤ 8.

    ``resident(c)`` is the number of blocks the card holds at once in
    clusters of c, one block an SM (a cluster sits within one GPC, so
    clusters of 3 or more reach fewer SMs).  A launch is modelled as
    (waves of blocks) × (32-deep k-steps a block + ``TC_FIXED`` for a
    block's own fixed cost: filling the ring, the epilogue), plus one
    k-step for the cluster launch and its sum of the partial tiles when
    split.  More than one cluster a tile (splits = G · cluster) is tried
    only where one cluster of 8 a tile leaves SMs idle, and only in one
    wave; it costs one k-step more for the workspace and the arrival
    counters, and (G − 1) / cluster for the last block's sum of the G
    cluster partials.  The least modelled time wins, fewer splits on a
    tie; no split is left empty.  ``sym``: only the triangle's tiles."""
    tiles = tc_tiles(M, N, sym) * batch

    def ktiles(s: int) -> int:   # k-steps of a split (the kernel's kchunk)
        return -(-(-(-K // s)) // TC_BK)

    def empty(s: int) -> bool:   # the last split would get no k
        return (s - 1) * ktiles(s) * TC_BK >= K

    best = (-(-tiles // resident(1)) * (ktiles(1) + TC_FIXED), 1, 1)
    for s in range(2, TC_MAX_SPLIT + 1):
        if empty(s):
            continue
        waves = -(-tiles * s // resident(s))
        best = min(best, (waves * (ktiles(s) + TC_FIXED) + 1, s, s))
    if tiles * TC_MAX_SPLIT < resident(TC_MAX_SPLIT):
        for c in range(2, TC_MAX_SPLIT + 1):
            for s in range(2 * c, resident(c) // tiles + 1, c):
                if empty(s):
                    continue
                cost = ktiles(s) + TC_FIXED + 2 + (s // c - 1) / c
                best = min(best, (cost, s, c))
    return best[1], best[2]


def tc_split(M: int, N: int, K: int, batch: int,
             resident: Callable[[int], int]) -> int:
    """The splits of ``tc_plan`` for a general (not symmetric) product."""
    return tc_plan(M, N, K, batch, resident)[0]


_TC_RESIDENT: Dict[Tuple[int, int], int] = {}


def tc_resident_blocks(cluster: int) -> int:
    """Blocks of the tensor-core GEMM the current card holds at once in
    clusters of ``cluster`` (cudaOccupancyMaxActiveClusters), cached."""
    key = (torch.cuda.current_device(), cluster)
    if key not in _TC_RESIDENT:
        fn = load().kfk_tc_resident_blocks
        fn.argtypes, fn.restype = [I], ctypes.c_int
        n = fn(cluster)
        if n <= 0:
            raise RuntimeError(f"cluster occupancy query failed: "
                               f"cudaError {-n}")
        _TC_RESIDENT[key] = n
    return _TC_RESIDENT[key]


@functools.lru_cache(maxsize=None)
def _tc_plan_cached(M: int, N: int, K: int, batch: int, sym: bool,
                    device: int) -> Tuple[int, int]:
    return tc_plan(M, N, K, batch, tc_resident_blocks, sym)


def tc_launch_args(M: int, N: int, K: int, batch: int, like: torch.Tensor,
                   sym: bool = False) -> List:
    """[ws, counters, splits, cluster] for a launch of the tensor-core GEMM
    on ``like``'s card: the plan (cached by shape), and the workspace
    (splits / cluster, batch, tiles, 128, 128) and arrival counters only
    when more than one cluster shares a tile."""
    splits, cluster = _tc_plan_cached(M, N, K, batch, sym,
                                      like.device.index)
    if splits == cluster:
        return [0, 0, splits, cluster]
    tiles = tc_tiles(M, N, sym)
    ws = torch.empty((splits // cluster, batch, tiles, TC_TILE, TC_TILE),
                     device=like.device, dtype=torch.float32)
    counters = arrival_counters(batch * tiles * cluster, like)
    return [ws.data_ptr(), counters.data_ptr(), splits, cluster]


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr() if t.numel() else 0
