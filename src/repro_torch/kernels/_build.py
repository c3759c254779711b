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
went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_ROOT = Path(__file__).with_name("_build")
SOURCES = ("ea_syrk.cu", "brand_panel.cu", "cholqr.cu", "precond_fused.cu")
HEADERS = ("gemm.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libkfac_kernels.so"

_lib: Optional[ctypes.CDLL] = None
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
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
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
        self._fn = None
        KERNELS[name] = self

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(load(), self.symbol)
            fn.argtypes = self.argtypes + [P]
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: "
                               f"cudaError {rc}")
        self.launches += 1


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


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


def mat_args(t: torch.Tensor) -> List:
    """(pointer, row stride, batch stride) of a (B, rows, cols) operand."""
    return [P(t.data_ptr()), L(t.stride(1) if t.shape[1] > 1 else t.shape[2]),
            L(t.stride(0) if t.shape[0] > 1 else 0)]


_SMS = 132          # H100 SXM streaming multiprocessors
_TILE = 64          # output tile of the shared GEMM (gemm.cuh BM = BN)
_MIN_K_PER_SPLIT = 256


def split_k(M: int, N: int, K: int, batch: int, sym: bool = False) -> int:
    """Blocks to split a long contraction over when the output has too few
    tiles to fill the card: at most two blocks per SM (rounded down, so no
    SM gets a third while others wait), with at least ``_MIN_K_PER_SPLIT``
    of K per split.  A symmetric product (``sym``, M == N) computes only
    the tiles on or above the diagonal."""
    tm, tn = -(-M // _TILE), -(-N // _TILE)
    tiles = (tm * (tm + 1) // 2 if sym else tm * tn) * batch
    return max(1, min(2 * _SMS // tiles, K // _MIN_K_PER_SPLIT, 64))


def workspace(splits: int, batch: int, M: int, N: int,
              like: torch.Tensor) -> torch.Tensor:
    """Split-K partial sums, (splits, batch, M, N); empty when unsplit."""
    shape = (splits, batch, M, N) if splits > 1 else (0,)
    return torch.empty(shape, device=like.device, dtype=torch.float32)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return P(t.data_ptr() if t.numel() else 0)
