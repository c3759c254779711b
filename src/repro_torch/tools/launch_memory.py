"""Device memory of the trainer CLI (``launch/train.py``) at gemma3-4b's
full width with ``--compress``, at several depth cuts: which is the
deepest that fits one card.

    PYTHONPATH=src python -m repro_torch.tools.launch_memory \\
        [--layers 3,1 4,1] [--steps 2] [--expandable] [--stages] \\
        [--ranks 2 | --mesh 1x2]

Each ``--layers`` gives the repeats of gemma3-4b's two segments (3,1: 22
of its 34 layers).  Each cut runs the CLI's defaults (batch 4 × 64,
``default_kfac_config``, stagger on) with ``--compress`` for ``--steps``
steps (the first is the Brand states' first update) and prints one JSON
line: parameters, the memory held after the run's build (parameters,
optimizer state, error feedback), the peak, and an out-of-memory failure
with the peak it reached (not raised).  ``--expandable`` turns on the
allocator's expandable segments first, as ``chip_smoke.py`` runs with
them; ``--stages`` adds the peak of each stage of each step (forward and
backward, compression, the optimizer update).  ``--ranks N`` runs each
cut data-parallel on ``--mesh Nx1``: N processes of this tool on the one
card (gloo), each on its rows of the batch, each printing its own line
(``rank``) — the card holds the N ranks' peaks together.  ``--mesh
DxM`` runs each cut on that mesh instead (axes data, model: M > 1 is
tensor-parallel, each rank holding its blocks of the sharded
parameters and its row blocks of the factors), on D·M processes.  Each
line also gives the factor state a rank holds after the run
(``factor_gb``: U, D, M and aux, the curvature engine's M blocks
included).  It needs one CUDA card.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed

from repro_torch.configs.base import get_arch
from repro_torch.core import kfac as kfac_lib
from repro_torch.data.synthetic import TokenStream
from repro_torch.distributed import compress as compress_lib
from repro_torch.launch import train as train_lib
from repro_torch.launch.param_count import count_params
from repro_torch.train import loop as loop_lib

GB = 1e9


#: the step's stages: (module, attribute) of each function whose peak is
#: read on its own (``--stages``)
STAGES = {"backward": (loop_lib, "kfac_grads"),
          "compress": (compress_lib, "compress_tree"),
          "update": (kfac_lib.Kfac, "update")}


@contextlib.contextmanager
def stage_peaks():
    """{stage: [peak bytes of each call]} while the block runs: the peak
    statistic is reset as each stage starts and read as it ends."""
    peaks = {name: [] for name in STAGES}
    saved = []
    for name, (owner, attr) in STAGES.items():
        fn = getattr(owner, attr)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            try:
                return _fn(*a, **kw)
            finally:    # out of memory too: the peak it reached
                peaks[_name].append(torch.cuda.max_memory_allocated())
        setattr(owner, attr, wrapped)
        saved.append((owner, attr, fn))
    try:
        yield peaks
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def measure(repeats, steps: int, stages: bool = False,
            mesh: str = "none") -> dict:
    """One CLI run at gemma3-4b cut to ``repeats`` → its JSON line (with
    ``stages``, each stage's peak a step, the whole step's unread); on a
    ``mesh`` (DxM) this process is one of its ranks."""
    arch = get_arch("gemma3_4b").with_repeats(repeats)
    ranks = mesh_ranks(mesh)
    args = train_lib.parse_args(
        ["--compress", "--steps", str(steps), "--metrics-every", "0"]
        + (["--mesh", mesh] if ranks > 1 else []))
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    stream = TokenStream(vocab=arch.vocab, batch=args.batch,
                         seq_len=args.seq, seed=0,
                         device=torch.device("cuda")).batch_at
    held = []

    def batches(k):
        # the CLI asks for step k's batch just before the step: what is
        # allocated then is the run's standing memory (after its build,
        # then after each step)
        held.append(torch.cuda.memory_allocated() - base)
        return stream(k)

    err = None
    losses = []
    by_stage = {}
    pk = None
    factor_bytes = None
    try:
        with (stage_peaks() if stages else contextlib.nullcontext()) as pk:
            state, losses = train_lib.run(args, arch=arch, batches=batches)
            torch.cuda.synchronize()
        factor_bytes = state.opt.factor_bytes()
        del state
    except torch.OutOfMemoryError as e:
        err = str(e).splitlines()[0]
    by_stage = {k: [(v - base) / GB for v in vs]
                for k, vs in (pk or {}).items()}
    peak = torch.cuda.max_memory_allocated() - base
    gc.collect()
    torch.cuda.empty_cache()
    return {"case": "cli_compress", "repeats": list(repeats),
            "ranks": ranks, "mesh": mesh,
            "rank": (torch.distributed.get_rank() if ranks > 1 else 0),
            "n_layers": arch.n_layers, "params": count_params(arch),
            "batch": [args.batch, args.seq], "steps": steps,
            "held_gb": held[0] / GB if held else None,
            "held_gb_by_step": [h / GB for h in held],
            "peak_gb": peak / GB,
            "factor_gb": (None if factor_bytes is None
                          else factor_bytes / GB),
            **({"stage_peaks_gb": by_stage} if stages else {}),
            "losses": losses, "oom": err}


def mesh_ranks(mesh: str) -> int:
    """The processes of a ``DxM`` mesh (1 for ``none``)."""
    if mesh in ("none", ""):
        return 1
    n = 1
    for x in mesh.split("x"):
        n *= int(x)
    return n


def spawn(argv, ranks: int) -> int:
    """This tool's ``argv`` on ``ranks`` processes of one gloo world
    (file rendezvous in a fresh temporary directory); each prints its own
    lines."""
    rdv = os.path.join(tempfile.mkdtemp(prefix="launch_memory_"), "rdv")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.tools.launch_memory", *argv,
         "--rank", str(r), rdv]) for r in range(ranks)]
    # a rank that ran out of memory exits at once; the others would wait
    # in their next collective, so they are stopped
    while any(p.poll() is None for p in procs):
        if any(p.poll() not in (None, 0) for p in procs):
            for p in procs:
                if p.poll() is None:
                    p.kill()
        time.sleep(1.0)
    return max(p.returncode for p in procs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", nargs="+", default=["3,1", "4,1"])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--expandable", action="store_true")
    ap.add_argument("--stages", action="store_true",
                    help="also the peak of each stage of a step: the "
                         "forward and backward, the compression, the "
                         "optimizer update")
    ap.add_argument("--ranks", type=int, default=1,
                    help="data-parallel ranks on the card (--mesh Nx1)")
    ap.add_argument("--mesh", default="",
                    help="DxM (data, model) mesh of ranks on the card; "
                         "M > 1 is tensor-parallel (overrides --ranks)")
    ap.add_argument("--rank", nargs=2, default=None,
                    metavar=("RANK", "RENDEZVOUS"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    mesh = args.mesh or (f"{args.ranks}x1" if args.ranks > 1 else "none")
    ranks = mesh_ranks(mesh)
    if ranks > 1 and args.rank is None:
        argv = list(sys.argv[1:] if argv is None else argv)
        rc = spawn(argv, ranks)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
        return rc
    if args.rank is not None:
        from repro_torch.launch import mesh as mesh_lib
        mesh_lib.init_process_group(
            None, init_method=f"file://{args.rank[1]}",
            rank=int(args.rank[0]), world_size=ranks)
    if args.expandable:
        set_allocator = (getattr(torch._C,
                                 "_accelerator_setAllocatorSettings", None)
                         or torch.cuda.memory._set_allocator_settings)
        set_allocator("expandable_segments:True")
    for layers in args.layers:
        reps = tuple(int(r) for r in layers.split(","))
        line = measure(reps, args.steps, args.stages, mesh)
        print(json.dumps(line), flush=True)
        if args.rank is not None and line["oom"]:
            os._exit(1)
    if args.rank is not None:
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
