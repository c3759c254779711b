"""Multi-pod dry-run: each (architecture × input-shape) cell's step on the
production meshes, run eagerly on meta tensors over a fake world.

Counterpart of ``src/repro/launch/dryrun.py``, which lowers and compiles
each cell's jitted step on 256 or 512 host devices and reads XLA's memory
and cost analyses.  Here the process joins ``torch.distributed``'s
single-process ``fake`` backend as rank 0 of a world of ``prod(shape)``
ranks (:func:`fake_world`), builds the production mesh over it
(``launch/mesh.py``: 16×16 ``data, model`` or 2×16×16 ``pod, data,
model``), and runs the builders' own step (``launch/steps.py``) once on
meta tensors: shapes and dtypes flow, nothing is computed or allocated,
and every collective goes to the fake backend, which returns at once.
The step's inputs are the builders' meta trees (``abstract_params``,
``abstract_opt``, ``batch_specs``, ``arg_specs``) cut to rank 0's blocks
under ``in_shardings`` (rank 0's block is never smaller than another
rank's).  The train step runs the reference's default work
(``uniform_work(do_stats=True, do_light=True, do_heavy=False)``) on an
optimizer state past its first update (a first step runs first, on
meta, uncounted); ``--opt fsdp`` builds it under
``plan="fsdp"``, ``--opt kvopt`` the decode step with the "heads" cache
and window caches, as the reference does.

While the step runs, :func:`_analyse` counts (one record a cell, with the
reference's keys, so one reader takes either):

  * ``dot_flops`` / ``dot_flops_by_dtype``: the matmul flops of rank 0
    (``launch/hlo_analysis.py::DotCounter``); ``flops`` is the same
    number (the port has no count of the other ops);
  * ``collective_bytes`` / ``collectives``: what rank 0's collectives
    move in the reference's convention (``collectives.counting``), and,
    port-only, ``collectives_by_name`` (the bytes handed in and the calls
    by function) and ``collective_bytes_by_axis``;
  * ``argument_size_in_bytes``: rank 0's parameters, optimizer state and
    batch (decode: parameters, cache, token and position);
    ``output_size_in_bytes``: what the step returns;
    ``temp_size_in_bytes``: the peak of live bytes during the step beyond
    the arguments (:class:`LiveBytes`: each new storage's bytes added
    when an op makes it, taken off when it is freed); port-only
    ``held_bytes`` (the state the train step hands back: parameters,
    optimizer state, a compression carry), ``param_bytes``,
    ``factor_bytes`` and ``peak_bytes`` (arguments + temp);
  * ``model_flops`` (6·N_active·D for training), ``useful_flops_ratio``
    and ``roofline`` (:func:`roofline_terms`);
  * ``trace_s`` (the step's wall time on meta) in place of the
    reference's ``lower_s`` and ``compile_s``.

The reference corrects XLA's count of a scanned layer stack (its cost
analysis visits a loop body once) with unrolled probe lowerings.  The
port loops over every repeat, so nothing is undercounted: the
``*_corrected`` keys equal the uncorrected ones and ``--no-probes`` is
accepted and changes nothing.

Two decisions the reference's traced program makes without values are
host reads in an eager step, so the dry-run fixes them by argument: a
data-parallel rank's MoE buffer rows are ⌈C / data ranks⌉ (the
reference's GSPMD block of the global buffer: evenly routed tokens;
``moe_capacity="even"`` of the builders, named in the record as
``moe_capacity_rule``), and the NS-KFAC inverse's LU repair
(``core/kfactor.py``), off the default B-KFAC path, is not reached.  A
cell that cannot run ends ``failed`` with the port's exception; nothing
falls back to another plan, layout or mesh.  The dry-run launches no
kernel: the builders' default ``use_kernels=False`` runs the plain
versions, on meta.

Usage (a process of its own: it joins the fake world)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3_4b \\
        --shape train_4k [--multi-pod | --both-meshes] [--opt fsdp] [--force]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

Records land in ``results/dryrun_torch/<arch>__<shape>__<mesh>[__opt].json``
(cached; ``--force`` runs again).  The roofline's constants are datasheet
figures of the NVIDIA H100 80GB HBM3 (SXM5, 700 W), not measurements.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs.base import (ARCH_NAMES, SHAPES, ShapeCell,
                                      cell_applicable, get_arch)
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shd
from repro_torch.launch import hlo_analysis, steps
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.param_count import model_flops_per_token

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
META = torch.device("meta")

# NVIDIA H100 80GB HBM3 (SXM5, 700 W) datasheet figures, not measurements
PEAK_BF16 = 989e12       # dense bf16 tensor-core FLOP/s
PEAK_FP32 = 67e12        # fp32 FLOP/s (TF32 off, as the port runs)
HBM_BW = 3.35e12         # HBM3 bytes/s
NET_BW = 50e9            # bytes/s a GPU: one 400 Gb/s NDR port
NVLINK_BW = 450e9        # bytes/s a GPU, NVLink 4, one direction
NODE_GPUS = 8            # GPUs of one NVLink node

#: a data-parallel rank's MoE buffer rows in the dry-run
MOE_CAPACITY_RULE = ("even: ceil(C / data ranks) rows a rank, the "
                     "reference's GSPMD block of the global buffer "
                     "(evenly routed tokens)")


def fake_world(n: int) -> None:
    """This process as rank 0 of a world of ``n`` ranks on the
    single-process ``fake`` backend (a world of another size or backend
    is left first)."""
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------

def _tensors(tree) -> list:
    """The tensors of a tree of dicts, lists, tuples and dataclasses."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in _tensors(getattr(tree, f.name))]
    return []


def tree_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree`` (a view adds
    nothing to its base)."""
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages alive while entered: :meth:`track` adds
    given tensors' storages (a step's arguments), and every storage an op
    makes is added when made and taken off when freed; ``peak`` is the
    largest sum seen."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._sizes: Dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def track(self, tree) -> None:
        for t in _tensors(tree):
            st = t.untyped_storage()
            key = id(st)
            if key in self._sizes:
                continue
            self._sizes[key] = st.nbytes()
            self.live += self._sizes[key]
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.track([t for t in tree_flatten(out)[0]
                    if isinstance(t, torch.Tensor)])
        return out


# ---------------------------------------------------------------------------
# the step of a cell
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Traced:
    """A cell's built step and rank 0's arguments on meta, ready for
    :func:`_analyse` (the reference's ``Lowered``).  ``run(*args)`` → the
    step's outputs; a train step's ``held(outputs)`` → the trees a rank
    keeps for the next step; ``args`` is handed over by :meth:`take`."""
    run: Callable
    args: list
    held: Optional[Callable]
    built: Any
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def take(self) -> list:
        args, self.args = self.args, []
        return args


def _cell(shape) -> ShapeCell:
    return SHAPES[shape] if isinstance(shape, str) else shape


def _lower_cell(arch, shape, mesh, unroll: bool = False, opt: str = "", *,
                flags: Optional[Dict[str, bool]] = None, first: bool = False,
                compress: bool = False, kfac_config=None) -> Traced:
    """The cell's step on ``mesh`` (a ``launch/mesh.py`` mesh over any
    world; its device meta for a dry-run) with rank 0's meta arguments.
    ``shape`` is a ``SHAPES`` name or any ``ShapeCell``.  Port-only
    knobs, for holding the dry-run against a run of the same step: the
    train step's ``flags`` (default: stats and light), ``first`` (the
    optimizer state as ``init`` leaves it, so the step takes the Brand
    init branch), ``compress`` (the trainer CLI's ``--compress`` step:
    ``train/loop.py::make_scheduled_kfac_step`` with PowerSGD, its carry
    held) and ``kfac_config`` (the builder's).  The decode step writes
    the last slot of its cache."""
    cell = _cell(shape)
    dev = mesh.device
    if cell.kind == "train":
        tb = steps.build_train_step(
            arch, mesh, cell=cell, unroll=unroll,
            plan="fsdp" if opt == "fsdp" else "tp", flags=flags, device=dev,
            kfac_config=kfac_config, moe_capacity="even")
        p_sh, o_sh, b_sh = tb.in_shardings[:3]
        params = {k: v.requires_grad_()
                  for k, v in shd.localize(tb.abstract_params, p_sh).items()}
        state = shd.localize(tb.abstract_opt, o_sh)
        batch = shd.localize(tb.batch_specs, b_sh)
        notes = {"param_bytes": tree_bytes(params),
                 "factor_bytes": state.factor_bytes()}
        if not compress:
            run = lambda p, s, b: tb.step_fn(p, s, b, None)
            held = lambda out: out[:2]
            args = [params, state, batch]
        else:
            from repro_torch.distributed import compress as compress_lib
            from repro_torch.train import loop as loop_lib
            sp = tb.lm.sp
            ccfg = compress_lib.CompressConfig(rank=8)
            step = loop_lib.make_scheduled_kfac_step(
                tb.lm.loss_fn, tb.opt, steps.n_tokens_of(arch, cell),
                grad_transform=lambda gp, cs: compress_lib.compress_tree(
                    gp, cs, ccfg, sp=sp), sp=sp)
            work = tb.opt.uniform_work(**(flags or dict(
                do_stats=True, do_light=True, do_heavy=False)))

            def run(p, s, b, cs):
                st, loss, cs = step(loop_lib.TrainState(params=p, opt=s,
                                                        rng=None),
                                    b, work, cstate=cs)
                return st.params, st.opt, loss, cs
            held = lambda out: (out[0], out[1], out[3])
            args = [params, state, batch,
                    compress_lib.init_state(params, ccfg, sp=sp)]
        del params, state
        if not first:
            # past the first update: the state a first step leaves, its
            # storages laid out as a run's are
            held_args = held(run(*args))
            args = [*held_args[:2], batch, *held_args[2:]]
            del held_args
        return Traced(run, args, held, tb, notes)
    if cell.kind == "prefill":
        bs = steps.build_prefill_step(arch, mesh, cell=cell, unroll=unroll,
                                      device=dev, moe_capacity="even")
        params = shd.localize(bs.abstract_params, bs.in_shardings[0])
        batch = shd.localize(bs.arg_specs[0], bs.in_shardings[1])
        return Traced(bs.step_fn, [params, batch], None, bs,
                      {"param_bytes": tree_bytes(params)})
    kv = dict(cache_layout="heads", window_caches=True) \
        if opt == "kvopt" else {}
    bs = steps.build_decode_step(arch, mesh, cell=cell, unroll=unroll,
                                 device=dev, moe_capacity="even", **kv)
    params = shd.localize(bs.abstract_params, bs.in_shardings[0])
    cache, token, t_spec = (shd.localize(x, s) for x, s in
                            zip(bs.arg_specs, bs.in_shardings[1:]))
    S_self = (max(cell.seq_len // arch.dec_ratio, 64) if arch.is_encdec
              else cell.seq_len)
    t = S_self - 1

    @torch.no_grad()
    def run(p, c, tok, _t):
        return bs.step_fn(p, c, tok, t)
    return Traced(run, [params, cache, token, t_spec], None, bs,
                  {"param_bytes": tree_bytes(params), "decode_t": t})


def _analyse(traced: Traced, n_devices: int) -> Dict[str, Any]:
    """Run the traced step once under the counters → the record's
    measured keys (module docstring)."""
    args = traced.take()
    arg_bytes = tree_bytes(args)
    mem, dots = LiveBytes(), hlo_analysis.DotCounter()
    t0 = time.perf_counter()
    with coll.counting() as tally, dots, mem:
        mem.track(args)
        out = traced.run(*args)
        del args
    trace_s = time.perf_counter() - t0
    coll_total, by_kind = hlo_analysis.collective_bytes(tally)
    dot = hlo_analysis.dot_flops(dots)
    out_bytes = tree_bytes(out)
    rec = {
        "flops": dot,
        "dot_flops": dot,
        "dot_flops_by_dtype": hlo_analysis.dot_flops_by_dtype(dots),
        "collective_bytes": float(coll_total),
        "collectives": by_kind,
        "collectives_by_name": {k: {"bytes": v[0], "calls": v[1]}
                                for k, v in tally.by_name.items()},
        "collective_bytes_by_axis": dict(tally.by_axis),
        "n_devices": n_devices,
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": out_bytes,
        "temp_size_in_bytes": max(mem.peak - arg_bytes, 0),
        "peak_bytes": mem.peak,
        "trace_s": trace_s,
    }
    if traced.held is not None:
        rec["held_bytes"] = tree_bytes(traced.held(out))
    rec["bytes"] = float(arg_bytes + out_bytes + rec["temp_size_in_bytes"])
    rec.update(traced.notes)
    for key in ("flops", "dot_flops", "bytes", "collective_bytes"):
        rec[key + "_corrected"] = rec[key]
    return rec


def link_bw(mesh, axis_tag: str) -> float:
    """Bytes/s a GPU over an axis (or "+"-joined axes): NVLink when rank
    0's group of it lies inside one NODE_GPUS node, else the network."""
    names = axis_tag.split("+")
    shape = dict(zip(mesh.axis_names, mesh.devices.shape))
    stride, span = 1, 0
    for a in reversed(mesh.axis_names):
        if a in names:
            span += (shape[a] - 1) * stride
        stride *= shape[a]
    return NVLINK_BW if span < NODE_GPUS else NET_BW


def roofline_terms(rec: Dict, n_devices: int) -> Dict:
    """Three roofline terms (seconds) of one rank: compute (bf16 and fp16
    products at PEAK_BF16, the others at PEAK_FP32; the reference has one
    peak for every dot), memory (argument + output + temp bytes over
    HBM_BW, each buffer read or written about once a step, as the
    reference models it) and collectives (each axis's bytes over its
    link, ``link_bw``; the total over NET_BW where the record has no
    split).  Datasheet constants, not measurements."""
    by_dtype = rec.get("dot_flops_by_dtype") or {
        "bfloat16": rec.get("dot_flops_corrected", rec["dot_flops"])}
    t_comp = sum(f / (PEAK_BF16 if k in ("bfloat16", "float16")
                      else PEAK_FP32) for k, f in by_dtype.items())
    b = (rec.get("argument_size_in_bytes", 0)
         + rec.get("output_size_in_bytes", 0)
         + rec.get("temp_size_in_bytes", 0)) or rec["bytes"]
    t_mem = b / HBM_BW
    links = rec.get("link_bw_by_axis") or {}
    by_axis = rec.get("collective_bytes_by_axis") or {}
    if by_axis and all(a in links for a in by_axis):
        t_coll = sum(v / links[a] for a, v in by_axis.items())
    else:
        t_coll = rec.get("collective_bytes_corrected",
                         rec["collective_bytes"]) / NET_BW
    dom = max((t_comp, "compute"), (t_mem, "memory"), (t_coll, "collective"))
    return {"t_compute_s": t_comp, "t_memory_s": t_mem,
            "t_collective_s": t_coll, "bottleneck": dom[1],
            "roofline_fraction": (max(t_comp, 1e-30)
                                  / max(t_comp, t_mem, t_coll))}


def analyse_cell(arch, shape, mesh, opt: str = "", **kw) -> Dict:
    """:func:`_lower_cell` and :func:`_analyse` of one cell on ``mesh``,
    with the model flops and the roofline (any ``ArchConfig``,
    ``ShapeCell`` and mesh; ``kw`` are ``_lower_cell``'s knobs)."""
    cell = _cell(shape)
    rec = _analyse(_lower_cell(arch, cell, mesh, opt=opt, **kw), mesh.size)
    rec["moe_capacity_rule"] = MOE_CAPACITY_RULE
    rec["link_bw_by_axis"] = {a: link_bw(mesh, a)
                              for a in rec["collective_bytes_by_axis"]}
    rec["roofline"] = roofline_terms(rec, mesh.size)
    if cell.kind == "train":
        n_tok = steps.n_tokens_of(arch, cell)
    else:
        n_tok = cell.global_batch * (cell.seq_len
                                     if cell.kind == "prefill" else 1)
    rec["model_flops"] = model_flops_per_token(
        arch, train=(cell.kind == "train")) * n_tok
    rec["useful_flops_ratio"] = rec["model_flops"] / max(
        rec["dot_flops_corrected"] * rec["n_devices"], 1.0)
    return rec


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             probes: bool = True, force: bool = False, opt: str = "") -> Dict:
    """One cell on a production mesh in a fake world of its size → its
    record (cached under RESULTS_DIR; ``probes`` has no effect)."""
    del probes
    os.makedirs(RESULTS_DIR, exist_ok=True)
    mesh_tag = "pod2x16x16" if multi_pod else "pod16x16"
    suffix = f"__{opt}" if opt else ""
    out_path = os.path.join(
        RESULTS_DIR, f"{arch_name}__{shape_name}__{mesh_tag}{suffix}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)
    arch = get_arch(arch_name)
    ok, reason = cell_applicable(arch, shape_name)
    rec: Dict = {"arch": arch_name, "shape": shape_name, "mesh": mesh_tag,
                 "opt": opt, "time": time.time()}
    if not ok:
        rec.update(status="skipped", reason=reason)
    else:
        fake_world(512 if multi_pod else 256)
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                             device=META)
        t0 = time.time()
        try:
            rec.update(analyse_cell(arch, shape_name, mesh, opt=opt))
            rec["status"] = "ok"
        except Exception as e:
            rec.update(status="failed", error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc(limit=8),
                       trace_s=time.time() - t0)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--opt", default="", choices=("", "kvopt", "fsdp"))
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in ARCH_NAMES for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]
    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    for a, s in cells:
        for mp in meshes:
            t0 = time.time()
            rec = run_cell(a, s, mp, probes=not args.no_probes,
                           force=args.force, opt=args.opt)
            status = rec.get("status")
            extra = (f" bottleneck={rec['roofline']['bottleneck']}"
                     if "roofline" in rec else "")
            print(f"[dryrun] {a} {s} multi_pod={mp}: {status} "
                  f"({time.time() - t0:.0f}s){extra}", flush=True)
            if status == "ok":
                print(f"  dot_flops={rec['dot_flops']:.3e} "
                      f"coll={rec['collective_bytes']:.3e} "
                      f"arg_bytes={rec['argument_size_in_bytes']:,} "
                      f"temp_bytes={rec['temp_size_in_bytes']:,}",
                      flush=True)
            elif status == "failed":
                print(f"  FAILED {rec['error']}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
