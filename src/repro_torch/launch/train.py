"""Production trainer entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3_4b \\
        --steps 100 [--variant bkfac] [--ckpt-dir /path] [--compress] \\
        [--reduced] [--device cpu]
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
        -m repro_torch.launch.train --reduced --mesh 2x2 \\
        --mesh-axes data,curv [--curvature-compress 4]

Counterpart of ``src/repro/launch/train.py``: the model zoo, the K-FAC
optimizer (``launch/steps.py::default_kfac_config``; ``--reduced`` trains
the family's CPU-scale config with the reference's small-model settings),
the deterministic ``TokenStream``, async checkpoints, the straggler
detector, telemetry, the profiler, the async heavy pipeline, the health
guards with the remediation ladder, and optional PowerSGD gradient
compression (``distributed/compress.py``).  Every flag is the
reference's, with its default, plus ``--device`` (default: the card; a
host without one raises).

``--mesh AxB[xC]`` (with ``--mesh-axes``; ``16x16`` and ``2x16x16`` are
the production meshes) builds a ``launch/mesh.py`` mesh over the ranks of
``torch.distributed.run`` (one process is one member; at one rank the
CLI sets up its own one-member world), and ``--curvature auto`` picks the
curvature engine's axes as the reference does: a ``curv`` axis larger
than 1 takes the factor slots and the next data axis larger than 1 the
dense-M rows, else the first data axis takes the slots.  The batch is
split over every axis but ``model`` (data parallelism, the reference's
``batch_sharding``): each rank trains on its block of the global
``TokenStream`` batch, and the loss, the taps' statistics rows and the
gradients (or, with ``--compress``, PowerSGD's panels) are summed over
those axes, so every rank takes the reference's one-device step on the
global batch.  Rank 0 alone writes the log, the telemetry and the
checkpoints (the gathered, one-device format); the health guards and the
telemetry read the global loss.  A ``model`` axis larger than 1
(``--mesh 1x2``, ``--mesh 2x2`` with the default axes ``data,model``)
runs tensor-parallel (``launch/steps.py``): each rank holds its block of
every sharded parameter and of its AdamW moments, the optimizer gathers
the sharded gradients bucket by bucket (rank 0 logs the bytes a step),
and the checkpoints stay the one-device format: the parameters and the
optimizer state are gathered (``distributed/sharding.py::globalize``)
before rank 0 writes them, and a restore lays them out again
(``shardings=``).

Steps run eagerly (the reference jits one program per work mask).
:func:`run` is the CLI without the parsing: tests and ``chip_smoke.py``
hand it a depth-cut arch, initial parameters, batches and heavy-op draws.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed

from repro_torch import device as device_lib
from repro_torch import specs as specs_lib
from repro_torch.configs.base import ARCH_NAMES, ArchConfig, get_arch
from repro_torch.core import kfac as kfac_lib
from repro_torch.core import policy as policy_lib
from repro_torch.data.synthetic import TokenStream, rank_rows
from repro_torch.distributed import compress as compress_lib
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models.lm import LM
from repro_torch.obs import events as obs_events
from repro_torch.obs import trace as obs_trace
from repro_torch.optim import base as optbase
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import health as health_lib
from repro_torch.train import loop as loop_lib
from repro_torch.train import straggler as strag_lib

Tensor = torch.Tensor


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma3_4b", choices=ARCH_NAMES)
    ap.add_argument("--variant", default="bkfac",
                    choices=list(policy_lib.VARIANTS))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--mesh", default="none",
                    help="none | 16x16 | 2x16x16 | AxB (custom)")
    ap.add_argument("--mesh-axes", default="",
                    help="comma-separated axis names for a custom --mesh "
                         "AxB, e.g. 'data,curv' for the 2D data × "
                         "curvature mesh (default: data,model)")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-scale config of the same family")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--compress", action="store_true",
                    help="PowerSGD-style DP gradient compression (error "
                         "feedback + warm-started power iteration)")
    ap.add_argument("--curvature-compress", type=int, default=0,
                    help="rank-q compression of the curvature engine's "
                         "(U, λ) cross-axis gathers (0 = raw gathers); "
                         "lossy")
    ap.add_argument("--stagger", dest="stagger", action="store_true",
                    default=True,
                    help="phase heavy factor work across the T_inv window "
                         "(constant per-step cost instead of a spike)")
    ap.add_argument("--no-stagger", dest="stagger", action="store_false")
    ap.add_argument("--stagger-splits", type=int, default=4,
                    help="max entry-aligned chunks per factor bucket")
    ap.add_argument("--async-heavy", dest="async_heavy",
                    action="store_true",
                    help="two-phase launch/land heavy pipeline: heavy "
                         "overwrites compute against a snapshot on a side "
                         "stream and swap in --heavy-lag steps later")
    ap.add_argument("--heavy-lag", type=int, default=2,
                    help="steps between a heavy launch (snapshot) and "
                         "its landing (swap-in); 0 = same-step")
    ap.add_argument("--curvature", default="auto",
                    choices=("auto", "none"),
                    help="auto: shard factor work across the mesh's first "
                         "data axis (distributed curvature engine)")
    ap.add_argument("--health", action="store_true",
                    help="health guards + staged remediation ladder (skip "
                         "/ damping escalation / forced refresh / "
                         "checkpoint rollback — the last needs "
                         "--ckpt-dir).  Bit-inert on healthy runs")
    ap.add_argument("--telemetry-dir", default="",
                    help="write the JSONL event log to "
                         "<dir>/events.jsonl (feed it to `python -m "
                         "repro_torch.obs.summary`)")
    ap.add_argument("--metrics-every", type=int, default=10,
                    help="curvature-metric flush cadence in steps (needs "
                         "--telemetry-dir; 0 disables)")
    ap.add_argument("--profile-dir", default="",
                    help="write a torch.profiler trace of a short step "
                         "window into this directory")
    ap.add_argument("--profile-steps", type=int, default=3,
                    help="steps in the --profile-dir trace window")
    ap.add_argument("--device", default=None,
                    help="default: cuda (a host without a card raises)")
    return ap.parse_args(argv)


def reduced_kfac_config(variant: str) -> kfac_lib.KfacConfig:
    """``--reduced``'s optimizer settings (the reference's)."""
    return kfac_lib.KfacConfig(
        policy=policy_lib.PolicyConfig(variant=variant, r=32,
                                       max_dense_dim=1024),
        lr=optbase.constant(0.02), damping_phi=optbase.constant(0.1),
        weight_decay=1e-4, clip=0.5, T_updt=2, T_inv=10, T_brand=2,
        T_rsvd=10, T_corct=10, fallback_lr=optbase.constant(3e-3))


def kfac_config_of(args) -> kfac_lib.KfacConfig:
    """The optimizer config the CLI trains with for ``args``."""
    kcfg = (reduced_kfac_config(args.variant) if args.reduced
            else steps_lib.default_kfac_config(None, args.variant))
    return dataclasses.replace(
        kcfg, stagger=args.stagger, stagger_splits=args.stagger_splits,
        async_heavy=args.async_heavy,
        heavy_lag=args.heavy_lag if args.async_heavy else 0)


def main(argv=None):
    return run(parse_args(argv))


def mesh_of(args):
    """``--mesh``/``--mesh-axes`` → a mesh, or None (``none``).  Under
    ``torch.distributed.run`` the world comes from its environment."""
    if args.mesh in ("none", ""):
        return None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        mesh_lib.init_process_group(args.device)
    if args.mesh == "16x16":
        return mesh_lib.make_production_mesh(device=args.device)
    if args.mesh == "2x16x16":
        return mesh_lib.make_production_mesh(multi_pod=True,
                                             device=args.device)
    dims = tuple(int(x) for x in args.mesh.split("x"))
    if args.mesh_axes:
        names = tuple(a.strip() for a in args.mesh_axes.split(","))
        if len(names) != len(dims):
            raise SystemExit(f"--mesh-axes {names} does not match "
                             f"--mesh {args.mesh}")
    else:
        names = ("data", "model")[: len(dims)]
    return mesh_lib.make_mesh(dims, names, device=args.device)


def curvature_axes(args, mesh):
    """(curvature axis, row axis) that ``--curvature`` picks on ``mesh``
    (the reference's choice)."""
    curv_axis = row_axis = None
    if args.curvature == "auto" and mesh is not None:
        dp = [a for a in mesh.axis_names if a != "model"]
        sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
        if "curv" in sizes and sizes["curv"] > 1:
            # slots over the dedicated curv axis, dense-M rows (and the
            # heavy FLOPs on them) over the remaining data axis
            curv_axis = "curv"
            rows = [a for a in dp if a != "curv" and sizes[a] > 1]
            row_axis = rows[0] if rows else None
        elif dp and sizes[dp[0]] > 1:
            curv_axis = dp[0]
    return curv_axis, row_axis


class _Saver:
    """The CLI's checkpoint writes: on a mesh every rank gathers the
    state to the one-device format and rank 0 writes it."""

    def __init__(self, directory: str, shardings, mesh, rank0: bool):
        self.shardings, self.mesh = shardings, mesh
        self.ck = (ckpt.AsyncCheckpointer(directory, keep=3)
                   if rank0 else None)

    def submit(self, step: int, state) -> None:
        if self.shardings is not None:
            state = shd.globalize(state, self.shardings)
        if self.ck is not None:
            self.ck.submit(step, state)

    def wait(self) -> None:
        if self.ck is not None:
            self.ck.wait()
        if self.shardings is not None:  # the files exist for every rank
            torch.distributed.barrier(group=self.mesh.group())

    def close(self) -> None:
        if self.ck is not None:
            self.ck.close()


def state_shardings(lm: LM, opt):
    """How a rank holds the CLI's TrainState on its mesh (None without
    one that splits it): the parameters' blocks on a model axis larger
    than 1 and the AdamW moments with them (the factors replicated over
    "model"), the curvature engine's layout of the optimizer state."""
    eng, sp = opt.curvature, lm.sp
    if sp.model_parallel:
        a_opt = kfac_lib.Kfac(opt.cfg, lm.taps, device=steps_lib.META
                              ).init(lm.init(None))
        o_sh = shd.kfac_state_sharding(a_opt, sp.mesh)
        if eng is not None:
            o_sh = shd.Composed(eng.state_sharding(opt), o_sh)
        return loop_lib.TrainState(params=lm.param_shardings, opt=o_sh,
                                   rng=None)
    if eng is not None:
        return loop_lib.TrainState(params=None,
                                   opt=eng.state_sharding(opt), rng=None)
    return None


def run(args, arch: Optional[ArchConfig] = None,
        params: Optional[Dict[str, Tensor]] = None,
        batches: Optional[Callable[[int], Dict[str, Tensor]]] = None,
        draws: Optional[Callable[[int], Dict]] = None):
    """Train as the CLI does for ``args`` → (final TrainState, losses).
    ``arch`` replaces ``--arch``/``--reduced``'s config (a depth cut);
    ``params`` the initial parameters (leaf tensors on the device that
    require grad); ``batches(k)`` the TokenStream's global batch of step
    ``k`` (on a data mesh each rank keeps its rows of it);
    ``draws(step)`` the heavy ops' random inputs by schedule step."""
    mesh = mesh_of(args)
    dev = mesh.device if mesh is not None else device_lib.resolve(
        args.device)
    rank0 = mesh is None or torch.distributed.get_rank() == 0
    jsonl = (os.path.join(args.telemetry_dir, "events.jsonl")
             if args.telemetry_dir and rank0 else None)
    if jsonl is not None:
        os.makedirs(args.telemetry_dir, exist_ok=True)
    writer = obs_events.TelemetryWriter(path=jsonl, console=rank0)
    writer.emit("run_start", config={
        "arch": args.arch, "variant": args.variant, "steps": args.steps,
        "batch": args.batch, "seq": args.seq, "mesh": args.mesh,
        "reduced": args.reduced, "stagger": args.stagger,
        "async_heavy": args.async_heavy, "heavy_lag": args.heavy_lag,
        "metrics_every": args.metrics_every})

    if arch is None:
        arch = get_arch(args.arch)
        if args.reduced:
            arch = arch.reduced()
    sp = steps_lib.shard_policy_for(mesh)
    lm = LM(arch, sp, remat=not args.reduced, device=dev)
    sp = lm.sp
    kcfg = kfac_config_of(args)
    opt = kfac_lib.Kfac(kcfg, lm.taps, device=dev)
    opt.model_shards = sp.shards
    curv_axis, row_axis = curvature_axes(args, mesh)
    eng = specs_lib.DistSpec(
        mesh=mesh, curvature_axis=curv_axis, row_axis=row_axis,
        curvature_compress=args.curvature_compress or None).attach(opt)
    if eng is not None:
        rep, per_dev = eng.job_counts()
        writer.log(f"curvature sharded on '{curv_axis}': "
                   f"{rep} factor slots replicated -> {per_dev}/device "
                   f"({eng.describe()})")
        m_rep, m_dev = eng.m_bytes()
        cb = eng.collective_bytes()
        writer.log(f"dense-M memory: {m_rep / 1e6:.2f} MB replicated -> "
                   f"{m_dev / 1e6:.2f} MB/device; (U, lambda) gather "
                   f"bytes/round: {cb['uncompressed'] / 1e6:.3f} MB raw, "
                   f"{cb['on_wire'] / 1e6:.3f} MB on wire")
    if sp.data_parallel:
        if args.batch % sp.dp_size:
            raise SystemExit(f"--batch {args.batch} does not split over "
                             f"the {sp.dp_size} ranks of the data axes "
                             f"{sp.dp}")
        tap_mb = loop_lib.gathered_tap_bytes(lm.taps,
                                             lm.dtype.itemsize) / 1e6
        writer.log(f"data parallel over {'×'.join(sp.dp)}: "
                   f"{sp.dp_size} ranks of {args.batch // sp.dp_size} "
                   f"rows; taps summed over them: {tap_mb:.2f} MB a step")
    if sp.model_parallel:
        ms = sp.shards
        held = sum(math.prod(ms.local_shape(k)) for k in ms.shapes)
        total = sum(math.prod(v) for v in ms.shapes.values())
        tapped = {t.param_path for t in lm.taps.values()}
        gathered = sum(math.prod(ms.shapes[k]) for k in tapped
                       if ms.sharded(k)) * 4 * (ms.size - 1) / ms.size
        writer.log(f"tensor parallel over {sp.tp}: {ms.size} ranks, "
                   f"{sum(ms.sharded(k) for k in ms.shapes)} of "
                   f"{len(ms.shapes)} leaves sharded, {held / 1e6:.2f}M of "
                   f"{total / 1e6:.2f}M parameters a rank; sharded "
                   f"gradients gathered for the preconditioning: "
                   f"{gathered / 1e6:.2f} MB a rank a step")
    sched = opt.scheduler()
    if args.stagger or args.async_heavy:
        writer.emit("sched",
                    detail=f"heavy-work scheduler: {sched.describe()}")
    runner = (loop_lib.AsyncInverseRunner.for_opt(opt, writer=writer)
              if args.async_heavy else None)
    if runner is not None:
        writer.log(f"async heavy pipeline: lag={kcfg.heavy_lag} offload="
                   f"{'side stream' if runner.stream else 'in-thread'}")

    n_tokens = args.batch * args.seq
    if batches is None:
        batches = TokenStream(vocab=arch.vocab, batch=args.batch,
                              seq_len=args.seq, seed=0, device=dev).batch_at
    if sp.data_parallel:
        batches = (lambda k, _whole=batches:
                   rank_rows(_whole(k), sp.dp_index, sp.dp_size))
    if params is None:
        params = lm.init(torch.Generator(device=dev).manual_seed(0))
    elif sp.model_parallel and any(
            tuple(v.shape) != sp.shards.local_shape(k)
            for k, v in params.items()):
        params = {k: v.requires_grad_() for k, v in shd.localize(
            {k: v.detach() for k, v in params.items()},
            lm.param_shardings).items()}
    state = loop_lib.TrainState(
        params=params, opt=opt.init(params),
        rng=torch.Generator(device=dev).manual_seed(1))

    # gradient compression rides as the step's grad_transform; its
    # CompressState is a separate carry outside TrainState, so the
    # checkpoint schema is untouched (a restore cold-starts it)
    grad_transform = None
    cstate = None
    if args.compress:
        ccfg = compress_lib.CompressConfig(rank=8)
        cstate = compress_lib.init_state(params, ccfg, sp=sp)
        grad_transform = lambda gp, cs: compress_lib.compress_tree(
            gp, cs, ccfg, sp=sp)
        if args.health:
            writer.log("--compress ignored with --health: the resilient "
                       "step has no gradient-transform hook")
            grad_transform = cstate = None

    meter = None
    if args.telemetry_dir:      # every rank: the metrics reduce over the mesh
        meter = specs_lib.ObsSpec(
            writer=writer, metrics_every=args.metrics_every).make_meter(opt)
    policy = None
    if args.health:
        policy = health_lib.RemediationPolicy(writer=writer)
        step_fn = health_lib.make_resilient_kfac_step(
            lm.loss_fn, opt, n_tokens, meter=meter, sp=sp)
        writer.log("health guards on: staged remediation ladder armed"
                   + ("" if args.ckpt_dir
                      else " (no --ckpt-dir: rollback stage disabled)"))
    else:
        step_fn = loop_lib.make_scheduled_kfac_step(
            lm.loss_fn, opt, n_tokens, meter=meter,
            grad_transform=grad_transform, sp=sp)

    shardings = state_shardings(lm, opt)
    checkpointer = (_Saver(args.ckpt_dir, shardings, mesh, rank0)
                    if args.ckpt_dir else None)
    start = ckpt.latest_step(args.ckpt_dir) if args.ckpt_dir else None
    if start is not None:
        state, _ = ckpt.restore(args.ckpt_dir, state, shardings=shardings)
        writer.emit("ckpt_restore", step=start, path=args.ckpt_dir)
    k0 = 0 if start is None else start + 1

    mesh_txt = ("×".join(f"{a}={s}" for a, s in
                         zip(mesh.axis_names, mesh.devices.shape))
                if mesh is not None else "")
    det = strag_lib.StragglerDetector(writer=writer, mesh_desc=mesh_txt)
    profiler = obs_trace.StepProfiler(args.profile_dir or None,
                                      first=k0 + 1,
                                      steps=args.profile_steps)
    t_start = time.time()
    losses = []
    # the loop takes the state out of a box: a caller's reference would
    # keep the initial optimizer state alive beside its successors
    box = [state]
    del state, params
    try:
        state = run_steps(args, sched, det, batches, step_fn, box,
                          checkpointer, k0, losses, runner=runner,
                          writer=writer, meter=meter, profiler=profiler,
                          policy=policy, opt=opt, cstate=cstate, draws=draws,
                          shardings=shardings)
    finally:
        profiler.close()
        if runner is not None:
            runner.close()
        if checkpointer is not None:
            checkpointer.close()
    writer.emit("run_end", steps=len(losses), loss_first=losses[0],
                loss_last=float(np.mean(losses[-3:])),
                s_per_step=(time.time() - t_start) / max(len(losses), 1))
    writer.close()
    return state, losses


def run_steps(args, sched, det, batches, step_fn, box, checkpointer, k0,
              losses, runner=None, writer=None, meter=None, profiler=None,
              policy=None, opt=None, cstate=None, draws=None,
              shardings=None):
    """Steps ``k0 .. args.steps - 1`` (the reference's ``run_steps``) →
    the final state; ``losses`` gets each step's loss.  ``box`` is a
    one-element list holding the initial TrainState, which the loop takes
    out, so that no caller keeps it (and its optimizer state) alive.
    ``shardings`` lay a rollback's restore out for the mesh."""
    state = box.pop()
    mbuf = meter.init() if meter is not None else None
    last_k = k0
    k_off = 0          # rollback re-anchor: schedule runs at k_off + k
    for k in range(k0, args.steps):
        last_k = k
        t0 = time.time()
        kk = k_off + k
        work = sched.work(kk)
        if policy is not None and policy.take_refresh():
            # remediation stage 2: abandon the (possibly poisoned)
            # pipeline, re-establish the inverse rep from the live M
            work = opt.remedial_work()
            state = dataclasses.replace(state,
                                        opt=opt.clear_inflight(state.opt))
            if runner is not None:
                runner.drop_pending(reason="dropped")
        actions = det.observe_step(k, {"host0": time.time() - t0 + 1e-6})
        work = strag_lib.apply_to_work(actions.get("host0",
                                                   strag_lib.Action.NONE),
                                       work)
        batch = batches(k)
        landing = (runner.landing(work, step=kk)
                   if runner is not None else None)
        if profiler is not None:
            profiler.tick(k)
        kw = dict(draws=None if draws is None else draws(kk),
                  landing=landing, mbuf=mbuf)
        report = None
        if policy is not None:
            out = step_fn(state, batch, work,
                          damping_scale=policy.damping_scale, **kw)
            state, loss, report = out[:3]
        elif cstate is not None:
            # compressed step: the CompressState carry trails the outputs
            # (after mbuf when a meter is on)
            out = step_fn(state, batch, work, cstate=cstate, **kw)
            state, loss, cstate = out[0], out[1], out[-1]
        else:
            out = step_fn(state, batch, work, **kw)
            state, loss = out[:2]
        if meter is not None:
            mbuf = out[2] if policy is None else out[3]
        if runner is not None:
            runner.launch(state.opt, work, step=kk)
        losses.append(float(loss))
        faulty = False
        if policy is not None:
            faulty = policy.observe(kk, losses[-1], report)
            if policy.take_rollback() and args.ckpt_dir:
                # remediation stage 3: restore the newest snapshot that
                # verifies and re-anchor the staggered cadence on it
                if runner is not None:
                    runner.drop_pending(reason="dropped")
                if checkpointer is not None:
                    checkpointer.wait()
                state, man = ckpt.restore_latest_healthy(
                    args.ckpt_dir, state, shardings=shardings)
                k_off = int(state.opt.phase) - (k + 1)
                policy.notify_rollback(kk, man["step"], args.ckpt_dir)
                if writer is not None:
                    writer.emit("ckpt_restore", step=int(man["step"]),
                                path=args.ckpt_dir)
                faulty = False
        if (checkpointer is not None and not faulty
                and k % args.ckpt_every == 0):
            checkpointer.submit(k, state)
            if writer is not None:
                writer.emit("ckpt_save", step=k, path=args.ckpt_dir)
        if writer is not None:
            writer.emit("step", step=kk, loss=float(loss),
                        dt_s=time.time() - t0, phase=work.label)
    if meter is not None:
        meter.drain(mbuf, last_k)
    return state


if __name__ == "__main__":
    main()
