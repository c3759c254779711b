"""The rank program of the port's multi-process CPU tests
(``test_torch_dist.py``, ``test_torch_mesh.py``, ``test_torch_dp.py``,
``test_torch_tp.py``), and :func:`spawn`, which runs it.

One ``gloo`` world of ``WORLD`` processes per test file: the parent
writes the cases to a pickle, each rank joins through a file rendezvous
under the test's temporary directory (never a fixed port: several test
workers run side by side), runs every case of its suite in the same
order (mesh creation and collectives are collective), and pickles its
results; the parent compares them with the reference.  Each rank pins
torch to one thread; the process group and the parent both time out, so
a hung rank fails its tests in about two minutes.

This file imports neither ``jax`` nor the JAX package: it is the port
alone, as on the card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import io
import os
import pickle
import subprocess
import sys
import time
import traceback

import numpy as np

WORLD = 4
HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")


# ---------------------------------------------------------------------------
# the parent's side
# ---------------------------------------------------------------------------

def spawn(suite: str, cases, tmp_dir: str, world: int = WORLD,
          timeout: float = 150.0):
    """Run ``suite`` over ``cases`` on ``world`` ranks → one result dict
    per rank (``{case name: result}``; a case that raised holds its
    traceback under ``"error"``)."""
    return start(suite, cases, tmp_dir, world, timeout)()


def start(suite: str, cases, tmp_dir: str, world: int = WORLD,
          timeout: float = 150.0):
    """:func:`spawn` in the background → a function that joins the ranks
    and returns their results (the parent computes its oracles
    meanwhile)."""
    os.makedirs(tmp_dir, exist_ok=True)
    job = os.path.join(tmp_dir, f"{suite}_cases.pkl")
    with open(job, "wb") as f:
        pickle.dump(cases, f)
    rdv = os.path.join(tmp_dir, f"{suite}_rendezvous")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC, HERE, os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    logs = [open(os.path.join(tmp_dir, f"{suite}_{r}.log"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), suite, job, str(r),
         str(world), rdv, tmp_dir], env=env, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.time() + timeout

    def join():
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        tails = []
        for r, f in enumerate(logs):
            f.seek(0)
            tails.append(f"--- rank {r} (rc {procs[r].returncode}) ---\n"
                         + f.read()[-3000:])
            f.close()
        if any(p.returncode != 0 for p in procs):
            raise AssertionError(f"{suite}: a rank failed or hung\n"
                                 + "\n".join(tails))
        out = []
        for r in range(world):
            with open(os.path.join(tmp_dir, f"{suite}_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    return join


def later(tmp_dir: str, suite: str, timeout: float = 150.0):
    """A case that makes the ranks wait for the parent's later cases (its
    oracles first need time the ranks can spend on the others) → (the
    case, a function that hands them the cases)."""
    path = os.path.join(tmp_dir, f"{suite}_later.pkl")

    def send(cases):
        with open(path + ".tmp", "wb") as f:
            pickle.dump(cases, f)
        os.replace(path + ".tmp", path)
    return {"name": "later", "kind": "later", "path": path,
            "timeout": timeout}, send


def _wait_for(path: str, timeout: float):
    deadline = time.time() + timeout
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(f"no later cases at {path}")
        time.sleep(0.1)
    with open(path, "rb") as f:
        return pickle.load(f)


def ok(results, name):
    """Every rank's result of case ``name``, after checking none
    raised."""
    got = [res[name] for res in results]
    for r, g in enumerate(got):
        if isinstance(g, dict) and "error" in g:
            raise AssertionError(f"{name} on rank {r}:\n{g['error']}")
    return got


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------

def _np(t):
    return t.detach().cpu().numpy().copy()


def _t(a):
    import torch
    return torch.as_tensor(np.asarray(a))


def _kfac_opt(case, device):
    from repro_torch.core import kfac as tkfac
    from repro_torch.core import policy as tpolicy
    from repro_torch.optim import base as tbase
    cfg = dict(case["cfg"])
    pol = tpolicy.PolicyConfig(**cfg.pop("policy"))
    for k in ("lr", "damping_phi", "fallback_lr"):
        if k in cfg:
            cfg[k] = tbase.constant(cfg[k])
    taps = {n: tkfac.TapInfo(**t) for n, t in case["taps"].items()}
    return tkfac.Kfac(tkfac.KfacConfig(policy=pol, **cfg), taps,
                      device=device)


class Ctx:
    """This rank's meshes (built once, in the same order on every rank)."""

    def __init__(self):
        import torch
        import torch.distributed as dist
        from repro_torch.launch import mesh as mesh_lib
        self.cpu = torch.device("cpu")
        self.rank = dist.get_rank()
        self.m1d = mesh_lib.make_mesh((WORLD,), ("curv",), device=self.cpu)
        self.m2d = mesh_lib.make_mesh((2, 2), ("data", "curv"),
                                      device=self.cpu)

    def dist_spec(self, kind, compress=None):
        from repro_torch import specs
        if kind == "1d":
            return specs.DistSpec(mesh=self.m1d, curvature_axis="curv",
                                  curvature_compress=compress)
        if kind == "2d":
            return specs.DistSpec(mesh=self.m2d, curvature_axis="curv",
                                  row_axis="data",
                                  curvature_compress=compress)
        assert kind == "rep"
        return specs.DistSpec()


# -- the engine suite --------------------------------------------------------

def _engine_case(ctx, case):
    """``Kfac.update`` under the engine for the case's steps, with the
    reference's operands and draws injected."""
    opt = _kfac_opt(case, ctx.cpu)
    eng = ctx.dist_spec(case["mesh"], case.get("compress")).attach(opt)
    sched = opt.scheduler(align=4)
    params = {k: _t(v) for k, v in case["params"].items()}
    st = opt.init(params)
    out = {"updates": []}
    for step in case["steps"]:
        draws = {int(bi): _t(d) for bi, d in step["draws"].items()}
        upd, st = opt.update(
            {k: _t(v) for k, v in step["grads"].items()}, st, params,
            acts={k: _t(v) for k, v in step["acts"].items()},
            probe_grads={k: _t(v) for k, v in step["pgs"].items()},
            n_tokens=case["n_tokens"], rng=None,
            work=sched.work(len(out["updates"])), draws=draws)
        out["updates"].append({k: _np(v) for k, v in upd.items()})
    if eng is None:
        return out
    out["held"] = sum(t.numel() * t.element_size()
                      for t in st.shards.values())
    out["m_bytes"] = eng.m_bytes()
    out["placeholders"] = sum(
        getattr(ts, s).M.numel() for ts in st.factors.values()
        for s in "AG" if getattr(ts, s).M.shape[-2] == 0)
    g = eng.gather_state(opt, st)
    out["factors"] = {n: {s: tuple(_np(getattr(getattr(ts, s), f))
                                   for f in ("M", "U", "D"))
                          for s in "AG"} for n, ts in g.factors.items()}
    out["inflight"] = {k: (_np(b.M), _np(b.panels), _np(b.live))
                       for k, b in g.inflight.items()}
    return out


def suite_engine(ctx, cases):
    return {c["name"]: _engine_case(ctx, c) for c in cases}


# -- the mesh suite ------------------------------------------------------------

D_IN, D_H, D_OUT, N_BS, N_STAT = 12, 32, 4, 16, 16


def mlp():
    """The reference's test_obs MLP, in the port, from numpy draws."""
    import torch
    from repro_torch.core import kfac as tkfac
    rs = np.random.default_rng(1)
    params = {"fc0/w": _t((rs.standard_normal((D_IN, D_H))
                           / np.sqrt(D_IN)).astype(np.float32)),
              "fc1/w": _t((rs.standard_normal((D_H, D_OUT))
                           / np.sqrt(D_H)).astype(np.float32))}
    for p in params.values():
        p.requires_grad_()
    taps = {"fc0": tkfac.TapInfo("fc0/w", D_IN, D_H, n_stat=N_STAT),
            "fc1": tkfac.TapInfo("fc1/w", D_H, D_OUT, n_stat=N_STAT)}
    return params, taps


def mlp_loss(params, probes, batch):
    import torch
    from repro_torch.models import layers as tlayers
    x, y = batch
    acts = {}
    h, acts["fc0"] = tlayers.tapped_matmul(params["fc0/w"], x,
                                           probes.get("fc0"), N_STAT)
    h = torch.relu(h)
    h, acts["fc1"] = tlayers.tapped_matmul(params["fc1/w"], h,
                                           probes.get("fc1"), N_STAT)
    return torch.mean((h - y) ** 2), acts


def mlp_batches(n):
    rs = np.random.default_rng(3)
    W = rs.standard_normal((D_IN, D_OUT)) / np.sqrt(D_IN)
    out = []
    for _ in range(n):
        x = rs.standard_normal((N_BS, D_IN))
        out.append((_t(x.astype(np.float32)),
                    _t(np.tanh(x @ W).astype(np.float32))))
    return out


def mlp_cfg(variant, **kw):
    from repro_torch.core import kfac as tkfac
    from repro_torch.core import policy as tpolicy
    from repro_torch.optim import base as tbase
    kwargs = dict(policy=tpolicy.PolicyConfig(variant=variant, r=8,
                                              max_dense_dim=512),
                  lr=tbase.constant(0.05),
                  damping_phi=tbase.constant(0.1), weight_decay=1e-4,
                  clip=10.0, T_updt=1, T_inv=4, T_brand=1, T_rsvd=4,
                  T_corct=4, fallback_lr=tbase.constant(1e-2))
    kwargs.update(kw)
    return tkfac.KfacConfig(**kwargs)


def mlp_train(variant, dist=None, steps=9, writer=None, metrics_every=0,
              health=False, **kw):
    """``run_kfac_training`` on the MLP → (final params, losses)."""
    from repro_torch import specs
    from repro_torch.core import kfac as tkfac
    from repro_torch.train import loop as tloop
    import torch
    params, taps = mlp()
    opt = tkfac.Kfac(mlp_cfg(variant, **kw), taps,
                     device=torch.device("cpu"))
    state, losses = tloop.run_kfac_training(
        mlp_loss, opt, params, mlp_batches(steps), n_tokens=N_BS, seed=0,
        dist=dist, obs=specs.ObsSpec(writer=writer,
                                     metrics_every=metrics_every),
        resilience=specs.ResilienceSpec(health=health),
        device=torch.device("cpu"))
    return {k: _np(v) for k, v in state.params.items()}, losses


def _obs_health(ctx, case):
    """Metrics on ≡ off and health on ≡ off under the 1D engine."""
    from repro_torch.obs import events as ev
    d = ctx.dist_spec("1d")
    path = os.path.join(case["dir"], f"events_{case['variant']}.jsonl")
    off = mlp_train(case["variant"], d)
    w = ev.TelemetryWriter(path, console=False) if ctx.rank == 0 else None
    # every rank takes the metrics path (its reductions are collective);
    # rank 0's writer is the only one that writes
    if w is None:
        w = ev.TelemetryWriter(console=False)
    on = mlp_train(case["variant"], d, writer=w, metrics_every=3)
    w.close()
    health = mlp_train(case["variant"], d, health=True)
    return {"off": off, "metrics": on, "health": health,
            "events": path if ctx.rank == 0 else None}


def _drive(opt, loss_fn, batches, params=None, state=None, shardings=None,
           seed=5):
    """The reference's ``_drive`` (test_mesh2d.py): a schedule-resuming
    driver with the alignment pinned, so every mesh runs the same
    masks."""
    import torch
    from repro_torch.train import loop as tloop
    sched = opt.scheduler(align=4)
    k_off = 0
    if state is None:
        state = tloop.TrainState(
            params=params, opt=opt.init(params),
            rng=torch.Generator().manual_seed(seed))
    else:
        k_off = int(state.opt.phase)
    step = tloop.make_scheduled_kfac_step(loss_fn, opt, N_STAT)
    losses = []
    for i, batch in enumerate(batches):
        state, loss = step(state, batch, sched.work(k_off + i))
        losses.append(float(loss))
    return state, losses


def ckpt_model():
    """test_mesh2d.py's one-tap model, from numpy draws."""
    from repro_torch.core import kfac as tkfac
    from repro_torch.models import layers as tlayers
    taps = {"fc": tkfac.TapInfo("fc/w", 48, 32, n_stat=N_STAT)}
    rs = np.random.default_rng(0)
    w0 = (rs.standard_normal((48, 32)) * 0.1).astype(np.float32)

    def fresh():
        return {"fc/w": _t(w0.copy()).requires_grad_()}

    def loss_fn(p, probes, batch):
        import torch
        x, y = batch
        h, act = tlayers.tapped_matmul(p["fc/w"], x, probes.get("fc"),
                                       N_STAT)
        return torch.mean((h - y) ** 2), {"fc": act}

    batches = [(_t(rs.standard_normal((16, 48)).astype(np.float32)),
                _t(rs.standard_normal((16, 32)).astype(np.float32)))
               for _ in range(8)]
    return taps, fresh, loss_fn, batches


def ckpt_opt(taps, async_heavy=False):
    import torch
    from repro_torch.core import kfac as tkfac
    from repro_torch.core import policy as tpolicy
    from repro_torch.optim import base as tbase
    cfg = tkfac.KfacConfig(
        policy=tpolicy.PolicyConfig(variant="kfac", r=4,
                                    max_dense_dim=8192),
        lr=tbase.constant(0.05), T_updt=1, T_inv=4, stagger=True,
        stagger_splits=2, async_heavy=async_heavy,
        heavy_lag=2 if async_heavy else 0)
    return tkfac.Kfac(cfg, taps, device=torch.device("cpu"))


def _save(opt, eng, state, directory, step):
    """Gather (collective), rank 0 writes, everyone waits for the file."""
    import torch.distributed as dist
    from repro_torch.train import checkpoint as ck
    tree = dataclasses.replace(state, opt=eng.gather_state(opt, state.opt))
    if dist.get_rank() == 0:
        ck.save(directory, step, tree)
    dist.barrier()
    return tree


def _ckpt(ctx, case):
    """Save on (2, 2) [data, curv] with rows on data; restore on (2, 1) and
    on one device; mid-lag: save right after a launch, restore on one
    device (test_mesh2d.py's two restore tests, on four ranks)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.train import checkpoint as ck
    from repro_torch.train import loop as tloop
    taps, fresh, loss_fn, batches = ckpt_model()
    m21 = mesh_lib.make_mesh((2, 1), ("data", "curv"), device=ctx.cpu)
    d2 = ctx.dist_spec("2d")
    out = {}
    for async_heavy in (False, True):
        tag = "async" if async_heavy else "sync"
        directory = os.path.join(case["dir"], tag)
        opt_a = ckpt_opt(taps, async_heavy)
        d2.attach(opt_a)
        _, ref = _drive(opt_a, loss_fn, batches, params=fresh())
        opt_b = ckpt_opt(taps, async_heavy)
        eng_b = d2.attach(opt_b)
        sched = opt_b.scheduler(align=4)
        cut = 3
        if async_heavy:
            cut = 1 + next(k for k in range(6)
                           if any(r for r in sched.work(k).launch))
        mid, head = _drive(opt_b, loss_fn, batches[:cut], params=fresh())
        saved = _save(opt_b, eng_b, mid, directory, cut)
        res = {"ref": ref, "head": head, "saved_step": cut,
               "dir": directory,
               "inflight_live": [bool(b.live.any())
                                 for b in saved.opt.inflight.values()],
               "gathered": {k: _np(v) for k, v in
                            ck.leaves(saved.opt).items()
                            if hasattr(v, "detach")}}
        # (2, 1): ranks 0 and 1 carry on, 2 and 3 sit it out
        from repro_torch import specs
        opt_c = ckpt_opt(taps, async_heavy)
        eng_c = specs.DistSpec(mesh=m21, curvature_axis="curv",
                               row_axis="data").attach(opt_c)
        if m21.member:
            tmpl = tloop.TrainState(params=fresh(), opt=opt_c.init(fresh()),
                                    rng=mid.rng)
            sh = tloop.TrainState(params=None,
                                  opt=eng_c.state_sharding(opt_c), rng=None)
            restored, man = ck.restore(directory, tmpl, shardings=sh)
            res["schema"] = man["schema"]
            _, tail = _drive(opt_c, loss_fn, batches[cut:], state=restored)
            res["tail_21"] = tail
        # one device: rank 0 alone, no engine
        if ctx.rank == 0:
            opt_d = ckpt_opt(taps, async_heavy)
            tmpl = tloop.TrainState(params=fresh(), opt=opt_d.init(fresh()),
                                    rng=mid.rng)
            restored, _ = ck.restore(directory, tmpl)
            _, tail = _drive(opt_d, loss_fn, batches[cut:], state=restored)
            res["tail_1"] = tail
        dist.barrier()
        out[tag] = res
    return out


def tcut(vocab: int = 256):
    """A depth cut of reduced gemma3, in the port: its first (local) layer,
    scanned twice (stacked taps of 2), which keeps the reference's jitted
    step short to compile."""
    from repro_torch.configs.base import Segment, get_arch
    red = get_arch("gemma3_4b").reduced()
    return dataclasses.replace(red, vocab=vocab, n_layers=2, segments=(
        Segment((red.segments[0].pattern[0],), repeats=2),))


def _cli(ctx, case):
    """The CLI on the 2 × 2 [data, curv] mesh (rank 0's console captured)
    and on the 2 × 2 [data, model] mesh (tensor-parallel); then the
    builder under ``plan="fsdp"`` on the CLI's model mesh: one step from
    the port's seeded parameters (this rank's blocks) and its block of
    the case's batch."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeCell
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch import train as ttrain
    buf = io.StringIO()
    args = ttrain.parse_args(case["argv"])
    with contextlib.redirect_stdout(buf):
        _, losses = ttrain.run(args, arch=tcut())
    with contextlib.redirect_stdout(io.StringIO()):
        _, model_losses = ttrain.run(ttrain.parse_args(case["model_argv"]),
                                     arch=tcut())
    B, T = case["fsdp_batch"]["tokens"].shape
    tb = tsteps.build_train_step(tcut(), mesh=ttrain.mesh_of(
        ttrain.parse_args(case["model_argv"])),
        cell=ShapeCell("t", T, B, "train"), plan="fsdp", device=ctx.cpu)
    from repro_torch.models.lm import LM
    whole = LM(tcut(), device=ctx.cpu).init(torch.Generator().manual_seed(0))
    params = {k: v.detach().requires_grad_() for k, v in shd.localize(
        whole, tb.in_shardings[0]).items()}
    batch = shd.localize({k: _t(v) for k, v in case["fsdp_batch"].items()},
                         tb.in_shardings[2])
    _, _, fsdp_loss = tb.step_fn(params, tb.opt.init(params), batch,
                                 torch.Generator().manual_seed(1))
    dist.barrier()
    return {"losses": losses, "console": buf.getvalue(),
            "model_losses": model_losses, "fsdp_loss": float(fsdp_loss)}


def _builder(ctx, case):
    """``build_train_step`` on the 2 × 2 [data, curv] mesh: one step from
    the reference's parameters and this rank's block of its batch (split
    over data and curv)."""
    import torch
    from repro_torch import convert
    from repro_torch.configs.base import ShapeCell
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps as tsteps
    tb = tsteps.build_train_step(
        tcut(), cell=ShapeCell("t", case["T"], case["B"], "train"),
        flags=case["flags"], dist=ctx.dist_spec("2d"), device=ctx.cpu)
    params = {k: v.requires_grad_() for k, v in convert.params_from_jax(
        case["init"], device=ctx.cpu).items()}
    batch = shd.localize({k: torch.as_tensor(v)
                          for k, v in case["batch"].items()},
                         tb.in_shardings[2])
    st0 = tb.opt.init(params)
    out, st, loss = tb.step_fn(params, st0, batch,
                               torch.Generator().manual_seed(1))
    return {"loss": float(loss), "after": {k: _np(v) for k, v in
                                           out.items()},
            "engine": tb.opt.curvature.describe(),
            "in_sh": tb.in_shardings is not None}


# -- FSDP (plan="fsdp"), read by the mesh, dp and tp suites ------------------

@contextlib.contextmanager
def fsdp_gathers():
    """Every ``ModelShards.gather_whole`` call while the block runs, as
    (scope, the keys it gathered whole, whether it carries gradients)."""
    from repro_torch.distributed import sharding as shd
    orig, seen = shd.ModelShards.gather_whole, []

    def recorded(self, xs, dims, grad=False, scope="", keys=()):
        seen.append((scope, tuple(k for k, d in zip(keys, dims)
                                  if d is not None), bool(grad),
                     sum(d is not None for d in dims)))
        return orig(self, xs, dims, grad=grad, scope=scope, keys=keys)
    shd.ModelShards.gather_whole = recorded
    try:
        yield seen
    finally:
        shd.ModelShards.gather_whole = orig


def fsdp_gather_report(tb, seen) -> dict:
    """The recorded gathers of an FSDP step checked against where a leaf
    may be whole: a layer gathers exactly its sharded parameters (a
    repeat of a segment, or the embedding, or the head with the MTP
    projection), a factor bucket only its entries' leaves, a precondition
    bucket only its taps' U and D; and no call gathers an unnamed leaf.
    → {"bad": [the calls that break it], "scopes": {scope: calls}}."""
    ms, opt = tb.lm.sp.shards, tb.opt
    sharded = {k for k in ms.shapes if ms.sharded(k)}
    bad, scopes = [], {}

    def tap_key(k):                 # factors/<tap>/<side>/<field>
        name, side, field = k[len("factors/"):].rsplit("/", 2)
        return name, side, field

    for scope, keys, grad, n in seen:
        scopes[scope] = scopes.get(scope, 0) + 1
        if n != len(keys):
            ok = False
        elif grad and scope.startswith(("segments/", "enc/")):
            pre = scope.rsplit("/", 1)[0] + "/"
            ok = set(keys) == {k for k in sharded if k.startswith(pre)}
        elif grad:
            ok = set(keys) == set(scope.split("+")) & sharded
        elif scope.startswith("factor bucket "):
            ents = {(e.name, e.side) for e in
                    opt.factor_buckets[int(scope.split()[-1])].entries}
            ok = all(tap_key(k)[:2] in ents for k in keys)
        elif scope.startswith("precond bucket "):
            names = {e.name for e in
                     opt.precond_buckets[int(scope.split()[-1])].entries}
            ok = all(tap_key(k)[0] in names and tap_key(k)[2] in "UD"
                     for k in keys)
        else:
            ok = False
        if not ok:
            bad.append((scope, keys))
    return {"bad": bad, "scopes": scopes}


def fsdp_held(tree, shardings, abstract) -> dict:
    """The leaves of ``tree`` (this rank's parameters or optimizer state)
    whose shape is not their block of the global (``abstract``) tree
    under ``shardings``, and how many leaves are strict blocks."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.train import checkpoint as ck
    want = ck.leaves(shd.localize(abstract, shardings))
    whole = ck.leaves(abstract)
    have = {k: v for k, v in ck.leaves(tree).items()
            if hasattr(v, "shape")}
    return {"wrong": sorted(k for k, v in have.items()
                            if tuple(v.shape) != tuple(want[k].shape)),
            "keys": sorted(have) == sorted(k for k, v in want.items()
                                          if hasattr(v, "shape")),
            "blocks": sum(k in whole and v.numel() < whole[k].numel()
                          for k, v in have.items())}


def fsdp_leaves(tree, shardings) -> dict:
    """{key: numpy} of a rank's tree gathered whole (collective): a
    parameter dict by path, a state by checkpoint key."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.train import checkpoint as ck
    whole = shd.globalize(tree, shardings)
    if isinstance(whole, dict):
        return {k: _np(v) for k, v in whole.items()}
    return {k: _np(v) for k, v in ck.leaves(whole).items()
            if hasattr(v, "shape")}


def _fsdp_builder(ctx, case):
    """``build_train_step(plan="fsdp")`` on the 2 × 2 [data, model] mesh:
    one step from the reference's parameters (this rank's blocks) and its
    block of the batch (split over both axes); what each rank holds
    before and after, the state gathered whole, and every whole gather."""
    import torch
    from repro_torch import convert
    from repro_torch.configs.base import ShapeCell
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps as tsteps
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), device=ctx.cpu)
    tb = tsteps.build_train_step(
        tcut(), mesh=mesh, cell=ShapeCell("t", case["T"], case["B"],
                                          "train"),
        flags=case["flags"], plan="fsdp", device=ctx.cpu)
    p_sh, o_sh, b_sh = tb.in_shardings[:3]
    params = {k: v.requires_grad_() for k, v in shd.localize(
        convert.params_from_jax(case["init"], device=ctx.cpu), p_sh).items()}
    batch = shd.localize({k: torch.as_tensor(v)
                          for k, v in case["batch"].items()}, b_sh)
    st0 = tb.opt.init(params)
    held = {"params": fsdp_held(params, p_sh, tb.abstract_params),
            "opt": fsdp_held(st0, o_sh, tb.abstract_opt)}
    seen = RowsSeen(tb.lm)
    with fsdp_gathers() as gathers:
        out, st, loss = tb.step_fn(params, st0, batch,
                                   torch.Generator().manual_seed(1))
    held.update(params_after=fsdp_held(out, p_sh, tb.abstract_params),
                opt_after=fsdp_held(st, o_sh, tb.abstract_opt))
    return {"loss": float(loss), "rows": seen.rows, "held": held,
            "gathers": fsdp_gather_report(tb, gathers),
            "after": fsdp_leaves(out, p_sh), "state": fsdp_leaves(st, o_sh),
            "policy": (tb.lm.sp.dp, tb.lm.sp.tp, tb.lm.sp.fsdp,
                       tb.lm.sp.mesh is mesh, tb.opt.model_shards.fsdp)}


def _fsdp_engine(ctx, case):
    """``build_train_step(plan="fsdp")`` with a curvature engine
    (``case["dist"]``), the async pipeline (``case["lag"]``) or both on
    the 2 × 2 mesh of ``case["axes"]``: the case's steps from the
    reference's parameters (this rank's blocks) and its blocks of the
    batches, each step built for its own StepWork (``case["works"]``;
    None: ``case["flags"]``) with the reference's draws injected; what
    each rank holds before and after every step, the losses, the
    parameters and the state gathered whole.  ``case["tp"]`` also runs
    the plan-"tp" step on the same mesh and engine; ``case["save"]``
    saves the state gathered whole after that step (rank 0 writes) and
    restores it in one process; ``case["shifts"]`` (the reference's
    continuation shifts, per step) are replayed."""
    import torch
    import torch.distributed as dist
    from repro_torch import convert, specs
    from repro_torch.configs.base import ShapeCell
    from repro_torch.core import schedule
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch import train as ttrain
    from repro_torch.models.lm import LM
    from repro_torch.train import checkpoint as ck
    mesh = mesh_lib.make_mesh((2, 2), tuple(case["axes"]), device=ctx.cpu)
    where = (dict(dist=specs.DistSpec(mesh=mesh, **case["dist"]))
             if case.get("dist") else dict(mesh=mesh))
    kw = dict(cell=ShapeCell("t", case["T"], case["B"], "train"),
              flags=case.get("flags"), device=ctx.cpu,
              async_heavy=case.get("lag") is not None,
              heavy_lag=case.get("lag") or 0,
              kfac_config=(ttrain.reduced_kfac_config(case["variant"])
                           if case.get("reduced") else None))

    def run(plan):
        built = {}

        def builder(k):
            work = case["works"][k]
            if repr(work) not in built:
                built[repr(work)] = tsteps.build_train_step(
                    tcut(), plan=plan, work=None if work is None
                    else schedule.StepWork(**work), **where, **kw)
            return built[repr(work)]
        tb = builder(0)
        p_sh, o_sh, b_sh = tb.in_shardings[:3]
        params = {k: v.requires_grad_() for k, v in shd.localize(
            convert.params_from_jax(case["init"], device=ctx.cpu),
            p_sh).items()}
        st = tb.opt.init(params)
        fsdp = plan == "fsdp"
        held = [fsdp_held(st, o_sh, tb.abstract_opt)] if fsdp else []
        out = {"losses": []}
        for k, batch in enumerate(case["batches"]):
            tb = builder(k)
            draws = case["draws"][k]
            rng = (torch.Generator().manual_seed(1) if draws is None else
                   {int(bi): _t(d) for bi, d in draws.items()})
            with continuation_replay(case["shifts"][k] if "shifts" in case
                                     else None):
                params, st, loss = tb.step_fn(params, st, shd.localize(
                    {n: _t(v) for n, v in batch.items()}, b_sh), rng)
            out["losses"].append(float(loss))
            if "shifts" in case:
                out.setdefault("afters", []).append(
                    fsdp_leaves(params, p_sh))
            if fsdp:
                held.append(fsdp_held(st, o_sh, tb.abstract_opt))
            if fsdp and k == case.get("save"):
                out["ckpt"] = _save_whole(tb, params, st, case["dir"], k)
        out["after"] = fsdp_leaves(params, p_sh)
        if fsdp:
            out |= {"held": held,
                    "params_held": fsdp_held(params, p_sh,
                                             tb.abstract_params),
                    "state": fsdp_leaves(st, o_sh),
                    "shards": sorted(st.shards),
                    "engine": (tb.opt.curvature.describe()
                               if tb.opt.curvature else None)}
        return out

    def _save_whole(tb, params, st, directory, k):
        """The state gathered whole, saved by rank 0 and restored there
        into a one-process template → its leaves and the largest
        difference of the restored ones."""
        p_sh, o_sh = tb.in_shardings[:2]
        tree = {"params": shd.globalize({n: v.detach() for n, v in
                                         params.items()}, p_sh),
                "opt": shd.globalize(st, o_sh)}
        res = {"dir": directory, "step": k + 1}
        if ctx.rank == 0:
            ck.save(directory, k + 1, tree)
            one = tsteps.build_train_step(tcut(), **kw)
            fresh = LM(tcut(), device=ctx.cpu).init(
                torch.Generator().manual_seed(0))
            got, _ = ck.restore(directory, {
                "params": fresh, "opt": one.opt.init(fresh)})
            want, have = ck.leaves(tree), ck.leaves(got)
            res["restored_err"] = max(
                float((have[n].double() - w.double()).abs().max())
                for n, w in want.items() if hasattr(w, "shape"))
            res["same_keys"] = sorted(want) == sorted(have)
            res["gathered"] = {n: _np(v) for n, v in
                               ck.leaves(tree["opt"]).items()
                               if hasattr(v, "shape")}
        dist.barrier()
        return res

    out = run("fsdp")
    if case.get("tp"):
        out["tp"] = run("tp")
    return out


def _elastic(ctx, case):
    """The elastic runner's cases on four ranks."""
    import torch
    import torch.distributed as dist
    from repro_torch.obs import events as ev
    from repro_torch.train import chaos as tchaos
    from repro_torch.train import elastic
    from repro_torch.train import loop as tloop
    out = {}
    root = case["dir"]

    class W:
        def __init__(self):
            self.events = []

        def emit(self, etype, **fields):
            self.events.append((etype, fields))

    # restart resumes from the checkpoint (test_fault_tolerance.py:216)
    def make_state(mesh):
        return {"x": torch.zeros(4), "step": torch.zeros((), dtype=torch.int64)}

    def make_step(mesh):
        return lambda st, k: {"x": st["x"] + (k + 1),
                              "step": torch.tensor(k)}
    inj = elastic.FailureInjector(fail_at=[7])
    runner = elastic.ElasticRunner(
        ckpt_dir=os.path.join(root, "resume"), make_state=make_state,
        make_step=make_step, ckpt_every=2,
        meshes=(((1,), ("data",)), ((1,), ("data",))), injector=inj,
        device=ctx.cpu)
    state, info = runner.run(10)
    out["resume"] = {"x": None if state is None else _np(state["x"]),
                     "info": info, "failed": inj.failed}

    # double failure walks the ladder (test_fault_tolerance.py:229)
    calls = []

    def make_step2(mesh):
        calls.append(tuple(mesh.devices.shape))
        return lambda st, k: {"x": st["x"] + 1}
    runner = elastic.ElasticRunner(
        ckpt_dir=os.path.join(root, "double"),
        make_state=lambda m: {"x": torch.zeros(())}, make_step=make_step2,
        ckpt_every=1, meshes=(((1, 1), ("data", "model")), ((1,), ("data",)),
                              ((1,), ("data",))),
        injector=elastic.FailureInjector(fail_at=[2, 5]), device=ctx.cpu)
    _, info = runner.run(8)
    out["double"] = {"info": info, "calls": calls}

    # repartition + remediation events (test_chaos.py:519), and the 2D
    # ladder's axis field (test_mesh2d.py:577), on the world's own ladder
    w = W()
    ladder = elastic.device_ladder(axes=("data", "curv"), shape=(2, 2))
    runner = elastic.ElasticRunner(
        ckpt_dir=os.path.join(root, "axis"),
        make_state=lambda m: {"x": torch.zeros(4)},
        make_step=lambda m: (lambda st, k: {"x": st["x"] + 1}),
        meshes=ladder, injector=elastic.FailureInjector(fail_at=[2]),
        writer=w, device=ctx.cpu)
    state, info = runner.run(5)
    out["axis"] = {"events": w.events, "info": info, "ladder": ladder,
                   "x": None if state is None else _np(state["x"])}

    # host loss mid-cycle on the K-FAC MLP, resumed on the shrunk rung
    # (test_chaos.py:576 in 1D, :626 in 2D with compressed gathers)
    drills = (("host_1d", elastic.device_ladder(axes=("curv",)),
               dict(curvature_axis="curv")),
              ("host_2d", elastic.device_ladder(axes=("data", "curv"),
                                                shape=(2, 2)),
               dict(curvature_axis="curv", row_axis="data",
                    curvature_compress=6)))
    for (tag, ladder, dkw), fault in [(d, f) for d in drills
                                      for f in (None, 7)]:
        if fault is None:
            tag = tag + "_ref"
        batches = mlp_batches(12)
        log = {}
        from repro_torch import specs

        def make_state(mesh, dkw=dkw):
            params, taps = mlp()
            opt = tkfac_opt(taps)
            specs.DistSpec(mesh=mesh, **dkw).attach(opt)
            holder["opt"] = opt
            return tloop.TrainState(params=params, opt=opt.init(params),
                                    rng=torch.Generator().manual_seed(0))

        def shardings(template, mesh):
            opt = holder["opt"]
            return tloop.TrainState(params=None,
                                    opt=opt.curvature.state_sharding(opt),
                                    rng=None)

        def make_step(mesh):
            opt = holder["opt"]
            sched = opt.scheduler()
            step = tloop.make_scheduled_kfac_step(mlp_loss, opt, N_BS)
            monkey = holder["chaos"]

            def step_fn(state, k):
                if not monkey.injected:     # the host is lost once
                    monkey.check(k)
                work = sched.work(k)
                state, loss = step(state, batches[k], work)
                log[k] = (float(loss), work.label,
                          tuple(mesh.devices.shape))
                return state
            return step_fn

        holder = {"chaos": tchaos.ChaosMonkey(
            () if fault is None else (tchaos.Fault(fault, "host_loss"),))}
        w = W()
        runner = elastic.ElasticRunner(
            ckpt_dir=os.path.join(root, tag), make_state=make_state,
            make_step=make_step, state_shardings=shardings, ckpt_every=2,
            meshes=ladder, writer=w, device=ctx.cpu)
        state, info = runner.run(12)
        out[tag] = {"log": log, "info": info, "events": w.events,
                    "params": None if state is None else
                    {k: _np(v) for k, v in state.params.items()}}
    return out


def tkfac_opt(taps):
    """The host-loss drills' optimizer: rkfac, staggered in one chunk."""
    import torch
    from repro_torch.core import kfac as tkfac
    return tkfac.Kfac(mlp_cfg("rkfac", stagger=True, stagger_splits=1),
                      taps, device=torch.device("cpu"))


def suite_mesh(ctx, cases):
    kinds = {"obs_health": _obs_health, "ckpt": _ckpt, "cli": _cli,
             "builder": _builder, "elastic": _elastic,
             "fsdp": _fsdp_builder, "fsdp_engine": _fsdp_engine}
    out = {}
    for case in cases:
        out[case["name"]] = kinds[case["kind"]](ctx, case)
    return out


# -- the data-parallel suite -------------------------------------------------

#: the data meshes of the suite: (shape, axes)
DP_MESHES = {"4x1": ((4, 1), ("data", "model")),
             "2x2x1": ((2, 2, 1), ("pod", "data", "model")),
             "2x1": ((2, 1), ("data", "model"))}


def dp_arch(spec):
    """The suite's architectures by name: ``cut`` (``tcut``: reduced
    gemma3's first local and its global layer, scanned twice), else a
    config's reduced one; ``vocab`` replaces the vocabulary."""
    from repro_torch.configs.base import Segment, get_arch
    name, vocab = spec
    if name == "cut":
        red = get_arch("gemma3_4b").reduced()
        p = red.segments[0].pattern
        arch = dataclasses.replace(red, n_layers=4, segments=(
            Segment((p[0], p[5]), repeats=2),))
    else:
        arch = get_arch(name).reduced()
    return dataclasses.replace(arch, vocab=vocab) if vocab else arch


def dp_kfac_config(variant):
    """The CLI's ``--reduced`` optimizer (r 32, dense up to 1024)."""
    from repro_torch.launch import train as ttrain
    return ttrain.reduced_kfac_config(variant)


class RowsSeen:
    """Records the batch rows of every forward of ``lm``."""

    def __init__(self, lm):
        self.rows = []
        forward = lm.forward

        def seen(params, batch, *a, **kw):
            self.rows.append(int(batch["tokens"].shape[0]))
            return forward(params, batch, *a, **kw)
        lm.forward = seen


def _dp_mesh(ctx, name):
    from repro_torch.launch import mesh as mesh_lib
    shape, axes = DP_MESHES[name]
    return mesh_lib.make_mesh(shape, axes, device=ctx.cpu)


def _dp_step(ctx, case):
    """``make_scheduled_kfac_step`` (the CLI's step) under the data mesh
    and the engine, from the reference's parameters, with its batches
    (global; each rank keeps its rows) and heavy-op draws."""
    import torch
    from repro_torch import convert, specs
    from repro_torch.core import kfac as tkfac
    from repro_torch.data.synthetic import rank_rows
    from repro_torch.launch import steps as tsteps
    from repro_torch.models.lm import LM
    from repro_torch.train import loop as tloop
    mesh = _dp_mesh(ctx, case["mesh"])
    sp = tsteps.shard_policy_for(mesh)
    lm = LM(dp_arch(case["arch"]), sp, remat=case.get("remat", False),
            device=ctx.cpu)
    seen = RowsSeen(lm)
    opt = tkfac.Kfac(dp_kfac_config(case["variant"]), lm.taps,
                     device=ctx.cpu)
    curv, rows = case["dist"]
    specs.DistSpec(mesh=mesh, curvature_axis=curv,
                   row_axis=rows).attach(opt)
    step = tloop.make_scheduled_kfac_step(lm.loss_fn, opt, case["n_tokens"],
                                          sp=sp)
    params = {k: v.requires_grad_() for k, v in convert.params_from_jax(
        case["init"], device=ctx.cpu).items()}
    state = tloop.TrainState(params=params, opt=opt.init(params),
                             rng=torch.Generator().manual_seed(1))
    work = opt.uniform_work(True, True, True)
    losses = []
    for k, batch in enumerate(case["batches"]):
        local = rank_rows({n: _t(v) for n, v in batch.items()},
                          sp.dp_index, sp.dp_size)
        draws = {int(b): _t(d) for b, d in case["draws"][k].items()}
        state, loss = step(state, local, work, draws=draws)
        losses.append(float(loss))
    return {"losses": losses, "rows": seen.rows,
            "after": {k: _np(v) for k, v in state.params.items()}}


def _dp_taps(ctx, case):
    """``kfac_grads`` under the data mesh: the loss, the summed acts and
    probe gradients, the parameter gradients, and the rows each forward
    saw."""
    import torch
    from repro_torch.data.synthetic import rank_rows
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import layers
    from repro_torch.models.lm import LM
    from repro_torch.train import loop as tloop
    sp = tsteps.shard_policy_for(_dp_mesh(ctx, case["mesh"]))
    lm = LM(dp_arch(case["arch"]), sp, remat=False, device=ctx.cpu)
    seen = RowsSeen(lm)
    params = lm.init(torch.Generator().manual_seed(0))
    local = rank_rows({n: _t(v) for n, v in case["batch"].items()},
                      sp.dp_index, sp.dp_size)
    loss, acts, gp, gprobe = tloop.kfac_grads(
        lm.loss_fn, params, layers.make_probes(lm.taps, device=ctx.cpu),
        local, sp)
    return {"loss": float(loss), "rows": seen.rows,
            "acts": {k: _np(v) for k, v in acts.items()},
            "probe_grads": {k: _np(v) for k, v in gprobe.items()},
            "grads": {k: _np(v) for k, v in gp.items()}}


def _dp_archs(ctx, case):
    """Every architecture's ``build_train_step`` (stats, light, heavy;
    remat) on the (2, 1) mesh, one step from the port's seeded parameters: the
    mesh's two ranks each take their block of the global batch under the
    step's batch sharding; the ranks outside the mesh wait."""
    import torch
    from repro_torch.configs.base import ShapeCell
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps as tsteps
    mesh = _dp_mesh(ctx, "2x1")
    out = {}
    if not mesh.member:
        return out
    B, T = case["B"], case["T"]
    for name, batch in case["batches"].items():
        arch = dp_arch((name, 0))
        tb = tsteps.build_train_step(
            arch, mesh=mesh, cell=ShapeCell("t", T, B, "train"),
            flags=dict(do_stats=True, do_light=True, do_heavy=True),
            device=ctx.cpu)
        seen = RowsSeen(tb.lm)
        params = tb.lm.init(torch.Generator().manual_seed(0))
        local = shd.localize({k: _t(v) for k, v in batch.items()},
                             tb.in_shardings[2])
        p, _, loss = tb.step_fn(params, tb.opt.init(params), local,
                                torch.Generator().manual_seed(1))
        out[name] = {"loss": float(loss), "rows": seen.rows,
                     "after": {k: _np(v) for k, v in p.items()}}
    return out


def _dp_fsdp_archs(ctx, case):
    """Every architecture's ``build_train_step(plan="fsdp")`` (stats,
    light, heavy; remat) on the (4, 1) mesh, one step from the port's
    seeded parameters (this rank's blocks) and its block of the batch
    (split over both axes): the loss, the rows its forward saw, what it
    holds, and the parameters after, gathered whole."""
    import torch
    from repro_torch.configs.base import ShapeCell
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps as tsteps
    from repro_torch.models.lm import LM
    mesh = _dp_mesh(ctx, case["mesh"])
    B, T = case["B"], case["T"]
    out = {}
    for name, batch in case["batches"].items():
        arch = dp_arch((name, 0))
        tb = tsteps.build_train_step(
            arch, mesh=mesh, cell=ShapeCell("t", T, B, "train"),
            flags=dict(do_stats=True, do_light=True, do_heavy=True),
            plan="fsdp", device=ctx.cpu)
        p_sh = tb.in_shardings[0]
        seen = RowsSeen(tb.lm)
        params = {k: v.detach().requires_grad_() for k, v in shd.localize(
            LM(arch, device=ctx.cpu).init(torch.Generator().manual_seed(0)),
            p_sh).items()}
        local = shd.localize({k: _t(v) for k, v in batch.items()},
                             tb.in_shardings[2])
        p, st, loss = tb.step_fn(params, tb.opt.init(params), local,
                                 torch.Generator().manual_seed(1))
        out[name] = {"loss": float(loss), "rows": seen.rows,
                     "held": fsdp_held(p, p_sh, tb.abstract_params),
                     "opt_held": fsdp_held(st, tb.in_shardings[1],
                                           tb.abstract_opt),
                     "after": fsdp_leaves(p, p_sh)}
    return out


def _dp_serve(ctx, case):
    """The prefill and decode builders on the data mesh: this rank's
    logits rows from its blocks of the batch, the cache and the tokens."""
    import torch
    from repro_torch.configs.base import ShapeCell
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps as tsteps
    mesh = _dp_mesh(ctx, case["mesh"])
    arch = dp_arch(case["arch"])
    B, T = case["B"], case["T"]
    tokens = _t(case["tokens"])
    pb = tsteps.build_prefill_step(arch, mesh=mesh, cell=ShapeCell(
        "p", T, B, "prefill"), device=ctx.cpu)
    params = pb.lm.init(torch.Generator().manual_seed(0))
    local = shd.localize({"tokens": tokens}, pb.in_shardings[1])
    out = {"prefill": _np(pb.step_fn(params, local))}
    db = tsteps.build_decode_step(arch, mesh=mesh, cell=ShapeCell(
        "d", 16, B, "decode"), device=ctx.cpu)
    cache = shd.localize(db.lm.init_cache(B, 16), db.in_shardings[1])
    tok = shd.localize(tokens, db.in_shardings[2])
    out["decode"] = []
    for t in range(3):
        lg, cache = db.step_fn(params, cache, tok[:, t:t + 1], t)
        out["decode"].append(_np(lg))
    return out


def _dp_compress(ctx, case):
    """``compress_tree(sp=)`` over the data mesh: each rank's share of the
    global gradients, rounds with error feedback from the given bases →
    the reduced approximations and this rank's errors, each round."""
    from repro_torch.distributed import compress as tcomp
    from repro_torch.launch import steps as tsteps
    sp = tsteps.shard_policy_for(_dp_mesh(ctx, case["mesh"]))
    cfg = tcomp.CompressConfig(**case["cfg"])
    r = sp.dp_index
    shares = case["shares"]
    state = tcomp.init_state({k: _t(v) for k, v in shares[0][r].items()},
                             cfg, bases={k: _t(v) for k, v in
                                         case["bases"].items()})
    out = []
    for round_ in shares:
        grads = {k: _t(v).clone() for k, v in round_[r].items()}
        approx, state = tcomp.compress_tree(grads, state, cfg, sp=sp)
        out.append({"approx": {k: _np(v) for k, v in approx.items()},
                    "err": {k: _np(v) for k, v in state.err.items()}})
    return out


def compressed_grads(compress_lib):
    """Patches ``compress_lib.compress_tree`` to record the compressed
    leaves it returns → (the list they go to, the original)."""
    got, compress_tree = [], compress_lib.compress_tree

    def recorded(gp, cs, cfg, sp=None):
        out, cs = compress_tree(gp, cs, cfg, sp=sp)
        got.append({k: v.detach().clone() for k, v in out.items()
                    if v.dim() >= 2 and v.numel() >= cfg.min_size})
        return out, cs
    compress_lib.compress_tree = recorded
    return got, compress_tree


def _dp_cli(ctx, case):
    """The CLI on the case's data mesh (``--mesh`` with ``--mesh-axes``):
    its losses, final parameters and compressed gradients."""
    from repro_torch.distributed import compress as tcomp
    from repro_torch.launch import train as ttrain
    grads, compress_tree = compressed_grads(tcomp)
    try:
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            state, losses = ttrain.run(ttrain.parse_args(case["argv"]),
                                       arch=dp_arch(case["arch"]))
    finally:
        tcomp.compress_tree = compress_tree
    return {"losses": losses, "log": buf.getvalue(),
            "grads": [{k: _np(v) for k, v in g.items()} for g in grads],
            "after": {k: _np(v) for k, v in state.params.items()}}


def suite_dp(ctx, cases):
    kinds = {"step": _dp_step, "taps": _dp_taps, "archs": _dp_archs,
             "serve": _dp_serve, "compress": _dp_compress, "cli": _dp_cli,
             "fsdp_archs": _dp_fsdp_archs}
    return {case["name"]: kinds[case["kind"]](ctx, case) for case in cases}


# -- the tensor-parallel suite -----------------------------------------------

#: the suite's meshes (data, model)
TP_MESHES = {"1x4": (1, 4), "2x2": (2, 2), "1x2": (1, 2),
             "1x2x2": (1, 2, 2)}


@contextlib.contextmanager
def continuation_replay(shifts=None):
    """Record the spectrum continuation's shift (``core/precond.py``'s min
    over modes with D > 0, per row) of every call while the block runs,
    as numpy arrays in the yielded list; with ``shifts`` (another run's
    record) apply that run's shift of the same call instead.  A
    rounding-level mode that is positive in one run and not in another
    moves λ by the smallest real mode there (ROADMAP §3); replaying one
    run's shifts in the other holds the rest of their arithmetic to each
    other (``chip_smoke.py``'s replay, for the CPU tests)."""
    import torch
    from repro_torch.core import precond
    orig = precond.spectrum_continuation
    rec = []

    def continuation(D, lam):
        _, own = orig(D, torch.zeros_like(lam))
        i = len(rec)
        rec.append(_np(own))
        if shifts is None:
            return orig(D, lam)
        sh = torch.as_tensor(shifts[i], dtype=D.dtype, device=D.device)
        return torch.clamp(D - sh[..., None], min=0.0), lam + sh

    precond.spectrum_continuation = continuation
    try:
        yield rec
    finally:
        precond.spectrum_continuation = orig


def _tp_mesh(ctx, name):
    """A model mesh: axes (data, model), or (curv, data, model) for a
    curvature engine with a row axis of its own."""
    from repro_torch.launch import mesh as mesh_lib
    shape = TP_MESHES[name]
    axes = ("data", "model") if len(shape) == 2 else ("curv", "data",
                                                      "model")
    return mesh_lib.make_mesh(shape, axes, device=ctx.cpu)


def _tp_lm(ctx, case, mesh):
    import torch
    from repro_torch.launch import steps as tsteps
    from repro_torch.models.lm import LM
    lm = LM(dp_arch(case["arch"]), tsteps.shard_policy_for(mesh),
            remat=case.get("remat", False), device=ctx.cpu)
    if "init" in case:                  # the reference's, localized
        from repro_torch import convert
        from repro_torch.distributed import sharding as shd
        params = shd.localize(convert.params_from_jax(case["init"],
                                                      device=ctx.cpu),
                              lm.param_shardings)
    else:
        params = lm.init(torch.Generator().manual_seed(0))
    return lm, {k: v.detach().requires_grad_() for k, v in params.items()}


def _blocks_held(lm, params) -> dict:
    """Whether every leaf is this rank's block: {path: (local shape, the
    whole leaf's)} of the sharded leaves, and the replicated leaves whose
    shape is not the whole one."""
    ms = lm.sp.shards
    out = {"sharded": {}, "wrong": []}
    for k, v in params.items():
        if tuple(v.shape) != ms.local_shape(k):
            out["wrong"].append(k)
        if ms.sharded(k):
            out["sharded"][k] = (tuple(v.shape), ms.shapes[k])
    return out


def _whole(lm, tree) -> dict:
    """A parameter-keyed tree of this rank's blocks gathered whole
    (collective), as numpy."""
    from repro_torch.distributed import sharding as shd
    g = shd.globalize({k: v.detach() for k, v in tree.items()},
                      lm.param_shardings)
    return {k: _np(v) for k, v in g.items()}


def _tp_step(ctx, case):
    """``make_scheduled_kfac_step`` (the CLI's step) on the model mesh
    (the curvature engine on "data" when it has members, as ``--curvature
    auto`` picks; on a (curv, data, model) mesh its slots on "curv" and
    its M rows on "data"), from the reference's parameters (this rank's
    blocks), with its batches (each rank its data block) and heavy-op
    draws; then the health guard's count of nonfinite entries planted in
    the final factors (:func:`_planted_count`)."""
    import torch
    from repro_torch import specs
    from repro_torch.core import kfac as tkfac
    from repro_torch.data.synthetic import rank_rows
    from repro_torch.train import loop as tloop
    mesh = _tp_mesh(ctx, case["mesh"])
    lm, params = _tp_lm(ctx, case, mesh)
    sp = lm.sp
    seen = RowsSeen(lm)
    opt = tkfac.Kfac(dp_kfac_config(case["variant"]), lm.taps,
                     device=ctx.cpu)
    opt.model_shards = sp.shards
    if "curv" in mesh.axis_names:
        specs.DistSpec(mesh=mesh, curvature_axis="curv",
                       row_axis="data").attach(opt)
    elif sp.dp_size > 1:
        specs.DistSpec(mesh=mesh, curvature_axis="data").attach(opt)
    step = tloop.make_scheduled_kfac_step(lm.loss_fn, opt, case["n_tokens"],
                                          sp=sp)
    held = _blocks_held(lm, params)
    state = tloop.TrainState(params=params, opt=opt.init(params),
                             rng=torch.Generator().manual_seed(1))
    work = opt.uniform_work(True, True, True)
    losses = []
    with gathers_seen() as gathered:
        for k, batch in enumerate(case["batches"]):
            local = rank_rows({n: _t(v) for n, v in batch.items()},
                              sp.dp_index, sp.dp_size)
            draws = {int(b): _t(d) for b, d in case["draws"][k].items()}
            state, loss = step(state, local, work, draws=draws)
            losses.append(float(loss))
    return {"losses": losses, "rows": seen.rows, "held": held,
            "gathered": gathered,
            "after": _whole(lm, state.params),
            "mu": _whole(lm, state.opt.fallback.mu),
            "planted": _planted_count(opt, state.opt, mesh)}


def _planted_count(opt, st, mesh):
    """One nonfinite entry of the global factor state planted in each of
    D, U and M of the first bucket that holds M by rows of U on "model"
    (where each lies: D on every rank; U's rows on the first model rank;
    M in the curvature engine's block of the first member, on the first
    model rank where its rows are on "model", else on both), then the
    guard's ``factor_report`` → (bucket, its count), or None without
    such a bucket.  Each entry must count once: 3."""
    from repro_torch.train import health
    bi = next((i for i, b in enumerate(opt.factor_buckets)
               if b.spec.needs_m and opt._factor_rows(b.spec)), None)
    if bi is None:
        return None
    e = opt.factor_buckets[bi].entries[0]
    ts = getattr(st.factors[e.name], e.side)
    first = lambda x: (0,) * x.dim()
    m0 = mesh.coord("model") == 0
    ts.D[first(ts.D)] = float("nan")
    if m0:
        ts.U[first(ts.U)] = float("nan")
    on_model = opt._m_rows(opt.factor_buckets[bi].spec) is not None
    M = st.shards.get(str(bi), ts.M)
    owner = all(mesh.coord(a) == 0 for a in mesh.axis_names
                if a != "model") if st.shards else True
    if owner and (m0 or not on_model):
        M[first(M)] = float("nan")
    rep = health.factor_report(opt, st.factors, st.shards)
    return bi, rep[f"bucket{bi}/factor_nonfinite"]


def _tp_taps(ctx, case):
    """``kfac_grads`` on the model mesh from the reference's parameters:
    the loss, the acts and probe gradients (whole on every rank), the
    gradients gathered whole, and the rows each forward saw."""
    from repro_torch.data.synthetic import rank_rows
    from repro_torch.models import layers
    from repro_torch.train import loop as tloop
    mesh = _tp_mesh(ctx, case["mesh"])
    lm, params = _tp_lm(ctx, case, mesh)
    sp = lm.sp
    seen = RowsSeen(lm)
    local = rank_rows({n: _t(v) for n, v in case["batch"].items()},
                      sp.dp_index, sp.dp_size)
    loss, acts, gp, gprobe = tloop.kfac_grads(
        lm.loss_fn, params, layers.make_probes(lm.taps, device=ctx.cpu),
        local, sp)
    return {"loss": float(loss), "rows": seen.rows,
            "held": _blocks_held(lm, params),
            "acts": {k: _np(v) for k, v in acts.items()},
            "probe_grads": {k: _np(v) for k, v in gprobe.items()},
            "grads": _whole(lm, gp)}


def _tp_archs(ctx, case):
    """Every architecture's ``build_train_step`` (stats, light, heavy;
    remat) on the (1, 2) mesh, one step from the port's seeded parameters
    (each rank its blocks); the ranks outside the mesh wait."""
    import torch
    from repro_torch.configs.base import ShapeCell
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps as tsteps
    mesh = _tp_mesh(ctx, "1x2")
    out = {}
    if not mesh.member:
        return out
    B, T = case["B"], case["T"]
    for name, batch in case["batches"].items():
        tb = tsteps.build_train_step(
            dp_arch((name, 0)), mesh=mesh, cell=ShapeCell("t", T, B, "train"),
            flags=dict(do_stats=True, do_light=True, do_heavy=True),
            device=ctx.cpu)
        params = tb.lm.init(torch.Generator().manual_seed(0))
        held = _blocks_held(tb.lm, params)
        local = shd.localize({k: _t(v) for k, v in batch.items()},
                             tb.in_shardings[2])
        with continuation_replay() as shifts, applied_updates() as upd, \
                gathers_seen() as gathered:
            p, st, loss = tb.step_fn(params, tb.opt.init(params), local,
                                     torch.Generator().manual_seed(1))
        out[name] = {"loss": float(loss), "held": held, "shifts": shifts,
                     "updates": _whole(tb.lm, upd[0]),
                     "mu": _whole(tb.lm, st.fallback.mu),
                     "factor_numel": factor_numel(st),
                     "gathered": gathered,
                     "tapped": sorted(t.param_path
                                      for t in tb.opt.taps.values())}
    return out


@contextlib.contextmanager
def gathers_seen():
    """The parameter paths of every ``ModelShards.gather`` (a leaf
    gathered whole over "model") while the block runs."""
    from repro_torch.distributed import sharding as shd
    orig, seen = shd.ModelShards.gather, []

    def recorded(self, path, x):
        if self.dim(path) is not None:
            seen.append(path)
        return orig(self, path, x)
    shd.ModelShards.gather = recorded
    try:
        yield seen
    finally:
        shd.ModelShards.gather = orig


def factor_numel(opt_state) -> dict:
    """{"factors/<tap>/<side>/<field>": entries this rank holds}."""
    return {f"factors/{n}/{side}/{f}": getattr(getattr(ts, side), f).numel()
            for n, ts in opt_state.factors.items() for side in "AG"
            for f in ("U", "D", "M", "aux")}


def _tp_rows_brand(ctx, case):
    """``kfactor.brand_step`` on the model mesh: each d of the case's
    (its init from X0, then the Brand update with X1, plain and through
    the kernels' passes) on the rank's rows where the model axis divides
    d (``ModelShards.factor_rows``), U gathered whole → {key: (U, D)}."""
    import torch
    from repro_torch.core import kfactor
    from repro_torch.distributed import sharding as shd
    mesh = _tp_mesh(ctx, case["mesh"])
    out = {}
    for d, (X0, X1) in case["inputs"].items():
        ms = shd.ModelShards({"w": torch.empty((d, d), device="meta")}, mesh)
        rows = ms.factor_rows(d)
        spec = kfactor.KFactorSpec(d=d, r=case["r"], n_stat=X0.shape[-1],
                                   mode=kfactor.Mode.BRAND)
        stack = X0.shape[:-2]
        for uk in (False, True):
            st = kfactor.make_state(d, spec.width, False,
                                    rows=rows and rows.rb)
            st = st.map(lambda x: x.expand(stack + x.shape).clone())
            local = (lambda x: x) if rows is None else rows.take
            st = kfactor.brand_step(spec, st, local(_t(X0)), True, uk, rows)
            st = kfactor.brand_step(spec, st, local(_t(X1)), False, uk, rows)
            U = st.U if rows is None else rows.gather(st.U)
            out[(d, uk)] = {"U": _np(U), "D": _np(st.D),
                            "rows": None if rows is None else rows.rb}
    return out


def _tp_rows_apply(ctx, case):
    """The optimizer's bucketed preconditioning on the model mesh for a
    column-parallel, a row-parallel, a replicated and an expert-stacked
    tap (``Kfac._bucketed_precondition``: each rank its blocks of the
    gradients and its row blocks of the factors, plain and with
    ``use_kernels``) → {(tap, use_kernels): the rank's block of S},
    and the leaves ``ModelShards.gather`` gathered whole."""
    import dataclasses as dc
    import torch
    from repro_torch.core import kfac as tkfac
    from repro_torch.core import kfactor
    from repro_torch.core import policy
    from repro_torch.distributed import sharding as shd
    mesh = _tp_mesh(ctx, case["mesh"])
    taps = {n: tkfac.TapInfo(**t) for n, t in case["taps"].items()}
    abstract = {t.param_path: torch.empty(t.stack + (t.d_in, t.d_out),
                                          device="meta")
                for t in taps.values()}
    ms = shd.ModelShards(abstract, mesh, taps={n: t.param_path
                                               for n, t in taps.items()})
    out = {"gathered": []}
    for uk in (False, True):
        cfg = tkfac.KfacConfig(policy=policy.PolicyConfig(**case["policy"]),
                               use_kernels=uk)
        opt = tkfac.Kfac(cfg, taps, device=ctx.cpu)
        opt.model_shards = ms
        factors, grads = {}, {}
        for n, t in taps.items():
            sides = {}
            for side in "AG":
                rows = opt._factor_rows(opt.specs[n][side])
                U = _t(case["factors"][n][side]["U"])
                sides[side] = kfactor.KFactorState(
                    U=U if rows is None else rows.take(U).clone(),
                    D=_t(case["factors"][n][side]["D"]),
                    M=torch.zeros(t.stack + (1, 1)),
                    aux=torch.zeros(t.stack + (kfactor.AUX_WIDTH,)))
            factors[n] = tkfac.TapState(**sides)
            grads[t.param_path] = ms.block(t.param_path,
                                           _t(case["grads"][n]))
        with gathers_seen() as seen:
            S = opt._bucketed_precondition(factors, grads, None, None,
                                           case["phi"])
        out["gathered"] += seen
        out.update({(n, uk): _np(v) for n, v in S.items()})
        out["kinds"] = {n: opt._precond_kind(n) for n in taps}
    out["coord"] = mesh.coord("model")
    return out


@contextlib.contextmanager
def applied_updates():
    """The updates every ``optim/base.py::apply_updates`` call adds while
    the block runs (copies, in the yielded list): a step's change before
    fp32 rounds it into parameters many times its size."""
    from repro_torch.optim import base as optbase
    orig, got = optbase.apply_updates, []

    def recorded(params, updates):
        got.append({k: v.detach().clone() for k, v in updates.items()})
        return orig(params, updates)
    optbase.apply_updates = recorded
    try:
        yield got
    finally:
        optbase.apply_updates = orig


def _tp_serve(ctx, case):
    """The prefill and decode builders on the model mesh from the port's
    seeded parameters: the prefill's vocabulary blocks gathered (this
    rank's rows), and decode's logits in every cache layout over a cache
    whose shards the tokens cross; the long-context decode (B = 1, the
    sequence over every axis, ring caches)."""
    import torch
    from repro_torch.configs.base import ShapeCell
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps as tsteps
    mesh = _tp_mesh(ctx, case["mesh"])
    arch = dp_arch(case["arch"])
    B, T = case["B"], case["T"]
    tokens = _t(case["tokens"])
    pb = tsteps.build_prefill_step(arch, mesh=mesh, cell=ShapeCell(
        "p", T, B, "prefill"), device=ctx.cpu)
    params = pb.lm.init(torch.Generator().manual_seed(0))
    local = shd.localize({"tokens": tokens}, pb.in_shardings[1])
    lg = pb.step_fn(params, local)
    out = {"prefill_block": list(lg.shape),
           "prefill": _np(coll.all_gather(lg, mesh, "model", 2))}
    for name, cell, layout, window, n in case["decodes"]:
        db = tsteps.build_decode_step(arch, mesh=mesh, cell=ShapeCell(
            cell, case["S"], B if cell != "long_500k" else 1, "decode"),
            cache_layout=layout, window_caches=window, device=ctx.cpu)
        Bd = B if cell != "long_500k" else 1
        rep = (tsteps.kv_rep_for(arch, mesh)
               if layout == "heads" and cell != "long_500k" else 1)
        cache = shd.localize(db.lm.init_cache(Bd, case["S"],
                                              window_caches=window,
                                              kv_rep=rep),
                             db.in_shardings[1])
        tok = shd.localize(tokens[:Bd], db.in_shardings[2])
        got = []
        for t in range(n):
            lgd, cache = db.step_fn(params, cache, tok[:, t:t + 1], t)
            got.append(_np(lgd))
        out[name] = {"logits": got,
                     "cache_k": list(cache["0"]["p0"]["k"].shape)}
    return out


def _tp_compress(ctx, case):
    """``compress_tree`` of sharded leaves over the 2 × 2 mesh: each data
    rank's share of the global gradients, this rank's block of it; rounds
    with error feedback from the given bases → this rank's block of the
    reduced approximations and of its error, each round."""
    import dataclasses as dc
    import torch
    from repro_torch.distributed import compress as tcomp
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps as tsteps
    mesh = _tp_mesh(ctx, case["mesh"])
    abstract = {k: torch.empty(s, device="meta")
                for k, s in case["shapes"].items()}
    ms = shd.ModelShards(abstract, mesh)
    sp = dc.replace(tsteps.shard_policy_for(mesh), shards=ms)
    cfg = tcomp.CompressConfig(**case["cfg"])
    r = sp.dp_index
    blk = lambda k, v: ms.block(k, _t(v))
    shares = case["shares"]
    state = tcomp.init_state({k: blk(k, v) for k, v in shares[0][r].items()},
                             cfg, bases={k: _t(v) for k, v in
                                         case["bases"].items()}, sp=sp)
    out = []
    for round_ in shares:
        grads = {k: blk(k, v) for k, v in round_[r].items()}
        approx, state = tcomp.compress_tree(grads, state, cfg, sp=sp)
        out.append({"approx": {k: _np(v) for k, v in approx.items()},
                    "err": {k: _np(v) for k, v in state.err.items()},
                    "dims": {k: ms.dim(k) for k in approx}})
    return {"rounds": out, "coord": (mesh.coord("data"),
                                     mesh.coord("model"))}


def _tp_cli(ctx, case):
    """The CLI on the case's model mesh with ``--compress`` and a
    checkpoint directory: its losses, compressed gradients and final
    parameters (gathered whole), rank 0's log."""
    from repro_torch.distributed import compress as tcomp
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch import train as ttrain
    from repro_torch.models.lm import LM
    grads, compress_tree = [], tcomp.compress_tree

    def recorded(gp, cs, cfg, sp=None):      # the leaves compressed whole
        out, cs = compress_tree(gp, cs, cfg, sp=sp)
        grads.append({k: v.detach().clone() for k, v in out.items()
                      if tcomp._compressible(v, cfg, sp, k)})
        return out, cs
    tcomp.compress_tree = recorded
    args = ttrain.parse_args(case["argv"])
    try:
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            state, losses = ttrain.run(args, arch=dp_arch(case["arch"]))
    finally:
        tcomp.compress_tree = compress_tree
    lm = LM(dp_arch(case["arch"]), tsteps.shard_policy_for(
        ttrain.mesh_of(args)), device=ctx.cpu)
    ms = lm.sp.shards
    return {"losses": losses, "log": buf.getvalue(),
            "held": _blocks_held(lm, state.params),
            "grads": [{k: _np(ms.gather(k, v)) for k, v in g.items()}
                      for g in grads],
            "after": _whole(lm, state.params)}


def _tp_health(ctx, case):
    """The CLI with ``--health`` on the model mesh: its losses and the
    guard's verdicts (each rank reads the same report: the sums and
    maxima of the sharded leaves' blocks reduced over "model")."""
    from repro_torch.launch import train as ttrain
    from repro_torch.train import health
    reports, make = [], health.health_report

    def recorded(*a, **kw):
        rep = make(*a, **kw)
        reports.append({k: rep[k] for k in ("ok", "grad_nonfinite",
                                            "update_nonfinite")})
        return rep
    health.health_report = recorded
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            _, losses = ttrain.run(ttrain.parse_args(case["argv"]),
                                   arch=dp_arch(case["arch"]))
    finally:
        health.health_report = make
    return {"losses": losses, "reports": reports}


def _tp_restore(ctx, case):
    """The CLI's checkpoint restored onto the model mesh (its
    ``state_shardings``): the blocks this rank holds, gathered whole."""
    import torch
    from repro_torch.core import kfac as tkfac
    from repro_torch.launch import train as ttrain
    from repro_torch.models.lm import LM
    from repro_torch.launch import steps as tsteps
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import loop as tloop
    args = ttrain.parse_args(case["argv"])
    mesh = ttrain.mesh_of(args)
    lm = LM(dp_arch(case["arch"]), tsteps.shard_policy_for(mesh),
            device=ctx.cpu)
    opt = tkfac.Kfac(ttrain.kfac_config_of(args), lm.taps, device=ctx.cpu)
    opt.model_shards = lm.sp.shards
    curv, rows = ttrain.curvature_axes(args, mesh)
    from repro_torch import specs
    specs.DistSpec(mesh=mesh, curvature_axis=curv, row_axis=rows).attach(opt)
    params = lm.init(torch.Generator().manual_seed(5))
    state = tloop.TrainState(params=params, opt=opt.init(params),
                             rng=torch.Generator().manual_seed(1))
    state, man = ckpt.restore(case["dir"], state,
                              shardings=ttrain.state_shardings(lm, opt))
    return {"step": int(man["step"]), "held": _blocks_held(lm, state.params),
            "params": _whole(lm, state.params),
            "mu": _whole(lm, {k: v for k, v in state.opt.fallback.mu.items()
                              if lm.sp.shards.sharded(k)})}


def _tp_fsdp(ctx, case):
    """``plan="fsdp"`` on the model mesh: three builder steps (stats,
    light, heavy) from the port's seeded parameters (this rank's blocks)
    and the case's batches (its block of each), each step's update and
    the final parameters and state gathered whole, the continuation
    shifts recorded; then the state saved (gathered, rank 0 writes) and
    restored in one process (rank 0, into the one-process builder's
    template) and back onto the ranks (``shardings=`` the step's
    ``in_shardings``): the leaves that differ from what was saved or
    held."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeCell
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps as tsteps
    from repro_torch.models.lm import LM
    from repro_torch.train import checkpoint as ck
    from repro_torch.train import loop as tloop
    arch = dp_arch(case["arch"])
    B, T = case["batches"][0]["tokens"].shape
    cell = ShapeCell("t", T, B, "train")
    tb = tsteps.build_train_step(arch, mesh=_tp_mesh(ctx, case["mesh"]),
                                 cell=cell, flags=case["flags"],
                                 plan="fsdp", device=ctx.cpu)
    p_sh, o_sh, b_sh = tb.in_shardings[:3]
    fresh = lambda seed: {k: v.detach().requires_grad_() for k, v in
                          shd.localize(LM(arch, device=ctx.cpu).init(
                              torch.Generator().manual_seed(seed)),
                              p_sh).items()}
    params = fresh(0)
    st = tb.opt.init(params)
    losses = []
    with continuation_replay() as shifts, applied_updates() as upd:
        for k, batch in enumerate(case["batches"]):
            local = shd.localize({n: _t(v) for n, v in batch.items()}, b_sh)
            params, st, loss = tb.step_fn(params, st, local,
                                          torch.Generator().manual_seed(
                                              1 + k))
            losses.append(float(loss))
    out = {"losses": losses, "shifts": shifts,
           "updates": [fsdp_leaves(u, p_sh) for u in upd],
           "held": {"params": fsdp_held(params, p_sh, tb.abstract_params),
                    "opt": fsdp_held(st, o_sh, tb.abstract_opt)},
           "state": fsdp_leaves(st, o_sh)}
    saved = tloop.TrainState(params=shd.globalize(params, p_sh),
                             opt=shd.globalize(st, o_sh),
                             rng=torch.Generator().manual_seed(9))
    if ctx.rank == 0:
        ck.save(case["dir"], len(losses), saved)
    dist.barrier()
    same = lambda a, b: sorted(
        k for k, v in ck.leaves(a).items() if isinstance(v, torch.Tensor)
        and not torch.equal(v.detach(), ck.leaves(b)[k].detach()))
    if ctx.rank == 0:
        one = tsteps.build_train_step(arch, cell=cell, device=ctx.cpu)
        p1 = one.lm.init(torch.Generator().manual_seed(5))
        tmpl = tloop.TrainState(params=p1, opt=one.opt.init(p1),
                                rng=torch.Generator())
        restored, _ = ck.restore(case["dir"], tmpl)
        out["restored_one"] = same(restored, saved)
    p4 = fresh(5)
    tmpl = tloop.TrainState(params=p4, opt=tb.opt.init(p4),
                            rng=torch.Generator())
    back, _ = ck.restore(case["dir"], tmpl, shardings=tloop.TrainState(
        params=p_sh, opt=o_sh, rng=None))
    out["restored_back"] = same(back, tloop.TrainState(
        params=params, opt=st, rng=saved.rng))
    return out


def _tp_dryrun(ctx, case):
    """One builder step under ``case["plan"]`` on the 2 × 2 mesh as the
    meta dry-run counts it (``launch/dryrun.py``): from the seeded
    parameters (this rank's blocks) a first step, then the counted one
    (stats and light, past the first update): its collectives by function
    and by the reference's kinds and axes (``collectives.counting``), its
    matmul flops (``FlopCounterMode`` and ``hlo_analysis.DotCounter`` by
    dtype), the bytes of its arguments and of the state it hands back."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.base import ShapeCell
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun, hlo_analysis
    from repro_torch.launch import steps as tsteps
    from repro_torch.models.lm import LM
    arch = dp_arch(case["arch"])
    B, T = case["batches"][0]["tokens"].shape
    tb = tsteps.build_train_step(arch, mesh=_tp_mesh(ctx, case["mesh"]),
                                 cell=ShapeCell("t", T, B, "train"),
                                 plan=case["plan"], device=ctx.cpu)
    p_sh, o_sh, b_sh = tb.in_shardings[:3]
    params = {k: v.detach().requires_grad_() for k, v in shd.localize(
        LM(arch, device=ctx.cpu).init(torch.Generator().manual_seed(0)),
        p_sh).items()}
    st = tb.opt.init(params)
    local = [shd.localize({n: _t(v) for n, v in b.items()}, b_sh)
             for b in case["batches"]]
    params, st, _ = tb.step_fn(params, st, local[0], None)
    args = dryrun.tree_bytes([params, st, local[1]])
    dots, flops = hlo_analysis.DotCounter(), FlopCounterMode(display=False)
    with coll.counting() as tally, dots, flops:
        params, st, _ = tb.step_fn(params, st, local[1], None)
    return {"by_name": {k: {"bytes": v[0], "calls": v[1]}
                        for k, v in tally.by_name.items()},
            "by_kind": dict(tally.by_kind), "by_axis": dict(tally.by_axis),
            "flops": flops.get_total_flops(), "by_dtype": dots.by_dtype,
            "args": args, "held": dryrun.tree_bytes([params, st])}


def suite_tp(ctx, cases):
    kinds = {"step": _tp_step, "taps": _tp_taps, "archs": _tp_archs,
             "serve": _tp_serve, "compress": _tp_compress, "cli": _tp_cli,
             "restore": _tp_restore, "fsdp": _tp_fsdp, "dryrun": _tp_dryrun,
             "health": _tp_health, "rows_brand": _tp_rows_brand,
             "rows_apply": _tp_rows_apply}
    return {case["name"]: kinds[case["kind"]](ctx, case) for case in cases}


SUITES = {"engine": suite_engine, "mesh": suite_mesh, "dp": suite_dp,
          "tp": suite_tp}


def main(argv):
    suite, job, rank, world, rdv, out_dir = argv
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            rank=int(rank), world_size=int(world),
                            timeout=datetime.timedelta(seconds=90))
    with open(job, "rb") as f:
        pending = pickle.load(f)
    ctx = Ctx()
    res = {}
    while pending:
        case = pending.pop(0)
        if case.get("kind") == "later":      # the parent's later cases
            pending[:0] = _wait_for(case["path"], case["timeout"])
            continue
        try:
            res.update(SUITES[suite](ctx, [case]))
        except Exception:
            res[case["name"]] = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"{suite}_{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
