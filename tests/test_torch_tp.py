"""The port's tensor-parallel execution of the LM on a mesh whose model
axis is larger than 1, on one world of four ``gloo`` CPU ranks
(``tests/torch_dist_worker.py``'s ``tp`` suite, spawned once; the
oracles are computed in this process meanwhile).

* **Against the reference's one-device step** on the global batch (its
  CLI step at ``--reduced``'s optimizer, jitted, two steps of stats,
  light and heavy work from the reference's parameters, its RSVD draws
  injected; ``test_torch_dp.py``'s oracle): the depth-cut reduced gemma3
  under bkfac and brkfac on (1, 4) and (2, 2) [data, model] (on (2, 2)
  the curvature engine on "data", as ``--curvature auto`` picks: its
  gathers run over the data ranks at each model coordinate), reduced
  llama4-scout with its experts on "model" at a batch whose experts
  overflow, reduced mamba2 and recurrentgemma (their fused fan-outs split
  across the ranks), reduced deepseek (MLA), reduced whisper and the
  same with an odd vocabulary (``fit_spec`` leaves the embedding and the
  head replicated).  Losses at 1e-5 relative, each parameter's change at
  2e-3 of the reference change's scale (``test_torch_dp.py``'s
  tolerances); each rank holds only its block of every sharded leaf.
* **Gradients.**  ``kfac_grads`` on (2, 2) from the reference's
  parameters: every gradient, the norm scales' among them (a replicated
  parameter ahead of the sequence gather sees only its T-block on a
  rank: a missing sum over "model" halves it), against the reference's
  ``kfac_grads`` at 1e-5 of scale; the acts and probe gradients against
  the port's one-process run, row for row, at 1e-5 of scale (the dense
  cut on (2, 2), the MoE with an expert a rank on (1, 4)).
* **PowerSGD.**  ``compress_tree`` of leaves split over "model" by their
  columns, their rows and their experts, on (2, 2), against the
  reference's compression of the whole global gradient, three rounds
  with error feedback: each rank's block of the approximation at 1e-5 of
  its scale, the data ranks' errors summed at 1e-5.  The CLI with
  ``--compress`` on (2, 2) against the port's one-process CLI (losses at
  1e-5, the compressed gradients the first round at 1e-5 and later at
  2e-3, each change at 2e-3 but the embedding's, as in
  ``test_torch_dp.py``).
* **Against the port's one-process run**: all ten architectures' builder
  step on (1, 2); prefill (the vocabulary blocks gathered) and decode on
  (2, 2) in the "seq", "heads" and "hd" cache layouts past a cache-shard
  boundary, and the long-context decode (B = 1, the sequence over all
  four ranks, ring caches) past its shard boundaries: logits at 1e-5 of
  scale.
* **Checkpoints.**  The CLI's checkpoint saved on (2, 2) restores in one
  process (the one-device format: the parameters the ranks hold,
  gathered) and back onto (2, 2) (each rank its blocks again).
* **Factor rows on "model".**  Each rank holds its row block of every
  factor U and M the reference's ``kfac_state_sharding`` shards: a rank's
  held entries of every factor leaf (all ten architectures on (1, 2))
  equal the reference rule's per-device ones, and no step (the CLI's
  step cases, the builders') gathers a tapped parameter's gradient whole
  (counted at ``ModelShards.gather``).  The row-block Brand update
  (``kfactor.brand_step``: the TSQR init, then the update; plain and
  through the kernels' passes, their plain versions here) on (1, 4)
  against the one-device one, as U diag(D) Uᵀ at 1e-5 of scale, for a
  d the axis divides (rows of 8, fewer than the panel's 12 columns) and
  one it does not (replicated).  The bucketed preconditioning of a
  column-parallel, a row-parallel (the two in one bucket), a replicated
  and an expert-stacked tap on the ranks' blocks against
  ``precondition_with_damping`` of the whole, at 1e-5 of scale.
* **FSDP** (``plan="fsdp"`` on (2, 2), the cut): three builder steps
  (stats, light, heavy) from the port's seeded parameters, so that state
  carried in blocks crosses steps, against the same steps in one process
  with the FSDP run's continuation shifts replayed: losses at 1e-5, each
  step's tapped updates, the final AdamW moments and factors at 2e-3 of
  scale; every rank holds its blocks; the state's checkpoint (saved
  gathered) restores in one process and back onto the four ranks under
  the step's ``in_shardings``, bit for bit.
* **The meta dry-run** (``launch/dryrun.py``, run first in an oracle
  process over a fake world of four): rank 0's light builder step under
  ``plan="tp"`` and ``plan="fsdp"`` on (2, 2), after a first step, has
  exactly the dry-run's collectives (bytes handed in and calls by
  function; the reference-convention bytes by kind and axis), matmul
  flops, argument bytes and held bytes.
"""
import concurrent.futures
import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.distributed import compress as jcomp  # noqa: E402
from repro.models.lm import LM as JLM  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ARCH_NAMES, ShapeCell  # noqa: E402
from repro_torch.core import kfac as tkfac  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.distributed import compress as tcomp  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro.core import kfac as jkfac  # noqa: E402
from repro.core import kfactor as jkfactor  # noqa: E402
from repro.core import precond as jprecond  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from test_torch_dp import STEPS, _close, jarch, jkfac_config  # noqa: E402
from test_torch_dp import lm_batch, ref_draws  # noqa: E402
from test_torch_mesh import _Spec, jspecs, stand_in  # noqa: E402
import torch_dist_worker as worker  # noqa: E402

CPU = torch.device("cpu")
REL = 1e-5
TRAJ = 2e-3
B, T = 4, 16
MOE = ("llama4_scout_17b_a16e", 0)
MOE_B, MOE_T = 8, 8     # 64 tokens over 4 experts: capacity 21, tokens drop
CUT = ("cut", 0)
CLI = ["--reduced", "--steps", "3", "--device", "cpu", "--compress"]
HEALTH = ["--reduced", "--steps", "3", "--device", "cpu", "--health"]
FSDP_FLAGS = dict(do_stats=True, do_light=True, do_heavy=True)

#: (case name, arch, variant, mesh, B, T)
STEP_CASES = (
    ("cut-bkfac-1x4", CUT, "bkfac", "1x4", B, T),
    ("cut-bkfac-2x2", CUT, "bkfac", "2x2", B, T),
    ("cut-brkfac-1x4", CUT, "brkfac", "1x4", B, T),
    ("cut-brkfac-2x2", CUT, "brkfac", "2x2", B, T),
    ("moe-bkfac-2x2", MOE, "bkfac", "2x2", MOE_B, MOE_T),
    ("mamba2-bkfac-2x2", ("mamba2_2p7b", 0), "bkfac", "2x2", B, T),
    ("rglru-bkfac-1x4", ("recurrentgemma_2b", 0), "bkfac", "1x4", B, T),
    ("mla-bkfac-2x2", ("deepseek_v3_671b", 0), "bkfac", "2x2", B, T),
    ("whisper-bkfac-2x2", ("whisper_medium", 0), "bkfac", "2x2", B, T),
    ("whisper-odd-vocab-bkfac-1x4", ("whisper_medium", 257), "bkfac", "1x4",
     B, T),
    # the curvature engine's slots on "curv" and its M rows on "data", the
    # factors' U rows on "model"
    ("cut-brkfac-rows-1x2x2", CUT, "brkfac", "1x2x2", B, T))
#: the serve case's decodes: (name, cell, layout, window caches, tokens)
DECODES = (("seq", "d", "seq", False, 12), ("heads", "d", "heads", False, 12),
           ("hd", "d", "hd", False, 12), ("long", "long_500k", "seq", True, 14))
S = 16                   # decode cache slots: 8 a rank in "seq" on (2, 2)
#: leaves PowerSGD compresses, split over "model" by their columns, their
#: rows (under a stacked repeat) and their experts
#: the row-block Brand update: d's of which the model axis of 4 divides
#: the first (rows of 8, fewer than the panel's ROWS_N columns) and not
#: the second; (rank, stack, panel columns)
ROWS_D = (32, 30)
ROWS_R, ROWS_STACK, ROWS_N = 6, (2,), 12
#: the row-block preconditioning's taps: column- and row-parallel in one
#: bucket, a replicated one, an expert stack (an expert a rank on 4)
APPLY_TAPS = {
    "col": dict(param_path="p/mix/wq", d_in=48, d_out=48, stack=(2,),
                n_stat=8),
    "row": dict(param_path="p/mix/wo", d_in=48, d_out=48, stack=(2,),
                n_stat=8),
    "rep": dict(param_path="p/ffn/router", d_in=48, d_out=8, stack=(2,),
                n_stat=8),
    "exp": dict(param_path="p/ffn/wi", d_in=48, d_out=32, stack=(1, 4),
                n_stat=8)}
APPLY_POLICY = dict(variant="bkfac", r=8)
APPLY_PHI = 0.1
COMPRESS_SHAPES = {"segments/0/p0/mix/wq": (2, 48, 64),
                   "segments/0/p0/mix/wo": (2, 64, 48),
                   "segments/0/p0/ffn/wi": (1, 4, 32, 24),
                   "final_ln": (16, 8)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small ops: one intra-op thread, as the LM tests pin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _compress_case(rs):
    """Three rounds of the two data ranks' shares of whole leaves, and the
    reference's cold-start bases."""
    cfg = dict(rank=4, min_size=1024, n_power_iter=1)
    shares = [[{k: rs.standard_normal(s).astype(np.float32)
                for k, s in COMPRESS_SHAPES.items()} for _ in range(2)]
              for _ in range(3)]
    bases = {}
    for k, s in COMPRESS_SHAPES.items():
        m, n = int(np.prod(s[:-1])), s[-1]
        if np.prod(s) >= cfg["min_size"]:
            bases[k] = np.asarray(jax.random.normal(
                jax.random.PRNGKey(m * 1315423911 + n),
                (n, min(cfg["rank"], m, n))))
    return {"cfg": cfg, "shares": shares, "bases": bases,
            "shapes": COMPRESS_SHAPES}


def _rows_brand_case(rs):
    return {"name": "rows-brand", "kind": "rows_brand", "mesh": "1x4",
            "r": ROWS_R, "inputs": {
                d: tuple(rs.standard_normal(ROWS_STACK + (d, ROWS_N))
                         .astype(np.float32) for _ in range(2))
                for d in ROWS_D}}


def _one_rows_brand(case):
    """The reference's one-device ``brand_step``s of the row-block case
    (``use_kernel`` through its plain versions on the CPU)."""
    out = {}
    for d, (X0, X1) in case["inputs"].items():
        spec = jkfactor.KFactorSpec(d=d, r=case["r"], n_stat=ROWS_N,
                                    mode=jkfactor.Mode.BRAND)
        for uk in (False, True):
            st = jax.tree_util.tree_map(
                lambda x: jnp.broadcast_to(x, ROWS_STACK + x.shape),
                spec.init())
            st = jkfactor.brand_step(spec, st, jnp.asarray(X0), True, uk)
            st = jkfactor.brand_step(spec, st, jnp.asarray(X1), False, uk)
            out[(d, uk)] = (np.asarray(st.U), np.asarray(st.D))
    return out


def _rows_apply_case(rs):
    """Whole factors (orthonormal U, descending D ≥ 0) and gradients of
    the APPLY_TAPS."""
    taps = {n: tkfac.TapInfo(**t) for n, t in APPLY_TAPS.items()}
    specs = tkfac.Kfac(tkfac.KfacConfig(
        policy=tpolicy.PolicyConfig(**APPLY_POLICY)), taps, device=CPU).specs
    factors, grads = {}, {}
    for n, t in taps.items():
        factors[n] = {}
        for side, d in (("A", t.d_in), ("G", t.d_out)):
            w = specs[n][side].width
            U = np.linalg.qr(rs.standard_normal(t.stack + (d, w)))[0]
            D = -np.sort(-rs.uniform(0.0, 2.0, t.stack + (w,)), axis=-1)
            factors[n][side] = {"U": U.astype(np.float32),
                                "D": D.astype(np.float32)}
        grads[n] = rs.standard_normal(t.stack + (t.d_in, t.d_out)
                                      ).astype(np.float32)
    return {"name": "rows-apply", "kind": "rows_apply", "mesh": "1x4",
            "taps": APPLY_TAPS, "policy": APPLY_POLICY, "phi": APPLY_PHI,
            "factors": factors, "grads": grads}


def _one_rows_apply(case):
    """The reference's ``precondition_with_damping`` of each whole tap,
    in its parameter layout."""
    out = {}
    for n in case["taps"]:
        f = {s: {k: jnp.asarray(v) for k, v in case["factors"][n][s]
                 .items()} for s in "AG"}
        J = jnp.swapaxes(jnp.asarray(case["grads"][n]), -1, -2)
        out[n] = np.swapaxes(np.asarray(jprecond.precondition_with_damping(
            J, f["G"]["U"], f["G"]["D"], f["A"]["U"], f["A"]["D"],
            case["phi"])), -1, -2)
    return out


def ref_run(spec, variant, Bg, Tg):
    """``test_torch_dp.py``'s oracle (the reference CLI's step, jitted,
    ``STEPS`` steps of stats, light and heavy work on global batches),
    which also keeps the AdamW fallback's first moments."""
    arch = jarch(spec)
    lm = JLM(arch)
    params = lm.init(jax.random.PRNGKey(0))
    opt = jkfac.Kfac(jkfac_config(variant), lm.taps)
    step = jax.jit(jloop.make_scheduled_kfac_step(lm.loss_fn, opt, Bg * Tg),
                   static_argnames=("work",))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    init = np_tree(params)
    state = jloop.TrainState(params=params, opt=opt.init(params),
                             rng=jax.random.PRNGKey(1))
    work = opt.uniform_work(True, True, True)
    batches = [lm_batch(arch, Bg, Tg, seed=10 + k) for k in range(STEPS)]
    draws, losses = [], []
    for b in batches:
        draws.append(ref_draws(opt, jax.random.split(state.rng)[1], work))
        state, loss = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                           work)
        losses.append(float(loss))
    case = {"arch": spec, "variant": variant, "init": init,
            "batches": batches, "draws": draws, "n_tokens": Bg * Tg}
    return case, {"losses": losses, "after": np_tree(state.params),
                  "init": init, "mu": np_tree(state.opt.fallback.mu)}


def _tapped(spec) -> set:
    return {t.param_path for t in TLM(worker.dp_arch(spec),
                                      device=torch.device("meta")).taps.values()}


def _ref_compress(case):
    cfg = jcomp.CompressConfig(**case["cfg"])
    total = lambda rnd: {k: jnp.asarray(sum(r[k] for r in rnd))
                         for k in COMPRESS_SHAPES}
    state = jcomp.init_state(total(case["shares"][0]), cfg)
    out = []
    for rnd in case["shares"]:
        approx, state = jcomp.compress_tree(total(rnd), state, cfg)
        out.append(({k: np.asarray(v) for k, v in approx.items()},
                    {k: np.asarray(v) for k, v in state.err.items()}))
    return out


def _ref_grads(spec, params, batch):
    """The reference's ``kfac_grads`` (its loss and parameter gradients)
    of the whole batch."""
    lm = JLM(jarch(spec))
    probes = jlayers.make_probes(lm.taps, jnp.float32)
    loss, _, gp, _ = jax.jit(lambda p, b: jloop.kfac_grads(
        lm.loss_fn, p, probes, b))(params, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
    return float(loss), convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, gp), device=CPU)


def _one_taps(spec, init, batch):
    lm = TLM(worker.dp_arch(spec), remat=False, device=CPU)
    params = {k: v.requires_grad_() for k, v in convert.params_from_jax(
        init, device=CPU).items()}
    loss, acts, gp, gprobe = tloop.kfac_grads(
        lm.loss_fn, params, tlayers.make_probes(lm.taps, device=CPU),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    return {"loss": float(loss), "acts": acts, "probe_grads": gprobe}


def _one_archs(batches, shifts):
    """Each architecture's builder step in one process, with the
    tensor-parallel run's spectrum-continuation shifts replayed."""
    out = {}
    for name, batch in batches.items():
        tb = tsteps.build_train_step(
            worker.dp_arch((name, 0)), cell=ShapeCell("t", T, B, "train"),
            flags=dict(do_stats=True, do_light=True, do_heavy=True),
            device=CPU)
        params = tb.lm.init(torch.Generator().manual_seed(0))
        with worker.continuation_replay(shifts[name]), \
                worker.applied_updates() as upd:
            p, st, loss = tb.step_fn(params, tb.opt.init(params),
                                     {k: torch.as_tensor(v)
                                      for k, v in batch.items()},
                                     torch.Generator().manual_seed(1))
        out[name] = {"loss": float(loss), "mu": st.fallback.mu,
                     "updates": upd[0]}
    return out


def _one_fsdp(case, shifts):
    """The FSDP case's three builder steps in one process, with the FSDP
    run's spectrum-continuation shifts replayed."""
    arch = worker.dp_arch(case["arch"])
    tb = tsteps.build_train_step(arch, cell=ShapeCell("t", T, B, "train"),
                                 flags=case["flags"], device=CPU)
    params = TLM(arch, device=CPU).init(torch.Generator().manual_seed(0))
    st, losses = tb.opt.init(params), []
    with worker.continuation_replay(shifts), \
            worker.applied_updates() as upd:
        for k, batch in enumerate(case["batches"]):
            params, st, loss = tb.step_fn(
                params, st, {n: torch.as_tensor(v) for n, v in batch.items()},
                torch.Generator().manual_seed(1 + k))
            losses.append(float(loss))
    return {"losses": losses, "updates": upd,
            "state": {k: v.detach().numpy() for k, v in
                      tckpt.leaves(st).items() if hasattr(v, "shape")}}


def _one_serve(tokens):
    arch = worker.dp_arch(CUT)
    pb = tsteps.build_prefill_step(arch, cell=ShapeCell("p", T, B, "prefill"),
                                   device=CPU)
    params = pb.lm.init(torch.Generator().manual_seed(0))
    out = {"prefill": pb.step_fn(params, {"tokens": tokens})}
    for name, cell, layout, window, n in DECODES:
        Bd = B if cell != "long_500k" else 1
        db = tsteps.build_decode_step(arch, cell=ShapeCell(cell, S, Bd,
                                                           "decode"),
                                      cache_layout=layout,
                                      window_caches=window, device=CPU)
        cache = db.lm.init_cache(Bd, S, window_caches=window)
        got = []
        for t in range(n):
            lg, cache = db.step_fn(params, cache, tokens[:Bd, t:t + 1], t)
            got.append(lg)
        out[name] = got
    return out


def dryrun_meta(spec, Bg, Tg):
    """``launch/dryrun.py``'s record of the "dryrun" cases' step under each
    plan on (2, 2), in this (spawned) process as rank 0 of a fake world of
    four → {plan: record}."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    dryrun.fake_world(4)
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"),
                              device=torch.device("meta"))
    cell = ShapeCell("t", Tg, Bg, "train")
    out = {plan: dryrun.analyse_cell(worker.dp_arch(spec), cell, mesh,
                                     opt="fsdp" if plan == "fsdp" else "")
           for plan in ("tp", "fsdp")}
    torch.distributed.destroy_process_group()
    return out


def _oracle_pool(submit, workers=4):
    """A pool of ``workers`` fresh processes that import this module
    (its directory put on their path) → (pool, ``submit(pool)``)."""
    import multiprocessing
    import os
    old = os.environ.get("PYTHONPATH")
    here = os.path.dirname(os.path.abspath(__file__))
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [here] + ([old] if old else []))
    try:
        pool = concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"))
        return pool, submit(pool)   # the workers start as tasks arrive
    finally:
        if old is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = old


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    # the reference's steps trace and compile in processes of their own
    # (threads would share the interpreter lock), the longest first, while
    # this process starts the ranks and computes the one-process oracles
    keys = list(dict.fromkeys((spec, variant, Bg, Tg)
                              for _, spec, variant, _, Bg, Tg in STEP_CASES))
    keys.sort(key=lambda k: k[0][0] not in ("deepseek_v3_671b", "cut"))
    # the meta dry-run of the "dryrun" cases first, in a process of its own
    # (it joins a fake world)
    pool, pending = _oracle_pool(lambda pool: {
        "dryrun": pool.submit(dryrun_meta, CUT, B, T),
        **{k: pool.submit(ref_run, *k) for k in keys}})
    root = tmp_path_factory.mktemp("tp")
    cases = []
    taps = {"cut": (CUT, "2x2", lm_batch(worker.dp_arch(CUT), B, T, 3)),
            "moe": (MOE, "1x4", lm_batch(worker.dp_arch(MOE), MOE_B,
                                         MOE_T, 3))}
    inits = {}
    for tag, (spec, mesh, batch) in taps.items():
        inits[tag] = jax.tree_util.tree_map(
            np.asarray, JLM(jarch(spec)).init(jax.random.PRNGKey(0)))
        cases.append({"name": f"taps-{tag}", "kind": "taps", "mesh": mesh,
                      "arch": spec, "batch": batch, "init": inits[tag]})
    arch_batches = {n: lm_batch(worker.dp_arch((n, 0)), B, T, 4)
                    for n in ARCH_NAMES}
    cases.append({"name": "archs", "kind": "archs", "B": B, "T": T,
                  "batches": arch_batches})
    tokens = lm_batch(worker.dp_arch(CUT), B, T, 5)["tokens"]
    cases.append({"name": "serve", "kind": "serve", "mesh": "2x2",
                  "arch": CUT, "B": B, "T": T, "S": S, "tokens": tokens,
                  "decodes": DECODES})
    comp = _compress_case(np.random.default_rng(6))
    cases.append({**comp, "name": "compress", "kind": "compress",
                  "mesh": "2x2"})
    ck = str(root / "ckpt")
    cli_argv = CLI + ["--mesh", "2x2", "--ckpt-dir", ck, "--ckpt-every", "2"]
    cases.append({"name": "cli", "kind": "cli", "arch": ("cut", 1024),
                  "argv": cli_argv})
    cases.append({"name": "restore", "kind": "restore", "arch": ("cut", 1024),
                  "argv": cli_argv, "dir": ck})
    fsdp = {"name": "fsdp", "kind": "fsdp", "arch": CUT, "mesh": "2x2",
            "batches": [lm_batch(worker.dp_arch(CUT), B, T, 11 + k)
                        for k in range(3)],
            "flags": FSDP_FLAGS, "dir": str(root / "fsdp")}
    cases.append(fsdp)
    cases.append({"name": "health", "kind": "health", "arch": CUT,
                  "argv": HEALTH + ["--mesh", "2x2"]})
    cases += [{"name": f"dryrun-{plan}", "kind": "dryrun", "plan": plan,
               "arch": CUT, "mesh": "2x2",
               "batches": [lm_batch(worker.dp_arch(CUT), B, T, 21 + k)
                           for k in range(2)]} for plan in ("tp", "fsdp")]
    rows_brand = _rows_brand_case(np.random.default_rng(7))
    rows_apply = _rows_apply_case(np.random.default_rng(8))
    cases += [rows_brand, rows_apply]
    wait, send = worker.later(str(root), "tp", timeout=240)
    join = worker.start("tp", cases + [wait], str(root), timeout=300)
    refs, steps = {}, []
    one = {"serve": _one_serve(torch.as_tensor(tokens)),
           "compress": _ref_compress(comp),
           "rows-brand": _one_rows_brand(rows_brand),
           "rows-apply": _one_rows_apply(rows_apply)}
    for tag, (spec, _, batch) in taps.items():
        one[f"taps-{tag}"] = _one_taps(spec, inits[tag], batch)
    one["grads-cut"] = _ref_grads(CUT, inits["cut"], taps["cut"][2])
    grads, compress_tree = worker.compressed_grads(tcomp)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            _, losses = ttrain.run(ttrain.parse_args(CLI),
                                   arch=worker.dp_arch(("cut", 1024)))
    finally:
        tcomp.compress_tree = compress_tree
    with contextlib.redirect_stdout(io.StringIO()):
        one["health"] = ttrain.run(ttrain.parse_args(HEALTH),
                                   arch=worker.dp_arch(CUT))[1]
    one["cli"] = {"losses": losses, "grads": grads,
                  "init": TLM(worker.dp_arch(("cut", 1024)), device=CPU
                              ).init(torch.Generator().manual_seed(0))}
    oracles = {k: f.result() for k, f in pending.items()}
    pool.shutdown()
    one["dryrun"] = oracles.pop("dryrun")
    for name, spec, variant, mesh, Bg, Tg in STEP_CASES:
        case, refs[name] = oracles[(spec, variant, Bg, Tg)]
        steps.append({**case, "name": name, "kind": "step", "mesh": mesh})
    send(steps)
    ranks = join()
    one["archs"] = _one_archs(arch_batches, {
        n: g["shifts"] for n, g in worker.ok(ranks, "archs")[0].items()})
    one["fsdp"] = _one_fsdp(fsdp, worker.ok(ranks, "fsdp")[0]["shifts"])
    return ranks, refs, one, ck


def _all(world, name):
    return worker.ok(world[0], name)


def _held(got):
    """Every sharded leaf is a strict block of its whole, and no leaf
    deviates from its block shape."""
    assert not got["wrong"], got["wrong"]
    assert got["sharded"]
    for k, (local, whole) in got["sharded"].items():
        assert np.prod(local) < np.prod(whole), k


def _changes_close(got_after, got_mu, init, after, mu, tapped, what):
    """Each tapped leaf's change at 2e-3 of its scale; an AdamW leaf by
    its first moment, at 2e-3 of scale: AdamW divides each entry by its
    own size, so a rounding-level gradient entry (a key bias's, whose
    gradient is zero in exact arithmetic) steps anywhere between 0 and the
    learning rate (ROADMAP §3)."""
    for k in after:
        if k in tapped:
            d_want = (after[k] - init[k]).numpy()
            _close(got_after[k] - init[k].numpy(), d_want, TRAJ,
                   f"{what} {k}")
        else:
            _close(got_mu[k], mu[k], TRAJ, f"{what} moment {k}")


@pytest.mark.parametrize("name", [c[0] for c in STEP_CASES])
def test_step_equals_the_reference_one_device_step(world, name):
    """The CLI's step on the model mesh ≡ the reference's one-device
    step: losses at 1e-5, each tapped parameter's change and each AdamW
    moment at 2e-3 of scale on every rank; each rank holds its blocks and
    saw its data rows."""
    want = world[1][name]
    case = next(c for c in STEP_CASES if c[0] == name)
    n_dp = int(np.prod(worker.TP_MESHES[case[3]][:-1]))
    init = convert.params_from_jax(want["init"], device=CPU)
    after = convert.params_from_jax(want["after"], device=CPU)
    mu = {k: v.numpy() for k, v in convert.params_from_jax(
        want["mu"], device=CPU).items()}
    tapped = _tapped(case[1])
    for got in _all(world, name):
        _held(got["held"])
        assert got["rows"] == [case[4] // n_dp] * 2
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=REL)
        assert set(got["mu"]) == set(after) - tapped
        _changes_close(got["after"], got["mu"], init, after, mu, tapped,
                       name)


def test_odd_vocabulary_stays_replicated(world):
    """``fit_spec`` on an odd vocabulary: whisper's embedding and head
    stay whole on every rank; its even-vocabulary run shards them."""
    odd = _all(world, "whisper-odd-vocab-bkfac-1x4")[0]["held"]["sharded"]
    even = _all(world, "whisper-bkfac-2x2")[0]["held"]["sharded"]
    assert "embed" not in odd and "head/w" not in odd
    assert even["embed"][0][0] * 2 == even["embed"][1][0]
    assert even["head/w"][0][1] * 2 == even["head/w"][1][1]


def test_gradients_equal_the_references_norm_scales_among_them(world):
    """``kfac_grads`` on (2, 2) from the reference's parameters: the loss
    and every gradient gathered whole ≡ the reference's ``kfac_grads``
    (1e-5 of scale); the norm scales are replicated parameters whose
    ranks' parts are summed over "model"."""
    loss, want = world[2]["grads-cut"]
    norms = [k for k in want if k.endswith("ln") or k.endswith("ln2")]
    assert norms
    for got in _all(world, "taps-cut"):
        assert abs(got["loss"] - loss) <= REL * abs(loss)
        assert set(got["grads"]) == set(want)
        for k, w in want.items():
            _close(got["grads"][k], w.numpy(), REL, f"grad {k}")


@pytest.mark.parametrize("tag", ["cut", "moe"])
def test_taps_are_one_process_rows(world, tag):
    """The acts (gathered over "model": a row-parallel matmul's input
    columns, an expert stack's experts) and the probe gradients (summed)
    on every rank ≡ the one-process taps, row for row (1e-5 of scale)."""
    want = world[2][f"taps-{tag}"]
    n_dp = 2 if tag == "cut" else 1
    Bg = B if tag == "cut" else MOE_B
    for got in _all(world, f"taps-{tag}"):
        _held(got["held"])
        assert got["rows"] == [Bg // n_dp]
        assert abs(got["loss"] - want["loss"]) <= REL * abs(want["loss"])
        for field in ("acts", "probe_grads"):
            assert set(got[field]) == set(want[field])
            for k, w in want[field].items():
                _close(got[field][k], w.numpy(), REL, f"{field} {k}")


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_every_architecture_on_a_1x2_mesh_equals_one_process(world, name):
    """``build_train_step`` (stats, light, heavy; remat) on (1, 2) from
    the port's seeded parameters (each rank its blocks) ≡ the same step
    in one process with the tensor-parallel step's spectrum-continuation
    shifts replayed (ROADMAP §3): loss at 1e-5, each tapped parameter's
    update (as ``apply_updates`` gets it: the clip leaves some of them
    near the fp32 rounding of their parameters) and each AdamW moment at
    2e-3 of scale."""
    want = world[2]["archs"][name]
    tapped = _tapped((name, 0))
    zero = {k: torch.zeros_like(v) for k, v in want["updates"].items()}
    mu = {k: v.numpy() for k, v in want["mu"].items()}
    got_all = _all(world, "archs")
    assert got_all[2] == got_all[3] == {}      # outside the (1, 2) mesh
    for got in got_all[:2]:
        g = got[name]
        _held(g["held"])
        assert abs(g["loss"] - want["loss"]) <= REL * abs(want["loss"])
        assert set(g["mu"]) == set(zero) - tapped
        _changes_close(g["updates"], g["mu"], zero, want["updates"], mu,
                       tapped, name)


def test_prefill_and_every_decode_layout_equal_one_process(world):
    """On (2, 2): the prefill's vocabulary blocks (half the vocabulary a
    rank) gathered ≡ the rank's rows of one process's; decode in the
    "seq", "heads" and "hd" layouts (each rank's block of the cache's
    sequence, KV heads or head dim; 12 tokens past the 8-slot shard) and
    the long-context decode (B = 1, the 16-slot ring of the local layer
    and the global layer's 16 slots over all four ranks, 14 tokens) ≡ one
    process's logits (1e-5 of scale)."""
    want = world[2]["serve"]
    arch = worker.dp_arch(CUT)
    runs = _all(world, "serve")
    for r, got in enumerate(runs):
        rows = slice((r // 2) * (B // 2), (r // 2 + 1) * (B // 2))
        assert got["prefill_block"][2] == arch.vocab // 2
        _close(got["prefill"], want["prefill"][rows].numpy(), what="prefill")
        for name, cell, layout, _, n in DECODES:
            w_rows = rows if cell != "long_500k" else slice(0, 1)
            for t in range(n):
                _close(got[name]["logits"][t],
                       want[name][t][w_rows].numpy(), what=f"{name} {t}")
        hd, Hk = arch.hd, arch.n_kv_heads
        assert got["seq"]["cache_k"][2] == S // 2
        assert got["heads"]["cache_k"][3] == Hk // 2
        assert got["hd"]["cache_k"][4] == hd // 2
        assert got["long"]["cache_k"][2] == 16 // 4


def test_powersgd_of_sharded_leaves_is_the_references(world):
    """``compress_tree`` of leaves split over "model" (by columns, by rows
    under a stacked repeat, by experts) ≡ the reference's compression of
    the whole global gradient, three rounds with error feedback: each
    rank's block of the approximation at 1e-5 of scale, the two data
    ranks' errors summed at 1e-5; the leaf under the size threshold
    summed raw."""
    want = world[2]["compress"]
    got = _all(world, "compress")
    for i, (w_approx, w_err) in enumerate(want):
        dims = got[0]["rounds"][i]["dims"]
        assert dims["segments/0/p0/mix/wq"] == 2
        assert dims["segments/0/p0/mix/wo"] == 1
        assert dims["segments/0/p0/ffn/wi"] == 1
        for k in COMPRESS_SHAPES:
            d = dims[k]

            def block(x, m):
                if d is None:
                    return x
                n = x.shape[d] // 2
                return np.take(x, range(m * n, (m + 1) * n), axis=d)
            for g in got:
                m = g["coord"][1]
                _close(g["rounds"][i]["approx"][k], block(w_approx[k], m),
                       REL, f"round {i} {k}")
            for m in range(2):
                errs = [g["rounds"][i]["err"][k] for g in got
                        if g["coord"][1] == m]
                _close(sum(errs), block(w_err[k], m), REL,
                       f"round {i} err {k}")


def test_cli_compress_on_a_2x2_mesh_equals_one_process(world):
    """``--compress`` on (2, 2) [data, model] ≡ the port's one-process CLI:
    losses at 1e-5; the compressed gradients entering the optimizer (the
    first round at 1e-5, the later ones at 2e-3); rank 0 logs the
    tensor-parallel split and the gathered gradient bytes."""
    want = world[2]["cli"]
    runs = _all(world, "cli")
    for got in runs:
        _held(got["held"])
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=REL)
        assert len(got["grads"]) == len(want["grads"]) == 3
        for k, (g, w) in enumerate(zip(got["grads"], want["grads"])):
            assert set(g) == set(w) == {"embed", "head/w"}
            for name in w:
                _close(g[name], w[name].numpy(), REL if k == 0 else TRAJ,
                       f"step {k} {name}")
    log = runs[0]["log"]
    assert "tensor parallel over model: 2 ranks" in log
    assert "data parallel over data: 2 ranks of 2 rows" in log
    assert "gathered for the preconditioning" in log
    assert all(not r["log"] for r in runs[1:])


def test_checkpoint_saved_on_a_2x2_mesh_restores_in_one_process_and_back(
        world):
    """The CLI's checkpoint on (2, 2) is the one-device format: restored
    into one process's template, its parameters are the ranks' final
    blocks gathered (bitwise); restored onto (2, 2) again through the
    CLI's shardings, each rank holds its blocks of it, the AdamW moments
    of the sharded leaves included."""
    ck = world[3]
    assert tckpt.latest_step(ck) == 2
    lm = TLM(worker.dp_arch(("cut", 1024)), device=CPU)
    args = ttrain.parse_args(CLI)
    opt = tkfac.Kfac(ttrain.kfac_config_of(args), lm.taps, device=CPU)
    params = lm.init(torch.Generator().manual_seed(5))
    state = tloop.TrainState(params=params, opt=opt.init(params),
                             rng=torch.Generator().manual_seed(1))
    state, man = tckpt.restore(ck, state)
    final = _all(world, "cli")[0]["after"]
    for k, v in state.params.items():
        np.testing.assert_array_equal(v.detach().numpy(), final[k])
    for got in _all(world, "restore"):
        assert got["step"] == 2
        _held(got["held"])
        for k, v in state.params.items():
            np.testing.assert_array_equal(got["params"][k],
                                          v.detach().numpy())
        assert got["mu"]
        for k, v in got["mu"].items():
            np.testing.assert_array_equal(
                v, state.opt.fallback.mu[k].numpy())


def test_fsdp_steps_equal_one_process_and_restore(world):
    """``plan="fsdp"`` on (2, 2) runs: three builder steps ≡ the same
    steps in one process with the FSDP run's continuation shifts replayed
    (losses at 1e-5; each step's tapped updates, the final AdamW moments,
    each factor's dense M and U diag(D) Uᵀ at 2e-3 of scale); every rank
    holds its block of every parameter and optimizer leaf; the checkpoint
    of the final state restores in one process and back onto the four
    ranks, bit for bit."""
    want = world[2]["fsdp"]
    tapped = _tapped(CUT)
    runs = _all(world, "fsdp")
    assert runs[0]["restored_one"] == []
    for got in runs:
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=REL)
        for part, h in got["held"].items():
            assert h["keys"] and not h["wrong"] and h["blocks"], part
        assert got["restored_back"] == []
        for k, (g, w) in enumerate(zip(got["updates"], want["updates"])):
            assert set(g) == set(w)
            for name in tapped:
                _close(g[name], w[name].numpy(), TRAJ, f"step {k} {name}")
        assert set(got["state"]) == set(want["state"])
        for key, w in want["state"].items():
            g = got["state"][key]
            field = key.rsplit("|", 1)[-1]
            if field == "U":
                D = key[:-1] + "D"
                rec = lambda u, d: (u * d[..., None, :]) @ np.swapaxes(
                    u, -1, -2)
                g, w = rec(g, got["state"][D]), rec(w, want["state"][D])
            if field in ("U", "M") or "|mu|" in key:
                _close(g, w, TRAJ, key)


@pytest.mark.parametrize("plan", ["tp", "fsdp"])
def test_meta_dry_run_equals_a_real_rank_zero_step(world, plan):
    """``launch/dryrun.py`` on meta tensors over a fake world of four
    predicts rank 0's real light step on (2, 2) exactly: the collectives'
    bytes handed in and calls by function, the reference-convention bytes
    by kind and by axis, the matmul flops (``FlopCounterMode``; by dtype),
    the argument bytes and the bytes of the state it hands back."""
    want = world[2]["dryrun"][plan]
    got = _all(world, f"dryrun-{plan}")[0]
    assert got["by_name"] == want["collectives_by_name"]
    assert got["by_kind"] == want["collectives"]
    assert got["by_axis"] == want["collective_bytes_by_axis"]
    assert got["flops"] == want["dot_flops"] > 0
    assert got["by_dtype"] == want["dot_flops_by_dtype"]
    assert got["args"] == want["argument_size_in_bytes"]
    assert got["held"] == want["held_bytes"]


def test_health_guards_on_a_2x2_mesh_read_the_global_step(world):
    """``--health`` on (2, 2): every rank's guard reads the whole step's
    report (the sharded leaves' sums and maxima reduced over "model", the
    replicated leaves counted once) and passes every step, and the losses
    are one process's at 1e-5."""
    want = world[2]["health"]
    for got in _all(world, "health"):
        np.testing.assert_allclose(got["losses"], want, rtol=REL)
        assert len(got["reports"]) == 3
        assert all(r == {"ok": 1.0, "grad_nonfinite": 0.0,
                         "update_nonfinite": 0.0} for r in got["reports"])


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("d", ROWS_D)
def test_row_block_brand_update_equals_one_device(world, d, use_kernel):
    """``brand_step`` (the init, then the update) on the ranks' rows of
    U and X (a d the model axis of 4 divides: rows of 8, each gathered
    whole) or replicated (one it does not) ≡ the reference's one-device
    step on the same inputs: U diag(D) Uᵀ at 1e-5 of scale, on every
    rank, plain and through the kernels' passes (``ut_a``, ``a_perp``,
    ``syrk_tn``, ``rinv_apply``; their plain versions on the CPU; the
    reference's ``use_kernel`` route through its plain versions)."""
    U1, D1 = world[2]["rows-brand"][(d, use_kernel)]
    want = (U1 * D1[..., None, :]) @ np.swapaxes(U1, -1, -2)
    for got in _all(world, "rows-brand"):
        g = got[(d, use_kernel)]
        assert g["rows"] == (d // 4 if d % 4 == 0 else None)
        have = (g["U"] * g["D"][..., None, :]) @ np.swapaxes(g["U"], -1, -2)
        _close(have, want, REL, f"d {d} kernel {use_kernel}")


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("tap", sorted(APPLY_TAPS))
def test_row_block_application_equals_the_whole(world, tap, use_kernels):
    """The bucketed preconditioning on (1, 4), each rank its gradient
    blocks and factor row blocks: a column-parallel tap on its G rows,
    a row-parallel one on its A rows (both in one bucket), a replicated
    and an expert-stacked one from their U's gathered — each rank's
    block ≡ the block of the reference's ``precondition_with_damping`` of
    the whole tap (1e-5 of scale), plain and through ``precond_panel``
    and ``precond_apply``; no gradient gathered whole."""
    want = world[2]["rows-apply"][tap]
    path = APPLY_TAPS[tap]["param_path"]
    kinds = {"col": "col", "row": "row", "rep": "whole", "exp": "whole"}
    for got in _all(world, "rows-apply"):
        assert got["kinds"][tap] == kinds[tap]
        assert not got["gathered"]
        m = got["coord"]
        dim = {"col": -1, "row": -2, "rep": None, "exp": -3}[tap]
        block = want
        if dim is not None:
            n = want.shape[dim] // 4
            block = np.take(want, range(m * n, (m + 1) * n), axis=dim)
        _close(got[(tap, use_kernels)], block, REL,
               f"{tap} {path} kernels {use_kernels}")


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_held_factor_entries_equal_the_reference_rule(world, name,
                                                      monkeypatch):
    """On (1, 2) each rank holds, of every factor leaf (U, D, M, aux),
    the entries the reference's ``kfac_state_sharding`` gives a device:
    U and M by rows on "model" where it divides d, the rest whole; and
    the builder's step gathers no tapped parameter's gradient whole."""
    monkeypatch.setattr(jshd, "NamedSharding", _Spec)
    jb = jsteps.build_train_step(jarch((name, 0)))
    mesh = stand_in((1, 2), ("data", "model"))
    specs = jspecs(jshd.kfac_state_sharding(jb.abstract_opt, mesh))
    shapes = {jshd._leaf_path(kp): leaf.shape for kp, leaf in
              jax.tree_util.tree_flatten_with_path(jb.abstract_opt)[0]}
    sizes = {"data": 1, "model": 2}
    want = {k: int(np.prod(shapes[k])) // int(np.prod(
                [sizes[a] for a in v if a is not None] or [1]))
            for k, v in specs.items() if k.startswith("factors/")}
    sharded = [k for k, v in specs.items() if k.startswith("factors/")
               and "model" in v]
    assert sharded
    for got in _all(world, "archs")[:2]:
        g = got[name]
        assert g["factor_numel"] == want
        assert not set(g["gathered"]) & set(g["tapped"])


@pytest.mark.parametrize("name", [c[0] for c in STEP_CASES
                                  if c[2] == "brkfac"])
def test_health_counts_each_nonfinite_factor_entry_once(world, name):
    """After the CLI's step on the model mesh, one nonfinite entry of the
    global factor state planted in each of D, U (a row block on
    "model") and M (the curvature engine's block: rows on "model", or,
    on (1, 2, 2), on the engine's row axis with every model rank holding
    the same block): the guard's ``bucket{bi}/factor_nonfinite`` is 3 on
    every rank."""
    got = [g["planted"] for g in _all(world, name)]
    assert got[0] is not None
    assert all(g == got[0] for g in got)
    assert got[0][1] == 3.0


def test_steps_gather_no_tapped_gradient_whole(world):
    """The CLI's step on (1, 4) and (2, 2), every architecture of the
    step cases: ``ModelShards.gather`` never sees a tapped parameter (the
    sharded gradients are preconditioned on factor rows; only an NS panel
    side would gather one)."""
    for name, spec, *_ in STEP_CASES:
        tapped = _tapped(spec)
        for got in _all(world, name):
            assert not set(got["gathered"]) & tapped, name


@pytest.mark.parametrize("model", [2, 4, 16])
def test_fit_spec_replicates_whispers_vocabulary(model):
    """whisper's 51865-entry vocabulary divides no even model axis:
    ``params_sharding`` leaves the embedding and the head replicated (the
    reference's ``fit_spec``), while the 1024-wide projections shard."""
    from repro_torch.configs.base import get_arch
    from repro_torch.distributed import sharding as shd
    import types
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.zeros((1, model)))
    abstract = TLM(get_arch("whisper_medium"),
                   device=torch.device("meta")).init(None)
    sh = shd.params_sharding(abstract, mesh)
    assert tuple(sh["embed"].spec) == (None, None)
    assert tuple(sh["head/w"].spec) == (None, None)
    assert tuple(sh["segments/0/p0/mix/wq"].spec)[-1] == "model"
