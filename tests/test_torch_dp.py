"""The port's data-parallel execution of the LM on a mesh whose model
axis is 1, on one world of four ``gloo`` CPU ranks
(``tests/torch_dist_worker.py``'s ``dp`` suite, spawned once; the oracles
are computed in this process meanwhile).

* **Against the reference's one-device step** on the global batch (the
  reference CLI's step, ``train/loop.py::make_scheduled_kfac_step`` with
  ``--reduced``'s optimizer, jitted, two steps of stats, light and heavy
  work from the reference's parameters, its RSVD draws injected): the
  depth-cut reduced gemma3 under bkfac and brkfac on (4, 1) [data,
  model] with the curvature engine on the data axis (``--curvature
  auto``'s pick) and on (2, 2, 1) [pod, data, model] with the 2D engine
  (slots on pod, dense-M rows on data); reduced llama4-scout (MoE, top-1
  of 4 experts) at a batch whose experts overflow; reduced whisper
  (encoder-decoder).  Losses at 1e-5 relative, each parameter's change at
  2e-3 of the reference change's scale (``tests/test_torch_launch.py``'s
  tolerances).  Each rank's forward sees B/N rows.
* **MoE capacity.**  The reference drops tokens at this batch; routing
  each rank's rows alone (capacity and slots from its own tokens) gives
  another loss than the reference's, beyond the tolerance, so the test
  tells the global rule from a per-rank one.
* **PowerSGD across ranks.**  ``compress_tree(sp=)`` on each rank's share
  of a gradient against the reference's ``compress_tree`` of the global
  gradient, three rounds with error feedback from the reference's bases:
  the approximations at 1e-5 of their scale, the ranks' errors summed at
  1e-5; the CLI with ``--compress`` on (2, 2, 1) against the port's
  one-process CLI (losses at 1e-5, changes at 2e-3).
* **Against the port's one-process run**: all ten architectures' builder
  step on (2, 1), the prefill and decode builders on (4, 1) (logits rows
  at 1e-5 of scale), and the taps summed over the data axes, row for row
  (acts and probe gradients at 1e-5 of scale), for the dense cut and the
  MoE.
* **Refusals.**  ``plan="fsdp"`` still raises ``NotImplementedError``,
  naming ROADMAP §1 item 5; a model axis of 2 and a long-context decode
  (sequence-sharded cache) build (``test_torch_tp.py`` runs them).
"""
import contextlib
import dataclasses
import io
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import Segment as JSegment  # noqa: E402
from repro.configs.base import get_arch as jget  # noqa: E402
from repro.core import kfac as jkfac  # noqa: E402
from repro.core import kfactor as jkf  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.distributed import compress as jcomp  # noqa: E402
from repro.models.lm import LM as JLM  # noqa: E402
from repro.optim import base as jbase  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeCell  # noqa: E402
from repro_torch.configs.base import ARCH_NAMES  # noqa: E402
from repro_torch.data.synthetic import rank_rows  # noqa: E402
from repro_torch.distributed import compress as tcomp  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
import torch_dist_worker as worker  # noqa: E402

CPU = torch.device("cpu")
REL = 1e-5
TRAJ = 2e-3
B, T = 4, 16            # the global batch: one row a rank on four
STEPS = 2
MOE = ("llama4_scout_17b_a16e", 0)
MOE_B, MOE_T = 8, 8     # 64 tokens over 4 experts: capacity 21
CLI = ["--reduced", "--steps", "3", "--device", "cpu", "--compress"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small ops: one intra-op thread, as the LM tests pin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=REL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err:.3e} > {rel} × {scale:.3e}"


def jarch(spec):
    """``torch_dist_worker.dp_arch`` in the reference."""
    name, vocab = spec
    if name == "cut":
        red = jget("gemma3_4b").reduced()
        p = red.segments[0].pattern
        arch = dataclasses.replace(red, n_layers=4, segments=(
            JSegment((p[0], p[5]), repeats=2),))
    else:
        arch = jget(name).reduced()
    return dataclasses.replace(arch, vocab=vocab) if vocab else arch


def jkfac_config(variant):
    """The reference CLI's ``--reduced`` optimizer."""
    return jkfac.KfacConfig(
        policy=jpolicy.PolicyConfig(variant=variant, r=32,
                                    max_dense_dim=1024),
        lr=jbase.constant(0.02), damping_phi=jbase.constant(0.1),
        weight_decay=1e-4, clip=0.5, T_updt=2, T_inv=10, T_brand=2,
        T_rsvd=10, T_corct=10, fallback_lr=jbase.constant(3e-3))


def ref_draws(jopt, rng, work):
    """The reference's heavy-op draws of one step (its per-slot keys, as
    drawn in ``core/kfac.py``), per bucket that fires."""
    out = {}
    bkeys = jax.random.split(rng, len(jopt.factor_buckets))
    for bi, (bkey, b) in enumerate(zip(bkeys, jopt.factor_buckets)):
        if not work.heavy[bi]:
            continue
        s = b.spec
        if s.mode in (jkf.Mode.RSVD, jkf.Mode.BRAND_RSVD):
            k = min(s.r + s.r_o, s.d)
            keys = jax.random.split(bkey, b.total)
            out[bi] = np.asarray(jax.vmap(lambda kk: jax.random.normal(
                kk, (s.d, k), dtype=jnp.float32))(keys))
    return out


def lm_batch(arch, Bg, Tg, seed):
    """A global training batch of ``train_batch_specs``' layout, drawn
    with numpy."""
    rs = np.random.default_rng(seed)
    specs = tsteps.train_batch_specs(arch, ShapeCell("t", Tg, Bg, "train"))
    out = {}
    for k, v in specs.items():
        if v.dtype == torch.int32:
            out[k] = rs.integers(0, arch.vocab, tuple(v.shape)).astype(
                np.int32)
        else:
            out[k] = rs.standard_normal(tuple(v.shape)).astype(np.float32)
    out["targets"] = out["tokens"]
    return out


def ref_run(spec, variant, Bg, Tg):
    """The reference CLI's step, jitted, ``STEPS`` steps of stats, light
    and heavy work on global batches → the case for the ranks and the
    losses and final parameters to hold them to."""
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
                  "init": init}


#: (case name, arch, variant, mesh, (curvature axis, row axis), B, T)
STEP_CASES = (
    ("cut-bkfac-4x1", ("cut", 0), "bkfac", "4x1", ("data", None), B, T),
    ("cut-bkfac-2x2x1", ("cut", 0), "bkfac", "2x2x1", ("pod", "data"), B, T),
    ("cut-brkfac-4x1", ("cut", 0), "brkfac", "4x1", ("data", None), B, T),
    ("cut-brkfac-2x2x1", ("cut", 0), "brkfac", "2x2x1", ("pod", "data"),
     B, T),
    ("moe-bkfac-4x1", MOE, "bkfac", "4x1", ("data", None), MOE_B, MOE_T),
    ("whisper-bkfac-2x2x1", ("whisper_medium", 0), "bkfac", "2x2x1",
     ("pod", "data"), B, T))


def _port_params(spec):
    return TLM(worker.dp_arch(spec), device=CPU).init(
        torch.Generator().manual_seed(0))


def _grads_of(spec, batch):
    """The port's one-process ``kfac_grads`` on ``batch`` (numpy)."""
    lm = TLM(worker.dp_arch(spec), remat=False, device=CPU)
    params = lm.init(torch.Generator().manual_seed(0))
    loss, acts, gp, gprobe = tloop.kfac_grads(
        lm.loss_fn, params, tlayers.make_probes(lm.taps, device=CPU),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    return {"loss": float(loss), "acts": acts, "probe_grads": gprobe,
            "grads": gp}


def _one_process_archs(batches):
    out = {}
    for name, batch in batches.items():
        tb = tsteps.build_train_step(
            worker.dp_arch((name, 0)), cell=ShapeCell("t", T, B, "train"),
            flags=dict(do_stats=True, do_light=True, do_heavy=True),
            device=CPU)
        params = tb.lm.init(torch.Generator().manual_seed(0))
        p, _, loss = tb.step_fn(params, tb.opt.init(params),
                                {k: torch.as_tensor(v)
                                 for k, v in batch.items()},
                                torch.Generator().manual_seed(1))
        out[name] = {"loss": float(loss),
                     "after": {k: v.detach() for k, v in p.items()}}
    return out


def _one_process_serve(tokens):
    arch = worker.dp_arch(("cut", 0))
    params = _port_params(("cut", 0))
    pb = tsteps.build_prefill_step(arch, cell=ShapeCell("p", T, B,
                                                        "prefill"),
                                   device=CPU)
    out = {"prefill": pb.step_fn(params, {"tokens": tokens})}
    db = tsteps.build_decode_step(arch, cell=ShapeCell("d", 16, B,
                                                       "decode"),
                                  device=CPU)
    cache = db.lm.init_cache(B, 16)
    out["decode"] = []
    for t in range(3):
        lg, cache = db.step_fn(params, cache, tokens[:, t:t + 1], t)
        out["decode"].append(lg)
    return out


COMPRESS_SHAPES = {"w": (3, 96, 64), "v": (200, 48), "small": (8, 8)}


def _compress_case(rs):
    """Three rounds of per-rank gradient shares (the global gradient is
    their sum) and the reference's cold-start bases."""
    cfg = dict(rank=4, min_size=1024, n_power_iter=1)
    shares = [[{k: rs.standard_normal(s).astype(np.float32)
                for k, s in COMPRESS_SHAPES.items()} for _ in range(4)]
              for _ in range(3)]
    bases = {}
    for k, s in COMPRESS_SHAPES.items():
        m, n = int(np.prod(s[:-1])), s[-1]
        if len(s) >= 2 and np.prod(s) >= cfg["min_size"]:
            bases[k] = np.asarray(jax.random.normal(
                jax.random.PRNGKey(m * 1315423911 + n),
                (n, min(cfg["rank"], m, n))))
    return {"cfg": cfg, "shares": shares, "bases": bases}


def _ref_compress(case):
    """The reference's ``compress_tree`` of the global gradient, each
    round → (approximations, errors)."""
    cfg = jcomp.CompressConfig(**case["cfg"])
    g0 = {k: jnp.asarray(sum(r[k] for r in case["shares"][0]))
          for k in COMPRESS_SHAPES}
    state = jcomp.init_state(g0, cfg)
    out = []
    for round_ in case["shares"]:
        g = {k: jnp.asarray(sum(np.asarray(r[k], np.float32) for r in round_))
             for k in COMPRESS_SHAPES}
        approx, state = jcomp.compress_tree(g, state, cfg)
        out.append(({k: np.asarray(v) for k, v in approx.items()},
                    {k: np.asarray(v) for k, v in state.err.items()}))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp")
    cases = []
    tap_batches = {"cut": lm_batch(worker.dp_arch(("cut", 0)), B, T, 3),
                   "moe": lm_batch(worker.dp_arch(MOE), MOE_B, MOE_T, 3)}
    for tag, spec in (("cut", ("cut", 0)), ("moe", MOE)):
        cases.append({"name": f"taps-{tag}", "kind": "taps", "mesh": "4x1",
                      "arch": spec, "batch": tap_batches[tag]})
    arch_batches = {n: lm_batch(worker.dp_arch((n, 0)), B, T, 4)
                    for n in ARCH_NAMES}
    cases.append({"name": "archs", "kind": "archs", "B": B, "T": T,
                  "batches": arch_batches})
    tokens = lm_batch(worker.dp_arch(("cut", 0)), B, T, 5)["tokens"]
    cases.append({"name": "serve", "kind": "serve", "mesh": "4x1",
                  "arch": ("cut", 0), "B": B, "T": T, "tokens": tokens})
    comp = _compress_case(np.random.default_rng(6))
    cases.append({**comp, "name": "compress", "kind": "compress",
                  "mesh": "4x1"})
    cases.append({"name": "cli", "kind": "cli", "arch": ("cut", 1024),
                  "argv": CLI + ["--mesh", "2x2x1", "--mesh-axes",
                                 "pod,data,model"]})
    # the ranks take the cases above while the reference's steps compile
    # here; the step cases, which need their parameters and draws, follow
    wait, send = worker.later(str(root), "dp", timeout=200)
    join = worker.start("dp", cases + [wait], str(root), timeout=240)
    refs, oracles, steps = {}, {}, []
    for name, spec, variant, mesh, axes, Bg, Tg in STEP_CASES:
        key = (spec, variant, Bg, Tg)
        if key not in oracles:
            oracles[key] = ref_run(spec, variant, Bg, Tg)
        case, refs[name] = oracles[key]
        steps.append({**case, "name": name, "kind": "step", "mesh": mesh,
                      "dist": axes})
    send(steps)
    # the port's one-process oracles, meanwhile
    one = {"archs": _one_process_archs(arch_batches),
           "serve": _one_process_serve(torch.as_tensor(tokens)),
           "compress": _ref_compress(comp)}
    for tag, spec in (("cut", ("cut", 0)), ("moe", MOE)):
        one[f"taps-{tag}"] = _grads_of(spec, tap_batches[tag])
    grads, compress_tree = worker.compressed_grads(tcomp)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            state, losses = ttrain.run(ttrain.parse_args(CLI),
                                       arch=worker.dp_arch(("cut", 1024)))
    finally:
        tcomp.compress_tree = compress_tree
    one["cli"] = {"losses": losses, "after": state.params, "grads": grads,
                  "init": _port_params(("cut", 1024))}
    return join(), refs, one


def _all(world, name):
    return worker.ok(world[0], name)


@pytest.mark.parametrize("name", [c[0] for c in STEP_CASES])
def test_step_equals_the_reference_one_device_step(world, name):
    """The CLI's step under the data mesh and the engine ≡ the reference's
    one-device step on the global batch: losses at 1e-5, each parameter's
    change at 2e-3 of scale, on every rank; each forward saw B/N rows."""
    want = world[1][name]
    n_dp = 4
    init = convert.params_from_jax(want["init"], device=CPU)
    after = convert.params_from_jax(want["after"], device=CPU)
    assert all(float((after[k] - init[k]).abs().max()) > 0 for k in after)
    Bg = dict((c[0], c[5]) for c in STEP_CASES)[name]
    for got in _all(world, name):
        assert got["rows"] == [Bg // n_dp] * STEPS
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=REL)
        for k in after:
            d_want = (after[k] - init[k]).numpy()
            _close(got["after"][k] - init[k].numpy(), d_want, TRAJ,
                   f"{name} {k}")


def test_moe_drops_tokens_and_the_capacity_is_the_global_batchs(world):
    """At the MoE case's batch the reference's experts overflow (tokens
    dropped in the port's one-process forward of it), and routing each
    rank's rows alone — capacity and slots from its own 16 tokens — gives
    another loss than the reference's, beyond the tolerance the sharded
    run meets."""
    case = next(c for c in STEP_CASES if c[0] == "moe-bkfac-4x1")
    want = world[1][case[0]]
    batch = {k: torch.as_tensor(v) for k, v in
             ref_run_batches(case)[0].items()}
    lm = TLM(worker.dp_arch(MOE), remat=False, device=CPU)
    params = convert.params_from_jax(want["init"], device=CPU)
    dropped, dispatch = [], tmoe.dispatch

    def counting(x, idx, dims, capacity, sp=None):
        buffers, info = dispatch(x, idx, dims, capacity, sp)
        dropped.append(int((~info[3]).sum()))
        return buffers, info
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmoe, "dispatch", counting)
        with torch.no_grad():
            whole, _ = lm.loss_fn(params, {}, batch)
        assert sum(dropped) > 0, dropped
        with torch.no_grad():
            local = [float(lm.loss_fn(params, {}, rank_rows(batch, r, 4))[0])
                     for r in range(4)]
    assert abs(float(whole) - want["losses"][0]) <= REL * want["losses"][0]
    per_rank = float(np.mean(local))
    assert abs(per_rank - want["losses"][0]) > 10 * REL * want["losses"][0]


def ref_run_batches(case):
    """The global batches of a step case (as ``ref_run`` drew them)."""
    arch = jarch(case[1])
    return [lm_batch(arch, case[5], case[6], seed=10 + k)
            for k in range(STEPS)]


@pytest.mark.parametrize("tag", ["cut", "moe"])
def test_taps_summed_over_the_data_axes_are_one_process_rows(world, tag):
    """``kfac_grads`` on (4, 1): every rank ends with the one-process
    acts and probe gradients, row for row (1e-5 of each tap's scale), the
    loss and the parameter gradients; each forward saw B/N rows."""
    want = world[2][f"taps-{tag}"]
    Bg = B if tag == "cut" else MOE_B
    for got in _all(world, f"taps-{tag}"):
        assert got["rows"] == [Bg // 4]
        assert abs(got["loss"] - want["loss"]) <= REL * abs(want["loss"])
        for field in ("acts", "probe_grads", "grads"):
            assert set(got[field]) == set(want[field])
            for k, w in want[field].items():
                _close(got[field][k], w.numpy(), REL, f"{field} {k}")


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_every_architecture_on_a_2x1_mesh_equals_one_process(world, name):
    """``build_train_step`` (stats, light, heavy; remat, the builder's
    default, so an MoE's collectives run again in the recomputed forward)
    on (2, 1) from the port's seeded parameters ≡ the same step in one
    process: loss at 1e-5, each parameter's change at 2e-3; each forward
    saw B/2 rows."""
    want = world[2]["archs"][name]
    init = _port_params((name, 0))
    got_all = _all(world, "archs")
    assert got_all[2] == got_all[3] == {}      # outside the (2, 1) mesh
    for got in got_all[:2]:
        g = got[name]
        assert g["rows"] == [B // 2]
        assert abs(g["loss"] - want["loss"]) <= REL * abs(want["loss"])
        for k, w in want["after"].items():
            d_want = (w - init[k].detach()).numpy()
            _close(g["after"][k] - init[k].detach().numpy(), d_want, TRAJ,
                   f"{name} {k}")


def test_prefill_and_decode_builders_give_the_ranks_rows(world):
    """On (4, 1) each rank's prefill and decode logits are its rows of the
    one-process logits (1e-5 of scale)."""
    want = world[2]["serve"]
    for r, got in enumerate(_all(world, "serve")):
        rows = slice(r * (B // 4), (r + 1) * (B // 4))
        _close(got["prefill"], want["prefill"][rows].numpy(),
               what="prefill")
        for t in range(3):
            _close(got["decode"][t], want["decode"][t][rows].numpy(),
                   what=f"decode {t}")


def test_powersgd_across_ranks_is_the_references_compression(world):
    """``compress_tree(sp=)`` on four ranks' shares ≡ the reference's
    compression of their sum, three rounds with error feedback: each
    round's approximation on every rank at 1e-5 of its scale, the ranks'
    errors summed at 1e-5 (the ``g − P Qᵀ`` quirk mirrored), the leaf the
    compressor leaves whole summed raw."""
    want = world[2]["compress"]
    got = _all(world, "compress")
    for i, (w_approx, w_err) in enumerate(want):
        for k in COMPRESS_SHAPES:
            for g in got:
                _close(g[i]["approx"][k], w_approx[k], REL,
                       f"round {i} {k}")
            _close(sum(g[i]["err"][k] for g in got), w_err[k], REL,
                   f"round {i} err {k}")


def test_cli_compress_on_a_2x2x1_mesh_equals_one_process(world):
    """``--compress`` on (2, 2, 1) [pod, data, model]: the batch over pod
    and data, PowerSGD across the four ranks ≡ the port's one-process
    CLI: losses at 1e-5; the compressed gradients entering the optimizer
    (the first round at 1e-5, the later ones at 2e-3: they follow the
    trajectory); each parameter's change at 2e-3 but the embedding's,
    which is held through its compressed gradients (AdamW over them moves
    the rows a batch leaves untouched by a step of either sign: ROADMAP
    §3); rank 0 logs the split and the taps' bytes."""
    want = world[2]["cli"]
    init = want["init"]
    runs = _all(world, "cli")
    for got in runs:
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=REL)
        assert len(got["grads"]) == len(want["grads"]) == 3
        for k, (g, w) in enumerate(zip(got["grads"], want["grads"])):
            assert set(g) == set(w) == {"embed", "head/w"}
            for name in w:
                _close(g[name], w[name].numpy(), REL if k == 0 else TRAJ,
                       f"step {k} {name}")
        for k, w in want["after"].items():
            if k == "embed":
                continue
            d_want = (w.detach() - init[k].detach()).numpy()
            _close(got["after"][k] - init[k].detach().numpy(), d_want, TRAJ,
                   f"cli {k}")
    assert "data parallel over pod×data: 4 ranks of 1 rows" in runs[0]["log"]
    assert all(not r["log"] for r in runs[1:])


def _stand_in(shape, axes):
    return types.SimpleNamespace(axis_names=axes, devices=np.zeros(shape))


def test_model_axis_fsdp_and_sequence_sharded_decode_still_raise():
    """A model axis of 2 and the long-context decode (its cache sharded
    over the sequence) build tensor-parallel steps (they run in
    ``test_torch_tp.py``: no world here); only ``plan="fsdp"`` raises when
    the step runs, naming ROADMAP §1 item 5; a data-parallel policy's
    roles stay the identity."""
    arch = worker.dp_arch(("cut", 0))
    tp = _stand_in((2, 2), ("data", "model"))
    dp = _stand_in((4, 1), ("data", "model"))
    cell = ShapeCell("t", T, B, "train")
    tb = tsteps.build_train_step(arch, mesh=tp, cell=cell, device=CPU)
    assert tb.lm.sp.model_parallel and tb.opt.model_shards is not None
    assert tb.in_shardings[0]["embed"].spec == ("model", None)
    # the factors' U rows on "model", the reference's rule (every d of the
    # cut divides 2)
    u = [getattr(ts, side).U.spec
         for ts in tb.in_shardings[1].factors.values() for side in "AG"]
    assert u and all(spec[-2] == "model" for spec in u)
    for mesh in (tp, dp):
        fb = tsteps.build_train_step(arch, mesh=mesh, cell=cell, plan="fsdp",
                                     device=CPU)
        with pytest.raises(NotImplementedError, match="item 5.*FSDP"):
            fb.step_fn({}, None, {}, None)
    pb = tsteps.build_prefill_step(arch, mesh=tp, cell=cell, device=CPU)
    assert tuple(pb.out_shardings.spec) == ("data", None, "model")
    db = tsteps.build_decode_step(arch, mesh=dp, cell=SHAPES["long_500k"],
                                  device=CPU)
    assert db.lm.sp.shard_kv_seq and tuple(db.in_shardings[2].spec) == ()
    sp = tsteps.shard_policy_for(tp)
    assert sp.model_parallel and sp.tp_size == 2
    sp = tsteps.shard_policy_for(dp)
    x = torch.zeros(1, 2, 3)
    assert sp.data_parallel and sp.dp_size == 4
    assert sp.residual(x) is x and sp.full_seq(x) is x
