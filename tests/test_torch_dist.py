"""The port's distributed curvature engine against the reference, on the
CPU: ``kfactor.ea_update_m_rows``, ``ShardPlan`` and the engine's
metadata, and sharded ≡ replicated ``Kfac.update`` on four ``gloo``
ranks.

* **Row blocks.**  ``ea_update_m_rows`` against the reference's for every
  row block of a few (stack, d, n) shapes, and against the row slice of
  the full absorb.
* **Metadata** (no processes): ``ShardPlan`` for every (total, n) of the
  reference's ``TestShardPlan``; ``job_counts``, ``m_bytes``,
  ``collective_bytes`` (raw and compressed), ``row_blocks``, ``align``
  and ``describe`` against the reference engine built on the same
  stand-in mesh (only ``axis_names`` and ``devices.shape`` are read), for
  the reference tests' mixed taps and VGG16_bn's and gemma3-4b's
  full-width factor buckets at (8,), (4, 2) and (16, 16); the three
  constructor errors.
* **Sharded ≡ replicated.**  One world of four ranks (a module fixture,
  ``torch_dist_worker.py``) runs the engine at (4,) [curv] and (2, 2)
  [data × curv, M rows on data]; the oracle is always the reference's
  *replicated* run (one CPU device), jitted once per variant and
  schedule, with its draws injected, at the reference tests' tolerances
  (atol 1e-5, rtol 1e-4).  Both meshes align heavy ranges to 4, so one
  reference run serves both.  The cases: all six variants under the
  staggered synchronous schedule; the same config async at lag 0 against
  that synchronous run; lag 2 (kfac, bkfacc: step-varying operands, the
  in-flight M and panels too); the row-split heavy range of
  ``tests/test_mesh2d.py:287``; the compressed gather against the raw one
  at the reference's bound (``tests/test_mesh2d.py:444``); each rank's
  held dense-M bytes against ``m_bytes()[1]``.
"""
import concurrent.futures
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_arch as jget  # noqa: E402
from repro.core import buckets as jbuckets  # noqa: E402
from repro.core import kfac as jkfac  # noqa: E402
from repro.core import kfactor as jkf  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.distributed import curvature as jcurv  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.models.lm import LM as JLM  # noqa: E402
from repro.optim import base as jbase  # noqa: E402
from repro_torch.configs.base import get_arch as tget  # noqa: E402
from repro_torch.core import buckets as tbuckets  # noqa: E402
from repro_torch.core import kfac as tkfac  # noqa: E402
from repro_torch.core import kfactor as tkf  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.distributed import curvature as tcurv  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from synthdata import tap_data  # noqa: E402
import torch_dist_worker as worker  # noqa: E402

CPU = torch.device("cpu")
ATOL, RTOL = 1e-5, 1e-4
N_STAT = 16
VARIANTS = tuple(jpolicy.VARIANTS)
MESHES = ("1d", "2d")


def stand_in(shape, axes):
    """What the engine's metadata reads of a mesh."""
    return types.SimpleNamespace(axis_names=tuple(axes),
                                 devices=np.zeros(shape))


# ---------------------------------------------------------------------------
# ea_update_m_rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stack,d,n,rb", [((), 8, 5, 2), ((3,), 12, 4, 4),
                                          ((2, 2), 16, 6, 8)])
def test_ea_update_m_rows_equals_reference(stack, d, n, rb):
    rs = np.random.default_rng(d)
    M = rs.standard_normal(stack + (d, d)).astype(np.float32)
    X = rs.standard_normal(stack + (d, n)).astype(np.float32)
    for first in (True, False):
        full = tkf.ea_update_m(torch.as_tensor(M), torch.as_tensor(X),
                               0.95, first).numpy()
        for r0 in range(0, d, rb):
            got = tkf.ea_update_m_rows(
                torch.as_tensor(M[..., r0:r0 + rb, :]), torch.as_tensor(X),
                r0, rb, 0.95, first).numpy()
            want = np.asarray(jkf.ea_update_m_rows(
                jnp.asarray(M[..., r0:r0 + rb, :]), jnp.asarray(X), r0, rb,
                0.95, first))
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(got, full[..., r0:r0 + rb, :],
                                       rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# metadata, no processes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("total,n", [(1, 8), (7, 8), (8, 8), (17, 8),
                                     (12, 4), (5, 2)])
def test_shard_plan_equals_reference(total, n):
    tp, jp = tcurv.ShardPlan.build(total, n), jcurv.ShardPlan.build(total, n)
    assert (tp.total, tp.n, tp.padded, tp.perm, tp.unperm,
            tp.per_device) == (jp.total, jp.n, jp.padded, jp.perm,
                               jp.unperm, jp.per_device)
    x = torch.arange(total * 3.0).reshape(total, 3)
    sh = tp.shard(x)
    np.testing.assert_array_equal(
        sh.numpy(), np.asarray(jp.shard(jnp.asarray(x.numpy()))))
    torch.testing.assert_close(tp.unshard(sh), x, rtol=0, atol=0)
    m = tp.per_device
    for c in range(n):
        torch.testing.assert_close(tp.local(x, c), sh[c * m:(c + 1) * m],
                                   rtol=0, atol=0)


def test_localize_ranges_equals_reference():
    for args in ((((0, 8),), 8, 4), (((4, 11),), 11, 4),
                 (((0, 4), (4, 12)), 12, 2)):
        assert tbuckets.localize_ranges(*args) == \
            jbuckets.localize_ranges(*args)
    for f in (tbuckets.localize_ranges, jbuckets.localize_ranges):
        with pytest.raises(ValueError, match="not aligned"):
            f(((2, 8),), 11, 4)


def _mixed_taps(mod):
    return {"fc": mod.TapInfo("fc/w", 48, 32, n_stat=N_STAT),
            "fc2": mod.TapInfo("fc2/w", 48, 32, n_stat=N_STAT),
            "scan": mod.TapInfo("scan/w", 48, 48, stack=(3,),
                                n_stat=N_STAT),
            "moe": mod.TapInfo("moe/w", 48, 32, stack=(2, 2),
                               n_stat=N_STAT)}


def _buckets(model):
    """(reference, port) factor buckets of a model's B-R-KFAC optimizer:
    the mixed taps (r 8), VGG16_bn at the paper's width (r 230,
    max_dense_dim 4096) and gemma3-4b at full width (the CLI's r 256,
    max_dense_dim 8192)."""
    if model == "mixed":
        kw = dict(r=8, max_dense_dim=8192)
        jt, tt = _mixed_taps(jkfac), _mixed_taps(tkfac)
    elif model == "vgg16_bn":
        kw = dict(r=230, max_dense_dim=4096)
        jt = jcnn.make_vgg(jcnn.VggConfig(stages=(64, 128, 256, 512, 512),
                                          fc_hidden=2048, n_stat=256))[3]
        tt = {n: tkfac.TapInfo(**dataclasses.asdict(t))
              for n, t in jt.items()}
    else:
        kw = dict(r=256, max_dense_dim=8192)
        jt = JLM(jget("gemma3_4b")).taps
        tt = TLM(tget("gemma3_4b"), device=torch.device("meta")).taps
    jo = jkfac.Kfac(jkfac.KfacConfig(policy=jpolicy.PolicyConfig(
        variant="brkfac", **kw)), jt)
    to = tkfac.Kfac(tkfac.KfacConfig(policy=tpolicy.PolicyConfig(
        variant="brkfac", **kw)), tt, device=CPU)
    return jo.factor_buckets, to.factor_buckets


META_MESHES = {"8": ((8,), ("curv",), None),
               "4x2": ((4, 2), ("data", "curv"), "data"),
               "16x16": ((16, 16), ("data", "curv"), "data")}


@pytest.mark.parametrize("mesh", sorted(META_MESHES))
@pytest.mark.parametrize("model", ["mixed", "vgg16_bn", "gemma3_4b"])
def test_engine_metadata_equals_reference(model, mesh):
    jb, tb = _buckets(model)
    shape, axes, rows = META_MESHES[mesh]
    m = stand_in(shape, axes)
    assert any(b.spec.needs_m for b in tb)
    for q in (None, 4):
        je = jcurv.CurvatureEngine(m, "curv", jb, row_axis=rows,
                                   compress_rank=q)
        te = tcurv.CurvatureEngine(m, "curv", tb, row_axis=rows,
                                   compress_rank=q)
        assert te.job_counts() == je.job_counts()
        assert te.m_bytes() == je.m_bytes()
        assert te.collective_bytes() == je.collective_bytes()
        assert te.row_blocks == je.row_blocks
        assert (te.align, te.n_devices, te.n_rows, te.row_axis) == \
            (je.align, je.n_devices, je.n_rows, je.row_axis)
        assert te.describe() == je.describe()


@pytest.mark.parametrize("kw,match", [
    (dict(axis="nope"), "no axis 'nope'"),
    (dict(axis="curv", row_axis="nope"), "no row axis 'nope'"),
    (dict(axis="curv", row_axis="curv"), "must differ")])
def test_engine_constructor_errors_equal_reference(kw, match):
    m = stand_in((2, 2), ("data", "curv"))
    jb, tb = _buckets("mixed")
    for mod, bk in ((jcurv, jb), (tcurv, tb)):
        with pytest.raises(ValueError, match=match):
            mod.CurvatureEngine(m, factor_buckets=bk, **kw)


# ---------------------------------------------------------------------------
# sharded ≡ replicated on four ranks
# ---------------------------------------------------------------------------

#: the reference tests' configs (test_distributed_curvature.py,
#: test_mesh2d.py): ``sync`` is ``_run``'s (momentum 0.9, T_inv 3),
#: staggered in up to 4 chunks; ``lag`` is ``_run_async``'s
SYNC = dict(lr=0.05, momentum=0.9, T_updt=1, T_brand=1, T_inv=3, T_rsvd=3,
            T_corct=3, stagger=True, stagger_splits=4)
PLAIN = dict(SYNC, stagger=False)
LAG = dict(lr=0.05, T_updt=1, T_brand=1, T_inv=3, T_rsvd=3, T_corct=3,
           stagger=True, stagger_splits=2, async_heavy=True, heavy_lag=2)


def _jopt(taps, variant, cfg):
    cfg = dict(cfg)
    cfg["lr"] = jbase.constant(cfg["lr"])
    return jkfac.Kfac(jkfac.KfacConfig(policy=jpolicy.PolicyConfig(
        variant=variant, r=8, max_dense_dim=8192), **cfg), taps)


def ref_draws(jopt, rng, work):
    """The reference's heavy-op draws of one step, per bucket that fires
    or launches a heavy range (its per-slot keys, as drawn in
    ``core/kfac.py``)."""
    out = {}
    bkeys = jax.random.split(rng, len(jopt.factor_buckets))
    for bi, (bkey, b) in enumerate(zip(bkeys, jopt.factor_buckets)):
        launch = work.launch[bi] if bi < len(work.launch) else ()
        if not (work.heavy[bi] or launch):
            continue
        keys = jax.random.split(bkey, b.total)
        s = b.spec
        if s.mode in (jkf.Mode.RSVD, jkf.Mode.BRAND_RSVD):
            k = min(s.r + s.r_o, s.d)
            out[bi] = np.asarray(jax.vmap(lambda kk: jax.random.normal(
                kk, (s.d, k), dtype=jnp.float32))(keys))
        elif s.mode is jkf.Mode.BRAND_CORR:
            out[bi] = np.asarray(jax.vmap(lambda kk: jax.random.choice(
                kk, s.r, shape=(s.n_crc,), replace=False))(keys)
                ).astype(np.int64)
    return out


def _operands(taps, steps, varying):
    """Per step the reference tests' tap operands, as numpy."""
    out = []
    for s in range(steps):
        _, g, a, p = (tap_data(taps, jax.random.PRNGKey(200 + s))
                      if varying else tap_data(taps))
        out.append({"grads": {f"{n}/w": np.asarray(v["w"])
                              for n, v in g.items()},
                    "acts": {n: np.asarray(v) for n, v in a.items()},
                    "pgs": {n: np.asarray(v) for n, v in p.items()}})
    return out


def _rng(s):
    return jax.random.fold_in(jax.random.PRNGKey(7), s)


def _case(name, taps, variant, cfg, mesh, steps, varying, compress=None):
    """A worker case: the port's config, the reference's operands, and
    the reference's draws under ``cfg``'s own schedule."""
    jopt = _jopt(taps, variant, cfg)
    sched = jopt.scheduler(align=4)
    ops = _operands(taps, steps, varying)
    for s, op in enumerate(ops):
        op["draws"] = ref_draws(jopt, _rng(s), sched.work(s))
    return {"name": name, "mesh": mesh, "compress": compress,
            "n_tokens": N_STAT, "steps": ops,
            "taps": {n: dataclasses.asdict(t) for n, t in taps.items()},
            "cfg": dict(cfg, policy=dict(variant=variant, r=8,
                                         max_dense_dim=8192)),
            "params": {f"{n}/w": np.asarray(p["w"])
                       for n, p in tap_data(taps)[0].items()}}


def jrun(taps, variant, cfg, steps, varying):
    """The reference's replicated run (jitted once) → (updates per step,
    final state), as numpy."""
    opt = _jopt(taps, variant, cfg)
    sched = opt.scheduler(align=4)
    params = tap_data(taps)[0]
    st = opt.init(params)

    def step(grads, st, acts, pgs, rng, work):
        return opt.update(grads, st, params, acts=acts, probe_grads=pgs,
                          n_tokens=N_STAT, rng=rng, work=work)
    # XLA's backend at optimization level 0 compiles these many small
    # step programs in about half the time (the run itself is milliseconds)
    step = jax.jit(step, static_argnames=("work",),
                   compiler_options={"xla_backend_optimization_level": 0})
    outs = []
    for s in range(steps):
        _, g, a, p = (tap_data(taps, jax.random.PRNGKey(200 + s))
                      if varying else tap_data(taps))
        upd, st = step(g, st, a, p, _rng(s), sched.work(s))
        outs.append({f"{n}/w": np.asarray(u["w"]) for n, u in upd.items()})
    return outs, jax.tree_util.tree_map(np.asarray, st)


ROW_TAPS = {"scan": jkfac.TapInfo("scan/w", 48, 48, stack=(8,),
                                  n_stat=N_STAT)}
LAG_VARIANTS = ("kfac", "bkfacc")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The four ranks' results and the reference's runs (XLA compiles
    outside the interpreter lock: the runs go side by side on threads
    while this thread makes the ranks' cases, then the ranks run)."""
    taps = _mixed_taps(jkfac)
    runs = {f"sync-{v}": (taps, v, SYNC, 4, False) for v in VARIANTS}
    runs.update({f"lag2-{v}": (taps, v, LAG, 6, True) for v in LAG_VARIANTS})
    runs["rowsplit"] = (ROW_TAPS, "kfac", PLAIN, 4, False)
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        futures = {k: pool.submit(jrun, *a) for k, a in runs.items()}
        one = []
        for v in VARIANTS:
            one.append(_case(f"sync-{v}", taps, v, SYNC, None, 4, False))
            one.append(_case(f"lag0-{v}", taps, v,
                             dict(SYNC, async_heavy=True, heavy_lag=0), None,
                             4, False))
        for v in LAG_VARIANTS:
            one.append(_case(f"lag2-{v}", taps, v, LAG, None, 6, True))
        cases = [dict(c, name=f"{c['name']}-{mesh}", mesh=mesh)
                 for mesh in MESHES for c in one]
        cases.append(_case("rowsplit", ROW_TAPS, "kfac", PLAIN, "2d", 4,
                           False))
        for q in (None, 8):
            cases.append(_case(f"compress-{q}", taps, "bkfac", PLAIN, "2d",
                               3, False, compress=q))
        join = worker.start("engine", cases,
                            str(tmp_path_factory.mktemp("engine")))
        ref = {k: f.result() for k, f in futures.items()}
    return join(), ref


def _assert_updates(got, want):
    assert len(got) == len(want)
    for k, (u, w) in enumerate(zip(got, want)):
        assert set(u) == set(w)
        for n in w:
            assert np.isfinite(u[n]).all()
            np.testing.assert_allclose(u[n], w[n], atol=ATOL, rtol=RTOL,
                                       err_msg=f"step {k} {n}")


def _recon(U, D):
    U, D = np.asarray(U, np.float64), np.asarray(D, np.float64)
    return (U * D[..., None, :]) @ np.swapaxes(U, -1, -2)


def _assert_factors(got, jst):
    """M and U·diag(D)·Uᵀ per factor (eigenbases may rotate), both at the
    reference's tolerance for M (the packages round differently, so the
    reference's sharded-vs-replicated atol alone is too tight across
    them)."""
    for name, sides in got.items():
        for side, (M, U, D) in sides.items():
            js = getattr(jst.factors[name], side)
            np.testing.assert_allclose(M, js.M, atol=ATOL, rtol=RTOL)
            np.testing.assert_allclose(_recon(U, D), _recon(js.U, js.D),
                                       atol=ATOL, rtol=RTOL)


def _ranks(world, name):
    return worker.ok(world[0], name)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_sharded_sync_matches_replicated(world, variant, mesh):
    """Staggered synchronous ``Kfac.update`` under the engine ≡ the
    reference's replicated run, on every rank, factors included."""
    want, jst = world[1][f"sync-{variant}"]
    for got in _ranks(world, f"sync-{variant}-{mesh}"):
        _assert_updates(got["updates"], want)
        _assert_factors(got["factors"], jst)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_sharded_async_lag0_matches_sync_replicated(world, variant, mesh):
    """lag 0: each member snapshots and lands only its own slots, in its
    own program — the reference's synchronous replicated run."""
    want, _ = world[1][f"sync-{variant}"]
    for got in _ranks(world, f"lag0-{variant}-{mesh}"):
        _assert_updates(got["updates"], want)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("variant", LAG_VARIANTS)
def test_sharded_async_lag2_matches_replicated(world, variant, mesh):
    """lag 2, step-varying operands: the in-flight snapshots, the panel
    ring and the landing shard; the gathered buffers equal the
    reference's."""
    want, jst = world[1][f"lag2-{variant}"]
    for got in _ranks(world, f"lag2-{variant}-{mesh}"):
        _assert_updates(got["updates"], want)
        assert set(got["inflight"]) == set(jst.inflight)
        for key, (M, panels, live) in got["inflight"].items():
            jb = jst.inflight[key]
            np.testing.assert_allclose(M, jb.M, atol=ATOL, rtol=RTOL)
            np.testing.assert_allclose(panels, jb.panels, atol=ATOL,
                                       rtol=RTOL)
            np.testing.assert_array_equal(live, np.asarray(jb.live))


def test_row_split_heavy_matches_replicated(world):
    """An 8-slot stacked bucket on the (2, 2) mesh: each curvature member
    holds 4 slots, which divide over the 2 row members, so the row-split
    branch of ``_heavy_rows`` runs (each row member computes 2 slots' EVD
    and the chunks re-gather)."""
    want, jst = world[1]["rowsplit"]
    for got in _ranks(world, "rowsplit"):
        _assert_updates(got["updates"], want)
        _assert_factors(got["factors"], jst)


def test_compressed_gather_stays_close_to_raw(world):
    """The reference's bound (tests/test_mesh2d.py:444): rank-8 PowerSGD
    (U, λ) gathers on the 2D mesh stay within half the raw update's norm,
    and finite."""
    raw = _ranks(world, "compress-None")[0]["updates"]
    for got in _ranks(world, "compress-8"):
        for ua, uc in zip(raw, got["updates"]):
            for n in ua:
                assert np.isfinite(uc[n]).all()
                assert np.linalg.norm(ua[n] - uc[n]) <= \
                    0.5 * np.linalg.norm(ua[n]) + 1e-6


def test_held_m_bytes_equal_per_device_m_bytes(world):
    """Memory is the point of the engine: every rank holds exactly
    ``m_bytes()[1]`` of dense M (its local slots, pad rows included,
    row-blocked on the 2D mesh), and the per-tap M leaves of those
    buckets are empty placeholders."""
    seen = 0
    for res in world[0]:
        for name, got in res.items():
            if "error" in got or "held" not in got:
                continue
            rep, dev = got["m_bytes"]
            assert got["held"] == dev, name
            if got["held"]:
                assert dev < rep
            seen += 1
    assert seen >= 4 * 20


def test_ranks_agree(world):
    """Every member ends a step with the same updates (the low-rank reps
    are gathered, so the preconditioning is replicated)."""
    for name in world[0][0]:
        runs = _ranks(world, name)
        for other in runs[1:]:
            for a, b in zip(runs[0]["updates"], other["updates"]):
                for n in a:
                    np.testing.assert_array_equal(a[n], b[n])
