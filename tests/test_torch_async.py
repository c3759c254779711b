"""The port's async heavy pipeline held against the JAX package: the
in-flight buffer primitives (``core/kfactor.py``), the launch/land
schedule, the optimizer's async branch on the reference's tap harness
(``tests/test_async_inverse.py``) for kfac, brkfac, bkfacc and nskfac, the
``AsyncInverseRunner`` through ``run_kfac_training(overlap=True)``.  The
whole slice (a small-VGG B-R-KFAC trajectory that launches and lands) is
``test_torch_async_slice.py``.

The reference snapshots per-slot PRNG keys and redraws from them when it
lands; the port snapshots the launch step's draws.  So the reference's
draws are recomputed from its keys and injected on every step that fires
a heavy range *or launches one* (``reference_draws_async``).
"""
import dataclasses
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import kfactor as jkf  # noqa: E402
from repro_torch.core import kfac as tkfac  # noqa: E402
from repro_torch.core import kfactor as tkf  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.optim import base as tbase  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from synthdata import tap_data  # noqa: E402
from test_async_inverse import _opt as jopt_for, _run as jrun  # noqa: E402
from test_torch_vgg import CPU, reference_draws  # noqa: E402


def _t(x, dtype=np.float32):
    return torch.from_numpy(np.array(x, dtype))


def reference_draws_async(opt, rng, work):
    """The reference's draws of one step for every bucket that fires a
    heavy range or launches one (the port stores a launch's draws in the
    buffer, where the reference stores the keys they come from)."""
    fired = dataclasses.replace(work, heavy=tuple(
        h or l for h, l in zip(work.heavy, work.launch)))
    return reference_draws(opt, rng, fired)


# ---------------------------------------------------------------------------
# buffer primitives (reference: TestInflightPrimitives)
# ---------------------------------------------------------------------------

def _specs(mode=jkf.Mode.BRAND_RSVD):
    kw = dict(d=24, r=6, n_stat=8)
    return (jkf.KFactorSpec(mode=mode, **kw),
            tkf.KFactorSpec(mode=tkf.Mode(mode.value), **kw))


def test_record_panel_ring_order():
    js, ts = _specs()
    jbuf = jkf.make_inflight(js, total=2, n_replay=2)
    tbuf = tkf.make_inflight(ts, total=2, n_replay=2)
    for i in range(3):
        x = np.full((2, 24, 8), float(i), np.float32)
        jbuf = jkf.record_panel(jbuf, jnp.asarray(x))
        tbuf = tkf.record_panel(tbuf, _t(x))
    # the ring holds the last two panels, oldest first, as the reference's
    np.testing.assert_array_equal(tbuf.panels.numpy(),
                                  np.asarray(jbuf.panels))
    assert float(tbuf.panels[:, 0].max()) == 1.0


def test_record_panel_noop_without_replay():
    _, ts = _specs()
    buf = tkf.make_inflight(ts, total=2, n_replay=0)
    out = tkf.record_panel(buf, torch.ones((2, 24, 8)))
    assert out.panels.shape == (2, 0, 24, 8)


@pytest.mark.parametrize("mode", [jkf.Mode.BRAND_RSVD, jkf.Mode.BRAND_CORR,
                                  jkf.Mode.EVD])
def test_launch_snapshot_touches_only_range(mode):
    """Slot 1 of 3 is snapshotted with its draws; slots 0 and 2 stay as
    made (zero), exactly as the reference's buffer (whose draws are the
    keys they come from)."""
    js, ts = _specs(mode)
    rng = np.random.default_rng(1)
    st = {f: rng.standard_normal((3,) + s).astype(np.float32)
          for f, s in (("U", (24, ts.width)), ("D", (ts.width,)),
                       ("M", (24, 24)), ("aux", (tkf.AUX_WIDTH,)))}
    keys = jax.random.split(jax.random.PRNGKey(1), 3)
    jbuf = jax.jit(jkf.launch_snapshot, static_argnums=(3, 4))(
        jkf.make_inflight(js, 3, 0),
        jkf.KFactorState(**{k: jnp.asarray(v) for k, v in st.items()}),
        keys, 1, 2)
    draws = tkf.draw_heavy(ts, 3, torch.Generator().manual_seed(0)) \
        if tkf.needs_draws(ts) else None
    tbuf = tkf.launch_snapshot(tkf.make_inflight(ts, 3, 0),
                               tkf.KFactorState(**{k: _t(v) for k, v in
                                                   st.items()}),
                               draws, 1, 2)
    for f in ("U", "D", "M", "live"):
        np.testing.assert_array_equal(getattr(tbuf, f).numpy(),
                                      np.asarray(getattr(jbuf, f)), f)
    if draws is not None:
        torch.testing.assert_close(tbuf.draws[1], draws[1], rtol=0, atol=0)
        assert not tbuf.draws[0].any() and not tbuf.draws[2].any()
    assert tbuf.live.tolist() == [False, True, False]


def _primed(js, ts, seed, B=2):
    """A stats-absorbed state in both packages from the same numpy X."""
    X0 = np.random.default_rng(seed).standard_normal((B, 24, 8)).astype(
        np.float32)
    jst = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (B,) + x.shape),
                                 js.init())
    jst = jkf.stats_step(js, jst, jnp.asarray(X0), jnp.asarray(True))
    tst = ts.init().map(lambda x: x.expand((B,) + x.shape).clone())
    tst = tkf.stats_step(ts, tst, _t(X0), True)
    return jst, tst


@pytest.mark.parametrize("mode", [jkf.Mode.BRAND_RSVD, jkf.Mode.BRAND_CORR])
def test_land_swap_is_heavy_of_snapshot_plus_replay(mode):
    """The landed rep equals heavy(snapshot) with the ring's panel
    replayed, computed by hand from the same buffer (the reference's
    check, at its tolerance); M is never touched and the live flag is
    consumed.  (The landing against the reference's own is held by
    test_async_updates_match_reference, whose brkfac and bkfacc runs land
    with two replayed panels.)"""
    js, ts = _specs(mode)
    B = 2
    _, tst = _primed(js, ts, seed=2, B=B)
    if mode is jkf.Mode.BRAND_CORR:    # the correction needs a Brand basis
        X1 = np.random.default_rng(5).standard_normal((B, 24, 8))
        tst = tkf.brand_step(ts, tst, _t(X1), True)
    panel = np.random.default_rng(9).standard_normal((B, 24, 8)).astype(
        np.float32)
    draws = tkf.draw_heavy(ts, B, torch.Generator().manual_seed(2))
    tbuf = tkf.record_panel(tkf.make_inflight(ts, B, 1), _t(panel))
    tbuf = tkf.launch_snapshot(tbuf, tst, draws, 0, B)
    assert bool(tbuf.live.all())
    tlanded, tbuf_after = tkf.land_swap(ts, tst, tbuf, 0, B)
    U, D, _ = tkf.heavy_from_snapshot(ts, tbuf, 0, B)
    U, D = tkf.replay_panels(ts, U, D, tbuf.panels[0:B])
    np.testing.assert_allclose(tlanded.U.numpy(), U.numpy())
    np.testing.assert_allclose(tlanded.D.numpy(), D.numpy())
    torch.testing.assert_close(tlanded.M, tst.M, rtol=0, atol=0)
    assert not bool(tbuf_after.live.any())


def test_land_without_launch_is_noop():
    """A landing whose launch was dropped or never fired leaves the live
    state untouched, and so does a second landing after a consumed
    launch."""
    _, ts = _specs()
    B = 2
    _, st = _primed(*_specs(), seed=3, B=B)
    st = dataclasses.replace(st, U=st.U + 0.5, D=st.D + 1.0)
    buf = tkf.make_inflight(ts, total=B, n_replay=0)
    out, buf2 = tkf.land_swap(ts, st, buf, 0, B)
    torch.testing.assert_close(out.U, st.U, rtol=0, atol=0)
    torch.testing.assert_close(out.D, st.D, rtol=0, atol=0)
    draws = tkf.draw_heavy(ts, B, torch.Generator().manual_seed(3))
    buf2 = tkf.launch_snapshot(buf2, st, draws, 0, B)
    mid, buf3 = tkf.land_swap(ts, st, buf2, 0, B)
    again, _ = tkf.land_swap(ts, mid, buf3, 0, B)
    torch.testing.assert_close(again.U, mid.U, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["kfac", "brkfac", "bkfacc", "nskfac"])
@pytest.mark.parametrize("lag", [0, 2, 3])
def test_async_schedule_matches_reference(variant, lag):
    """Heavy, launch and land ranges of every step of two cycles, and the
    sync-only units, equal the reference scheduler's."""
    jopt = jopt_for(variant, lag=lag)
    topt = _topt(variant, lag=lag)
    js, ts = jopt.scheduler(), topt.scheduler()
    assert [(u.bucket, u.lo, u.hi, u.phase, u.sync_only) for u in js.units] \
        == [(u.bucket, u.lo, u.hi, u.phase, u.sync_only) for u in ts.units]
    for k in range(2 * js.cycle + lag + 1):
        jw, tw = js.work(k), ts.work(k)
        assert (jw.heavy, jw.launch, jw.land, jw.label) == (
            tw.heavy, tw.launch, tw.land, tw.label), k
    assert topt._async_buckets == jopt._async_buckets


def test_lag_must_be_below_the_heavy_period():
    with pytest.raises(ValueError, match="heavy_lag"):
        _topt("kfac", lag=4)


def test_async_requires_bucketed():
    with pytest.raises(ValueError, match="bucketed"):
        _topt("kfac", lag=2, bucketed=False)


# ---------------------------------------------------------------------------
# optimizer level, on the reference's tap harness
# ---------------------------------------------------------------------------

def _taps():
    return {"fc": tkfac.TapInfo("fc/w", 48, 32, n_stat=16),
            "scan": tkfac.TapInfo("scan/w", 48, 48, stack=(3,), n_stat=16)}


def _topt(variant="kfac", lag=0, **kw):
    """The port's counterpart of test_async_inverse._opt."""
    kwargs = dict(policy=tpolicy.PolicyConfig(variant=variant, r=8,
                                              max_dense_dim=8192),
                  lr=tbase.constant(0.05), T_updt=1, T_brand=1, T_inv=4,
                  T_rsvd=4, T_corct=4, stagger=True, stagger_splits=2,
                  async_heavy=True, heavy_lag=lag)
    kwargs.update(kw)
    return tkfac.Kfac(tkfac.KfacConfig(**kwargs), _taps(), device=CPU)


STEPS = 8


@pytest.fixture(scope="module")
def harness():
    """Per step: the reference's operands (as the port's tensors) and its
    step key, from test_async_inverse._run's chain."""
    jtaps = jopt_for("kfac").taps
    params = {f"{n}/w": _t(p["w"])
              for n, p in tap_data(jtaps)[0].items()}
    steps = []
    for s in range(STEPS):
        _, grads, acts, pgs = tap_data(jtaps, jax.random.PRNGKey(100 + s))
        steps.append(dict(
            grads={f"{n}/w": _t(g["w"]) for n, g in grads.items()},
            acts={n: _t(a) for n, a in acts.items()},
            pgs={n: _t(p) for n, p in pgs.items()},
            rng=jax.random.fold_in(jax.random.PRNGKey(7), s)))
    return params, steps


def _trun(topt, harness, jopt, landing_fn=None, steps=STEPS):
    """The port's counterpart of test_async_inverse._run, with the
    reference's draws (from ``jopt``'s buckets and schedule) injected."""
    params, data = harness
    sched, jsched = topt.scheduler(), jopt.scheduler()
    st = topt.init(params)
    outs = []
    for s in range(steps):
        d = data[s]
        work = sched.work(s)
        landing = landing_fn(st, work) if landing_fn else None
        upd, st = topt.update(
            d["grads"], st, params, acts=d["acts"], probe_grads=d["pgs"],
            n_tokens=16, rng=None, work=work, landing=landing,
            draws=reference_draws_async(jopt, d["rng"], jsched.work(s)))
        outs.append(upd)
    return outs, st


ASYNC_VARIANTS = ("kfac", "brkfac", "bkfacc", "nskfac")


@pytest.mark.parametrize("variant", ASYNC_VARIANTS)
def test_async_updates_match_reference(variant, harness):
    """lag 2, stagger 2, every period 4 or 1: 8 updates of the port
    against the reference's, launches and landings included (the tap
    harness's tolerance, rtol 1e-5 / atol 1e-6)."""
    jopt = jopt_for(variant, lag=2)
    want, jst = jrun(jopt, steps=STEPS)
    got, tst = _trun(_topt(variant, lag=2), harness, jopt)
    for k, (u, w) in enumerate(zip(got, want)):
        for n in ("fc", "scan"):
            np.testing.assert_allclose(u[f"{n}/w"].numpy(),
                                       np.asarray(w[n]["w"]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"step {k} {n}")
    assert set(tst.inflight) == set(jst.inflight)
    for key, jbuf in jst.inflight.items():
        assert tst.inflight[key].live.tolist() == np.asarray(
            jbuf.live).tolist()


@pytest.mark.parametrize("variant", ASYNC_VARIANTS)
def test_lag0_async_equals_sync_bitwise(variant, harness):
    """lag 0 launches and lands on the same step: bit for bit the
    synchronous optimizer on the same draws."""
    jopt = jopt_for(variant, lag=0)
    a, _ = _trun(_topt(variant, lag=0), harness, jopt)
    b, _ = _trun(_topt(variant, lag=0, async_heavy=False), harness, jopt)
    for k, (ua, ub) in enumerate(zip(a, b)):
        for key in ua:
            assert torch.equal(ua[key], ub[key]), (k, key)


@pytest.mark.parametrize("variant", ASYNC_VARIANTS)
def test_staleness_contract_lag_vs_sync(variant, harness):
    """lag 2 is not sync shifted: equal on the warmup step, apart from the
    first in-flight window on — by more than 1e-5 of the updates' scale,
    100 times fp32 rounding (the same run at lag 0 is equal bit for bit,
    above; bkfacc's correction re-solves only n_crc columns of a basis the
    Brand update keeps current, so its gap is the smallest: 6.4e-5 of the
    scale)."""
    jopt = jopt_for(variant, lag=2)
    a, _ = _trun(_topt(variant, lag=2, async_heavy=False), harness, jopt)
    b, _ = _trun(_topt(variant, lag=2), harness, jopt)
    for key in a[0]:
        torch.testing.assert_close(b[0][key], a[0][key], rtol=1e-5,
                                   atol=1e-6)
    diffs = [max(float((b[k][key] - a[k][key]).abs().max()) for key in a[k])
             for k in range(STEPS)]
    scale = max(float(u.abs().max()) for upd in a for u in upd.values())
    assert max(diffs[1:]) > 1e-5 * scale, (diffs, scale)


@pytest.mark.parametrize("variant", ASYNC_VARIANTS)
def test_overlapped_landing_equals_in_graph(variant, harness):
    """Landing pre-computed heavy results gives the in-line landing's
    numbers (rtol 1e-6 / atol 1e-7, the reference's tolerance)."""
    jopt = jopt_for(variant, lag=2)
    topt = _topt(variant, lag=2)

    def precompute(st, work):
        out = {}
        for bi, ranges in enumerate(work.land):
            if ranges:
                spec = topt.factor_buckets[bi].spec
                out[str(bi)] = tuple(tkf.heavy_from_snapshot(
                    spec, st.inflight[str(bi)], lo, hi) for lo, hi in ranges)
        return out or None

    a, _ = _trun(topt, harness, jopt)
    b, _ = _trun(_topt(variant, lag=2), harness, jopt, landing_fn=precompute)
    for k, (ua, ub) in enumerate(zip(a, b)):
        for key in ua:
            torch.testing.assert_close(ub[key], ua[key], rtol=1e-6,
                                       atol=1e-7, msg=f"step {k} {key}")


def test_clear_inflight_turns_landings_into_noops(harness):
    topt = _topt("kfac", lag=2)
    st = topt.init(harness[0])
    for buf in st.inflight.values():
        buf.live.fill_(True)
    cleared = topt.clear_inflight(st)
    assert all(not b.live.any() for b in cleared.inflight.values())
    assert _topt("kfac", async_heavy=False).init(harness[0]).inflight == {}


def _tiny():
    """The reference runner test's model: one 24×8 tap, kfac r = 4,
    T_inv = 4, stagger, lag 2, 8 steps."""
    key = jax.random.PRNGKey(0)
    w = np.asarray(jax.random.normal(key, (24, 8))) * 0.1
    batches = [(np.asarray(jax.random.normal(jax.random.fold_in(key, i),
                                             (8, 24))),
                np.asarray(jax.random.normal(jax.random.fold_in(key, 50 + i),
                                             (8, 8))))
               for i in range(8)]
    return w, batches


def _tiny_loss(p, probes, batch):
    from repro_torch.models import layers
    x, y = batch
    h, act = layers.tapped_matmul(p["fc/w"], x, probes.get("fc"), 8)
    return torch.mean((h - y) ** 2), {"fc": act}


def _tiny_run(variant, overlap, device=CPU):
    w, batches = _tiny()
    cfg = tkfac.KfacConfig(
        policy=tpolicy.PolicyConfig(variant=variant, r=4),
        lr=tbase.constant(0.05), T_updt=1, T_inv=4, T_rsvd=4, T_brand=1,
        stagger=True, async_heavy=True, heavy_lag=2)
    opt = tkfac.Kfac(cfg, {"fc": tkfac.TapInfo("fc/w", 24, 8, n_stat=8)},
                     device=device)
    params = {"fc/w": _t(w).to(device).requires_grad_()}
    runner = tloop.AsyncInverseRunner.for_opt(opt) if overlap else None
    _, losses = tloop.run_kfac_training(
        _tiny_loss, opt, params,
        [(_t(x).to(device), _t(y).to(device)) for x, y in batches],
        n_tokens=8, device=device, overlap=runner or False)
    return losses, runner


def test_async_runner_matches_in_graph_end_to_end():
    """The threaded runner through run_kfac_training(overlap=True)
    reproduces the in-line landing (rtol 1e-6, the reference's
    tolerance), lands every range whose landing falls in the run and
    misses none."""
    la, _ = _tiny_run("kfac", overlap=False)
    lb, runner = _tiny_run("kfac", overlap=True)
    np.testing.assert_allclose(lb, la, rtol=1e-6)
    # every range whose landing falls inside the 8 steps landed from the
    # worker; the last launch's landing falls after the run
    sched = runner.opt.scheduler()
    n_land = sum(len(r) for k in range(8) for r in sched.work(k).land)
    h = runner.health
    assert h["landed"] == n_land >= 2 and h["missed"] == 0, h
    assert h["launched"] == n_land + 1
    # a heavy op per landed range (the unlanded one may be cancelled by
    # close() before it starts)
    assert n_land <= len(runner.durations) <= h["launched"]


def test_runner_is_none_for_a_sync_config():
    opt = _topt("kfac", async_heavy=False)
    assert tloop.AsyncInverseRunner.for_opt(opt) is None
    # a telemetry writer is taken as given (its events: test_torch_obs.py)
    writer = object()
    assert tloop.AsyncInverseRunner.for_opt(_topt("kfac", lag=2),
                                            writer=writer).writer is writer


def test_runner_miss_lands_in_line(monkeypatch):
    """A landing with no pending launch (a resume mid-lag) misses and
    lands in line; a crashed worker is counted, respawned and lands in
    line too."""
    topt = _topt("kfac", lag=2)
    runner = tloop.AsyncInverseRunner(topt)
    sched = topt.scheduler()
    k = next(k for k in range(1, 8) if any(sched.work(k).land))
    out = runner.landing(sched.work(k))
    assert all(r is None for v in out.values() for r in v)
    assert runner.health["miss_reasons"] == {"resume": sum(
        len(r) for r in sched.work(k).land)}
    st = topt.init({"fc/w": torch.zeros(48, 32),
                    "scan/w": torch.zeros(3, 48, 48)})

    def boom(*_):
        raise FloatingPointError("worker fault")
    monkeypatch.setattr(tkf, "heavy_from_snapshot", boom)
    w = next(sched.work(j) for j in range(1, 8) if any(sched.work(j).launch))
    runner.launch(st, w)
    land = dataclasses.replace(w, land=w.launch)
    out = runner.landing(land)
    assert runner.health["miss_reasons"].get("crash") == runner.health[
        "launched"] and runner.health["respawns"] >= 1
    assert isinstance(runner.last_error, FloatingPointError)
    assert all(r is None for v in out.values() for r in v)
    runner.close()


def test_launch_counts_are_exact_across_threads():
    """Kernel launch counts stay exact when several threads count at once
    (the async worker launches kernels beside the training step)."""
    k = _build.Kernel("count_probe", "none", [])
    old = sys.getswitchinterval()
    try:
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(
            target=lambda i=i: [k.count(side=i % 2 == 1)
                                for _ in range(2000)]) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert (k.launches, k.side_launches) == (32000, 16000)
        assert _build.side_launch_counts()["count_probe"] == 16000
    finally:
        sys.setswitchinterval(old)
        _build.KERNELS.pop("count_probe")
