"""The port's resilience layer held against the JAX package's
(``tests/test_chaos.py``, ``TestStraggler`` of
``tests/test_fault_tolerance.py``): the remediation policy's actions on
the same report sequences, seeded fault plans, the guard's report on the
same step, health-on equal to health-off bit for bit, and every fault
class the one-device trainer survives — NaN batches through the whole
ladder, a poisoned in-flight snapshot, hung and dead async workers, and a
truncated checkpoint walked past by the rollback.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import kfac as jkfac  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.train import chaos as jchaos  # noqa: E402
from repro.train import health as jhealth  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train import straggler as jstraggler  # noqa: E402
from repro_torch import specs  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.obs import events as ev  # noqa: E402
from repro_torch.obs import summary as tsum  # noqa: E402
from repro_torch.train import chaos  # noqa: E402
from repro_torch.train import health  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.train import straggler  # noqa: E402
from repro_torch.train.chaos import ChaosMonkey, Fault  # noqa: E402
from repro_torch.train.health import HealthConfig, RemediationPolicy  # noqa: E402,E501
from test_obs import _batches, _cfg, _make_mlp, _mlp_loss  # noqa: E402
from test_torch_obs import (CPU, N_BS, VARIANTS, assert_identical,  # noqa: E402,E501
                            read, tbatches, tloss, topt, tparams, ttrain)


def _all_finite(tensors) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors
               if t.is_floating_point())


def _factor_tensors(state):
    return [t for tap in state.opt.factors.values() for side in (tap.A, tap.G)
            for t in (side.U, side.D, side.M)]


# ---------------------------------------------------------------------------
# fault plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,kinds,n_faults", [
    (7, chaos.KINDS, 5), (8, chaos.KINDS, 5), (0, ("nan_grad",), 3),
    (3, ("drop_landing", "hang_landing"), 19)])
def test_seeded_plan_equals_the_references(seed, kinds, n_faults):
    got = ChaosMonkey.from_seed(seed, 20, kinds=kinds, n_faults=n_faults)
    want = jchaos.ChaosMonkey.from_seed(seed, 20, kinds=kinds,
                                        n_faults=n_faults)
    assert [(f.step, f.kind) for f in got.faults] == [
        (f.step, f.kind) for f in want.faults]
    assert tuple(chaos.KINDS) == tuple(jchaos.KINDS)


def test_unknown_kind_rejected():
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault(3, "meteor_strike")


def test_empty_plan_is_inert():
    m = ChaosMonkey(())
    batch = (torch.ones((2, 3)), torch.zeros((2,)))
    assert m.corrupt_batch(5, batch) is batch
    m.check(5)
    m.harass_runner(5, None)
    assert m.injected == [] and m.summary() == {}


def test_corrupt_batch_nans_float_tensors_only():
    m = ChaosMonkey((Fault(2, "nan_grad"),))
    x, idx = torch.ones((4,)), torch.arange(4)
    bx, bidx = m.corrupt_batch(2, (x, idx))
    assert bool(torch.isnan(bx).all()) and torch.equal(bidx, idx)
    assert m.summary() == {"nan_grad": 1}


def test_host_loss_raises():
    m = ChaosMonkey((Fault(4, "host_loss"),))
    m.check(3)
    with pytest.raises(RuntimeError, match="injected node failure"):
        m.check(4)


# ---------------------------------------------------------------------------
# the policy: the reference's actions on the same report sequences
# ---------------------------------------------------------------------------

def _report(ok=1.0, **extra):
    rep = {"ok": ok, "grad_nonfinite": 0.0 if ok else 8.0,
           "grad_abs_max": 1.0, "update_nonfinite": 0.0,
           "update_abs_max": 1.0, "bucket0/factor_nonfinite": 0.0}
    rep.update(extra)
    return rep


NAN = float("nan")
SEQUENCES = {
    # 6-step faulty streak: skip ×6, escalate ×2, refresh, rollback
    "streak": [(NAN, _report(ok=0.0))] * 6 + [(1.0, _report())],
    # escalate, then four healthy steps de-escalate
    "recover": [(NAN, _report(ok=0.0))] + [(1.0, _report())] * 4,
    # an ok report with a diverged loss: a fault without a skip
    "diverge": [(1.0, _report())] * 3 + [(1e6, _report())],
    "ns_blowup": [(1.0, _report(**{"bucket0/ns_res": 0.9}))],
    "mixed": ([(1.0, _report())] * 2 + [(NAN, _report(ok=0.0))] * 3
              + [(1.0, _report())] * 5 + [(NAN, _report(ok=0.0))] * 7),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
@pytest.mark.parametrize("recovery_steps", [3, 4])
def test_policy_actions_equal_the_references(name, recovery_steps,
                                             tmp_path):
    got = RemediationPolicy(HealthConfig(recovery_steps=recovery_steps))
    want = jhealth.RemediationPolicy(jhealth.HealthConfig(
        recovery_steps=recovery_steps))
    path = tmp_path / "e.jsonl"
    with ev.TelemetryWriter(str(path), console=False) as w:
        got.writer = w
        for k, (loss, rep) in enumerate(SEQUENCES[name]):
            assert got.observe(k, loss, rep) == want.observe(k, loss, rep)
            assert got.take_refresh() == want.take_refresh()
            assert got.take_rollback() == want.take_rollback()
            assert got.damping_scale == want.damping_scale
    assert got.actions == want.actions
    assert [{f: e[f] for f in ("step", "stage", "action", "detail")}
            for e in read(path) if e["type"] == "remediation"] == got.actions


# ---------------------------------------------------------------------------
# the guard's report
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_reports():
    """One bkfac step of the MLP in the reference, on a clean batch and
    on one whose target holds a NaN (its jitted update and report, one
    compile each): {poison: (batch, report)}."""
    jparams, jtaps = _make_mlp()
    jopt = jkfac.Kfac(_cfg("bkfac"), jtaps)
    work = jopt.scheduler().work(0)

    @jax.jit
    def step(params, batch):
        jp = jlayers.make_probes(jtaps)
        jl, jacts, jgp, jgpr = jloop.kfac_grads(_mlp_loss, params, jp, batch)
        ju, jst = jopt.update(jgp, jopt.init(params), params, acts=jacts,
                              probe_grads=jgpr, n_tokens=N_BS,
                              rng=jax.random.PRNGKey(0), work=work)
        return jhealth.health_report(jhealth.HealthConfig(), jopt, jl, jgp,
                                     ju, jst)

    out = {}
    for poison in (False, True):
        x, y = _batches(1)[0]
        if poison:  # the target, not the input: torch's relu passes a
            # NaN gradient at a NaN input where jax's stops it
            y = y.at[0, 0].set(jnp.nan)
        rep = jax.device_get(step(jparams, (x, y)))
        out[poison] = ((x, y), {k: float(v) for k, v in rep.items()})
    return out


@pytest.mark.parametrize("poison", [False, True])
def test_health_report_equals_the_references(poison, reference_reports):
    """The port's report on the same step: the same keys; the verdict and
    every nonfinite count equal; the largest magnitudes within 1e-4
    where finite."""
    from repro_torch.train import loop as tl
    (x, y), want = reference_reports[poison]
    opt = topt("bkfac")
    params = tparams()
    probes = tlayers.make_probes(opt.taps, device=CPU)
    batch = (torch.from_numpy(np.array(x)), torch.from_numpy(np.array(y)))
    loss, acts, gp, gpr = tl.kfac_grads(tloss, params, probes, batch)
    upd, st = opt.update(gp, opt.init(params), params, acts=acts,
                         probe_grads=gpr, n_tokens=N_BS, rng=None,
                         work=opt.scheduler().work(0))
    got = health.health_report(HealthConfig(), opt, loss, gp, upd, st)
    assert set(got) == set(want)
    assert got["ok"] == want["ok"] == (0.0 if poison else 1.0)
    for k, v in want.items():
        if k.endswith("nonfinite"):
            assert got[k] == v, k
        elif np.isfinite(v):
            np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("nan_at", [None, 0, 2])
def test_factorizations_give_nan_for_a_nonfinite_matrix(nan_at):
    """The port's eigh (and the Brand init's SVD) on a batch: a matrix
    with a NaN gives NaN results, as the reference's factorizations do,
    instead of LAPACK's error; the others are decomposed as if alone."""
    from repro_torch.core import brand as tbrand
    from repro_torch.kernels import ref as tref
    g = torch.Generator().manual_seed(0)
    A = torch.randn((3, 12, 12), generator=g)
    M = A @ A.mT
    X = torch.randn((3, 12, 5), generator=g)
    if nan_at is not None:
        M[nan_at, 3, 2] = float("nan")   # eigh reads the lower triangle
        X[nan_at, 0, 0] = float("nan")
    vals, vecs = tref.eigh(M)
    U, D = tbrand.init_from_factor(X, 8)
    for i in range(3):
        if i == nan_at:
            assert torch.isnan(vals[i]).all() and torch.isnan(vecs[i]).all()
            assert torch.isnan(D[i, :5]).all() and torch.isnan(U[i]).any()
            continue
        v, _ = tref.eigh(M[i:i + 1])
        assert torch.equal(vals[i:i + 1], v)
        _, d = tbrand.init_from_factor(X[i:i + 1], 8)
        torch.testing.assert_close(D[i:i + 1], d)


# ---------------------------------------------------------------------------
# acceptance claim 1: the guards are inert on healthy runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_health_on_equals_health_off(variant):
    s_off, l_off = ttrain(variant)
    pol = RemediationPolicy(HealthConfig())
    s_on, l_on = ttrain(variant, policy=pol)
    assert_identical(s_off, l_off, s_on, l_on)
    assert pol.actions == [] and pol.damping_scale == 1.0


@pytest.mark.parametrize("variant", ["bkfac", "rkfac"])
def test_health_inert_through_async_pipeline(variant):
    """The same with the overlapped launch/land pipeline (rkfac: real
    worker-thread landings; bkfac: no heavy op to pipeline)."""
    kw = dict(steps=10, async_heavy=True, heavy_lag=2, stagger=True,
              stagger_splits=2, overlap=True)
    s_off, l_off = ttrain(variant, **kw)
    s_on, l_on = ttrain(variant, health=True, **kw)
    assert_identical(s_off, l_off, s_on, l_on)


def test_healthy_run_health_metrics_all_zero(tmp_path):
    path = tmp_path / "events.jsonl"
    with ev.TelemetryWriter(str(path), console=False) as w:
        ttrain("bkfac", health=True, writer=w, metrics_every=3)
    metrics = [e for e in read(path) if e["type"] == "metrics"]
    assert metrics
    for e in metrics:
        assert e["values"]["health/guard_trips"] == 0.0
        assert e["values"]["health/grad_nonfinite"] == 0.0


# ---------------------------------------------------------------------------
# acceptance claim 2: every fault class ends in a documented remediation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_nan_grad_recovery_ladder(variant):
    """Three poisoned batches: each skipped (NaN loss, parameters
    untouched), damping escalated twice, a forced refresh, and four
    healthy steps later the damping back at exactly 1.0."""
    cm = ChaosMonkey(tuple(Fault(k, "nan_grad") for k in (3, 4, 5)))
    pol = RemediationPolicy(HealthConfig())
    snaps = {}

    def cb(k, state, loss):
        snaps[k] = {n: p.detach().clone() for n, p in state.params.items()}

    state, losses = ttrain(variant, steps=12, policy=pol, chaos=cm,
                           callback=cb)
    assert cm.summary() == {"nan_grad": 3}
    assert [pol.count(a) for a in ("skip", "escalate", "refresh",
                                   "deescalate")] == [3, 2, 1, 1]
    assert pol.damping_scale == 1.0
    for k, loss in enumerate(losses):
        assert np.isfinite(loss) == (k not in (3, 4, 5)), (k, loss)
    for k in (3, 4, 5):
        assert all(torch.equal(snaps[k][n], snaps[2][n]) for n in snaps[2])
    assert _all_finite(state.params.values())
    assert _all_finite(_factor_tensors(state))


def test_corrupt_inflight_lands_guarded(tmp_path):
    """A poisoned in-flight snapshot forced onto the in-line landing
    (futures dropped): the guard catches the NaN swap, a faulty streak
    forces the refresh, and the factors end finite."""
    faults = (Fault(5, "corrupt_inflight"), Fault(5, "drop_landing"),
              Fault(6, "drop_landing"), Fault(7, "drop_landing"),
              Fault(7, "nan_grad"), Fault(8, "nan_grad"))
    cm = ChaosMonkey(faults)
    path = str(tmp_path / "events.jsonl")
    with ev.TelemetryWriter(path, console=False) as w:
        pol = RemediationPolicy(HealthConfig(), writer=w)
        state, _ = ttrain("rkfac", steps=14, policy=pol, chaos=cm,
                          overlap=True, writer=w, async_heavy=True,
                          heavy_lag=2, stagger=True, stagger_splits=1)
    assert cm.summary()["corrupt_inflight"] == 1
    assert cm.summary()["drop_landing"] >= 1
    assert pol.count("skip") >= 3 and pol.count("refresh") >= 1
    assert _all_finite(_factor_tensors(state))
    assert _all_finite(state.params.values())
    misses = [e for e in read(path) if e["type"] == "async_miss"]
    assert misses and {e["reason"] for e in misses} <= {"dropped", "resume"}
    assert any(e["reason"] == "dropped" for e in misses)


def test_hung_and_dead_workers_do_not_change_numbers(monkeypatch):
    """Hang one landing's workers and kill another's: both miss within
    the shortened deadline, the pool respawns, every miss lands in line,
    and the harassed run matches the in-line run (rtol 1e-5, the
    reference's)."""
    kw = dict(async_heavy=True, heavy_lag=2, stagger=True, stagger_splits=1)
    _, ref_losses = ttrain("rkfac", steps=14, **kw)
    orig = tloop.AsyncInverseRunner.for_opt.__func__
    seen = {}

    def patched(cls, opt, writer=None):
        r = orig(cls, opt, writer=writer)
        if r is not None:
            r.deadline_s = 0.3
            seen["runner"] = r
        return r

    monkeypatch.setattr(tloop.AsyncInverseRunner, "for_opt",
                        classmethod(patched))
    cm = ChaosMonkey((Fault(6, "hang_landing"), Fault(10, "worker_death")))
    _, losses = ttrain("rkfac", steps=14, overlap=True, chaos=cm, **kw)
    assert cm.summary() == {"hang_landing": 1, "worker_death": 1}
    h = seen["runner"].health
    assert h["miss_reasons"].get("timeout", 0) >= 1
    assert h["miss_reasons"].get("crash", 0) >= 1
    assert h["respawns"] >= 2
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5, atol=1e-7)


def test_truncated_checkpoint_rollback(tmp_path):
    """A 7-step NaN streak exhausts the ladder into a rollback while the
    newest snapshot is torn on disk: the restore walks past it to the
    older healthy one, copies it into the live parameters, and training
    ends healthy; the event log tells the story and validates."""
    ckpt_dir = str(tmp_path / "ckpt")
    path = str(tmp_path / "events.jsonl")
    cm = ChaosMonkey(tuple(Fault(k, "nan_grad") for k in range(3, 10))
                     + (Fault(2, "truncate_ckpt"),))
    params = tparams()
    with ev.TelemetryWriter(path, console=False) as w:
        pol = RemediationPolicy(HealthConfig(), writer=w)
        state, losses = tloop.run_kfac_training(
            tloss, topt("bkfac"), params, tbatches(14), n_tokens=N_BS,
            device=CPU, obs=specs.ObsSpec(writer=w),
            resilience=specs.ResilienceSpec(policy=pol, chaos=cm),
            ckpt=specs.CkptSpec(dir=ckpt_dir, every=2))
    assert cm.summary()["truncate_ckpt"] == 1
    assert pol.count("rollback") == 1 and pol.count("restored") == 1
    restored = next(a for a in pol.actions if a["action"] == "restored")
    assert "healthy step 0" in restored["detail"]    # walked past step 2
    assert np.isfinite(losses[-1])
    assert all(state.params[k] is params[k] for k in params)
    assert _all_finite(state.params.values())
    evs = read(path)
    assert [e["type"] for e in evs].count("ckpt_restore") == 1
    assert tsum.main([path, "--validate"]) == 0
    res = tsum.summarize(path)["resilience"]
    assert res["remediations"] == len(pol.actions)
    assert res["actions"]["rollback"] == 1


# ---------------------------------------------------------------------------
# stragglers (TestStraggler)
# ---------------------------------------------------------------------------

def _times(k, slow=()):
    t = {f"h{i}": 1.0 for i in range(4)}
    for h in slow:
        t[h] = 3.0
    return t


@pytest.mark.parametrize("case", ["persistent", "blip", "fleet"])
def test_straggler_detector_equals_the_references(case):
    def seq(k):
        if case == "persistent":
            return _times(k, ("h2",) if k >= 4 else ())
        if case == "blip":
            return _times(k, ("h1",) if k == 5 else ())
        return {f"h{i}": 3.0 if k >= 4 else 1.0 for i in range(4)}

    got = straggler.StragglerDetector(patience=3, rebalance_after=6)
    want = jstraggler.StragglerDetector(patience=3, rebalance_after=6)
    for k in range(12):
        a, b = got.observe_step(k, seq(k)), want.observe_step(k, seq(k))
        assert {h: x.value for h, x in a.items()} == {
            h: x.value for h, x in b.items()}
    assert got.events == want.events
    flagged = {e["host"] for e in got.events}
    assert flagged == {"persistent": {"h2"}, "blip": set(),
                       "fleet": set()}[case]


def test_drop_stats_rewrites():
    flags = {"do_stats": True, "do_light": True, "do_heavy": True}
    assert straggler.apply_to_flags(straggler.Action.DROP_STATS, flags) == {
        "do_stats": False, "do_light": False, "do_heavy": False}
    assert straggler.apply_to_flags(straggler.Action.NONE, flags) == flags
    work = topt("kfac", async_heavy=True, heavy_lag=2).scheduler().work(4)
    out = straggler.apply_to_work(straggler.Action.DROP_STATS, work)
    assert not out.any


def test_straggler_mitigations_join_remediation_stream(tmp_path):
    path = tmp_path / "e.jsonl"
    with ev.TelemetryWriter(str(path), console=False) as w:
        det = straggler.StragglerDetector(patience=3, rebalance_after=6,
                                          writer=w)
        for k in range(12):
            det.observe_step(k, _times(k, ("h2",) if k >= 4 else ()))
    evs = [e for e in read(path) if e["type"] == "remediation"]
    assert evs and all(e["stage"] == health.STAGE_ELASTIC for e in evs)
    assert {"drop_stats", "rebalance"} <= {e["action"] for e in evs}
    assert all("straggler h2" in e["detail"] for e in evs)
