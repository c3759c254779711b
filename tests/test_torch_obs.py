"""The port's telemetry (``repro_torch.obs``) held against the JAX
package's (``tests/test_obs.py``): the event schema and console lines, the
Meter's counter/gauge/flush semantics, the metric catalog of every
variant (names, kinds, order), metrics-on equal to metrics-off bit for
bit, the flushed values against the reference's on the same run, event
logs that the reference's ``repro.obs.summary --validate`` accepts, the
async runner's launch/land/miss events, and the profiler spans.

The tapped MLP, its batches and configs are ``tests/test_obs.py``'s,
converted to the port; ``test_torch_state.py`` and
``test_torch_resilience.py`` reuse the helpers here.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import kfac as jkfac  # noqa: E402
from repro.obs import events as jev  # noqa: E402
from repro.obs import metrics as jm  # noqa: E402
from repro.obs import summary as jsum  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro import specs as jspecs  # noqa: E402
from repro_torch import specs  # noqa: E402
from repro_torch.core import kfac as tkfac  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.obs import events as ev  # noqa: E402
from repro_torch.obs import metrics as m  # noqa: E402
from repro_torch.obs import summary as tsum  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.optim import base as tbase  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from test_obs import (N_BS, N_STAT, _SAMPLE_EVENTS, _batches,  # noqa: E402
                      _cfg, _make_mlp, _mlp_loss)

CPU = torch.device("cpu")
VARIANTS = tuple(tpolicy.VARIANTS)


# ---------------------------------------------------------------------------
# the reference's MLP, in the port (shared with the other two files)
# ---------------------------------------------------------------------------

def tcfg(variant, **kw):
    """The port's counterpart of test_obs._cfg."""
    pol = tpolicy.PolicyConfig(variant=variant, r=8, max_dense_dim=512)
    kwargs = dict(policy=pol, lr=tbase.constant(0.05),
                  damping_phi=tbase.constant(0.1), weight_decay=1e-4,
                  clip=10.0, T_updt=1, T_inv=4, T_brand=1, T_rsvd=4,
                  T_corct=4, fallback_lr=tbase.constant(1e-2))
    kwargs.update(kw)
    return tkfac.KfacConfig(**kwargs)


def tparams():
    jparams, _ = _make_mlp()
    return {f"{n}/w": torch.from_numpy(np.array(p["w"], np.float32))
            .requires_grad_() for n, p in jparams.items()}


def ttaps():
    _, jtaps = _make_mlp()
    return {n: tkfac.TapInfo(t.param_path, t.d_in, t.d_out, n_stat=t.n_stat)
            for n, t in jtaps.items()}


def tloss(params, probes, batch):
    x, y = batch
    acts = {}
    h, acts["fc0"] = tlayers.tapped_matmul(params["fc0/w"], x,
                                           probes.get("fc0"), N_STAT)
    h = torch.relu(h)
    h, acts["fc1"] = tlayers.tapped_matmul(params["fc1/w"], h,
                                           probes.get("fc1"), N_STAT)
    return torch.mean(torch.square(h - y)), acts


def tbatches(n):
    return [(torch.from_numpy(np.array(x, np.float32)),
             torch.from_numpy(np.array(y, np.float32)))
            for x, y in _batches(n)]


def topt(variant, **cfg_kw):
    return tkfac.Kfac(tcfg(variant, **cfg_kw), ttaps(), device=CPU)


def ttrain(variant, steps=9, batches=None, state=None, overlap=False,
           writer=None, metrics_every=0, health=None, policy=None,
           chaos=None, ckpt_dir=None, ckpt_every=5, ckpt_keep=3,
           callback=None, **cfg_kw):
    """The port's counterpart of test_chaos._train (fresh parameters each
    call: the port updates them in place)."""
    opt = topt(variant, **cfg_kw)
    return tloop.run_kfac_training(
        tloss, opt, None if state is not None else tparams(),
        batches if batches is not None else tbatches(steps),
        n_tokens=N_BS, seed=0, state=state, overlap=overlap, device=CPU,
        callback=callback,
        obs=specs.ObsSpec(writer=writer, metrics_every=metrics_every),
        resilience=specs.ResilienceSpec(health=health, policy=policy,
                                        chaos=chaos),
        ckpt=specs.CkptSpec(dir=ckpt_dir, every=ckpt_every, keep=ckpt_keep))


def assert_identical(sa, la, sb, lb):
    """Bit for bit: the same losses and parameters."""
    np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))
    for k in sa.params:
        assert torch.equal(sa.params[k], sb.params[k]), k


def read(path):
    return list(ev.read_events(str(path)))


# ---------------------------------------------------------------------------
# event-log schema
# ---------------------------------------------------------------------------

def test_schema_is_the_references():
    assert ev.SCHEMA_VERSION == jev.SCHEMA_VERSION
    assert ev.EVENT_TYPES == jev.EVENT_TYPES


def test_every_event_type_round_trips(tmp_path):
    """One event of each type through the port's writer, read back by
    both packages' readers."""
    path = tmp_path / "events.jsonl"
    with ev.TelemetryWriter(str(path), console=False) as w:
        for etype, fields in _SAMPLE_EVENTS.items():
            w.emit(etype, **fields)
    for reader in (ev.read_events, jev.read_events):
        evs = list(reader(str(path)))
        assert [e["type"] for e in evs] == list(_SAMPLE_EVENTS)
        assert all(e["schema"] == 1 and isinstance(e["t"], float)
                   for e in evs)


def test_writer_rejects_malformed_events(tmp_path):
    w = ev.TelemetryWriter(str(tmp_path / "e.jsonl"), console=False)
    with pytest.raises(ev.EventSchemaError):
        w.emit("no_such_type", x=1)
    with pytest.raises(ev.EventSchemaError):
        w.emit("step", step=0, loss=1.0)       # missing dt_s, phase
    w.close()
    assert read(tmp_path / "e.jsonl") == []


def test_reader_flags_corrupt_lines(tmp_path):
    path = tmp_path / "e.jsonl"
    path.write_text('{"schema": 1, "t": 0.0, "type": "log", "msg": "ok"}\n'
                    "not json\n")
    with pytest.raises(ev.EventSchemaError, match="e.jsonl:2"):
        read(path)
    path.write_text(json.dumps({"schema": 1, "t": 0.0, "type": "xx"}) + "\n")
    assert len(list(ev.read_events(str(path), validate=False))) == 1


@pytest.mark.parametrize("etype", ["log", "step", "run_end", "ckpt_save",
                                   "ckpt_restore", "async_miss",
                                   "remediation", "metrics"])
def test_console_lines_equal_the_references(etype):
    """The console line of each event type (None: kept off the console)
    is the reference's."""
    fields = dict(_SAMPLE_EVENTS.get(etype, {}))
    if etype == "async_miss":
        fields["reason"] = "timeout"
    got, want = [], []
    ev.TelemetryWriter(console_fn=got.append).emit(etype, **fields)
    jev.TelemetryWriter(console_fn=want.append).emit(etype, **fields)
    assert got == want


# ---------------------------------------------------------------------------
# Meter: counter / gauge / flush cadence
# ---------------------------------------------------------------------------

def _toy_meter(sink, every):
    catalog = (m.MetricSpec("c", m.COUNTER), m.MetricSpec("g", m.GAUGE))
    return m.Meter(catalog, sink, every=every, device=CPU)


def test_meter_counter_gauge_flush_cadence():
    got = []
    meter = _toy_meter(lambda s, w, v: got.append((s, w, v)), every=3)
    mbuf = meter.init()
    for k in range(7):
        with meter.collecting() as col:
            m.record("c", 2.0)
            m.record("c", torch.tensor(1.0))   # counters add within a step
            m.record("g", torch.tensor(float(k)))
        mbuf = meter.maybe_flush(meter.merge(mbuf, col), k)
    assert [(s, w) for s, w, _ in got] == [(2, 3), (5, 3)]
    assert got[0][2]["c"] == 9.0            # 3 steps x (2+1)
    assert got[1][2]["c"] == 9.0            # counter reset between windows
    assert got[1][2]["g"] == 5.0            # gauge: last value wins
    meter.drain(mbuf, 6)                    # 1-step partial window
    assert got[-1][0] == 6 and got[-1][1] == 1 and got[-1][2]["c"] == 3.0
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0
               and v.dtype == torch.float32
               for k, v in mbuf.items() if not k.startswith("_"))


def test_meter_runs_on_the_card_unless_asked(monkeypatch):
    """The Meter's buffer lives on the card by default: a host without
    one raises rather than falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    catalog = (m.MetricSpec("c", m.COUNTER),)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.Meter(catalog, lambda *a: None)
    assert m.Meter(catalog, lambda *a: None, device=CPU).init()[
        "c"].device == CPU
    meter = specs.ObsSpec(writer=ev.TelemetryWriter(console=False),
                          metrics_every=1).make_meter(topt("bkfac"))
    assert meter.device == CPU          # the optimizer's device


def test_record_is_noop_without_collector():
    calls = []
    m.record("anything", lambda: calls.append(1) or 1.0)
    assert not calls                        # thunk never evaluated
    assert not m.active()


def test_record_ignores_names_outside_the_catalog():
    meter = _toy_meter(lambda *a: None, every=10)
    with meter.collecting() as col:
        m.record("g", torch.tensor(3.0) * 2.0)
        m.record("not_in_catalog", 1.0)
    out = meter.merge(meter.init(), col)
    assert float(out["g"]) == 6.0 and out["_steps"] == 1
    assert set(col.values) == {"g"}


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("async_heavy", [False, True])
def test_catalog_equals_the_references(variant, async_heavy):
    """catalog_for: the reference's names, kinds and order."""
    kw = dict(async_heavy=async_heavy, heavy_lag=2 if async_heavy else 0)
    taps = {"fc": jkfac.TapInfo("fc/w", 24, 16, n_stat=N_STAT),
            "wide": jkfac.TapInfo("wide/w", 64, 40, n_stat=N_STAT)}
    jopt = jkfac.Kfac(_cfg(variant, **kw), taps)
    opt = tkfac.Kfac(tcfg(variant, **kw), {
        n: tkfac.TapInfo(t.param_path, t.d_in, t.d_out, n_stat=t.n_stat)
        for n, t in taps.items()}, device=CPU)
    assert ([tuple(s[:2]) for s in m.catalog_for(opt)]
            == [tuple(s[:2]) for s in jm.catalog_for(jopt)])


# ---------------------------------------------------------------------------
# metrics are numerically inert
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_metrics_on_equals_metrics_off(variant, tmp_path):
    path = tmp_path / "events.jsonl"
    s_off, l_off = ttrain(variant)
    with ev.TelemetryWriter(str(path), console=False) as w:
        s_on, l_on = ttrain(variant, writer=w, metrics_every=3)
    assert_identical(s_off, l_off, s_on, l_on)
    evs = read(path)
    metrics = [e for e in evs if e["type"] == "metrics"]
    assert [e["window_steps"] for e in metrics] == [3, 3, 3]
    assert sum(e["values"]["work/stats_fired"] for e in metrics) == 9
    assert len([e for e in evs if e["type"] == "step"]) == len(l_on)


def test_async_metrics_on_equals_off(tmp_path):
    """The same through the async launch/land pipeline (in-line
    landings), B-R-KFAC."""
    kw = dict(async_heavy=True, heavy_lag=2, stagger=True, stagger_splits=2)
    s_off, l_off = ttrain("brkfac", steps=10, **kw)
    with ev.TelemetryWriter(str(tmp_path / "e.jsonl"), console=False) as w:
        s_on, l_on = ttrain("brkfac", steps=10, writer=w, metrics_every=3,
                            **kw)
    assert_identical(s_off, l_off, s_on, l_on)
    vals = [e["values"] for e in read(tmp_path / "e.jsonl")
            if e["type"] == "metrics"]
    assert sum(v["work/launch_slots"] for v in vals) > 0
    assert sum(v["work/land_slots"] for v in vals) > 0


@pytest.fixture(scope="module")
def reference_metrics(tmp_path_factory):
    """The reference's flushed metrics windows of a 9-step bkfac and a
    9-step kfac run on the MLP (metrics every 3 steps)."""
    out = {}
    for variant in ("bkfac", "kfac"):
        path = str(tmp_path_factory.mktemp("ref") / "events.jsonl")
        params, taps = _make_mlp()
        with jev.TelemetryWriter(path, console=False) as w:
            jloop.run_kfac_training(
                _mlp_loss, jkfac.Kfac(_cfg(variant), taps), params,
                _batches(9), n_tokens=N_BS, seed=0,
                obs=jspecs.ObsSpec(writer=w, metrics_every=3))
        out[variant] = [e for e in jev.read_events(path)
                        if e["type"] == "metrics"]
    return out


@pytest.mark.parametrize("variant", ["bkfac", "kfac"])
def test_flushed_values_equal_the_references(variant, reference_metrics,
                                             tmp_path):
    """Same windows, same names; counters exactly, gauges within 1e-4
    relative (kfac: EVD refreshes every 4 steps, so trunc_mass and
    inv_err gauges are compared too)."""
    path = tmp_path / "events.jsonl"
    with ev.TelemetryWriter(str(path), console=False) as w:
        ttrain(variant, writer=w, metrics_every=3)
    got = [e for e in read(path) if e["type"] == "metrics"]
    want = reference_metrics[variant]
    assert [(e["step"], e["window_steps"]) for e in got] == [
        (e["step"], e["window_steps"]) for e in want]
    for g, w in zip(got, want):
        assert g["kinds"] == w["kinds"]
        assert set(g["values"]) == set(w["values"])
        for name, v in w["values"].items():
            if w["kinds"][name] == "counter":
                assert g["values"][name] == v, name
            else:
                np.testing.assert_allclose(g["values"][name], v, rtol=1e-4,
                                           atol=1e-7, err_msg=name)


# ---------------------------------------------------------------------------
# summary CLI: the port's logs pass both packages' validators
# ---------------------------------------------------------------------------

def test_port_log_passes_both_summaries(tmp_path, capsys):
    path = str(tmp_path / "events.jsonl")
    with ev.TelemetryWriter(path, console=False) as w:
        ttrain("bkfac", writer=w, metrics_every=3, health=True,
               ckpt_dir=str(tmp_path / "ckpt"))
    assert jsum.main([path, "--validate"]) == 0
    assert tsum.main([path, "--validate"]) == 0
    assert tsum.main([path]) == 0
    report = tsum.summarize(path)
    assert report == jsum.summarize(path)
    assert report["steps"]["count"] == 9
    assert report["metrics"]["windows"] == 3
    assert report["checkpoint"] == {"saves": 2, "restores": 0}
    text = tsum.render(report)
    assert "telemetry summary" in text and "work/stats_fired" in text
    capsys.readouterr()


def test_summary_validate_fails_on_bad_log(tmp_path, capsys):
    path = tmp_path / "bad.jsonl"
    path.write_text('{"schema": 1, "t": 0.0, "type": "mystery"}\n')
    assert tsum.main([str(path), "--validate"]) == 1
    capsys.readouterr()


# ---------------------------------------------------------------------------
# the async runner's events
# ---------------------------------------------------------------------------

def test_runner_events_cover_launch_land_and_miss(tmp_path):
    """An overlapped kfac run (stagger, lag 2) logs a launch and a land
    per pipelined range, and a resumed landing logs a miss with its
    reason (reference: TestRunnerDeadline)."""
    path = str(tmp_path / "e.jsonl")
    kw = dict(async_heavy=True, heavy_lag=2, stagger=True)
    with ev.TelemetryWriter(path, console=False) as w:
        ttrain("kfac", steps=10, overlap=True, writer=w, **kw)
        opt = topt("kfac", **kw)
        runner = tloop.AsyncInverseRunner(opt, writer=w)
        sched = opt.scheduler()
        work = next(sched.work(k) for k in range(1, 12)
                    if any(sched.work(k).land))
        runner.landing(work, step=7)
        runner.close()
    evs = read(path)
    launches = [e for e in evs if e["type"] == "async_launch"]
    lands = [e for e in evs if e["type"] == "async_land"]
    misses = [e for e in evs if e["type"] == "async_miss"]
    assert launches and len(lands) >= len(launches) - 2
    assert all(isinstance(e["overlapped"], bool) for e in lands)
    assert misses and {e["reason"] for e in misses} == {"resume"}
    assert all(e["step"] == 7 for e in misses)
    assert jsum.main([path, "--validate"]) == 0


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

def test_spans_nest_by_name():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("kfac/factor/b0_evd"):
            with trace.span("stats"):
                torch.ones(3).sum()
        with trace.host_span("async/heavy/b1"):
            torch.ones(3).sum()
    names = {e.name for e in prof.events()}
    assert {"kfac/factor/b0_evd", "kfac/factor/b0_evd/stats",
            "async/heavy/b1"} <= names


def test_step_profiler_windows_and_inert_when_off(tmp_path):
    """One window a step over [first, first + steps), each a Chrome trace
    holding the optimizer's kfac/* spans; an inactive profiler does
    nothing, and profiling changes no number."""
    prof = trace.StepProfiler(str(tmp_path), first=2, steps=2)
    off = trace.StepProfiler(None)
    s_off, l_off = ttrain("kfac", steps=5)
    s_on, l_on = ttrain("kfac", steps=5,
                        callback=lambda k, s, l: (prof.tick(k + 1),
                                                  off.tick(k + 1)))
    prof.close()
    assert_identical(s_off, l_off, s_on, l_on)
    assert sorted(prof.windows) == [2, 3] and off.windows == {}
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_2.json", "step_3.json"]
    names = {e.name for e in prof.windows[3].events()}
    assert any(n.startswith("kfac/factor/b") for n in names)
    assert any(n.startswith("kfac/precond/b") for n in names)
    assert any(n.endswith("/stats") for n in names)
