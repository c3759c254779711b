"""The port's serving stack (``repro_torch/serve/``, per-lane
``decode_step``) against the reference's, on gemma3's reduced config.

  * The port's ``Engine`` emits the reference ``Engine``'s greedy tokens
    for a request admitted mid-decode (staggered) and for one admitted
    into a drained slot (tests/test_serve.py's two cases); a refilled
    lane starts from a zero cache (recurrent states included).
  * A (B,)-position ``decode_step`` equals B one-row calls at each row's
    position, for every architecture the engine serves by itself (all
    but whisper, whose decoder needs its encoder's cross cache).
  * A 2-tenant ``TenantService`` over two fine-tune ticks and two
    requests reaches the reference service's losses, steps, tokens and
    parameters; tenant 1 stays bitwise untouched while only tenant 0
    trains.
  * Checkpoints restore across packages both ways, each tenant's step
    re-seated from the v6 ``tenants`` table; a manifest without the table
    stays compatible.
  * ``serve/load.py`` on the CPU writes events that validate (against
    both packages' schemas) and a ``latency.json`` with the expected
    counts.

The reference runs happen once, in module fixtures.  The port takes the
reference's weights through ``convert.params_from_jax`` and the same
numpy traffic.
"""
import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.base import ARCH_NAMES, get_arch  # noqa: E402
from repro.models.lm import LM as JLM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve import load as jload  # noqa: E402
from repro.serve import service as jservice  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.configs import base as tconfigs  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import kfac as tkfac  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.serve import load as tload  # noqa: E402
from repro_torch.serve import service as tservice  # noqa: E402
from repro_torch.train import checkpoint as tck  # noqa: E402

CPU = torch.device("cpu")
MAX_LEN = 32
#: the parameters' change over two fine-tune steps, held to this much of
#: the reference's change (test_torch_lm_parts.py's TRAJ: a
#: step moves a weight ~1e-4 of its scale, so the parameters themselves
#: would agree to fp32 rounding whatever the update)
CHANGE_REL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def ra():
    return dict(uid=0, prompt=[3, 1, 4, 1, 5], max_new=6)


def rb():
    return dict(uid=1, prompt=[2, 7], max_new=6)


def r_first():
    return dict(uid=0, prompt=[9, 9, 9, 9, 9, 9], max_new=4)


def r_second():
    return dict(uid=1, prompt=[5, 3], max_new=5)


def serve_one(mod, lm, params, req, **kw):
    eng = mod.Engine(lm, params, **kw)
    eng.submit(mod.Request(**req))
    eng.run_until_drained()
    return eng.completed[req["uid"]].out_tokens


@pytest.fixture(scope="module")
def reference_engine():
    """The reference's tokens for each request served alone (its own test
    asserts the staggered and slot-reuse runs emit them), and its
    weights."""
    arch = get_arch("gemma3_4b").reduced()
    lm = JLM(arch, remat=False)
    params = lm.init(jax.random.PRNGKey(0))
    out = {"a": serve_one(jengine, lm, params, ra(), batch_slots=2,
                          max_len=MAX_LEN),
           "b": serve_one(jengine, lm, params, rb(), batch_slots=2,
                          max_len=MAX_LEN),
           "second": serve_one(jengine, lm, params, r_second(),
                               batch_slots=1, max_len=MAX_LEN)}
    return arch, _np(params), out


def port_lm(arch, jparams):
    tarch = tconfigs.get_arch(arch.name).reduced()
    return TLM(tarch, remat=False, device=CPU), params_from_jax(jparams,
                                                               device=CPU)


def test_engine_staggered_requests_match_reference(reference_engine):
    """Request B admitted while A is 4 positions in: each emits the
    reference's tokens for it alone, and so does each served alone."""
    arch, jparams, want = reference_engine
    lm, params = port_lm(arch, jparams)
    assert serve_one(tengine, lm, params, ra(), batch_slots=2,
                     max_len=MAX_LEN) == want["a"]
    eng = tengine.Engine(lm, params, batch_slots=2, max_len=MAX_LEN)
    eng.submit(tengine.Request(**ra()))
    for _ in range(4):
        eng.step()
    eng.submit(tengine.Request(**rb()))
    eng.run_until_drained()
    assert eng.completed[0].out_tokens == want["a"]
    assert eng.completed[1].out_tokens == want["b"]


def test_engine_slot_reuse_matches_reference(reference_engine):
    """A request admitted into the slot its predecessor drained decodes
    as the reference's does alone."""
    arch, jparams, want = reference_engine
    lm, params = port_lm(arch, jparams)
    eng = tengine.Engine(lm, params, batch_slots=1, max_len=MAX_LEN)
    eng.submit(tengine.Request(**r_first()))
    eng.run_until_drained()
    eng.submit(tengine.Request(**r_second()))
    eng.run_until_drained()
    assert eng.completed[1].out_tokens == want["second"]
    rep = eng.latency_report()
    assert rep["requests"] == 2 and rep["p50_s"] <= rep["p99_s"]


@pytest.mark.parametrize("name", ["mamba2_2p7b", "recurrentgemma_2b"])
def test_engine_refilled_lane_starts_from_a_zero_state(name):
    """A lane's cache rows are zeroed when a request is admitted into it:
    a recurrent state, which no position mask hides, would otherwise
    carry its predecessor's (the reference's engine keeps it), and the
    request would not emit the tokens it emits alone."""
    arch = tconfigs.get_arch(name).reduced()
    lm = TLM(arch, remat=False, device=CPU)
    params = {k: v.detach() for k, v in
              lm.init(torch.Generator().manual_seed(0)).items()}
    alone = serve_one(tengine, lm, params, r_second(), batch_slots=1,
                      max_len=MAX_LEN)
    eng = tengine.Engine(lm, params, batch_slots=1, max_len=MAX_LEN)
    eng.submit(tengine.Request(**r_first()))
    eng.run_until_drained()
    eng.submit(tengine.Request(**r_second()))
    eng.run_until_drained()
    assert eng.completed[1].out_tokens == alone


SERVED = [n for n in ARCH_NAMES if not get_arch(n).is_encdec]


@pytest.mark.parametrize("name", SERVED)
def test_decode_step_per_row_positions_match_single_rows(name):
    """Three rows that start 0, 3 and 7 ticks apart, decoded together
    with a (3,) position tensor, against each row decoded alone with a
    host int: equal to 1e-5 of the logits' scale (a batch of three sums
    its products in another order than a batch of one)."""
    arch = tconfigs.get_arch(name).reduced()
    lm = TLM(arch, remat=False, device=CPU)
    params = {k: v.detach() for k, v in
              lm.init(torch.Generator().manual_seed(0)).items()}
    rows, S, starts = 3, 24, (0, 3, 7)
    toks = torch.randint(0, arch.vocab, (rows, S),
                         generator=torch.Generator().manual_seed(1))
    cache = lm.init_cache(rows, S)
    alone = [lm.init_cache(1, S) for _ in range(rows)]
    for tick in range(12):
        pos = torch.tensor([max(0, tick - s) for s in starts])
        tok = toks[torch.arange(rows), pos][:, None]
        got, _ = lm.decode_step(params, cache, tok, pos)
        for b in range(rows):
            want, _ = lm.decode_step(params, alone[b], tok[b:b + 1],
                                     int(pos[b]))
            scale = float(want.abs().max())
            assert float((got[b] - want[0]).abs().max()) <= 1e-5 * scale


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------

FT_B, FT_T = 2, 16


def traffic(vocab):
    """Two fine-tune batches for each of two tenants and one greedy
    request each, from numpy."""
    rng = np.random.default_rng(0)
    out = []
    for k in range(2):
        for t in range(2):
            out.append(("ft", 10 * k + t, t, {
                "tokens": rng.integers(0, vocab, (FT_B, FT_T)).astype(
                    np.int32),
                "targets": rng.integers(0, vocab, (FT_B, FT_T)).astype(
                    np.int32)}))
    out += [("infer", 100, 0, [3, 1, 4]), ("infer", 101, 1, [2, 7])]
    return out


def submit(svc, mod_engine, mod_service, reqs):
    for kind, uid, t, x in reqs:
        if kind == "ft":
            svc.submit(mod_service.FinetuneRequest(uid=uid, tenant=t,
                                                   batch=x))
        else:
            svc.submit(mod_engine.Request(uid=uid, prompt=x, max_new=3,
                                          tenant=t))


def results(svc):
    return ({u: r.loss for u, r in svc.completed_ft.items()},
            {u: r.out_tokens for u, r in svc.engine.completed.items()},
            list(svc.steps))


@pytest.fixture(scope="module")
def reference_service(tmp_path_factory):
    """The reference's 2-tenant service (load.build_service, max_len 32)
    through the traffic, then its checkpoint → dict."""
    d = str(tmp_path_factory.mktemp("ref_ckpt"))
    svc, arch = jload.build_service(tenants=2, max_len=MAX_LEN, ckpt_dir=d)
    p0 = _np(svc.params)
    submit(svc, jengine, jservice, traffic(arch.vocab))
    svc.run_until_drained()
    svc.save_checkpoint()
    return {"svc": svc, "arch": arch, "p0": p0, "params": _np(svc.params),
            "results": results(svc), "ckpt": d}


def port_service(arch, base, ckpt_dir=None):
    """The port's service over ``arch``'s reduced config from ``base``
    weights, at build_service's settings."""
    tarch = tconfigs.get_arch(arch.name).reduced()
    lm = TLM(tarch, remat=False, device=CPU)
    opt = tkfac.Kfac(tload.finetune_kfac_config(tarch, "bkfac"), lm.taps,
                     device=CPU)
    return tservice.TenantService(lm, opt, base, 2, max_len=MAX_LEN,
                                  ckpt_dir=ckpt_dir)


def base_of(ref):
    return params_from_jax(jax.tree_util.tree_map(lambda x: x[0], ref["p0"]),
                           device=CPU)


def test_service_matches_reference(reference_service):
    ref = reference_service
    svc = port_service(ref["arch"], base_of(ref))
    submit(svc, tengine, tservice, traffic(ref["arch"].vocab))
    svc.run_until_drained()
    losses, tokens, steps = results(svc)
    want_losses, want_tokens, want_steps = ref["results"]
    assert steps == want_steps == [2, 2]
    assert tokens == want_tokens
    assert set(losses) == set(want_losses)
    for u in losses:
        assert abs(losses[u] - want_losses[u]) <= 1e-5 * abs(want_losses[u])
    p0 = params_from_jax(ref["p0"], device=CPU)
    want = params_from_jax(ref["params"], device=CPU)
    for k, w in want.items():
        d_ref = (w - p0[k]).double()
        d_port = (svc.params[k] - p0[k]).double()
        scale = float(d_ref.abs().max())
        assert scale > 0, k
        assert float((d_port - d_ref).abs().max()) <= CHANGE_REL * scale, k
    rep = svc.latency_report()
    assert rep["infer"]["requests"] == 2
    assert rep["finetune"]["requests"] == 4
    assert rep["tenants"] == {"0": 3, "1": 3}


def test_service_tenant_isolation_and_restore(reference_service, tmp_path):
    """Fine-tuning tenant 0 alone leaves tenant 1's weights bitwise as
    they were; a restored service re-seats the per-tenant steps from the
    v6 table and the weights bit for bit."""
    ref = reference_service
    d = str(tmp_path / "ckpt")
    svc = port_service(ref["arch"], base_of(ref), ckpt_dir=d)
    before = {k: v.clone() for k, v in svc.params.items()}
    rng = np.random.default_rng(0)
    vocab = ref["arch"].vocab
    batch = {"tokens": rng.integers(0, vocab, (FT_B, FT_T)).astype(np.int32),
             "targets": rng.integers(0, vocab, (FT_B, FT_T)).astype(
                 np.int32)}
    for k in range(3):
        svc.submit(tservice.FinetuneRequest(uid=k, tenant=0, batch=batch))
    svc.run_until_drained()
    assert any(not torch.equal(svc.params[k][0], before[k][0])
               for k in before)
    for k in before:
        assert torch.equal(svc.params[k][1], before[k][1]), k
    assert svc.steps == [3, 0]
    assert svc.state.step.tolist() == [3, 0]
    svc.save_checkpoint()
    fresh = port_service(ref["arch"], base_of(ref), ckpt_dir=d)
    manifest = fresh.restore()
    assert fresh.steps == [3, 0]
    assert manifest["tenants"][0]["step"] == 3
    for k, v in svc.params.items():
        assert torch.equal(fresh.params[k], v), k
    with pytest.raises(ValueError):
        bad = {k: v[:, :4] for k, v in batch.items()}
        svc.submit(tservice.FinetuneRequest(uid=9, tenant=1, batch=bad))
        svc.tick()


def test_reference_checkpoint_restores_into_port(reference_service):
    """The reference service's snapshot (stacked params, stacked state
    with (N,) step arrays, the v6 table) restored by the port's service:
    the reference's weights and per-tenant counters, steps re-seated."""
    ref = reference_service
    svc = port_service(ref["arch"], base_of(ref))
    manifest = svc.restore(ref["ckpt"])
    assert [r["step"] for r in manifest["tenants"]] == [2, 2]
    assert svc.steps == [2, 2]
    assert svc.state.step.tolist() == svc.state.n_stats.tolist() == [2, 2]
    for k, w in params_from_jax(ref["params"], device=CPU).items():
        assert torch.equal(svc.params[k], w), k
    jst = ref["svc"].state
    name = sorted(svc.opt.taps)[0]
    np.testing.assert_array_equal(svc.state.factors[name].A.D.numpy(),
                                  np.asarray(jst.factors[name].A.D))


def _untapped(tree, tapped, prefix=""):
    """The nested reference tree without the tapped parameters' leaves."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out[k] = _untapped(v, tapped, path + "/")
        elif path not in tapped:
            out[k] = v
    return out


def test_port_checkpoint_restores_into_reference(reference_service,
                                                 tmp_path):
    """The port's snapshot restored by a reference TenantService whose
    fallback template covers the untapped parameters, the moments the
    port keeps (train/checkpoint.py): the port's weights and steps."""
    ref = reference_service
    d = str(tmp_path / "ckpt")
    svc = port_service(ref["arch"], base_of(ref), ckpt_dir=d)
    submit(svc, tengine, tservice, traffic(ref["arch"].vocab)[:3])
    svc.run_until_drained()
    assert svc.steps == [2, 1]
    svc.save_checkpoint()
    jsvc0 = ref["svc"]
    jsvc = jservice.TenantService(
        jsvc0.lm, jsvc0.opt, jax.tree_util.tree_map(lambda x: x[0],
                                                    jsvc0.params), 2,
        max_len=MAX_LEN, ckpt_dir=d)
    tapped = {t.param_path for t in jsvc.opt.taps.values()}
    fb = jsvc.state.fallback
    jsvc.state = jsvc.state._replace(fallback=jadamw.AdamWState(
        step=fb.step, mu=_untapped(fb.mu, tapped),
        nu=_untapped(fb.nu, tapped)))
    manifest = jsvc.restore()
    assert jsvc.steps == [2, 1] and manifest["tenants"][1]["step"] == 1
    np.testing.assert_array_equal(np.asarray(jsvc.state.step), [2, 1])
    for k, w in params_from_jax(_np(jsvc.params), device=CPU).items():
        assert torch.equal(svc.params[k], w), k


def test_ckpt_v6_tenant_table_roundtrip(tmp_path):
    tree = {"w": torch.arange(6.0).reshape(2, 3)}
    table = [{"tenant": 0, "slot": 0, "step": 7},
             {"tenant": 1, "slot": 1, "step": 3}]
    tck.save(str(tmp_path), 5, tree, tenants=table)
    out, manifest = tck.restore(str(tmp_path), tree)
    assert manifest["schema"] == tck.SCHEMA_VERSION == 6
    assert manifest["tenants"] == table
    assert torch.equal(out["w"], tree["w"])


def test_ckpt_without_tenants_stays_compatible(tmp_path):
    """A single-tenant save (and a pre-v6 manifest, which lacks the key)
    reads back with no tenants table."""
    tree = {"w": torch.ones(2)}
    tck.save(str(tmp_path), 1, tree)
    _, manifest = tck.restore(str(tmp_path), tree)
    assert manifest.get("tenants") is None
    man_path = glob.glob(str(tmp_path / "step_*/manifest.json"))[0]
    with open(man_path) as f:
        man = json.load(f)
    del man["tenants"]
    man["schema"] = 5
    with open(man_path, "w") as f:
        json.dump(man, f)
    _, manifest = tck.restore(str(tmp_path), tree)
    assert manifest.get("tenants") is None


# ---------------------------------------------------------------------------
# the load generator, the API
# ---------------------------------------------------------------------------

def test_run_load_writes_valid_events_and_latency(tmp_path):
    from repro.obs import events as jevents
    from repro_torch.obs import events as tevents
    d = str(tmp_path / "telem")
    report = tload.main(["--device", "cpu", "--tenants", "3", "--waves",
                         "2", "--infer-per-wave", "2", "--ft-per-wave", "3",
                         "--ticks-between", "2", "--telemetry-dir", d,
                         "--ckpt-every", "4"])
    events = os.path.join(d, "events.jsonl")
    evs = list(tevents.read_events(events))
    assert list(jevents.read_events(events)) == evs
    kinds = {e["type"] for e in evs}
    assert {"tenant_update", "serve_request", "ckpt_save"} <= kinds
    assert all("tenant" in e for e in evs if e["type"] == "serve_request")
    with open(os.path.join(d, "latency.json")) as f:
        lat = json.load(f)
    assert lat == json.loads(json.dumps(report))
    assert lat["infer"]["requests"] == 4
    assert lat["finetune"]["requests"] == 6
    assert sum(lat["steps"]) == 6 and lat["ticks"] < 200


def test_api_exports_the_serving_surface():
    for name in ("TenantBank", "tree_stack", "tree_unstack",
                 "TenantService", "FinetuneRequest", "Engine", "Request",
                 "default_kfac_config"):
        assert name in api.__all__ and hasattr(api, name)
    assert api.NOT_YET_PORTED == ()
