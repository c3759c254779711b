"""The port's state and API surface held against the JAX package:
checkpoints (``train/checkpoint.py``: the cases of ``TestCheckpoint`` in
``tests/test_fault_tolerance.py`` and ``TestCheckpointIntegrity`` in
``tests/test_chaos.py``), the reference's leaf keys, a checkpoint written
by either package restored and trained on by the other, resume through
``run_kfac_training(state=)`` (a mid-lag async save included, after
``TestAsyncCheckpointRoundTrip``), and ``api.py`` / ``specs.py`` (the
cases of ``tests/test_api.py`` that need no tenants, serving or launch
tooling).
"""
import dataclasses
import json
import os
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core import kfac as jkfac  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import base as jbase  # noqa: E402
from repro.train import checkpoint as jck  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch import api, specs  # noqa: E402
from repro_torch.examples import quickstart as tquick  # noqa: E402
from repro_torch.train import chaos as tchaos  # noqa: E402
from repro_torch.train import checkpoint as ck  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from test_torch_obs import (CPU, N_BS, assert_identical, tbatches,  # noqa: E402,E501
                            tloss, topt, tparams, ttrain)


# ---------------------------------------------------------------------------
# checkpoint: save / restore / prune / async (TestCheckpoint)
# ---------------------------------------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 4), generator=g),
                       "b": torch.zeros((4,))},
            "opt": {"mu": torch.ones((8, 4)) * 0.5},
            "step": seed}


def _eq(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _eq(a[k], b[k])
        elif isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_save_restore_roundtrip(tmp_path):
    tree = dict(_tree(), step=7)
    ck.save(str(tmp_path), 7, tree)
    got, manifest = ck.restore(str(tmp_path), tree)
    assert manifest["step"] == 7
    _eq(got, tree)


def test_latest_pointer_and_prune(tmp_path):
    for s in (1, 2, 3, 4):
        ck.save(str(tmp_path), s, _tree())
    assert ck.latest_step(str(tmp_path)) == 4
    ck.prune(str(tmp_path), keep=2)
    assert ck.available_steps(str(tmp_path)) == [3, 4]
    assert ck.latest_step(str(tmp_path)) == 4


def test_async_checkpointer_snapshots_on_the_calling_thread(tmp_path):
    """The reference's async case, plus: a tensor changed in place right
    after ``submit`` (as the next step's ``apply_updates`` does) is saved
    with its value at the submit."""
    c = ck.AsyncCheckpointer(str(tmp_path), keep=2)
    tree = _tree()
    for s in (0, 5, 10):
        c.submit(s, dict(tree, step=s))
        with torch.no_grad():
            tree["params"]["w"].add_(1.0)
    c.close()
    assert ck.latest_step(str(tmp_path)) == 10
    assert ck.available_steps(str(tmp_path)) == [5, 10]
    got, _ = ck.restore(str(tmp_path), tree, step=5)
    assert torch.equal(got["params"]["w"], _tree()["params"]["w"] + 1.0)


def test_shape_mismatch_rejected(tmp_path):
    ck.save(str(tmp_path), 0, _tree())
    bad = _tree()
    bad["params"]["w"] = torch.zeros((9, 4))
    with pytest.raises(ValueError):
        ck.restore(str(tmp_path), bad)


def test_manifest_carries_the_references_fields(tmp_path):
    path = ck.save(str(tmp_path), 0, _tree())
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    assert man["schema"] == ck.SCHEMA_VERSION == jck.SCHEMA_VERSION == 6
    assert set(man) == {"step", "schema", "time", "n_arrays", "bytes",
                        "checksums", "extra", "tenants", "done"}
    assert man["tenants"] is None and man["done"] is True
    assert man["n_arrays"] == 4 and man["bytes"] == 4 * (32 + 4 + 32) + 4


def test_old_pytree_fails_with_actionable_schema_error(tmp_path):
    path = ck.save(str(tmp_path), 0, _tree())
    man = os.path.join(path, "manifest.json")
    with open(man) as f:
        m = json.load(f)
    del m["schema"]
    with open(man, "w") as f:
        json.dump(m, f)
    newer = dict(_tree(), inflight={"0": torch.zeros((2, 3))})
    with pytest.raises(ck.SchemaMismatchError) as ei:
        ck.restore(str(tmp_path), newer)
    msg = str(ei.value)
    assert "schema v1" in msg and f"schema v{ck.SCHEMA_VERSION}" in msg
    assert "migrate" in msg


def test_leaf_compatible_old_checkpoint_still_restores(tmp_path):
    ck.save(str(tmp_path), 3, _tree())
    got, _ = ck.restore(str(tmp_path), dict(_tree(), inflight={}))
    assert got["inflight"] == {}


# ---------------------------------------------------------------------------
# checkpoint integrity (TestCheckpointIntegrity)
# ---------------------------------------------------------------------------

def test_manifest_records_a_checksum_per_array(tmp_path):
    path = ck.save(str(tmp_path), 0, _tree())
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    assert len(man["checksums"]) == man["n_arrays"] > 0
    assert all(len(d) == 8 for d in man["checksums"].values())
    with np.load(os.path.join(path, "arrays.npz")) as z:
        assert man["checksums"] == {k: jck._digest(z[k]) for k in z.files}


def test_truncated_archive_raises_corruption_error(tmp_path):
    ck.save(str(tmp_path), 3, _tree())
    assert tchaos.truncate_latest(str(tmp_path))
    with pytest.raises(ck.CheckpointCorruptionError,
                       match="truncated or unreadable"):
        ck.restore(str(tmp_path), _tree())


def test_silent_bitflip_caught_by_checksum(tmp_path):
    path = ck.save(str(tmp_path), 0, _tree())
    npz = os.path.join(path, "arrays.npz")
    with np.load(npz) as z:
        arrays = {k: np.array(z[k]) for k in z.files}
    key = next(k for k, v in arrays.items() if v.size > 1)
    arrays[key].flat[0] += 1.0
    np.savez(npz, **arrays)
    with pytest.raises(ck.CheckpointCorruptionError,
                       match="failed integrity check"):
        ck.restore(str(tmp_path), _tree())


def test_pre_checksum_checkpoint_restores_unverified(tmp_path):
    path = ck.save(str(tmp_path), 0, _tree())
    man_path = os.path.join(path, "manifest.json")
    with open(man_path) as f:
        man = json.load(f)
    del man["checksums"]
    man["schema"] = 4
    with open(man_path, "w") as f:
        json.dump(man, f)
    got, _ = ck.restore(str(tmp_path), _tree())
    assert torch.equal(got["params"]["w"], _tree()["params"]["w"])


def test_restore_latest_healthy_walks_past_corruption(tmp_path):
    for s in (1, 2, 3):
        ck.save(str(tmp_path), s, _tree(s))
    assert tchaos.truncate_latest(str(tmp_path))          # step 3 torn
    got, man = ck.restore_latest_healthy(str(tmp_path), _tree())
    assert man["step"] == 2 and got["step"] == 2
    assert [s["step"] for s in man["skipped_corrupt"]] == [3]
    assert "CheckpointCorruptionError" in man["skipped_corrupt"][0]["error"]


def test_restore_latest_healthy_exhausted_is_actionable(tmp_path):
    ck.save(str(tmp_path), 1, _tree())
    tchaos.truncate_latest(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no healthy"):
        ck.restore_latest_healthy(str(tmp_path), _tree())


# ---------------------------------------------------------------------------
# the reference's leaf keys, and checkpoints across the two packages
# ---------------------------------------------------------------------------

def _quick_reference():
    """The quickstart MLP of ``test_torch_baselines`` in the reference:
    loss, B-KFAC optimizer (momentum 0.9, so its buffers ride along),
    initial parameters and six batches."""
    D = tquick

    def jloss(params, probes, batch):
        x, y = batch
        acts = {}
        h, acts["fc0"] = jlayers.tapped_matmul(params["fc0"]["w"], x,
                                               probes.get("fc0"), D.N_STAT)
        h = jax.nn.relu(h)
        out, acts["fc1"] = jlayers.tapped_matmul(params["fc1"]["w"], h,
                                                 probes.get("fc1"), D.N_STAT)
        return jnp.mean((out - y) ** 2), acts

    taps = {"fc0": jkfac.TapInfo("fc0/w", D.D_IN, D.D_H, n_stat=D.N_STAT),
            "fc1": jkfac.TapInfo("fc1/w", D.D_H, D.D_OUT, n_stat=D.N_STAT)}
    cfg = jkfac.KfacConfig(
        policy=jpolicy.PolicyConfig(variant="bkfac", r=32),
        lr=jbase.constant(0.05), damping_phi=jbase.constant(0.1),
        clip=1.0, momentum=0.9, T_updt=1, T_brand=1)
    key = jax.random.PRNGKey(0)
    W_true = jax.random.normal(key, (D.D_IN, D.D_OUT))
    batches = []
    for i in range(6):
        x = jax.random.normal(jax.random.fold_in(key, i), (D.BATCH, D.D_IN))
        batches.append((x, jnp.tanh(x @ W_true)))
    k0, k1 = jax.random.split(jax.random.PRNGKey(1))
    params = {"fc0": {"w": jlayers.dense_init(k0, D.D_IN, D.D_H)},
              "fc1": {"w": jlayers.dense_init(k1, D.D_H, D.D_OUT)}}
    return jloss, jkfac.Kfac(cfg, taps), params, batches


def _tquick_opt():
    from repro_torch.core import kfac as tkfac
    from repro_torch.core import policy as tpolicy
    from repro_torch.optim import base as tb
    cfg = tkfac.KfacConfig(
        policy=tpolicy.PolicyConfig(variant="bkfac", r=32),
        lr=tb.constant(0.05), damping_phi=tb.constant(0.1), clip=1.0,
        momentum=0.9, T_updt=1, T_brand=1)
    return tkfac.Kfac(cfg, tquick.TAPS, device=CPU)


def _tp(jparams, grad=True):
    return {f"{n}/w": torch.from_numpy(np.array(p["w"], np.float32))
            .requires_grad_(grad) for n, p in jparams.items()}


def _tb(batches):
    return [(torch.from_numpy(np.array(x, np.float32)),
             torch.from_numpy(np.array(y, np.float32))) for x, y in batches]


def test_leaf_keys_are_the_references():
    """A TrainState's keys in the port's checkpoint are the reference's
    for the same model and optimizer, but for the two package-only
    leaves (``rng``) and the fallback moments of tapped weights, which
    the port does not keep."""
    _, jopt, jparams, _ = _quick_reference()
    jstate = jloop.TrainState(params=jparams, opt=jopt.init(jparams),
                              rng=jax.random.PRNGKey(0))
    params = _tp(jparams)
    tstate = tloop.TrainState(params=params,
                              opt=_tquick_opt().init(params),
                              rng=torch.Generator().manual_seed(0))
    jkeys = {k: v.shape for k, v in jck._flatten(jstate).items()}
    tkeys = {k: v.shape for k, v in ck._flatten(tstate).items()}
    tapped = {"opt|fallback|mu|fc0|w", "opt|fallback|mu|fc1|w",
              "opt|fallback|nu|fc0|w", "opt|fallback|nu|fc1|w"}
    assert set(jkeys) - set(tkeys) == tapped
    assert set(tkeys) - set(jkeys) == set()
    assert all(tkeys[k] == jkeys[k] for k in tkeys if k != "rng")
    assert ck._flatten(tstate)["opt|step"].dtype == np.int32


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_restores_across_packages(writer, tmp_path):
    """Three B-KFAC steps of the quickstart MLP in the writing package, a
    checkpoint through its ``save``, then both packages restore it
    through a ``{"params", "opt"}`` template and take three more steps:
    the two continuations agree to the trajectory tolerance of
    test_torch_kfac.py (2e-3 of each tensor's scale)."""
    jloss, jopt, jparams, batches = _quick_reference()
    d = str(tmp_path)
    if writer == "reference":
        jst, _ = jloop.run_kfac_training(jloss, jopt, jparams, batches[:3],
                                         n_tokens=tquick.BATCH)
        jck.save(d, 3, jst)
    else:
        tst, _ = tloop.run_kfac_training(
            tquick.loss_fn, _tquick_opt(), _tp(jparams), _tb(batches[:3]),
            n_tokens=tquick.BATCH, device=CPU)
        ck.save(d, 3, tst)
    # the port restores through its own template
    topt = _tquick_opt()
    t_tmpl = {"params": _tp(jparams), "opt": topt.init(_tp(jparams))}
    got, _ = ck.restore(d, t_tmpl)
    assert got["opt"].step == 3 and got["opt"].n_stats == 3
    tstate = tloop.TrainState(params=got["params"], opt=got["opt"],
                              rng=torch.Generator().manual_seed(0))
    tst, tl = tloop.run_kfac_training(tquick.loss_fn, topt, None,
                                      _tb(batches[3:]), n_tokens=tquick.BATCH,
                                      device=CPU, state=tstate)
    # the reference restores through its own template, its fallback
    # moments restricted to the untapped parameters (none here) — the
    # moments of tapped weights are never read, so they restart at zero
    full = jopt.init(jparams)
    j_tmpl = {"params": jparams, "opt": full._replace(
        fallback=jadamw.AdamWState(step=full.fallback.step, mu={}, nu={}))}
    jgot, _ = jck.restore(d, j_tmpl)
    jstate = jloop.TrainState(
        params=jgot["params"],
        opt=jgot["opt"]._replace(fallback=full.fallback._replace(
            step=jgot["opt"].fallback.step)),
        rng=jax.random.PRNGKey(0))
    assert int(jstate.opt.step) == 3
    jst, jl = jloop.run_kfac_training(jloss, jopt, None, batches[3:],
                                      n_tokens=tquick.BATCH, state=jstate)
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    for n, p in _np(jst.params).items():
        want = np.asarray(p["w"], np.float64)
        got_p = tst.params[f"{n}/w"].detach().numpy().astype(np.float64)
        assert np.abs(got_p - want).max() <= 2e-3 * np.abs(want).max(), n


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_sgd_state_restores_across_packages(writer, tmp_path):
    """An SGD state, whose momentum is keyed by parameter path, keeps the
    reference's nested keys (``opt|momentum|fc0|w``), and a checkpoint of
    it written by either package restores bit for bit in the other."""
    from repro.optim import sgd as jsgd
    from repro_torch.optim import sgd as tsgd
    _, _, jparams, _ = _quick_reference()
    rng = np.random.default_rng(0)
    jmom = {n: {"w": jnp.asarray(rng.standard_normal(p["w"].shape),
                                 jnp.float32)} for n, p in jparams.items()}
    jtree = {"params": jparams, "opt": jsgd.SgdState(
        step=jnp.asarray(5, jnp.int32), momentum=jmom)}
    ttree = {"params": _tp(jparams, grad=False), "opt": tsgd.SgdState(
        step=5, momentum=_tp(jmom, grad=False))}
    assert set(ck._flatten(ttree)) == set(jck._flatten(jtree))
    assert "opt|momentum|fc0|w" in ck._flatten(ttree)
    d = str(tmp_path)
    if writer == "reference":
        jck.save(d, 5, jtree)
    else:
        ck.save(d, 5, ttree)
    zero = tsgd.Sgd(lr=None).init(_tp(jparams, grad=False))
    got, _ = ck.restore(d, {"params": _tp(jparams, grad=False),
                            "opt": dataclasses.replace(zero, step=0)})
    assert got["opt"].step == 5
    for k, v in ttree["opt"].momentum.items():
        assert torch.equal(got["opt"].momentum[k], v), k
    jzero = jax.tree_util.tree_map(jnp.zeros_like, jtree)
    jgot, _ = jck.restore(d, jzero)
    assert int(jgot["opt"].step) == 5
    for n, m in jmom.items():
        np.testing.assert_array_equal(np.asarray(jgot["opt"].momentum[n]["w"]),
                                      np.asarray(m["w"]))


# ---------------------------------------------------------------------------
# resume through run_kfac_training(state=)
# ---------------------------------------------------------------------------

def _fresh_state(opt):
    params = tparams()
    return tloop.TrainState(params=params, opt=opt.init(params),
                            rng=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("variant,kw", [
    ("brkfac", dict(T_rsvd=2)),
    ("kfac", dict(T_inv=4, stagger=True, stagger_splits=2,
                  async_heavy=True, heavy_lag=2)),
])
def test_save_restore_resume_equals_uninterrupted(variant, kw, tmp_path):
    """Stop after step 3, save, restore into a fresh template and finish:
    bit for bit the uninterrupted 8 steps — for B-R-KFAC the generator's
    state carries the RSVD draws across; for async kfac (TestAsync-
    CheckpointRoundTrip) the launch of step 2 is in flight at the save
    and lands at step 4 from the restored snapshot."""
    batches = tbatches(8)
    ref_state, ref_losses = ttrain(variant, batches=batches, **kw)
    opt = topt(variant, **kw)
    if opt._async_buckets:
        sched = opt.scheduler()
        assert any(sched.work(2).launch) and any(sched.work(4).land)
    mid, head = ttrain(variant, batches=batches[:3], **kw)
    if opt._async_buckets:
        assert any(bool(b.live.any()) for b in mid.opt.inflight.values())
    ck.save(str(tmp_path), 3, mid)
    restored, man = ck.restore(str(tmp_path), _fresh_state(opt))
    assert man["schema"] == ck.SCHEMA_VERSION
    end, tail = tloop.run_kfac_training(tloss, opt, None, batches[3:],
                                        n_tokens=N_BS, device=CPU,
                                        state=restored)
    assert head + tail == ref_losses
    for k in end.params:
        assert torch.equal(end.params[k], ref_state.params[k]), k


def test_mid_lag_restore_with_overlap_runner(tmp_path):
    """Resuming with the overlapped runner: the landing whose launch
    predates the restore misses ("resume") and lands in line from the
    restored snapshot — the same numbers (rtol 1e-6, the reference's)."""
    kw = dict(T_inv=4, stagger=True, stagger_splits=2, async_heavy=True,
              heavy_lag=2)
    batches = tbatches(8)
    _, ref_losses = ttrain("kfac", batches=batches, **kw)
    mid, head = ttrain("kfac", batches=batches[:3], **kw)
    ck.save(str(tmp_path), 3, mid)
    opt = topt("kfac", **kw)
    restored, _ = ck.restore(str(tmp_path), _fresh_state(opt))
    runner = tloop.AsyncInverseRunner.for_opt(opt)
    _, tail = tloop.run_kfac_training(tloss, opt, None, batches[3:],
                                      n_tokens=N_BS, device=CPU,
                                      state=restored, overlap=runner)
    np.testing.assert_allclose(head + tail, ref_losses, rtol=1e-6)
    assert runner.health["miss_reasons"].get("resume", 0) >= 1


# ---------------------------------------------------------------------------
# api.py and specs.py (tests/test_api.py)
# ---------------------------------------------------------------------------

def test_api_all_plus_not_yet_ported_is_the_references():
    assert set(api.__all__) | set(api.NOT_YET_PORTED) == set(japi.__all__)
    assert not set(api.__all__) & set(api.NOT_YET_PORTED)
    assert api.NOT_YET_PORTED == ()
    for name in api.__all__:
        assert getattr(api, name) is not None, name


def test_legacy_kwargs_equal_specs_and_warn(tmp_path):
    specs._WARNED.clear()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        s_old, l_old = tloop.run_kfac_training(
            tloss, topt("bkfac"), tparams(), tbatches(4), n_tokens=N_BS,
            device=CPU, ckpt_dir=str(tmp_path / "old"), ckpt_every=2,
            ckpt_keep=2)
    dep = [x for x in w if issubclass(x.category, DeprecationWarning)]
    assert dep and "CkptSpec" in str(dep[0].message)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        s_new, l_new = tloop.run_kfac_training(
            tloss, topt("bkfac"), tparams(), tbatches(4), n_tokens=N_BS,
            device=CPU,
            ckpt=specs.CkptSpec(dir=str(tmp_path / "new"), every=2, keep=2))
    assert not [x for x in w if issubclass(x.category, DeprecationWarning)]
    assert_identical(s_old, l_old, s_new, l_new)
    assert ck.available_steps(str(tmp_path / "old")) == [0, 2] == \
        ck.available_steps(str(tmp_path / "new"))


def test_legacy_kwarg_warns_once_per_process():
    specs._WARNED.clear()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for _ in range(3):
            specs.warn_once("k", "msg")
    assert len(w) == 1


@pytest.mark.parametrize("kw,err,match", [
    (dict(ckpt=specs.CkptSpec(dir="x"), ckpt_dir="y"), ValueError,
     "conflicts"),
    (dict(no_such_option=1), TypeError, "unexpected keyword"),
    (dict(dist=specs.DistSpec(mesh=types.SimpleNamespace(
        axis_names=("data",), devices=np.zeros(2)), curvature_axis="curv")),
     ValueError, "no axis 'curv'"),
])
def test_bad_training_options_raise(kw, err, match):
    with pytest.raises(err, match=match):
        tloop.run_kfac_training(tloss, topt("bkfac"), tparams(),
                                tbatches(1), n_tokens=N_BS, device=CPU, **kw)


def test_flags_shim_warns_and_delegates():
    opt = topt("bkfac", T_inv=2)
    specs._WARNED.clear()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        flags = opt.cfg.flags(0)
    assert any(issubclass(x.category, DeprecationWarning) for x in w)
    assert flags == {"do_stats": True, "do_light": True, "do_heavy": False}
    for variant in ("kfac", "brkfac", "bkfacc", "nskfac"):
        cfg = topt(variant).cfg
        jc = jkfac.KfacConfig(policy=jpolicy.PolicyConfig(variant=variant),
                              T_updt=1, T_inv=4, T_brand=1, T_rsvd=4,
                              T_corct=4)
        for k in range(9):
            assert topt(variant).scheduler().flags(k) == \
                jc.flags(k) == cfg.flags(k), (variant, k)


def test_make_kfac_step_shim_matches_scheduled():
    opt = topt("bkfac", T_inv=2)
    batch = tbatches(1)[0]
    specs._WARNED.clear()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        legacy = tloop.make_kfac_step(tloss, opt, n_tokens=N_BS)
    assert any(issubclass(x.category, DeprecationWarning) for x in w)
    scheduled = tloop.make_scheduled_kfac_step(tloss, opt, n_tokens=N_BS)
    s_old, loss_old = legacy(_fresh_state(opt), batch, True, True, False)
    s_new, loss_new = scheduled(_fresh_state(opt), batch,
                                opt.uniform_work(True, True, False))
    assert torch.equal(loss_old, loss_new)
    for k in s_old.params:
        assert torch.equal(s_old.params[k], s_new.params[k]), k


def test_group_by_work_and_remedial_work_equal_the_references():
    from repro.core import schedule as jsched
    from repro_torch.core import schedule as tsched
    from test_obs import _cfg, _make_mlp
    for variant in ("kfac", "bkfac", "brkfac"):
        kw = dict(stagger=True, stagger_splits=2)
        opt = topt(variant, **kw)
        jopt = jkfac.Kfac(_cfg(variant, **kw), _make_mlp()[1])
        steps = [0, 1, 2, 3, 4, 5, 4, 0]
        tg = tsched.group_by_work(opt.scheduler(), steps)
        jg = jsched.group_by_work(jopt.scheduler(), steps)
        assert sorted(tg.values()) == sorted(jg.values())
        assert opt.remedial_work() == tsched.StepWork(**{
            f: getattr(jopt.remedial_work(), f)
            for f in ("stats", "light", "heavy", "launch", "land")})
