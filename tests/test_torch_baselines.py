"""The port's baseline optimizers and quickstart held against the JAX
package on the same numpy inputs: SENG's Woodbury solve and its update
sequence (``tests/test_seng.py``), SGD with and without nesterov and
weight decay, ``make_baseline_step`` (SGD and AdamW on the MLP of
``tests/test_kfac_optimizer.py``), and the quickstart MLP's 50-step B-KFAC
loss trajectory (``examples/quickstart.py``) from the reference's initial
weights and batches.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import kfac as jkfac  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import base as jbase  # noqa: E402
from repro.optim import seng as jseng  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import kfac as tkfac  # noqa: E402
from repro_torch.examples import quickstart as tquick  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import base as tbase  # noqa: E402
from repro_torch.optim import seng as tseng  # noqa: E402
from repro_torch.optim import sgd as tsgd  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from synthdata import tap_data  # noqa: E402
from test_kfac_optimizer import (D_H, D_IN, D_OUT, N_BS, N_STAT,  # noqa: E402
                                 init_mlp, make_batches, make_mlp_taps,
                                 mlp_loss)

CPU = torch.device("cpu")


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _flat(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                           device=CPU)


def _close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# SENG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stack", [(), (3,)])
def test_woodbury_matches_reference_and_dense(stack):
    """_precondition against the reference's (vmapped over the stack) and
    against the dense solve (λI + (1/n)VVᵀ)⁻¹ vec(J) — the reference's
    tolerance, rtol 1e-4 / atol 1e-5."""
    d_in, d_out, n, lam = 6, 5, 4, 0.7
    rng = np.random.default_rng(0)
    A = rng.standard_normal(stack + (d_in, n)).astype(np.float32)
    G = rng.standard_normal(stack + (d_out, n)).astype(np.float32)
    J = rng.standard_normal(stack + (d_in, d_out)).astype(np.float32)
    got = tseng._precondition(_t(A), _t(G), _t(J), lam).numpy()
    fn = jseng._precondition
    for _ in stack:
        fn = jax.vmap(fn, in_axes=(0, 0, 0, None))
    want = np.asarray(fn(jnp.asarray(A), jnp.asarray(G), jnp.asarray(J),
                         jnp.asarray(lam, jnp.float32)))
    _close(got, want, 1e-4, 1e-5, "vs reference")
    for idx in np.ndindex(*stack):
        V = np.stack([np.outer(A[idx][:, i], G[idx][:, i]).reshape(-1)
                      for i in range(n)], axis=1)
        F = lam * np.eye(d_in * d_out) + (V @ V.T) / n
        dense = np.linalg.solve(F, J[idx].reshape(-1)).reshape(d_in, d_out)
        _close(got[idx], dense, 1e-4, 1e-5, f"vs dense {idx}")


def _seng_taps(mod):
    """The MLP's three taps plus one stacked tap."""
    taps = dict(make_mlp_taps())
    taps["scan"] = jkfac.TapInfo("scan/w", 24, 24, stack=(3,), n_stat=16)
    if mod is jkfac:
        return taps
    return {n: tkfac.TapInfo(t.param_path, t.d_in, t.d_out, t.stack,
                             t.n_stat) for n, t in taps.items()}


def test_seng_updates_match_reference():
    """Six Seng.update steps, T_fim = 3 (do_fim on at steps 0 and 3, off
    between: the cached factors precondition fresh gradients), on the
    MLP's taps plus a stacked one with its biases as untapped parameters:
    every update against the reference's (rtol 1e-4 / atol 1e-5, the
    Woodbury tolerance)."""
    jtaps, ttaps = _seng_taps(jkfac), _seng_taps(tseng)
    kw = dict(damping=2.0, momentum=0.9, weight_decay=1e-2, T_fim=3)
    jopt = jseng.Seng(jseng.SengConfig(
        lr=jbase.constant(0.05), fallback_lr=jbase.constant(3e-3), **kw),
        jtaps)
    topt = tseng.Seng(tseng.SengConfig(
        lr=tbase.constant(0.05), fallback_lr=tbase.constant(3e-3), **kw),
        ttaps, device=CPU)
    jparams, _, _, _ = tap_data(jtaps)
    for name in ("fc0", "fc1", "fc2"):
        jparams[name]["b"] = jnp.zeros((jtaps[name].d_out,))
    tparams = _flat(jparams)
    jst, tst = jopt.init(jparams), topt.init(tparams)
    jupd = jax.jit(jopt.update, static_argnames=("do_fim", "n_tokens"))
    for k in range(6):
        key = jax.random.PRNGKey(200 + k)
        _, grads, acts, pgs = tap_data(jtaps, key)
        for name in ("fc0", "fc1", "fc2"):
            grads[name]["b"] = jax.random.normal(jax.random.fold_in(key, 77),
                                                 (jtaps[name].d_out,))
        do_fim = jopt.cfg.flags(k)["do_fim"]
        assert do_fim == topt.cfg.flags(k)["do_fim"]
        ju, jst = jupd(grads, jst, jparams, acts=acts, probe_grads=pgs,
                       n_tokens=N_BS, do_fim=do_fim)
        tu, tst = topt.update(_flat(grads), tst, tparams,
                              acts={n: _t(a) for n, a in acts.items()},
                              probe_grads={n: _t(p) for n, p in pgs.items()},
                              n_tokens=N_BS, do_fim=do_fim)
        want = _flat(ju)
        assert list(tu) == list(tparams)
        for p in want:
            _close(tu[p], want[p], 1e-4, 1e-5, f"step {k} {p}")
        jparams = jbase.apply_updates(jparams, ju)
        tbase.apply_updates(tparams, tu)
    assert tst.step == int(jst.step) == 6


# ---------------------------------------------------------------------------
# SGD and the baseline step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nesterov,wd", [(False, 0.0), (False, 7e-4),
                                         (True, 0.0), (True, 7e-4)])
def test_sgd_matches_reference(nesterov, wd):
    """Four SGD updates (momentum 0.9) from the same gradients: fp32
    elementwise arithmetic in the same order, rtol 1e-6 / atol 1e-7."""
    rng = np.random.default_rng(1)
    shapes = {"a/w": (6, 5), "a/b": (5,), "c/w": (3, 4, 4)}
    jp = {k: jnp.asarray(rng.standard_normal(s), jnp.float32)
          for k, s in shapes.items()}
    tp = {k: _t(v) for k, v in jp.items()}
    jopt = jsgd.sgd(jbase.constant(0.05), momentum=0.9, weight_decay=wd,
                    nesterov=nesterov)
    topt = tsgd.sgd(tbase.constant(0.05), momentum=0.9, weight_decay=wd,
                    nesterov=nesterov)
    jst, tst = jopt.init(jp), topt.init(tp)
    for k in range(4):
        g = {key: rng.standard_normal(s).astype(np.float32)
             for key, s in shapes.items()}
        ju, jst = jopt.update({k2: jnp.asarray(v) for k2, v in g.items()},
                              jst, jp)
        tu, tst = topt.update({k2: _t(v) for k2, v in g.items()}, tst, tp)
        for key in shapes:
            _close(tu[key], ju[key], 1e-6, 1e-7, f"step {k} {key}")
        jp = jbase.apply_updates(jp, ju)
        tbase.apply_updates(tp, tu)
    assert tst.step == int(jst.step) == 4


def _torch_mlp_loss(params, probes, batch):
    """The port's counterpart of test_kfac_optimizer.mlp_loss."""
    x, y = batch
    acts, h = {}, x
    for i in range(3):
        name = f"fc{i}"
        h, acts[name] = tlayers.tapped_matmul(params[f"{name}/w"], h,
                                              probes.get(name), N_STAT)
        h = h + params[f"{name}/b"]
        if i < 2:
            h = torch.relu(h)
    return torch.mean(torch.square(h - y)), acts


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_baseline_step_matches_reference(name):
    """make_baseline_step with SGD (the reference's train_quality settings:
    lr 0.05, momentum 0.9, wd 7e-4) and AdamW (lr 1e-3, wd 7e-4), five
    steps of the MLP from the same weights and batches: losses and final
    weights against the reference's (rtol 1e-5 / atol 1e-6: fp32 forward
    and backward in two libraries)."""
    if name == "sgd":
        jopt = jsgd.sgd(jbase.constant(0.05), momentum=0.9,
                        weight_decay=7e-4)
        topt = tsgd.sgd(tbase.constant(0.05), momentum=0.9,
                        weight_decay=7e-4)
    else:
        jopt = jadamw.adamw(jbase.constant(1e-3), weight_decay=7e-4)
        topt = tadamw.adamw(tbase.constant(1e-3), weight_decay=7e-4)
    jparams = init_mlp(jax.random.PRNGKey(4))
    tparams = {k: v.requires_grad_() for k, v in _flat(jparams).items()}
    batches = make_batches(5, seed=5)
    jstep = jax.jit(jloop.make_baseline_step(mlp_loss, jopt))
    tstep = tloop.make_baseline_step(_torch_mlp_loss, topt)
    jst = jloop.TrainState(params=jparams, opt=jopt.init(jparams),
                           rng=jax.random.PRNGKey(0))
    tst = tloop.TrainState(params=tparams, opt=topt.init(tparams),
                           rng=torch.Generator().manual_seed(0))
    for k, (x, y) in enumerate(batches):
        jst, jl = jstep(jst, (x, y))
        tst, tl = tstep(tst, (_t(x), _t(y)))
        _close(float(tl), float(jl), 1e-5, 0, f"loss {k}")
    want = _flat(jst.params)
    for p in want:
        _close(tst.params[p].detach(), want[p], 1e-5, 1e-6, p)


# ---------------------------------------------------------------------------
# the quickstart
# ---------------------------------------------------------------------------

def test_quickstart_trajectory_matches_reference():
    """The port's quickstart MLP and optimizer from the reference
    example's initial weights (PRNGKey(1), ``layers.dense_init``) and
    batches, 50 steps of B-KFAC r = 32: every loss against the
    reference's ``run_kfac_training`` (jitted, as the example runs it) at
    rtol 1e-4, and the example's own check."""
    D = tquick
    taps = {"fc0": jkfac.TapInfo("fc0/w", D.D_IN, D.D_H, n_stat=D.N_STAT),
            "fc1": jkfac.TapInfo("fc1/w", D.D_H, D.D_OUT, n_stat=D.N_STAT)}
    assert {n: (t.d_in, t.d_out, t.n_stat) for n, t in taps.items()} == {
        n: (t.d_in, t.d_out, t.n_stat) for n, t in D.TAPS.items()}

    def jloss(params, probes, batch):
        x, y = batch
        acts = {}
        h, acts["fc0"] = jlayers.tapped_matmul(params["fc0"]["w"], x,
                                               probes.get("fc0"), D.N_STAT)
        h = jax.nn.relu(h)
        out, acts["fc1"] = jlayers.tapped_matmul(params["fc1"]["w"], h,
                                                 probes.get("fc1"), D.N_STAT)
        return jnp.mean((out - y) ** 2), acts

    from repro.core import policy as jpolicy
    cfg = jkfac.KfacConfig(
        policy=jpolicy.PolicyConfig(variant="bkfac", r=32),
        lr=jbase.constant(0.05), damping_phi=jbase.constant(0.1),
        clip=1.0, T_updt=1, T_brand=1)
    key = jax.random.PRNGKey(0)
    W_true = jax.random.normal(key, (D.D_IN, D.D_OUT))
    batches = []
    for i in range(D.STEPS):
        x = jax.random.normal(jax.random.fold_in(key, i), (D.BATCH, D.D_IN))
        batches.append((x, jnp.tanh(x @ W_true)))
    k0, k1 = jax.random.split(jax.random.PRNGKey(1))
    jparams = {"fc0": {"w": jlayers.dense_init(k0, D.D_IN, D.D_H)},
               "fc1": {"w": jlayers.dense_init(k1, D.D_H, D.D_OUT)}}
    _, jl = jloop.run_kfac_training(jloss, jkfac.Kfac(cfg, taps), jparams,
                                    batches, n_tokens=D.BATCH)
    tl = D.train(_flat(jparams), [(_t(x), _t(y)) for x, y in batches], CPU)
    assert len(tl) == len(jl) == 50
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < 0.3 * tl[0]


def test_quickstart_runs_on_the_cpu_on_request(capsys):
    tquick.main(["--device", "cpu"])
    assert capsys.readouterr().out.strip().endswith("OK")
