"""The port's LM against the reference for all ten architectures at their
``reduced()`` configs, on the CPU: taps, loss, logits, every tap's act
and probe gradient, the parameter gradients, two decode steps, decode
against forward, and the parameter counts of the full configs.

Each architecture's reference run (jitted forward + value_and_grad and
two decode steps, B = 2, T = 32) happens once per module and is shared by
its tests.  The port takes the reference's initial parameters through
``convert.params_from_jax`` and the same numpy batch.  Tolerance: 1e-5
of the largest entry of each compared tensor, in fp32 (no reference test
holds these quantities to a tolerance); decode against forward at the
reference's 2e-2 (``tests/test_arch_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ARCH_NAMES, get_arch  # noqa: E402
from repro.launch.param_count import count_params  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.lm import LM as JLM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as tconfigs  # noqa: E402
from repro_torch.launch import param_count as tcount  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402

CPU = torch.device("cpu")
B, T = 2, 32
REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's side is many small ops: on one intra-op thread they cost
    the same alone and do not crawl when parallel test workers share the
    cores (each worker's thread pool spans all of them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=REL, what=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= rel, f"{what}: max err {err:.3g} of the scale > {rel}"


def _batch(arch, seed=0):
    """The reference smoke test's batch layout, drawn with numpy."""
    rs = np.random.default_rng(seed)
    n_tok = T - (arch.n_prefix if arch.frontend == "vision" else 0)
    batch = {"tokens": rs.integers(0, arch.vocab, (B, n_tok)),
             "targets": rs.integers(0, arch.vocab, (B, n_tok))}
    if arch.is_encdec:
        batch["frames"] = (rs.standard_normal((B, T, arch.d_model))
                           * 0.1).astype(np.float32)
        batch["tokens"] = batch["tokens"][:, : T // arch.dec_ratio]
        batch["targets"] = batch["targets"][:, : T // arch.dec_ratio]
    if arch.frontend == "vision":
        batch["embeds"] = (rs.standard_normal((B, arch.n_prefix,
                                               arch.d_model))
                           * 0.1).astype(np.float32)
    return batch


class _Runs:
    """Reference runs by architecture, each made on first use."""

    def __init__(self):
        self._done = {}

    def __getitem__(self, name):
        if name not in self._done:
            self._done[name] = self._run(name)
        return self._done[name]

    @staticmethod
    def _run(name):
        arch = get_arch(name).reduced()
        lm = JLM(arch, remat=False)
        params = lm.init(jax.random.PRNGKey(0))
        batch = _batch(arch)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        probes = jlayers.make_probes(lm.taps)

        @jax.jit
        def fwd_bwd(p, pr):
            (loss, acts), grads = jax.value_and_grad(
                lambda p, pr: lm.loss_fn(p, pr, jb), argnums=(0, 1),
                has_aux=True)(p, pr)
            return loss, acts, grads, lm.forward(p, jb, pr, train=True)[0]

        loss, acts, (gp, gpr), logits = fwd_bwd(params, probes)
        cross_len = T if arch.is_encdec else 0
        cache = lm.init_cache(B, 16, cross_len=cross_len)
        step = jax.jit(lm.decode_step)
        token = jnp.asarray(batch["tokens"][:, :1], jnp.int32)
        decoded = []
        for t in range(2):
            lg, cache = step(params, cache, token, jnp.asarray(t))
            decoded.append(np.asarray(lg))
        to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
        return dict(arch=arch, lm=lm, params=to_np(params), batch=batch,
                    loss=float(loss), acts=to_np(acts), grad_params=to_np(gp),
                    grad_probes=to_np(gpr), logits=np.asarray(logits),
                    decoded=decoded)


@pytest.fixture(scope="module")
def runs():
    return _Runs()


def _port(run, remat=False):
    """The port's LM, the reference's parameters (requiring grad), zero
    probes and the batch as tensors."""
    arch = tconfigs.get_arch(run["arch"].name).reduced()
    lm = TLM(arch, remat=remat, device=CPU)
    params = convert.params_from_jax(run["params"], device=CPU)
    for v in params.values():
        v.requires_grad_(True)
    probes = tlayers.make_probes(lm.taps, device=CPU)
    batch = {k: torch.as_tensor(np.array(v)) for k, v in run["batch"].items()}
    return lm, params, probes, batch


def _port_grads(run, remat=False):
    lm, params, probes, batch = _port(run, remat)
    loss, acts = lm.loss_fn(params, probes, batch)
    pk, qk = list(params), list(probes)
    grads = torch.autograd.grad(loss, [params[k] for k in pk]
                                + [probes[k] for k in qk])
    return (lm, params, loss, acts, dict(zip(pk, grads[:len(pk)])),
            dict(zip(qk, grads[len(pk):])))


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_config_equals_reference(name):
    for full in (get_arch(name), get_arch(name).reduced()):
        port = tconfigs.get_arch(name) if full is get_arch(name) else \
            tconfigs.get_arch(name).reduced()
        assert repr(port) == repr(full)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_taps_equal_reference(name, runs):
    run = runs[name]
    lm = TLM(tconfigs.get_arch(name).reduced(), device=CPU)
    fields = lambda t: (t.param_path, t.d_in, t.d_out, tuple(t.stack),
                        t.n_stat, t.linear_apply)
    assert list(lm.taps) == list(run["lm"].taps)
    assert {n: fields(t) for n, t in lm.taps.items()} == \
        {n: fields(t) for n, t in run["lm"].taps.items()}
    # every tap's W has the (*stack, d_in, d_out) shape in the parameters
    params = convert.params_from_jax(run["params"], device=CPU)
    for t in lm.taps.values():
        assert tuple(params[t.param_path].shape) == \
            tuple(t.stack) + (t.d_in, t.d_out)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_loss_and_logits_equal_reference(name, runs):
    run = runs[name]
    lm, params, probes, batch = _port(run)
    with torch.no_grad():
        logits = lm.forward(params, batch, probes, train=True)[0]
        loss, _ = lm.loss_fn(params, probes, batch)
    _close(logits, run["logits"], what="logits")
    assert abs(float(loss) - run["loss"]) <= REL * abs(run["loss"])


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_acts_and_probe_grads_equal_reference(name, runs):
    run = runs[name]
    _, _, _, acts, _, gprobe = _port_grads(run)
    assert set(acts) == set(run["acts"]) == set(gprobe)
    for n in acts:
        _close(acts[n], run["acts"][n], what=f"act {n}")
        _close(gprobe[n], run["grad_probes"][n], what=f"probe grad {n}")


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_grads_equal_reference(name, runs):
    run = runs[name]
    _, params, _, _, gp, _ = _port_grads(run)
    want = convert.params_from_jax(run["grad_params"], device=CPU)
    assert set(gp) == set(want)
    for k in gp:
        _close(gp[k], want[k], what=f"grad {k}")


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_decode_two_tokens_equal_reference(name, runs):
    run = runs[name]
    arch = run["arch"]
    lm, params, _, batch = _port(run)
    cache = lm.init_cache(B, 16, cross_len=T if arch.is_encdec else 0)
    token = batch["tokens"][:, :1]
    for t in range(2):
        logits, cache = lm.decode_step(params, cache, token, t)
        assert logits.shape == (B, 1, arch.vocab)
        _close(logits, run["decoded"][t], what=f"decode t={t}")


@pytest.mark.parametrize("name", ["gemma3_4b", "mamba2_2p7b",
                                  "recurrentgemma_2b"])
def test_decode_matches_forward(name, runs):
    """Greedy decode logits == full-forward logits position by position
    (test_arch_smoke.py::test_decode_matches_forward, its tolerance)."""
    run = runs[name]
    lm, params, _, _ = _port(run)
    n_tok = 8
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, run["arch"].vocab, (B, n_tok)))
    with torch.no_grad():
        full = lm.forward(params, {"tokens": tokens, "targets": tokens},
                          train=False)[0]
    cache = lm.init_cache(B, n_tok)
    outs = []
    for t in range(n_tok):
        lg, cache = lm.decode_step(params, cache, tokens[:, t:t + 1], t)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(),
                               full.detach().numpy(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_count_params_equals_reference(name):
    full = tconfigs.get_arch(name)
    assert tcount.count_params(full) == count_params(get_arch(name))
    assert tcount.count_params(full, active_only=True) == \
        count_params(get_arch(name), active_only=True)
    # the analytic count is every parameter but the norm scales and the
    # mixers' per-channel vectors, at the reduced config too
    red = full.reduced()
    params = TLM(red, device=CPU).init(torch.Generator().manual_seed(0))
    vectors = {"ln", "ln2", "x_ln", "final_ln", "enc_ln", "out_norm",
               "A_log", "D", "dt_bias", "lam"}
    assert tcount.count_params(red) == sum(
        v.numel() for k, v in params.items()
        if k.split("/")[-1] not in vectors)


def test_with_repeats_cuts_depth_only():
    """gemma3-4b cut to 2 + 1 repeats (16 of its 34 layers) keeps every
    width and the segments' patterns; its count is the reference's for
    the same cut."""
    import dataclasses
    full = tconfigs.get_arch("gemma3_4b")
    cut = full.with_repeats((2, 1))
    assert cut.n_layers == 16 and full.n_layers == 34
    assert [s.repeats for s in cut.segments] == [2, 1]
    assert [s.pattern for s in cut.segments] == \
        [s.pattern for s in full.segments]
    assert dataclasses.replace(cut, segments=full.segments,
                               n_layers=full.n_layers) == full
    jfull = get_arch("gemma3_4b")
    jcut = dataclasses.replace(jfull, n_layers=16, segments=tuple(
        dataclasses.replace(s, repeats=r)
        for s, r in zip(jfull.segments, (2, 1))))
    assert tcount.count_params(cut) == count_params(jcut) == 2_852_126_720
    with pytest.raises(ValueError):
        full.with_repeats((2,))


def test_init_shapes_equal_reference(runs):
    """The port's own init has the reference's parameter paths and
    shapes (gemma3's stacked segments, the MoE and enc-dec extras)."""
    for name in ("gemma3_4b", "llama4_scout_17b_a16e", "whisper_medium",
                 "deepseek_v3_671b"):
        run = runs[name] if name == "gemma3_4b" else None
        arch = tconfigs.get_arch(name).reduced()
        got = TLM(arch, device=CPU).init(torch.Generator().manual_seed(1))
        ref = run["params"] if run else jax.tree_util.tree_map(
            np.asarray, JLM(get_arch(name).reduced()).init(
                jax.random.PRNGKey(0)))
        want = convert.params_from_jax(ref, device=CPU)
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        assert all(v.dtype == torch.float32 for v in got.values())


def test_params_from_jax_keeps_stacked_axes(runs):
    run = runs["gemma3_4b"]
    params = convert.params_from_jax(run["params"], device=CPU)
    seg = run["params"]["segments"]["0"]["p0"]["mix"]["wq"]
    assert tuple(params["segments/0/p0/mix/wq"].shape) == seg.shape
    assert seg.shape[0] == run["arch"].segments[0].repeats
    np.testing.assert_array_equal(params["segments/0/p0/mix/wq"].numpy(),
                                  seg)
    assert "head/w" in params and "embed" in params


def test_remat_equals_no_remat(runs):
    """remat=True (torch.utils.checkpoint per repeat) recomputes the same
    forward: loss, acts and gradients bit for bit."""
    run = runs["gemma3_4b"]
    a = _port_grads(run, remat=False)
    b = _port_grads(run, remat=True)
    assert torch.equal(a[2], b[2])
    for x, y in ((a[3], b[3]), (a[4], b[4]), (a[5], b[5])):
        for k in x:
            assert torch.equal(x[k], y[k]), k
