"""The LM stack's parts in the port against the reference, on the CPU:
norms, rope and softcap; blockwise and decode attention; the SSD and
RG-LRU mixers and the causal conv; MoE routing, dispatch and combine (with
forced drops); the token stream from the reference's draws.

Inputs are made with numpy from a seed and go through both packages.
Tolerances are the reference test's own where it has one
(``tests/test_mixers.py``: attention atol 2e-5 / rtol 2e-4, SSD atol 1e-4
/ rtol 1e-3, RG-LRU atol 1e-5 / rtol 1e-4), else 1e-5 relative to the
largest entry in fp32 (``_close``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

CPU = torch.device("cpu")
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


def _rs(seed):
    return np.random.default_rng(seed)


def _n(rs, *shape, scale=1.0):
    return (rs.standard_normal(shape) * scale).astype(np.float32)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, rel=REL):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= rel, f"max err {err:.3g} of the scale > {rel}"


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm_and_layer_norm():
    rs = _rs(0)
    x, s, b = _n(rs, 2, 5, 24), _n(rs, 24, scale=0.1), _n(rs, 24)
    _close(tlayers.rms_norm(_t(x), _t(s)), jlayers.rms_norm(x, s))
    _close(tlayers.layer_norm(_t(x), _t(s), _t(b)),
           jlayers.layer_norm(x, s, b))


@pytest.mark.parametrize("theta", [10000.0, 1000000.0])
def test_rope(theta):
    rs = _rs(1)
    x = _n(rs, 2, 32, 4, 16)
    pos = np.broadcast_to(np.arange(32), (2, 32))
    _close(tlayers.rope(_t(x), _t(pos), theta), jlayers.rope(x, pos, theta))


def test_rope_bf16_keeps_dtype():
    x = torch.randn(1, 8, 2, 16).to(torch.bfloat16)
    pos = torch.arange(8)[None]
    assert tlayers.rope(x, pos).dtype == torch.bfloat16


def test_softcap():
    x = _n(_rs(2), 4, 7, scale=50.0)
    _close(tlayers.softcap(_t(x), 30.0), jlayers.softcap(x, 30.0))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _qkv(seed, B, T, H, Hk, hd):
    rs = _rs(seed)
    return _n(rs, B, T, H, hd), _n(rs, B, T, Hk, hd), _n(rs, B, T, Hk, hd)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (16, 0.0), (0, 30.0)])
def test_blockwise_attention(window, softcap):
    """The three cases of test_mixers.py::test_blockwise_matches_naive,
    the port against the reference's blockwise function."""
    q, k, v = _qkv(3, 2, 64, 4, 2, 16)
    got = tattn.blockwise_attention(_t(q), _t(k), _t(v), causal=True,
                                    window=window, softcap=softcap,
                                    q_block=16, kv_block=16)
    want = jattn.blockwise_attention(*map(jnp.asarray, (q, k, v)),
                                     causal=True, window=window,
                                     softcap=softcap, q_block=16,
                                     kv_block=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-4)


def test_blockwise_attention_noncausal_cross():
    rs = _rs(4)
    q, k, v = _n(rs, 2, 16, 4, 8), _n(rs, 2, 32, 2, 8), _n(rs, 2, 32, 2, 8)
    got = tattn.blockwise_attention(_t(q), _t(k), _t(v), causal=False,
                                    q_block=8, kv_block=8)
    want = jattn.blockwise_attention(*map(jnp.asarray, (q, k, v)),
                                     causal=False, q_block=8, kv_block=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-4)


def test_blockwise_attention_grads():
    """Gradients through the skipped-block loop equal the reference's."""
    q, k, v = _qkv(5, 2, 32, 4, 2, 8)
    w = _n(_rs(6), 2, 32, 4, 8)

    def jf(q, k, v):
        return jnp.sum(jattn.blockwise_attention(
            q, k, v, window=12, q_block=8, kv_block=8) * w)
    want = jax.grad(jf, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    out = torch.sum(tattn.blockwise_attention(
        tq, tk, tv, window=12, q_block=8, kv_block=8) * _t(w))
    got = torch.autograd.grad(out, (tq, tk, tv))
    for g, w_ in zip(got, want):
        _close(g, w_)


@pytest.mark.parametrize("window", [0, 8])
def test_decode_attention(window):
    q, k, v = _qkv(7, 2, 32, 4, 2, 8)
    got = tattn.decode_attention(_t(q[:, -1:]), _t(k), _t(v), window=window,
                                 t=31)
    want = jattn.decode_attention(q[:, -1:], k, v, window=window,
                                  t=jnp.asarray(31))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-4)
    full = tattn.blockwise_attention(_t(q), _t(k), _t(v), window=window,
                                     q_block=8, kv_block=8)
    np.testing.assert_allclose(got[:, 0].numpy(), full[:, -1].numpy(),
                               atol=2e-5, rtol=2e-4)


# ---------------------------------------------------------------------------
# SSD and RG-LRU
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, B=2, T=32, H=4, P=8, G=2, N=6):
    rs = _rs(seed)
    xh = _n(rs, B, T, H, P)
    dt = (np.log1p(np.exp(_n(rs, B, T, H))) * 0.1).astype(np.float32)
    A = (-np.log1p(np.exp(_n(rs, H)))).astype(np.float32)
    return xh, dt, A, _n(rs, B, T, G, N), _n(rs, B, T, G, N)


def test_ssd_chunked_and_reference():
    args = _ssd_inputs(8)
    got = tssm.ssd_chunked(*map(_t, args), chunk=8)
    want = jssm.ssd_chunked(*args, chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-3)
    _close(got, want)
    dense = tssm.ssd_reference(*map(_t, args))
    np.testing.assert_allclose(dense.numpy(),
                               np.asarray(jssm.ssd_reference(*args)),
                               atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-4,
                               rtol=1e-3)


def test_ssd_decode_step():
    xh, dt, A, Bm, Cm = _ssd_inputs(9)
    B, T, H, P = xh.shape
    N = Bm.shape[-1]
    ts = torch.zeros((B, H, N, P))
    js = jnp.zeros((B, H, N, P))
    for t in range(T):
        ty, ts = tssm.ssd_decode_step(_t(xh[:, t]), _t(dt[:, t]), _t(A),
                                      _t(Bm[:, t]), _t(Cm[:, t]), ts)
        jy, js = jssm.ssd_decode_step(xh[:, t], dt[:, t], A, Bm[:, t],
                                      Cm[:, t], js)
    _close(ty, jy)
    _close(ts, js)
    full = tssm.ssd_chunked(*map(_t, (xh, dt, A, Bm, Cm)), chunk=8)
    np.testing.assert_allclose(ty.numpy(), full[:, -1].numpy(), atol=1e-4,
                               rtol=1e-3)


def test_rglru_and_step():
    """The log-depth scan against the reference's associative scan, and
    against the port's own step loop (test_mixers.py's tolerance)."""
    rs = _rs(10)
    B, T, D = 2, 16, 12
    x, gx, ga, lam = _n(rs, B, T, D), _n(rs, B, T, D), _n(rs, B, T, D), \
        _n(rs, D)
    full = tssm.rglru(_t(x), _t(gx), _t(ga), _t(lam))
    np.testing.assert_allclose(full.numpy(),
                               np.asarray(jssm.rglru(x, gx, ga, lam)),
                               atol=1e-5, rtol=1e-4)
    h = torch.zeros((B, D))
    jh = jnp.zeros((B, D))
    outs = []
    for t in range(T):
        y, h = tssm.rglru_step(_t(x[:, t]), _t(gx[:, t]), _t(ga[:, t]),
                               _t(lam), h)
        _, jh = jssm.rglru_step(x[:, t], gx[:, t], ga[:, t], lam, jh)
        outs.append(y)
    _close(h, jh)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               atol=1e-5, rtol=1e-4)


def test_causal_conv1d_and_step():
    rs = _rs(11)
    B, T, C, K = 2, 10, 6, 4
    x, w = _n(rs, B, T, C), _n(rs, K, C)
    full = tssm.causal_conv1d(_t(x), _t(w))
    _close(full, jssm.causal_conv1d(x, w))
    buf, jbuf = torch.zeros((B, K - 1, C)), jnp.zeros((B, K - 1, C))
    for t in range(T):
        y, buf = tssm.causal_conv1d_step(_t(x[:, t]), buf, _t(w))
        jy, jbuf = jssm.causal_conv1d_step(x[:, t], jbuf, w)
        _close(y, jy)
        np.testing.assert_allclose(y.numpy(), full[:, t].numpy(), atol=1e-5,
                                   rtol=1e-4)
    _close(buf, jbuf)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

DIMS = dict(d_model=16, d_ff=8, n_experts=4, top_k=2)


def test_route():
    rs = _rs(12)
    x, w = _n(rs, 24, 16), _n(rs, 16, 4)
    tw, ti, ta = tmoe.route(_t(x), _t(w), tmoe.MoeDims(**DIMS))
    jw, ji, ja = jmoe.route(x, w, jmoe.MoeDims(**DIMS))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tw, jw)
    _close(ta, ja)


@pytest.mark.parametrize("capacity", [3, 8, 24])
def test_dispatch_combine_with_drops(capacity):
    """Capacity 3 and 8 drop assignments (12 tokens × top-2 over 4
    experts): every dropped one goes to the sentinel row and contributes
    nothing; the buffers and the combine equal the reference's."""
    rs = _rs(13)
    N = 12
    x, w = _n(rs, N, 16), _n(rs, 16, 4)
    tdims, jdims = tmoe.MoeDims(**DIMS), jmoe.MoeDims(**DIMS)
    _, idx, _ = jmoe.route(x, w, jdims)
    wts, _, _ = tmoe.route(_t(x), _t(w), tdims)
    tb, tinfo = tmoe.dispatch(_t(x), _t(idx).long(), tdims, capacity)
    jb, jinfo = jmoe.dispatch(x, idx, jdims, capacity)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    for a, b in zip(tinfo, jinfo):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    kept = int(tinfo[3].sum())
    assert kept <= 4 * capacity
    assert (kept == N * 2) if capacity >= N * 2 else (kept < N * 2 or
                                                       capacity == 8)
    if capacity == 3:
        assert kept < N * 2 and int((tinfo[2] == 4 * capacity).sum()) == \
            N * 2 - kept
    out = _n(rs, 4, capacity, 16)
    _close(tmoe.combine(_t(out), wts, tinfo, N),
           jmoe.combine(out, np.asarray(wts), jinfo, N))


def test_moe_block_with_taps_and_grads():
    """moe_block with a shared expert and forced drops (N = 16 tokens, the
    floor capacity 8 < 16·2/4·1.25): output, aux, the (E,)-stacked acts and
    the gradients w.r.t. input, parameters and probes."""
    rs = _rs(14)
    dims = dict(DIMS, n_shared=1)
    n_stat = 6
    p = {"router": _n(rs, 16, 4), "wi": _n(rs, 4, 16, 16, scale=0.25),
         "wo": _n(rs, 4, 8, 16, scale=0.3),
         "shared_wi": _n(rs, 16, 16, scale=0.25),
         "shared_wo": _n(rs, 8, 16, scale=0.3)}
    x = _n(rs, 2, 8, 16)
    probes = {"moe/moe_wi": np.zeros((4, n_stat, 16), np.float32),
              "moe/moe_wo": np.zeros((4, n_stat, 16), np.float32),
              "moe/shared_wi": np.zeros((n_stat, 16), np.float32),
              "moe/shared_wo": np.zeros((n_stat, 16), np.float32)}
    gw = _n(rs, 2, 8, 16)

    def jf(x, p, probes):
        acts = {}
        y, aux = jmoe.moe_block(x, p, jmoe.MoeDims(**dims), probes, acts,
                                "moe", n_stat)
        return jnp.sum(y * gw) + aux, (y, aux, acts)
    (_, (jy, jaux, jacts)), jg = jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True)(x, p, probes)
    tx = _t(x).requires_grad_(True)
    tp = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    tpr = {k: _t(v).requires_grad_(True) for k, v in probes.items()}
    acts = {}
    ty, taux = tmoe.moe_block(tx, tp, tmoe.MoeDims(**dims), tpr, acts,
                              "moe", n_stat)
    grads = torch.autograd.grad(torch.sum(ty * _t(gw)) + taux,
                                [tx] + list(tp.values())
                                + list(tpr.values()))
    _close(ty, jy)
    _close(taux, jaux)
    assert set(acts) == set(jacts)
    for k in acts:
        _close(acts[k], jacts[k])
    _close(grads[0], jg[0])
    for g, k in zip(grads[1:1 + len(tp)], tp):
        _close(g, jg[1][k])
    for g, k in zip(grads[1 + len(tp):], tpr):
        _close(g, jg[2][k])


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_token_stream_from_the_references_draws():
    """batch_at with the reference's draws (teacher, first, noise,
    follow) injected gives the reference's batch token for token."""
    js = jsyn.TokenStream(vocab=97, batch=3, seq_len=40, seed=5)
    step = 7
    nxt = js._teacher()
    key = jax.random.fold_in(jax.random.PRNGKey(js.seed + 1), step)
    k1, k2, k3 = jax.random.split(key, 3)
    first = jax.random.randint(k1, (3, 1), 0, 97)
    noise = jax.random.randint(k2, (3, 40), 0, 97)
    follow = jax.random.bernoulli(k3, js.structure, (3, 40))
    ts = tsyn.TokenStream(vocab=97, batch=3, seq_len=40, seed=5, device=CPU)
    got = ts.batch_at(step, teacher=_t(nxt), first=_t(first),
                      noise=_t(noise), follow=_t(follow))
    want = js.batch_at(step)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["targets"].numpy(),
                                  np.asarray(want["targets"]))


def test_token_stream_is_a_function_of_seed_and_step():
    ts = tsyn.TokenStream(vocab=50, batch=2, seq_len=64, seed=1, device=CPU)
    a, b = ts.batch_at(3), ts.batch_at(3)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], ts.batch_at(4)["tokens"])
    tok = a["tokens"]
    assert tok.dtype == torch.int64 and tok.shape == (2, 64)
    assert int(tok.min()) >= 0 and int(tok.max()) < 50
    # the bigram teacher is followed about `structure` of the time
    nxt = ts._teacher(CPU)
    follows = (nxt[tok[:, :-1]] == tok[:, 1:]).float().mean()
    assert 0.5 < float(follows) < 0.9


# ---------------------------------------------------------------------------
# B-KFAC on the LM: trajectory, checkpoints across packages, the example
# ---------------------------------------------------------------------------

from repro.configs.base import get_arch as jget_arch  # noqa: E402
from repro.core import kfac as jkfac  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.models.lm import LM as JLM  # noqa: E402
from repro.optim import base as jbase  # noqa: E402
from repro.train import checkpoint as jck  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as tconfigs  # noqa: E402
from repro_torch.core import kfac as tkfac  # noqa: E402
from repro_torch.examples import train_lm_kfac as texample  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from repro_torch.train import checkpoint as tck  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402

LM_B, LM_T, LM_STEPS = 2, 32, 4
#: the trajectory tolerance: 2e-3 of the scale of each tensor's change
#: since the initial parameters (a step moves a weight by 1.5e-4 to 3.6e-4
#: of its own scale here, so the parameters themselves would not tell a
#: wrong update from none).  Readings on this model: at most 5.1e-4 over
#: the four steps (a zero-initialised norm scale; the matrices at most
#: 9.6e-5), and 2.5e-4 for the resumed third step
TRAJ = 2e-3


def _jcfg():
    """examples/train_lm_kfac.py's optimizer settings, in the reference."""
    return jkfac.KfacConfig(
        policy=jpolicy.PolicyConfig(variant="bkfac", r=64,
                                    max_dense_dim=2048),
        lr=jbase.constant(0.02), damping_phi=jbase.constant(0.1),
        weight_decay=1e-4, clip=0.5, T_updt=2, T_inv=10, T_brand=2,
        T_rsvd=10, T_corct=10, fallback_lr=jbase.constant(3e-3))


@pytest.fixture(scope="module")
def lm_traj():
    """Reduced gemma3 (the example's ``tiny`` preset) trained LM_STEPS
    B-KFAC steps by the reference's make_scheduled_kfac_step (jitted per
    step kind, as the reference example runs it) on the reference's
    TokenStream batches (B = 2, T = 32); the state after 2 steps is kept
    for the checkpoint tests."""
    arch = jget_arch("gemma3_4b").reduced()
    lm = JLM(arch, remat=False)
    opt = jkfac.Kfac(_jcfg(), lm.taps)
    params = lm.init(jax.random.PRNGKey(0))
    stream = jsyn.TokenStream(vocab=arch.vocab, batch=LM_B, seq_len=LM_T,
                              seed=0)
    batches = [stream.batch_at(k) for k in range(LM_STEPS)]
    step = jax.jit(jloop.make_scheduled_kfac_step(lm.loss_fn, opt,
                                                  n_tokens=LM_B * LM_T),
                   static_argnames=("work",))
    sched = opt.scheduler()
    state = jloop.TrainState(params=params, opt=opt.init(params),
                             rng=jax.random.PRNGKey(1))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    out = {"init": np_tree(params), "losses": [], "after": [],
           "batches": [np_tree(b) for b in batches]}
    for k in range(LM_STEPS):
        state, loss = step(state, batches[k], work=sched.work(k))
        out["losses"].append(float(loss))
        out["after"].append(np_tree(state.params))
        if k == 1:
            out["state2"] = state
    return out


@pytest.fixture(scope="module")
def port_traj(lm_traj, tmp_path_factory):
    """The port's uninterrupted LM_STEPS steps from the reference's initial
    parameters and batches: losses, parameters after every step, and a
    checkpoint of its TrainState after 2 steps."""
    lm, opt = _tlm()
    params = _tparams(lm_traj["init"])
    state = tloop.TrainState(params=params, opt=opt.init(params),
                             rng=torch.Generator().manual_seed(1))
    step = tloop.make_scheduled_kfac_step(lm.loss_fn, opt,
                                          n_tokens=LM_B * LM_T)
    sched = opt.scheduler()
    ck_dir = str(tmp_path_factory.mktemp("port_lm_ckpt"))
    out = {"losses": [], "after": [], "ckpt": ck_dir}
    for k in range(LM_STEPS):
        state, loss = step(state, _tbatch(lm_traj["batches"][k]),
                           sched.work(k))
        out["losses"].append(float(loss))
        out["after"].append({k_: v.detach().clone()
                             for k_, v in state.params.items()})
        if k == 1:
            tck.save(ck_dir, 1, state)
    return out


def _tlm():
    arch = tconfigs.get_arch("gemma3_4b").reduced()
    lm = TLM(arch, remat=False, device=CPU)
    opt = tkfac.Kfac(texample.kfac_config(), lm.taps, device=CPU)
    return lm, opt


def _tparams(np_tree):
    return {k: v.requires_grad_() for k, v in
            convert.params_from_jax(np_tree, device=CPU).items()}


def _tbatch(b):
    return {k: torch.as_tensor(np.array(v)) for k, v in b.items()}


def _close_change(got, want, init, rel=TRAJ):
    """``got`` and ``want`` moved the same way from ``init``: the largest
    difference of the two changes within ``rel`` of the reference
    change's largest entry."""
    init = np.asarray(init.detach(), np.float64)
    _close(np.asarray(got.detach(), np.float64) - init,
           np.asarray(want, np.float64) - init, rel=rel)


def _port_steps(lm, opt, state, batches, k0):
    step = tloop.make_scheduled_kfac_step(lm.loss_fn, opt,
                                          n_tokens=LM_B * LM_T)
    sched = opt.scheduler()
    losses = []
    for k, b in enumerate(batches, start=k0):
        state, loss = step(state, _tbatch(b), sched.work(k))
        losses.append(float(loss))
    return state, losses


def test_bkfac_trajectory_equals_reference(lm_traj, port_traj):
    """Four B-KFAC steps of reduced gemma3 (stacked taps; EVD and Brand
    factors; stats and Brand updates on steps 0 and 2): losses to 1e-5
    relative, and each parameter's change from the initial parameters
    after every step to TRAJ of the reference change's scale."""
    init = convert.params_from_jax(lm_traj["init"], device=CPU)
    for k in range(LM_STEPS):
        assert abs(port_traj["losses"][k] - lm_traj["losses"][k]) <= \
            1e-5 * abs(lm_traj["losses"][k]), k
        want = convert.params_from_jax(lm_traj["after"][k], device=CPU)
        for name in want:
            _close_change(port_traj["after"][k][name], want[name],
                          init[name])


def test_reference_lm_checkpoint_resumes_in_the_port(lm_traj, port_traj,
                                                     tmp_path):
    """The reference's TrainState after 2 steps, saved by its
    train/checkpoint.py, restores in the port through a {"params", "opt"}
    template; the next step equals the port's uninterrupted third step
    (its change from the initial parameters to the trajectory tolerance:
    the two runs before it are the two packages'), and the port's example resumes from the same directory."""
    d = str(tmp_path)
    jck.save(d, 1, lm_traj["state2"])
    lm, opt = _tlm()
    params = _tparams(lm_traj["init"])
    got, _ = tck.restore(d, {"params": params, "opt": opt.init(params)})
    assert got["opt"].step == 2 and got["opt"].n_stats == 1
    resumed = tloop.TrainState(params=got["params"], opt=got["opt"],
                               rng=torch.Generator().manual_seed(1))
    resumed, tail = _port_steps(lm, opt, resumed, lm_traj["batches"][2:3],
                                k0=2)
    assert abs(tail[0] - port_traj["losses"][2]) <= \
        1e-4 * abs(port_traj["losses"][2])
    init = convert.params_from_jax(lm_traj["init"], device=CPU)
    for k, v in port_traj["after"][2].items():
        _close_change(resumed.params[k], v, init[k])
    # the port's example picks the reference's checkpoint up (its tiny
    # preset is this model and optimizer) and runs steps 2 and 3
    state, ex_losses = texample.main(
        ["--preset", "tiny", "--steps", "4", "--batch", str(LM_B), "--seq",
         str(LM_T), "--ckpt-dir", d, "--device", "cpu"])
    assert len(ex_losses) == 2 and state.opt.step == 4
    assert all(np.isfinite(ex_losses))


def test_port_lm_checkpoint_resume_is_exact(lm_traj, port_traj):
    """Within the port: the checkpoint after 2 steps, restored into a
    fresh TrainState, continues bit for bit as the uninterrupted run."""
    lm, opt = _tlm()
    p = _tparams(lm_traj["init"])
    tmpl = tloop.TrainState(params=p, opt=opt.init(p),
                            rng=torch.Generator().manual_seed(1))
    restored, _ = tck.restore(port_traj["ckpt"], tmpl)
    end, tail = _port_steps(lm, opt, restored, lm_traj["batches"][2:],
                            k0=2)
    assert tail == port_traj["losses"][2:]
    for k, v in port_traj["after"][-1].items():
        assert torch.equal(end.params[k], v), k
