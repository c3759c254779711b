"""The port's TenantBank (``repro_torch/core/tenant.py``): N optimizer
states stacked on a tenant axis that joins each bucket's batch.

Held against the reference's TenantBank (``tests/test_tenant.py``'s tiny
taps, tenants' data and per-tenant keys, the reference's random draws
injected), and against the port's own plain ``Kfac.update``:

  * N = 1 ≡ the plain update, bit for bit;
  * N = 3 stacked ≡ the reference's stacked bank and the port's three
    sequential runs, at the reference's atol 3e-4, rtol 1e-2;
  * identical inputs → bitwise identical lanes; inactive tenants bitwise
    inert in state and parameters; a group mixing tenants at their first
    statistics step with tenants past it ≡ the sequential runs;
  * the kernel-dispatch calls of an update are the same at N = 1, 2, 4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import test_tenant as jref  # noqa: E402
from test_torch_vgg import reference_draws  # noqa: E402
from repro.core import tenant as jtenant  # noqa: E402
from repro_torch.core import kfac as tkfac  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.core import tenant  # noqa: E402
from repro_torch.optim import base as tbase  # noqa: E402

CPU = torch.device("cpu")
VARIANTS = ["bkfac", "kfac", "rkfac", "brkfac", "bkfacc", "nskfac"]
STEPS = 3
N_STAT = 8


def _ttaps(momentum=0.9, use_kernels=False, variant="bkfac"):
    """The reference's tiny taps and optimizer settings, in the port."""
    taps = {n: tkfac.TapInfo(t.param_path, t.d_in, t.d_out,
                             stack=tuple(t.stack), n_stat=t.n_stat)
            for n, t in jref._taps().items()}
    cfg = tkfac.KfacConfig(
        policy=tpolicy.PolicyConfig(variant=variant, r=4,
                                    max_dense_dim=8192),
        lr=tbase.constant(0.05), momentum=momentum, T_updt=1, T_brand=1,
        bucketed=True, use_kernels=use_kernels)
    return taps, tkfac.Kfac(cfg, taps, device=CPU)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def tenant_data(t):
    """Tenant ``t``'s (params, grads, acts, probe grads) of the reference
    test, flat for the port."""
    p, g, a, pg = jref._tenant_data(jref._taps(), jax.random.PRNGKey(0), t)
    return ({f"{n}/w": _t(v["w"]) for n, v in p.items()},
            {f"{n}/w": _t(v["w"]) for n, v in g.items()},
            {n: _t(v) for n, v in a.items()},
            {n: _t(v) for n, v in pg.items()})


def rkey(t, s):
    return jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(7), t),
                              s)


def work(opt, s):
    return opt.uniform_work(True, True, s % 2 == 0)


@pytest.fixture(scope="module")
def reference_banks():
    """The reference's stacked N = 3 bank, 3 steps, per variant (run on
    first use): {variant: (reference opt, [per-step stacked updates])}."""
    cache = {}

    def get(variant):
        if variant not in cache:
            opt = jref._opt(variant, jref._taps())
            _, ups, _ = jref._run_stacked(opt, jref._taps(), 3, steps=STEPS)
            cache[variant] = (opt, [jax.tree_util.tree_map(np.asarray, u)
                                    for u in ups])
        return cache[variant]
    return get


def run_sequential(opt, n, steps=STEPS, jopt=None):
    """n independent plain-Kfac runs from the tenants' data → per tenant
    (updates per step, final state)."""
    out = []
    for t in range(n):
        p, g, a, pg = tenant_data(t)
        st, ups = opt.init(p), []
        for s in range(steps):
            w = work(opt, s)
            draws = (None if jopt is None
                     else reference_draws(jopt, rkey(t, s), w))
            u, st = opt.update(g, st, p, acts=a, probe_grads=pg,
                               n_tokens=N_STAT, rng=None, work=w,
                               draws=draws)
            ups.append(u)
        out.append((ups, st))
    return out


def stacked_inputs(n, same=False):
    per = [tenant_data(0 if same else t) for t in range(n)]
    return [tenant.tree_stack([x[i] for x in per]) for i in range(4)]


def run_stacked(opt, n, steps=STEPS, active=None, jopt=None, same=False,
                lists=False):
    """The port's bank over n tenants → (bank, per-step updates, state,
    stacked params).  ``lists`` hands the gradients as per-tenant lists."""
    P, G, A, PG = stacked_inputs(n, same)
    bank = tenant.TenantBank(opt)
    st = bank.init(P)
    ups = []
    for s in range(steps):
        w = work(opt, s)
        draws = (None if jopt is None else
                 [reference_draws(jopt, rkey(t, s), w) for t in range(n)])
        # the bank drops the entries of gradient lists as it reads them
        g = {k: list(v) for k, v in G.items()} if lists else G
        u, st = bank.update(g, st, P, acts=A, probe_grads=PG,
                            n_tokens=N_STAT, work=w, active=active,
                            draws=draws)
        ups.append(u)
    return bank, ups, st, P


def leaves(tree):
    return tenant._leaves(tree_to_tensors(tree))


def tree_to_tensors(tree):
    return tenant.tree_map(
        lambda x: x if isinstance(x, torch.Tensor) else torch.tensor(x),
        tree)


def assert_equal_trees(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# N = 1 ≡ the plain update, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["bkfac", "kfac"])
def test_single_tenant_bank_is_bitwise_plain_kfac(variant):
    _, opt = _ttaps(variant=variant)
    (seq_ups, seq_st), = run_sequential(opt, 1)
    _, ups, st, _ = run_stacked(opt, 1)
    for su, bu in zip(seq_ups, ups):
        assert_equal_trees(su, tenant.tree_slot(bu, 0))
    assert_equal_trees(seq_st, tenant.tree_slot(st, 0))
    assert tenant.tree_slot(st, 0).step == STEPS


# ---------------------------------------------------------------------------
# N = 3 stacked ≡ the reference's stacked bank ≡ three sequential runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_stacked_matches_reference_and_sequential(variant,
                                                  reference_banks):
    """Updates of every tenant at every step against the reference's
    stacked bank (its draws injected: the per-tenant keys' RSVD test
    matrices and correction columns) and against the port's sequential
    runs, at the reference's own tolerance for stacked vs sequential
    (tests/test_tenant.py: atol 3e-4, rtol 1e-2).  The gradients go in as
    per-tenant lists for half the variants (the bank empties them)."""
    jopt, jups = reference_banks(variant)
    _, opt = _ttaps(variant=variant)
    seq = run_sequential(opt, 3, jopt=jopt)
    _, ups, st, _ = run_stacked(opt, 3, jopt=jopt,
                                lists=VARIANTS.index(variant) % 2 == 1)
    for s in range(STEPS):
        for t in range(3):
            for name in jref._taps():
                key = f"{name}/w"
                got = ups[s][key][t].numpy()
                assert np.isfinite(got).all()
                np.testing.assert_allclose(got, jups[s][name]["w"][t],
                                           atol=3e-4, rtol=1e-2)
                np.testing.assert_allclose(got, seq[t][0][s][key].numpy(),
                                           atol=3e-4, rtol=1e-2)
    assert st.step.tolist() == st.n_stats.tolist() == [STEPS] * 3


def test_identical_inputs_give_bitwise_identical_lanes():
    """Tenants with identical inputs produce identical slices, bit for
    bit: any cross-tenant mixing in the widened buckets would break it."""
    _, opt = _ttaps()
    _, ups, st, _ = run_stacked(opt, 3, steps=2, same=True)
    for tree in (ups[-1], st):
        for x in leaves(tree):
            assert torch.equal(x[0], x[1]) and torch.equal(x[0], x[2])


# ---------------------------------------------------------------------------
# active masking, mixed first steps
# ---------------------------------------------------------------------------

def test_inactive_tenants_are_bitwise_inert():
    _, opt = _ttaps()
    active = torch.tensor([True, False, True])
    bank, ups_m, st_m, P_m = run_stacked(opt, 3, active=active)
    _, ups_f, st_f, _ = run_stacked(opt, 3)
    P0, _, _, _ = stacked_inputs(3)
    st0 = bank.init(P0)
    # tenant 1: its state is its init, its update zero, its params as given
    assert_equal_trees(tenant.tree_slot(st_m, 1), tenant.tree_slot(st0, 1))
    for up in ups_m:
        for x in up.values():
            assert torch.equal(x[1], torch.zeros_like(x[1]))
    new = bank.apply_updates(P_m, ups_m[0], active=active)
    for k in P0:
        assert torch.equal(new[k][1], P0[k][1])
    # the active tenants: the all-active run's, step by step
    for t in (0, 2):
        assert_equal_trees(tenant.tree_slot(st_m, t),
                           tenant.tree_slot(st_f, t))
        for um, uf in zip(ups_m, ups_f):
            for k in um:
                assert torch.equal(um[k][t], uf[k][t])
    assert st_m.step.tolist() == [STEPS, 0, STEPS]


def test_apply_updates_is_in_place_and_masks_params():
    _, opt = _ttaps()
    _, ups, _, _ = run_stacked(opt, 2, steps=1)
    P, _, _, _ = stacked_inputs(2)
    before = {k: v.clone() for k, v in P.items()}
    out = tenant.TenantBank.apply_updates(P, ups[0],
                                          active=np.array([True, False]))
    assert out is P
    for k in P:
        assert torch.equal(P[k][1], before[k][1])
        assert torch.equal(P[k][0], before[k][0] + ups[0][k][0])


def test_mixed_first_group_matches_sequential():
    """Tenant 0 at its first statistics step beside tenant 1 past it, in
    one update with one work mask: each slice equals its own sequential
    update (the bank splits the group by ``n_stats == 0``)."""
    _, opt = _ttaps()
    w = opt.uniform_work(True, True, False)
    data = [tenant_data(t) for t in range(2)]
    # tenant 1 takes one update first, alone
    states = []
    for t, (p, g, a, pg) in enumerate(data):
        st = opt.init(p)
        if t == 1:
            _, st = opt.update(g, st, p, acts=a, probe_grads=pg,
                               n_tokens=N_STAT, rng=None, work=w)
        states.append(st)
    bank = tenant.TenantBank(opt)
    P, G, A, PG = [tenant.tree_stack([d[i] for d in data])
                   for i in range(4)]
    st = tenant.tree_stack(states)
    ups, st = bank.update(G, st, P, acts=A, probe_grads=PG,
                          n_tokens=N_STAT, work=w)
    for t, (p, g, a, pg) in enumerate(data):
        want, want_st = opt.update(g, states[t], p, acts=a, probe_grads=pg,
                                   n_tokens=N_STAT, rng=None, work=w)
        for k in want:
            np.testing.assert_allclose(ups[k][t].numpy(), want[k].numpy(),
                                       atol=3e-4, rtol=1e-2)
        got_st = tenant.tree_slot(st, t)
        assert (got_st.step, got_st.n_stats) == (want_st.step,
                                                 want_st.n_stats)
        for name in want_st.factors:
            for side in "AG":
                np.testing.assert_allclose(
                    getattr(got_st.factors[name], side).D.numpy(),
                    getattr(want_st.factors[name], side).D.numpy(),
                    atol=1e-5, rtol=1e-3)
    assert st.step.tolist() == [1, 2]


# ---------------------------------------------------------------------------
# launches, plumbing
# ---------------------------------------------------------------------------

OPS = ("ea_syrk", "ns_step", "brand_panel", "cholqr2", "orthonormalize",
       "lowrank_apply", "precond_fused")


@pytest.mark.parametrize("variant", ["bkfac", "brkfac"])
def test_kernel_calls_per_update_do_not_grow_with_tenants(variant,
                                                          monkeypatch):
    """Every call of ``kernels/ops.py`` (the dispatch layer that launches
    the CUDA kernels on the card) counted over one update with the kernel
    route on: the same count at N = 1, 2 and 4 — the bank's
    O(#shape classes) launches, which the reference can only assert
    statically (test_launch_groups_static_in_tenant_count)."""
    from repro_torch.kernels import ops
    counts = {}
    for name in OPS:
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    _, opt = _ttaps(use_kernels=True, variant=variant)
    seen = {}
    for n in (1, 2, 4):
        P, G, A, PG = stacked_inputs(n)
        bank = tenant.TenantBank(opt)
        st = bank.init(P)
        per_step = []
        for s in range(2):
            counts.clear()
            _, st = bank.update(G, st, P, acts=A, probe_grads=PG,
                                n_tokens=N_STAT, work=work(opt, s))
            per_step.append(dict(counts))
        seen[n] = per_step
    assert seen[1] == seen[2] == seen[4]
    assert sum(seen[1][0].values()) > 0
    assert tenant.TenantBank(opt).launch_groups() == (
        len(opt.factor_buckets) + len(opt.precond_buckets))


def test_checkout_checkin_roundtrip():
    _, opt = _ttaps()
    P, _, _, _ = stacked_inputs(2)
    bank = tenant.TenantBank(opt)
    st = bank.init(P)
    one = bank.checkout(st, 1)
    assert isinstance(one.step, int)
    assert_equal_trees(bank.checkin(st, 1, one), st)
    # admit re-initializes a slot from fresh params
    p1 = tenant.tree_slot(P, 1)
    st2 = bank.admit(st, 0, p1)
    assert_equal_trees(tenant.tree_slot(st2, 0), opt.init(p1))


def test_tree_stack_unstack_roundtrip():
    trees = [{"a": torch.arange(3.0) + t, "n": t} for t in range(4)]
    stacked = tenant.tree_stack(trees)
    assert stacked["n"].dtype == tenant.COUNTER
    back = tenant.tree_unstack(stacked)
    for a, b in zip(trees, back):
        assert torch.equal(a["a"], b["a"]) and a["n"] == b["n"]
    # the reference's stack of the same trees has the same leaves
    ref = jtenant.tree_stack([{"a": jnp.arange(3.0) + t} for t in range(4)])
    np.testing.assert_array_equal(np.asarray(ref["a"]), stacked["a"].numpy())


def test_tree_select_picks_slices_bitwise():
    new = {"x": torch.randn(3, 2), "n": torch.tensor([5, 6, 7],
                                                     dtype=tenant.COUNTER)}
    old = {"x": torch.randn(3, 2), "n": torch.tensor([1, 2, 3],
                                                     dtype=tenant.COUNTER)}
    out = tenant.tree_select(np.array([True, False, True]), new, old)
    assert torch.equal(out["x"][1], old["x"][1])
    assert torch.equal(out["x"][0], new["x"][0])
    assert out["n"].tolist() == [5, 2, 7]


def test_bank_refuses_async_and_per_tap_optimizers():
    import dataclasses
    taps, opt = _ttaps()
    for kw in ({"bucketed": False}, {"async_heavy": True, "heavy_lag": 0}):
        cfg = dataclasses.replace(opt.cfg, **kw)
        with pytest.raises(ValueError):
            tenant.TenantBank(tkfac.Kfac(cfg, taps, device=CPU))
