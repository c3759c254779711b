"""TenantBank: N independent per-tenant K-FAC optimizer states in one
stacked state.

Counterpart of ``src/repro/core/tenant.py``.  The multi-tenant service
(``serve/service.py``) holds one parameter set and optimizer state per
tenant.  Every tenant shares the model, so their K-factors share the
shape classes, and the cross-layer bucketing that makes a step's launches
O(#shape classes) (``core/buckets.py``) extends across tenants.  The
reference runs ``jax.vmap(Kfac.update)`` over a leading tenant axis; a
``vmap`` cannot batch through the port's kernel launches, so here **the
tenant axis joins each bucket's batch**: a bucket of ``total`` slots
becomes one of ``total × Na`` slots for the Na tenants that step, laid
out slot-major (slot s of tenant j at ``s·Na + j``), and the bucket's
one stats / Brand / heavy / preconditioning call serves them all.  The
launches of an update do not depend on N.

Semantics, as the reference's:

* Per-tenant independence: each tenant's slice evolves as its own
  ``Kfac.update`` run would (allclose: batched products may sum in
  another order), with its own step, ``n_stats`` and phase, learning
  rate and damping ratio (a per-slot φ reaches the kernels as their
  per-batch λ), weight decay and momentum, clip (its own global norm)
  and AdamW fallback with its own bias-correction count.  Heavy draws
  come per tenant: one ``torch.Generator`` each, or injected.
* N = 1 without a mask is **bit for bit** the plain ``Kfac.update``: the
  bank squeezes the tenant axis and calls it.
* ``active``: only the active tenants' slots are gathered into the
  buckets; an inactive tenant's state and parameters are not written at
  all (bitwise unchanged), and its update is zero.
* Tenants at their first statistics step (``n_stats == 0``) and tenants
  past it run as two stacked updates: the Brand and EA programs branch on
  that flag for a whole bucket.
* A scheduler range of a bucket's slots maps to one range of the
  widened bucket (``lo·Na`` … ``hi·Na``), whatever N is.

Differences from the reference, for memory at full width (9.1 GB of
parameters a gemma3-4b tenant): :meth:`TenantBank.update` consumes the
state it is given — untouched tenants' slots and the fallback moments
are updated in place — so the caller keeps only the returned state; its
gradients may be a sequence of N per-tenant tensors instead of a
stacked one (no stacking copy; ``None`` for an inactive tenant); and
:meth:`TenantBank.apply_updates` adds in place.  Host counters (Python
ints in a plain ``KfacState``) stack into (N,) int32 CPU tensors, the
reference's (N,) int32 arrays, and slot back into ints.  The bank runs
the bucketed synchronous program: a per-tap (``bucketed=False``) or
async (``async_heavy``) optimizer is refused.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.core import kfac as kfac_lib
from repro_torch.core import kfactor, schedule
from repro_torch.optim import adamw as adamw_lib
from repro_torch.optim import base as optbase

Tensor = torch.Tensor

#: dtype of a stacked host counter (the reference's int32 step arrays)
COUNTER = torch.int32


def tree_map(fn, *trees):
    """``fn`` over the leaves (tensors and Python ints) of nests of dicts
    and dataclasses; ``None`` stays ``None``."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, (Tensor, int)):
        return fn(*trees)
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if dataclasses.is_dataclass(t0) and not isinstance(t0, type):
        return dataclasses.replace(t0, **{
            f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(t0)})
    raise TypeError(f"tree_map: unsupported node {type(t0).__name__}")


def _leaves(tree) -> List[Tensor]:
    out: List[Tensor] = []
    tree_map(lambda x: out.append(x) if isinstance(x, Tensor) else None,
             tree)
    return out


def _lead_dim(tree) -> int:
    leaves = _leaves(tree)
    if not leaves:
        raise ValueError("a tree without tensors has no tenant axis")
    return int(leaves[0].shape[0])


def _is_counter(x: Tensor) -> bool:
    return x.dtype == COUNTER and x.dim() == 1 and x.device.type == "cpu"


def tree_stack(trees: Sequence[Any]) -> Any:
    """N per-tenant trees → one tree with a leading tenant axis (Python
    ints become an (N,) int32 CPU tensor)."""
    def stack(*xs):
        if isinstance(xs[0], Tensor):
            return torch.stack([x.detach() for x in xs])
        return torch.tensor(xs, dtype=COUNTER)
    return tree_map(stack, *trees)


def tree_slot(bank_tree: Any, i: int) -> Any:
    """One tenant's tree out of slot ``i`` (views; counters as ints)."""
    def slot(x):
        return int(x[i]) if _is_counter(x) else x[i]
    return tree_map(slot, bank_tree)


def tree_unstack(tree: Any, n: Optional[int] = None) -> list:
    """Inverse of :func:`tree_stack`."""
    n = _lead_dim(tree) if n is None else n
    return [tree_slot(tree, i) for i in range(n)]


def _mask(active, n: int) -> Tensor:
    return torch.as_tensor(active, dtype=torch.bool).reshape(n).cpu()


def tree_select(mask, new: Any, old: Any) -> Any:
    """Per-tenant select: ``mask`` (N,) bool picks ``new``'s slice where
    True, ``old``'s where False — bit-exact on both sides."""
    def sel(a, b):
        m = _mask(mask, a.shape[0]).to(a.device)
        return torch.where(m.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
    return tree_map(sel, new, old)


def tree_insert(bank_tree: Any, i: int, one: Any) -> Any:
    """A copy of the bank tree with slot ``i`` set to one tenant's
    (unstacked) tree."""
    def put(b, x):
        b = b.clone()
        b[i] = x if not isinstance(x, Tensor) else x.to(b.dtype)
        return b
    return tree_map(put, bank_tree, one)


def _expand(x):
    """A one-tenant stack of a leaf: a view for a tensor."""
    return x[None] if isinstance(x, Tensor) else torch.tensor(
        [x], dtype=COUNTER)


def _take(state, field: str):
    """A consumed state's field, handed over: the state keeps no
    reference to it."""
    value = getattr(state, field)
    setattr(state, field, None)
    return value


def _slot_dict(d: Dict[str, Any], i: int) -> Dict[str, Any]:
    return {k: v[i] for k, v in d.items()}


class TenantLayout(kfac_lib.BucketLayout):
    """A bucket's batch over the tenants ``idx`` of an N-tenant bank:
    slot s of the j-th of them at ``s·Na + j``.  Leaves are (N, *stack,
    *core) tensors or sequences of N per-tenant (*stack, *core) ones;
    only the listed tenants are read.  With every tenant listed in order
    the scattered leaves are views of the bucket's result; otherwise they
    are written into the tenants' slots of the old leaves."""

    def __init__(self, n: int, idx: Sequence[int]):
        self.n = n
        self.idx = list(idx)
        self.na = len(self.idx)
        self.full = self.idx == list(range(n))

    def ranges(self, ranges):
        return tuple((lo * self.na, hi * self.na) for lo, hi in ranges)

    def per_slot(self, value, total: int):
        return value.repeat(total)

    def release(self, leaves, keys) -> None:
        """Drop the listed tenants' entries of per-tenant gradient lists
        (the caller gave them up): their memory goes as the update
        proceeds."""
        for k in keys:
            if isinstance(leaves[k], list):
                for i in self.idx:
                    leaves[k][i] = None

    def gather(self, entries, leaves):
        e0 = entries[0]
        x0 = leaves[(e0.name, e0.side)][self.idx[0]]
        core = tuple(x0.shape[len(e0.stack):])
        total = entries[-1].offset + entries[-1].count
        out = torch.empty((total, self.na) + core, dtype=x0.dtype,
                          device=x0.device)
        for e in entries:
            x = leaves[(e.name, e.side)]
            for j, i in enumerate(self.idx):
                out[e.offset:e.offset + e.count, j] = x[i].reshape(
                    (e.count,) + core)
        return out.reshape((total * self.na,) + core)

    def scatter(self, entries, batched):
        core = tuple(batched.shape[1:])
        v = batched.reshape((-1, self.na) + core)
        return {(e.name, e.side): v[e.offset:e.offset + e.count]
                .transpose(0, 1).reshape((self.na,) + tuple(e.stack) + core)
                for e in entries}

    def gather_states(self, entries, states):
        field = lambda f: self.gather(entries, {
            (e.name, e.side): getattr(states[(e.name, e.side)], f)
            for e in entries})
        return kfactor.KFactorState(U=field("U"), D=field("D"),
                                    M=field("M"), aux=field("aux"))

    def scatter_states(self, entries, batched, old):
        fields = ("U", "D", "M", "aux")
        parts = {f: self.scatter(entries, getattr(batched, f))
                 for f in fields}
        out = {}
        for e in entries:
            key = (e.name, e.side)
            new = kfactor.KFactorState(**{f: parts[f][key] for f in fields})
            if not self.full:
                self.write(old[key], new)
                new = old[key]
            out[key] = new
        return out

    def write(self, old, new) -> None:
        """Copy the listed tenants' slices of ``new`` (Na, …) into their
        slots of ``old`` (N, …), leaf by leaf."""
        def put(o, x):
            for j, i in enumerate(self.idx):
                o[i].copy_(x[j])
        tree_map(put, old, new)


class TenantBank:
    """N stacked, independent optimizer states over one shared ``Kfac``.

    The bank owns the stacked-state math, not tenant bookkeeping
    (admission, naming, queues: ``serve/service.py``):

      ``init(stacked_params)``   → stacked KfacState
      ``update(grads, state, params, …, work, active=None)``
                                 → (stacked updates, stacked state)
      ``apply_updates(params, updates, active=None)`` → params, in place
    """

    def __init__(self, opt: kfac_lib.Kfac):
        if not opt.cfg.bucketed or opt.cfg.async_heavy:
            raise ValueError("TenantBank runs the bucketed synchronous "
                             "program: bucketed=True, async_heavy=False")
        self.opt = opt

    # -- construction ---------------------------------------------------------

    def init(self, stacked_params) -> kfac_lib.KfacState:
        """Stacked state from stacked params (leading tenant axis)."""
        n = _lead_dim(stacked_params)
        return tree_stack([self.opt.init(_slot_dict(stacked_params, i))
                           for i in range(n)])

    @staticmethod
    def n_tenants(stacked_state: kfac_lib.KfacState) -> int:
        return int(stacked_state.step.shape[0])

    # -- the stacked update ---------------------------------------------------

    def update(self, grads, state: kfac_lib.KfacState, params, *, acts,
               probe_grads, n_tokens, rngs=None,
               work: schedule.StepWork, active=None, damping_scale=None,
               draws=None):
        """One stacked optimizer step over the tenant axis.

        ``params`` are (N, …) tensors; ``acts`` and ``probe_grads`` (N,
        *stack, n_stat, d) tensors; ``grads`` (N, …) tensors or sequences
        of N per-tenant tensors.  ``rngs`` is a sequence of N generators
        (or None: the global one) and ``draws`` an optional sequence of N
        per-tenant ``{bucket index: draws}`` (the parity tests inject the
        reference's).  ``work`` is one mask for the whole call (group
        tenants by mask first: :func:`repro_torch.core.schedule.
        group_by_work`); ``active`` an optional (N,) bool vector;
        ``damping_scale`` an optional scalar or (N,) vector.  Consumes
        ``state`` (see the module docstring), and the entries of gradient
        lists: each is dropped once it has been read.  N = 1 with no mask
        is the plain ``Kfac.update``, bit for bit."""
        n = self.n_tenants(state)
        if n == 1 and active is None:
            scale = None if damping_scale is None else float(
                torch.as_tensor(damping_scale).reshape(-1)[0])
            updates, new_state = self.opt.update(
                _slot_dict(grads, 0), tree_slot(state, 0),
                _slot_dict(params, 0), acts=_slot_dict(acts, 0),
                probe_grads=_slot_dict(probe_grads, 0), n_tokens=n_tokens,
                rng=None if rngs is None else rngs[0], work=work,
                draws=None if draws is None else draws[0],
                damping_scale=scale)
            return ({k: u[None] for k, u in updates.items()},
                    tree_map(_expand, new_state))
        mask = (torch.ones(n, dtype=torch.bool) if active is None
                else _mask(active, n))
        scales = ([1.0] * n if damping_scale is None else
                  torch.as_tensor(damping_scale, dtype=torch.float32)
                  .broadcast_to((n,)).tolist())
        n_stats = state.n_stats.tolist()
        by_first: Dict[bool, List[int]] = {}
        for i in range(n):
            if mask[i]:
                by_first.setdefault(n_stats[i] == 0, []).append(i)
        parts = []
        for first in sorted(by_first):
            group = by_first[first]
            ups, state = self._update_group(
                grads, state, params, acts, probe_grads, n_tokens, rngs,
                work, group, first, scales, draws)
            parts.append((group, ups))
        if len(parts) == 1 and parts[0][0] == list(range(n)):
            return parts[0][1], state
        updates = {}
        for k, p in params.items():
            u = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for group, ups in parts:
                for j, i in enumerate(group):
                    u[i] = ups[k][j]
            updates[k] = u
        return updates, state

    def _update_group(self, grads, state, params, acts, probe_grads,
                      n_tokens, rngs, work, group, first, scales, draws):
        """The stacked update of tenants ``group`` (all at the same
        ``first``) → ({key: (Na, …) update}, state)."""
        opt, cfg = self.opt, self.opt.cfg
        dev = opt.device
        n = self.n_tenants(state)
        na = len(group)
        lay = TenantLayout(n, group)
        steps = state.step.tolist()
        lrs = [cfg.lr(steps[i]) for i in group]
        phis = [cfg.damping_phi(steps[i]) for i in group]
        phis = [p if scales[i] == 1.0 else p * scales[i]
                for p, i in zip(phis, group)]
        phi = torch.tensor(phis, dtype=torch.float32, device=dev)

        # the fallback first: its fresh moments and update are the largest
        # transients, and nothing of the factor work is alive yet
        fb = opt._fallback
        fbs = state.fallback
        fb_steps = fbs.step.tolist()
        updates: Dict[str, Tensor] = {}
        for k in fbs.mu:
            out = None
            for j, i in enumerate(group):
                u, m, v = fb.leaf(grads[k][i], fbs.mu[k][i], fbs.nu[k][i],
                                  params[k][i], fb_steps[i])
                fbs.mu[k][i].copy_(m)
                fbs.nu[k][i].copy_(v)
                if out is None:
                    out = torch.empty((na,) + tuple(u.shape), dtype=u.dtype,
                                      device=u.device)
                out[j] = u
                del u, m, v
            updates[k] = out
        lay.release(grads, list(fbs.mu))

        # heavy draws: each tenant's from its own generator in bucket
        # order (the draws its own run takes), or injected
        wdraws = {}
        for bi, b in enumerate(opt.factor_buckets):
            if not (work.heavy[bi] and kfactor.needs_draws(b.spec)):
                continue
            per = []
            for i in group:
                d = None if draws is None or draws[i] is None \
                    else draws[i].get(bi)
                if d is None:
                    d = kfactor.draw_heavy(b.spec, b.total,
                                           None if rngs is None else rngs[i],
                                           dev)
                per.append(d.to(dev))
            wdraws[bi] = torch.stack(per, 1).reshape(
                (b.total * na,) + tuple(per[0].shape[1:]))

        # the old states are handed over (their only reference), so each
        # bucket's goes as its new one lands
        factors, _ = opt._bucketed_factor_work(
            _take(state, "factors"), {}, acts, probe_grads, n_tokens, None,
            first, work, draws=wdraws, layout=lay)
        S_all = opt._bucketed_precondition(factors, grads, acts,
                                           probe_grads, phi, layout=lay)
        mom = state.momentum
        for name, t in opt.taps.items():
            S = S_all.pop(name)
            P = params[t.param_path]
            for j, i in enumerate(group):
                S[j].add_(cfg.weight_decay
                          * P[i].detach().to(torch.float32))
                if mom is not None:
                    m = cfg.momentum * mom[name][i] + S[j]
                    mom[name][i].copy_(m)
                    S[j].copy_(-lrs[j] * m)
                else:
                    S[j].mul_(-lrs[j])
            updates[t.param_path] = S
        updates = {k: updates[k] for k in params}     # parameter order
        if cfg.clip > 0:
            for j in range(na):
                optbase.clip_by_global_norm_(
                    {k: u[j] for k, u in updates.items()}, cfg.clip)

        def bump(x, by):
            x = x.clone()
            for i in group:
                x[i] = by(int(x[i]))
            return x
        new_state = kfac_lib.KfacState(
            step=bump(state.step, lambda s: s + 1),
            n_stats=bump(state.n_stats, lambda s: s + int(work.stats)),
            phase=bump(state.phase, lambda s: (s + 1) % opt._cycle),
            factors=factors, momentum=mom,
            fallback=adamw_lib.AdamWState(
                step=bump(fbs.step, lambda s: s + 1), mu=fbs.mu, nu=fbs.nu),
            inflight={})
        return updates, new_state

    @staticmethod
    @torch.no_grad()
    def apply_updates(params, updates, active=None):
        """params += updates, in place (the stacked ``optbase.
        apply_updates``); with ``active``, an inactive tenant's params are
        not written at all.  Returns ``params``."""
        for k, p in params.items():
            u = updates[k]
            if active is None:
                p.add_(u.to(p.dtype))
                continue
            for i in torch.nonzero(_mask(active, p.shape[0])).flatten():
                p[int(i)].add_(u[int(i)].to(p.dtype))
        return params

    # -- per-tenant access ----------------------------------------------------

    def checkout(self, state: kfac_lib.KfacState, i: int
                 ) -> kfac_lib.KfacState:
        """One tenant's plain KfacState (views of its slot)."""
        return tree_slot(state, i)

    def checkin(self, state: kfac_lib.KfacState, i: int,
                one: kfac_lib.KfacState) -> kfac_lib.KfacState:
        """A copy of the stacked state with slot ``i`` set to ``one``."""
        return tree_insert(state, i, one)

    def admit(self, state: kfac_lib.KfacState, i: int, params_i
              ) -> kfac_lib.KfacState:
        """(Re)initialize slot ``i`` from that tenant's params."""
        return self.checkin(state, i, self.opt.init(params_i))

    def steps(self, state: kfac_lib.KfacState) -> Tensor:
        """(N,) per-tenant step counters."""
        return state.step

    def launch_groups(self) -> int:
        """Launch groups of one stacked step — by construction
        independent of N (the O(#shape-classes) claim; the launches
        themselves are counted in tests/test_torch_tenant.py)."""
        return len(self.opt.factor_buckets) + len(self.opt.precond_buckets)
