"""Distributed curvature engine: shard the bucketed K-factor pipeline
across one or two mesh axes, on ``torch.distributed``.

Counterpart of ``src/repro/distributed/curvature.py``.  KAISA's idea on
the bucketed pipeline of ``core/buckets.py``:

  * each factor bucket's flat batch axis is partitioned across the mesh's
    **curvature axis** round-robin (``buckets.shard_perm``): slot ``s``
    lives on member ``s % N``, so every member owns an equal ``⌈B/N⌉``
    share of every bucket;
  * each member runs the SAME per-bucket program as the replicated path
    (``kfactor.bucket_factor_step``) on its local slots — stats, Brand
    and the scheduled heavy ranges cost 1/N of the replicated work;
  * the updated low-rank reps (U, λ, aux) are **all-gathered** (O(d·r)
    per factor), while the dense EA factor M (O(d²)) never leaves its
    owner.

With a second axis (``row_axis``) each bucket's dense M is also sharded
**by rows** there: a member holds (⌈B/N_curv⌉, d/N_rows, d).  Stats stay
exact on row blocks (``kfactor.ea_update_m_rows``); a heavy range gathers
only its slots' rows over the row axis, splits the range across the row
members and re-gathers the refreshed (U, λ) chunks.  ``compress_rank=q``
routes the U gather through rank-q PowerSGD factors
(``distributed/compress.py::compress_batched``, the same seeded basis on
every member; lossy, opt-in).  The async pipeline composes: each member
snapshots and lands only its local slots, and on a 2D mesh gathers the
live and in-flight M rows only on a step that fires or lands heavy work
on it.

**On a model mesh** (tensor parallelism: ``Kfac.model_shards``) a rank
holds its row block on "model" of every factor's U and, unless a row
axis takes M's rows, of its M (``kfac_state_sharding``): the per-bucket
program on the local slots is ``core/kfactor.py``'s row-block one, and
the (U, λ) gathers over the curvature axis move the rank's rows only.
Under FSDP (``ModelShards.fsdp``: the curvature axis is one of the axes
FSDP splits every leaf over) the members work on whole rows of their
slots, as on a data mesh (``Kfac._work_rows``); the engine keeps its M
and in-flight buffers in its own layout below, and each bucket's U, D and
aux are relaid from their FSDP blocks to whole for the bucket's step and
back (``Kfac``'s ``_HeldLayout``).

How ``shard_map`` becomes torch: one process is one mesh member (a
:class:`~repro_torch.launch.mesh.Mesh`); ``jax.lax.all_gather(x, axis,
tiled=True)`` is ``distributed/collectives.py::all_gather`` over the
axis's process group; ``jax.lax.axis_index`` is ``mesh.coord(axis)``; an
``in_specs=P(axis)`` operand is the member's own slice of the
device-major layout (:meth:`ShardPlan.local`), an ``out_specs=P()``
result the gathered tensor.  Every member runs the same bucket loop on
the same replicated operands, so the collectives line up.

**Where a member keeps its M.**  A per-bucket local stack:
``KfacState.shards[str(bi)]`` is the member's (⌈B/N⌉, rows, d) block of
the bucket's M in device-major order — pad rows included (a pad slot
wraps onto a real slot of another member and evolves as it does; its
results are never read back) — and the per-tap ``M`` leaves of such a
bucket are zero-size (…, 0, d) placeholders.  So the dense-M bytes a
member holds are exactly ``m_bytes()[1]``.  U, D and aux stay per tap and
replicated.  The in-flight buffers (``KfacState.inflight``) hold the
member's local slots only, their M row-blocked like the live one.
:meth:`CurvatureEngine.localize_state` and :meth:`gather_state` convert
between this layout and the one-device one (init, checkpoints, restores
onto another mesh); :meth:`state_sharding` wraps both for
``distributed/sharding.py``'s tree helpers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import buckets, kfactor
from repro_torch.core.kfactor import KFactorState
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import compress as compress_lib
from repro_torch.distributed import sharding as shd
from repro_torch.obs import trace as obs_trace

Tensor = torch.Tensor


def _take(x, idx):
    """Rows ``idx`` of a tensor or of every leaf of a state (``.map``)."""
    if hasattr(x, "map"):
        return x.map(lambda t: _take(t, idx))
    return x.index_select(0, torch.as_tensor(idx, device=x.device))


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Static layout of one bucket's batch axis on the curvature axis."""
    total: int                   # true bucket batch
    n: int                       # members on the curvature axis
    padded: int                  # total padded up to a multiple of n
    perm: Tuple[int, ...]        # device-major round-robin gather indices
    unperm: Tuple[int, ...]      # slot → device-major position

    @classmethod
    def build(cls, total: int, n: int) -> "ShardPlan":
        return cls(total=total, n=n,
                   padded=buckets.padded_total(total, n),
                   perm=tuple(buckets.shard_perm(total, n)),
                   unperm=tuple(buckets.shard_unperm(total, n)))

    @property
    def per_device(self) -> int:
        return self.padded // self.n

    def shard(self, x):
        """(total, …) → (padded, …) in device-major round-robin order (pad
        rows wrap onto real slots)."""
        return _take(x, self.perm)

    def unshard(self, x):
        """Inverse of :meth:`shard`; drops the pad rows."""
        return _take(x, self.unperm)

    def local(self, x, coord: int):
        """Member ``coord``'s rows of :meth:`shard` (its own slots)."""
        m = self.per_device
        return _take(x, self.perm[coord * m:(coord + 1) * m])


class CurvatureEngine:
    """Runs ``Kfac``'s bucketed factor work sharded over ``mesh[axis]``
    (bucket slots), optionally × ``mesh[row_axis]`` (dense-M rows).

    Attach with ``Kfac(cfg, taps, curvature=engine)``, ``opt.curvature =
    engine`` or :meth:`for_kfac`; ``Kfac.update`` delegates to
    :meth:`factor_work` whenever an engine is present (bucketed mode).
    The engine is static metadata (mesh, per-bucket ShardPlans, row-block
    sizes) and owns no tensors.  Its metadata needs only ``axis_names``
    and ``devices.shape`` of the mesh; running it needs a
    :class:`~repro_torch.launch.mesh.Mesh` this process is a member of."""

    def __init__(self, mesh, axis: str, factor_buckets,
                 row_axis: Optional[str] = None,
                 compress_rank: Optional[int] = None):
        if axis not in mesh.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}; "
                             f"axes: {mesh.axis_names}")
        if row_axis is not None and row_axis not in mesh.axis_names:
            raise ValueError(f"mesh has no row axis {row_axis!r}; "
                             f"axes: {mesh.axis_names}")
        if row_axis == axis:
            raise ValueError("row_axis must differ from the curvature "
                             f"(slot) axis, both were {axis!r}")
        self.mesh = mesh
        self.axis = axis
        sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
        self.n_devices = int(sizes[axis])
        self.row_axis = row_axis if (row_axis is not None
                                     and sizes[row_axis] > 1) else None
        self.n_rows = int(sizes[row_axis]) if self.row_axis else 1
        #: scheduler alignment: heavy ranges split across slots AND rows
        self.align = self.n_devices * self.n_rows
        self.compress_rank = (int(compress_rank)
                              if compress_rank else None)
        self.specs = tuple(b.spec for b in factor_buckets)
        self.plans = tuple(ShardPlan.build(b.total, self.n_devices)
                           for b in factor_buckets)
        #: per-bucket local row-block height of the dense M, or None when
        #: the bucket's M stays row-replicated
        self.row_blocks = tuple(
            (s.d // self.n_rows)
            if (self.row_axis is not None and s.needs_m
                and s.d % self.n_rows == 0) else None
            for s in self.specs)

    @classmethod
    def for_kfac(cls, opt, mesh, axis: str, row_axis: Optional[str] = None,
                 compress_rank: Optional[int] = None) -> "CurvatureEngine":
        eng = cls(mesh, axis, opt.factor_buckets, row_axis=row_axis,
                  compress_rank=compress_rank)
        opt.curvature = eng
        return eng

    # -- job accounting (benchmarks / logs) ---------------------------------
    def job_counts(self) -> Tuple[int, int]:
        """(replicated, per-device) factor-job slot counts."""
        rep = sum(p.total for p in self.plans)
        dev = sum(p.per_device for p in self.plans)
        return rep, dev

    def m_bytes(self, opt=None) -> Tuple[int, int]:
        """(replicated, per-device) dense-M bytes across all buckets;
        per-device M is ⌈B/N_curv⌉ · d/N_rows · d floats for row-sharded
        buckets (d/N_model rows for those ``opt`` holds by rows on a model
        axis)."""
        rep = dev = 0
        for spec, plan, rb in zip(self.specs, self.plans, self.row_blocks):
            if not spec.needs_m:
                continue
            rep += plan.total * spec.d * spec.d * 4
            mrows = None if opt is None else opt._m_rows(spec)
            rows = (rb if rb is not None else
                    mrows.rb if mrows is not None else spec.d)
            dev += plan.per_device * rows * spec.d * 4
        return rep, dev

    def collective_bytes(self) -> Dict[str, int]:
        """Per-full-refresh bytes of the (U, λ, aux) gathers: what the raw
        U gather moves (``uncompressed``) and what the engine ships
        (``on_wire``: rank-q (P, Q) pairs under ``compress_rank``)."""
        raw_u = wire_u = small = 0
        for spec, plan in zip(self.specs, self.plans):
            B, d, w = plan.padded, spec.d, spec.width
            raw_u += B * d * w * 4
            small += B * (w + kfactor.AUX_WIDTH) * 4
            if self.compress_rank is not None:
                q = min(self.compress_rank, d, w)
                wire_u += B * (d + w) * q * 4
            else:
                wire_u += B * d * w * 4
        return {"uncompressed": raw_u + small, "on_wire": wire_u + small}

    def describe(self) -> str:
        parts = [f"axis={self.axis} n={self.n_devices}"]
        if self.row_axis is not None:
            parts.append(f"rows={self.row_axis} n_rows={self.n_rows}")
        if self.compress_rank is not None:
            parts.append(f"compress_q={self.compress_rank}")
        for p, rb in zip(self.plans, self.row_blocks):
            tail = f" rb={rb}" if rb is not None else ""
            parts.append(f"[B={p.total}→{p.padded} "
                         f"/dev={p.per_device}{tail}]")
        return " ".join(parts)

    # -- this member's place -----------------------------------------------
    def _coord(self) -> int:
        return self.mesh.coord(self.axis)

    def _r0(self, rb: int) -> int:
        return self.mesh.coord(self.row_axis) * rb

    def _m_sharding(self, rb) -> shd.NamedSharding:
        """The local M block of a device-major (padded, d, d) stack."""
        return shd.NamedSharding(self.mesh, shd.P(
            self.axis, self.row_axis if rb is not None else None))

    # -- layout conversions ---------------------------------------------------
    def localize_state(self, opt, state):
        """A KfacState in the one-device format (on a model mesh: with
        the rank's row blocks of the factors) → this member's layout (no
        communication: every member holds that state).  The
        per-tap path (``bucketed=False``) runs replicated, as the
        reference's, so its state stays whole."""
        if not opt.cfg.bucketed:
            return state
        factors = {n: dataclasses.replace(ts) for n, ts in
                   state.factors.items()}
        shards = {}
        for bi, (bucket, plan, rb) in enumerate(zip(
                opt.factor_buckets, self.plans, self.row_blocks)):
            if not bucket.spec.needs_m:
                continue
            M = buckets.gather(bucket.entries, {
                (e.name, e.side): getattr(factors[e.name], e.side).M
                for e in bucket.entries})
            shards[str(bi)] = shd.local_slice(plan.shard(M),
                                              self._m_sharding(rb))
            del M
            for e in bucket.entries:
                st = getattr(factors[e.name], e.side)
                ph = st.M.new_zeros(tuple(st.M.shape[:-2])
                                    + (0, st.M.shape[-1]))
                setattr(factors[e.name], e.side,
                        dataclasses.replace(st, M=ph))
        inflight = {}
        for key, buf in state.inflight.items():
            bi = int(key)
            plan, rb = self.plans[bi], self.row_blocks[bi]
            loc = plan.local(buf, self._coord())
            if rb is not None:
                r0 = self._r0(rb)
                loc = dataclasses.replace(loc, M=loc.M[:, r0:r0 + rb].clone(
                    memory_format=torch.contiguous_format))
            inflight[key] = loc
        return dataclasses.replace(state, factors=factors, inflight=inflight,
                                   shards=shards)

    def gather_state(self, opt, state):
        """This member's layout → the one-device KfacState (on a model
        mesh: the rank's row blocks), on every member (collective over the
        engine's axes)."""
        if not state.shards:
            return state
        factors = {n: dataclasses.replace(ts) for n, ts in
                   state.factors.items()}
        for bi, (bucket, plan, rb) in enumerate(zip(
                opt.factor_buckets, self.plans, self.row_blocks)):
            key = str(bi)
            if key not in state.shards:
                continue
            M = coll.all_gather(state.shards[key], self.mesh,
                                    self.row_axis if rb is not None
                                    else None, dim=1)
            M = plan.unshard(coll.all_gather(M, self.mesh, self.axis))
            for (name, side), Me in buckets.scatter(bucket.entries,
                                                    M).items():
                st = getattr(factors[name], side)
                setattr(factors[name], side,
                        dataclasses.replace(st, M=Me.clone()))
        inflight = {}
        for key, buf in state.inflight.items():
            bi = int(key)
            plan, rb = self.plans[bi], self.row_blocks[bi]
            if rb is not None:
                buf = dataclasses.replace(buf, M=coll.all_gather(
                    buf.M, self.mesh, self.row_axis, dim=1))
            inflight[key] = plan.unshard(buf.map(
                lambda x: coll.all_gather(x, self.mesh, self.axis)))
        return dataclasses.replace(state, factors=factors, inflight=inflight,
                                   shards={})

    def global_template(self, opt, state):
        """Uninitialized one-device KfacState of a local one's shapes."""
        factors = {n: dataclasses.replace(ts) for n, ts in
                   state.factors.items()}
        for bi, bucket in enumerate(opt.factor_buckets):
            if not bucket.spec.needs_m:
                continue
            # the rows a member holds before the engine's own split (a
            # model axis's row block, or all d)
            mrows = opt._m_rows(bucket.spec)
            rows = bucket.spec.d if mrows is None else mrows.rb
            for e in bucket.entries:
                st = getattr(factors[e.name], e.side)
                d = st.M.shape[-1]
                setattr(factors[e.name], e.side, dataclasses.replace(
                    st, M=st.M.new_empty(tuple(st.M.shape[:-2])
                                         + (rows, d))))
        inflight = {}
        for key, buf in state.inflight.items():
            bucket = opt.factor_buckets[int(key)]
            total, d = bucket.total, bucket.spec.d

            def grow(x, f):
                shape = (total,) + tuple(x.shape[1:])
                if f == "M" and self.row_blocks[int(key)] is not None:
                    shape = (total, d, d)
                return x.new_empty(shape)
            inflight[key] = dataclasses.replace(buf, **{
                f.name: grow(getattr(buf, f.name), f.name)
                for f in dataclasses.fields(buf)})
        return dataclasses.replace(state, factors=factors, inflight=inflight,
                                   shards={})

    def state_sharding(self, opt) -> "EngineSharding":
        """This layout as a sharding object for ``distributed/sharding.py``
        (``localize`` / ``globalize`` / ``global_template``)."""
        return EngineSharding(self, opt)

    # -- the sharded factor work ---------------------------------------------
    def factor_work(self, opt, factors, inflight, shards, acts, probe_grads,
                    n_tokens, rng, first, work, draws=None, landing=None,
                    phi=None):
        """Drop-in for ``Kfac._bucketed_factor_work``: same operands, same
        per-slot numerics, 1/N of the factor work per member.  The bucket
        loop (operand collection, no-op skip, gather/scatter, draws) is
        Kfac's own — only the inner per-bucket program and the bucket
        layout (M from ``shards``) are substituted.  Pre-computed
        ``landing`` operands are a replicated-path feature and are
        rejected: the engine lands inside its own program.  Returns
        (factors, inflight, shards)."""
        if landing:
            raise ValueError("the distributed curvature engine computes "
                             "landings in-graph; overlapped landing "
                             "operands are a replicated-path feature")
        layout = _EngineLayout(opt, shards)
        use_kernel = opt.cfg.use_kernels

        def bucket_step(bi, bucket, st, X, bdraws, buf, landed):
            launch = work.launch[bi] if work.launch else ()
            land = work.land[bi] if work.land else ()
            return self._bucket_step(bucket.spec, self.plans[bi],
                                     self.row_blocks[bi], st, X, bdraws,
                                     first, work.stats, work.light,
                                     work.heavy[bi], launch, land, buf,
                                     use_kernel,
                                     opt._work_rows(bucket.spec))

        factors, inflight = opt._bucketed_factor_work(
            factors, inflight, acts, probe_grads, n_tokens, rng, first,
            work, draws=draws, phi=phi, layout=layout,
            bucket_step=bucket_step)
        return factors, inflight, layout.shards

    # -- gather helpers ---------------------------------------------------------
    def _gather_u(self, U_loc: Tensor) -> Tensor:
        """All-gather the local (B_loc, d, w) U blocks over the curvature
        axis — raw, or as rank-q PowerSGD factors (every member, the owner
        included, uses the decompressed result)."""
        if self.compress_rank is None:
            return coll.all_gather(U_loc, self.mesh, self.axis)
        Pl, Ql = compress_lib.compress_batched(U_loc, self.compress_rank)
        Pg = coll.all_gather(Pl, self.mesh, self.axis)
        Qg = coll.all_gather(Ql, self.mesh, self.axis)
        return (Pg @ Qg.transpose(-1, -2)).to(U_loc.dtype)

    def _gather_rep(self, plan: ShardPlan, st: KFactorState) -> KFactorState:
        """Gather the low-rank rep over the curvature axis into slot order;
        M keeps its shard."""
        with obs_trace.span("gather_rep"):
            g = lambda x: coll.all_gather(x, self.mesh, self.axis)
            U = plan.unshard(self._gather_u(st.U))
            D = plan.unshard(g(st.D))
            aux = plan.unshard(g(st.aux))
        return KFactorState(U=U, D=D, M=st.M, aux=aux)

    def _heavy_rows(self, spec, st: KFactorState, draws, llo: int, lhi: int,
                    urows=None) -> KFactorState:
        """One local heavy range on row-sharded M: gather the firing
        slots' rows to full (transient), split the range across the row
        members, re-gather the refreshed chunks.  No heavy op writes M.
        ``urows``: U's row block on a model axis (gathered where the op
        reads U, the rank's rows of the result kept)."""
        sub = st.map(lambda x: x[llo:lhi])
        Mfull = coll.all_gather(sub.M, self.mesh, self.row_axis, dim=1)
        subf = kfactor.whole_rows(spec, KFactorState(
            U=sub.U, D=sub.D, M=Mfull, aux=sub.aux), urows)
        dsub = None if draws is None else draws[llo:lhi]
        bh = lhi - llo
        if bh >= self.n_rows and bh % self.n_rows == 0:
            w = bh // self.n_rows
            o = self.mesh.coord(self.row_axis) * w
            chunk = subf.map(lambda x: x[o:o + w])
            out = kfactor.heavy_overwrite_batched(
                spec, chunk, None if dsub is None else dsub[o:o + w])
            g0 = lambda x: coll.all_gather(x, self.mesh, self.row_axis)
            U, D, aux = g0(out.U), g0(out.D), g0(out.aux)
        else:
            # range shorter than (or misaligned with) the row count: every
            # row member computes the whole range
            out = kfactor.heavy_overwrite_batched(spec, subf, dsub)
            U, D, aux = out.U, out.D, out.aux
        if urows is not None:
            U = urows.take(U)
        put = kfactor._put
        return KFactorState(U=put(st.U, llo, lhi, U),
                            D=put(st.D, llo, lhi, D), M=st.M,
                            aux=put(st.aux, llo, lhi, aux))

    def _stats_rows(self, spec, st: KFactorState, X: Tensor, rb: int,
                    first: bool) -> KFactorState:
        with obs_trace.span("stats_rows"):
            M = kfactor.ea_update_m_rows(st.M, X, self._r0(rb), rb,
                                         spec.rho, first)
        return KFactorState(U=st.U, D=st.D, M=M, aux=st.aux)

    def _bucket_step(self, spec, plan: ShardPlan, rb: Optional[int],
                     st: KFactorState, X: Tensor, draws, first: bool,
                     stats: bool, light: bool, ranges, launch, land, buf,
                     use_kernel: bool, urows=None):
        """One bucket's step on this member: the shared per-bucket program
        on its ⌈B/N⌉ local slots, then the all-gather of the O(d·r)
        low-rank rep; the dense M — live and in flight — stays local (and
        row-blocked with ``rb``).  ``st`` holds the global U/D/aux and,
        for a bucket that keeps M, the member's M block.  ``urows``: the
        model axis's row block of U (and of M where ``rb`` is None)."""
        mrows = urows if (rb is None and spec.needs_m) else None
        loc = lambda r: buckets.localize_ranges(r, plan.total, plan.n)
        local_heavy, local_launch, local_land = (loc(ranges), loc(launch),
                                                 loc(land))
        c = self._coord()
        M_in = st.M
        stl = KFactorState(U=plan.local(st.U, c), D=plan.local(st.D, c),
                           M=M_in if spec.needs_m else plan.local(M_in, c),
                           aux=plan.local(st.aux, c))
        Xl = plan.local(X, c)
        dl = None if draws is None else plan.local(draws, c)

        def finish(stl):
            out = self._gather_rep(plan, stl)
            return out if spec.needs_m else dataclasses.replace(out, M=M_in)

        if buf is None:
            if rb is None:
                stl = kfactor.bucket_factor_step(
                    spec, stl, Xl, first, stats, light, local_heavy,
                    use_kernel, draws=dl, rows=urows, m_rows=mrows)
                return finish(stl), None
            if stats:
                stl = self._stats_rows(spec, stl, Xl, rb, first)
            if (light or local_heavy) and spec.mode in kfactor._HAS_BRAND:
                with obs_trace.span("light_brand"):
                    stl = kfactor.brand_step(spec, stl, Xl, first,
                                             use_kernel, urows)
            for llo, lhi in local_heavy:
                with obs_trace.span(f"heavy_{llo}_{lhi}"):
                    stl = self._heavy_rows(spec, stl, dl, llo, lhi, urows)
            return finish(stl), None

        if rb is None:
            stl, buf = kfactor.bucket_factor_step_async(
                spec, stl, Xl, first, stats, light, local_heavy,
                local_launch, local_land, buf, use_kernel, draws=dl,
                rows=urows, m_rows=mrows)
            return finish(stl), buf
        # 2D: row-block stats first (exact); only when this member's slots
        # fire or land heavy work, gather the live and in-flight M rows
        # around the unchanged async program and re-slice both
        if stats:
            stl = self._stats_rows(spec, stl, Xl, rb, first)
        if local_heavy or local_land:
            g1 = lambda x: coll.all_gather(x, self.mesh, self.row_axis,
                                               dim=1)
            stf = dataclasses.replace(stl, M=g1(stl.M))
            buff = dataclasses.replace(buf, M=g1(buf.M))
            stf, buff = kfactor.bucket_factor_step_async(
                spec, stf, Xl, first, False, light, local_heavy,
                local_launch, local_land, buff, use_kernel, draws=dl,
                rows=urows)
            r0 = self._r0(rb)
            s1 = lambda x: x[:, r0:r0 + rb].clone(
                memory_format=torch.contiguous_format)
            stl = dataclasses.replace(stf, M=s1(stf.M))
            buf = dataclasses.replace(buff, M=s1(buff.M))
        else:
            stl, buf = kfactor.bucket_factor_step_async(
                spec, stl, Xl, first, False, light, (), local_launch, (),
                buf, use_kernel, draws=dl, rows=urows)
        return finish(stl), buf

    # -- telemetry ------------------------------------------------------------
    def inv_error_proxy(self, opt, bi: int, spec, st: KFactorState, phi
                        ) -> Tensor:
        """``Kfac._inv_error_proxy`` on the sharded layout: each member
        forms the residual rows it holds for its own slots, the row
        members sum them, the curvature members take the worst slot —
        the replicated proxy's value on every member."""
        plan, rb = self.plans[bi], self.row_blocks[bi]
        urows = opt._work_rows(spec)
        c = self._coord()
        d = spec.d
        k = min(8, d)
        rows = torch.arange(k, device=st.M.device) * max(1, d // k)
        U = st.U if urows is None else urows.gather(st.U)
        loc = KFactorState(U=plan.local(U, c), D=plan.local(st.D, c),
                           M=st.M, aux=plan.local(st.aux, c))
        # M's rows held by this member: a row axis's block, a model
        # axis's, or all
        axis, r0, hb = self.row_axis, 0, d
        if rb is not None:
            r0, hb = self._r0(rb), rb
        elif urows is not None:
            axis, r0, hb = urows.axis, urows.r0, urows.rb
        mine = (rows >= r0) & (rows < r0 + hb)
        grows = rows[mine]
        Mrows = st.M[:, grows - r0, :]
        sq = opt._residual_sq(spec, Mrows, grows, loc, phi)
        coll.all_reduce(sq, self.mesh, axis)
        worst = torch.max(torch.sqrt(sq / k)).reshape(1)
        return coll.all_reduce(worst, self.mesh, self.axis,
                                   op=dist.ReduceOp.MAX)[0]


class _EngineLayout:
    """The bucket layout of an engine-attached optimizer: a bucket that
    keeps M takes it from (and returns it to) this member's local stack;
    U/D/aux are gathered and scattered per tap as the optimizer's own
    layout does (on one device; under FSDP relaid from and to their
    blocks, ``Kfac``'s ``_HeldLayout``).  The in-flight buffers are the
    engine's (its members' slots) and are not moved."""

    def __init__(self, opt, shards: Dict[str, Tensor]):
        from repro_torch.core import kfac as kfac_lib
        self._base = (kfac_lib._HeldLayout(opt) if opt._fsdp
                      else kfac_lib.BucketLayout)
        self.shards = dict(shards)
        self._bi = {b.entries: bi for bi, b in enumerate(opt.factor_buckets)}
        self.gather = self._base.gather
        self.scatter = self._base.scatter
        self.ranges = self._base.ranges
        self.per_slot = self._base.per_slot
        self.release = self._base.release

    @staticmethod
    def inflight(bi, buf, to_work: bool):
        return buf

    def gather_states(self, entries, states):
        st = self._base.gather_states(entries, states)
        key = str(self._bi[tuple(entries)])
        if key not in self.shards:
            return st
        return dataclasses.replace(st, M=self.shards[key])

    def scatter_states(self, entries, batched, old):
        key = str(self._bi[tuple(entries)])
        if key in self.shards:      # the per-tap leaves keep (…, 0, d)
            self.shards[key] = batched.M
            batched = dataclasses.replace(batched, M=batched.M.new_zeros(
                (batched.U.shape[0], 0, batched.M.shape[-1])))
        return self._base.scatter_states(entries, batched, old)


@dataclasses.dataclass(frozen=True)
class EngineSharding:
    """The engine's layout of a KfacState as a sharding object (see
    ``distributed/sharding.py::localize``)."""
    engine: CurvatureEngine
    opt: object

    def localize(self, state):
        return self.engine.localize_state(self.opt, state)

    def globalize(self, state):
        return self.engine.gather_state(self.opt, state)

    def global_template(self, state):
        return self.engine.global_template(self.opt, state)
