"""Step builders for training, prefill and decode — shared by the trainer
CLI and the serving stack.

Counterpart of ``src/repro/launch/steps.py``.  The reference's abstract
values (``jax.eval_shape``) are tensors on the meta device here:
``abstract_params`` and ``abstract_opt`` are the port's own containers (a
flat parameter dict, a ``KfacState``) over meta tensors, ``batch_specs``
and a decode step's ``arg_specs`` meta tensors of the reference's shapes
and dtypes; nothing is drawn or allocated for them.  With a mesh
(anything with ``axis_names`` and ``devices.shape`` for the abstract
trees; a ``launch/mesh.py`` mesh to run) ``in_shardings`` and
``out_shardings`` are ``distributed/sharding.py`` shardings of those
trees, the reference's rules.

**Running on a mesh.**  A mesh whose model axis is 1 runs data-parallel,
as the reference's GSPMD program does: the batch is split over every
axis but "model" (``shard_policy_for``, ``batch_sharding``), the
parameters are replicated, and a built step takes this rank's block of
the global batch (``distributed/sharding.py::local_slice`` under
``in_shardings``; a decode step's cache and tokens likewise under
``cache_sharding``) and returns this rank's rows of the logits, per
``out_shardings``.  The numbers are the reference's one-device step on
the global batch: the loss, the taps' statistics rows and the gradients
are summed over the data axes (``train/loop.py::kfac_grads``), so each
rank runs 1/N of the model work.  A curvature axis (``dist``/
``curvature_axis``) shards the factor work through the distributed
curvature engine, whose inputs are then the global batch's taps.

A model axis larger than 1 runs tensor-parallel under ``plan="tp"``
(``models/sharding_policy.py``): each rank holds its block of every
leaf ``params_sharding`` shards (``LM.init`` draws the whole tree and
keeps the rank's blocks; ``localize`` under ``in_shardings[0]`` does the
same to a given one), the layers run Megatron-style with
sequence-parallel residuals, and the optimizer (``Kfac.model_shards``)
holds the rank's row block of every factor whose rows the model axis
divides (U and M rows on "model", D replicated: the reference's
``kfac_state_sharding``), runs the factor work on those rows and
preconditions each sharded gradient on the rows of the factor its
sharded dimension matches, with no gradient gathered whole.  The numbers
are the reference's one-device step.

``in_shardings`` and ``out_shardings`` are the layouts the port's step
takes and returns; a rank localizes its arguments under them.  They are
the reference's rules but in one place: the "hd" decode cache has its
head dim on "model" (the reference's in-sharding puts that cache's
sequence there and re-lays it out inside the step).  Prefill returns the rank's
vocabulary block of the logits, decode the whole logits; the decode
cache is read in its layout ("seq", "heads", "hd"), and the
long-context decode (``long_500k``: B = 1, the cache's sequence
over every axis) combines its partial softmaxes over the mesh.

``plan="fsdp"`` runs FSDP over the whole mesh: the batch is split over
every axis, each rank holds its block of every ≥ 2-D leaf of the
parameters and of the optimizer state by ``params_sharding_fsdp``'s rule
(its largest dimension the mesh divides), each layer gathers its weights
as it runs (``models/lm.py``; their gradients reduce-scattered), and the
optimizer works on its blocks (``Kfac`` under ``ModelShards.fsdp``: the
factor work and the preconditioning on factor rows, as under tensor
parallelism, each bucket's other leaves relaid for that bucket only).
With ``async_heavy`` each bucket's in-flight buffer is held by the same
rule and is whole while its bucket steps.  A curvature axis (``dist``/
``curvature_axis``) runs the factor work through the distributed
curvature engine on whole rows of each member's slots: the engine keeps
each bucket's dense M, live and in flight, in its own layout
(``KfacState.shards``, its members' in-flight slots), and the state's
sharding (``in_shardings[1]``) is FSDP's composed with the engine's
(``sharding.Composed``).  The numbers are the reference's one-device
step.

A built step runs eagerly on ``device`` (the card unless the caller asks
for another).  ``default_kfac_config`` keeps the reference's
``use_kernels=False``: the Brand update and the preconditioning run in
plain PyTorch, as the reference's run in plain ``jnp``; only a dense
factor's EA absorb goes through ``ops.ea_syrk`` always (the RSVD and NS
heavy ops through their kernels), as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from repro_torch import device as device_lib
from repro_torch import specs as specs_lib
from repro_torch.configs.base import ArchConfig, SHAPES, ShapeCell
from repro_torch.core import kfac as kfac_lib
from repro_torch.core import policy as policy_lib
from repro_torch.distributed import sharding as shd
from repro_torch.models import layers
from repro_torch.models.lm import LM
from repro_torch.models.sharding_policy import NO_SHARD, ShardPolicy
from repro_torch.optim import base as optbase
from repro_torch.train import loop as loop_lib

META = torch.device("meta")


def _axis_sizes(mesh) -> Tuple[Tuple[str, int], ...]:
    return tuple((a, int(s)) for a, s in zip(mesh.axis_names,
                                             mesh.devices.shape))


def shard_policy_for(mesh=None, shard_kv_seq: bool = False,
                     seq_shard_residual: bool = True) -> ShardPolicy:
    """The reference's policy for ``mesh``: data axes = every axis but
    "model", tensor axis = "model" when present; ``NO_SHARD`` without a
    mesh."""
    if mesh is None:
        return NO_SHARD
    dp = tuple(a for a in mesh.axis_names if a != "model")
    tp = "model" if "model" in mesh.axis_names else None
    return ShardPolicy(dp=dp, tp=tp, seq_shard_residual=seq_shard_residual,
                       shard_kv_seq=shard_kv_seq,
                       axis_sizes=_axis_sizes(mesh), mesh=mesh)


def default_kfac_config(arch: ArchConfig, variant: str = "bkfac",
                        use_kernels: bool = False) -> kfac_lib.KfacConfig:
    """The reference's LM defaults: r 256, max_dense_dim 8192, lr 0.3,
    damping 0.1, weight decay 7e-4, clip 0.07, the pretraining cadence
    (T_updt = T_brand = 25, T_inv = T_rsvd = 250, T_corct = 500) and an
    AdamW fallback at 1e-3.  ``arch`` is unused, as in the reference."""
    pol = policy_lib.PolicyConfig(variant=variant, r=256,
                                  max_dense_dim=8192)
    return kfac_lib.KfacConfig(
        policy=pol,
        lr=optbase.constant(0.3),
        damping_phi=optbase.constant(0.1),
        weight_decay=7e-4, clip=0.07,
        use_kernels=use_kernels,
        T_updt=25, T_inv=250, T_brand=25, T_rsvd=250, T_corct=500,
        fallback_lr=optbase.constant(1e-3))


@dataclasses.dataclass
class BuiltTrain:
    lm: LM
    opt: kfac_lib.Kfac
    step_fn: Any                 # (params, opt_state, batch, rng) -> ...
    abstract_params: Any
    abstract_opt: Any
    in_shardings: Any
    out_shardings: Any
    batch_specs: Dict[str, torch.Tensor]


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_batch_specs(arch: ArchConfig, cell: ShapeCell
                      ) -> Dict[str, torch.Tensor]:
    """The training batch as meta tensors (the reference's int32 tokens
    and fp32 frames / embeddings)."""
    B, T = cell.global_batch, cell.seq_len
    i32, f32 = torch.int32, torch.float32
    if arch.is_encdec:
        Td = max(T // arch.dec_ratio, 8)
        return {"frames": _spec((B, T, arch.d_model), f32),
                "tokens": _spec((B, Td), i32),
                "targets": _spec((B, Td), i32)}
    if arch.frontend == "vision":
        Tt = T - arch.n_prefix
        return {"embeds": _spec((B, arch.n_prefix, arch.d_model), f32),
                "tokens": _spec((B, Tt), i32),
                "targets": _spec((B, Tt), i32)}
    return {"tokens": _spec((B, T), i32), "targets": _spec((B, T), i32)}


def n_tokens_of(arch: ArchConfig, cell: ShapeCell) -> int:
    specs = train_batch_specs(arch, cell)
    return int(specs["tokens"].shape[0] * specs["tokens"].shape[1])


def abstract_params(arch: ArchConfig, sp: ShardPolicy = NO_SHARD):
    """The parameters as meta tensors (``jax.eval_shape(lm.init, key)``)."""
    return LM(arch, sp, remat=False, device=META).init(None)


def build_train_step(arch: ArchConfig, mesh=None, variant: str = "bkfac",
                     unroll: bool = False, cell: Optional[ShapeCell] = None,
                     flags: Optional[Dict[str, bool]] = None, work=None,
                     curvature_axis: Optional[str] = None,
                     remat: bool = True, plan: str = "tp",
                     async_heavy: bool = False, heavy_lag: int = 0,
                     dist: Optional[specs_lib.DistSpec] = None,
                     device=None,
                     kfac_config: Optional[kfac_lib.KfacConfig] = None,
                     moe_capacity: str = "kept") -> BuiltTrain:
    """``work`` (a schedule.StepWork) supersedes ``flags`` when given.
    ``kfac_config`` replaces ``default_kfac_config(arch, variant)`` (a
    port-only knob: the reduced paths on the card train with the CLI's
    ``--reduced`` optimizer).  ``moe_capacity`` is the policy's rule for a
    data-parallel rank's MoE buffer rows (``ShardPolicy.moe_capacity``;
    port-only: the meta-tensor dry-run takes "even").
    ``dist`` is the spec-level spelling of the ``mesh``/``curvature_axis``
    pair and may not be mixed with it; its curvature axis attaches the
    distributed curvature engine (``opt.init`` then gives each rank its
    layout).  ``plan`` is the reference's model-sharding plan ("tp" or
    "fsdp"), which picks the shardings and how a mesh runs (the module
    docstring; under "fsdp" with the async pipeline, a curvature engine
    or both too).  ``async_heavy``/``heavy_lag`` give the
    optimizer the double-buffered heavy pipeline (its state then carries
    the in-flight buffers).

    ``step_fn(params, opt_state, batch, rng) -> (params, opt_state,
    loss)`` in the port's in-place convention: ``params`` is updated in
    place and returned.  On a data mesh ``batch`` is this rank's block
    and the loss the global batch's.  ``rng`` is a ``torch.Generator``, or a mapping of
    per-bucket heavy-op draws as ``Kfac.update(draws=)`` takes them."""
    if dist is not None:
        if mesh is not None or curvature_axis is not None:
            raise ValueError("build_train_step: pass dist= OR the loose "
                             "mesh=/curvature_axis= pair, not both")
        mesh, curvature_axis = dist.mesh, dist.curvature_axis
    else:
        dist = specs_lib.DistSpec(mesh=mesh, curvature_axis=curvature_axis)
    cell = cell or SHAPES["train_4k"]
    flags = flags or dict(do_stats=True, do_light=True, do_heavy=False)
    fsdp = plan == "fsdp" and mesh is not None
    if fsdp:
        sp = ShardPolicy(dp=tuple(mesh.axis_names), tp=None,
                         seq_shard_residual=False,
                         axis_sizes=_axis_sizes(mesh), mesh=mesh)
    else:
        sp = shard_policy_for(mesh)
    sp = dataclasses.replace(sp, moe_capacity=moe_capacity)
    dev = device_lib.resolve(device)
    lm = LM(arch, sp, remat=remat, unroll=unroll, device=dev, fsdp=fsdp)
    sp = lm.sp
    kcfg = kfac_config or default_kfac_config(arch, variant)
    if async_heavy:
        kcfg = dataclasses.replace(kcfg, async_heavy=True,
                                   heavy_lag=heavy_lag)
    opt = kfac_lib.Kfac(kcfg, lm.taps, device=dev)
    opt.model_shards = sp.shards
    dist.attach(opt)
    n_tokens = n_tokens_of(arch, cell)
    step_work = work if work is not None else opt.uniform_work(**flags)

    def train_step(params, opt_state, batch, rng):
        draws = None
        if isinstance(rng, Mapping):
            draws, rng = rng, None
        probes = layers.make_probes(opt.taps, device=dev)
        loss, acts, gp, gprobe = loop_lib.kfac_grads(
            lm.loss_fn, params, probes, batch, sp,
            keep_blocks=opt.probe_blocks())
        updates, opt_state = opt.update(
            gp, opt_state, params, acts=acts, probe_grads=gprobe,
            n_tokens=n_tokens, rng=rng, work=step_work, draws=draws,
            consume_grads=True)
        optbase.apply_updates(params, updates)
        return params, opt_state, loss

    a_params = abstract_params(arch, sp)
    a_opt = kfac_lib.Kfac(kcfg, lm.taps, device=META).init(a_params)
    batch_specs = train_batch_specs(arch, cell)
    in_sh = out_sh = None
    if mesh is not None:
        if plan == "fsdp":
            p_sh = shd.params_sharding_fsdp(a_params, mesh)
            o_sh = fsdp_state_sharding(opt, a_opt, mesh)
            dp_all = tuple(mesh.axis_names)
            b_sh = {k: shd.NamedSharding(mesh, shd.P(
                        *((dp_all,) + (None,) * (v.ndim - 1))))
                    for k, v in batch_specs.items()}
        else:
            p_sh = shd.params_sharding(a_params, mesh)
            o_sh = shd.kfac_state_sharding(a_opt, mesh,
                                           curvature_axis=curvature_axis)
            b_sh = shd.batch_sharding(batch_specs, mesh)
        r_sh = shd.NamedSharding(mesh, shd.P())
        in_sh = (p_sh, o_sh, b_sh, r_sh)
        out_sh = (p_sh, o_sh, shd.NamedSharding(mesh, shd.P()))
    return BuiltTrain(lm=lm, opt=opt, step_fn=train_step,
                      abstract_params=a_params, abstract_opt=a_opt,
                      in_shardings=in_sh, out_shardings=out_sh,
                      batch_specs=batch_specs)


def fsdp_state_sharding(opt: kfac_lib.Kfac, a_opt, mesh):
    """How a rank holds ``opt``'s state under ``plan="fsdp"``: each ≥ 2-D
    leaf of the global state (``a_opt``) by ``params_sharding_fsdp``;
    with a curvature engine, composed with the engine's layout, for which
    the dense M it keeps and the in-flight buffers are left whole."""
    o_sh = shd.params_sharding_fsdp(a_opt, mesh)
    eng = opt.curvature
    if eng is None:
        return o_sh
    whole = shd.NamedSharding(mesh, shd.P())
    o_sh = dataclasses.replace(
        o_sh, inflight=shd.replicated(a_opt.inflight, mesh),
        factors={n: kfac_lib.TapState(**{
            side: dataclasses.replace(getattr(ts, side), M=whole)
            if opt._engine_m(opt.specs[n][side]) else getattr(ts, side)
            for side in ("A", "G")}) for n, ts in o_sh.factors.items()})
    return shd.Composed(o_sh, eng.state_sharding(opt))


@dataclasses.dataclass
class BuiltServe:
    lm: LM
    step_fn: Any
    abstract_params: Any
    arg_specs: Tuple
    in_shardings: Any
    out_shardings: Any


def build_prefill_step(arch: ArchConfig, mesh=None,
                       cell: Optional[ShapeCell] = None,
                       unroll: bool = False, device=None,
                       moe_capacity: str = "kept") -> BuiltServe:
    """``step_fn(params, batch) -> logits`` (B, T, vocab), no gradients;
    on a data mesh ``batch`` and the logits are this rank's rows, on a
    model axis larger than 1 its vocabulary block (``out_shardings``).
    ``moe_capacity`` as in :func:`build_train_step`."""
    cell = cell or SHAPES["prefill_32k"]
    sp = dataclasses.replace(shard_policy_for(mesh),
                             moe_capacity=moe_capacity)
    lm = LM(arch, sp, remat=False, unroll=unroll,
            device=device_lib.resolve(device))
    batch_specs = train_batch_specs(arch, cell)
    batch_specs.pop("targets")

    @torch.no_grad()
    def prefill(params, batch):
        logits, _, _, _ = lm.forward(params, batch, train=False)
        return logits

    a_params = abstract_params(arch, sp)
    in_sh = out_sh = None
    if mesh is not None:
        p_sh = shd.params_sharding(a_params, mesh)
        b_sh = shd.batch_sharding(batch_specs, mesh)
        dp = tuple(a for a in mesh.axis_names if a != "model")
        in_sh = (p_sh, b_sh)
        logits_shape = (cell.global_batch, 1, arch.vocab)
        out_sh = shd.NamedSharding(mesh, shd.fit_spec(
            shd.P(dp, None, "model"), logits_shape, mesh))
    return BuiltServe(lm=lm, step_fn=prefill, abstract_params=a_params,
                      arg_specs=(batch_specs,), in_shardings=in_sh,
                      out_shardings=out_sh)


def kv_rep_for(arch: ArchConfig, mesh) -> int:
    """Smallest KV-head replication r with (Hk·r) divisible by the model
    axis and r dividing the GQA group (so H/(Hk·r) stays integral)."""
    if mesh is None or "model" not in mesh.axis_names:
        return 1
    tp = dict(_axis_sizes(mesh))["model"]
    Hk, G = arch.n_kv_heads, arch.n_heads // arch.n_kv_heads
    for r in range(1, G + 1):
        if G % r == 0 and (Hk * r) % tp == 0:
            return r
    return 1


def build_decode_step(arch: ArchConfig, mesh=None,
                      cell: Optional[ShapeCell] = None,
                      unroll: bool = False, cache_layout: str = "seq",
                      window_caches: bool = False,
                      device=None, moe_capacity: str = "kept") -> BuiltServe:
    """``step_fn(params, cache, token, t) -> (logits, cache)``;
    ``arg_specs`` = (cache, token, t) as meta tensors (global shapes; on
    a data mesh the step takes this rank's blocks of the cache, the
    tokens and a (B,) ``t``, and returns its rows).  At one device
    ``cache_layout`` changes no shape (the reference's layouts place the
    cache over a mesh); ``window_caches`` keeps a sliding-window layer's
    ring at its window.  ``moe_capacity`` as in :func:`build_train_step`."""
    cell = cell or SHAPES["decode_32k"]
    B, S = cell.global_batch, cell.seq_len
    shard_seq = cell.name == "long_500k"
    kv_rep = 1
    if cache_layout == "heads" and not shard_seq:
        kv_rep = kv_rep_for(arch, mesh)
        if kv_rep == 1 and mesh is not None:
            tp = dict(_axis_sizes(mesh)).get("model", 1)
            if arch.n_kv_heads % tp != 0:
                # heads unrealizable → shard head_dim
                cache_layout = "hd" if arch.hd % tp == 0 else "seq"
    small_thr = 0
    cross_len = S if arch.is_encdec else 0
    S_self = max(S // arch.dec_ratio, 64) if arch.is_encdec else S
    sp = dataclasses.replace(shard_policy_for(mesh, shard_kv_seq=shard_seq),
                             moe_capacity=moe_capacity)
    if sp.active:
        sp = dataclasses.replace(sp, kv_cache_layout=cache_layout,
                                 kv_small_seq_threshold=small_thr,
                                 kv_lens=(S_self, cross_len, window_caches))
    lm = LM(arch, sp, remat=False, unroll=unroll,
            device=device_lib.resolve(device))

    def decode(params, cache, token, t):
        return lm.decode_step(params, cache, token, t)

    meta_lm = LM(arch, sp, remat=False, device=META)
    abstract_cache = meta_lm.init_cache(B, S_self, cross_len=cross_len,
                                        window_caches=window_caches,
                                        kv_rep=kv_rep)
    token_spec = _spec((B, 1), torch.int32)
    t_spec = _spec((), torch.int32)
    a_params = meta_lm.init(None)
    in_sh = out_sh = None
    if mesh is not None:
        p_sh = shd.params_sharding(a_params, mesh)
        c_sh = shd.cache_sharding(abstract_cache, mesh,
                                  shard_seq=shard_seq, layout=cache_layout,
                                  small_seq_threshold=small_thr)
        dp = tuple(a for a in mesh.axis_names if a != "model")
        tok_sh = shd.NamedSharding(mesh, shd.P() if shard_seq
                                   else shd.P(dp, None))
        in_sh = (p_sh, c_sh, tok_sh, shd.NamedSharding(mesh, shd.P()))
        out_logits = shd.P() if shard_seq else shd.P(dp, None, None)
        out_sh = (shd.NamedSharding(mesh, out_logits), c_sh)
    return BuiltServe(lm=lm, step_fn=decode, abstract_params=a_params,
                      arg_specs=(abstract_cache, token_spec, t_spec),
                      in_shardings=in_sh, out_shardings=out_sh)
