"""Step builders for training, prefill and decode — shared by the trainer
CLI and the serving stack.

Counterpart of ``src/repro/launch/steps.py`` at one device.  The
reference's abstract values (``jax.eval_shape``) are tensors on the meta
device here: ``abstract_params`` and ``abstract_opt`` are the port's own
containers (a flat parameter dict, a ``KfacState``) over meta tensors,
``batch_specs`` and a decode step's ``arg_specs`` meta tensors of the
reference's shapes and dtypes; nothing is drawn or allocated for them.
``in_shardings``/``out_shardings`` are None: a mesh raises (ROADMAP §1
item 4 brings meshes).

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
from repro_torch.models import layers
from repro_torch.models.lm import LM
from repro_torch.models.sharding_policy import NO_SHARD, ShardPolicy
from repro_torch.optim import base as optbase
from repro_torch.train import loop as loop_lib

META = torch.device("meta")


def _no_mesh(mesh, what: str) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"{what}: meshes are not ported yet (ROADMAP §1 item 4, "
            f"'Distributed'); the port builds one-device steps — pass "
            f"mesh=None")


def shard_policy_for(mesh=None, shard_kv_seq: bool = False,
                     seq_shard_residual: bool = True) -> ShardPolicy:
    """``NO_SHARD`` at ``mesh=None``; a mesh raises."""
    _no_mesh(mesh, "shard_policy_for")
    return NO_SHARD


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
                     device=None) -> BuiltTrain:
    """``work`` (a schedule.StepWork) supersedes ``flags`` when given.
    ``dist`` is the spec-level spelling of the ``mesh``/``curvature_axis``
    pair and may not be mixed with it; an inactive spec attaches as a
    no-op, a mesh raises.  ``plan`` is the reference's model-sharding
    plan, inert without a mesh.  ``async_heavy``/``heavy_lag`` give the
    optimizer the double-buffered heavy pipeline (its state then carries
    the in-flight buffers).

    ``step_fn(params, opt_state, batch, rng) -> (params, opt_state,
    loss)`` in the port's in-place convention: ``params`` is updated in
    place and returned.  ``rng`` is a ``torch.Generator``, or a mapping of
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
    sp = shard_policy_for(mesh)
    dev = device_lib.resolve(device)
    lm = LM(arch, sp, remat=remat, unroll=unroll, device=dev)
    kcfg = default_kfac_config(arch, variant)
    if async_heavy:
        kcfg = dataclasses.replace(kcfg, async_heavy=True,
                                   heavy_lag=heavy_lag)
    opt = kfac_lib.Kfac(kcfg, lm.taps, device=dev)
    dist.attach(opt)
    n_tokens = n_tokens_of(arch, cell)
    step_work = work if work is not None else opt.uniform_work(**flags)

    def train_step(params, opt_state, batch, rng):
        draws = None
        if isinstance(rng, Mapping):
            draws, rng = rng, None
        probes = layers.make_probes(opt.taps, device=dev)
        loss, acts, gp, gprobe = loop_lib.kfac_grads(
            lm.loss_fn, params, probes, batch)
        updates, opt_state = opt.update(
            gp, opt_state, params, acts=acts, probe_grads=gprobe,
            n_tokens=n_tokens, rng=rng, work=step_work, draws=draws,
            consume_grads=True)
        optbase.apply_updates(params, updates)
        return params, opt_state, loss

    a_params = abstract_params(arch, sp)
    a_opt = kfac_lib.Kfac(kcfg, lm.taps, device=META).init(a_params)
    return BuiltTrain(lm=lm, opt=opt, step_fn=train_step,
                      abstract_params=a_params, abstract_opt=a_opt,
                      in_shardings=None, out_shardings=None,
                      batch_specs=train_batch_specs(arch, cell))


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
                       unroll: bool = False, device=None) -> BuiltServe:
    """``step_fn(params, batch) -> logits`` (B, T, vocab), no gradients."""
    cell = cell or SHAPES["prefill_32k"]
    sp = shard_policy_for(mesh)
    lm = LM(arch, sp, remat=False, unroll=unroll,
            device=device_lib.resolve(device))
    batch_specs = train_batch_specs(arch, cell)
    batch_specs.pop("targets")

    @torch.no_grad()
    def prefill(params, batch):
        logits, _, _, _ = lm.forward(params, batch, train=False)
        return logits

    return BuiltServe(lm=lm, step_fn=prefill,
                      abstract_params=abstract_params(arch, sp),
                      arg_specs=(batch_specs,), in_shardings=None,
                      out_shardings=None)


def kv_rep_for(arch: ArchConfig, mesh) -> int:
    """Smallest KV-head replication over the mesh's model axis: 1 at
    ``mesh=None``; a mesh raises."""
    _no_mesh(mesh, "kv_rep_for")
    return 1


def build_decode_step(arch: ArchConfig, mesh=None,
                      cell: Optional[ShapeCell] = None,
                      unroll: bool = False, cache_layout: str = "seq",
                      window_caches: bool = False,
                      device=None) -> BuiltServe:
    """``step_fn(params, cache, token, t) -> (logits, cache)``;
    ``arg_specs`` = (cache, token, t) as meta tensors.  At one device
    ``cache_layout`` changes no shape (the reference's layouts place the
    cache over a mesh); ``window_caches`` keeps a sliding-window layer's
    ring at its window."""
    cell = cell or SHAPES["decode_32k"]
    B, S = cell.global_batch, cell.seq_len
    shard_seq = cell.name == "long_500k"
    kv_rep = 1
    if cache_layout == "heads" and not shard_seq:
        kv_rep = kv_rep_for(arch, mesh)
    sp = shard_policy_for(mesh, shard_kv_seq=shard_seq)
    lm = LM(arch, sp, remat=False, unroll=unroll,
            device=device_lib.resolve(device))
    cross_len = S if arch.is_encdec else 0
    S_self = max(S // arch.dec_ratio, 64) if arch.is_encdec else S

    def decode(params, cache, token, t):
        return lm.decode_step(params, cache, token, t)

    meta_lm = LM(arch, sp, remat=False, device=META)
    abstract_cache = meta_lm.init_cache(B, S_self, cross_len=cross_len,
                                        window_caches=window_caches,
                                        kv_rep=kv_rep)
    token_spec = _spec((B, 1), torch.int32)
    t_spec = _spec((), torch.int32)
    return BuiltServe(lm=lm, step_fn=decode,
                      abstract_params=meta_lm.init(None),
                      arg_specs=(abstract_cache, token_spec, t_spec),
                      in_shardings=None, out_shardings=None)
