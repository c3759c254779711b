"""The generic LM covering all 10 assigned architectures.

Counterpart of ``src/repro/models/lm.py``.  Assembly: embed → [segments:
(pattern × repeats)] → final norm → tapped LM head (→ optional MTP head).
Enc-dec archs (whisper) run an encoder stack first and feed it as
cross-attention memory.  VLM/audio frontends are stubs: precomputed
embeddings enter as a sequence prefix / encoder input, as in the
reference.

Parameters are a flat dict keyed by the reference's "/"-joined paths
("embed", "segments/0/p1/mix/wq", "head/w", …); a segment's block
parameters carry the segment's repeats as their leading axis, as the
reference's scanned stacks do.  The reference scans each segment with
``lax.scan``; here a Python loop runs the repeats on the indexed stacks
and ``torch.stack``s each tap's activations, so a stacked tap's act has
the reference's shape (*stack, n_stat, d_in).  ``remat=True`` wraps each
repeat in ``torch.utils.checkpoint`` (non-reentrant).  ``unroll`` is
accepted for the reference's signature and has no effect: the port
always unrolls.

Train path: ``loss_fn(params, probes, batch) -> (loss, acts)`` — the K-FAC
tap contract (core/kfac.py).  Under a data-parallel policy the batch is
this rank's block of the global batch and the loss is this rank's share
of the global loss (summed over the data axes it is the reference's), the
acts this rank's placements of the global statistics rows
(``layers.tapped_matmul``).  Serve path: ``decode_step`` (one token, KV /
state caches, written in place) and ``forward`` (prefill-shaped logits).

**Tensor parallelism** (a policy whose model axis is larger than 1):
``init`` returns the rank's blocks of the parameters
(``distributed/sharding.py::params_sharding``; ``param_shardings``
localizes a whole tree), and ``sp.shards`` records which leaves are
blocks.  The embedding is vocabulary-parallel (a masked lookup of the
rank's rows, summed over the model axis), the residual stream is
sequence-sharded between blocks, the head gives the rank's vocabulary
block of the logits (prefill returns it), and the cross-entropy is
vocabulary-parallel: the max and the sum of exponentials are reduced
over the axis and the target's logit comes from the rank that holds it.
The loss is each rank's 1/M share, the acts are gathered over the axis
to the one-device taps, and decode's logits are gathered whole.

**FSDP** (``fsdp=True`` with a policy whose data axes are every axis of
its mesh: ``launch/steps.py``'s ``plan="fsdp"``): ``init`` returns the
rank's blocks of ``distributed/sharding.py::params_sharding_fsdp`` (every
≥ 2-D leaf split over the whole mesh on its largest dimension that the
mesh divides) and ``sp.shards`` is ``ModelShards`` over the whole mesh.
A repeat gathers its leaves whole inside its checkpointed body, in one
packed collective whose backward reduce-scatters their gradients
(``collectives.gather_grad_coalesced``), so remat gathers them again in
the backward and no layer's whole weights outlive it; the embedding and
the head (with the MTP projection) are gathered the same way where they
are used.  The layers then run as on one device on the rank's rows of
the batch, as under data parallelism.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch import device as device_lib
from repro_torch.configs.base import ArchConfig, LayerSpec, Segment
from repro_torch.core.kfac import TapInfo
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shd
from repro_torch.models import blocks, layers
from repro_torch.models.sharding_policy import NO_SHARD, ShardPolicy

Tensor = torch.Tensor

#: local tap name → block param sub-path ("mix"/"ffn" namespaced)
_TAP_PARAM = {
    "attn_q": "mix/wq", "attn_kv": "mix/wkv", "attn_o": "mix/wo",
    "x_attn_q": "mix/x_wq", "x_attn_kv": "mix/x_wkv",
    "x_attn_o": "mix/x_wo",
    "ffn_wi": "ffn/wi", "ffn_wo": "ffn/wo_f",
    "moe_wi": "ffn/wi", "moe_wo": "ffn/wo",
    "shared_wi": "ffn/shared_wi", "shared_wo": "ffn/shared_wo",
    "wq_a": "mix/wq_a", "wq_b": "mix/wq_b", "wkv_a": "mix/wkv_a",
    "wkv_b": "mix/wkv_b", "wo": "mix/wo",
    "ssm_in": "mix/in_proj", "ssm_out": "mix/out_proj",
    "lru_in": "mix/wi", "lru_gates": "mix/wg", "lru_out": "mix/wo",
}


def _ce_loss(logits: Tensor, targets: Tensor,
             mask: Optional[Tensor] = None) -> Tensor:
    """Token-mean cross-entropy with fp32 accumulation and no fp32 copy of
    the logits (vocab can be 262k): the max is taken in the logits' dtype,
    the exponentials stay in it, and their sum is fp32.  The target's
    logit is gathered (the reference contracts a one-hot mask; both pick
    the same value exactly).  The max is ``torch.max``, whose backward
    scatters into the row's maximum: ``torch.amax``'s counts the maxima
    of every row in int64, a 16 GiB temporary at gemma3's vocab."""
    m = torch.max(logits, dim=-1, keepdim=True).values
    lse = m[..., 0].to(torch.float32) + torch.log(
        torch.sum(torch.exp(logits - m), dim=-1, dtype=torch.float32))
    ll = torch.gather(logits, -1, targets[..., None].to(torch.int64)
                      )[..., 0].to(torch.float32)
    nll = lse - ll
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def _ce_loss_vp(logits: Tensor, targets: Tensor, sp, vocab: int) -> Tensor:
    """:func:`_ce_loss` of vocabulary-parallel logits (the rank's block of
    ``vocab`` columns): the max (no gradient: the log-sum-exp does not
    depend on it) and the sum of exponentials reduced over the model
    axis, the target's logit from its owner, the exponentials in the
    logits' dtype and their sum fp32, as on one device."""
    Vl = logits.shape[-1]
    lo = sp.block_range(vocab, Vl)[0]
    m = sp.tp_max(torch.max(logits.detach(), dim=-1, keepdim=True).values)
    se = sp.tp_sum(torch.sum(torch.exp(logits - m), dim=-1,
                             dtype=torch.float32))
    lse = m[..., 0].to(torch.float32) + torch.log(se)
    t = targets.to(torch.int64) - lo
    own = (t >= 0) & (t < Vl)
    ll = torch.gather(logits, -1, t.clamp(0, Vl - 1)[..., None])[..., 0]
    ll = sp.tp_sum(torch.where(own, ll.to(torch.float32), 0.0))
    return torch.mean(lse - ll)


def _nest(flat: Dict[str, Tensor]) -> Dict:
    """{"mix/wq": x, …} → {"mix": {"wq": x}, …}."""
    out: Dict = {}
    for k, v in flat.items():
        node = out
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def _block(p_r: Dict, i: int) -> Dict:
    """Pattern position i's block parameters ({"mix", "ffn"}; an FFN of
    kind "none" has no leaves, so it has no flat keys either)."""
    p = p_r.get(f"p{i}", {})
    return {"mix": p.get("mix", {}), "ffn": p.get("ffn", {})}


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


class LM:
    def __init__(self, arch: ArchConfig, sp: ShardPolicy = NO_SHARD,
                 remat: bool = True, unroll: bool = False, device=None,
                 fsdp: bool = False):
        self.arch = arch
        self.sp = sp
        self.remat = remat
        self.unroll = unroll     # the reference's knob; no effect here
        self.device = device_lib.resolve(device)
        self.dtype = (torch.bfloat16 if arch.dtype == "bfloat16"
                      else torch.float32)
        self._enc_segments: Tuple[Segment, ...] = ()
        if arch.is_encdec:
            enc_spec = LayerSpec(mixer="gqa", ffn="dense",
                                 causal=arch.enc_causal)
            self._enc_segments = (Segment((enc_spec,), arch.n_enc_layers),)
        self.taps = self._build_taps()
        self.param_shardings = None
        taps = {n: t.param_path for n, t in self.taps.items()}
        if sp.model_parallel:
            abstract = self.init(None)
            self.param_shardings = shd.params_sharding(abstract, sp.mesh)
            self.sp = dataclasses.replace(sp, shards=shd.ModelShards(
                abstract, sp.mesh, sp.tp, taps=taps))
        elif fsdp and sp.mesh is not None:
            abstract = self.init(None)
            self.param_shardings = shd.params_sharding_fsdp(abstract,
                                                            sp.mesh)
            ms = shd.ModelShards(abstract, sp.mesh, None, taps=taps)
            stacked = [k for k in abstract if k.startswith(("segments/",
                                                            "enc/"))
                       and ms.dim(k) == 0]
            if stacked:
                # a repeat indexes its leaves locally (v[r]); no
                # architecture has a leaf whose block is a run of repeats
                raise NotImplementedError(
                    f"FSDP: {stacked[:3]} would be split over their "
                    f"repeats")
            self.sp = dataclasses.replace(sp, shards=ms)

    # ------------------------------------------------------------------ taps
    def _seg_taps(self, segments, base: str) -> Dict[str, TapInfo]:
        arch = self.arch
        out = {}
        cross = arch.is_encdec and base == "segments"
        for s, seg in enumerate(segments):
            for i, spec in enumerate(seg.pattern):
                for local, (d_in, d_out, extra) in blocks.block_taps(
                        arch, spec, cross=cross).items():
                    name = f"{base}/seg{s}/p{i}/{local}"
                    pkey = _TAP_PARAM[local]
                    out[name] = TapInfo(
                        param_path=f"{base}/{s}/p{i}/{pkey}",
                        d_in=d_in, d_out=d_out,
                        stack=(seg.repeats,) + tuple(extra),
                        n_stat=arch.n_stat)
        return out

    def _build_taps(self) -> Dict[str, TapInfo]:
        arch = self.arch
        taps = self._seg_taps(arch.segments, "segments")
        if self._enc_segments:
            taps.update(self._seg_taps(self._enc_segments, "enc"))
        taps["head"] = TapInfo(param_path="head/w", d_in=arch.d_model,
                               d_out=arch.vocab, n_stat=arch.n_stat)
        if arch.mtp:
            taps["mtp_proj"] = TapInfo(param_path="mtp/w",
                                       d_in=arch.d_model,
                                       d_out=arch.d_model,
                                       n_stat=arch.n_stat)
        return taps

    # ------------------------------------------------------------------ init
    def _init_segments(self, g, segments, base: str, cross: bool):
        arch = self.arch
        out = {}
        for s, seg in enumerate(segments):
            for i, spec in enumerate(seg.pattern):
                reps = [_flatten(blocks.init_block(g, arch, spec,
                                                   cross=cross))
                        for _ in range(seg.repeats)]
                for k in reps[0]:
                    out[f"{base}/{s}/p{i}/{k}"] = torch.stack(
                        [r[k] for r in reps])
        return out

    def init(self, generator: Optional[torch.Generator]
             ) -> Dict[str, Tensor]:
        """Random fp32 parameters with the reference's shapes and scales,
        drawn from ``generator`` on its device (the numbers are not the
        reference's: parity tests convert the reference's instead), as
        leaf tensors that require grad.  ``generator=None`` gives them on
        the meta device — shapes and dtypes only, nothing drawn or
        allocated (the reference's ``jax.eval_shape(lm.init, key)``)."""
        arch = self.arch
        g = generator
        dev = layers.init_device(g)
        params = {"embed": torch.randn((arch.vocab, arch.d_model),
                                       generator=g, device=dev) * 0.01}
        params.update(self._init_segments(g, arch.segments, "segments",
                                          cross=arch.is_encdec))
        params["final_ln"] = torch.zeros((arch.d_model,), device=dev)
        params["head/w"] = layers.dense_init(g, arch.d_model, arch.vocab,
                                             scale=0.01)
        if self._enc_segments:
            params.update(self._init_segments(g, self._enc_segments, "enc",
                                              cross=False))
            params["enc_ln"] = torch.zeros((arch.d_model,), device=dev)
        if arch.mtp:
            params["mtp/w"] = layers.dense_init(g, arch.d_model,
                                                arch.d_model)
        if g is not None and self.param_shardings is not None:
            params = shd.localize(params, self.param_shardings)
        return {k: v.requires_grad_() for k, v in params.items()}

    # --------------------------------------------------------------- forward
    def _run_segments(self, segments, params, base, h, probes, positions,
                      memory=None, train=True, sp=None):
        arch, sp = self.arch, sp or self.sp
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        acts: Dict[str, Tensor] = {}
        cross = memory is not None
        for s, seg in enumerate(segments):
            pattern = seg.pattern
            pre = f"{base}/{s}/"
            seg_params = {k[len(pre):]: v for k, v in params.items()
                          if k.startswith(pre)}
            names = [n for n in self.taps
                     if n.startswith(f"{base}/seg{s}/")]
            probes_seg = {n: probes[n] for n in names if n in probes}

            # the segment is bound as defaults: a checkpointed repeat
            # recomputes after the loop has moved on.  Under FSDP the
            # repeat's blocks are gathered here, so a recomputation
            # gathers them again and no layer's whole weights outlive it
            def body(hh, aux_c, p_r, probe_r, r, s=s, pattern=pattern,
                     pre=pre):
                if sp.fsdp:
                    whole = sp.shards.gather_params(
                        {pre + k: v for k, v in p_r.items()},
                        scope=f"{pre}{r}")
                    p_r = {k[len(pre):]: v for k, v in whole.items()}
                p_r = _nest(p_r)
                acts_l: Dict[str, Tensor] = {}
                for i, spec in enumerate(pattern):
                    tc = blocks.TapCtx(probe_r, arch.n_stat,
                                       prefix=f"{base}/seg{s}/p{i}/", sp=sp)
                    hh, aux_i = blocks.apply_block(
                        arch, spec, _block(p_r, i), hh, tc, positions, sp,
                        memory=memory if cross else None)
                    aux_c = aux_c + aux_i
                    acts_l.update(tc.acts)
                return hh, aux_c, acts_l

            acts_list = []
            for r in range(seg.repeats):
                p_r = {k: v[r] for k, v in seg_params.items()}
                probe_r = {k: v[r] for k, v in probes_seg.items()}
                if train and self.remat:
                    h, aux, acts_r = torch_checkpoint.checkpoint(
                        body, h, aux, p_r, probe_r, r, use_reentrant=False)
                else:
                    h, aux, acts_r = body(h, aux, p_r, probe_r, r)
                acts_list.append(acts_r)
            for n in acts_list[0]:
                acts[n] = torch.stack([a[n] for a in acts_list])
        return h, aux, acts

    def _whole(self, params, *keys):
        """The leaves ``keys`` as a layer computes with them: under FSDP
        gathered whole in one packed collective whose backward
        reduce-scatters their gradients, else as held."""
        if not self.sp.fsdp:
            return [params[k] for k in keys]
        got = self.sp.shards.gather_params({k: params[k] for k in keys},
                                           scope="+".join(keys))
        return [got[k] for k in keys]

    def _embed(self, params, tokens):
        E, = self._whole(params, "embed")
        if E.shape[0] != self.arch.vocab:   # the rank's vocabulary rows
            lo = self.sp.block_range(self.arch.vocab, E.shape[0])[0]
            t = tokens.to(torch.int64) - lo
            own = (t >= 0) & (t < E.shape[0])
            h = E[t.clamp(0, E.shape[0] - 1)] * own[..., None]
            h = self.sp.tp_sum(h).to(self.dtype)
        else:
            h = E[tokens].to(self.dtype)
        scale = torch.tensor(math.sqrt(self.arch.d_model),
                             dtype=torch.float32).to(self.dtype)
        return h * scale.to(h.device)

    def forward(self, params, batch, probes=None, train=True):
        """Full-sequence forward → (logits, aux, acts, logits_mtp), the
        last None unless the arch has an MTP head and ``train``."""
        arch, sp = self.arch, self.sp
        probes = probes or {}
        acts: Dict[str, Tensor] = {}
        memory = None
        if arch.is_encdec:
            mem = batch["frames"].to(self.dtype)         # (B, Te, d) stub
            pos_e = torch.arange(mem.shape[1], device=mem.device
                                 ).expand(mem.shape[:2])
            enc_sp = sp.for_seq(mem.shape[1])
            memory, _, acts_e = self._run_segments(
                self._enc_segments, params, "enc", enc_sp.residual(mem),
                probes, pos_e, train=train, sp=enc_sp)
            memory = layers.rms_norm(memory, params["enc_ln"])
            memory = enc_sp.full_seq(memory)    # whole for cross-attention
            acts.update(acts_e)
        tokens = batch["tokens"]
        h = self._embed(params, tokens)
        if arch.frontend == "vision":
            h = torch.cat([batch["embeds"].to(self.dtype), h], dim=1)
        B, T = h.shape[:2]
        positions = torch.arange(T, device=h.device).expand(B, T)
        sp = sp.for_seq(T)
        h = sp.residual(h)
        h, aux, acts_m = self._run_segments(
            arch.segments, params, "segments", h, probes, positions,
            memory=memory, train=train, sp=sp)
        acts.update(acts_m)
        h = sp.full_seq(layers.rms_norm(h, params["final_ln"]))
        tc = blocks.TapCtx(probes, arch.n_stat, prefix="", sp=sp)
        mtp = arch.mtp and train
        W = self._whole(params, "head/w", *(("mtp/w",) if mtp else ()))
        # under tensor parallelism the rank's vocabulary block (the
        # reference's ``sp.logits`` constraint)
        logits = tc.mm("head", W[0], h)
        acts.update(tc.acts)
        if arch.logit_softcap > 0:
            logits = layers.softcap(logits, arch.logit_softcap)
        if mtp:
            tcm = blocks.TapCtx(probes, arch.n_stat, prefix="", sp=sp)
            h_mtp = sp.gather_cols(tcm.mm("mtp_proj", W[1], h),
                                   arch.d_model)
            acts.update(tcm.acts)
            logits_mtp = h_mtp @ W[0].to(h_mtp.dtype)
            return logits, aux, acts, logits_mtp
        return logits, aux, acts, None

    def _gather_acts(self, acts: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """The one-device taps from the ranks' acts: a row-parallel
        matmul's (the rank's input columns) and an expert stack's (the
        rank's experts) gathered over the model axis, in one packed
        collective."""
        names, xs, dims = [], [], []
        for name, a in acts.items():
            t = self.taps[name]
            want = tuple(t.stack) + (t.n_stat, t.d_in)
            diff = [i for i, (g, w) in enumerate(zip(a.shape, want))
                    if g != w]
            if diff:
                names.append(name)
                xs.append(a)
                dims.append(diff[0])
        out = dict(acts)
        out.update(zip(names, coll.all_gather_coalesced(
            xs, self.sp.mesh, self.sp.tp, dims)))
        return out

    def loss_fn(self, params, probes, batch):
        arch = self.arch
        logits, aux, acts, logits_mtp = self.forward(params, batch, probes,
                                                     train=True)
        targets = batch["targets"]
        sp = self.sp
        ce = (_ce_loss if logits.shape[-1] == arch.vocab else
              lambda lg, tg: _ce_loss_vp(lg, tg, sp, arch.vocab))
        if arch.frontend == "vision":       # loss only on the token span
            logits = logits[:, arch.n_prefix:]
        loss = ce(logits[:, :-1], targets[:, 1:])
        if logits_mtp is not None:          # MTP: predict t+2 (depth-1)
            if arch.frontend == "vision":
                logits_mtp = logits_mtp[:, arch.n_prefix:]
            loss = loss + 0.3 * ce(logits_mtp[:, :-2], targets[:, 2:])
        loss = loss + arch.aux_loss_coef * aux
        if sp.data_parallel:
            # this rank's share of the global mean: its rows' token mean
            # over the data ranks (the rows split evenly), and a 1/N share
            # of the load-balance loss, which is global already
            loss = loss / sp.dp_size
        if sp.model_parallel:
            # every model rank holds the same value: a 1/M share each
            loss = loss / sp.tp_size
            acts = self._gather_acts(acts)
        return loss, acts

    # ----------------------------------------------------------------- serve
    def init_cache(self, B: int, S: int, cross_len: int = 0,
                   window_caches: bool = False, kv_rep: int = 1):
        """Zero decode caches {segment: {"p{i}": {name: (repeats, …)}}} on
        the LM's device, in the activation dtype (recurrent states fp32)."""
        arch = self.arch
        cache = {}
        for s, seg in enumerate(arch.segments):
            seg_cache = {}
            for i, spec in enumerate(seg.pattern):
                one = blocks.block_cache_init(
                    arch, spec, B, S, self.dtype, self.device,
                    cross_len=cross_len, window_caches=window_caches,
                    kv_rep=kv_rep)
                seg_cache[f"p{i}"] = {
                    k: v.expand((seg.repeats,) + v.shape).clone()
                    for k, v in one.items()}
            cache[str(s)] = seg_cache
        return cache

    @torch.no_grad()
    def decode_step(self, params, cache, token, t):
        """One decode step. token: (B, 1) integer; t: a host int position
        for the whole batch, or a (B,) integer tensor on the LM's device
        with each row's own position (continuous batching: every row a
        lane of its own; the recurrent mixers carry no position).
        Returns (logits (B, 1, V), cache); the cache tensors are updated in
        place and returned."""
        arch, sp = self.arch, self.sp
        t = t.to(token.device) if isinstance(t, Tensor) else int(t)
        h_t = self._embed(params, token)
        for s, seg in enumerate(arch.segments):
            pre = f"segments/{s}/"
            seg_params = {k[len(pre):]: v for k, v in params.items()
                          if k.startswith(pre)}
            seg_cache = cache[str(s)]
            for r in range(seg.repeats):
                p_r = _nest({k: v[r] for k, v in seg_params.items()})
                for i, spec in enumerate(seg.pattern):
                    c_r = {k: v[r] for k, v in seg_cache[f"p{i}"].items()}
                    h_t, nc = blocks.decode_block(arch, spec, _block(p_r, i),
                                                  h_t, c_r, t, sp)
                    for k, v in nc.items():
                        if v.data_ptr() != c_r[k].data_ptr():
                            c_r[k].copy_(v)
        h_t = layers.rms_norm(h_t, params["final_ln"])
        logits = h_t @ params["head/w"].to(h_t.dtype)
        if arch.logit_softcap > 0:
            logits = layers.softcap(logits, arch.logit_softcap)
        return sp.gather_cols(logits, arch.vocab), cache
