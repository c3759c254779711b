"""Parameter / optimizer-state / batch sharding rules, and a rank's local
slice of a global tensor under them.

Counterpart of ``src/repro/distributed/sharding.py``: the same
path-pattern rules on the (pod, data, model) mesh —

  * embeddings & LM head : vocab on "model"
  * attention q/kv/o     : head (fused out) dim on "model"
  * FFN wi / wo          : hidden dim on "model"
  * MoE expert stacks    : expert dim on "model" (EP)
  * K-FAC low-rank U     : factor rows (d) on "model"
  * small vectors (norms, biases, D/A_log/…) : replicated
  * batch                : ("pod", "data")

A spec is the port's own :class:`P` (a tuple with one axis name, tuple of
names or None per dimension) and a :class:`NamedSharding` pairs a mesh
with one; no ``jax.sharding`` is involved.  The rules are pure functions
of paths, shapes and axis sizes, so anything with ``axis_names`` and
``devices.shape`` serves as the mesh.  Trees are the port's own: nests of
dicts and dataclasses, with a leaf's path its keys and field names joined
by "/" (a flat parameter name such as ``segments/0/p0/mix/wq`` is the
reference's nested path already).

:func:`local_slice` takes a rank's block of a global tensor under a
sharding (contiguous blocks in the axes' coordinate order, as
``jax.device_put`` lays a ``NamedSharding`` out); :func:`localize`,
:func:`globalize` and :func:`global_template` apply it over a tree whose
shardings may also hold a layout object of its own (the curvature
engine's round-robin M layout, ``distributed/curvature.py``) — the
checkpoint restore and the elastic runner use them.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Mapping, Tuple

import torch

from repro_torch.distributed import collectives as coll


def _canon(entry):
    """A one-name tuple is that name, an empty one None (as
    ``jax.sharding.PartitionSpec`` canonicalizes)."""
    if isinstance(entry, tuple) and len(entry) <= 1:
        return entry[0] if entry else None
    return entry


class P(tuple):
    """A partition spec: one entry per leading dimension (an axis name,
    a tuple of names, or None); missing trailing entries replicate."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_canon(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Any
    spec: P


def _sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _is_dc(node) -> bool:
    return dataclasses.is_dataclass(node) and not isinstance(node, type)


def _map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a nest of dicts and dataclasses (None stays
    None)."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if _is_dc(tree):
        return dataclasses.replace(tree, **{
            f.name: _map_with_path(fn, getattr(tree, f.name),
                                   path + (f.name,))
            for f in dataclasses.fields(tree)})
    return fn("/".join(path), tree)


def _ndim(leaf) -> int:
    return leaf.ndim if isinstance(leaf, torch.Tensor) else 0


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()


#: (regex, trailing-dims builder); first match wins.  Builders describe the
#: trailing two dims (d_in, d_out); leading scan-stack dims get None.
_RULES = [
    # fan-in on model (output projections)
    (re.compile(r"mix/(wo|x_wo|out_proj)$"), lambda tp: (tp, None)),
    # fan-out on model (input/qkv/gate projections)
    (re.compile(r"mix/(wq|wkv|x_wq|x_wkv|wq_a|wq_b|wkv_a|wkv_b|in_proj|"
                r"wi|wg)$"), lambda tp: (None, tp)),
    (re.compile(r"ffn/wo_f$"), lambda tp: (tp, None)),
    (re.compile(r"ffn/shared_wi$"), lambda tp: (None, tp)),
    (re.compile(r"ffn/shared_wo$"), lambda tp: (tp, None)),
    (re.compile(r"ffn/router$"), lambda tp: (None, None)),
    # embeddings / head: vocab on model
    (re.compile(r"^embed$"), lambda tp: (tp, None)),
    (re.compile(r"^head/w$"), lambda tp: (None, tp)),
    (re.compile(r"^mtp/w$"), lambda tp: (None, tp)),
]

_FFN_WI_WO = re.compile(r"ffn/(wi|wo)$")


def param_spec(path: str, ndim: int, mesh) -> P:
    tp = "model" if "model" in mesh.axis_names else None
    m = _FFN_WI_WO.search(path)
    if m:
        if ndim >= 4:
            # MoE experts (…, E, d_in, d_out): expert dim on model (EP)
            return P(*((None,) * (ndim - 3) + (tp, None, None)))
        dims = (None, tp) if m.group(1) == "wi" else (tp, None)
        return P(*((None,) * (ndim - 2) + dims))
    for rx, fn in _RULES:
        if rx.search(path):
            dims = fn(tp)
            n_lead = ndim - len(dims)
            if n_lead < 0:      # rank-1 target (bias-like): replicate
                return P()
            return P(*((None,) * n_lead + tuple(dims)))
    return P()                   # norms, biases, scalars: replicated


def _axis_size(entry, sizes) -> int:
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(sizes.get(a, 1) for a in names)


def fit_spec(spec: P, shape, mesh) -> P:
    """Drop spec axes that do not divide the corresponding dim (the
    offending axis is replicated instead)."""
    sizes = _sizes(mesh)
    fitted = []
    for i, entry in enumerate(tuple(spec)):
        if i >= len(shape) or shape[i] % _axis_size(entry, sizes) != 0:
            fitted.append(None)
        else:
            fitted.append(entry)
    return P(*fitted)


def params_sharding(params, mesh):
    """NamedSharding tree for a parameter tree."""
    def one(path, leaf):
        spec = param_spec(path, _ndim(leaf), mesh)
        return NamedSharding(mesh, fit_spec(spec, _shape(leaf), mesh))
    return _map_with_path(one, params)


def params_sharding_fsdp(params, mesh):
    """FSDP/ZeRO-3 plan: every ≥2D leaf fully sharded over ALL mesh axes
    on its largest divisible dim."""
    axes = tuple(mesh.axis_names)
    n = int(mesh.devices.size)

    def one(path, leaf):
        shape = _shape(leaf)
        if len(shape) >= 2:
            order = sorted(range(len(shape)), key=lambda i: -shape[i])
            for i in order:
                if shape[i] % n == 0 and shape[i] >= n:
                    spec = [None] * len(shape)
                    spec[i] = axes
                    return NamedSharding(mesh, P(*spec))
        return NamedSharding(mesh, P())

    return _map_with_path(one, params)


def kfac_state_sharding(opt_state, mesh, curvature_axis=None,
                        row_axis=None):
    """K-FAC optimizer state: factor U/M rows on "model" (each model rank
    owns the rows of its weight shard's factor), D replicated; AdamW
    fallback mirrors the param sharding; scalars replicated.
    ``curvature_axis`` places stacked taps' dense M on that axis along
    the leading stack dim; ``row_axis`` shards every dense M's rows
    there instead of on "model" — live and in-flight snapshot alike.
    Non-divisible stacks / factor sides fall back to replication
    (fit_spec)."""
    tp = "model" if "model" in mesh.axis_names else None

    def one(path, leaf):
        ndim, shape = _ndim(leaf), _shape(leaf)
        if path.startswith("inflight"):
            field = path.rsplit("/", 1)[-1]
            if field == "M" and curvature_axis is not None and \
                    ndim >= 3 and shape[-1] > 1:
                spec = P(*((curvature_axis, row_axis)
                           + (None,) * (ndim - 2)))
                return NamedSharding(mesh, fit_spec(spec, shape, mesh))
            return NamedSharding(mesh, P())
        if "/factors/" in "/" + path + "/" or path.startswith("factors"):
            field = path.rsplit("/", 1)[-1]
            if field in ("U", "M") and ndim >= 2 and shape[-1] > 1:
                lead = (None,) * (ndim - 2)
                rows = tp
                if field == "M":
                    if curvature_axis is not None and ndim >= 3:
                        lead = (curvature_axis,) + (None,) * (ndim - 3)
                    if row_axis is not None:
                        rows = row_axis
                spec = P(*(lead + (rows, None)))
                return NamedSharding(mesh, fit_spec(spec, shape, mesh))
            return NamedSharding(mesh, P())
        if path.startswith("fallback") or path.startswith("momentum"):
            sub = re.sub(r"^(fallback/(mu|nu)|momentum)/", "", path)
            spec = param_spec(sub, ndim, mesh)
            return NamedSharding(mesh, fit_spec(spec, shape, mesh))
        return NamedSharding(mesh, P())

    return _map_with_path(one, opt_state)


def batch_sharding(batch, mesh):
    dp = tuple(a for a in mesh.axis_names if a != "model")

    def one(path, leaf):
        return NamedSharding(mesh, P(*((dp,) + (None,) * (_ndim(leaf) - 1))))
    return _map_with_path(one, batch)


#: cache leaves with a sequence axis at position 2 (stacked: (reps, B, S, …))
_SEQ_CACHE_LEAVES = {"k", "v", "xk", "xv", "c_kv", "k_rope"}


def cache_sharding(cache, mesh, shard_seq: bool = False,
                   layout: str = "seq", small_seq_threshold: int = 0):
    """KV/state caches: batch on the data axes + seq on the model axis;
    ``layout="heads"`` puts KV heads on the model axis, ``layout="hd"``
    the head dim; long context (``shard_seq``) shards the sequence axis
    of KV-like leaves and replicates recurrent states.  The reference
    gives the "hd" layout the sequence rule and re-lays the cache out
    inside the step (its policy's ``kv_cache`` constraint); the port's
    decode step takes the cache in the layout it attends in."""
    dp = tuple(a for a in mesh.axis_names if a != "model")
    tp = "model" if "model" in mesh.axis_names else None

    def one(path, leaf):
        ndim, shape = _ndim(leaf), _shape(leaf)
        name = path.rsplit("/", 1)[-1]
        if name in _SEQ_CACHE_LEAVES and ndim >= 3:
            if shard_seq:
                spec = (None, None, dp + ((tp,) if tp else ()))
            elif shape[2] <= small_seq_threshold:
                spec = (None, dp, None)
            elif layout == "heads" and ndim >= 5:
                spec = (None, dp, None, tp)
            elif layout == "hd" and ndim >= 5:
                spec = (None, dp, None, None, tp)
            else:
                spec = (None, dp, tp)
            sh = P(*(spec + (None,) * (ndim - len(spec))))
            return NamedSharding(mesh, fit_spec(sh, shape, mesh))
        if shard_seq:               # B == 1: states replicate
            return NamedSharding(mesh, P())
        if ndim >= 2:               # (reps, B, ...): batch on data axes
            return NamedSharding(mesh, P(*((None, dp)
                                           + (None,) * (ndim - 2))))
        return NamedSharding(mesh, P())

    return _map_with_path(one, cache)


class ModelShards:
    """Which parameters a rank of a model axis larger than 1 holds a
    block of: each leaf's dimension on "model" under
    :func:`params_sharding` of the global (abstract) parameters, which
    factor rows (:meth:`factor_rows`, :func:`kfac_state_sharding`'s
    rule), and the collectives of a tensor-parallel step over them (the
    per-leaf gathers, the global norms, the replicated leaves' gradient
    sums)."""

    def __init__(self, abstract_params, mesh, axis: str = "model",
                 taps=None):
        self.mesh, self.axis = mesh, axis
        self.taps = dict(taps or {})     # tap name → its parameter's path
        self.shapes = {k: tuple(v.shape) for k, v in abstract_params.items()}
        self.dims = {}
        for k, sh in params_sharding(abstract_params, mesh).items():
            self.dims[k] = next((i for i, e in enumerate(tuple(sh.spec))
                                 if e == axis), None)

    @property
    def size(self) -> int:
        return int(self.mesh.shape[self.axis])

    @property
    def index(self) -> int:
        return self.mesh.coord(self.axis)

    def dim(self, path: str):
        """The dimension of ``path`` split over the model axis, or None
        (replicated; also a path that is not a parameter)."""
        return self.dims.get(path)

    def sharded(self, path: str) -> bool:
        return self.dim(path) is not None

    def gather(self, path: str, x: torch.Tensor) -> torch.Tensor:
        """The whole leaf from the ranks' blocks (no gradient)."""
        d = self.dim(path)
        if d is None:
            return x
        d = d - len(self.shapes[path]) + x.dim()    # a stacked view
        return coll.all_gather(x.detach(), self.mesh, self.axis, d)

    def block(self, path: str, x: torch.Tensor) -> torch.Tensor:
        """The rank's block of a whole leaf-shaped ``x`` (a copy)."""
        d = self.dim(path)
        if d is None:
            return x
        d = d - len(self.shapes[path]) + x.dim()
        size = x.shape[d] // self.size
        return x.narrow(d, self.index * size, size).clone(
            memory_format=torch.contiguous_format)

    def probe_dim(self, tap: str):
        """The dimension of a tap's (…, n_stat, d_out) probe that the
        ranks hold blocks of — the output columns (-1) of a
        column-parallel matmul, the experts (-3) of an (E,)-stacked one —
        or None: a row-parallel or replicated tap's probe gradient is a
        sum of the ranks' parts."""
        path = self.taps.get(tap)
        d = self.dim(path) if path is not None else None
        if d is None:
            return None
        n = len(self.shapes[path])
        return {n - 1: -1, n - 3: -3}.get(d)

    def factor_rows(self, d: int):
        """The :class:`RowBlock` a rank holds of a factor with ``d`` rows
        (``kfac_state_sharding``'s rule: rows on the model axis where it
        divides them), or None (replicated)."""
        if d % self.size:
            return None
        return RowBlock(self.mesh, self.axis, self.index, d // self.size)

    def local_shape(self, path: str) -> tuple:
        shape = list(self.shapes[path])
        d = self.dim(path)
        if d is not None:
            shape[d] //= self.size
        return tuple(shape)

    def sq_norm(self, tree) -> torch.Tensor:
        """Σ x² over a tree keyed by parameter path: a sharded leaf's
        blocks each once (summed over the model axis), a replicated leaf
        once."""
        sq = lambda xs: sum(torch.sum(torch.square(x.to(torch.float32)))
                            for x in xs)
        dev = next(iter(tree.values())).device
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        shard = sq([x for k, x in tree.items() if self.sharded(k)]) + zero
        rep = sq([x for k, x in tree.items() if not self.sharded(k)]) + zero
        coll.all_reduce(shard, self.mesh, self.axis)
        return shard + rep


@dataclasses.dataclass(frozen=True)
class RowBlock:
    """A rank's row block [r0, r0 + rb) of a factor of d = n·rb rows
    split over ``axis`` (``kfac_state_sharding``'s rows on "model"), and
    the collectives of the factor work on such blocks: a reduction over
    the d rows is the same reduction on the local rows summed over the
    axis (:meth:`sum`), and a side that needs its U whole gathers the
    blocks (:meth:`gather`)."""
    mesh: Any
    axis: str
    index: int
    rb: int

    @property
    def r0(self) -> int:
        return self.index * self.rb

    def take(self, x: torch.Tensor, dim: int = -2) -> torch.Tensor:
        """The rank's rows of a whole ``x`` (a view)."""
        return x.narrow(dim, self.r0, self.rb)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` if it holds the rank's rows already (rb rows), else its
        rows of the whole."""
        return x if x.shape[-2] == self.rb else self.take(x)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the axis (contiguous, in place)."""
        return coll.all_reduce(x.contiguous(), self.mesh, self.axis)

    def sum_all(self, xs) -> None:
        """Every tensor of ``xs`` summed over the axis, in place, in one
        packed collective."""
        coll.all_reduce_coalesced(list(xs), self.mesh, self.axis)

    def gather(self, x: torch.Tensor, dim: int = -2) -> torch.Tensor:
        """The whole from the ranks' blocks along ``dim`` (no gradient)."""
        return coll.all_gather(x.detach(), self.mesh, self.axis,
                               dim % x.dim())

    def gather_all(self, xs, dims) -> list:
        """:meth:`gather` of each ``xs[i]`` along ``dims[i]``, packed into
        one collective."""
        return coll.all_gather_coalesced(
            list(xs), self.mesh, self.axis,
            [d % x.dim() for x, d in zip(xs, dims)])


class Composed:
    """Two shardings of one tree applied in turn (``first`` outermost):
    a curvature engine's layout of an optimizer state and the model
    axis's blocks of its parameter-shaped leaves touch disjoint leaves,
    so a restore localizes by both and a save gathers by both."""

    def __init__(self, first, second):
        self.first, self.second = first, second

    def localize(self, tree):
        return localize(localize(tree, self.first), self.second)

    def globalize(self, tree):
        return globalize(globalize(tree, self.second), self.first)

    def global_template(self, tree):
        return global_template(global_template(tree, self.second),
                               self.first)


def replicated(tree, mesh):
    return _map_with_path(lambda path, leaf: NamedSharding(mesh, P()), tree)


# ---------------------------------------------------------------------------
# a rank's local slice of a global tensor
# ---------------------------------------------------------------------------

def _blocks(sharding: NamedSharding, ndim: int):
    """[(dim, n_blocks, block index)] of this rank under ``sharding``."""
    mesh, out = sharding.mesh, []
    sizes = _sizes(mesh)
    for i, entry in enumerate(tuple(sharding.spec)[:ndim]):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        n, idx = 1, 0
        for a in names:                 # row-major over the named axes
            idx = idx * sizes[a] + mesh.coord(a)
            n *= sizes[a]
        if n > 1:
            out.append((i, n, idx))
    return out


def local_slice(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of the global ``x`` under ``sharding`` (a copy:
    the global tensor may be freed)."""
    for dim, n, idx in _blocks(sharding, x.ndim):
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of a {tuple(x.shape)} "
                             f"tensor does not split into {n} blocks")
        size = x.shape[dim] // n
        x = x.narrow(dim, idx * size, size)
    return x.clone(memory_format=torch.contiguous_format)


def _gather_blocks(x: torch.Tensor, sharding: NamedSharding
                   ) -> torch.Tensor:
    """Inverse of :func:`local_slice`: the global tensor, on every rank
    (collective over the sharded axes)."""
    for i, entry in reversed(list(enumerate(tuple(sharding.spec)[:x.ndim]))):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        for a in reversed(names):
            x = coll.all_gather(x, sharding.mesh, a, dim=i)
    return x


def _walk(tree, shardings, leaf_fn, obj_fn):
    if shardings is None or tree is None:
        return tree
    if hasattr(shardings, "localize"):            # a layout object
        return obj_fn(shardings, tree)
    if isinstance(shardings, NamedSharding):
        if isinstance(tree, torch.Tensor):
            return leaf_fn(tree, shardings)
        return tree
    if isinstance(tree, Mapping):
        return type(tree)({k: _walk(v, shardings.get(k), leaf_fn, obj_fn)
                           for k, v in tree.items()})
    if _is_dc(tree):
        return dataclasses.replace(tree, **{
            f.name: _walk(getattr(tree, f.name),
                          getattr(shardings, f.name, None), leaf_fn, obj_fn)
            for f in dataclasses.fields(tree)})
    return tree


def localize(tree, shardings):
    """This rank's slice of every leaf of a global ``tree`` under the
    matching ``shardings`` tree (None: kept whole)."""
    return _walk(tree, shardings, local_slice,
                 lambda sh, sub: sh.localize(sub))


def globalize(tree, shardings):
    """The global tree from every rank's local ``tree`` (collective)."""
    return _walk(tree, shardings, _gather_blocks,
                 lambda sh, sub: sh.globalize(sub))


def global_template(tree, shardings):
    """A tree of the global shapes of a local ``tree`` (uninitialized
    tensors: a restore fills them)."""
    def leaf(x, sh):
        shape = list(x.shape)
        for dim, n, _ in _blocks(sh, x.ndim):
            shape[dim] *= n
        if shape == list(x.shape):
            return x
        return torch.empty(shape, dtype=x.dtype, device=x.device
                           ).requires_grad_(x.requires_grad)
    return _walk(tree, shardings, leaf,
                 lambda sh, sub: sh.global_template(sub))
