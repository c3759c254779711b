"""Fault-tolerant checkpointing: npz + JSON manifest with a crc32 for each
array, atomic publish, an async writer thread, and a restore that walks
past damaged snapshots.

Counterpart of ``src/repro/train/checkpoint.py`` (manifest schema v6).
Layout, as the reference's::

    <dir>/step_000000123/
        manifest.json   {step, schema, time, n_arrays, bytes, checksums,
                         extra, tenants, done: true}
        arrays.npz      flat {key: np.ndarray}
    <dir>/LATEST        atomic pointer file

A snapshot is visible only once its manifest says ``done`` and ``LATEST``
points at it.

**Leaf keys are the reference's.**  A key is the leaf's path joined by
``|``: dict keys (a flat parameter name such as ``conv0_0/w`` splits at
its ``/`` into ``conv0_0|w``, the reference's nesting, while a tap name
such as ``segments/seg0/p0/attn_q`` stays one key, as in the reference,
under the fields a state type lists in its ``TAP_KEYED``), then dataclass
field names — ``params|fc0|w``, ``opt|step``, ``opt|factors|fc0|A|U``,
``opt|fallback|mu|…``.  The port's host-side counters (Python ints) are
written as int32 0-d arrays, as the reference stores them.  So a
checkpoint written by either package restores in the other through a
``{"params": …, "opt": …}`` template.  Two caveats of the cross-package
restore: the port's AdamW fallback keeps moments for the untapped
parameters only (``optim/adamw.py``), where the reference's keeps them for
every parameter and never reads the tapped ones — a reference template
takes a port checkpoint with its fallback moments restricted to the
untapped parameters; and two leaves stay each package's own:

  * ``rng`` — the port saves ``torch.Generator.get_state()`` (a uint8
    array); a torch generator cannot continue a ``jax.random`` key, nor
    the other way round;
  * ``opt|inflight|…`` — the port's in-flight buffers snapshot the launch
    step's *draws* (``draws``) where the reference's snapshot per-slot
    keys (``keys``; see ``core/kfactor.py``), so an async state restores
    within the port only.

**Meshes.**  A checkpoint is always in the one-device format: a state
laid out by the distributed curvature engine is gathered back to its
global, slot-ordered tensors before it is saved (the training loop and
the elastic runner do that through ``distributed/sharding.py``), and
:func:`restore` with ``shardings=`` reads the global tensors and keeps
each rank's own slice of them — so a file written on one mesh restores
on another, on one device, or in the reference.

**Snapshots are taken on the calling thread.**  The training loop updates
the parameters in place (``optim/base.py::apply_updates``), so
:func:`save` and :meth:`AsyncCheckpointer.submit` copy every leaf to host
memory before they return; the writer thread only ever sees those copies.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import shutil
import threading
import time
import zipfile
import zlib
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

SEP = "|"

#: Manifest schema version (the reference's): v1 a state without
#: ``KfacState.phase``; v2 added ``phase``; v3 added ``KfacState.inflight``
#: (async in-flight buffers); v4 added ``KFactorState.aux``; v5 added the
#: per-array crc32 ``checksums``; v6 added the ``tenants`` table (the
#: multi-tenant service's {tenant, slot, step} rows, ``serve/service.py``;
#: ``None`` for a single-tenant trainer).  The schema explains restore
#: failures; it does not reject compatible checkpoints.
SCHEMA_VERSION = 6

_SCHEMA_HISTORY = {
    1: "the first pytree (KfacState without `phase`)",
    2: "pytree with KfacState.phase",
    3: "pytree with KfacState.inflight async buffers",
    4: "pytree with KFactorState.aux heavy-op diagnostics",
    5: "manifest with per-array crc32 checksums; same pytree as v4",
    6: "manifest with a per-tenant `tenants` table; same pytree rules "
       "as v5",
}


def _step_dir(step: int) -> str:
    return f"step_{step:09d}"


def _digest(arr: np.ndarray) -> str:
    """crc32 over the raw bytes (torn-write / bit-rot detection, not
    cryptographic integrity)."""
    crc = zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xffffffff
    return f"{crc:08x}"


def _tap_keyed(node) -> Tuple[str, ...]:
    """The fields of a state dataclass whose mappings are keyed by tap
    name: the reference keeps a tap name ("segments/seg0/p0/attn_q") as
    one key, where a parameter path ("segments/0/p0/mix/wq") is a nest of
    keys.  A state type declares them in its ``TAP_KEYED``."""
    return getattr(type(node), "TAP_KEYED", ())


def _path_of(key, whole: bool = False) -> Tuple[str, ...]:
    return (str(key),) if whole else tuple(str(key).split("/"))


def _is_dataclass(node) -> bool:
    return dataclasses.is_dataclass(node) and not isinstance(node, type)


def leaves(tree) -> Dict[str, Any]:
    """{key: leaf} of ``tree`` — a nest of dicts and dataclasses over
    tensors, generators and Python ints (``None`` has no leaves) — keyed
    as a checkpoint keys them; the leaves are not copied (meta tensors
    too: the step builders' abstract trees)."""
    out: Dict[str, Any] = {}

    def walk(node, path, whole=False):
        key = SEP.join(path)
        if node is None:
            return
        if isinstance(node, (torch.Tensor, torch.Generator, int)):
            out[key] = node
        elif isinstance(node, Mapping):
            for k in sorted(node, key=str):
                walk(node[k], path + _path_of(k, whole))
        elif _is_dataclass(node):
            keyed = _tap_keyed(node)
            for f in dataclasses.fields(node):
                walk(getattr(node, f.name), path + (f.name,),
                     f.name in keyed)
        else:
            raise TypeError(f"checkpoint: cannot save leaf {key!r} of type "
                            f"{type(node).__name__}")

    walk(tree, ())
    return out


def _flatten(tree) -> Dict[str, np.ndarray]:
    """{key: host copy} of every leaf of ``tree`` (see :func:`leaves`)."""
    out: Dict[str, np.ndarray] = {}
    for key, node in leaves(tree).items():
        if isinstance(node, torch.Tensor):
            out[key] = node.detach().to("cpu", copy=True).numpy()
        elif isinstance(node, torch.Generator):
            out[key] = node.get_state().numpy().copy()
        else:
            out[key] = np.asarray(node, np.int32)
    return out


def _unflatten_into(template, arrays: Dict[str, np.ndarray]):
    """A tree shaped like ``template`` with every leaf taken from
    ``arrays``: tensors land on the template leaf's device and dtype (a
    template tensor that requires grad gives one that does too)."""

    def get(path, shape):
        key = SEP.join(path)
        if key not in arrays:
            raise KeyError(key)
        arr = arrays[key]
        if shape is not None and tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{key}: shape {arr.shape} != {tuple(shape)}")
        return arr

    def build(node, path, whole=False):
        if node is None:
            return None
        if isinstance(node, torch.Tensor):
            arr = get(path, node.shape)
            t = torch.from_numpy(np.array(arr)).to(device=node.device,
                                                   dtype=node.dtype)
            return t.requires_grad_(node.requires_grad)
        if isinstance(node, torch.Generator):
            g = torch.Generator(device=node.device)
            saved = get(path, None)
            try:
                g.set_state(torch.from_numpy(np.array(saved, np.uint8)))
            except RuntimeError as e:   # another device's generator
                raise ValueError(
                    f"{SEP.join(path)}: a {saved.size}-byte generator "
                    f"state does not fit a {node.device.type} generator "
                    f"({e}); restore through a template without it"
                    ) from e
            return g
        if isinstance(node, int):
            return int(get(path, ()))
        if isinstance(node, Mapping):
            return type(node)({k: build(v, path + _path_of(k, whole))
                               for k, v in node.items()})
        if _is_dataclass(node):
            keyed = _tap_keyed(node)
            return dataclasses.replace(node, **{
                f.name: build(getattr(node, f.name), path + (f.name,),
                              f.name in keyed)
                for f in dataclasses.fields(node)})
        raise TypeError(f"checkpoint: cannot restore leaf "
                        f"{SEP.join(path)!r} of type {type(node).__name__}")

    return build(template, ())


def _write(directory: str, step: int, arrays: Dict[str, np.ndarray],
           extra: Optional[dict], tenants: Optional[List[dict]]) -> str:
    os.makedirs(directory, exist_ok=True)
    name = _step_dir(step)
    tmp = os.path.join(directory, f".tmp_{name}_{os.getpid()}")
    final = os.path.join(directory, name)
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "schema": SCHEMA_VERSION,
        "time": time.time(),
        "n_arrays": len(arrays),
        "bytes": int(sum(a.nbytes for a in arrays.values())),
        "checksums": {k: _digest(a) for k, a in arrays.items()},
        "extra": extra or {},
        "tenants": tenants,
        "done": True,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    latest_tmp = os.path.join(directory, ".LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(name)
    os.replace(latest_tmp, os.path.join(directory, "LATEST"))
    return final


def save(directory: str, step: int, tree, extra: Optional[dict] = None,
         tenants: Optional[List[dict]] = None) -> str:
    """Synchronous checkpoint write with atomic publish; returns the
    snapshot's directory.  Every leaf is copied to the host before
    anything is written.  ``tenants`` is the reference's schema-v6 table
    (``None`` for a single-tenant trainer)."""
    return _write(directory, step, _flatten(tree), extra, tenants)


def latest_step(directory: str) -> Optional[int]:
    ptr = os.path.join(directory, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    man = os.path.join(directory, name, "manifest.json")
    if not os.path.exists(man):
        return None
    try:
        with open(man) as f:
            m = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return m["step"] if m.get("done") else None


class SchemaMismatchError(RuntimeError):
    """A checkpoint's structure does not match the template — raised with
    the manifest schema versions so the operator knows whether to migrate
    or re-run."""


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint's on-disk bytes are damaged — truncated archive,
    unreadable manifest, or an array whose crc32 disagrees with the
    manifest's; ``restore_latest_healthy`` walks past these."""


def restore(directory: str, template, step: Optional[int] = None,
            shardings=None) -> Tuple[Any, dict]:
    """Load a checkpoint into the template's structure → (tree,
    manifest).  Tensors land on the device (and in the dtype) of the
    template's leaves.  ``shardings`` (a tree matching the template's, of
    ``distributed/sharding.py`` shardings or layout objects) re-lays the
    global tensors onto a mesh: the template is then this rank's local
    state, and each rank keeps its own slice.  A checkpoint missing a
    leaf the template has fails with a :class:`SchemaMismatchError`
    naming both schema versions; damaged bytes with a
    :class:`CheckpointCorruptionError`."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, _step_dir(step))
    man_path = os.path.join(path, "manifest.json")
    try:
        with open(man_path) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorruptionError(
            f"checkpoint manifest {man_path} is unreadable ({e}); the "
            f"snapshot is damaged — delete {path} or use "
            f"restore_latest_healthy() to fall back to an older one."
        ) from e
    npz_path = os.path.join(path, "arrays.npz")
    try:
        with np.load(npz_path) as z:
            arrays = {k: z[k] for k in z.files}
    except (OSError, ValueError, zipfile.BadZipFile, EOFError) as e:
        raise CheckpointCorruptionError(
            f"checkpoint archive {npz_path} is truncated or unreadable "
            f"({type(e).__name__}: {e}); likely a torn write — delete "
            f"{path} or use restore_latest_healthy() to fall back."
        ) from e
    for key, expect in manifest.get("checksums", {}).items():
        if key not in arrays:
            raise CheckpointCorruptionError(
                f"checkpoint {npz_path}: array {key!r} listed in the "
                f"manifest is missing from the archive (torn write).")
        found = _digest(arrays[key])
        if found != expect:
            raise CheckpointCorruptionError(
                f"checkpoint {npz_path}: array {key!r} failed integrity "
                f"check — expected crc32 {expect}, found {found}.  The "
                f"snapshot is corrupt; delete {path} or use "
                f"restore_latest_healthy() to fall back.")
    if shardings is not None:
        from repro_torch.distributed import sharding as shd
        template = shd.global_template(template, shardings)
    try:
        tree = _unflatten_into(template, arrays)
    except KeyError as e:
        found = manifest.get("schema", 1)
        raise SchemaMismatchError(
            f"checkpoint {path} has manifest schema v{found} "
            f"({_SCHEMA_HISTORY.get(found, 'unknown layout')}) but this "
            f"build restores schema v{SCHEMA_VERSION} "
            f"({_SCHEMA_HISTORY[SCHEMA_VERSION]}): leaf {e.args[0]!r} is "
            f"missing from the saved arrays.  Re-run training from "
            f"scratch, or migrate the checkpoint (load it with the "
            f"writing build's state template, then re-save with this "
            f"one).  Async note: a pre-async checkpoint restores fine "
            f"when async_heavy is off; turning async on mid-run needs a "
            f"fresh (or migrated) checkpoint because the in-flight "
            f"buffers join the pytree.") from e
    if shardings is not None:
        tree = shd.localize(tree, shardings)
    return tree, manifest


def available_steps(directory: str) -> List[int]:
    """All snapshot step numbers present on disk, oldest first (healthy
    or not; in-progress ``.tmp_`` directories excluded)."""
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        if d.startswith("step_"):
            try:
                out.append(int(d[len("step_"):]))
            except ValueError:
                continue
    return sorted(out)


def restore_latest_healthy(directory: str, template,
                           shardings=None) -> Tuple[Any, dict]:
    """Restore the newest snapshot that passes verification, walking the
    ring past corrupted, truncated or mismatched ones (the rollback stage
    of the remediation ladder).  The returned manifest carries
    ``skipped_corrupt``: one ``{step, error}`` record for every newer
    snapshot walked past.  Raises ``FileNotFoundError`` if no healthy
    snapshot exists.  ``shardings`` as in :func:`restore`."""
    skipped: List[dict] = []
    for step in reversed(available_steps(directory)):
        try:
            tree, manifest = restore(directory, template, step=step,
                                     shardings=shardings)
        except (CheckpointCorruptionError, SchemaMismatchError,
                OSError, KeyError, ValueError) as e:
            skipped.append({"step": step,
                            "error": f"{type(e).__name__}: {e}"})
            continue
        if not manifest.get("done"):
            skipped.append({"step": step, "error": "manifest not done"})
            continue
        manifest = dict(manifest)
        manifest["skipped_corrupt"] = skipped
        return tree, manifest
    detail = "; ".join(f"step {s['step']}: {s['error'].splitlines()[0]}"
                       for s in skipped) or "directory empty"
    raise FileNotFoundError(
        f"no healthy checkpoint in {directory} ({detail})")


def prune(directory: str, keep: int = 3) -> None:
    if not os.path.isdir(directory):
        return
    ckpts = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_"))
    for d in ckpts[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


class AsyncCheckpointer:
    """Background writer: :meth:`submit` copies every leaf to the host on
    the calling thread (the parameters change in place at the next step),
    then serialization, checksums and IO run on a worker thread."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, arrays, extra = item
            try:
                _write(self.directory, step, arrays, extra, None)
                prune(self.directory, self.keep)
            except BaseException as e:      # surfaced on next submit/close
                self._err = e
            finally:
                self._q.task_done()

    def submit(self, step: int, tree, extra: Optional[dict] = None):
        if self._err is not None:
            raise RuntimeError("async checkpoint failed") from self._err
        self._q.put((step, _flatten(tree), extra))

    def wait(self):
        self._q.join()
        if self._err is not None:
            raise RuntimeError("async checkpoint failed") from self._err

    def close(self):
        self._q.join()
        self._q.put(None)
        self._thread.join(timeout=10)
        if self._err is not None:
            raise RuntimeError("async checkpoint failed") from self._err
