"""The port's launch dry-run (``src/repro_torch/launch/dryrun.py`` and
``hlo_analysis.py``) against the reference's, on the CPU.

The reference's numbers come from its own ``repro.launch.dryrun``
(``_lower_cell_inner`` and ``_analyse``: a compiled step's HLO through
``repro.launch.hlo_analysis``), in spawned processes started first.
Importing that module forces 512 host devices on every later JAX client
of its process, so it is never imported here: each oracle process sets
its own ``XLA_FLAGS`` and imports it there.  The oracles are split over
three processes so that the file stays near a minute alone (reduced
gemma3's two train steps take ~45 s of XLA compile between them).  The
port's dry-runs run in a fourth spawned process, as the dry-run is meant
to (it joins the ``fake`` backend as rank 0: worlds of 1, 256, 512 and
4 ranks in turn), so that no process group is left in this one.

* **Matmul flops** on a (1, 1) mesh with ``unroll=True``, at 2 × 64,
  for reduced gemma3-4b and reduced deepseek-v3 (MoE and MLA): prefill,
  decode and the train step under ``uniform_work(False, False, False)``
  equal the reference's ``dot_flops`` at REL; the light train step (stats
  and light) equals it once the port's count of the Brand init products
  (the products inside ``brand.init_from_factor`` of a first step) is
  added, because the reference's HLO holds both branches of
  ``lax.cond(first, _init, _update)`` and its parser counts both.
  ONE_SIDED lists the products only one side counts (none at these
  cells; the thin SVD of the Brand init has no product on either side).
* **Argument bytes** on (1, 1): the reference's ``memory_analysis()``,
  each difference named: in the train step the port holds neither the
  AdamW fallback's moments of the tapped parameters (the reference keeps
  them and never reads them, ``train/checkpoint.py``'s caveat) nor the
  step counters as tensors (host ints); and ``jax.jit`` drops the
  arguments a step does not read, which the port's caller still holds
  (deepseek's multi-token-prediction head in prefill and decode; the rng
  key of a step without heavy work, so it is in neither count).
* **Per-device bytes on 16×16** for both reduced archs' train step
  (batch 32 × 64): the port's rank-0 parameters, factors, fallback
  moments and batch under ``in_shardings`` equal the sums of
  ``NamedSharding.shard_shape`` sizes under the reference's own rules
  (256 host devices, nothing compiled).
* **The collective convention**: a ``shard_map`` with ``psum``,
  ``all_gather`` and ``psum_scatter`` on 4 host devices through the
  reference's ``collective_bytes``, and the same collectives of the same
  per-device blocks through the port's counter on a 4-rank fake world:
  the same ``by_kind``.
* **MoE on a data mesh**: reduced deepseek's train and prefill steps on
  a (2, 2) fake world run on meta tensors (a rank's expert capacity by
  rule, with no host read).
* **The CLI**: ``main(["--arch", "mamba2_2p7b", "--shape", "decode_32k",
  "--both-meshes", "--force"])`` writes both production meshes' records
  (status ok, the reference's keys); reduced gemma3's train step on both
  production meshes through ``analyse_cell`` ends ok with the same keys.
"""
import concurrent.futures
import json
import multiprocessing
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.configs.base import ShapeCell, get_arch  # noqa: E402
from repro_torch.core import brand  # noqa: E402
from repro_torch.launch import dryrun, hlo_analysis  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402

ARCHS = ("gemma3_4b", "deepseek_v3_671b")
B, T = 2, 64
BIG_B = 32              # the 16×16 cell: the batch over 16 data ranks
REL = 1e-6
NO_WORK = dict(do_stats=False, do_light=False, do_heavy=False)
#: (arch, cell) → products counted by one side only, as (side, flops);
#: none at these cells
ONE_SIDED = {}
#: every key a reader of the reference's records takes (its run_cell,
#: less what only a compile gives: lower_s, compile_s, the generated
#: code size and the probe lowerings' keys)
REF_KEYS = {"arch", "shape", "mesh", "opt", "time", "status", "flops",
            "dot_flops", "bytes", "collective_bytes", "collectives",
            "n_devices", "temp_size_in_bytes", "argument_size_in_bytes",
            "output_size_in_bytes", "flops_corrected",
            "dot_flops_corrected", "bytes_corrected",
            "collective_bytes_corrected", "roofline", "model_flops",
            "useful_flops_ratio"}
ROOFLINE_KEYS = {"t_compute_s", "t_memory_s", "t_collective_s",
                 "bottleneck", "roofline_fraction"}
KINDS = ("prefill", "decode", "train_idle", "train")


def _cell(kind, batch=B):
    return ShapeCell(kind, T, batch, kind.split("_")[0])


# ---------------------------------------------------------------------------
# the reference's side (spawned processes only)
# ---------------------------------------------------------------------------

def _jmesh(shape, axes):
    import jax
    from jax.sharding import AxisType
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(
        shape))


def _flat(tree, leaf=None) -> dict:
    """A reference tree's leaves by their "/"-joined path."""
    import jax
    key = lambda p: str(getattr(p, "key", getattr(p, "name", getattr(
        p, "idx", p))))
    return {"/".join(key(p) for p in path): x for path, x in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=leaf)[0]}


def _ref_cells(arch_name, kinds):
    """The reference dry-run's dot flops, argument bytes and collective
    bytes of ``kinds`` at 2 × 64 on (1, 1), unrolled; and, for the train
    step, the bytes of its arguments the port keeps off the device."""
    import jax
    from repro.configs.base import ShapeCell as JCell
    from repro.configs.base import get_arch as jget
    from repro.launch import dryrun as rd
    from repro.launch import steps as js
    arch = jget(arch_name).reduced()
    mesh = _jmesh((1, 1), ("data", "model"))
    out = {}
    for kind in kinds:
        cell = JCell(kind, T, B, kind.split("_")[0])
        with mesh:
            if kind == "train_idle":
                built = js.build_train_step(arch, mesh, cell=cell,
                                            unroll=True, flags=NO_WORK)
                fn = jax.jit(built.step_fn, in_shardings=built.in_shardings,
                             out_shardings=built.out_shardings,
                             donate_argnums=(0, 1))
                lowered = fn.lower(
                    built.abstract_params, built.abstract_opt,
                    built.batch_specs,
                    jax.ShapeDtypeStruct((2,), jax.numpy.uint32))
            else:
                lowered = rd._lower_cell_inner(arch, cell, mesh, True)
            rec = rd._analyse(lowered, 1)
        row = {k: rec[k] for k in ("dot_flops", "argument_size_in_bytes",
                                   "collective_bytes")}
        if kind.startswith("train"):
            built = js.build_train_step(arch, mesh, cell=cell, unroll=True)
            tapped = {t.param_path for t in built.opt.taps.values()}
            st = built.abstract_opt
            nb = lambda x: int(np.prod(x.shape)) * x.dtype.itemsize
            row["tapped_moments"] = sum(
                nb(x) for tree in (st.fallback.mu, st.fallback.nu)
                for k, x in _flat(tree).items() if k in tapped)
            row["counters"] = sum(nb(x) for x in (
                st.step, st.n_stats, st.phase, st.fallback.step))
        out[kind] = row
    return out


def _ref_shard_bytes(arch_name):
    """Per-device bytes of the reduced arch's train step on 16×16 under the
    reference's in_shardings: parameters, factors, the fallback moments of
    the untapped leaves, the batch."""
    import jax
    from repro.configs.base import ShapeCell as JCell
    from repro.configs.base import get_arch as jget
    from repro.launch import steps as js
    arch = jget(arch_name).reduced()
    mesh = _jmesh((16, 16), ("data", "model"))
    built = js.build_train_step(arch, mesh, cell=JCell("train", T, BIG_B,
                                                       "train"))
    p_sh, o_sh, b_sh = built.in_shardings[:3]
    st = built.abstract_opt

    is_sh = lambda x: isinstance(x, jax.sharding.NamedSharding)
    tapped = {t.param_path for t in built.opt.taps.values()}

    def size(tree, shardings, keep=lambda k: True):
        shs = _flat(shardings, is_sh)
        return sum(int(np.prod(shs[k].shard_shape(x.shape)))
                   * x.dtype.itemsize for k, x in _flat(tree).items()
                   if keep(k))
    return {"params": size(built.abstract_params, p_sh),
            "factors": size(st.factors, o_sh.factors),
            "fallback": sum(size(getattr(st.fallback, f),
                                 getattr(o_sh.fallback, f),
                                 lambda k: k not in tapped)
                            for f in ("mu", "nu")),
            "batch": size(built.batch_specs, b_sh)}


def _ref_collectives():
    """``psum``, tiled ``all_gather`` and tiled ``psum_scatter`` of (8, 16)
    fp32 blocks in a ``shard_map`` on 4 host devices, through the
    reference's parser."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.launch import hlo_analysis as rh
    mesh = _jmesh((4,), ("x",))

    def f(a, b, c):
        return (jax.lax.psum(a, "x"),
                jax.lax.all_gather(b, "x", axis=0, tiled=True),
                jax.lax.psum_scatter(c, "x", scatter_dimension=0,
                                     tiled=True))
    g = jax.shard_map(f, mesh=mesh, in_specs=(P("x"),) * 3,
                      out_specs=(P("x"), P("x"), P("x")), check_vma=False)
    x = jax.ShapeDtypeStruct((32, 16), jnp.float32)
    text = jax.jit(g).lower(x, x, x).compile().as_text()
    return rh.collective_bytes(text)[1]


def _oracle(job):
    """One oracle process's share of the reference's numbers."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    if job == "gemma3_4b:train":
        return {"gemma3_4b": _ref_cells("gemma3_4b", ("train",))}
    if job == "gemma3_4b":
        return {"gemma3_4b": _ref_cells("gemma3_4b", KINDS[:3])}
    return {"deepseek_v3_671b": _ref_cells("deepseek_v3_671b", KINDS),
            "shards": {a: _ref_shard_bytes(a) for a in ARCHS},
            "collectives": _ref_collectives()}


# ---------------------------------------------------------------------------
# the port's fake worlds (a spawned process)
# ---------------------------------------------------------------------------

def _port_fake_worlds(cli_dir):
    """The port's cells at (1, 1) (``_port_cells``), its per-device bytes
    on 16×16, reduced gemma3 on both production meshes, its counter's
    convention on a 4-rank world, and the CLI."""
    from repro_torch.distributed import collectives as coll
    meta = torch.device("meta")
    dryrun.fake_world(1)
    out = {"cells": {a: _port_cells(a) for a in ARCHS}, "shards": {}}
    dryrun.fake_world(256)
    mesh = mesh_lib.make_production_mesh(device=meta)
    for a in ARCHS:
        params, state, batch = dryrun._lower_cell(
            get_arch(a).reduced(), _cell("train", BIG_B), mesh).take()
        out["shards"][a] = {
            "params": dryrun.tree_bytes(params),
            "factors": dryrun.tree_bytes(state.factors),
            "fallback": dryrun.tree_bytes(state.fallback),
            "batch": dryrun.tree_bytes(batch)}
    out["records"] = {}
    for multi_pod in (False, True):
        dryrun.fake_world(512 if multi_pod else 256)
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                             device=meta)
        out["records"][multi_pod] = dryrun.analyse_cell(
            get_arch("gemma3_4b").reduced(), _cell("train", BIG_B), mesh)
    dryrun.fake_world(4)
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), device=meta)
    out["moe"] = {}
    for k in ("train", "prefill"):
        try:
            out["moe"][k] = dryrun.analyse_cell(
                get_arch("deepseek_v3_671b").reduced(), _cell(k, 4), mesh)
        except Exception as e:      # the test reports it
            out["moe"][k] = {"error": f"{type(e).__name__}: {e}"}
    mesh = mesh_lib.make_mesh((4,), ("x",), device=meta)
    x = torch.empty((8, 16), device=meta)
    with coll.counting() as tally:
        coll.all_reduce(x.clone(), mesh, "x")
        coll.all_gather(x, mesh, "x", 0)
        coll.reduce_scatter(x, mesh, "x", 0)
    out["collectives"] = dict(tally.by_kind)
    dryrun.RESULTS_DIR = cli_dir
    dryrun.main(["--arch", "mamba2_2p7b", "--shape", "decode_32k",
                 "--both-meshes", "--force"])
    out["cli"] = {f: json.load(open(os.path.join(cli_dir, f)))
                  for f in sorted(os.listdir(cli_dir))}
    torch.distributed.destroy_process_group()
    return out


def _port_cells(arch_name):
    """The port's dry-run of KINDS at 2 × 64 on (1, 1), unrolled, and the
    Brand init products of a first step."""
    mesh = mesh_lib.make_mesh((1, 1), ("data", "model"),
                              device=torch.device("meta"))
    arch = get_arch(arch_name).reduced()
    out = {}
    for kind in KINDS:
        kw = dict(flags=NO_WORK) if kind == "train_idle" else {}
        traced = dryrun._lower_cell(arch, _cell(kind), mesh, unroll=True,
                                    **kw)
        out[kind] = dryrun._analyse(traced, 1)
        out[kind]["unused_mtp"] = sum(
            dryrun.tree_bytes(v) for k, v in traced.built.abstract_params
            .items() if k.startswith("mtp/"))
    init = hlo_analysis.DotCounter()
    orig = brand.init_from_factor

    def counted(*a, **kw):
        with init:
            return orig(*a, **kw)
    brand.init_from_factor = counted
    try:
        dryrun._analyse(dryrun._lower_cell(arch, _cell("train"), mesh,
                                           unroll=True, first=True), 1)
    finally:
        brand.init_from_factor = orig
    out["brand_init_flops"] = init.total
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    here = os.path.dirname(os.path.abspath(__file__))
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join([here] + ([old] if old
                                                         else []))
    try:
        pool = concurrent.futures.ProcessPoolExecutor(
            4, mp_context=multiprocessing.get_context("spawn"))
        jobs = {j: pool.submit(_oracle, j) for j in
                ("gemma3_4b:train", "deepseek_v3_671b", "gemma3_4b")}
        fake = pool.submit(_port_fake_worlds,
                           str(tmp_path_factory.mktemp("dryrun")))
    finally:
        if old is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = old
    ref = {}
    for f in jobs.values():
        for k, v in f.result().items():
            ref[k] = {**ref.get(k, {}), **v} if k in ARCHS else v
    fake = fake.result()
    pool.shutdown()
    return ref, fake.pop("cells"), fake


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1.0)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["prefill", "decode", "train_idle"])
def test_dot_flops_equal_the_references(runs, arch, kind):
    """Prefill, decode and the train step without factor work: the same
    matmul flops as the reference's HLO parser (REL), no products on one
    side only, and no collective on a (1, 1) mesh."""
    ref, port, _ = runs
    want = ref[arch][kind]
    got = port[arch][kind]
    assert not ONE_SIDED.get((arch, kind))
    assert _rel(got["dot_flops"], want["dot_flops"]) <= REL, (
        got["dot_flops"], want["dot_flops"])
    assert got["collective_bytes"] == want["collective_bytes"] == 0
    assert got["dot_flops_corrected"] == got["dot_flops"]


@pytest.mark.parametrize("arch", ARCHS)
def test_light_step_flops_equal_the_references_with_both_brand_branches(
        runs, arch):
    """The light step (stats and light, past the first update) plus the
    port's Brand init products equals the reference's count, which holds
    both branches of its ``lax.cond(first, _init, _update)``."""
    ref, port, _ = runs
    got = port[arch]["train"]["dot_flops"] + port[arch]["brand_init_flops"]
    assert _rel(got, ref[arch]["train"]["dot_flops"]) <= REL, (
        got, ref[arch]["train"]["dot_flops"])
    assert port[arch]["train"]["dot_flops"] > port[arch]["train_idle"][
        "dot_flops"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", KINDS)
def test_argument_bytes_equal_the_references(runs, arch, kind):
    """Argument bytes ≡ the reference's ``memory_analysis()``, less the
    train step's tapped-leaf AdamW moments and step counters (the port
    holds neither as a tensor), plus what the reference's jit drops as
    unread: the MTP head outside training (the rng key, which a step
    without heavy work never reads, is dropped there too and so is in
    neither count)."""
    ref, port, _ = runs
    want, got = ref[arch][kind], port[arch][kind]
    if kind.startswith("train"):
        off = -(want["tapped_moments"] + want["counters"])
    else:
        off = got["unused_mtp"]
    assert got["argument_size_in_bytes"] == want["argument_size_in_bytes"] \
        + off, (got["argument_size_in_bytes"], want["argument_size_in_bytes"],
                off)
    assert (got["unused_mtp"] > 0) == (arch == "deepseek_v3_671b")


@pytest.mark.parametrize("arch", ARCHS)
def test_per_device_bytes_on_16x16_equal_the_reference_rules(runs, arch):
    """Rank 0's parameters, factors, fallback moments and batch on the
    16×16 mesh ≡ ``NamedSharding.shard_shape`` under the reference's
    in_shardings."""
    ref, _, fake = runs
    assert fake["shards"][arch] == ref["shards"][arch]


def test_counter_convention_equals_the_reference_parser(runs):
    """psum / all_gather / psum_scatter of (8, 16) fp32 blocks over 4
    members: the port's counter and the reference's HLO parser give the
    same bytes and calls by kind."""
    ref, _, fake = runs
    assert fake["collectives"] == ref["collectives"]
    assert fake["collectives"]["all-gather"] == 4 * 8 * 16 * 4


def test_reduced_arch_on_both_production_meshes(runs):
    """Reduced gemma3's train step on 16×16 and 2×16×16: the reference's
    record keys, 256 and 512 devices, collectives on every data axis."""
    _, _, fake = runs
    for multi_pod, rec in fake["records"].items():
        assert REF_KEYS - {"arch", "shape", "mesh", "opt", "time",
                           "status"} <= set(rec)
        assert ROOFLINE_KEYS <= set(rec["roofline"])
        assert rec["n_devices"] == (512 if multi_pod else 256)
        axes = {"pod", "data", "model"} if multi_pod else {"data", "model"}
        assert {a for tag in rec["collective_bytes_by_axis"]
                for a in tag.split("+")} == axes
        assert rec["dot_flops"] > 0 and rec["temp_size_in_bytes"] > 0


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_moe_on_a_data_mesh_reads_nothing_from_the_device(runs, kind):
    """Reduced deepseek (MoE) on a (2, 2) mesh: a data-parallel rank's
    expert buffers take ⌈C / data ranks⌉ rows (``moe_capacity="even"``),
    so the step runs on meta tensors, where any host read would raise."""
    _, _, fake = runs
    rec = fake["moe"][kind]
    assert "error" not in rec, rec.get("error")
    assert rec["moe_capacity_rule"].startswith("even")
    assert rec["dot_flops"] > 0 and rec["collectives"]["all-gather"] > 0


def test_cli_writes_both_meshes_records_with_the_reference_keys(runs):
    """The CLI (``--both-meshes --force``) on a full-size decode cell: two
    records, status ok, the reference's keys and its collective kinds."""
    _, _, fake = runs
    recs = fake["cli"]
    assert sorted(recs) == ["mamba2_2p7b__decode_32k__pod16x16.json",
                            "mamba2_2p7b__decode_32k__pod2x16x16.json"]
    for rec in recs.values():
        assert rec["status"] == "ok", rec.get("error")
        assert REF_KEYS <= set(rec), REF_KEYS - set(rec)
        assert ROOFLINE_KEYS <= set(rec["roofline"])
        assert set(rec["collectives"]) == set(
            hlo_analysis_kinds()), rec["collectives"]


def hlo_analysis_kinds():
    from repro_torch.distributed import collectives as coll
    return list(coll.KINDS) + [k + "_count" for k in coll.KINDS]


def test_live_bytes_adds_each_new_storage_and_takes_it_off_when_freed():
    """``LiveBytes`` on meta: arguments tracked, a new storage added when
    an op makes it (a view adds nothing), taken off when freed; the peak
    is the largest sum."""
    meta = torch.device("meta")
    x = torch.empty(1000, device=meta)                       # 4,000 bytes
    mem = dryrun.LiveBytes()
    with mem:
        mem.track([x, x[:10]])
        y = x * 2                                             # + 4,000
        z = torch.empty(500, dtype=torch.float64, device=meta)  # + 4,000
        v = y[100:]
        del y, z
        live_mid = mem.live                    # y's storage lives in v
        del v
    assert (mem.peak, live_mid, mem.live) == (12000, 8000, 4000)
