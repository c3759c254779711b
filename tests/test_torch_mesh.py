"""The port's meshes, sharding rules, the builders' and the CLI's mesh
branches, checkpoints across meshes and the elastic runner, against the
reference, on the CPU.

* **Rules** (no processes): ``param_spec``/``fit_spec`` through
  ``params_sharding``, ``params_sharding_fsdp``, ``kfac_state_sharding``
  (without and with curvature and row axes), ``batch_sharding`` and
  ``cache_sharding`` (each layout, ``shard_seq``) over the full-width
  abstract trees of all ten architectures (the builders' meta trees
  against the reference's ``eval_shape`` trees) at (16, 16) [data, model]
  and (2, 16, 16) [pod, data, model] stand-in meshes.  The reference's
  functions build ``NamedSharding``s, which need a real mesh: the tests
  swap that name in the reference modules for one that records the spec,
  for the duration of a test.
* **Builders**: ``shard_policy_for``, ``kv_rep_for`` and the train,
  prefill and decode builders' shardings against the reference's.
* **Four ranks** (one world, a module fixture, ``torch_dist_worker.py``):
  a builder step on a 2 × 2 [data, curv] mesh against the reference's
  replicated step; the CLI at ``--mesh 2x2 --mesh-axes data,curv``
  against the port's own ``--mesh none`` run (losses at 1e-5, the engine
  seen in its log lines) and on a model axis (tensor-parallel, the same
  losses; only ``plan="fsdp"`` refused); metrics on ≡ off and
  health on ≡ off under the engine (``tests/test_obs.py:301``,
  ``tests/test_chaos.py:276``); a checkpoint saved on (2, 2) restored on
  (2, 1) and on one device, synchronous and mid-lag
  (``tests/test_mesh2d.py:362``, ``:395``), and into the reference's
  ``restore``; the elastic runner's cases (``tests/test_fault_tolerance.py
  :216``, ``:229``, ``tests/test_chaos.py:519``, ``tests/test_mesh2d.py
  :577``) and the host-loss drills in 1D and 2D with compressed gathers
  (``tests/test_chaos.py:576``, ``:626``) through it.
"""
import contextlib
import dataclasses
import io
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ARCH_NAMES  # noqa: E402
from repro.configs.base import Segment as JSegment  # noqa: E402
from repro.configs.base import ShapeCell as JCell  # noqa: E402
from repro.configs.base import get_arch as jget  # noqa: E402
from repro.core import kfac as jkfac  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.distributed import curvature as jcurv  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.lm import LM as JLM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import base as jbase  # noqa: E402
from repro.train import checkpoint as jck  # noqa: E402
from repro.train import elastic as jelastic  # noqa: E402
from repro_torch import specs as tspecs  # noqa: E402
from repro_torch.configs.base import get_arch as tget  # noqa: E402
from repro_torch.distributed import curvature as tcurv  # noqa: E402
from repro_torch.distributed import sharding as tshd  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.obs import events as tev  # noqa: E402
from repro_torch.train import elastic as telastic  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
import torch_dist_worker as worker  # noqa: E402

CPU = torch.device("cpu")
META = torch.device("meta")


def stand_in(shape, axes):
    return types.SimpleNamespace(axis_names=tuple(axes),
                                 devices=np.zeros(shape))


MESH_16 = stand_in((16, 16), ("data", "model"))
MESH_2_16 = stand_in((2, 16, 16), ("pod", "data", "model"))
MESHES = {"16x16": MESH_16, "2x16x16": MESH_2_16}


class _Spec:
    """What the reference's patched ``NamedSharding`` records."""

    def __init__(self, mesh, spec):
        self.spec = tuple(spec)


@pytest.fixture
def ref_specs(monkeypatch):
    """The reference's sharding functions, returning specs."""
    monkeypatch.setattr(jshd, "NamedSharding", _Spec)
    monkeypatch.setattr(jsteps, "NamedSharding", _Spec)


def jspecs(tree):
    """{path: spec} of a reference tree of recorded specs."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, _Spec))[0]
    return {jshd._leaf_path(kp): leaf.spec for kp, leaf in flat}


def tspecs_of(tree, path=()):
    """{path: spec} of a port tree of shardings."""
    out = {}
    if isinstance(tree, tshd.NamedSharding):
        out["/".join(path)] = tuple(tree.spec)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(tspecs_of(v, path + (str(k),)))
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            out.update(tspecs_of(getattr(tree, f.name), path + (f.name,)))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(tspecs_of(v, path + (str(i),)))
    return out


def hd_on_model(ref, cache, m):
    """The reference's "hd"-layout cache specs (its sequence rule: it
    re-lays the cache out inside the step) with the port's documented
    difference: a ≥5-D KV leaf takes its head dim on "model", the layout
    the port's decode step reads."""
    shapes = tspecs_shapes(cache)
    out = dict(ref)
    for k, spec in ref.items():
        shape = shapes[k]
        if k.rsplit("/", 1)[-1] in tshd._SEQ_CACHE_LEAVES and len(shape) >= 5:
            want = jshd.P(None, spec[1], None, None, "model",
                          *((None,) * (len(shape) - 5)))
            out[k] = tuple(jshd.fit_spec(want, shape, m))
    return out


def tspecs_shapes(tree, path=()):
    """{path: shape} of a port tree of tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(tspecs_shapes(v, path + (str(k),)))
        return out
    return {"/".join(path): tuple(tree.shape)}


def _same(port, ref, what, allow_missing=()):
    """The port's specs equal the reference's on every shared path; the
    port has no path the reference lacks, and lacks only the allowed
    ones (each package's own leaves)."""
    assert set(port) <= set(ref), (what, sorted(set(port) - set(ref))[:5])
    missing = {k for k in set(ref) - set(port)
               if not any(a in k for a in allow_missing)}
    assert not missing, (what, sorted(missing)[:5])
    bad = {k: (port[k], ref[k]) for k in port if port[k] != ref[k]}
    assert not bad, (what, list(bad.items())[:5])


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def test_make_mesh_past_the_world_raises_as_the_reference():
    """Too few ranks is ``jax.make_mesh``'s ValueError (16 exceeds both the
    one-process world and any host-device count the suite sets)."""
    with pytest.raises(ValueError, match="must be >= the product"):
        tmesh.make_mesh((4, 4), ("data", "curv"), device=CPU)
    with pytest.raises(ValueError, match="must be >= the product"):
        jmesh.make_mesh((4, 4), ("data", "curv"))
    for m in MESHES.values():
        assert tmesh.data_axes(m) == jmesh.data_axes(m)


# ---------------------------------------------------------------------------
# the rules over the ten architectures' abstract trees
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trees():
    """Both packages' default train builders (abstract parameters and
    optimizer state) and decode builders (abstract caches), per
    architecture."""
    out = {}
    for n in ARCH_NAMES:
        jb, tb = (jsteps.build_train_step(jget(n)),
                  tsteps.build_train_step(tget(n), device=CPU))
        jd, td = (jsteps.build_decode_step(jget(n)),
                  tsteps.build_decode_step(tget(n), device=CPU))
        out[n] = (jb, tb, jd.arg_specs[0], td.arg_specs[0])
    return out


#: leaves only the reference's optimizer state has: the AdamW fallback's
#: moments of the tapped parameters (the port keeps them for the untapped
#: ones only; train/checkpoint.py's caveat)
FALLBACK = ("fallback/mu/", "fallback/nu/")


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_and_state_rules_equal_reference(name, mesh, trees,
                                               ref_specs):
    jb, tb, _, _ = trees[name]
    m = MESHES[mesh]
    _same(tspecs_of(tshd.params_sharding(tb.abstract_params, m)),
          jspecs(jshd.params_sharding(jb.abstract_params, m)), "params")
    _same(tspecs_of(tshd.params_sharding_fsdp(tb.abstract_params, m)),
          jspecs(jshd.params_sharding_fsdp(jb.abstract_params, m)), "fsdp")
    for kw in (dict(), dict(curvature_axis="data"),
               dict(curvature_axis="data", row_axis=m.axis_names[0])):
        _same(tspecs_of(tshd.kfac_state_sharding(tb.abstract_opt, m, **kw)),
              jspecs(jshd.kfac_state_sharding(jb.abstract_opt, m, **kw)),
              f"opt {kw}", allow_missing=FALLBACK)
    _same(tspecs_of(tshd.batch_sharding(tb.batch_specs, m)),
          jspecs(jshd.batch_sharding(jb.batch_specs, m)), "batch")
    _same(tspecs_of(tshd.replicated(tb.abstract_params, m)),
          jspecs(jshd.replicated(jb.abstract_params, m)), "replicated")


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_cache_rules_equal_reference(name, mesh, trees, ref_specs):
    _, _, jc, tc = trees[name]
    m = MESHES[mesh]
    for kw in (dict(), dict(layout="heads"), dict(shard_seq=True),
               dict(small_seq_threshold=1 << 20), dict(layout="hd")):
        ref = jspecs(jshd.cache_sharding(jc, m, **kw))
        if kw.get("layout") == "hd":
            ref = hd_on_model(ref, tc, m)
        _same(tspecs_of(tshd.cache_sharding(tc, m, **kw)), ref,
              f"cache {kw}")


def test_param_spec_and_fit_spec_equal_reference():
    paths = ["embed", "head/w", "mtp/w", "segments/0/p0/mix/wq",
             "segments/0/p0/mix/wo", "segments/0/p0/ffn/wi",
             "segments/0/p0/ffn/wo", "segments/0/p0/ffn/router",
             "segments/0/p0/ffn/shared_wi", "segments/0/p0/ln",
             "segments/0/p0/mix/x_wkv", "segments/0/p0/ffn/wo_f"]
    for m in MESHES.values():
        for p in paths:
            for nd in (1, 2, 3, 4):
                assert tuple(tshd.param_spec(p, nd, m)) == \
                    tuple(jshd.param_spec(p, nd, m))
        for spec, shape in (((None, "model"), (7, 51865)),
                            (("data", "model"), (32, 64)),
                            ((("pod", "data"), None), (64, 3)),
                            (("model",), ())):
            assert tuple(tshd.fit_spec(tshd.P(*spec), shape, m)) == \
                tuple(jshd.fit_spec(jshd.P(*spec), shape, m))


# ---------------------------------------------------------------------------
# the builders' mesh branches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_policy_and_kv_rep_equal_reference(mesh):
    m = MESHES[mesh]
    for kw in (dict(), dict(shard_kv_seq=True),
               dict(seq_shard_residual=False)):
        # the reference's fields; the port's policy also holds the mesh its
        # data-parallel collectives run over
        tpol = tsteps.shard_policy_for(m, **kw)
        jpol = dict(jsteps.shard_policy_for(m, **kw).__dict__)
        assert {f: getattr(tpol, f) for f in jpol} == jpol
        assert tpol.mesh is m
    for n in ARCH_NAMES:
        assert tsteps.kv_rep_for(tget(n), m) == jsteps.kv_rep_for(jget(n), m)


@pytest.mark.parametrize("plan", ["tp", "fsdp"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_builder_shardings_equal_reference(mesh, plan, ref_specs):
    """The builders' in/out shardings at gemma3-4b's full width (the rules
    themselves are held over all ten architectures above)."""
    name = "gemma3_4b"
    for m in (MESHES[mesh],):
        jb = jsteps.build_train_step(jget(name), mesh=m, plan=plan)
        tb = tsteps.build_train_step(tget(name), mesh=m, plan=plan,
                                     device=CPU)
        for i, what in enumerate(("params", "opt", "batch", "rng")):
            ref = jspecs(jb.in_shardings[i])
            _same(tspecs_of(tb.in_shardings[i]), ref, what,
                  allow_missing=FALLBACK)
        _same(tspecs_of(tb.out_shardings[2]), jspecs(jb.out_shardings[2]),
              "loss")
        jp = jsteps.build_prefill_step(jget(name), mesh=m)
        tp = tsteps.build_prefill_step(tget(name), mesh=m, device=CPU)
        _same(tspecs_of(tp.in_shardings), jspecs(jp.in_shardings), "pre")
        assert tuple(tp.out_shardings.spec) == jp.out_shardings.spec
        for layout in ("seq", "heads", "hd"):
            jd = jsteps.build_decode_step(jget(name), mesh=m,
                                          cache_layout=layout)
            td = tsteps.build_decode_step(tget(name), mesh=m,
                                          cache_layout=layout, device=CPU)
            ref_in, ref_out = (jspecs(jd.in_shardings),
                               jspecs(jd.out_shardings))
            if td.lm.sp.kv_cache_layout == "hd":    # "heads" may fall back
                cache = td.arg_specs[0]
                ref_in.update({f"1/{k}": v for k, v in hd_on_model(
                    {k[2:]: v for k, v in ref_in.items()
                     if k.startswith("1/")}, cache, m).items()})
                ref_out.update({f"1/{k}": v for k, v in hd_on_model(
                    {k[2:]: v for k, v in ref_out.items()
                     if k.startswith("1/")}, cache, m).items()})
            _same(tspecs_of(td.in_shardings), ref_in, f"decode {layout}")
            _same(tspecs_of(td.out_shardings), ref_out,
                  f"decode out {layout}")


def test_dist_spec_attach_builds_the_engine():
    """``DistSpec.attach`` builds and attaches the engine (the reference's
    metadata on a stand-in mesh); an inactive spec is a no-op; ``dist=``
    mixed with the loose pair raises."""
    from repro_torch.core import kfac as tkfac
    from repro_torch.core import policy as tpolicy
    from test_torch_dist import _buckets, _mixed_taps
    m = stand_in((2, 2), ("data", "curv"))
    jb, _ = _buckets("mixed")
    opt = tkfac.Kfac(tkfac.KfacConfig(policy=tpolicy.PolicyConfig(
        variant="brkfac", r=8, max_dense_dim=8192)), _mixed_taps(tkfac),
        device=CPU)
    spec = tspecs.DistSpec(mesh=m, curvature_axis="curv", row_axis="data",
                           curvature_compress=4)
    eng = spec.attach(opt)
    assert opt.curvature is eng and isinstance(eng, tcurv.CurvatureEngine)
    je = jcurv.CurvatureEngine(m, "curv", jb, row_axis="data",
                               compress_rank=4)
    assert eng.describe() == je.describe()
    assert je.align == eng.align == 4
    assert opt.scheduler().units == opt.scheduler(align=4).units
    assert tspecs.DistSpec().attach(opt) is None
    with pytest.raises(ValueError, match="conflicts"):
        tloop.run_kfac_training(None, opt, {}, [], n_tokens=1, dist=spec,
                                mesh=m, device=CPU)


@pytest.mark.parametrize("mesh,want", [
    (((4, 2), ("data", "curv")), ("curv", "data")),
    (((2, 4), ("data", "curv")), ("curv", "data")),
    (((1, 4), ("data", "curv")), ("curv", None)),
    (((4, 1), ("data", "curv")), ("data", None)),
    (((4, 2), ("data", "model")), ("data", None)),
    (((1, 2), ("data", "model")), (None, None)),
    (((2, 2, 2), ("pod", "data", "model")), ("pod", None)),
    (((2, 2, 2), ("pod", "curv", "model")), ("curv", "pod"))])
def test_cli_curvature_axes_are_the_references(mesh, want):
    """``--curvature auto``'s choice (reference ``launch/train.py:160``):
    a ``curv`` axis larger than 1 takes the slots and the next data axis
    larger than 1 the rows, else the first data axis takes the slots."""
    args = ttrain.parse_args(["--device", "cpu"])
    assert ttrain.curvature_axes(args, stand_in(*mesh)) == want
    args = ttrain.parse_args(["--device", "cpu", "--curvature", "none"])
    assert ttrain.curvature_axes(args, stand_in(*mesh)) == (None, None)


# ---------------------------------------------------------------------------
# the elastic ladders (pure)
# ---------------------------------------------------------------------------

def test_ladders_equal_reference():
    for args, kw in (((8,), {}), ((4,), dict(axes=("data", "model"))),
                     ((8,), dict(axes=("data", "curv"), shape=(4, 2))),
                     ((4,), dict(axes=("data", "curv"), shape=(2, 2)))):
        assert telastic.device_ladder(*args, **kw) == \
            jelastic.device_ladder(*args, **kw)
    axes = ("data", "curv")
    for a, b in (((4, 2), (2, 2)), ((1, 2), (1, 1)), ((2, 2), (2, 2))):
        assert telastic.shrunk_axes(a, b, axes) == \
            jelastic.shrunk_axes(a, b, axes)
    assert telastic.FALLBACK_MESHES == jelastic.FALLBACK_MESHES
    # one process with no world: the ladder of one
    assert telastic.device_ladder() == (((1,), ("data",)),)


# ---------------------------------------------------------------------------
# four ranks
# ---------------------------------------------------------------------------

B, T = 4, 16        # the batch splits over the mesh's four data ranks
HEAVY = dict(do_stats=True, do_light=True, do_heavy=True)
CLI = ["--reduced", "--variant", "brkfac", "--steps", "6", "--device", "cpu"]


def jcut(vocab=256):
    """The workers' depth cut (``torch_dist_worker.tcut``) in the
    reference: reduced gemma3's first layer, scanned twice."""
    red = jget("gemma3_4b").reduced()
    return dataclasses.replace(red, vocab=vocab, n_layers=2, segments=(
        JSegment((red.segments[0].pattern[0],), repeats=2),))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh")
    arch = jcut()
    params = JLM(arch).init(jax.random.PRNGKey(0))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    rs = np.random.default_rng(0)
    batch = {"tokens": rs.integers(0, arch.vocab, (B, T)).astype(np.int32)}
    batch["targets"] = batch["tokens"]
    cases = [
        {"name": "builder", "kind": "builder", "init": np_tree(params),
         "batch": batch, "B": B, "T": T, "flags": HEAVY},
        {"name": "cli", "kind": "cli",
         "argv": CLI + ["--mesh", "2x2", "--mesh-axes", "data,curv"],
         "model_argv": CLI + ["--mesh", "2x2"]},
        {"name": "ckpt", "kind": "ckpt", "dir": str(root / "ckpt")},
        {"name": "elastic", "kind": "elastic", "dir": str(root / "el")}]
    for v in ("bkfac", "nskfac"):
        cases.append({"name": f"obs-{v}", "kind": "obs_health",
                      "variant": v, "dir": str(root)})
    join = worker.start("mesh", cases, str(root), timeout=200)
    # the oracles, meanwhile: the reference's replicated builder step and
    # the port's own --mesh none CLI run
    ref = {}
    tb = jsteps.build_train_step(arch, cell=JCell("t", T, B, "train"),
                                 flags=HEAVY)
    p, _, loss = jax.jit(tb.step_fn)(params, tb.opt.init(params),
                                     {k: jnp.asarray(v)
                                      for k, v in batch.items()},
                                     jax.random.PRNGKey(1))
    ref["builder"] = (np_tree(params), float(loss), np_tree(p))
    with contextlib.redirect_stdout(io.StringIO()):
        _, ref["cli"] = ttrain.run(ttrain.parse_args(CLI),
                                   arch=worker.tcut())
    return join(), ref


def _one(world, name):
    return worker.ok(world[0], name)


def test_builder_step_on_a_2x2_mesh_equals_reference(world):
    """``build_train_step`` with ``dist`` on [data, curv] (slots on curv,
    M rows on data): one step (stats, light, heavy) from the reference's
    parameters, on every rank, at test_torch_launch.py's tolerances (the
    loss at 1e-5, each parameter's change at 2e-3 of its scale)."""
    from repro_torch import convert
    init, loss, after = world[1]["builder"]
    flat0 = convert.params_from_jax(init, device=CPU)
    want = convert.params_from_jax(after, device=CPU)
    for got in _one(world, "builder"):
        assert got["in_sh"] and "axis=curv n=2 rows=data" in got["engine"]
        assert abs(got["loss"] - loss) <= 1e-5 * abs(loss)
        for k, w in want.items():
            d_want = (w - flat0[k]).numpy().astype(np.float64)
            d_got = got["after"][k].astype(np.float64) - flat0[k].numpy()
            scale = max(np.abs(d_want).max(), 1e-30)
            assert np.abs(d_got - d_want).max() <= 2e-3 * scale, k


def test_cli_on_a_2x2_mesh_equals_no_mesh(world):
    """``--mesh 2x2 --mesh-axes data,curv`` on four ranks ≡ ``--mesh
    none``: losses at 1e-5; rank 0's log shows the engine (slots on curv,
    rows on data) and the memory it divides; the other ranks print
    nothing; a model axis larger than 1 (``--mesh 2x2``: data, model)
    runs tensor-parallel to the same losses, and only ``plan="fsdp"`` is
    refused, naming ROADMAP §1 item 5."""
    want = world[1]["cli"]
    runs = _one(world, "cli")
    for got in runs:
        np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
        np.testing.assert_allclose(got["model_losses"], want, rtol=1e-5)
        assert "item 5" in got["refused"] and "fsdp" in got["refused"]
    log = runs[0]["console"]
    assert "curvature sharded on 'curv'" in log
    assert "rows=data n_rows=2" in log and "dense-M memory" in log
    assert all(not r["console"] for r in runs[1:])


@pytest.mark.parametrize("variant", ["bkfac", "nskfac"])
def test_sharded_metrics_and_health_are_inert(world, variant):
    """Under the engine on (4,), metrics on ≡ off and health on ≡ off, bit
    for bit, on every rank (tests/test_obs.py:301, test_chaos.py:276);
    rank 0's log validates and its metric windows are finite."""
    from repro_torch.obs import summary as tsum
    for got in _one(world, f"obs-{variant}"):
        p_off, l_off = got["off"]
        for other in ("metrics", "health"):
            p, losses = got[other]
            assert losses == l_off, other
            for k in p_off:
                np.testing.assert_array_equal(p[k], p_off[k])
    path = _one(world, f"obs-{variant}")[0]["events"]
    evs = list(tev.read_events(path))
    metrics = [e for e in evs if e["type"] == "metrics"]
    assert metrics
    for e in metrics:
        assert set(e["values"]) == set(e["kinds"])
        assert all(np.isfinite(v) for v in e["values"].values())
    assert tsum.main([path, "--validate"]) == 0


@pytest.mark.parametrize("tag", ["sync", "async"])
def test_checkpoint_restores_across_meshes(world, tag):
    """Saved on (2, 2) (the row-sharded M gathered at save), restored on
    (2, 1) and on one device: both continuations equal the uninterrupted
    (2, 2) run (test_mesh2d.py's tolerance, rtol 1e-5); ``async`` saves
    right after a launch, with the snapshot still in flight."""
    got = _one(world, "ckpt")
    for r, res in enumerate(got):
        run = res[tag]
        cut = run["saved_step"]
        np.testing.assert_allclose(run["head"], run["ref"][:cut],
                                   rtol=1e-5, atol=1e-7)
        if r < 2:
            np.testing.assert_allclose(run["tail_21"], run["ref"][cut:],
                                       rtol=1e-5, atol=1e-7)
        else:
            assert "tail_21" not in run
    first = got[0][tag]
    np.testing.assert_allclose(first["tail_1"], first["ref"][cut:],
                               rtol=1e-5, atol=1e-7)
    if tag == "async":
        assert any(first["inflight_live"])


def test_mesh_checkpoint_restores_in_the_reference(world):
    """A checkpoint written on the (2, 2) mesh is the one-device format:
    the reference's ``restore`` takes it (fallback moments restricted to
    the untapped parameters, none here) and holds the gathered M."""
    saved = _one(world, "ckpt")[0]["sync"]
    taps = {"fc": jkfac.TapInfo("fc/w", 48, 32, n_stat=16)}
    jopt = jkfac.Kfac(jkfac.KfacConfig(
        policy=jpolicy.PolicyConfig(variant="kfac", r=4,
                                    max_dense_dim=8192),
        lr=jbase.constant(0.05), T_updt=1, T_inv=4, stagger=True,
        stagger_splits=2), taps)
    params = {"fc": {"w": jnp.zeros((48, 32))}}
    full = jopt.init(params)
    tmpl = {"params": params, "opt": full._replace(
        fallback=jadamw.AdamWState(step=full.fallback.step, mu={}, nu={}))}
    jgot, man = jck.restore(saved["dir"], tmpl)
    assert man["step"] == saved["saved_step"]
    assert int(jgot["opt"].step) == saved["saved_step"]
    for side in "AG":
        M = saved["gathered"][f"factors|fc|{side}|M"]
        assert M.shape == ((48, 48) if side == "A" else (32, 32))
        np.testing.assert_array_equal(
            np.asarray(getattr(jgot["opt"].factors["fc"], side).M), M)


def test_elastic_runner_restarts_and_walks_the_ladder(world):
    """test_fault_tolerance.py:216 and :229 on four ranks (the one-member
    rungs are rank 0; the others wait for the run's end)."""
    got = _one(world, "elastic")
    res = got[0]["resume"]
    assert res["info"]["restarts"] == 1 and res["failed"] == [7]
    want = np.zeros(4)
    for k in range(10):
        want = want + (k + 1)
    np.testing.assert_allclose(res["x"], want)
    assert all(g["resume"]["x"] is None for g in got[1:])
    dbl = got[0]["double"]
    assert dbl["info"]["restarts"] == 2 and len(dbl["calls"]) == 3
    assert all(g["double"]["info"] == dbl["info"] for g in got)


def test_elastic_runner_events_and_the_2d_axis(world):
    """The world's own 2D ladder (2, 2) → (1, 2) → (1, 1): a failure at
    step 2 drops a data row; the repartition events (one per rung) name
    the shrunk axis, one stage-4 remediation is emitted (rank 0's writer
    only), and the final mesh's members finish."""
    got = _one(world, "elastic")
    ax = got[0]["axis"]
    assert ax["ladder"] == jelastic.device_ladder(
        4, axes=("data", "curv"), shape=(2, 2))
    reps = [f for e, f in ax["events"] if e == "repartition"]
    remeds = [f for e, f in ax["events"] if e == "remediation"]
    assert len(reps) == 2 and reps[1].get("axis") == "data"
    assert len(remeds) == 1 and remeds[0]["stage"] == 4
    assert remeds[0]["action"] == "repartition"
    assert all(not g["axis"]["events"] for g in got[1:])
    assert ax["info"] == {"restarts": 1, "mesh_idx": 1}
    assert got[1]["axis"]["x"] is not None and got[2]["axis"]["x"] is None


@pytest.mark.parametrize("tag", ["host_1d", "host_2d"])
def test_host_loss_resumes_the_phase_on_the_shrunk_mesh(world, tag):
    """Chaos's host loss at step 7 mid-stagger-cycle; the runner drops one
    rung ((4,) → (2,); (2, 2) → (1, 2) with rank-6 compressed gathers),
    restores step 6 under the new rung's shardings and resumes: the
    cadence continues label for label (no warmup spike) and the losses
    track the uninterrupted run (test_chaos.py's rtol 5e-3)."""
    got = _one(world, "elastic")[0]
    run, ref = got[tag], got[tag + "_ref"]
    assert run["info"]["restarts"] == 1
    assert [e for e, _ in run["events"]].count("remediation") == 1
    assert sorted(run["log"]) == list(range(12))
    ref_labels = [ref["log"][k][1] for k in range(12)]
    assert [run["log"][k][1] for k in range(12)] == ref_labels
    assert run["log"][7][1] != ref_labels[0]
    shrunk = run["log"][7][2]
    assert np.prod(shrunk) == np.prod(run["log"][0][2]) // 2
    np.testing.assert_allclose([run["log"][k][0] for k in range(12)],
                               [ref["log"][k][0] for k in range(12)],
                               rtol=5e-3, atol=1e-5)
    assert all(np.isfinite(v).all() for v in run["params"].values())
