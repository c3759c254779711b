"""The port's one-device launch layer against the reference, on the CPU:
``launch/steps.py``'s builders and the trainer CLI ``launch/train.py``.

* **Abstract trees.**  For all ten architectures at full width, the
  builders' meta-device parameters, optimizer state, batch specs and
  decode arguments against the reference's ``jax.eval_shape`` trees —
  names (each package's checkpoint keys), shapes and dtypes; nothing is
  allocated or compiled.  Two things stay each package's own: the
  optimizer state's ``inflight`` buffers (none in the default config) and
  the AdamW fallback's moments of the tapped parameters, which the
  reference keeps and never reads (``train/checkpoint.py``'s caveat).
* **Steps.**  One ``build_train_step`` step (stats, light and the EVD
  heavy op), a prefill and three decode steps at reduced gemma3 (cut in
  depth to keep the reference's compile short: ``jcut``) against the
  reference's jitted ones, from the reference's parameters: the loss
  and logits at 1e-5 of their scale
  (``tests/test_torch_lm.py``'s tolerance), each parameter's change at
  ``tests/test_torch_lm_parts.py``'s trajectory tolerance, 2e-3 of the
  reference change's scale.
* **The CLI.**  ``--reduced`` runs of ``repro_torch.launch.train`` on the
  CPU against the reference CLI's (in-process runs of
  ``repro.launch.train.main`` at the same depth cut and a vocabulary of
  1024, without and with ``--compress``: a module fixture), with the
  reference's initial parameters, batches and compression bases
  injected: the losses at 1e-5 relative, each parameter's change at
  2e-3, and under ``--compress`` the compressed gradients of each step;
  ``--compress`` also against a hand-threaded ``compress_tree`` loop (bit
  for bit); ``--health`` with NaN batches through the ladder to a
  rollback that re-anchors the schedule; a resume from ``--ckpt-dir``.
"""
import argparse
import dataclasses
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ARCH_NAMES  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import Segment as JSegment  # noqa: E402
from repro.configs.base import ShapeCell as JCell  # noqa: E402
from repro.configs.base import get_arch as jget  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.distributed import compress as jcomp  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models.lm import LM as JLM  # noqa: E402
from repro.train import checkpoint as jck  # noqa: E402
from repro_torch import api, convert  # noqa: E402
from repro_torch import specs as tspecs  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeCell  # noqa: E402
from repro_torch.configs.base import Segment as TSegment  # noqa: E402
from repro_torch.configs.base import get_arch as tget  # noqa: E402
from repro_torch.distributed import compress as tcomp  # noqa: E402
from repro_torch.distributed import sharding as tshd  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from repro_torch.optim import base as toptbase  # noqa: E402
from repro_torch.train import checkpoint as tck  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402

CPU = torch.device("cpu")
REL = 1e-5
TRAJ = 2e-3
CLI_STEPS = 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small ops: one intra-op thread, as the LM tests pin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=REL, what=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= rel, f"{what}: max err {err:.3g} of the scale > {rel}"


# ---------------------------------------------------------------------------
# abstract trees at full width
# ---------------------------------------------------------------------------

def _jspecs(tree):
    """{checkpoint key: (shape, dtype)} of a reference abstract tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"|".join(jck._key_str(k) for k in kp):
            (tuple(leaf.shape), np.dtype(leaf.dtype).name)
            for kp, leaf in flat}


def _tspecs(tree):
    """The same of a port tree of meta tensors (host ints are the
    checkpoint's int32 scalars)."""
    out = {}
    for k, v in tck.leaves(tree).items():
        if isinstance(v, torch.Tensor):
            assert v.device.type == "meta", k
            out[k] = (tuple(v.shape), str(v.dtype).removeprefix("torch."))
        else:
            assert isinstance(v, int), k
            out[k] = ((), "int32")
    return out


@pytest.fixture(scope="module")
def built():
    """Both packages' default train builders for every architecture."""
    return {n: (jsteps.build_train_step(jget(n)),
                tsteps.build_train_step(tget(n), device=CPU))
            for n in ARCH_NAMES}


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_abstract_params_equal_reference(name, built):
    jb, tb = built[name]
    assert _tspecs(tb.abstract_params) == _jspecs(jb.abstract_params)
    assert tb.in_shardings is None and tb.out_shardings is None


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_abstract_opt_equals_reference(name, built):
    jb, tb = built[name]
    got, want = _tspecs(tb.abstract_opt), _jspecs(jb.abstract_opt)
    tapped = {t.param_path.replace("/", "|") for t in tb.opt.taps.values()}
    # the reference's fallback moments of the tapped parameters (kept,
    # never read) are not the port's
    want = {k: v for k, v in want.items()
            if not (k.startswith(("fallback|mu|", "fallback|nu|"))
                    and k.split("|", 2)[2] in tapped)}
    assert not any(k.startswith("inflight") for k in got)
    assert got == want


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_batch_specs_and_n_tokens_equal_reference(name):
    for cell in SHAPES:
        jc, tc = JSHAPES[cell], SHAPES[cell]
        want = {k: (tuple(v.shape), np.dtype(v.dtype).name)
                for k, v in jsteps.train_batch_specs(jget(name), jc).items()}
        got = tsteps.train_batch_specs(tget(name), tc)
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in got.items()} == want, cell
        assert all(v.device.type == "meta" for v in got.values())
        assert tsteps.n_tokens_of(tget(name), tc) == \
            jsteps.n_tokens_of(jget(name), jc)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_serve_specs_equal_reference(name):
    """Prefill's batch and parameters, decode's cache, token and position
    (with and without window caches) at full width."""
    jp = jsteps.build_prefill_step(jget(name))
    tp = tsteps.build_prefill_step(tget(name), device=CPU)
    assert _tspecs(tp.abstract_params) == _jspecs(jp.abstract_params)
    assert _tspecs(tp.arg_specs[0]) == _jspecs(jp.arg_specs[0])
    for window in (False, True):
        jd = jsteps.build_decode_step(jget(name), window_caches=window)
        td = tsteps.build_decode_step(tget(name), window_caches=window,
                                      device=CPU)
        assert _tspecs(td.arg_specs[0]) == _jspecs(jd.arg_specs[0])
        assert [(tuple(t.shape), str(t.dtype)) for t in td.arg_specs[1:]] \
            == [(tuple(t.shape), f"torch.{np.dtype(t.dtype).name}")
                for t in jd.arg_specs[1:]]


def test_one_device_policy_and_refusals():
    arch = tget("gemma3_4b").reduced()
    assert tsteps.kv_rep_for(arch, None) == 1
    assert tsteps.shard_policy_for(None) is tsteps.NO_SHARD
    with pytest.raises(ValueError, match="not both"):
        tsteps.build_train_step(arch, dist=tspecs.DistSpec(
            curvature_axis="curv"), curvature_axis="curv", device=CPU)
    # a mesh with a model axis larger than 1: the policy and the
    # shardings are the reference's (the port's policy also holds the
    # mesh its collectives run over, the forward's length, the LM's
    # parameter blocks, the decode caches' lengths and a data-parallel
    # rank's MoE capacity rule, "kept" unless the dry-run asks); the steps
    # build tensor-parallel (they run in test_torch_tp.py: no world here)
    mesh = argparse.Namespace(axis_names=("data", "model"),
                              devices=np.zeros((2, 2)))
    jarch = jget("gemma3_4b").reduced()
    assert tsteps.kv_rep_for(arch, mesh) == jsteps.kv_rep_for(jarch, mesh)
    tpol = tsteps.shard_policy_for(mesh).__dict__
    jpol = jsteps.shard_policy_for(mesh).__dict__
    assert {k: tpol[k] for k in jpol} == jpol
    assert set(tpol) - set(jpol) == {"mesh", "seq", "shards", "kv_lens",
                                     "moe_capacity"}
    assert tpol["moe_capacity"] == "kept"
    assert tpol["mesh"] is mesh
    built = tsteps.build_train_step(arch, mesh=mesh, device=CPU)
    dec = tsteps.build_decode_step(arch, mesh=mesh, device=CPU)
    pre = tsteps.build_prefill_step(arch, mesh=mesh, device=CPU)
    assert built.in_shardings is not None and dec.in_shardings is not None
    assert built.lm.sp.model_parallel and pre.lm.sp.model_parallel
    assert dec.lm.sp.kv_lens == (SHAPES["decode_32k"].seq_len, 0, False)
    # plan="fsdp" builds (its step runs on four ranks in
    # test_torch_{mesh,dp,tp}.py), with the async pipeline, a curvature
    # axis or both too: the state's sharding is FSDP's, composed with the
    # engine's layout where one is attached
    fsdp = tsteps.build_train_step(arch, mesh=mesh, plan="fsdp", device=CPU)
    assert fsdp.lm.sp.fsdp and fsdp.lm.sp.mesh is mesh
    for kw in (dict(async_heavy=True, heavy_lag=2),
               dict(curvature_axis="data"),
               dict(dist=tspecs.DistSpec(mesh=mesh, curvature_axis="data",
                                         row_axis="model",
                                         curvature_compress=8)),
               dict(curvature_axis="model", async_heavy=True)):
        where = {} if "dist" in kw else dict(mesh=mesh)
        tb = tsteps.build_train_step(arch, plan="fsdp", device=CPU,
                                     **where, **kw)
        assert tb.lm.sp.fsdp and tb.opt.model_shards.fsdp
        assert tb.opt.cfg.async_heavy == ("async_heavy" in kw)
        o_sh = tb.in_shardings[1]
        if tb.opt.curvature is None:
            assert o_sh == tshd.params_sharding_fsdp(tb.abstract_opt, mesh)
        else:
            assert isinstance(o_sh, tshd.Composed)
            assert o_sh.first.fallback == tshd.params_sharding_fsdp(
                tb.abstract_opt, mesh).fallback
        assert tb.out_shardings[1] is o_sh
    # it runs on a mesh of one member (every collective the identity):
    # each ≥ 2-D leaf a block of one, gathered per layer, the factor work
    # on rows and its buckets relaid, the same step as without a mesh;
    # the async pipeline's in-flight buffers (the --reduced optimizer
    # under B-R-KFAC at lag 2: the Brand init, a launch, a light step,
    # the landing) likewise; the per-tap path refuses under FSDP (no
    # reference entry point reaches it)
    cell = ShapeCell("t", T, B, "train")
    rs = np.random.default_rng(3)
    tokens = torch.as_tensor(rs.integers(0, 256, (B, T)))
    batch = {"tokens": tokens, "targets": tokens}
    lag = dict(kfac_config=ttrain.reduced_kfac_config("brkfac"),
               async_heavy=True, heavy_lag=2)
    steps = {}
    for tag, plan, m, kw in (("tp", "tp", None, {}),
                             ("fsdp", "fsdp", _OneMember(), {}),
                             ("tp-async", "tp", None, lag),
                             ("fsdp-async", "fsdp", _OneMember(), lag)):
        tb = tsteps.build_train_step(tcut(), mesh=m, cell=cell, flags=HEAVY,
                                     plan=plan, device=CPU, **kw)
        params = tb.lm.init(torch.Generator().manual_seed(0))
        init = {k: v.detach().clone() for k, v in params.items()}
        st = tb.opt.init(params)
        works = ([None] if not kw else
                 [_async_work(tb.opt, mask)
                  for mask in ("light", "launch", "light", "land")])
        losses = []
        for k, work in enumerate(works):
            if work is not None:
                tb = tsteps.build_train_step(tcut(), mesh=m, cell=cell,
                                             work=work, plan=plan,
                                             device=CPU, **kw)
            params, st, loss = tb.step_fn(params, st, batch,
                                          torch.Generator().manual_seed(k))
            losses.append(float(loss))
        steps[tag] = (init, params, losses)
    for tag in ("fsdp", "fsdp-async"):
        init, want, loss = steps[tag.replace("fsdp", "tp")]
        _, got, fsdp_loss = steps[tag]
        assert got.keys() == want.keys()
        np.testing.assert_allclose(fsdp_loss, loss, rtol=REL)
        for k in want:
            _close(got[k].detach() - init[k], want[k].detach() - init[k],
                   TRAJ, k)
    tb = tsteps.build_train_step(
        tcut(), mesh=_OneMember(), cell=cell, plan="fsdp", device=CPU,
        kfac_config=dataclasses.replace(tsteps.default_kfac_config(None),
                                        bucketed=False))
    params = tb.lm.init(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="bucketed update only"):
        tb.step_fn(params, tb.opt.init(params), batch,
                   torch.Generator().manual_seed(1))


def _async_work(opt, mask):
    """Stats and light, and with "launch"/"land" every async bucket's
    slots launched/landed."""
    from repro_torch.core import schedule
    none = tuple(() for _ in opt.factor_buckets)
    every = tuple(((0, b.total),) if bi in opt._async_buckets else ()
                  for bi, b in enumerate(opt.factor_buckets))
    return schedule.StepWork(stats=True, light=True, heavy=none,
                             launch=every if mask == "launch" else none,
                             land=every if mask == "land" else none)


class _OneMember:
    """A [data, model] mesh of one member: every collective over it is the
    identity, so no process group is needed."""
    axis_names = ("data", "model")
    devices = np.zeros((1, 1))
    shape = {"data": 1, "model": 1}
    size = 1

    def coord(self, axis):
        return 0

    def group(self, axis=None):
        return None


def test_api_exports_build_train_step():
    from repro import api as japi
    assert api.NOT_YET_PORTED == ()
    assert api.build_train_step is tsteps.build_train_step
    assert set(api.__all__) == set(japi.__all__)


# ---------------------------------------------------------------------------
# one step of each builder at reduced gemma3
# ---------------------------------------------------------------------------

B, T = 2, 32
#: the builders' step with the heavy op on: at the reduced config every
#: factor is EVD, so the default mask (stats + light) leaves the spectrum
#: empty and the step's update is clipped to zero in both packages; with
#: the EVD at the step the update is real (and draws no random numbers)
HEAVY = dict(do_stats=True, do_light=True, do_heavy=True)


def _cut(get, segment, vocab):
    """Reduced gemma3 cut in depth to keep the reference's compile short:
    its first local (sliding-window) layer and its global layer as one
    pattern, scanned twice (stacked taps of 2), at ``vocab``."""
    red = get("gemma3_4b").reduced()
    p = red.segments[0].pattern
    assert p[0].window and not p[5].window
    return dataclasses.replace(red, vocab=vocab, n_layers=4,
                               segments=(segment((p[0], p[5]), repeats=2),))


def jcut(vocab=256):
    return _cut(jget, JSegment, vocab)


def tcut(vocab=256):
    return _cut(tget, TSegment, vocab)


@pytest.fixture(scope="module")
def ref_steps():
    """The reference builders' steps at the depth-cut reduced gemma3,
    jitted: one train step (stats, light and heavy), a prefill and three
    decode steps."""
    arch = jcut()
    params = JLM(arch).init(jax.random.PRNGKey(0))
    rs = np.random.default_rng(0)
    batch = {"tokens": rs.integers(0, arch.vocab, (B, T)).astype(np.int32)}
    batch["targets"] = batch["tokens"]
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    out = {"init": np_tree(params), "batch": batch}
    tb = jsteps.build_train_step(arch, cell=JCell("t", T, B, "train"),
                                 flags=HEAVY)
    p, st, loss = jax.jit(tb.step_fn)(params, tb.opt.init(params),
                                      {k: jnp.asarray(v)
                                       for k, v in batch.items()},
                                      jax.random.PRNGKey(1))
    out["loss"], out["after"] = float(loss), np_tree(p)
    pb = jsteps.build_prefill_step(arch, cell=JCell("p", T, B, "prefill"))
    out["logits"] = np.asarray(jax.jit(pb.step_fn)(
        params, {"tokens": jnp.asarray(batch["tokens"])}))
    db = jsteps.build_decode_step(arch, cell=JCell("d", 16, B, "decode"))
    cache = db.lm.init_cache(B, 16)
    step = jax.jit(db.step_fn)
    out["decoded"] = []
    for t in range(3):
        lg, cache = step(params, cache,
                         jnp.asarray(batch["tokens"][:, t:t + 1]),
                         jnp.asarray(t))
        out["decoded"].append(np.asarray(lg))
    return out


def _tparams(np_tree):
    return {k: v.requires_grad_() for k, v in
            convert.params_from_jax(np_tree, device=CPU).items()}


def test_train_step_equals_reference(ref_steps):
    arch = tcut()
    tb = tsteps.build_train_step(arch, cell=ShapeCell("t", T, B, "train"),
                                 flags=HEAVY, device=CPU)
    params = _tparams(ref_steps["init"])
    batch = {k: torch.as_tensor(v) for k, v in ref_steps["batch"].items()}
    out, st, loss = tb.step_fn(params, tb.opt.init(params), batch,
                               torch.Generator().manual_seed(1))
    assert out is params and st.step == 1 and st.n_stats == 1
    assert abs(float(loss) - ref_steps["loss"]) <= \
        REL * abs(ref_steps["loss"])
    init = convert.params_from_jax(ref_steps["init"], device=CPU)
    want = convert.params_from_jax(ref_steps["after"], device=CPU)
    assert all(float((want[k] - init[k]).abs().max()) > 0 for k in want)
    for k in want:
        _close(out[k].detach() - init[k], want[k] - init[k], TRAJ, k)


def test_prefill_and_decode_equal_reference(ref_steps):
    arch = tcut()
    params = _tparams(ref_steps["init"])
    tokens = torch.as_tensor(ref_steps["batch"]["tokens"])
    pb = tsteps.build_prefill_step(arch, cell=ShapeCell("p", T, B,
                                                        "prefill"),
                                   device=CPU)
    logits = pb.step_fn(params, {"tokens": tokens})
    assert not logits.requires_grad
    _close(logits, ref_steps["logits"], what="prefill")
    db = tsteps.build_decode_step(arch, cell=ShapeCell("d", 16, B,
                                                       "decode"),
                                  device=CPU)
    cache = db.lm.init_cache(B, 16)
    for t in range(3):
        lg, cache = db.step_fn(params, cache, tokens[:, t:t + 1], t)
        _close(lg, ref_steps["decoded"][t], what=f"decode t={t}")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _capture_parser(call):
    """The parsed defaults and option strings of the parser ``call``
    builds (the reference CLI builds its parser inside ``main``, so
    ``parse_args`` is intercepted there)."""
    got = {}

    class Stop(Exception):
        pass

    orig = argparse.ArgumentParser.parse_args

    def intercept(self, args=None, namespace=None):
        got["ns"] = vars(orig(self, []))
        got["options"] = {s for a in self._actions
                          for s in a.option_strings}
        raise Stop

    argparse.ArgumentParser.parse_args = intercept
    try:
        call()
    except Stop:
        pass
    finally:
        argparse.ArgumentParser.parse_args = orig
    return got


def test_cli_flags_and_defaults_equal_reference():
    """Every flag of the reference with its default, plus ``--device``;
    a mesh larger than the world raises the reference's ValueError
    (``jax.make_mesh``'s: too few devices)."""
    ref = _capture_parser(jtrain.main)
    port = _capture_parser(ttrain.parse_args)
    assert port["options"] == ref["options"] | {"--device"}
    assert port["ns"] == dict(ref["ns"], device=None)
    with pytest.raises(ValueError, match="must be >= the product"):
        ttrain.run(ttrain.parse_args(["--mesh", "2x4", "--device", "cpu"]))


#: the CLI tests' vocabulary: the embedding and head (64 × 1024) reach
#: ``CompressConfig``'s ``min_size`` of 65536, so ``--compress`` acts on
#: them (at the reduced vocabulary of 256 every leaf is below it and
#: compression changes nothing)
CLI_VOCAB = 1024


def _ref_cli_run(argv, d):
    """One in-process run of the reference CLI for ``argv`` with its
    telemetry in ``d``, its ``--reduced`` arch replaced by
    ``jcut(CLI_VOCAB)`` → (its events, its final parameters, the
    compressed gradients of each step by leaf — none without
    ``--compress``)."""

    class Arch:
        def __init__(self, name):
            assert name == "gemma3_4b", name

        def reduced(self):
            return jcut(CLI_VOCAB)

    got, run_steps, compress_tree = {}, jtrain.run_steps, jcomp.compress_tree
    grads = []

    def keep(*a, **kw):
        got["state"] = run_steps(*a, **kw)
        return got["state"]

    def recorded(gp, cs, cfg):
        # the jitted step's compressed leaves, read back at each run of it
        out, cs = compress_tree(gp, cs, cfg)
        big = {"/".join(jck._key_str(k) for k in kp): v for kp, v in
               jax.tree_util.tree_flatten_with_path(out)[0]
               if v.ndim >= 2 and v.size >= cfg.min_size}
        jax.debug.callback(lambda t: grads.append(
            {k: np.asarray(v) for k, v in t.items()}), big)
        return out, cs

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "get_arch", Arch)
        mp.setattr(jtrain, "run_steps", keep)
        mp.setattr(jcomp, "compress_tree", recorded)
        mp.setattr(sys, "argv", ["train", *argv, "--telemetry-dir", d])
        jtrain.main()
    return (_events(d), jax.tree_util.tree_map(np.asarray,
                                               got["state"].params), grads)


@pytest.fixture(scope="module")
def ref_cli(tmp_path_factory):
    """The reference CLI at ``--reduced --steps CLI_STEPS`` (the arch cut
    by ``jcut(CLI_VOCAB)``), without and with ``--compress``, in process:
    each run's events and final parameters, and the initial parameters and
    batches it drew (PRNGKey(0), its TokenStream(seed=0))."""
    argv = ["--reduced", "--steps", str(CLI_STEPS)]
    out = {name: _ref_cli_run(argv + extra,
                              str(tmp_path_factory.mktemp(name)))
           for name, extra in (("plain", []), ("compress", ["--compress"]))}
    arch = jcut(CLI_VOCAB)
    out["init"] = jax.tree_util.tree_map(
        np.asarray, JLM(arch).init(jax.random.PRNGKey(0)))
    stream = jsyn.TokenStream(vocab=arch.vocab, batch=4, seq_len=64, seed=0)
    out["batches"] = [{k: np.asarray(v)
                       for k, v in stream.batch_at(k).items()}
                      for k in range(CLI_STEPS)]
    return out


def _events(d):
    return [json.loads(line) for line in open(f"{d}/events.jsonl")]


def _batches(np_batches):
    tb = [{k: torch.as_tensor(np.array(v)) for k, v in b.items()}
          for b in np_batches]
    return lambda k: tb[k]


def _ref_basis(m, n, q, device=None):
    """The reference's seeded cold-start basis of an (m, n) matrix."""
    return torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(m * 1315423911 + n), (n, q)))).to(device)


def _port_cli(ref_cli, argv, d):
    """The port's CLI for ``argv`` at ``tcut(CLI_VOCAB)`` from the
    reference run's initial parameters and batches → (state, losses)."""
    args = ttrain.parse_args(["--reduced", "--steps", str(CLI_STEPS),
                              "--telemetry-dir", str(d), "--device", "cpu",
                              *argv])
    return ttrain.run(args, arch=tcut(CLI_VOCAB),
                      params=_tparams(ref_cli["init"]),
                      batches=_batches(ref_cli["batches"]))


def _trajectory_equals(got_events, losses, want_events, params, want,
                       init, skip=()):
    """Step numbers and labels equal, each loss within REL, each
    parameter's change (but ``skip``'s) within TRAJ of the reference
    change's scale."""
    want_s = [e for e in want_events if e["type"] == "step"]
    got_s = [e for e in got_events if e["type"] == "step"]
    assert [(e["step"], e["phase"]) for e in got_s] == \
        [(e["step"], e["phase"]) for e in want_s]
    for g, w, loss in zip(got_s, want_s, losses, strict=True):
        assert g["loss"] == loss
        assert abs(g["loss"] - w["loss"]) <= REL * abs(w["loss"]), (g, w)
    init = convert.params_from_jax(init, device=CPU)
    want = convert.params_from_jax(want, device=CPU)
    assert set(params) == set(want)
    assert all(float((want[k] - init[k]).abs().max()) > 0 for k in want)
    for k in set(want) - set(skip):
        _close(params[k].detach() - init[k], want[k] - init[k], TRAJ, k)


def test_cli_trajectory_equals_reference(ref_cli, tmp_path):
    state, losses = _port_cli(ref_cli, [], tmp_path)
    events, want, _ = ref_cli["plain"]
    _trajectory_equals(_events(tmp_path), losses, events, state.params,
                       want, ref_cli["init"])


def test_cli_compress_trajectory_equals_reference(ref_cli, tmp_path,
                                                  monkeypatch):
    """``--compress`` with the reference's bases injected: the losses,
    the compressed gradients that enter the optimizer at each step (the
    first round at REL, the later ones at TRAJ: they follow the
    trajectory), and each parameter's change, against the reference
    CLI's.  The change of a compressed leaf that no K-FAC tap owns (the
    embedding, under the AdamW fallback) is held through its gradients
    only: AdamW divides each entry by its own size, so an entry that
    compression leaves at rounding level (an untouched token row) takes
    a step of either sign.  Compression moves the run from its second
    step on, in both packages."""
    grads, compress_tree = [], tcomp.compress_tree

    def recorded(gp, cs, cfg, sp=None):
        out, cs = compress_tree(gp, cs, cfg, sp=sp)
        grads.append({k: v.detach().clone() for k, v in out.items()
                      if v.dim() >= 2 and v.numel() >= cfg.min_size})
        return out, cs

    monkeypatch.setattr(tcomp, "seeded_basis", _ref_basis)
    monkeypatch.setattr(tcomp, "compress_tree", recorded)
    state, losses = _port_cli(ref_cli, ["--compress"], tmp_path)
    events, want, want_grads = ref_cli["compress"]
    assert len(grads) == len(want_grads) == CLI_STEPS
    for k, (g, w) in enumerate(zip(grads, want_grads)):
        assert set(g) == set(w) == {"embed", "head/w"}
        for name in w:
            _close(g[name], w[name], REL if k == 0 else TRAJ,
                   f"step {k} {name}")
    tapped = {t.param_path for t in TLM(tcut(CLI_VOCAB), device=CPU)
              .taps.values()}
    untapped = set(want_grads[0]) - tapped
    assert untapped == {"embed"}
    _trajectory_equals(_events(tmp_path), losses, events, state.params,
                       want, ref_cli["init"], skip=untapped)
    loss_of = lambda evs: [e["loss"] for e in evs if e["type"] == "step"]
    plain, comp = loss_of(ref_cli["plain"][0]), loss_of(events)
    assert plain[0] == comp[0] and plain[1] != comp[1]
    assert not np.allclose(plain[1:], comp[1:], rtol=REL, atol=0)


def test_cli_events_hold_the_references_types(ref_cli, tmp_path):
    """The same event types in the same order, each with the reference's
    fields; the same run configuration."""
    _port_cli(ref_cli, [], tmp_path)
    got, want = _events(tmp_path), ref_cli["plain"][0]
    assert [e["type"] for e in got] == [e["type"] for e in want]
    for g, w in zip(got, want):
        assert set(g) == set(w), g["type"]
        if g["type"] in ("run_start", "sched"):
            assert {k: v for k, v in g.items() if k != "t"} == \
                {k: v for k, v in w.items() if k != "t"}
    assert {e["type"] for e in got} >= {"run_start", "sched", "step",
                                        "metrics", "run_end"}


def _compress_arch():
    """Reduced gemma3 at the CLI tests' vocabulary of 1024."""
    return dataclasses.replace(tget("gemma3_4b").reduced(), vocab=CLI_VOCAB)


def _hand_compressed(arch, steps):
    """The ``--reduced --compress`` run threaded by hand: the CLI's model,
    optimizer, parameters, batches and schedule, with ``compress_tree``
    between the gradients and ``Kfac.update``."""
    args = ttrain.parse_args(["--reduced", "--device", "cpu"])
    lm = TLM(arch, remat=False, device=CPU)
    opt = api.Kfac(ttrain.kfac_config_of(args), lm.taps, device=CPU)
    params = lm.init(torch.Generator().manual_seed(0))
    ost = opt.init(params)
    rng = torch.Generator().manual_seed(1)
    ccfg = tcomp.CompressConfig(rank=8)
    cstate = tcomp.init_state(params, ccfg)
    stream = ttrain.TokenStream(vocab=arch.vocab, batch=4, seq_len=64,
                                seed=0, device=CPU)
    sched = opt.scheduler()
    losses = []
    for k in range(steps):
        probes = tlayers.make_probes(opt.taps, device=CPU)
        loss, acts, gp, gprobe = tloop.kfac_grads(
            lm.loss_fn, params, probes, stream.batch_at(k))
        gp, cstate = tcomp.compress_tree(gp, cstate, ccfg)
        updates, ost = opt.update(gp, ost, params, acts=acts,
                                  probe_grads=gprobe, n_tokens=4 * 64,
                                  rng=rng, work=sched.work(k))
        toptbase.apply_updates(params, updates)
        losses.append(float(loss))
    return params, losses, cstate


def test_cli_compress_equals_hand_threaded_loop():
    """The port's own threading of the carry through the CLI's step, bit
    for bit (the reference comparison is the test above)."""
    steps = 3
    arch = _compress_arch()
    want_params, want, cstate = _hand_compressed(arch, steps)
    assert {k for k, q in cstate.q.items() if q.numel()} == \
        {"embed", "head/w"}
    args = ttrain.parse_args(["--reduced", "--compress", "--steps",
                              str(steps), "--device", "cpu"])
    state, losses = ttrain.run(args, arch=arch)
    assert losses == want
    for k, v in want_params.items():
        assert torch.equal(state.params[k], v), k
    # compression changes the run from its second step on
    _, plain = ttrain.run(ttrain.parse_args(
        ["--reduced", "--steps", str(steps), "--device", "cpu"]), arch=arch)
    assert plain[0] == losses[0] and plain[1] != losses[1]


def test_cli_health_rollback_reanchors_the_schedule(tmp_path):
    """``--health`` on the reduced vision LM (its patch embeddings can
    carry NaN): four healthy steps, six NaN batches — two damping
    escalations, a forced refresh, a rollback to the newest snapshot
    (step 2) — then four healthy steps that resume the schedule from the
    snapshot's phase and de-escalate the damping."""
    arch = tget("internvl2_76b").reduced()
    rs = np.random.default_rng(0)
    n_tok = 64 - arch.n_prefix

    def batch(k):
        tok = torch.as_tensor(rs.integers(0, arch.vocab, (4, n_tok)))
        emb = torch.as_tensor(rs.standard_normal(
            (4, arch.n_prefix, arch.d_model)).astype(np.float32) * 0.1)
        if 4 <= k < 10:
            emb = torch.full_like(emb, float("nan"))
        return {"tokens": tok, "targets": tok, "embeds": emb}

    bank = [batch(k) for k in range(14)]
    ck = tmp_path / "ck"
    args = ttrain.parse_args(
        ["--arch", "internvl2_76b", "--reduced", "--health", "--steps",
         "14", "--ckpt-dir", str(ck), "--ckpt-every", "2",
         "--telemetry-dir", str(tmp_path), "--metrics-every", "0",
         "--device", "cpu"])
    state, losses = ttrain.run(args, batches=lambda k: bank[k])
    ev = _events(tmp_path)
    actions = [e["action"] for e in ev if e["type"] == "remediation"]
    assert actions == ["skip", "escalate", "skip", "escalate", "skip",
                       "refresh", "skip", "skip", "skip", "rollback",
                       "restored", "deescalate"]
    restores = [e["step"] for e in ev if e["type"] == "ckpt_restore"]
    assert restores == [2]
    steps = [(e["step"], e["phase"]) for e in ev if e["type"] == "step"]
    sched = api.Kfac(ttrain.kfac_config_of(args),
                     TLM(arch, device=CPU).taps, device=CPU).scheduler()
    # k = 10 … 13 run the schedule from the snapshot's phase: 3 steps
    # into a cycle of 2
    phase = 3 % sched.cycle
    anchored = list(range(phase, phase + 4))
    assert [s for s, _ in steps] == list(range(10)) + anchored
    assert [p for _, p in steps[10:]] == \
        [sched.work(s).label for s in anchored]
    assert all(np.isnan(losses[4:10])) and np.all(np.isfinite(losses[10:]))
    assert state.opt.step == 3 + 4
    saves = [e["step"] for e in ev if e["type"] == "ckpt_save"]
    assert saves == [0, 2, 10, 12]


def test_cli_resume_continues_the_trajectory(tmp_path):
    """A run cut after step 3 resumes from its step-2 snapshot: steps 3–5
    equal the uninterrupted run's bit for bit."""
    common = ["--reduced", "--device", "cpu", "--metrics-every", "0"]
    _, whole = ttrain.run(ttrain.parse_args(common + ["--steps", "6"]))
    ck = str(tmp_path / "ck")
    resumable = common + ["--ckpt-dir", ck, "--ckpt-every", "2",
                          "--telemetry-dir", str(tmp_path)]
    _, first = ttrain.run(ttrain.parse_args(resumable + ["--steps", "4"]))
    assert first == whole[:4] and tck.latest_step(ck) == 2
    state, tail = ttrain.run(ttrain.parse_args(resumable + ["--steps",
                                                            "6"]))
    assert tail == whole[3:]
    assert state.opt.step == 6
    ev = _events(tmp_path)
    assert [e["step"] for e in ev if e["type"] == "ckpt_restore"] == [2]


def test_launch_entry_points_refuse_cpu_fallback(monkeypatch):
    """On a host without a card the CLI and the builders raise unless the
    CPU is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arch = tget("gemma3_4b").reduced()
    for call in (lambda: ttrain.main(["--reduced", "--steps", "1"]),
                 lambda: tsteps.build_train_step(arch),
                 lambda: tsteps.build_prefill_step(arch),
                 lambda: tsteps.build_decode_step(arch)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert tsteps.build_prefill_step(arch, device=CPU).lm.device == CPU


def _numpy_draws(opt, seed):
    """Heavy-op draws by schedule step from numpy: every bucket whose heavy
    range fires (the RSVD test matrices)."""
    from repro_torch.core import kfactor
    sched = opt.scheduler()

    def draws(step):
        work, out = sched.work(step), {}
        for bi, b in enumerate(opt.factor_buckets):
            if work.heavy[bi] and kfactor.needs_draws(b.spec):
                k = min(b.spec.r + b.spec.r_o, b.spec.d)
                out[bi] = torch.from_numpy(np.random.default_rng(
                    [seed, step, bi]).standard_normal(
                        (b.total, b.spec.d, k)).astype(np.float32))
        return out
    return draws


def test_cli_and_builder_take_injected_draws():
    """The heavy ops' random inputs handed to ``run(draws=)`` and to a
    builder step's ``rng`` are the ones consumed: the same draws give the
    same run, the generator's give another."""
    arch = tget("gemma3_4b").reduced()
    argv = ["--reduced", "--variant", "brkfac", "--steps", "1",
            "--device", "cpu"]
    args = ttrain.parse_args(argv)
    opt = api.Kfac(ttrain.kfac_config_of(args), TLM(arch, device=CPU).taps,
                   device=CPU)
    runs = [ttrain.run(args, draws=d)[0].params for d in (
        _numpy_draws(opt, 0), _numpy_draws(opt, 0), None)]
    assert all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
    assert not all(torch.equal(runs[0][k], runs[2][k]) for k in runs[0])
    # default_kfac_config's r = 256 makes every reduced factor EVD but the
    # head's G side at a vocabulary of 1024, which R-KFAC's RSVD draws for
    tb = tsteps.build_train_step(_compress_arch(), variant="rkfac",
                                 flags=HEAVY, device=CPU,
                                 cell=ShapeCell("t", T, B, "train"))
    w = tb.lm.init(torch.Generator().manual_seed(0))
    tok = torch.as_tensor(np.random.default_rng(1).integers(0, 1024,
                                                            (B, T)))
    outs = []
    for rng in (_numpy_draws(tb.opt, 0)(0), _numpy_draws(tb.opt, 0)(0),
                torch.Generator().manual_seed(1)):
        p = {k: v.detach().clone().requires_grad_() for k, v in w.items()}
        outs.append(tb.step_fn(p, tb.opt.init(p),
                               {"tokens": tok, "targets": tok}, rng)[0])
    assert all(torch.equal(outs[0][k], outs[1][k]) for k in w)
    assert not all(torch.equal(outs[0][k], outs[2][k]) for k in w)


def test_spectrum_continuation_jumps_at_rounding_level_modes():
    """The reference's continuation (``core/precond.py:40``) takes the min
    over modes with D > 0, so a rounding-level eigenvalue of a
    rank-deficient factor moves λ by the smallest real mode when it is
    positive on one device and zero on another; the port mirrors it.
    Pinned here because it makes card and CPU runs of the reduced CLI
    differ in their parameter changes (``chip_smoke.py``'s agree_launch
    holds the losses)."""
    from repro.core import precond as jprec
    from repro_torch.core import precond as tprec
    lam = 0.1
    for tiny, want in ((1e-18, lam + 1e-18), (0.0, lam + 0.5)):
        D = np.array([[1.0, 0.5, tiny, 0.0]], np.float32)
        _, jl = jprec.spectrum_continuation(jnp.asarray(D),
                                            jnp.asarray([lam]))
        _, tl = tprec.spectrum_continuation(torch.as_tensor(D),
                                            torch.tensor([lam]))
        assert float(tl[0]) == pytest.approx(want, rel=1e-6)
        assert float(jl[0]) == pytest.approx(want, rel=1e-6)
