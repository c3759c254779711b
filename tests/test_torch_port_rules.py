"""Rules of the port: ``src/repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the reference package, importing the port leaves JAX
unloaded, and its entry points refuse to fall back to the CPU on a host
without a card."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_files_exist():
    assert len(PORT_FILES) > 15
    assert (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir()


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax", "optax")]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_leaves_jax_unloaded():
    code = (
        "import sys, importlib, pkgutil\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "print(len(bad), bad[:5])\n"
        "sys.exit(1 if bad else 0)\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_a_card(no_card):
    from repro_torch import device as device_lib
    from repro_torch.core import kfac as tkfac
    from repro_torch.data.synthetic import ImageStream
    from repro_torch.models.cnn import VggConfig, make_vgg
    from repro_torch.train import loop
    cpu = torch.device("cpu")
    model, taps = make_vgg(VggConfig(stages=(4,), fc_hidden=8, n_stat=4),
                           device=cpu)
    opt = tkfac.Kfac(tkfac.KfacConfig(), taps, device=cpu)
    batch = ImageStream(batch=2, device=cpu).batch_at(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.run_kfac_training(model.loss, opt, model.params(), [batch],
                               n_tokens=2)
    for call in (lambda: device_lib.resolve(None),
                 lambda: make_vgg(VggConfig()),
                 lambda: tkfac.Kfac(tkfac.KfacConfig(), taps),
                 lambda: ImageStream(batch=2).batch_at(0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # the explicit CPU request runs
    _, losses = loop.run_kfac_training(model.loss, opt, model.params(),
                                       [batch], n_tokens=2, device=cpu)
    assert len(losses) == 1
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_example_refuses_cpu_fallback(no_card):
    from repro_torch.examples import train_vgg_kfac
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_vgg_kfac.main(["--preset", "small", "--steps", "1"])


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env={"PATH": "/usr/bin:/bin",
                              "CUDA_VISIBLE_DEVICES": ""},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the
    repo, the script fails and prints no ok line."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(tmp_path / "chip_smoke.py")],
                         env={"PATH": "/usr/bin:/bin"}, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
