"""Guards of the port's boundaries: ``repro_torch`` and ``chip_smoke.py``
import neither ``jax`` nor anything of ``repro``, nor ``msgpack`` (the GPU
host has none: the checkpoint blob is written with ``struct``), and the
entry points run on the CPU only when asked to."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import _torch_threads  # noqa: F401
import repro_torch
from repro_torch.configs import get_config
from repro_torch.core import dsgd
from repro_torch.launch import train
from repro_torch.launch.train import build_cpu_preset
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.weights import from_reference_params

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(path):
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "flax", "optax", "msgpack")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_source_imports_no_jax_and_no_reference(path):
    bad = [n for n in _imported(path) if _forbidden(n)]
    assert not bad, f"{path} imports {bad}"


def test_import_with_jax_and_reference_blocked():
    """Every module of the port, and chip_smoke.py, imports in a process in
    which ``import jax``, ``import repro`` and ``import msgpack`` fail."""
    mods = ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages([str(PKG)], "repro_torch.")]
    code = "\n".join([
        "import importlib, sys",
        "for name in ('jax', 'jaxlib', 'repro', 'msgpack'):",
        "    sys.modules[name] = None",
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]",
        f"for m in {mods!r} + ['chip_smoke']:",
        "    importlib.import_module(m)",
        "print('ok')"])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    assert len(mods) > 20
    for new in ("repro_torch.checkpoint.io", "repro_torch.serving.engine",
                "repro_torch.launch.serve", "repro_torch.telemetry.events",
                "repro_torch.telemetry.latency", "repro_torch.telemetry.trace",
                "repro_torch.telemetry.export",
                "repro_torch.telemetry.validate", "repro_torch.models.moe",
                "repro_torch.configs.deepseek_v3_671b"):
        assert new in mods


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_launcher_without_device_raises(no_gpu, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--rounds", "1", "--agents", "2", "--out",
                    str(tmp_path)])
    assert not list(tmp_path.iterdir())


def test_init_panel_state_without_device_raises(no_gpu):
    cfg = build_cpu_preset(get_config("olmo-1b"), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dsgd.init_panel_state(build_model(cfg).init_params,
                              make_optimizer("adamw", 1e-3), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        dsgd.init_panel_state(build_model(cfg).init_params,
                              make_optimizer("adamw", 1e-3), 2,
                              device="cuda")


def test_weights_handover_without_device_raises(no_gpu):
    import numpy as np
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_reference_params({"w": np.zeros((2, 3), np.float32)})


def test_resolve_device_explicit_cpu(no_gpu):
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line when there
    is no card, and when run alone, outside the repository."""
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run(
            [sys.executable, str(script)], cwd=cwd, capture_output=True,
            text=True, timeout=120,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": ""})
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_figures_cli_without_device_raises(no_gpu, capsys):
    """``python -m repro_torch.bench.figures`` raises with no card and
    prints no result line."""
    from repro_torch.bench import figures
    with pytest.raises(RuntimeError, match="no CUDA device"):
        figures.main(["appendix_c34"])
    assert "us_per_call" not in capsys.readouterr().out


def test_figures_cli_on_cpu_when_asked(no_gpu, capsys):
    from repro_torch.bench import figures
    assert figures.main(["appendix_c34", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert len(lines) == 2
    assert lines[1].startswith("appendix_c34_gossip_merge,")
    assert "ERROR" not in lines[1]
