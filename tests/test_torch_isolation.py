"""The PyTorch port stands alone: no ``jax`` and nothing of ``repro`` in its
sources or in a process that imports it, and its entry points refuse to run
on the card when there is none (no silent CPU fallback)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax_or_repro(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_importing_the_engine_loads_no_jax():
    code = ("import sys; import repro_torch.serving.engine, "
            "repro_torch.models.convert, repro_torch.core, repro_torch.hw, "
            "repro_torch.cluster.recovery, repro_torch.serving.server, "
            "repro_torch.train, repro_torch.launch.train, "
            "repro_torch.launch.serve, repro_torch.kernels.ssd_scan, "
            "repro_torch.launch.pipeline, repro_torch.configs.shapes, "
            "repro_torch.cluster, repro_torch.cluster.simulator, "
            "repro_torch.cluster.frontier, repro_torch.sharding, "
            "repro_torch.sharding.rules, repro_torch.launch.mesh, "
            "repro_torch.launch.steps; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_without_device_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from repro_torch.configs import get_config
    from repro_torch.models import LM, build_model
    from repro_torch.serving import Engine
    cfg = get_config("qwen3-32b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(cfg)
    params = build_model(cfg, device="cpu").init(seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, params)


def _smoke(*args):
    return subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           *args], capture_output=True, text=True,
                          timeout=600, cwd=ROOT)


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _smoke()
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_cpu_rehearsal_runs_and_prints_no_ok_line():
    """The card-free phases of chip_smoke.py (kernel-case construction and
    bound accounting with the plain versions, engine parity, the serving
    loop) run on the CPU at a tiny size."""
    r = _smoke("--cpu-rehearsal")
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "[rehearsal] done" in r.stdout
    assert '"ok": true' not in r.stdout
