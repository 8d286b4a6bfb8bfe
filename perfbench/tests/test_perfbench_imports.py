"""No module a run loads is JAX's or the JAX package's (whole top-level
names: ``repro_torch`` is not ``repro``), and the reference imports nothing
of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BANNED = {"jax", "jaxlib", "flax", "repro"}

SCRIPT = f"""
import sys, json, runpy
sys.argv = ["run.py", "--help"]
try:
    runpy.run_path({str(ROOT / "perfbench" / "run.py")!r},
                   run_name="__main__")
except SystemExit:
    pass
import torch
from perfbench import harness, testing
for name in ("qwen3-32b-pp2.offline", "cmdr-plus-104b-pp4.rag"):
    for traced in (False, True):
        harness.run(testing.tiny_cell(name), 5, 0.3, traced,
                    torch.device("cpu"), 0.0)
for kind in ("e2e", "layers"):
    for p in (harness.HERE / kind).glob("*.py"):
        harness.reader(kind, p.stem)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_jax_and_no_reference_package():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in names and "perfbench" in names
    assert not names & BANNED, names & BANNED


def test_reference_imports_nothing_of_the_program():
    for p in (ROOT / "perfbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                assert m.split(".")[0] not in BANNED | {"repro_torch",
                                                        "perfbench"}, (p, m)
    code = ("import sys; sys.path.insert(0, %r); "
            "import perfbench.reference.model; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "repro_torch" not in out.stdout and "'repro'" not in out.stdout
