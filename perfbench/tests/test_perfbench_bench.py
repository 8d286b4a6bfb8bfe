"""BENCHMARK.json against the contract the harness is written to, and the
harness's own data-driven layout: every metric has its reader, every cell
its configuration and mix, and each per-layer metric's cells report the
end-to-end metric it moves."""

import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[0:0] = [str(ROOT), str(ROOT / "src")]

import pytest  # noqa: E402
import torch  # noqa: E402

from perfbench import harness, testing  # noqa: E402
from perfbench.testing import one_thread  # noqa: E402,F401

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_readers():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert (harness.HERE / "e2e" / f"{m['name']}.py").exists()
    layers = set()
    for m in BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["moves"] in e2e
        assert (harness.HERE / "layers" / f"{m['name']}.py").exists()
        layers.add(m["layer"])
        for cell in m["workloads"]:
            mv = e2e[m["moves"]]
            assert "workloads" not in mv or cell in mv["workloads"], \
                (m["name"], cell)
    assert len(layers) >= 5


def test_every_cell_loads_and_reports_enough():
    configs = {c["name"] for c in BENCH["configs"]}
    used = set()
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cell = harness.load_cell(w["name"])
        used.add(w["config"])
        names = [m["name"] for m in cell.e2e]
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        assert "limits" in cell.config and "model" in cell.config
        assert harness.arch_config(cell).n_layers == \
            cell.model["n_layers"]
    assert used == configs


def test_reduced_keys_differ_from_the_published_config():
    widths = re.compile(r"hidden_size|intermediate|latent|state|proj|"
                        r"_dim$|_rank$|head_dim|expan|experts_per_tok")
    for c in BENCH["configs"]:
        f = json.loads((ROOT / c["file"]).read_text())
        assert set(c["reduced"]) == set(f["published"])
        for key in c["reduced"]:
            assert not widths.search(key), key
            assert f[key] != f["published"][key], key


def test_check_budget_fits_every_later_cell():
    runs = 2 + 14 * 24
    need = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert need <= 43200


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_tiny_traced_run_reports_the_scheduler_metrics(name, one_thread):
    """A traced run of each cell at a tiny size on the CPU: the readers of
    program counters find their numbers (the device's need the card)."""
    out = harness.run(testing.tiny_cell(name), 2 ** 31 + 3, 0.6, True,
                      torch.device("cpu"), 0.0)
    got = out["metrics"]
    assert got["decode_rows"]["value"] >= 1
    assert 0 < got["kv_pool_used"]["value"] <= 100
    assert "syncs_per_step" not in got      # the sync census needs a card
