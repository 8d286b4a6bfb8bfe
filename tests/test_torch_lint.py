"""torchlint (``repro_torch.analysis``), the port's counterpart of jaxlint:
every check has a snippet it must flag and one it must pass; parity with
jaxlint on the same sources (equal fingerprints where both flag, the same
suppression split); the baseline round trip and its line-drift
stability; the CLI's exit codes; and the repo gate (the committed
``.torchlint-baseline`` keeps ``python -m repro_torch.analysis
src/repro_torch --fail-on-stale`` at exit 0)."""

import pathlib
import textwrap

import pytest

from repro.analysis import LintConfig as JaxLintConfig
from repro.analysis import analyze_file as jax_analyze_file
from repro_torch.analysis import (
    CHECKS,
    LintConfig,
    analyze_file,
    analyze_paths,
    load_baseline,
    write_baseline,
)
from repro_torch.analysis.__main__ import main as torchlint_main

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def _lint(tmp_path, src, config=None, rel="mod.py", tests_blob="",
          smoke_blob="", suppressed=False):
    p = tmp_path / "mod.py"
    p.write_text(textwrap.dedent(src))
    return analyze_file(str(p), config or LintConfig(), rel=rel,
                        tests_blob=tests_blob, smoke_blob=smoke_blob,
                        suppressed=suppressed)


def _checks(findings):
    return {f.check for f in findings}


def _lines(findings):
    return sorted(f.line for f in findings)


_HOT = LintConfig(hot_functions=(r"^hot$",))
_MODEL = "repro_torch/models/mod.py"
_KERNEL = "repro_torch/kernels/mod.py"


# -- host-sync -----------------------------------------------------------------

def test_host_sync_flags_reads_waits_and_blocking_copies(tmp_path):
    fs = _lint(tmp_path, """
        import numpy as np
        import torch

        def hot(self, x, vals, d, ev, n):
            a = np.asarray(x)
            b = x.item()
            c = x.tolist()
            e = x.cpu()
            f = x.numpy()
            g = int(vals[0])
            h = float(n)
            torch.cuda.synchronize()
            ev.synchronize()
            i = torch.tensor(vals, device=d)
            j = torch.as_tensor(vals, device=d)
            k = x.to(self.device)
            m = x.to("cuda")
            o = x.cuda()
            p = self._dev(vals)
            x[:, vals] = 0
            x[vals] = -POISON
            return a, b, c, e, f, g, h, i, j, k, m, o, p
        """, config=_HOT)
    assert _checks(fs) == {"host-sync"}
    assert _lines(fs) == list(range(6, 23))


def test_host_sync_passes_host_data_async_copies_and_cold_paths(tmp_path):
    fs = _lint(tmp_path, """
        import numpy as np
        import torch

        def hot(ms, x, d, n: int):
            slots = np.array([m.slot for m in ms], np.int32)
            k = int(len(ms)) + int(n)
            y = x.to(torch.float32)
            z = x.to(d, non_blocking=True)
            w = x.cuda(non_blocking=True)
            t = torch.tensor([1, 2])
            u = torch.zeros(3, device=d)
            u[0] = 1
            u[:, :n] = 0
            u[:, d] = y
            return slots, k, y, z, w, t, u

        def cold(x, d):
            return x.item(), torch.tensor(x, device=d)
        """, config=_HOT)
    assert fs == []


# -- model-sync ----------------------------------------------------------------

_MODEL_BAD = """
    import torch

    def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
        f = torch.tensor(theta, device=x.device)
        if x.sum() > 0:
            x = x * f
        while x.abs().max() > 1:
            x = x / 2
        n = int(x)
        m = float(x[0])
        return x * n * m
    """


def test_model_sync_flags_value_reads_and_sync_patterns(tmp_path):
    fs = _lint(tmp_path, _MODEL_BAD, rel=_MODEL)
    assert _checks(fs) == {"model-sync"}
    assert _lines(fs) == [5, 6, 8, 10, 11]


def test_model_sync_passes_metadata_and_outside_model_code(tmp_path):
    fs = _lint(tmp_path, """
        from typing import Optional

        import torch

        def step(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                 y=None) -> torch.Tensor:
            if mask is None:
                mask = torch.ones_like(x)
            if x.ndim == 3 and x.shape[0] > 1 and len(x) > 1:
                x = x[0]
            if x.is_cuda and isinstance(x, torch.Tensor):
                x = x + 1
            if y:
                x = x * 2
            return x * int(x.shape[-1]) * mask

        def kernel_plain(x: torch.Tensor) -> torch.Tensor:
            if x.sum() > 0:
                return x.cpu()
            return x
        """, rel=_MODEL)
    assert fs == []
    # the same findings outside models/, kernels/ and sharding/: none
    assert _lint(tmp_path, _MODEL_BAD, rel="repro_torch/serving/mod.py") \
        == []


def test_model_sync_skips_the_cold_list(tmp_path):
    assert _lint(tmp_path, _MODEL_BAD,
                 rel="repro_torch/models/convert.py") == []
    cold = _MODEL_BAD.replace("def rope(", "def init_params(")
    assert _lint(tmp_path, cold, rel=_MODEL) == []


# -- retrace -------------------------------------------------------------------

_DISPATCH = """
    class Engine:
        def caller(self, payload, n):
            return self.model.prefill_chunk(self.params, payload[:, :8],
                                            last_pos=payload[:, :8])
    """


def test_retrace_flags_varying_slice_into_a_dispatch(tmp_path):
    varying = _DISPATCH.replace(":8]", ":n]")
    fs = _lint(tmp_path, varying)
    assert _checks(fs) == {"retrace"} and len(fs) == 2
    assert "prefill_chunk" in fs[0].message


def test_retrace_passes_constant_slices_blessed_and_other_callees(
        tmp_path):
    assert _lint(tmp_path, _DISPATCH) == []
    varying = _DISPATCH.replace(":8]", ":n]")
    blessed = LintConfig(blessed_retrace=(r"caller$",))
    assert _lint(tmp_path, varying, config=blessed) == []
    other = varying.replace("self.model.prefill_chunk", "self._scatter")
    assert _lint(tmp_path, other) == []


# -- kernel-grid ---------------------------------------------------------------

def test_kernel_grid_flags_magic_numbers(tmp_path):
    fs = _lint(tmp_path, """
        from repro_torch.kernels import _build

        def run(q):
            lib = _build.load()
            return lib.rt_thing(q.data_ptr(), 8, 128, -2, 0, 1)
        """)
    assert _checks(fs) == {"kernel-grid"} and len(fs) == 3
    assert {f.message.split()[2] for f in fs} == {"8", "128", "-2"}


def test_kernel_grid_passes_named_constants_and_planner_results(tmp_path):
    fs = _lint(tmp_path, """
        from repro_torch.kernels import _build

        SPLIT = 8

        def run(q, plan):
            lib = _build.load()
            return lib.rt_thing(q.data_ptr(), SPLIT, plan[0], 0, 1, 1.0)
        """)
    assert fs == []


# -- kernel-test ---------------------------------------------------------------

_WRAPPER = """
    from repro_torch.kernels import _build

    def run(q):
        return _build.load().rt_run(q.data_ptr())
    {plain}
    def _helper(q):
        return _build.load().rt_helper(q.data_ptr())
    """


def test_kernel_test_flags_missing_plain_test_and_smoke(tmp_path):
    fs = _lint(tmp_path, _WRAPPER.format(plain=""), rel=_KERNEL,
               tests_blob="something_else()", smoke_blob="other()")
    msgs = " ".join(f.message for f in fs)
    assert _checks(fs) == {"kernel-test"} and len(fs) == 3
    assert "run_plain" in msgs and "tests directory" in msgs
    assert "chip_smoke.py" in msgs


def test_kernel_test_passes_covered_wrapper(tmp_path):
    src = _WRAPPER.format(plain="\n    def run_plain(q):\n        return q\n")
    assert _lint(tmp_path, src, rel=_KERNEL, tests_blob="run(q) == ref",
                 smoke_blob="kernel run(q)") == []
    # the same module outside kernels/: not a wrapper module
    assert _lint(tmp_path, _WRAPPER.format(plain=""),
                 rel="repro_torch/models/mod.py") == []


# -- parity with jaxlint -------------------------------------------------------

_ENGINE_STEP = """
    import numpy as np
    import torch

    class Engine:
        def step(self, logits, x, d):
            a = logits.item()
            b = np.asarray(x)
            c = logits.tolist()
            e = torch.tensor(x, device=d)
            return a, b, c, e
    """


def test_hot_engine_step_fingerprints_equal_jaxlint(tmp_path):
    p = tmp_path / "engine.py"
    p.write_text(textwrap.dedent(_ENGINE_STEP))
    jax = jax_analyze_file(str(p), JaxLintConfig(), rel="engine.py",
                           tests_blob="")
    ours = analyze_file(str(p), LintConfig(), rel="engine.py",
                        tests_blob="", smoke_blob="")
    assert {(f.check, f.line) for f in jax} == {("host-sync", 7),
                                               ("host-sync", 8)}
    assert {(f.line, f.fingerprint) for f in jax} <= {
        (f.line, f.fingerprint) for f in ours}
    assert {f.line for f in ours} == {7, 8, 9, 10}
    assert _checks(ours) == {"host-sync"}


_SUPPRESSION = """
    import numpy as np

    def hot(x, y, z, w, v):
        a = np.asarray(x)  # {tool}: disable=host-sync -- intended
        # {tool}: disable=host-sync -- comment-line form
        # a second comment line
        b = np.asarray(y)
        c = np.asarray(z)  # {tool}: disable=retrace -- wrong check
        d = w.item()  # {tool}: disable=all -- every check
        # {tool}: disable=host-sync
        e = int(v[0])
        f = np.asarray(v)
        return a, b, c, d, e, f
    """


@pytest.mark.parametrize("suppressed", [False, True])
def test_suppression_split_equals_jaxlint(tmp_path, suppressed):
    jp = tmp_path / "jax_mod.py"
    jp.write_text(textwrap.dedent(_SUPPRESSION.format(tool="jaxlint")))
    jax = jax_analyze_file(str(jp), JaxLintConfig(
        hot_functions=(r"^hot$",)), tests_blob="")
    fs = _lint(tmp_path, _SUPPRESSION.format(tool="torchlint"),
               config=_HOT, suppressed=suppressed)
    kept = [f for f in fs if f.suppressed is None]
    assert _lines(kept) == _lines(jax) == [9, 13]
    if suppressed:
        dropped = {f.line: f.suppressed for f in fs if f.suppressed is not None}
        assert dropped == {5: "intended", 8: "comment-line form",
                           10: "every check", 12: ""}


def test_suppressed_findings_keep_their_own_occurrence(tmp_path):
    src = """
        def hot(x):
            a = x.item()
            a = x.item()  # torchlint: disable=host-sync -- kept apart
            a = x.item()
            return a
        """
    kept = _lint(tmp_path, src, config=_HOT)
    every = _lint(tmp_path, src, config=_HOT, suppressed=True)
    plain = _lint(tmp_path, src.replace("  # torchlint", "  # x"),
                  config=_HOT)
    # the two reported ones fingerprint as occurrences 0 and 1, whether
    # or not the suppressed one is asked for
    assert [f.fingerprint for f in kept] == [
        f.fingerprint for f in every if f.suppressed is None]
    assert [f.fingerprint for f in kept] == [f.fingerprint for f in plain
                                             if f.line != 4]


# -- baseline ------------------------------------------------------------------

def test_baseline_roundtrip_and_line_drift_stability(tmp_path):
    src = """
        import numpy as np

        def hot(x):
            return np.asarray(x)
        """
    fs = _lint(tmp_path, src, config=_HOT)
    assert len(fs) == 1
    bl = tmp_path / "baseline"
    assert write_baseline(str(bl), fs) == 1
    assert load_baseline(str(bl)) == {fs[0].fingerprint}
    assert ".torchlint-baseline" in bl.read_text()
    assert load_baseline(str(tmp_path / "absent")) == set()
    # unrelated edits above the finding must not rotate the fingerprint
    drifted = textwrap.dedent(src).replace(
        "import numpy as np", "import os\n\nimport numpy as np")
    (tmp_path / "mod.py").write_text(drifted)
    fs2 = analyze_file(str(tmp_path / "mod.py"), _HOT, rel="mod.py",
                       tests_blob="", smoke_blob="")
    assert fs2[0].line != fs[0].line
    assert fs2[0].fingerprint == fs[0].fingerprint
    # editing the flagged line itself forces re-triage
    edited = drifted.replace("np.asarray(x)", "np.asarray(x) + 0")
    (tmp_path / "mod.py").write_text(edited)
    fs3 = analyze_file(str(tmp_path / "mod.py"), _HOT, rel="mod.py",
                       tests_blob="", smoke_blob="")
    assert fs3[0].fingerprint != fs[0].fingerprint


def test_every_check_has_catalogue_entry():
    assert set(CHECKS) == {"host-sync", "model-sync", "retrace",
                           "kernel-grid", "kernel-test"}


# -- CLI -----------------------------------------------------------------------

def test_cli_exit_codes(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(ROOT)
    assert torchlint_main(["--fail-on-stale"]) == 0
    assert "torchlint clean" in capsys.readouterr().out
    assert torchlint_main(["--list-checks"]) == 0
    out = capsys.readouterr().out
    for name in CHECKS:
        assert f"{name}:" in out
    assert torchlint_main(["--select", "host-sync,nope"]) == 2
    mod = tmp_path / "repro_torch" / "models" / "mod.py"
    mod.parent.mkdir(parents=True)
    mod.write_text(textwrap.dedent(_MODEL_BAD))
    root = str(tmp_path / "repro_torch")
    bl = tmp_path / "bl"
    assert torchlint_main([root, "--baseline", str(bl)]) == 1
    assert "5 new finding(s)" in capsys.readouterr().out
    assert torchlint_main([root, "--write-baseline", str(bl)]) == 0
    assert torchlint_main([root, "--baseline", str(bl)]) == 0
    assert torchlint_main([root, "--baseline", str(bl),
                           "--select", "retrace"]) == 0
    # the baselined findings are stale once the code is fixed
    mod.write_text("def rope(x):\n    return x\n")
    assert torchlint_main([root, "--baseline", str(bl)]) == 0
    assert torchlint_main([root, "--baseline", str(bl),
                           "--fail-on-stale"]) == 1
    assert torchlint_main([root, "--no-baseline", "--fail-on-stale"]) == 0


# -- repo gate -----------------------------------------------------------------

def _repo_findings(suppressed=False):
    cfg = LintConfig(tests_dir=str(ROOT / "tests"),
                     smoke_file=str(ROOT / "chip_smoke.py"))
    return analyze_paths([str(PORT)], cfg, suppressed=suppressed)


def test_repo_is_clean_against_committed_baseline():
    """The committed baseline covers every finding on src/repro_torch and
    carries no stale entry: ``chip_smoke.py`` phase ``lint`` runs exactly
    this gate."""
    findings = _repo_findings()
    accepted = load_baseline(str(ROOT / ".torchlint-baseline"))
    fresh = [f for f in findings if f.fingerprint not in accepted]
    assert fresh == [], "\n".join(f.render() for f in fresh)
    assert accepted <= {f.fingerprint for f in findings}


def _line_of(path: pathlib.Path, text: str, within: str) -> list:
    """Line numbers of ``text`` inside ``def within`` of ``path``."""
    lines = path.read_text().splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if ln.lstrip().startswith(f"def {within}("))
    end = next((i for i in range(start + 1, len(lines))
                if lines[i].lstrip().startswith("def ")), len(lines))
    return [i + 1 for i in range(start, end) if text in lines[i]]


def test_repo_findings_cover_the_known_syncs():
    """The linter reports (suppressed or not) the per-step token read and
    the step's uploads in ``Engine.step``, and RoPE's per-call upload of
    theta in ``models/common.py``; each suppression carries a reason."""
    found = _repo_findings(suppressed=True)
    engine = PORT / "serving" / "engine.py"
    common = PORT / "models" / "common.py"
    (read,) = _line_of(engine, ".tolist()", "step")
    (upload,) = _line_of(engine, "self._dev(tokens)", "step")
    (rope,) = _line_of(common, "torch.tensor(theta", "rope_frequencies")
    at = {}
    for f in found:
        at.setdefault((f.path, f.line, f.check), []).append(f)
    (step_read,) = at[("repro_torch/serving/engine.py", read, "host-sync")]
    assert step_read.suppressed and "per-step" in step_read.suppressed
    uploads = at[("repro_torch/serving/engine.py", upload, "host-sync")]
    assert len(uploads) == 2 and all("_dev" in f.message for f in uploads)
    assert {f.qualname for f in uploads} == {"Engine.step"}
    assert ("repro_torch/models/common.py", rope, "model-sync") in at
    assert all(f.suppressed.strip() for f in found
               if f.suppressed is not None)
