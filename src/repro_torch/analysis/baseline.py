"""Baseline file handling for torchlint's incremental CI gate.

A baseline is a committed list of accepted finding fingerprints — the
gate fails only on findings whose fingerprint is absent. Format (one
entry per line)::

    <fingerprint>  <check> <path>:<line> <qualname>  # reason

Everything after the first whitespace run is commentary for humans:
``load_baseline`` keys on the leading fingerprint token alone, so the
descriptive tail (and the recorded line number) may drift without
invalidating the entry. Blank lines and ``#``-prefixed lines are
ignored. Fingerprints are line-number-free (see ``torchlint``), so
baselines survive edits elsewhere in the file; editing the flagged line
itself changes the fingerprint and forces re-triage — intended.
"""

from __future__ import annotations

from typing import Iterable, Set

from repro_torch.analysis.torchlint import Finding

_HEADER = """\
# torchlint baseline — accepted findings (see src/repro_torch/analysis/).
# One fingerprint per line; trailing text is human commentary only.
# Regenerate with:  PYTHONPATH=src python -m repro_torch.analysis \\
#     src/repro_torch --write-baseline .torchlint-baseline
# then re-add reason comments for entries you keep.
"""


def load_baseline(path: str) -> Set[str]:
    """Accepted fingerprints from ``path``; empty set if absent."""
    fps: Set[str] = set()
    try:
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                fps.add(line.split()[0])
    except FileNotFoundError:
        pass
    return fps


def write_baseline(path: str, findings: Iterable[Finding]) -> int:
    """Write all ``findings`` as a fresh baseline; returns the count."""
    rows = sorted(findings, key=lambda f: (f.path, f.line, f.check))
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(_HEADER)
        for f in rows:
            fh.write(f"{f.fingerprint}  {f.check} {f.path}:{f.line} "
                     f"{f.qualname}\n")
    return len(rows)
