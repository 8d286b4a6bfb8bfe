"""repro_torch.analysis — the port's host-sync and kernel discipline
tooling (port of ``repro/analysis/``).

``torchlint`` — an AST-based static analyzer (stdlib ``ast`` only, no
new dependencies) with checks tuned to THIS port's invariants: hot
scheduling loops must not silently sync the card (a device-to-host read,
an explicit wait, or a blocking host-to-device copy), the model code a
dispatch runs eagerly must not read a tensor's value on the host, model
dispatches must not be fed Python-varying shapes outside the blessed
bucketing helpers, calls into the built kernel library must tie their
geometry to named constants, and every kernel wrapper needs a plain
version, a test and a place in ``chip_smoke.py``. Findings are
suppressed inline with ``# torchlint: disable=<check> -- reason`` or
accepted into the committed ``.torchlint-baseline`` so the gate is
incremental (only NEW findings fail it).

  Run it locally::

      PYTHONPATH=src python -m repro_torch.analysis src/repro_torch

The other half of the reference's ``analysis/`` docstring, the KV-block
sanitizer, was ported with the serving modules:
``serving/kv_blocks.py`` (``BlockManager(sanitize=True)`` or
``REPRO_KV_SANITIZE=1``: the shadow ledger, poisoned freed blocks and
``KVSanitizerError``, with the device probe of the paged kernels) and
``serving/tensor_store.py``.
"""

from repro_torch.analysis.baseline import load_baseline, write_baseline
from repro_torch.analysis.torchlint import (
    CHECKS,
    Finding,
    LintConfig,
    analyze_file,
    analyze_paths,
)

__all__ = [
    "CHECKS",
    "Finding",
    "LintConfig",
    "analyze_file",
    "analyze_paths",
    "load_baseline",
    "write_baseline",
]
