"""CLI: ``python -m repro_torch.analysis [paths...]``.

Exit 0 when every finding is baselined or suppressed; exit 1 when new
findings exist (printed) or ``--fail-on-stale`` is set and the baseline
carries entries that no longer fire; exit 2 on an unknown check.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List

from repro_torch.analysis.baseline import load_baseline, write_baseline
from repro_torch.analysis.torchlint import CHECKS, LintConfig, analyze_paths


def main(argv: List[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repo-tuned PyTorch host-sync and kernel discipline "
                    "analyzer")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to scan (default: "
                         "src/repro_torch)")
    ap.add_argument("--baseline", default=".torchlint-baseline",
                    help="accepted-findings file (default: "
                         ".torchlint-baseline)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignoring the baseline")
    ap.add_argument("--write-baseline", metavar="PATH",
                    help="accept all current findings into PATH and exit")
    ap.add_argument("--tests-dir", default="tests",
                    help="tests directory for the kernel-test "
                         "cross-reference (default: tests); its parent's "
                         "chip_smoke.py, where there is one, is the smoke "
                         "script the kernel wrappers must appear in")
    ap.add_argument("--select", metavar="CHECKS",
                    help="comma-separated subset of checks to run")
    ap.add_argument("--list-checks", action="store_true",
                    help="print the check catalogue and exit")
    ap.add_argument("--fail-on-stale", action="store_true",
                    help="also fail when baseline entries no longer fire")
    args = ap.parse_args(argv)

    if args.list_checks:
        for name, doc in CHECKS.items():
            print(f"{name}: {doc}")
        return 0

    enabled = tuple(CHECKS)
    if args.select:
        enabled = tuple(c.strip() for c in args.select.split(","))
        unknown = [c for c in enabled if c not in CHECKS]
        if unknown:
            print(f"unknown check(s): {', '.join(unknown)}",
                  file=sys.stderr)
            return 2

    tests_dir = args.tests_dir if os.path.isdir(args.tests_dir) else None
    smoke = (os.path.join(os.path.dirname(os.path.abspath(tests_dir)),
                          "chip_smoke.py") if tests_dir else None)
    config = LintConfig(tests_dir=tests_dir, enabled=enabled,
                        smoke_file=smoke)
    paths = args.paths or ["src/repro_torch"]
    findings = analyze_paths(paths, config)

    if args.write_baseline:
        n = write_baseline(args.write_baseline, findings)
        print(f"wrote {n} finding(s) to {args.write_baseline}")
        return 0

    accepted = (set() if args.no_baseline
                else load_baseline(args.baseline))
    new = [f for f in findings if f.fingerprint not in accepted]
    fired = {f.fingerprint for f in findings}
    stale = sorted(accepted - fired)

    for f in new:
        print(f.render())
    if new:
        print(f"\n{len(new)} new finding(s) "
              f"({len(findings) - len(new)} baselined). Fix, suppress "
              f"with `# torchlint: disable=<check> -- reason`, or accept "
              f"via --write-baseline.")
        return 1
    if stale:
        print(f"{len(stale)} stale baseline entr{'y' if len(stale) == 1 else 'ies'} "
              f"(no longer fire): {', '.join(stale)}")
        if args.fail_on_stale:
            return 1
    print(f"torchlint clean: {len(findings)} finding(s), all baselined "
          f"or none.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
