"""The control of a cell's correctness check, on the card at the cell's own
size: for each seed, one run of the cell (a short window at its own load),
then over the same sample of prompts and served tokens the reference in
float32 and the reference in float8 (``Reference(precision="fp8")``, the
precision below the configuration's bfloat16). Prints, a line a seed, the
program's logit gap (a sound run's reading) and the gap of the tokens the
float8 reference puts first (the control's reading).

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 20
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import os
    os.environ.setdefault("REPRO_TORCH_BUILD_DIR",
                          str(ROOT / "build" / "kernels"))
    import torch
    from perfbench import check, harness
    from perfbench.reference.model import Reference

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("perfbench: the control needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for seed in [int(x) for x in args.seeds.split(",")]:
        got = {}

        def after(params, seqs, ref):
            ctl = Reference(cell.model, params, precision="fp8"
                            ).served_logits(seqs)
            got["control_gap"] = check.control_gap(ref, ctl)
            got["tokens"] = sum(len(s) for _, s in seqs)

        t = time.perf_counter()
        out = harness.run(cell, seed, args.seconds, False, dev,
                          time.perf_counter(), after=after)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "program_gap": out["checks"]["logit_gap"]["value"],
                          "control_gap": got.get("control_gap"),
                          "sampled_tokens": got.get("tokens"),
                          "correct": out["correct"],
                          "metrics": out["metrics"],
                          "seconds": time.perf_counter() - t}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
