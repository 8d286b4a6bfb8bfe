"""Serving driver: ``python -m repro_torch.launch.serve --arch <id> [...]``
(port of ``repro/launch/serve.py``).

Places the model on a (simulated or declared) cluster with the ShuntServe
optimizer, builds real engines per pipeline, serves a batched workload with
continuous batching, and optionally injects a spot interruption to exercise
output-preserving migration + concurrent initialization.

Dispatch weights and the virtual-clock increment per round come from the
§4.1 estimator's stage latencies for each placed pipeline, so the reported
virtual throughput is consistent with the simulator, not a hardcoded
weight=1.0 / 0.01 s round. The engines run on the card by default
(``--device cpu`` runs the plain PyTorch path); the printed lines are the
reference's.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import populate_cluster
from repro_torch.device import resolve_device
from repro_torch.hw import AWS_INSTANCES, effective, paper_cluster
from repro_torch.models import build_model
from repro_torch.serving import GlobalServer, ServeRequest, TensorStore


def main(argv: Optional[List[str]] = None,
         params: Optional[Dict] = None) -> List[ServeRequest]:
    """Run the driver; returns the served requests. ``params`` (the
    execution config's, on the serving device) replaces the seed-0
    init."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=12)
    ap.add_argument("--interrupt-at", type=int, default=-1,
                    help="scheduling round to interrupt an instance at")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked-prefill size (0 = single-shot admission)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch path)")
    ap.add_argument("--reduced", action="store_true", default=True)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    exec_cfg = cfg.reduced() if args.reduced else cfg
    # control plane: ShuntServe placement for the FULL model on the paper's
    # cluster (what would run in production)
    insts = {n: dataclasses.replace(i, device=effective(i.device))
             for n, i in AWS_INSTANCES.items()}
    plan = populate_cluster(cfg.to_modelspec(), paper_cluster(), insts,
                            763, 232, beam_k=1)
    print(f"[serve] placement for {cfg.name}: {len(plan.pipelines)} "
          f"pipelines, est {plan.total_rps:.2f} rps")
    for p in plan.pipelines:
        print("   ", p.describe())

    # data plane: real engines on the execution config
    if params is None:
        params = build_model(exec_cfg, device=dev, remat=False).init(seed=0)
    store = TensorStore()
    srv = GlobalServer(exec_cfg, store, max_batch=4, max_len=96, device=dev,
                       prefill_chunk=args.prefill_chunk)
    for i, placement in enumerate(plan.pipelines[:2] or [None]):
        pipe = srv.add_pipeline(params, [f"inst-{i}-a", f"inst-{i}-b"],
                                placement=placement)
        print(f"[serve] p{pipe.pid}: est weight {pipe.weight:.3f} rps, "
              f"round {pipe.round_s*1e3:.2f} ms")
    rng = np.random.RandomState(0)
    reqs = [ServeRequest(
        prompt=rng.randint(0, exec_cfg.vocab,
                           size=rng.randint(3, 8)).tolist(),
        max_new_tokens=args.max_new_tokens) for _ in range(args.requests)]
    for r in reqs:
        srv.submit(r)
    t0 = time.perf_counter()
    rounds = 0
    while srv.pending():
        if rounds == args.interrupt_at:
            print(f"[serve] interrupting inst-0-a at round {rounds}")
            srv.interrupt_instance("inst-0-a")
        srv.step()
        srv.tick()
        rounds += 1
        if rounds > 50_000:
            break
    dt = time.perf_counter() - t0
    done = [r for r in reqs if r.done]
    toks = sum(len(r.generated) for r in done)
    migrated = sum(1 for r in reqs if r.migrations)
    retraces = sum(p.engine.stats.prefill_retraces for p in srv.pipelines)
    print(f"[serve] {len(done)}/{len(reqs)} requests, {toks} tokens in "
          f"{dt:.1f}s wall ({toks/dt:.1f} tok/s), {migrated} migrated, "
          f"{rounds} rounds")
    print(f"[serve] virtual clock {srv.clock:.2f}s -> "
          f"{toks/max(srv.clock, 1e-9):.1f} tok/s simulated; "
          f"{retraces} prefill traces")
    return reqs


if __name__ == "__main__":
    main()
