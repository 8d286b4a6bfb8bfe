"""Training driver: ``python -m repro_torch.launch.train --arch <id> [...]``
(port of ``repro/launch/train.py``).

End-to-end training on one device: data pipeline -> microbatched
``train_step`` (each layer rematerialised; attention through the flash
forward and backward kernels on the card) -> checkpointing -> resume. The
default device is the card; without one it raises unless ``--device cpu``.

  python -m repro_torch.launch.train --arch internlm2-1.8b --reduced \\
      --steps 200 --batch 8 --seq 128 --microbatches 2 \\
      --ckpt-dir /tmp/repro_torch_train_small --ckpt-every 50
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import DataConfig, SyntheticLM, to_torch
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import init_train_state, make_train_step


def main(argv: Optional[List[str]] = None) -> List[float]:
    """Run the driver; returns the losses it printed (one per logged
    step)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced config (CPU-friendly)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=dev, remat=True)
    state = init_train_state(model.init(seed=0))
    print(f"[train] {cfg.name}: {model.param_count() / 1e6:.2f}M params, "
          f"batch={args.batch} seq={args.seq} micro={args.microbatches} "
          f"on {dev}")

    step_fn = make_train_step(model, AdamWConfig(lr=args.lr),
                              n_microbatches=args.microbatches)
    data = SyntheticLM(cfg, DataConfig(args.batch, args.seq))

    start = 0
    if args.resume and args.ckpt_dir:
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            state = ckpt.restore_checkpoint(args.ckpt_dir, last, state)
            start = last
            print(f"[train] resumed from step {last}")

    losses = []
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        batch = to_torch(data.batch_at(step), dev)
        state, metrics = step_fn(state, batch)
        if step % max(1, args.steps // 10) == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = time.perf_counter() - t0
            tok_s = (step - start + 1) * args.batch * args.seq / dt
            print(f"  step {step:5d} loss {loss:7.4f} "
                  f"({tok_s:9.0f} tok/s)")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save_checkpoint(args.ckpt_dir, step + 1, state)
    if args.ckpt_dir:
        ckpt.save_checkpoint(args.ckpt_dir, args.steps, state)
    print("[train] done")
    return losses


if __name__ == "__main__":
    main()
