"""One-time hardware calibration (paper §4.1.3 / §7.1.5, Table 4), in
PyTorch (port of ``repro/hw/calibration.py``).

The paper found white-paper peaks diverge from effective rates (L4: 121
reported vs ~55 measured TFLOPS), so ShuntServe calibrates each device type
once with three microbenchmarks that saturate distinct resources:

  * compute-bound GEMM      -> effective FLOP/s
  * memory-bound GEMV       -> effective HBM bytes/s
  * network-bound AllReduce -> effective link bytes/s (+ latency alpha)

The protocol is the reference's: each feature is measured at several sizes
and summarised by the **median**, and (alpha, beta) are fitted by least
squares over message sizes. Calibration measures the library, so the GEMM
and GEMV are plain ``torch.matmul`` calls (the reference times ``a @ b``
outside any Pallas kernel). On the card, timings end in
``torch.cuda.synchronize()``. The collective is a real ``all_reduce``
over a process group when the caller passes one of two or more ranks, and
otherwise the copy-based bound the reference falls back to with a single
device.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.hw.profiles import DeviceProfile


@dataclasses.dataclass
class CalibrationResult:
    device_name: str
    eff_flops: float
    eff_mem_bw: float
    eff_net_bps: float
    net_alpha_s: float
    wall_time_s: float
    samples: Dict[str, List[float]]

    def apply(self, dev: DeviceProfile) -> DeviceProfile:
        return dataclasses.replace(
            dev,
            flops_bf16=self.eff_flops,
            mem_bw=self.eff_mem_bw,
            intra_beta_bps=self.eff_net_bps,
            intra_alpha_s=self.net_alpha_s,
        )


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time_fn(fn, *args, warmup: int = 1, iters: int = 3) -> float:
    dev = args[0].device
    for _ in range(warmup):
        fn(*args)
        _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync(dev)
    return (time.perf_counter() - t0) / iters


def _normal(shape, gen: torch.Generator, dev: torch.device,
            dtype: torch.dtype) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def calibrate_gemm(sizes: Sequence[int] = (256, 512, 1024),
                   dtype: torch.dtype = torch.float32,
                   device: DeviceLike = None, seed: int = 0) -> List[float]:
    """Effective FLOP/s from square matmuls (2*m*n*k FLOPs each)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rates = []
    for n in sizes:
        a = _normal((n, n), gen, dev, dtype)
        b = _normal((n, n), gen, dev, dtype)
        dt = _time_fn(torch.matmul, a, b)
        rates.append(2.0 * n ** 3 / dt)
    return rates


def calibrate_gemv(sizes: Sequence[int] = (1024, 2048, 4096),
                   dtype: torch.dtype = torch.float32,
                   device: DeviceLike = None, seed: int = 0) -> List[float]:
    """Effective HBM bytes/s from matrix-vector products (reads n*n matrix)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rates = []
    for n in sizes:
        a = _normal((n, n), gen, dev, dtype)
        x = _normal((n,), gen, dev, dtype)
        dt = _time_fn(torch.matmul, a, x)
        rates.append(n * n * a.element_size() / dt)
    return rates


def calibrate_allreduce(sizes_bytes: Sequence[int] = (1 << 16, 1 << 20),
                        dtype: torch.dtype = torch.float32,
                        device: DeviceLike = None,
                        group=None) -> Dict[str, float]:
    """Effective collective beta (bytes/s) and alpha (s). Fits (alpha,
    beta) by least squares over message sizes:
        t(N) = alpha + N / beta

    With a process ``group`` of at least 2 ranks (the reference's several
    devices) it times a real ``dist.all_reduce`` SUM of N bytes on
    ``device`` over the group; every rank of the group must call it.
    Otherwise the collective degenerates to a copy-based bound on one
    device, as the reference falls back with a single device."""
    dev = resolve_device(device)
    itemsize = torch.empty((), dtype=dtype).element_size()
    times, sizes = [], []
    real = False
    if group is not None:
        import torch.distributed as dist
        real = dist.get_world_size(group) >= 2
    for nbytes in sizes_bytes:
        n = max(1, nbytes // itemsize)
        x = torch.ones((n,), dtype=dtype, device=dev)
        if real:
            dt = _time_fn(lambda a: dist.all_reduce(a, group=group), x)
        else:
            dt = _time_fn(lambda a: a + 1.0, x)
        times.append(dt)
        sizes.append(nbytes)
    # Least-squares fit of t = alpha + N/beta.
    A = np.stack([np.ones(len(sizes)), np.array(sizes, float)], axis=1)
    coef, *_ = np.linalg.lstsq(A, np.array(times), rcond=None)
    alpha = max(float(coef[0]), 1e-7)
    inv_beta = max(float(coef[1]), 1e-15)
    return {"alpha_s": alpha, "beta_bps": 1.0 / inv_beta}


# a decode step's all_reduce (tens of KB) up to a prefill's (tens of MB)
MESH_ALLREDUCE_SIZES = (1 << 16, 1 << 20, 1 << 24, 1 << 26)


def calibrate_model_allreduce(mesh, device: DeviceLike) -> Dict[str, float]:
    """``calibrate_allreduce`` over the process group of ``mesh``'s
    ``model`` axis that holds this rank, at ``MESH_ALLREDUCE_SIZES``: a
    rank function for ``launch.mesh.run_ranks`` (every rank calls it)."""
    return calibrate_allreduce(MESH_ALLREDUCE_SIZES, device=device,
                               group=mesh.group(("model",)))


def calibrate(device_name: str = "local",
              gemm_sizes: Sequence[int] = (256, 512, 1024),
              gemv_sizes: Sequence[int] = (1024, 2048, 4096),
              net_sizes: Sequence[int] = (1 << 16, 1 << 20),
              dtype: torch.dtype = torch.float32,
              device: DeviceLike = None, seed: int = 0,
              ) -> CalibrationResult:
    """Full calibration pass on ``device`` (the card unless the caller
    passes ``device="cpu"``); median-summarized per the paper."""
    t0 = time.perf_counter()
    gemm = calibrate_gemm(gemm_sizes, dtype, device, seed)
    gemv = calibrate_gemv(gemv_sizes, dtype, device, seed)
    net = calibrate_allreduce(net_sizes, dtype, device)
    wall = time.perf_counter() - t0
    return CalibrationResult(
        device_name=device_name,
        eff_flops=statistics.median(gemm),
        eff_mem_bw=statistics.median(gemv),
        eff_net_bps=net["beta_bps"],
        net_alpha_s=net["alpha_s"],
        wall_time_s=wall,
        samples={"gemm_flops": gemm, "gemv_bps": gemv},
    )
