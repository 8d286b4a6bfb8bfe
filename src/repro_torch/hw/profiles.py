"""Hardware device/instance profiles.

The paper (Table 1) grades GPUs by peak BF16 FLOPS, memory capacity and HBM
bandwidth, plus per-instance network characteristics (alpha/beta for both
intra-stage TP fabric and inter-stage PP fabric) and spot/on-demand pricing.

We carry BOTH the paper's AWS GPU instances (to reproduce its evaluation) and
TPU profiles (copied with the rest of the table). The estimator/optimizer
only ever sees ``DeviceProfile``/``InstanceProfile`` and is agnostic to the
vendor. The port runs on an H100, whose row holds data-sheet peaks, not a
measurement; ``hw.calibration`` measures the effective rates on the card.

Effective (calibrated) numbers differ from white-paper peaks (paper §7.1.5:
L4 reports 121 TFLOPS but measures ~55). Profiles store *peak* values;
``hw.calibration`` produces *effective* values and ``derate()`` applies them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """A single accelerator die."""

    name: str
    mem_gb: float                 # HBM capacity
    flops_bf16: float             # peak dense BF16 FLOP/s
    mem_bw: float                 # HBM bytes/s
    # Intra-stage fabric (TP): PCIe/NVLink on GPU, ICI on TPU.
    intra_alpha_s: float          # per-message latency, seconds
    intra_beta_bps: float         # bytes/s per device
    kind: str = "gpu"             # "gpu" | "tpu"

    def derate(self, flops_scale: float = 1.0, bw_scale: float = 1.0,
               net_scale: float = 1.0) -> "DeviceProfile":
        return dataclasses.replace(
            self,
            flops_bf16=self.flops_bf16 * flops_scale,
            mem_bw=self.mem_bw * bw_scale,
            intra_beta_bps=self.intra_beta_bps * net_scale,
        )


@dataclasses.dataclass(frozen=True)
class InstanceProfile:
    """A rentable node: N devices of one type + inter-node fabric + price."""

    name: str
    device: DeviceProfile
    num_devices: int
    # Inter-stage fabric (PP): Ethernet/EFA on AWS, DCN between TPU pods.
    inter_alpha_s: float
    inter_beta_bps: float
    price_ondemand_hr: float
    price_spot_hr: float
    spot_pool: str = ""           # pools with correlated interruption

    @property
    def mem_bytes_total(self) -> float:
        return self.num_devices * self.device.mem_gb * 1e9

    def __str__(self) -> str:  # pragma: no cover - debugging nicety
        return f"{self.name}({self.num_devices}x{self.device.name})"


GB = 1e9
TFLOPS = 1e12

# ---------------------------------------------------------------------------
# Paper Table 1 GPUs. FLOPS are BF16 non-sparse peaks; paper's calibration
# found effective ~0.45-0.6x of peak — DEFAULT_DERATE reflects that (§7.1.5).
# ---------------------------------------------------------------------------
L4 = DeviceProfile("L4", 24, 121 * TFLOPS, 300 * GB, 5e-6, 32 * GB)
A10G = DeviceProfile("A10G", 24, 70 * TFLOPS, 600 * GB, 5e-6, 32 * GB)
L40S = DeviceProfile("L40S", 48, 362 * TFLOPS, 864 * GB, 5e-6, 32 * GB)
A100_40 = DeviceProfile("A100", 40, 312 * TFLOPS, 1555 * GB, 3e-6, 300 * GB)
H100 = DeviceProfile("H100", 80, 989 * TFLOPS, 3350 * GB, 3e-6, 450 * GB)
B200 = DeviceProfile("B200", 180, 4500 * TFLOPS, 7700 * GB, 3e-6, 900 * GB)

# TPU profiles (target runtime). ICI is the intra-"stage" fabric; DCN the
# inter-pod fabric. v5e numbers come from the brief: 197 bf16 TFLOP/s,
# 819 GB/s HBM, ~50 GB/s per ICI link.
TPU_V5E = DeviceProfile("TPUv5e", 16, 197 * TFLOPS, 819 * GB, 1e-6, 50 * GB,
                        kind="tpu")
TPU_V4 = DeviceProfile("TPUv4", 32, 275 * TFLOPS, 1228 * GB, 1e-6, 100 * GB,
                       kind="tpu")
TPU_V5P = DeviceProfile("TPUv5p", 95, 459 * TFLOPS, 2765 * GB, 1e-6, 100 * GB,
                        kind="tpu")

# Paper's effective-vs-peak derates observed during calibration (§7.1.5).
DEFAULT_DERATE = {
    "L4": (55.0 / 121.0, 0.85),     # (flops_scale, bw_scale)
    "A10G": (0.60, 0.85),
    "L40S": (0.55, 0.85),
    "A100": (0.60, 0.80),
    "H100": (0.60, 0.80),
    "B200": (0.55, 0.80),
    "TPUv5e": (0.72, 0.90),
    "TPUv4": (0.70, 0.90),
    "TPUv5p": (0.70, 0.90),
}


def effective(dev: DeviceProfile) -> DeviceProfile:
    """Apply the default calibration derate (stand-in for hw.calibration)."""
    fs, bs = DEFAULT_DERATE.get(dev.name, (0.6, 0.85))
    return dev.derate(flops_scale=fs, bw_scale=bs)


# ---------------------------------------------------------------------------
# AWS instances used in the paper's evaluation cluster (§7 Model and Cluster
# Setup): 3x g6.12xlarge (4xL4), 2x g5.12xlarge (4xA10G), 4x g6e.xlarge
# (1xL40S). Prices are us-west-2 on-demand / representative spot.
# ---------------------------------------------------------------------------
def _inst(name, dev, n, od, spot, pool, inter_beta=25 * GB / 8 * 1.0):
    # Default inter-node: 25 Gbps-class Ethernet unless overridden.
    return InstanceProfile(name, dev, n, 5e-5, inter_beta, od, spot, pool)


AWS_INSTANCES: Dict[str, InstanceProfile] = {
    "g6.12xlarge": _inst("g6.12xlarge", L4, 4, 4.601, 1.61, "g6",
                         inter_beta=40e9 / 8),
    "g5.12xlarge": _inst("g5.12xlarge", A10G, 4, 5.672, 1.98, "g5",
                         inter_beta=40e9 / 8),
    "g6e.xlarge": _inst("g6e.xlarge", L40S, 1, 1.861, 0.65, "g6e",
                        inter_beta=20e9 / 8),
    "g6e.12xlarge": _inst("g6e.12xlarge", L40S, 4, 10.493, 3.67, "g6e",
                          inter_beta=100e9 / 8),
    "g6.48xlarge": _inst("g6.48xlarge", L4, 8, 13.350, 4.67, "g6",
                         inter_beta=100e9 / 8),
    "g5.48xlarge": _inst("g5.48xlarge", A10G, 8, 16.288, 5.70, "g5",
                         inter_beta=100e9 / 8),
    "g6e.48xlarge": _inst("g6e.48xlarge", L40S, 8, 30.131, 10.55, "g6e",
                          inter_beta=400e9 / 8),
    "p4d.24xlarge": _inst("p4d.24xlarge", A100_40, 8, 32.773, 11.47, "p4d",
                          inter_beta=400e9 / 8),
    "p5.48xlarge": _inst("p5.48xlarge", H100, 8, 98.32, 34.41, "p5",
                         inter_beta=3200e9 / 8),
}

# TPU "instances": a slice of chips rentable as one unit. Preemptible slices
# are GCP's spot analog. Inter = DCN per host (~25 GB/s).
TPU_INSTANCES: Dict[str, InstanceProfile] = {
    "v5e-4": InstanceProfile("v5e-4", TPU_V5E, 4, 2e-5, 25 * GB, 4.8, 1.7,
                             "v5e"),
    "v5e-8": InstanceProfile("v5e-8", TPU_V5E, 8, 2e-5, 25 * GB, 9.6, 3.4,
                             "v5e"),
    "v4-8": InstanceProfile("v4-8", TPU_V4, 8, 2e-5, 25 * GB, 12.9, 4.5,
                            "v4"),
    "v5p-8": InstanceProfile("v5p-8", TPU_V5P, 8, 2e-5, 25 * GB, 33.1, 11.6,
                             "v5p"),
}

ALL_INSTANCES: Dict[str, InstanceProfile] = {**AWS_INSTANCES, **TPU_INSTANCES}


def paper_cluster() -> Dict[str, int]:
    """The paper's 24-GPU evaluation cluster (counts per instance type)."""
    return {"g6.12xlarge": 3, "g5.12xlarge": 2, "g6e.xlarge": 4}


def get_instance(name: str) -> InstanceProfile:
    return ALL_INSTANCES[name]
