"""Roofline analysis of dry-run records (the counterpart of
``repro/launch/roofline.py``).

Per (arch x shape x mesh) cell, three terms in SECONDS from one rank's
traced step (``launch/dryrun.py``: FLOPs, op bytes and collective wire
bytes a chip, ``launch/op_costs.py``):

    compute    = flops_per_chip / peak_FLOPs_per_chip
    memory     = bytes_per_chip / HBM_bw_per_chip
    collective = wire_bytes_per_chip / link_bw

Hardware: NVIDIA H100 SXM data-sheet figures, not measurements: 989
TFLOP/s dense bf16, 3.35 TB/s HBM3, 450 GB/s a direction over NVLink 4
inside one 8-GPU node, 50 GB/s (NDR 400 Gb/s InfiniBand, one NIC a GPU)
for a group that spans nodes. The collective term takes each record's
wire bytes over groups that span nodes (``collectives["network"]``) at
the network figure and the rest at NVLink's; a record without that split
(the reference's) is taken at the network figure. A (16, 16) mesh is 32
nodes: ``model``'s 16 consecutive ranks span two of them, ``data``'s
sixteen.

Also reports MODEL_FLOPS (analytic useful compute: 6·N_active·tokens for
training, 2·N_active·tokens for inference) and the usefulness ratio
MODEL_FLOPS / (flops_per_chip * chips), which exposes remat/redundant
compute.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

H100_PEAK_FLOPS = 989e12       # dense bf16, SXM data sheet
H100_HBM_BPS = 3.35e12         # HBM3, SXM data sheet
H100_NVLINK_BPS = 450e9        # NVLink 4, a direction, inside a node
H100_NETWORK_BPS = 50e9        # NDR 400 Gb/s a GPU, across nodes


@dataclasses.dataclass
class RooflineCell:
    arch: str
    shape: str
    step: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops_per_chip: float
    useful_ratio: float
    bottleneck: str
    peak_mem_bytes: float
    serve_pp: bool = False

    ideal_compute_s: float = 0.0
    ideal_memory_s: float = 0.0

    @property
    def total_s(self) -> float:
        # optimistic overlap model: terms overlap perfectly; the dominant
        # term is the floor
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """ideal_time / achieved_time, where ideal_time is the analytic
        roofline floor of the ALGORITHM on this hardware: max(useful FLOPs /
        peak, mandatory bytes / HBM bw). Decode is legitimately memory-bound
        — an MFU-style fraction would misgrade it; this fraction is 1.0 when
        the program moves only the mandatory bytes and computes only the
        useful FLOPs at peak."""
        if self.total_s <= 0:
            return 0.0
        ideal = max(self.ideal_compute_s, self.ideal_memory_s)
        return min(1.0, ideal / self.total_s)


def n_chips(mesh: str) -> int:
    return {"16x16": 256, "2x16x16": 512}[mesh]


def model_flops_for(arch: str, shape_name: str) -> float:
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ALL_SHAPES
    cfg = get_config(arch)
    spec = cfg.to_modelspec()
    shape = {s.name: s for s in ALL_SHAPES}[shape_name]
    n_active = spec.params_active()
    if shape.step == "train_step":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.step == "prefill_step":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch       # one decode token


def analytic_min_bytes(arch: str, shape_name: str) -> float:
    """Mandatory GLOBAL memory traffic of the algorithm (weights scanned
    once per step + activations + KV/state), from the paper's Table 2 scan
    terms at d_tp=1. Train approximates fwd+bwd as 3x the forward scan."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ALL_SHAPES
    from repro_torch.core import roofline as rl
    cfg = get_config(arch)
    spec = cfg.to_modelspec()
    shape = {s.name: s for s in ALL_SHAPES}[shape_name]
    b, s = shape.global_batch, shape.seq_len
    phase = "decode" if shape.step == "serve_step" else "prefill"
    s_in = s if phase == "prefill" else s - 1
    s_out = 1 if phase == "decode" else 0
    total = 0.0
    for layer in spec.layers + spec.encoder_layers:
        for op in rl.layer_op_costs(layer, phase, b, s_in, max(s_out, 1), 1,
                                    spec.dtype_bytes):
            total += op.scan_bytes
    total += rl.logits_op_cost(spec, phase, b, s_in, max(s_out, 1),
                               1).scan_bytes
    if shape.step == "train_step":
        total *= 3.0                      # fwd + backward weight/act reads
    return total


def collective_seconds(coll: Dict[str, Any]) -> float:
    """A record's collective term: wire bytes over groups that span nodes
    at the network figure, the rest at NVLink's (all at the network figure
    where the record has no split)."""
    total = float(coll.get("total", 0.0))
    network = float(coll.get("network", total))
    return network / H100_NETWORK_BPS + (total - network) / H100_NVLINK_BPS


def analyze_record(rec: Dict[str, Any]) -> Optional[RooflineCell]:
    ca = rec.get("cost_analysis", {})
    if "flops" not in ca:
        return None
    chips = n_chips(rec["mesh"])
    # compute: the traced FLOPs; memory: the larger of the traced op bytes
    # and the analytic Table-2 scan traffic
    tw = rec.get("tw_costs", {})
    flops = float(tw.get("flops", ca.get("flops", 0.0)))
    traced_bytes = float(ca.get("bytes accessed", 0.0))
    analytic_bytes = analytic_min_bytes(rec["arch"], rec["shape"]) / chips
    hbm_bytes = max(traced_bytes, analytic_bytes)
    compute_s = flops / H100_PEAK_FLOPS
    memory_s = hbm_bytes / H100_HBM_BPS
    collective_s = collective_seconds(rec.get("collectives", {}))
    mf = model_flops_for(rec["arch"], rec["shape"])
    useful = mf / max(1.0, flops * chips)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    peak = float(rec.get("memory_analysis", {}).get(
        "peak_memory_in_bytes", 0.0))
    ideal_c = mf / (chips * H100_PEAK_FLOPS)
    ideal_m = analytic_bytes / H100_HBM_BPS
    return RooflineCell(
        rec["arch"], rec["shape"], rec["step"], rec["mesh"], compute_s,
        memory_s, collective_s, mf, flops, useful, bottleneck, peak,
        serve_pp=bool(rec.get("serve_pp")), ideal_compute_s=ideal_c,
        ideal_memory_s=ideal_m)


def analyze_file(path: str) -> List[RooflineCell]:
    with open(path) as f:
        data = json.load(f)
    cells = []
    for rec in data.get("records", []):
        c = analyze_record(rec)
        if c:
            cells.append(c)
    return cells


def whats_next(cell: RooflineCell) -> str:
    """One sentence: what moves the dominant term down."""
    if cell.bottleneck == "compute":
        if cell.useful_ratio < 0.4:
            return ("compute-bound but mostly NON-useful FLOPs: cut remat "
                    "recompute / dense-replicated work (check scan policy)")
        return ("compute-bound near useful: raise tensor-core utilization "
                "(tile alignment, bf16 accumulation), or shard the "
                "dominant matmul over more axes")
    if cell.bottleneck == "memory":
        return ("HBM-bound: shrink the resident working set — shard the KV "
                "cache/weights over more axes, fuse elementwise chains, or "
                "quantize the cache")
    return ("collective-bound: change the sharding to cut all-gathers "
            "(FSDP prefetch overlap, sequence-sharded KV instead of "
            "softmax-side reductions, or bigger per-step compute)")
