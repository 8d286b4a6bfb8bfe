"""One run of one cell: set-up, a measured window, an optional traced span,
the correctness check, and the result line.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<mix>.json``); the
metrics it reports are the ``end_to_end`` and ``per_layer`` entries whose
``workloads`` list it (or that have no such list), each read by the file of
its name under ``e2e/`` or ``layers/``. Nothing here names a cell.

The program is driven through its own entry points, ``Engine.admit_many``
/ ``Engine.step``, in a closed loop. Requests are timed on the host clock
by the benchmark: each call into the engine is wrapped (on the instance,
not in the program) to stamp admissions and every token as the host
receives it.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from perfbench import check, devtrace, loadgen, weights as wmod, work

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
clock = time.perf_counter


# -- the cell -------------------------------------------------------------------
@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    e2e: List[Dict]
    per_layer: List[Dict]

    @property
    def model(self) -> Dict:
        return self.config["model"]

    @property
    def engine_kw(self) -> Dict:
        kw = dict(self.config.get("engine", {}))
        kw.update(self.traffic.get("engine", {}))
        return kw


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"perfbench: no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name, int(w["chips"]), config, traffic,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def reader(kind: str, name: str) -> Callable:
    """The ``read(rec)`` function of ``<kind>/<name>.py``."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# -- the program ---------------------------------------------------------------
def arch_config(cell: Cell):
    """The port's ``ArchConfig`` as the configuration file runs it; its
    sizes must be the file's ``model`` block."""
    from repro_torch.configs import get_config
    spec = cell.config["repro_torch"]
    cfg = dataclasses.replace(get_config(spec["arch"]),
                              **spec.get("replace", {}))
    m = cell.model
    for key in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                "vocab", "norm", "rope_theta", "tie_embeddings", "dtype",
                "gated_ffn", "act", "vocab_pad_multiple"):
        if key in m and getattr(cfg, key) != m[key]:
            raise SystemExit(f"perfbench: {cell.config['repro_torch']} has "
                             f"{key}={getattr(cfg, key)!r}, the file "
                             f"{m[key]!r}")
    if m.get("head_dim") and cfg.hd != m["head_dim"]:
        raise SystemExit("perfbench: head_dim differs from the program's")
    return cfg


@dataclasses.dataclass
class Track:
    """The benchmark's record of one request."""
    prompt_len: int
    max_new: int
    t_admit: Optional[float] = None
    stamps: List[float] = dataclasses.field(default_factory=list)
    t_finish: Optional[float] = None


class Driver:
    """Builds the program for a cell and drives it; every call into the
    engine is stamped."""

    def __init__(self, cell: Cell, seed: int, device: torch.device,
                 params: Dict, cfg, n_blocks: int):
        from repro_torch.serving.request import ServeRequest
        self.ServeRequest = ServeRequest
        self.cell, self.seed, self.dev = cell, seed, device
        self.mix = cell.traffic
        kw = cell.engine_kw
        self.max_batch = int(kw.pop("max_batch"))
        self.max_len = int(kw.pop("max_len"))
        kw["n_blocks"] = n_blocks
        from repro_torch.serving.engine import Engine
        self.eng = Engine(cfg, params, max_batch=self.max_batch,
                          max_len=self.max_len, device=device, **kw)
        self.tracks: Dict[int, Track] = {}
        self.inflight: Dict[int, object] = {}
        self.finished: List = []
        self.census = devtrace.SyncCensus()
        self.step_calls = 0
        self.decode_log: Optional[List] = None
        self.kv_peak = 0
        self._wrap()
        self.gen = loadgen.requests(self.mix, seed, cfg.vocab,
                                    self.max_batch)
        self.queue: List = []

    # -- instrumentation -------------------------------------------------------
    def _wrap(self) -> None:
        eng = self.eng
        admit, step, decode = eng.admit_many, eng.step, eng._decode

        def admit_many(reqs):
            t = clock()
            self.census.where = "admit"
            with devtrace.span("admit_many"):
                out = admit(reqs)
            self.census.where = "other"
            for r in out:
                tr = self.tracks.get(r.rid)
                if tr is not None and tr.t_admit is None:
                    tr.t_admit = t
                self.inflight[r.rid] = r
            self._stamp()
            return out

        def step_():
            self.census.where = "step"
            with devtrace.span("engine.step"):
                fin = step()
            self.census.where = "other"
            self.step_calls += 1
            now = self._stamp()
            for r in fin:
                self.inflight.pop(r.rid, None)
                tr = self.tracks.get(r.rid)
                if tr is not None:
                    tr.t_finish = now
                    self.finished.append(r)
            return fin

        def decode_(tokens, live):
            if self.decode_log is not None:
                pend = eng._pending_slots()
                pos = [s.ctx_len - 1 for i, s in enumerate(eng.slots)
                       if s is not None and i not in pend]
                self.decode_log.append((eng.max_batch, pos))
            return decode(tokens, live)

        eng.admit_many, eng.step, eng._decode = admit_many, step_, decode_

    def _stamp(self) -> float:
        now = clock()
        for rid, r in self.inflight.items():
            tr = self.tracks.get(rid)
            if tr is not None and len(r.generated) > len(tr.stamps):
                tr.stamps.extend([now] * (len(r.generated) - len(tr.stamps)))
        return now

    # -- requests ----------------------------------------------------------------
    def _new(self, q) -> object:
        r = self.ServeRequest(prompt=q.prompt, max_new_tokens=q.max_new)
        r.idx = q.idx
        self.tracks[r.rid] = Track(len(q.prompt), q.max_new)
        return r

    def _refill(self) -> None:
        want = int(self.mix["backlog_per_slot"]) * self.max_batch
        while len(self.queue) < want:
            self.queue.append(self._new(next(self.gen)))

    # -- one iteration of the loop ----------------------------------------------
    def iterate(self) -> None:
        self._refill()
        admitted = self.eng.admit_many(self.queue)
        if admitted:
            taken = {id(r) for r in admitted}
            self.queue = [r for r in self.queue if id(r) not in taken]
        self.kv_peak = max(self.kv_peak, self.eng.bm.blocks_in_use())
        self.eng.step()

    def run_until(self, done: Callable[[], bool]) -> None:
        while not done():
            self.iterate()

    # -- warm-up -----------------------------------------------------------------
    def warm_up(self) -> None:
        """Every prefill shape the mix can send (each length bucket of the
        group prefill, the chunk dispatch with one row and with a full
        group) and the decode step, on the engine itself, drained."""
        eng, kw = self.eng, self.cell.engine_kw
        lo, hi = self.mix["input"]["lo"], self.mix["input"]["hi"]
        chunk = int(kw.get("prefill_chunk", 0))
        group = int(kw.get("prefill_group", 4))
        top = hi if chunk <= 0 else min(hi, chunk)
        rng = loadgen.rng_of(self.seed, 9)
        vocab = int(self.cell.model["vocab"])
        mk = lambda n: self.ServeRequest(  # noqa: E731
            prompt=rng.integers(0, vocab, size=n).tolist(), max_new_tokens=2)
        batches = []
        if lo <= top:
            lens, b = [], 16
            while b < top:
                if b >= lo:
                    lens.append(b)
                b *= 2
            lens.append(top)
            batches.append([mk(n) for n in lens])
        if chunk > 0 and hi > chunk:
            for g in sorted({1, group}):
                batches.append([mk(chunk + 1) for _ in range(g)])
        for reqs in batches:
            for i in range(0, len(reqs), self.max_batch):
                eng.admit_many(reqs[i:i + self.max_batch])
                while eng.busy():
                    eng.step()
        self.inflight.clear()
        self.finished.clear()
        sync(self.dev)

    def fill(self) -> None:
        """Admit the first backlog and step until every request of it has
        its first token (the engine holds its steady rows)."""
        self._refill()
        first = list(self.queue)
        self.iterate()
        self.run_until(lambda: all(self.tracks[r.rid].stamps
                                   for r in first
                                   if self.tracks[r.rid].t_admit is not None))

    def stats(self) -> Dict:
        return dataclasses.asdict(self.eng.stats)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def kv_blocks(cell: Cell, dev: torch.device, block_size: int) -> int:
    """Blocks of the KV pool: what the card has left after the weights and
    the cell's workspace (the configuration's ``workspace_gib``); on the
    CPU the engine keywords' ``n_blocks``."""
    m = cell.model
    per_block = (2 * int(m["n_layers"]) * block_size * int(m["n_kv_heads"])
                 * int(m.get("head_dim") or m["d_model"] // m["n_heads"])
                 * 2)
    if dev.type != "cuda":
        return int(cell.engine_kw.get("n_blocks", 0))
    free, _ = torch.cuda.mem_get_info(dev)
    spare = free - float(cell.config["workspace_gib"]) * (1 << 30)
    return int(spare // per_block)


# -- one run -----------------------------------------------------------------------
def run(cell: Cell, seed: int, seconds: float, traced: bool,
        dev: torch.device, t_start: float,
        patch: Optional[Callable] = None,
        after: Optional[Callable] = None,
        keep: Optional[Dict] = None) -> Dict:
    """One run; returns the result line's object. ``patch(driver)`` (the
    tests' faults) is called once the program is built; ``after(params,
    seqs, ref_logits)`` (the control's readings) once the reference has
    judged the sample; ``keep`` (a dict) receives the run's record."""
    cfg = arch_config(cell)
    dtype = getattr(torch, cell.model["dtype"])
    params = wmod.make_weights(cell.model, seed, dev, dtype,
                               float(cell.config["init_std"]))
    from repro_torch.models import build_model
    want = build_model(cfg, device="meta").param_shapes()
    if wmod.shapes_of(params) != want:
        raise SystemExit("perfbench: the weight tree differs from the "
                         "program's param_shapes()")
    kw = cell.engine_kw
    n_blocks = kv_blocks(cell, dev, int(kw.get("block_size", 16)))
    drv = Driver(cell, seed, dev, params, cfg, n_blocks)
    per_block = drv.eng.cache["k"][:, 1:2].nbytes * 2
    if patch is not None:
        patch(drv)
    drv.warm_up()
    drv.fill()
    mix = cell.traffic
    sync(dev)
    t0 = clock()
    setup_s = t0 - t_start
    stats0 = drv.stats()
    drv.kv_peak = 0
    t1 = t0 + seconds
    drv.run_until(lambda: clock() >= t1)
    stats1 = drv.stats()
    rec = Record(cell=cell, seed=seed, t0=t0, t1=t1, setup_s=setup_s,
                 tracks=list(drv.tracks.values()), stats0=stats0,
                 stats1=stats1, shapes=work.shapes(cell.model),
                 kv_blocks=drv.eng.bm.n_blocks - 1,
                 kv_peak_blocks=drv.kv_peak)
    if keep is not None:
        keep["rec"] = rec
    print(f"perfbench: weights {wmod.count(params) * dtype.itemsize / 1e9:.2f}"
          f" GB; KV pool {rec.kv_blocks} blocks, "
          f"{rec.kv_blocks * per_block / 1e9:.2f} GB; at most "
          f"{rec.kv_peak_blocks} in use in the window, "
          f"{rec.kv_peak_blocks * per_block / 1e9:.2f} GB", file=sys.stderr)
    if traced:
        rec.profile = traced_span(drv, dev, float(mix["trace_s"]))
        rec.census = census(drv, int(mix["census_steps"]))
    attempted = sum(1 for tr in drv.tracks.values()
                    if tr.t_finish is not None and t0 < tr.t_finish <= t1)
    sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    done = [r for r in drv.finished
            if drv.tracks[r.rid].t_finish <= t1]
    picked = check.sample(done, seed, **mix["check"])
    seqs = [(list(r.prompt), list(r.generated)) for r in picked]
    del drv
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    from perfbench.reference.model import Reference
    # no finished request to judge: a gap no limit admits
    values = {"logit_gap": 1e9}
    if seqs:
        t_ref = clock()
        ref = Reference(cell.model, params).served_logits(seqs)
        print(f"perfbench: the reference judged {len(seqs)} requests, "
              f"{sum(len(s) for _, s in seqs)} served tokens, in "
              f"{clock() - t_ref:.1f} s", file=sys.stderr)
        values["logit_gap"] = check.served_gap(ref, [s for _, s in seqs])
        if after is not None:
            after(params, seqs, ref)
        del ref
    correct, table = check.judge(values, cell.config["limits"])
    metrics = {}
    for m in (cell.per_layer if traced else cell.e2e):
        kind = "layers" if traced else "e2e"
        v = reader(kind, m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": cell.chips, "memory_peak_bytes": int(peak)}
    # a closed loop finishes every request it admits: none is lost
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": 0, "metrics": metrics, "device": device}
    if traced:
        device["busy_s"] = rec.profile["busy_s"]
        device["window_s"] = rec.profile["window_s"]
        top = sorted(rec.profile["by_name"].items(), key=lambda kv: -kv[1])
        out["breakdown"] = {"device_ops": [[n[:200], s]
                                           for n, s in top[:10]],
                            "idle_gaps": rec.profile["gaps"][:10]}
    out["checks"] = table
    return out


@dataclasses.dataclass
class Record:
    """What the metric readers are given."""
    cell: Cell
    seed: int
    t0: float
    t1: float
    setup_s: float
    tracks: List[Track]
    stats0: Dict
    stats1: Dict
    shapes: Dict
    kv_blocks: int = 0              # the KV pool, trash block left out
    kv_peak_blocks: int = 0         # most blocks in use in the window
    profile: Optional[Dict] = None
    census: Optional[Dict] = None


def traced_span(drv: Driver, dev: torch.device, seconds: float) -> Dict:
    """Drive the loop for ``seconds`` more under ``torch.profiler`` (CPU
    and CUDA activity), logging each decode call's live rows; read the
    span's device time, gaps and kernels."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    drv.decode_log = []
    sync(dev)
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(devtrace.WINDOW):
            end = clock() + seconds
            drv.run_until(lambda: clock() >= end)
            sync(dev)
    out = devtrace.read_profile(prof)
    out["decode_log"], drv.decode_log = drv.decode_log, None
    return out


def census(drv: Driver, steps: int) -> Dict:
    """Syncs over ``steps`` more engine steps, by the span they fell in
    (needs the card: the sync debug mode is CUDA's)."""
    if drv.dev.type != "cuda":
        return {"counts": {}, "steps": 0}
    drv.census.counts = {}
    start = drv.step_calls
    with drv.census.on():
        drv.run_until(lambda: drv.step_calls - start >= steps)
    return {"counts": dict(drv.census.counts),
            "steps": drv.step_calls - start}
