"""Multi-pod dry run on fake ranks (the counterpart of
``repro/launch/dryrun.py``): build every (architecture x input shape) step
on the production meshes and record one rank's memory, FLOPs, bytes and
collective bytes, in one host process a cell, with no card.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
      --shape decode_32k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
      --shape train_4k --extra-rules '{"seq": ["model"]}'
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out results/dryrun_torch.json

Each traced rank runs in a subprocess of its own (cells on the same mesh
and rank share one), since the fake process group is global to a
process: it calls ``dist.init_process_group("fake",
store=FakeStore(), rank=r, world_size=256 | 512)``, ``make_production_mesh``
(``launch/mesh.py``), ``build_step(..., device="cpu")`` and then traces
the rank's step (``launch/op_costs.py``): train (forward, backward,
AdamW), prefill, a serve token, or a PP stage. It traces rank 0, and for
a PP step the first rank of each stage (the record's numbers are the
largest stage's, each stage's under ``meta["stages"]``). A train step is
traced at 2 and 3 depth units and 1 and 2 microbatches and scaled to the
configuration (``op_costs.scale``; a cell's ``full`` traces it as built).

The traced route is the CPU one, through the kernels' plain versions:
attention's FLOPs are its full S x S products, as the reference's HLO of
jnp attention counts them. The record has the reference's keys
(``memory_analysis``, ``cost_analysis``, ``collectives``, ``tw_costs``,
``meta``; ``lower_s`` is the trace's seconds, ``compile_s`` 0), so
``launch/roofline.py``'s ``analyze_record`` reads both.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import traceback
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.configs import REGISTRY, get_config
from repro_torch.configs.shapes import ALL_SHAPES, ShapeSpec, shapes_for
from repro_torch.launch.op_costs import collectives_record

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _mesh_name(shape: Sequence[int]) -> str:
    return "x".join(str(n) for n in shape)


def depth_unit(cfg) -> int:
    """Layers a depth unit holds: a hybrid's period, else one."""
    return cfg.hybrid_period if cfg.family == "hybrid" else 1


def at_depth(cfg, units: int):
    """``cfg`` cut to ``units`` depth units (an encoder-decoder's encoder
    too, which must be as deep as its decoder)."""
    n = units * depth_unit(cfg)
    if cfg.is_encdec:
        if cfg.n_encoder_layers != cfg.n_layers:
            raise NotImplementedError(
                f"{cfg.name}: scaling an encoder of {cfg.n_encoder_layers} "
                f"layers beside a decoder of {cfg.n_layers}")
        return dataclasses.replace(cfg, n_layers=n, n_encoder_layers=n)
    return dataclasses.replace(cfg, n_layers=n)


def trace_cells(specs: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The worker's side: one rank of a fake world, every spec's step
    traced on it (``spec``: ``arch``, ``shape`` (a name or [seq_len,
    global_batch, step]), ``mesh`` [shape, axes] and ``rank``, the same
    for every spec, ``step_kw`` for ``build_step``, ``reduced`` and
    ``overrides`` for a test's config, ``full``); returns, for each,
    ``op_costs.StepCosts`` fields and the step's meta."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_mesh
    mesh_shape, axes = specs[0]["mesh"]
    world = 1
    for n in mesh_shape:
        world *= n
    dist.init_process_group("fake", store=FakeStore(),
                            rank=specs[0]["rank"], world_size=world)
    try:
        mesh = make_mesh(mesh_shape, axes)
        return [_trace_one(spec, mesh) for spec in specs]
    finally:
        dist.destroy_process_group()


def _trace_one(spec: Dict[str, Any], mesh: Any) -> Dict[str, Any]:
    from repro_torch.launch import op_costs
    from repro_torch.launch.steps import build_step
    cfg = get_config(spec["arch"])
    if spec.get("reduced"):
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, **spec.get("overrides", {}))
    shape = _shape(spec["shape"])
    kw = dict(spec.get("step_kw", {}))
    if kw.get("extra_rules"):
        kw["extra_rules"] = {k: tuple(v) if isinstance(v, list) else v
                             for k, v in kw["extra_rules"].items()}
    built = build_step(cfg, shape, mesh, device="cpu", **kw)
    meta = {k: v for k, v in built.meta.items()
            if isinstance(v, (int, float, str, list, tuple))}
    meta["seq"] = getattr(built.meta.get("layout"), "seq", None)
    if shape.step != "train_step" or spec.get("full"):
        costs = op_costs.trace(built, shape.step)
    else:
        nm = built.meta["n_microbatches"]
        mb = shape.global_batch // nm
        units = cfg.n_layers // depth_unit(cfg)
        traced = {}
        for d in ((2, 3) if units > 3 else (units,)):
            for k in (1, 2):
                kw["n_microbatches"] = k
                b = build_step(at_depth(cfg, d), dataclasses.replace(
                    shape, global_batch=mb * k), mesh, device="cpu", **kw)
                traced[(d, k)] = op_costs.trace(b, shape.step)
        costs = op_costs.scale(traced, units, nm)
        meta["scaled"] = {"depth_units": units, "microbatches": nm,
                          "traced": [list(key) for key in traced]}
    return {"costs": dataclasses.asdict(costs), "meta": meta}


def _shape(s) -> ShapeSpec:
    if isinstance(s, str):
        return {x.name: x for x in ALL_SHAPES}[s]
    seq_len, batch, step = s
    return ShapeSpec(step[0], seq_len, batch, step)


def run_traced(specs: List[Dict[str, Any]], timeout: float = 900.0
               ) -> List[Dict[str, Any]]:
    """``trace_cells`` of the specs, in their order: one subprocess for
    each (mesh, rank) among them (a fake world is global to its process),
    all at once; raises with a failed one's error output."""
    import repro_torch
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    groups: Dict[str, List[int]] = {}
    for i, spec in enumerate(specs):
        groups.setdefault(json.dumps([spec["mesh"], spec["rank"]]),
                          []).append(i)
    procs = [(idx, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--worker",
         json.dumps([specs[i] for i in idx])], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for idx in groups.values()]
    out: List[Any] = [None] * len(specs)
    for idx, p in procs:
        stdout, stderr = p.communicate(timeout=timeout)
        if p.returncode != 0:
            raise RuntimeError(f"dry-run worker failed ({p.returncode}):\n"
                               f"{stderr[-4000:]}")
        line = [ln for ln in stdout.splitlines() if ln.startswith("JSON::")]
        for i, got in zip(idx, json.loads(line[-1][len("JSON::"):])):
            out[i] = got
    return out


def _ranks(shape: ShapeSpec, mesh_shape, axes, serve_pp: bool
           ) -> List[int]:
    """The ranks a cell traces: 0, and for a PP serve step the first rank
    of each stage."""
    if serve_pp and "pod" in axes and shape.step == "serve_step":
        per = 1
        for n in mesh_shape[1:]:
            per *= n
        return [s * per for s in range(mesh_shape[0])]
    return [0]


def run_cell(arch: str, shape_name, multi_pod: bool = False,
             quiet: bool = False, **kw: Any) -> Dict[str, Any]:
    """One cell's record (the reference's keys); ``kw`` as ``run_cells``
    takes a cell's."""
    return run_cells([dict(kw, arch=arch, shape=shape_name,
                           multi_pod=multi_pod)], quiet=quiet)[0]


def run_cells(cells: List[Dict[str, Any]], quiet: bool = False
              ) -> List[Dict[str, Any]]:
    """Each cell's record, every traced rank of every cell in a subprocess
    of its own, all at once. A cell: ``arch``, ``shape`` (a name, or
    [seq_len, global_batch, step]), ``multi_pod``, ``serve_pp``,
    ``extra_rules``, ``mesh`` ((shape, axes) instead of the production
    mesh), ``reduced`` / ``overrides`` (a test's config), ``full``, and
    ``build_step``'s keywords (the hill-climber's levers)."""
    specs, owners, recs = [], [], []
    for i, cell in enumerate(cells):
        kw = dict(cell)
        arch, shape_name = kw.pop("arch"), kw.pop("shape")
        mesh_shape, axes = (kw.pop("mesh", None)
                            or PRODUCTION[bool(kw.pop("multi_pod", False))])
        kw.pop("multi_pod", None)
        extra_rules = kw.get("extra_rules") or {}
        pp = bool(kw.pop("serve_pp", False) and "pod" in axes)
        if pp:
            kw["serve_pp"] = True
        shape = _shape(shape_name)
        spec = {"arch": arch, "shape": shape_name,
                "mesh": [list(mesh_shape), list(axes)],
                "reduced": kw.pop("reduced", False),
                "overrides": kw.pop("overrides", None) or {},
                "full": kw.pop("full", False), "step_kw": kw}
        for r in _ranks(shape, mesh_shape, axes, pp):
            specs.append(dict(spec, rank=r))
            owners.append(i)
        recs.append({"arch": arch, "shape": shape.name, "step": shape.step,
                     "mesh": _mesh_name(mesh_shape), "serve_pp": pp,
                     "extra_rules": extra_rules})
    got = run_traced(specs)
    for i, rec in enumerate(recs):
        mine = [g for g, o in zip(got, owners) if o == i]
        _fill(rec, [g["costs"] for g in mine], mine[0]["meta"])
        if not quiet:
            _print(rec)
    return recs


def _fill(rec: Dict[str, Any], costs: List[Dict[str, Any]],
          meta: Dict[str, Any]) -> None:
    """The record's numbers from its traced ranks: each the largest over
    them (a PP cell's stages, each under ``meta["stages"]``)."""
    def most(key):
        return max(c[key] for c in costs)
    coll: Dict[str, Dict[str, float]] = {}
    for c in costs:
        for kind, v in c["collectives"].items():
            mine = coll.setdefault(kind, dict.fromkeys(v, 0.0))
            for f, x in v.items():
                mine[f] = max(mine[f], x)
    rec["lower_s"] = round(sum(c["seconds"] for c in costs), 2)
    rec["compile_s"] = 0.0
    rec["memory_analysis"] = {
        "argument_size_in_bytes": int(most("arg_bytes")),
        "temp_size_in_bytes": int(most("peak_bytes") - most("arg_bytes")),
        "peak_memory_in_bytes": int(most("peak_bytes"))}
    rec["cost_analysis"] = {"flops": most("flops"),
                            "bytes accessed": most("bytes")}
    rec["collectives"] = collectives_record(coll)
    rec["tw_costs"] = {"flops": most("flops"), "bytes": most("bytes")}
    rec["meta"] = dict(meta)
    if rec["serve_pp"]:
        rec["meta"]["stages"] = [{k: v for k, v in c.items() if k != "log"}
                                 for c in costs]


def _print(rec: Dict[str, Any]) -> None:
    print(f"[dryrun] {rec['arch']} x {rec['shape']} on {rec['mesh']}"
          f"{' (PP)' if rec['serve_pp'] else ''}"
          f"{' ' + json.dumps(rec['extra_rules']) if rec['extra_rules'] else ''}"
          f": trace {rec['lower_s']}s")
    ma = rec["memory_analysis"]
    print(f"  memory: args={ma['argument_size_in_bytes'] / 1e9:.3f} GB "
          f"peak={ma['peak_memory_in_bytes'] / 1e9:.3f} GB")
    ca = rec["cost_analysis"]
    print(f"  costs: flops={ca['flops']:.4e} bytes={ca['bytes accessed']:.4e}")
    co = rec["collectives"]
    kinds = {k: co[k] for k in co if k not in (
        "total", "raw_output_bytes", "counts", "rank_bytes", "network")}
    print(f"  collective wire bytes a chip: {co['total']:.4e} "
          f"({', '.join(f'{k} {v:.4e}' for k, v in kinds.items())}); "
          f"rank bytes {co['raw_output_bytes']:.4e}; calls "
          f"{ {k: int(v) for k, v in co['counts'].items()} }")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x applicable shape) cell")
    ap.add_argument("--serve-pp", action="store_true",
                    help="multi-pod serving uses pipeline parallelism over "
                         "the pod axis (paper-faithful) when supported")
    ap.add_argument("--extra-rules", default=None,
                    help='JSON rules on top of build_rules, e.g. '
                         '\'{"seq": ["model"]}\'')
    ap.add_argument("--out", default=None, help="write JSON records here")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print("JSON::" + json.dumps(trace_cells(json.loads(args.worker))))
        return

    cells = []
    if args.all:
        for name, cfg in REGISTRY.items():
            for sh in shapes_for(cfg):
                cells.append((name, sh.name))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells.append((args.arch, args.shape))
    extra = json.loads(args.extra_rules) if args.extra_rules else None
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    records, failures = [], []
    for arch, shape_name in cells:
        for multi in meshes:
            pp = args.serve_pp and multi
            if pp:
                from repro_torch.launch.pipeline import pp_supported
                pp = (pp_supported(get_config(arch))
                      and _shape(shape_name).step == "serve_step")
            try:
                records.append(run_cell(arch, shape_name, multi,
                                        serve_pp=pp, extra_rules=extra))
            except Exception as e:
                traceback.print_exc()
                failures.append({"arch": arch, "shape": shape_name,
                                 "mesh": "multi" if multi else "single",
                                 "error": repr(e)})
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"records": records, "failures": failures}, f,
                          indent=1)
    print(f"\n[dryrun] {len(records)} cells OK, {len(failures)} failed")
    if failures:
        for f_ in failures:
            print("  FAIL:", f_)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
