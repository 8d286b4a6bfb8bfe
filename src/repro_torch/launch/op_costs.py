"""A rank's step counted on fake tensors in a fake world (the counterpart of
``repro/launch/hlo_costs.py`` and ``hlo_utils.py``).

There is no HLO. ``trace`` runs one rank's step (``launch/steps.py``'s
``build_step``, built for ``device="cpu"``) once inside
``torch._subclasses.fake_tensor.FakeTensorMode``, so no tensor is
allocated, in a process whose default group is a fake world
(``torch.distributed`` backend ``"fake"``: every collective returns at
once), and counts what that rank's program does:

* FLOPs, by ``torch.utils.flop_counter.FlopCounterMode``: matrix products
  (``mm``, ``bmm``, ``addmm``, attention) forward and backward, 2 a
  multiply-add. Elementwise work is not counted (the reference's HLO walk
  adds one a elementwise output). The traced route is the CPU one, through
  the kernels' plain versions, so attention counts its full S x S
  products, as the reference's HLO of jnp attention does.
* bytes: the input and output bytes of every aten op but views and bare
  allocations (``empty``; ``prim`` ops such as ``prim.device`` read
  metadata only): an unfused upper bound, as HLO "bytes accessed" is
  before fusion; a fused kernel on the card moves less.
* collectives by kind, from the c10d ops the rank calls (a
  ``TorchDispatchMode`` sees ``c10d.allreduce_``, ``allgather_``,
  ``alltoall_base_``, ``send``): calls, this rank's bytes (its input:
  what it puts on the wire) and the wire bytes a chip by the ring
  formulas of ``hlo_utils._line_collective`` over the group's size P:
  all-reduce 2 N (P-1) / P, all-gather N_out (P-1) / P, all-to-all N
  (P-1) / P, a point-to-point send (``collective-permute``) N. The
  port's ``Sharder.reduce_scatter`` travels as an all_to_all of the
  pieces (summed where they land), so it counts as all-to-all;
  ``Sharder.stats`` still names it.
* memory: the argument bytes (the rank's params, optimizer state, cache
  and batch) and the peak of the bytes held by live storages from the
  arguments to the step's end (each storage counted once however many
  views share it; a storage's bytes leave when its last tensor dies).

``scale`` is the counterpart of the reference's ``trip_hints``: a train
step is traced at 2 and 3 depth units (layers; a hybrid's groups of
``hybrid_period``; the whole depth where it has 3 or fewer: at one unit
the stacked leaves' leading dimension of 1 makes some slices contiguous
that are copied at any other depth) and 1 and 2 microbatches, and every
count is extrapolated bilinearly to the configuration's depth and
microbatch count (exact for counts that are affine in each: a depth
unit's work is the same in every microbatch). The peak is taken from the
2-microbatch traces, linear in depth (the step's state and each
microbatch's per-layer checkpoints and gradients grow with the layers).
``tests/test_torch_dryrun.py`` holds both to a full trace at test size.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import weakref
from typing import Any, Dict, List, Tuple

import torch

# the c10d ops the port's steps call -> (kind, index of their input
# tensors); a receive is counted by its send, any other op raises
_C10D = {
    "allreduce_": ("all-reduce", 0),
    "allgather_": ("all-gather", 1),
    "alltoall_base_": ("all-to-all", 1),
    "send": ("collective-permute", 0),
}
# GPUs of one node (an 8-GPU NVLink island, as an HGX H100 board): a
# group whose ranks share ``rank // NODE_GPUS`` stays on NVLink
NODE_GPUS = 8
FIELDS = ("calls", "bytes", "wire", "wire_network")
_NO_TRAFFIC = ("empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "alias", "lift_fresh")


@dataclasses.dataclass
class StepCosts:
    """One rank's step: ``flops``, ``bytes`` (op inputs and outputs),
    ``collectives`` (kind -> ``calls``, ``bytes``: this rank's input,
    ``wire``: bytes a chip by the ring formulas, ``wire_network``: the
    part over groups that span nodes), ``arg_bytes``,
    ``peak_bytes``, the trace's ``seconds`` and its ``log`` of
    collective calls in order."""

    flops: float
    bytes: float
    collectives: Dict[str, Dict[str, float]]
    arg_bytes: float
    peak_bytes: float
    seconds: float = 0.0
    log: List[Tuple[str, int, int]] = dataclasses.field(
        default_factory=list)   # a trace's calls: (kind, bytes, ranks)


def linear(pairs: List[Tuple[float, StepCosts]]) -> StepCosts:
    """The sum of ``w * costs`` over ``pairs``, count by count (the
    arguments and the peak too; the seconds added)."""
    def lin(get):
        return sum(w * get(c) for w, c in pairs)
    kinds = sorted({k for _, c in pairs for k in c.collectives})
    coll = {k: {f: lin(lambda c: c.collectives.get(k, {}).get(f, 0.0))
                for f in FIELDS} for k in kinds}
    return StepCosts(lin(lambda c: c.flops), lin(lambda c: c.bytes), coll,
                     lin(lambda c: c.arg_bytes), lin(lambda c: c.peak_bytes),
                     sum(c.seconds for _, c in pairs))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _group_ranks(name: str, args) -> List[int]:
    """The global ranks a c10d op runs over: its process group's; a
    send's, this rank and its peer."""
    import torch.distributed as dist
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                pg = dist.ProcessGroup.unbox(a)
            except RuntimeError:        # the op's ReduceOp
                continue
            if name == "send":
                return [dist.get_rank(), dist.get_global_rank(pg, args[2])]
            return dist.get_process_group_ranks(pg)
    raise ValueError("a c10d op without a process group")


def _wire(kind: str, n_in: float, p: int) -> float:
    """Bytes a chip sends for one call of ``kind`` whose input on this
    rank is ``n_in`` bytes, over ``p`` ranks (``hlo_utils``'s ring
    formulas, written for the input; a send: its bytes)."""
    if kind == "collective-permute":
        return n_in
    if p <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * n_in * (p - 1) / p
    if kind == "all-gather":
        return n_in * (p - 1)           # N_out (P-1) / P, N_out = P n_in
    return n_in * (p - 1) / p           # all-to-all


class _Counter:
    """The dispatch mode's state: op bytes, collectives and live
    storages."""

    def __init__(self):
        self.bytes = 0.0
        self.coll: Dict[str, Dict[str, float]] = {}
        self.log: List[Tuple[str, int, int]] = []
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, weakref.ref] = {}

    def hold(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as alive until it is freed."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen and self._seen[key]() is st:
            return
        n = st.nbytes()

        def freed(_ref, key=key, n=n):
            if self._seen.get(key) is _ref:
                del self._seen[key]
                self.live -= n
        self._seen[key] = weakref.ref(st, freed)
        self.live += n
        self.peak = max(self.peak, self.live)

    def collective(self, name: str, args) -> None:
        kind, i_in = _C10D[name]
        n_in = sum(_nbytes(t) for t in _tensors(args[i_in]))
        ranks = _group_ranks(name, args)
        rec = self.coll.setdefault(kind, dict.fromkeys(FIELDS, 0.0))
        wire = _wire(kind, n_in, len(ranks))
        rec["calls"] += 1
        rec["bytes"] += n_in
        rec["wire"] += wire
        self.log.append((kind, n_in, len(ranks)))
        if len({r // NODE_GPUS for r in ranks}) > 1:
            rec["wire_network"] += wire


def _mode(counter: _Counter):
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountOps(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = func._opname
            if func.namespace == "c10d":
                if name in _C10D:
                    counter.collective(name, args)
                elif name != "recv_":
                    raise ValueError(f"op_costs: an uncounted collective "
                                     f"{func}")
                return out
            outs = _tensors(out)
            for t in outs:
                counter.hold(t)
            if (func.namespace == "aten" and not func.is_view
                    and name not in _NO_TRAFFIC):
                counter.bytes += sum(_nbytes(t) for t in
                                     _tensors(args) + _tensors(kwargs)
                                     + outs)
            return out
    return CountOps()


def fake_args(built: Any, step: str) -> Tuple[Any, ...]:
    """The step's arguments as this rank holds them, made of fresh
    (fake, under the caller's mode) tensors: its params (and optimizer
    state) at their local shapes, a train batch or prefill inputs at the
    global shapes every rank is given, a serve step's local cache and the
    whole batch's tokens."""
    from repro_torch.train.optimizer import AdamWState
    from repro_torch.train.train_step import TrainState
    model = built.model
    dt = model.dtype
    qdt = built.meta.get("weight_dtype")

    def tree(shapes, dtype, quant=None):
        if isinstance(shapes, dict):
            return {k: tree(v, dtype, quant) for k, v in shapes.items()}
        d = quant if quant is not None and len(shapes) >= 2 else dtype
        return torch.zeros(shapes, dtype=d)

    def inputs(specs):
        return {k: torch.zeros(s.shape, dtype=s.dtype)
                for k, s in specs.items()}
    local = built.in_shardings[0]
    if step == "train_step":
        return (TrainState(tree(local, dt),
                           AdamWState(0, tree(local, torch.float32),
                                      tree(local, torch.float32))),
                inputs(built.args_shapes[1]))
    if step == "prefill_step":
        return tree(local, dt), inputs(built.args_shapes[1])
    cache_dt = {k: s.dtype for k, s in built.args_shapes[1].items()}
    cache = {k: torch.zeros(shape, dtype=cache_dt[k])
             for k, shape in built.in_shardings[1].items()}
    if "pos" in cache and cache["pos"].ndim == 0:
        cache["pos"] = torch.zeros((), dtype=torch.int32)
    return (tree(local, dt, qdt), cache,
            torch.zeros(built.args_shapes[2].shape, dtype=torch.int32))


def trace(built: Any, step: str, fake: bool = True) -> StepCosts:
    """One run of ``built.fn`` on ``fake_args`` inside ``FakeTensorMode``,
    counted (module docstring). Call it in a process whose default group
    is a fake world of the mesh's size (``dryrun`` does): nothing is sent.
    ``fake=False`` runs the step on real zero tensors in the world it was
    built in (a gloo world of ``run_ranks``: ``rank_costs``), counted the
    same way."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    counter = _Counter()
    t0 = time.perf_counter()
    # index vectors built with the step (a rank's KV-head selection, its
    # slices) are real tensors; the mode takes them as constants
    mode = (FakeTensorMode(allow_non_fake_inputs=True) if fake
            else contextlib.nullcontext())
    with mode:
        args = fake_args(built, step)
        held = _tensors(args)
        for t in held:
            counter.hold(t)
        arg_bytes = counter.live
        flops = FlopCounterMode(display=False)
        with flops, _mode(counter):
            out = built.fn(*args)
        del out, args, held
    return StepCosts(float(flops.get_total_flops()), counter.bytes,
                     counter.coll, float(arg_bytes), float(counter.peak),
                     time.perf_counter() - t0, counter.log)


def rank_costs(mesh: Any, device: Any, cases: List[Tuple[Any, Any, Dict]]
               ) -> List[StepCosts]:
    """``launch.mesh.run_ranks``' side: for each ``(cfg, shape,
    build_step keywords)`` this rank's step built on ``mesh`` and run once
    on real zero tensors (``trace(fake=False)``)."""
    from repro_torch.launch.steps import build_step
    out = []
    for cfg, shape, kw in cases:
        built = build_step(cfg, shape, mesh, device=device, **kw)
        out.append(trace(built, shape.step, fake=False))
    return out


def _line(points: Tuple[int, ...], x: int) -> Dict[int, float]:
    """Weights of the values at ``points`` (one or two) that give a line's
    value at ``x``."""
    if len(points) == 1:
        return {points[0]: 1.0}
    p, q = points
    return {p: (q - x) / (q - p), q: (x - p) / (q - p)}


def scale(costs: Dict[Tuple[int, int], StepCosts], depth: int,
          micro: int) -> StepCosts:
    """``costs`` traced at (depth units, microbatches) for one or two
    depths and microbatches 1 and 2, extrapolated to ``depth`` units and
    ``micro`` microbatches: every count bilinearly (``a + b d + c k + e d
    k``), the arguments and the peak linearly in depth at ``micro``'s
    number of microbatches, two for two or more (the steady state: the
    accumulated gradient beside a microbatch)."""
    depths = tuple(sorted({d for d, _ in costs}))
    wd = _line(depths, depth)
    wk = _line((1, 2), micro)
    out = linear([(wd[d] * wk[k], costs[(d, k)]) for d in wd for k in wk])
    kk = min(micro, 2)
    mem = linear([(wd[d], costs[(d, kk)]) for d in wd])
    out.arg_bytes, out.peak_bytes = mem.arg_bytes, mem.peak_bytes
    out.seconds = sum(c.seconds for c in costs.values())
    return out


def collectives_record(coll: Dict[str, Dict[str, float]]) -> Dict[str, Any]:
    """``hlo_utils.collective_bytes``' record of the counts: wire bytes a
    chip by kind and ``total``, ``raw_output_bytes`` (here this rank's
    input bytes), ``counts``, plus ``rank_bytes`` by kind."""
    out: Dict[str, Any] = {k: v["wire"] for k, v in coll.items()}
    out["total"] = float(sum(v["wire"] for v in coll.values()))
    out["raw_output_bytes"] = float(sum(v["bytes"] for v in coll.values()))
    out["counts"] = {k: v["calls"] for k, v in coll.items()}
    out["rank_bytes"] = {k: v["bytes"] for k, v in coll.items()}
    out["network"] = float(sum(v["wire_network"] for v in coll.values()))
    return out
