"""The rank's training step over a mesh: FSDP over ``data``, tensor
parallelism over ``model`` (port of ``repro/launch/steps.py``'s
``build_step`` for a ``train_step`` shape, with
``repro/train/train_step.py``).

``build_step(cfg, shape, mesh)`` gives a train shape's step here
(``build_train_step``): ``fn(state, batch) -> (state, metrics)`` is THIS
rank's part of the reference's sharded step, the same function to fp32
rounding.

Layout. The rules are ``build_rules(train=True)`` (``TRAIN_RULES``, or
``TRAIN_RULES_MULTIPOD`` on a mesh with ``pod``) with ``extra_rules`` on
top. A rank holds its shard of ``params``, ``m`` and ``v``: the
tensor-parallel slice the serving steps run (the model's
``_local_leaf`` under the rules with ``embed`` replicated, the
reference's ``gathered_rules``: heads in whole heads, the KV heads a
rank's queries read, the Mamba2 mixer by SSD head, vocab, ffn and
expert_ffn split over ``model``), cut further over ``data`` along its
``embed`` dimension wherever ``resolve`` splits that dimension under the
train rules (FSDP). ``step`` is a Python int on every rank.

A step. Every rank gets the whole global batch. It is split into
microbatches as the reference's ``split_micro`` splits it, and the rank
takes its rows of each over the ``batch`` rule (``data``, or ``(pod,
data)``). The FSDP-split leaves are gathered over ``data`` into the
tensor-parallel layout (``all_gather``; once a step with
``gather_weights_once``, else once a microbatch: the same numbers), and
forward and backward run there, each layer rematerialised. The rank's
objective is its share of the microbatch's loss (``LM.loss_shard``: its
rows' NLL over the microbatch's global mask count, its share of the MoE
loss), so the shares' gradients summed over the batch axes are the
microbatch's gradient. The model's collectives carry their own backward
(``Sharder.reduce`` / ``Sharder.enter``); after the backward a leaf that
ranks of ``model`` hold in copies whose gradients are partial is summed
over them (the KV heads that several ranks' queries read, the MoE
router, the Mamba2 mixer's B / C columns).

Under a ``seq`` rule that cuts a microbatch's positions over ``model``
(``LM._seq_axes``, as in the prefill) the residual stream holds the
rank's slice of the positions: each block gathers the sequence
(``Sharder.all_gather``, backward a reduce-scatter), its row-parallel
products reduce-scatter their partials (backward an all_gather), the
vocab-parallel logits come back by one all_to_all, and the rank's
objective is its slice's NLL. A leaf whole on every rank of ``model``
then has a partial gradient (the embedding, the norms, the biases added
after a sum, the final norm and a head whose vocab is not split) and is
summed over the cut's axes like the router; the loss is summed over
them too. Each gradient is then summed
over the batch axes in fp32, the rank keeps its FSDP slice (the
reduce-scatter, as an ``all_reduce`` and a slice: gloo reduces every
dtype and layout that way), and only then, with
``compress_grads_bf16``, is it rounded to bf16, as the reference rounds
the global gradient (without the rounding the sums over the ranks
commute with the sum over the microbatches and run once a step). The
fp32 sum of the microbatches' gradients over their count feeds
``adamw_update``, whose clip takes the global norm summed with each
element counted once over the ranks (copies on other ranks of ``pod``,
``data`` or ``model`` are not counted again). The ``loss`` and
``grad_norm`` metrics are equal on every rank.

``TrainBuiltStep.init_state(seed)`` draws the rank's shard of
``init_train_state(model.init(seed))`` with the unsplit init's numbers,
one full leaf alive at a time; ``shard_state(full)`` cuts a full state
(a one-process state, or the reference's through
``models/convert.train_state_from_jax``); ``gather_state(local)`` puts
the full state back together (every rank, or only ``dst``);
``state_shardings()`` is the per-leaf counterpart of the reference's
``NamedSharding`` tree that ``train/checkpoint.restore_checkpoint``
takes.

``rank_start`` builds a rank's step and its starting state (a given full
state, a checkpoint or the seeded init, optionally on a resized mesh);
``train_run`` / ``train_cases`` run steps from it for
``launch.mesh.run_ranks``, optionally into a checkpoint.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.api import build_model, input_specs
from repro_torch.models.common import ParamDef, init_params
from repro_torch.models.transformer import kv_select
from repro_torch.sharding import rules as R
from repro_torch.train.optimizer import (AdamWConfig, AdamWState,
                                         adamw_update, tree_map)
from repro_torch.train.train_step import (TrainState, choose_microbatches,
                                          split_microbatches)

Path = Tuple[str, ...]


@dataclasses.dataclass
class _Leaf:
    """How one parameter (and its moments) is laid out and reduced."""

    d: ParamDef
    index: List[torch.Tensor]       # global indices of the rank's shard
    fsdp: Optional[Tuple[int, R.Axes, int, int]]  # dim, axes, lo, hi
    kv: Optional[Tuple[int, torch.Tensor]]   # dim, its global indices
    part: Optional[Tuple[int, int, int]]     # dim, [lo, hi) summed
    whole: bool                     # the whole gradient summed over model
    sum_axes: R.Axes                # the model axes of kv / part / whole
    owned: Any                      # norm weight: 1.0, 0.0 or a mask


def _schema_walk(schema: Dict, path: Path = ()):
    """(path, ParamDef) pairs of a schema."""
    for k, v in schema.items():
        if isinstance(v, ParamDef):
            yield path + (k,), v
        else:
            yield from _schema_walk(v, path + (k,))


def leaf_at(tree, path: Path):
    """The leaf of nested dicts ``tree`` at ``path``."""
    for k in path:
        tree = tree[k]
    return tree


def _map_paths(tree, fn, path: Path = ()):
    """``tree`` (nested dicts, in its own key order) with each leaf
    replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map_paths(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def leaf_paths(tree, path: Path = ()) -> List[Path]:
    """The paths of the leaves of nested dicts ``tree``, in its key
    order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in leaf_paths(v, path + (k,))]
    return [path]


class StateLayout:
    """Every parameter's ``_Leaf`` on this rank, from the tensor-parallel
    ``model`` (its sharder under the rules with ``embed`` replicated) and
    the train ``rules``; ``seq``: the axes the ``seq`` rule cuts a
    microbatch's positions over (None: whole)."""

    def __init__(self, model, rules: Dict, mesh: Any, seq: R.Axes = None):
        self.model = model
        self.mesh = mesh
        self.seq = seq
        self.full = R.Sharder(mesh=mesh, rules=rules)
        self.leaves: Dict[Path, _Leaf] = {
            path: self._leaf(path, d)
            for path, d in _schema_walk(model._schema)}

    def _fsdp(self, d: ParamDef, tp: List[torch.Tensor]):
        """(dim, axes, lo, hi): the tensor-parallel leaf's ``embed``
        dimension cut over the axes the train rules split it over."""
        spec = self.full.spec(d.names, d.shape)
        for i, (n, e) in enumerate(zip(d.names, spec)):
            if n == "embed" and self.full.size(e) > 1:
                if len(tp[i]) != d.shape[i]:
                    raise NotImplementedError(
                        f"{d.names}: the embed dimension is split by the "
                        f"tensor-parallel layout too")
                size = self.full.size(e)
                lo = self.full.index(e) * (d.shape[i] // size)
                return i, e, lo, lo + d.shape[i] // size
        return None

    def _leaf(self, path: Path, d: ParamDef) -> _Leaf:
        m = self.model
        tp = m.local_index(d)
        tp_spec = m.sharder.spec(d.names, d.shape)
        if any(a != "model" for e in tp_spec for a in R.as_axes(e)):
            raise NotImplementedError(
                f"{'/'.join(path)}: the tensor-parallel layout {tp_spec} "
                f"uses an axis other than model")
        fsdp = self._fsdp(d, tp)
        index = list(tp)
        if fsdp is not None:
            i, _, lo, hi = fsdp
            index[i] = tp[i][lo:hi]
        kv = part = None
        whole = False
        sum_axes = None
        masks: Dict[int, torch.Tensor] = {}
        split_model = any(len(t) != n for t, n in zip(tp, d.shape))
        c = m.cfg
        if m._kv_sel is not None and "kv_heads" in d.names:
            ax = d.names.index("kv_heads")
            kv, sum_axes, split_model = (ax, tp[ax]), m._heads_ax, True
            masks[ax] = self._kv_owned(c.hd)
        mixer = m._mixer
        ax = next((i for i, n in enumerate(d.names)
                   if n in ("ssm_inner", "ssm_heads")), None)
        if mixer is not None and not mixer.whole and ax is not None:
            split_model = True
            bc = mixer.shared(d.names[ax], d.shape[ax])
            if bc is not None:              # B and C whole on every rank
                inside = (tp[ax] >= bc[0]) & (tp[ax] < bc[1])
                lo = int(inside.nonzero()[0])
                hi = lo + bc[1] - bc[0]
                part, sum_axes = (ax, lo, hi), m._ssm_ax
                mask = torch.ones(len(tp[ax]))
                if m.sharder.index(m._ssm_ax):
                    mask[lo:hi] = 0.0
                masks[ax] = mask
        if path[-2:] == ("moe", "router") and m._ffn_ax is not None:
            whole, sum_axes = True, m._ffn_ax
        # under the seq cut a leaf whole on every rank of its axes sees
        # only the rank's part of the work (its slice of the positions, or
        # its columns' partial gradient through a gathered input)
        if self.seq is not None and not (split_model or whole):
            whole, sum_axes = True, self.seq
        # the norm counts each element on one rank: its first holder
        owned = 1.0
        split = set()
        if split_model:
            split.add("model")
        if fsdp is not None:
            split.update(R.as_axes(fsdp[1]))
        for a in self.mesh.shape:
            if a not in split and self.mesh.coords[a]:
                owned = 0.0
        if owned and masks:
            owned = torch.ones(())
            for i, mk in masks.items():
                shape = [1] * len(d.shape)
                shape[i] = -1
                owned = owned * mk.reshape(shape)
        return _Leaf(d, index, fsdp, kv, part, whole, sum_axes, owned)

    def _kv_owned(self, hd: int) -> torch.Tensor:
        """Over this rank's KV columns: 1 where it is the first holder of
        the KV head (lowest model index, first local position)."""
        m, c = self.model, self.model.cfg
        me = m.sharder.index(m._heads_ax)
        seen = set()
        for r in range(me):
            seen.update(kv_select(c.n_heads, c.n_kv_heads, m.n_heads_local,
                                  r * m.n_heads_local))
        mask = []
        for h in m._kv_sel:
            mask.append(0.0 if h in seen else 1.0)
            seen.add(h)
        return torch.tensor(mask).repeat_interleave(hd)

    # -- cutting and gathering ---------------------------------------------
    def local(self, path: Path, full: torch.Tensor) -> torch.Tensor:
        """The rank's shard of one full leaf (a copy)."""
        leaf = self.leaves[path]
        t = self.model._local_leaf(leaf.d, full)
        if leaf.fsdp is not None:
            i, _, lo, hi = leaf.fsdp
            t = t.narrow(i, lo, hi - lo)
        return t.clone(memory_format=torch.contiguous_format)

    def gathered(self, path: Path, t: torch.Tensor, comm: Dict
                 ) -> torch.Tensor:
        """The tensor-parallel leaf from the rank's FSDP shard ``t``."""
        leaf = self.leaves[path]
        if leaf.fsdp is None:
            return t
        import torch.distributed as dist
        i, axes, _, _ = leaf.fsdp
        parts = [torch.empty_like(t) for _ in range(self.full.size(axes))]
        dist.all_gather(parts, t.contiguous(),
                        group=self.mesh.group(R.as_axes(axes)))
        comm["gather_calls"] += 1
        comm["gather_bytes"] += t.numel() * t.element_size() * len(parts)
        return torch.cat(parts, i)


def _sum(t: torch.Tensor, mesh: Any, axes: R.Axes, comm: Dict
         ) -> torch.Tensor:
    """``t`` summed in place over the ranks of ``axes``, counted."""
    import torch.distributed as dist
    dist.all_reduce(t, group=mesh.group(R.as_axes(axes)))
    comm["grad_calls"] += 1
    comm["grad_bytes"] += t.numel() * t.element_size()
    return t


def _ix(index: List[torch.Tensor]):
    """``index`` as a key of ``full[...]``: slices where every vector is
    a contiguous range, else the vectors broadcast against each other."""
    def lo(v):
        return int(v[0]) if len(v) else 0
    if all(torch.equal(v, torch.arange(lo(v), lo(v) + len(v)))
           for v in index):
        return tuple(slice(lo(v), lo(v) + len(v)) for v in index)
    nd = len(index)
    return tuple(v.reshape([-1 if j == i else 1 for j in range(nd)])
                 for i, v in enumerate(index))


@dataclasses.dataclass
class TrainBuiltStep:
    """A rank's train step (``build_train_step``): ``fn(state, batch)``,
    the global shapes of its arguments, this rank's local shapes, and
    ``meta`` (``n_microbatches``, ``rules``, ``model``, ``sharder``,
    ``mesh``, ``layout``, ``rows`` of a microbatch, ``comm``: the step's
    own collectives, FSDP gathers and gradient sums, calls and bytes)."""

    fn: Callable
    args_shapes: Tuple[Any, ...]
    in_shardings: Tuple[Any, ...]
    meta: Dict[str, Any]

    @property
    def model(self):
        return self.meta["model"]

    @property
    def layout(self) -> StateLayout:
        return self.meta["layout"]

    def init_state(self, seed: int = 0) -> TrainState:
        """This rank's shard of ``init_train_state(model.init(seed))``,
        drawn leaf by leaf with the unsplit init's numbers."""
        model, lay = self.model, self.layout
        gen = torch.Generator(device=model.device).manual_seed(seed)
        by_def = {id(leaf.d): path for path, leaf in lay.leaves.items()}
        params = init_params(model._schema, gen, model.dtype, model.device,
                             local=lambda d, full: lay.local(
                                 by_def[id(d)], full))

        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return TrainState(params, AdamWState(0, tree_map(zeros, params),
                                             tree_map(zeros, params)))

    def shard_state(self, full: TrainState) -> TrainState:
        """This rank's shard of a full state (tensors on any device; each
        shard lands on the model's device in its dtype)."""
        dev = self.model.device

        def cut(tree):
            return _map_paths(tree, lambda p, t: self.layout.local(
                p, t).to(dev))
        return TrainState(cut(full.params),
                          AdamWState(int(full.opt.step), cut(full.opt.m),
                                     cut(full.opt.v)))

    def state_shardings(self) -> TrainState:
        """A tree shaped like the state whose leaves map a full tensor
        (on the host) to this rank's shard on its device: the
        ``shardings`` of ``restore_checkpoint``. ``step`` maps to
        itself."""
        dev = self.model.device

        def one(path):
            return lambda full: self.layout.local(path, full).to(dev)
        tree = _map_paths(self.model.param_shapes(), lambda p, _: one(p))
        return TrainState(tree, AdamWState(None, tree, tree))

    def gather_state(self, local: TrainState, dst: Optional[int] = None
                     ) -> Optional[TrainState]:
        """The full state from every rank's shard (a collective: every
        rank calls it), on the host, in the key order of ``local``: on
        every rank, or with ``dst`` only on that global rank (None
        elsewhere)."""
        import torch.distributed as dist
        world, me = dist.get_world_size(), dist.get_rank()
        lay = self.layout
        # every rank's global indices, once
        mine = {p: lay.leaves[p].index for p in leaf_paths(local.params)}
        if dst is None:
            idx: List[Any] = [None] * world
            dist.all_gather_object(idx, mine)
        else:
            idx = [None] * world if me == dst else None
            dist.gather_object(mine, idx, dst=dst)
        keep = dst is None or me == dst

        def one(path, t):
            t = t.detach().cpu().contiguous()
            parts = [torch.empty_like(t) for _ in range(world)]
            if dst is None:
                dist.all_gather(parts, t)
            else:
                dist.gather(t, parts if me == dst else None, dst=dst)
            if not keep:
                return None
            full = torch.empty(lay.leaves[path].d.shape, dtype=t.dtype)
            # lower ranks last: where copies meet, the first holder's
            for r in reversed(range(world)):
                full[_ix(idx[r][path])] = parts[r]
            return full

        params = _map_paths(local.params, one)
        m = _map_paths(local.opt.m, one)
        v = _map_paths(local.opt.v, one)
        if not keep:
            return None
        return TrainState(params, AdamWState(int(local.opt.step), m, v))


def build_train_step(cfg: ArchConfig, shape: ShapeSpec, mesh: Any,
                     rules: Dict, n_microbatches: Optional[int] = None,
                     gather_weights_once: bool = False,
                     remat_policy: Optional[str] = None,
                     opt_cfg: Optional[AdamWConfig] = None,
                     device: DeviceLike = None) -> TrainBuiltStep:
    """This rank's step of ``(cfg, shape)`` on ``mesh`` under the train
    ``rules`` (module docstring); ``opt_cfg`` defaults to the reference's
    ``AdamWConfig()``."""
    from repro_torch.launch.steps import _row_inputs, n_chips
    opt_cfg = opt_cfg or AdamWConfig()
    nm = n_microbatches or choose_microbatches(
        shape.global_batch, shape.seq_len, cfg.padded_vocab, n_chips(mesh))
    if shape.global_batch % nm:
        raise ValueError(f"global batch {shape.global_batch} is not a "
                         f"multiple of {nm} microbatches")
    mb = shape.global_batch // nm
    full = R.Sharder(mesh=mesh, rules=rules)
    lo, hi = full.local_range(("batch",), (mb,), 0)
    rows = slice(lo, hi)
    bspec = full.spec(("batch",), (mb,))[0]
    batch_axes = bspec if full.size(bspec) > 1 else None
    dev = resolve_device(device)
    sharder = R.Sharder(mesh=mesh, rules=dict(rules, embed=None))
    model = build_model(cfg, device=dev, sharder=sharder,
                        batch_axes=batch_axes, remat=True,
                        remat_policy=None if cfg.is_encdec else remat_policy)
    seq = model._seq_axes(hi - lo, shape.seq_len)
    layout = StateLayout(model, rules, mesh, seq)
    comm = {"gather_calls": 0, "gather_bytes": 0, "grad_calls": 0,
            "grad_bytes": 0}

    def gather(params: Dict) -> Dict:
        return _map_paths(params, lambda p, t: layout.gathered(p, t, comm))

    def fix(path: Path, g: torch.Tensor) -> torch.Tensor:
        """A tensor-parallel gradient as a fresh fp32 tensor, summed where
        copies on ranks of ``model`` hold partial ones, then over the
        batch axes, then cut to the rank's FSDP shard."""
        leaf = layout.leaves[path]
        g = g.to(torch.float32, copy=True)
        if leaf.kv is not None:
            ax, sel = leaf.kv
            sel = sel.to(g.device)
            shape = list(g.shape)
            shape[ax] = leaf.d.shape[ax]
            tot = g.new_zeros(shape).index_add_(ax, sel, g)
            g = _sum(tot, mesh, leaf.sum_axes, comm).index_select(ax, sel)
        elif leaf.part is not None:
            ax, plo, phi = leaf.part
            piece = g.narrow(ax, plo, phi - plo).contiguous()
            g.narrow(ax, plo, phi - plo).copy_(
                _sum(piece, mesh, leaf.sum_axes, comm))
        elif leaf.whole:
            g = _sum(g, mesh, leaf.sum_axes, comm)
        if batch_axes is not None:
            g = _sum(g, mesh, batch_axes, comm)
        if leaf.fsdp is not None:
            i, _, flo, fhi = leaf.fsdp
            g = g.narrow(i, flo, fhi - flo).contiguous()
        return g

    def norm(order: List[Path], grads: List[torch.Tensor]) -> torch.Tensor:
        """The global norm of the gradient, each element once."""
        import torch.distributed as dist
        sq = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        for path, g in zip(order, grads):
            owned = layout.leaves[path].owned
            if isinstance(owned, float):
                if owned:
                    sq = sq + torch.sum(torch.square(g))
            else:
                sq = sq + torch.sum(torch.square(g) * owned.to(g.device))
        dist.all_reduce(sq)
        comm["grad_calls"] += 1
        comm["grad_bytes"] += sq.element_size()
        return torch.sqrt(sq)

    # the bf16 round applies to each microbatch's global gradient, so each
    # is summed over the ranks as it comes; without it the sums over the
    # ranks and over the microbatches commute, and the ranks' sums run
    # once a step on the accumulated tensor-parallel gradient
    compress = opt_cfg.compress_grads_bf16

    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        order = leaf_paths(state.params)
        gsum: List[Optional[torch.Tensor]] = [None] * len(order)
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        tp = gather(state.params) if gather_weights_once else None
        for micro in split_microbatches(batch, nm):
            params = tp if tp is not None else gather(state.params)
            alias = _map_paths(params,
                               lambda p, t: t.detach().requires_grad_(True))
            # the reference's denominator: the microbatch's mask sum (its
            # token count without a mask), the same on every rank
            tokens = micro["targets"].numel()
            count = (torch.clamp(micro["mask"].sum(), min=1.0)
                     if "mask" in micro else float(tokens))
            obj, value = model.loss_shard(alias, _row_inputs(micro, rows),
                                          count, tokens)
            grads = list(torch.autograd.grad(
                obj, [leaf_at(alias, p) for p in order]))
            del alias, params, obj
            with torch.no_grad():
                for i, path in enumerate(order):
                    g, grads[i] = grads[i], None
                    if compress:
                        g = fix(path, g).to(torch.bfloat16).float()
                    else:
                        g = g.to(torch.float32, copy=gsum[i] is None)
                    if gsum[i] is None:
                        gsum[i] = g
                    else:
                        gsum[i].add_(g)
                lsum += value
        del tp
        with torch.no_grad():
            if not compress:
                gsum = [fix(p, g) for p, g in zip(order, gsum)]
            for s in gsum:
                s.div_(nm)
            for axes in (batch_axes, seq):
                if axes is not None:
                    _sum(lsum, mesh, axes, comm)
            gnorm = norm(order, gsum)
            it = iter(gsum)
            grads = _map_paths(state.params, lambda p, t: next(it))
            params, opt = adamw_update(opt_cfg, grads, state.opt,
                                       state.params, gnorm=gnorm)
        return TrainState(params, opt), {"loss": lsum / nm,
                                         "grad_norm": gnorm}

    specs = input_specs(cfg, shape)
    local_shapes = _map_paths(
        model.param_shapes(), lambda p, _: tuple(len(i) for i in
                                                 layout.leaves[p].index))
    return TrainBuiltStep(
        fn=train_step,
        args_shapes=(model.param_shapes(), specs),
        in_shardings=(local_shapes, {k: v.shape for k, v in specs.items()}),
        meta={"n_microbatches": nm, "rules": rules, "model": model,
              "sharder": sharder, "mesh": mesh, "layout": layout,
              "rows": rows, "batch_axes": batch_axes, "comm": comm})




# ---------------------------------------------------------------------------
# rank-side runners
# ---------------------------------------------------------------------------
def rank_start(mesh: Any, device: torch.device, cfg: ArchConfig,
               seq_len: int, global_batch: int,
               state: Optional[TrainState] = None, seed: int = 0,
               step_kw: Optional[Dict] = None,
               restore: Optional[Tuple[str, int]] = None,
               elastic: Optional[Tuple[Any, int, int]] = None
               ) -> Tuple[TrainBuiltStep, TrainState]:
    """This rank's train step of ``build_step`` (``step_kw`` its keywords)
    at ``global_batch`` and ``seq_len``, and its starting state: the
    rank's shard of the full ``state`` (``shard_state``), of the
    checkpoint ``restore = (dir, step)`` (``restore_checkpoint`` with
    ``state_shardings``), or ``init_state(seed)``. ``elastic = (old
    ElasticState, new device count, model axis)``: on
    ``train.elastic.resize_mesh``'s mesh instead of ``mesh``."""
    from repro_torch.launch.steps import build_step
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import elastic as el
    if elastic is not None:
        mesh = el.resize_mesh(*elastic).mesh
    shape = ShapeSpec("train", seq_len, global_batch, "train_step")
    built = build_step(cfg, shape, mesh, device=device, **(step_kw or {}))
    if restore is not None:
        local = ckpt.restore_checkpoint(restore[0], restore[1],
                                        built.init_state(seed),
                                        shardings=built.state_shardings())
    elif state is not None:
        local = built.shard_state(state)
    else:
        local = built.init_state(seed)
    return built, local


def train_run(mesh: Any, device: torch.device, cfg: ArchConfig,
              seq_len: int, batches: List[Dict],
              ckpt_dir: Optional[str] = None, dst: int = 0,
              **start: Any) -> Dict[str, Any]:
    """One rank's train steps for ``launch.mesh.run_ranks``: from
    ``rank_start`` (``start``: its keywords) at the batches' global
    batch, a step on each of ``batches`` (numpy); with ``ckpt_dir`` a
    checkpoint of the result from the mesh. Returns the ``loss`` and
    ``grad_norm`` of each step, ``n_microbatches``, the step's ``comm``
    and the model sharder's ``stats``, the full state on rank ``dst``
    (None elsewhere), the residual stream's local shape in the last
    forward (``residual``: the rank's slice of the positions under the
    ``seq`` rule), the layout's ``seq`` axes, and every warning raised
    while it ran (``warnings``)."""
    import warnings

    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.data import to_torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        built, local = rank_start(mesh, device, cfg, seq_len,
                                  len(batches[0]["targets"]), **start)
        metrics = []
        for b in batches:
            local, m = built.fn(local, to_torch(b, device))
            metrics.append({k: v.item() for k, v in m.items()})
        if ckpt_dir is not None:
            ckpt.save_checkpoint(ckpt_dir, local.opt.step, local,
                                 gather=lambda t: built.gather_state(
                                     t, dst=0))
        full = built.gather_state(local, dst=dst)
    return {"metrics": metrics, "state": full,
            "n_microbatches": built.meta["n_microbatches"],
            "comm": dict(built.meta["comm"]),
            "stats": dict(built.meta["sharder"].stats),
            "residual": built.model.residual_shape,
            "seq": built.layout.seq,
            "warnings": [str(w.message) for w in caught]}


def train_cases(mesh: Any, device: torch.device, cases: List[Dict]
                ) -> List[Dict[str, Any]]:
    """``train_run`` for each keyword dict of ``cases`` in one world."""
    return [train_run(mesh, device, **case) for case in cases]
