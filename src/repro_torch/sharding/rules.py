"""Divisibility-aware logical-axis sharding (port of
``repro/sharding/rules.py``).

Model code names each tensor dimension with a *logical* axis; a rule table
maps logical names to mesh axes per execution mode. ``resolve`` drops a
mesh axis whenever the dimension is not divisible by the mesh-axis size
(14 query heads on a 4-way model axis, 2 KV heads, odd vocabularies), so
such a dimension is replicated instead of refused. The tables and
``resolve`` are the reference's, and ``resolve`` returns a plain tuple
equal element by element to the reference's ``PartitionSpec``.

Where the reference hands the spec to GSPMD, which inserts the collectives,
here a ``Sharder`` on a ``launch.mesh.Mesh`` gives each rank its slice of
a full tensor (``shard_leaf``, ``tree_shard``: the counterpart of
``in_shardings`` plus ``device_put``) and sums partial results over the
ranks of a set of mesh axes (``reduce``: ``all_reduce`` SUM). The model
code calls ``reduce`` where the reference's GSPMD would insert an
all-reduce; there is no counterpart of ``constrain``. For a KV cache cut
by sequence (the ``cache_seq`` rule) the serving code also gathers
(``all_gather``) and exchanges (``all_to_all``) over a set of mesh axes,
and for a prefill whose activations are cut by sequence (the ``seq``
rule) it gathers them before each column-parallel product and sums each
row-parallel product's partials into the rank's slice
(``reduce_scatter``).
``Sharder()`` with no mesh is the identity, as in the reference.

Under autograd every collective carries the backward its use implies
(a bare ``dist.all_reduce`` has no autograd rule, and a backward through
it silently runs as the identity): ``reduce`` passes the gradient through
unchanged (every rank then computes the same thing: Megatron's "g"), or,
with ``grad="sum"``, sums it over the same ranks (ranks go on differently
from the sum, as the Mamba2 gated norm's sums of squares); ``enter`` is
the identity forward and sums the gradient over the axes (a replicated
activation entering a product whose weight is split: Megatron's "f").
Under the ``seq`` rule in training, ``all_gather``'s backward is a
reduce-scatter of the gradient, ``reduce_scatter``'s an all_gather of it,
and ``all_to_all``'s the exchange back (the vocab-parallel logits of a
rank's slice of the positions); each backward collective is counted in
``stats`` as the forward one is.
Without autograd recording, ``reduce`` is the in-place ``all_reduce`` and
``enter`` returns its input. ``leaf_index`` gives the global indices,
dimension by dimension, of the part of a tensor ``shard_leaf`` keeps.

The Mamba2 mixer's fused leaves are split by SSD head (``MixerSplit``):
a rank keeps its heads' columns of each segment of ``w_in`` and of the
conv channels, B and C whole, where the reference's ``resolve`` cuts the
flat ``ssm_inner`` dimension across the segments and GSPMD reshards.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

Axes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axes, ...]

# Rule tables. Keys are logical axis names used throughout the models.
INFER_RULES: Dict[str, Axes] = {
    "batch": ("data",),
    "seq": None,
    "cache_seq": None,         # launch code may set ("model",) when KV heads
    #                            do not divide the model axis (seq-parallel KV)
    "embed": None,             # replicated over data in inference
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": None,
    "qkv_flat": ("model",),    # fused q/kv projection output dim
    "ffn": ("model",),
    "vocab": ("model",),
    "experts": None,
    "moe_cap": None,           # expert capacity dim (hillclimb lever)
    "expert_ffn": ("model",),
    "ssm_inner": ("model",),
    "ssm_heads": ("model",),
    "ssm_state": None,
    "conv": None,
    "layers": None,
    "stack": None,
}

# Training: FSDP — shard the replicated-embed dims over data too.
TRAIN_RULES: Dict[str, Axes] = dict(
    INFER_RULES,
    embed=("data",),
    experts=None,
)

# Multi-pod training: gradients all-reduce over ("pod","data"); batch spans
# both. (Serving multi-pod uses the pod axis for PP instead.)
TRAIN_RULES_MULTIPOD: Dict[str, Axes] = dict(
    TRAIN_RULES,
    batch=("pod", "data"),
)

INFER_RULES_MULTIPOD: Dict[str, Axes] = dict(
    INFER_RULES,
    batch=("pod", "data"),
)


def _axis_size(mesh: Any, axes: Axes) -> int:
    n = 1
    for a in as_axes(axes):
        n *= mesh.shape[a]
    return n


def as_axes(entry: Axes) -> Tuple[str, ...]:
    """A spec entry (None, one axis name or a tuple of them) as a tuple."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def resolve(names: Sequence[Optional[str]], shape: Sequence[int],
            rules: Dict[str, Axes], mesh: Any) -> Spec:
    """Logical names -> spec (one entry per dimension: None, an axis name
    or a tuple of them), dropping non-divisible axes and never using a
    mesh axis twice. ``mesh`` needs only ``.shape`` (axis -> size)."""
    assert len(names) == len(shape), (names, shape)
    out = []
    used: set = set()
    for name, dim in zip(names, shape):
        axes = rules.get(name) if name else None
        if axes is None:
            out.append(None)
            continue
        if isinstance(axes, str):
            axes = (axes,)
        kept = []
        denom = 1
        for a in axes:
            if a in used:
                continue
            sz = mesh.shape[a]
            if dim % (denom * sz) == 0:
                kept.append(a)
                denom *= sz
        for a in kept:
            used.add(a)
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(tuple(kept))
    return tuple(out)


@dataclasses.dataclass
class Sharder:
    """Sharding helper threaded through the model code.

    ``mesh=None`` (unit tests, one device) makes every call the identity.
    With a mesh, ``reduce`` counts its calls, their bytes and the calls
    on fp32 tensors in ``stats`` (``calls``, ``bytes``, ``fp32_calls``),
    and ``all_gather``, ``all_to_all`` and ``reduce_scatter`` theirs
    (``gather_calls`` / ``gather_bytes``, ``a2a_calls`` / ``a2a_bytes``,
    ``rs_calls`` / ``rs_bytes``: the bytes of this rank's input);
    ``reset_stats`` zeroes them."""

    mesh: Optional[Any] = None
    rules: Dict[str, Axes] = dataclasses.field(
        default_factory=lambda: dict(INFER_RULES))
    stats: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"calls": 0, "bytes": 0, "fp32_calls": 0,
                                 "gather_calls": 0, "gather_bytes": 0,
                                 "a2a_calls": 0, "a2a_bytes": 0,
                                 "rs_calls": 0, "rs_bytes": 0})

    def reset_stats(self) -> None:
        self.stats.update(dict.fromkeys(self.stats, 0))

    def spec(self, names: Sequence[Optional[str]], shape: Sequence[int]
             ) -> Spec:
        if self.mesh is None:
            return ()
        return resolve(names, shape, self.rules, self.mesh)

    def size(self, axes: Axes) -> int:
        """Ranks along ``axes`` (1 without a mesh)."""
        return 1 if self.mesh is None else _axis_size(self.mesh, axes)

    def index(self, axes: Axes) -> int:
        """This rank's index along ``axes``, major-first over the tuple (as
        ``NamedSharding`` lays devices out)."""
        i = 0
        for a in as_axes(axes):
            i = i * self.mesh.shape[a] + self.mesh.coords[a]
        return i

    def _specs(self, names, shape, unit):
        unit = unit or (1,) * len(shape)
        spec = self.spec(names, [d // u for d, u in zip(shape, unit)])
        return spec or (None,) * len(shape)

    def local_shape(self, names: Sequence[Optional[str]],
                    shape: Sequence[int], unit: Sequence[int] = None
                    ) -> Tuple[int, ...]:
        """The shape of this rank's slice. ``unit`` (per dimension) makes
        the split decision and the slices in whole units (head dim blocks
        for a flat heads x head_dim dimension)."""
        spec = self._specs(names, shape, unit)
        return tuple(d // self.size(e) for d, e in zip(shape, spec))

    def local_range(self, names: Sequence[Optional[str]],
                    shape: Sequence[int], dim: int,
                    unit: Sequence[int] = None) -> Tuple[int, int]:
        """[lo, hi) of dimension ``dim`` that this rank holds."""
        e = self._specs(names, shape, unit)[dim]
        n = shape[dim] // self.size(e)
        lo = self.index(e) * n if e is not None else 0
        return lo, lo + n

    def reduce(self, x: torch.Tensor, axes: Axes, grad: str = "identity"
               ) -> torch.Tensor:
        """``x`` summed over the ranks along ``axes`` (``all_reduce`` SUM
        over that axis group); the identity without a mesh or on a single
        rank. While autograd records ``x``, the sum is a copy and its
        backward passes the gradient through (``grad="identity"``) or sums
        it over the same ranks (``grad="sum"``); otherwise ``x`` is summed
        in place."""
        if self.mesh is None or self.size(axes) == 1:
            return x
        if grad not in ("identity", "sum"):
            raise ValueError(f"reduce: grad={grad!r}")
        if torch.is_grad_enabled() and x.requires_grad:
            return _Sum.apply(x, self, axes, grad == "sum")
        return self._all_reduce(x.contiguous(), axes)

    def enter(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """``x``, a tensor every rank along ``axes`` holds whole, as it
        enters products whose weights are split over them: the identity,
        whose backward sums the ranks' partial gradients over ``axes``.
        ``x`` itself when autograd does not record it, or on one rank."""
        if (self.mesh is None or self.size(axes) == 1
                or not (torch.is_grad_enabled() and x.requires_grad)):
            return x
        return _Enter.apply(x, self, axes)

    def all_gather(self, x: torch.Tensor, axes: Axes, dim: int
                   ) -> torch.Tensor:
        """Every rank's ``x`` along ``axes``, concatenated along ``dim`` in
        rank order (``index(axes)``); ``x`` on one rank or without a mesh.
        Under autograd its backward reduce-scatters the gradient (each
        rank's piece summed over the ranks in rank order)."""
        n = self.size(axes)
        if self.mesh is None or n == 1:
            return x
        if torch.is_grad_enabled() and x.requires_grad:
            return _Gather.apply(x, self, axes, dim)
        return self._all_gather(x, axes, dim)

    def _all_gather(self, x: torch.Tensor, axes: Axes, dim: int
                    ) -> torch.Tensor:
        import torch.distributed as dist
        n = self.size(axes)
        group = self.mesh.group(as_axes(axes))
        src = _on_wire(x.contiguous(), group)
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        self.stats["gather_calls"] += 1
        self.stats["gather_bytes"] += src.numel() * src.element_size()
        return torch.cat(parts, dim=dim).to(x.device)

    def all_to_all(self, x: torch.Tensor, axes: Axes, split_dim: int,
                   cat_dim: int) -> torch.Tensor:
        """``x`` cut along ``split_dim`` into one equal piece per rank of
        ``axes``, piece r sent to rank r, and the pieces this rank
        receives concatenated along ``cat_dim`` in rank order (one
        ``all_to_all_single``); ``x`` on one rank or without a mesh.
        Under autograd its backward sends the gradient's pieces back (the
        same exchange with the two dimensions swapped)."""
        n = self.size(axes)
        if self.mesh is None or n == 1:
            return x
        if torch.is_grad_enabled() and x.requires_grad:
            return _Exchange.apply(x, self, axes, split_dim, cat_dim)
        return self._all_to_all(x, axes, split_dim, cat_dim)

    def _all_to_all(self, x: torch.Tensor, axes: Axes, split_dim: int,
                    cat_dim: int) -> torch.Tensor:
        n = self.size(axes)
        got = self._exchange(x, axes, split_dim, "a2a").to(x.device)
        return torch.cat([got[r].movedim(0, split_dim) for r in range(n)],
                         dim=cat_dim)

    def reduce_scatter(self, x: torch.Tensor, axes: Axes, dim: int
                       ) -> torch.Tensor:
        """This rank's piece (``index(axes)``) of ``x`` summed over the
        ranks along ``axes``, ``x`` cut along ``dim`` into one equal piece
        per rank: one ``all_to_all_single`` of the pieces (a reduce-
        scatter's traffic), then the n pieces received summed here in rank
        order, so that the sum's order, and its bits, are the same on
        every backend (over gloo the sum runs in host memory, and only the
        slice comes back to the card). ``x`` on one rank or without a
        mesh. Under autograd its backward all_gathers the gradient."""
        n = self.size(axes)
        if self.mesh is None or n == 1:
            return x
        if torch.is_grad_enabled() and x.requires_grad:
            return _Scatter.apply(x, self, axes, dim)
        return self._reduce_scatter(x, axes, dim)

    def _reduce_scatter(self, x: torch.Tensor, axes: Axes, dim: int
                        ) -> torch.Tensor:
        n = self.size(axes)
        got = self._exchange(x, axes, dim, "rs")
        out = got[0]
        for r in range(1, n):
            out = out + got[r]
        return out.to(x.device).movedim(0, dim).contiguous()

    def _exchange(self, x: torch.Tensor, axes: Axes, dim: int, stat: str
                  ) -> torch.Tensor:
        """The pieces this rank receives when ``x``, cut along ``dim``
        into one equal piece per rank of ``axes``, sends piece r to rank
        r: (n, ...), piece r from rank r with ``dim`` moved first, where
        the backend received them (one ``all_to_all_single``, counted in
        ``stats`` under ``stat``)."""
        import torch.distributed as dist
        n = self.size(axes)
        group = self.mesh.group(as_axes(axes))
        moved = x.movedim(dim, 0)
        if moved.shape[0] % n:
            raise ValueError(f"all_to_all: dimension {dim} of "
                             f"{tuple(x.shape)} does not cut into {n}")
        src = _on_wire(moved.reshape((n, moved.shape[0] // n)
                                     + tuple(moved.shape[1:])).contiguous(),
                       group)
        got = torch.empty_like(src)
        dist.all_to_all_single(got, src, group=group)
        self.stats[f"{stat}_calls"] += 1
        self.stats[f"{stat}_bytes"] += src.numel() * src.element_size()
        return got

    def _all_reduce(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """In-place ``all_reduce`` SUM of the contiguous ``x``, counted in
        ``stats``."""
        import torch.distributed as dist
        dist.all_reduce(x, group=self.mesh.group(as_axes(axes)))
        self.stats["calls"] += 1
        self.stats["bytes"] += x.numel() * x.element_size()
        self.stats["fp32_calls"] += int(x.dtype == torch.float32)
        return x


def _on_wire(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` where ``group``'s backend takes it for ``all_gather`` and
    ``all_to_all``: a CUDA tensor of a gloo group through host memory,
    else ``x``."""
    import torch.distributed as dist
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.cpu()
    return x


class _Sum(torch.autograd.Function):
    """``Sharder.reduce`` under autograd: the sum over the ranks of
    ``axes``; backward the identity, or the same sum (``grad_sum``)."""

    @staticmethod
    def forward(ctx, x, sharder, axes, grad_sum):
        ctx.sharder, ctx.axes, ctx.grad_sum = sharder, axes, grad_sum
        return sharder._all_reduce(
            x.clone(memory_format=torch.contiguous_format), axes)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_sum:
            g = ctx.sharder._all_reduce(
                g.clone(memory_format=torch.contiguous_format), ctx.axes)
        return g, None, None, None


class _Enter(torch.autograd.Function):
    """``Sharder.enter``: the identity; backward the sum over ``axes``."""

    @staticmethod
    def forward(ctx, x, sharder, axes):
        ctx.sharder, ctx.axes = sharder, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.sharder._all_reduce(
            g.clone(memory_format=torch.contiguous_format), ctx.axes), \
            None, None


class _Gather(torch.autograd.Function):
    """``Sharder.all_gather`` under autograd; backward the reduce-scatter
    of the gradient along the same dimension."""

    @staticmethod
    def forward(ctx, x, sharder, axes, dim):
        ctx.sharder, ctx.axes, ctx.dim = sharder, axes, dim
        return sharder._all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.sharder._reduce_scatter(g, ctx.axes, ctx.dim), \
            None, None, None


class _Scatter(torch.autograd.Function):
    """``Sharder.reduce_scatter`` under autograd; backward the all_gather
    of the gradient along the same dimension."""

    @staticmethod
    def forward(ctx, x, sharder, axes, dim):
        ctx.sharder, ctx.axes, ctx.dim = sharder, axes, dim
        return sharder._reduce_scatter(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.sharder._all_gather(g, ctx.axes, ctx.dim), \
            None, None, None


class _Exchange(torch.autograd.Function):
    """``Sharder.all_to_all`` under autograd; backward the exchange of the
    gradient with ``split_dim`` and ``cat_dim`` swapped."""

    @staticmethod
    def forward(ctx, x, sharder, axes, split_dim, cat_dim):
        ctx.sharder, ctx.axes = sharder, axes
        ctx.dims = split_dim, cat_dim
        return sharder._all_to_all(x, axes, split_dim, cat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, cat_dim = ctx.dims
        return ctx.sharder._all_to_all(g, ctx.axes, cat_dim, split_dim), \
            None, None, None, None


def _is_names(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def head_units(names: Sequence[Optional[str]], head_dim: Optional[int]
               ) -> Optional[Tuple[int, ...]]:
    """Split units per dimension: ``head_dim`` for a flat heads x head_dim
    dimension (``"heads"``, ``"kv_heads"``), so that it is decided and cut
    in whole heads; None (units of 1) without a head size."""
    if head_dim is None:
        return None
    return tuple(head_dim if n in ("heads", "kv_heads") else 1
                 for n in names)


@dataclasses.dataclass(frozen=True)
class MixerSplit:
    """A rank's SSD heads ``[lo, hi)`` of a Mamba2 mixer of ``n_heads``
    heads of ``head_dim`` with state width ``n_state`` (one group): the
    head-aligned split of its fused leaves. ``lo, hi = 0, n_heads`` keeps
    the mixer whole (the head count does not divide the model axis)."""

    n_heads: int
    head_dim: int
    n_state: int
    lo: int
    hi: int

    @property
    def whole(self) -> bool:
        return (self.lo, self.hi) == (0, self.n_heads)

    def ranges(self, name: str, width: int) -> List[Tuple[int, int]]:
        """The ``[lo, hi)`` pieces of a dimension named ``name``
        (``ssm_heads`` or ``ssm_inner``) and ``width`` wide that the rank
        keeps, in order. ``ssm_inner`` is told apart by its width: the
        gated output ``d_inner`` (``gate_norm``, ``w_out``'s rows), the conv
        channels ``[x | B | C]`` (``d_inner + 2N``) or ``w_in``'s fused
        ``[z | x | B | C | dt]`` (``2 d_inner + 2N + n_heads``); the rank
        keeps its heads' z, x and dt, and B and C whole."""
        return [(lo, hi) for lo, hi, _ in self._pieces(name, width)]

    def shared(self, name: str, width: int) -> Optional[Tuple[int, int]]:
        """The piece of ``ranges`` that every rank keeps whole, B and C, as
        its global ``[lo, hi)``; None where the dimension has none."""
        return next(((lo, hi) for lo, hi, whole in self._pieces(name, width)
                     if whole), None)

    def _pieces(self, name: str, width: int) -> List[Tuple[int, int, bool]]:
        """``ranges`` with, for each piece, whether every rank keeps it."""
        hd, n, nh = self.head_dim, self.n_state, self.n_heads
        d_inner = nh * hd
        x = (self.lo * hd, self.hi * hd, False)
        if name == "ssm_heads" and width == nh:
            return [(self.lo, self.hi, False)]
        if name == "ssm_inner" and width == d_inner:
            return [x]
        if name == "ssm_inner" and width == d_inner + 2 * n:
            return [x, (d_inner, d_inner + 2 * n, True)]
        if name == "ssm_inner" and width == 2 * d_inner + 2 * n + nh:
            bc = 2 * d_inner
            return [x, (d_inner + x[0], d_inner + x[1], False),
                    (bc, bc + 2 * n, True),
                    (bc + 2 * n + self.lo, bc + 2 * n + self.hi, False)]
        raise ValueError(f"no Mamba2 mixer dimension {name!r} of width "
                         f"{width} ({nh} heads of {hd}, state {n})")


def shard_leaf(full: torch.Tensor, names: Sequence[Optional[str]],
               sharder: Sharder, head_dim: Optional[int] = None,
               kv_sel: Optional[Sequence[int]] = None,
               mixer: Optional[MixerSplit] = None) -> torch.Tensor:
    """This rank's part of one full tensor (a copy, so that the full tensor
    can be freed; ``full`` itself where nothing is split): the indices
    ``leaf_index`` gives, heads in whole heads of ``head_dim``; where
    ``kv_sel`` is given (``kv_heads`` replicated, ``heads`` split), the
    ``kv_heads`` dimension keeps the KV heads it lists, in that order:
    those the rank's query heads read. With ``mixer``, an ``ssm_inner`` or
    ``ssm_heads`` dimension keeps the rank's SSD heads' pieces
    (``MixerSplit.ranges``), never ``resolve``'s cut of the flat
    dimension."""
    out, cut, picked = full, False, False
    for d, v in enumerate(leaf_index(full.shape, names, sharder, head_dim,
                                     kv_sel, mixer)):
        lo = int(v[0]) if len(v) else 0
        if torch.equal(v, torch.arange(lo, lo + len(v))):
            cut |= len(v) != full.shape[d]
            out = out.narrow(d, lo, len(v))
        else:
            picked = True
            out = out.index_select(d, v.to(full.device))
    if picked:
        return out.contiguous()
    return out.clone() if cut else full


def leaf_index(shape: Sequence[int], names: Sequence[Optional[str]],
               sharder: Sharder, head_dim: Optional[int] = None,
               kv_sel: Optional[Sequence[int]] = None,
               mixer: Optional[MixerSplit] = None) -> List[torch.Tensor]:
    """The part of a tensor of ``shape`` that ``shard_leaf`` keeps, as one
    int64 vector of global indices per dimension (the kept part is
    ``full[ix]`` with the vectors crossed): the same decisions, on index
    vectors instead of values."""
    idx = [torch.arange(n) for n in shape]
    names = tuple(names)
    if mixer is not None:
        ax = next((i for i, n in enumerate(names)
                   if n in ("ssm_inner", "ssm_heads")), None)
        if ax is not None:
            if not mixer.whole:
                idx[ax] = torch.cat([idx[ax][lo:hi] for lo, hi in
                                     mixer.ranges(names[ax], shape[ax])])
            names = tuple(None if i == ax else n
                          for i, n in enumerate(names))
    if kv_sel is not None and "kv_heads" in names:
        ax = names.index("kv_heads")
        idx[ax] = torch.cat([torch.arange(h * head_dim, (h + 1) * head_dim)
                             for h in kv_sel])
        return idx
    if sharder.mesh is None:
        return idx
    cut = [len(i) for i in idx]
    unit = head_units(names, head_dim)
    for i in range(len(cut)):
        lo, hi = sharder.local_range(names, cut, i, unit)
        idx[i] = idx[i][lo:hi]
    return idx


def tree_shard(tree: Any, specs: Any, sharder: Sharder,
               head_dim: Optional[int] = None,
               kv_sel: Optional[Sequence[int]] = None,
               mixer: Optional[MixerSplit] = None) -> Any:
    """Map a tree of full tensors and a same-structure tree of logical-name
    tuples to this rank's local tensors (the counterpart of
    ``tree_shardings`` plus ``device_put``), each leaf by ``shard_leaf``.
    The models' ``shard_params`` and ``init`` slice their params with it,
    passing the head size, the KV-head selection and the Mamba2 mixer's
    head split."""
    if _is_names(specs):
        return shard_leaf(tree, specs, sharder, head_dim, kv_sel, mixer)
    return {k: tree_shard(tree[k], specs[k], sharder, head_dim, kv_sel,
                          mixer)
            for k in tree}
