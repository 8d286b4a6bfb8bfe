"""Decoder-only LM: dense GQA, MoE, SSM (Mamba2), hybrid (Zamba2) and the
M-RoPE VLM (Qwen2-VL) families (port of ``repro/models/transformer.py``).

Entry points, as in the reference:

  * ``loss(params, batch)`` — the training objective (causal-LM cross
    entropy plus the MoE load-balancing loss), each layer rematerialised
    in the backward pass with ``remat`` (the default);
  * ``prefill(params, inputs, cache=paged)`` — prompt -> (last logits,
    cache with the prompt K/V written through the block tables); without
    a paged cache, a fresh contiguous cache at ``max_len``;
  * ``prefill_chunk(...)`` — a C-token chunk, either written straight into
    the engine pool through per-row table snapshots (engine-direct mode)
    or appended to a contiguous cache (attention families only, as in the
    reference);
  * ``prefill_suffix(...)`` — the prefix-sharing engine's suffix prefill:
    per-row bases after a shared prefix already resident in the pool;
  * ``decode_step(params, cache, tokens)`` — one token per row against a
    paged or contiguous cache, or one recurrent step.

Two KV layouts, both the reference's: the paged pool
``(L, n_blocks, block, nkv, d)`` with per-row block tables, and the
contiguous ``(L, B, max_len, nkv, d)`` with per-row positions, linear
(sliding windows by masking: what the engine allocates) or, with
``ring=True`` for a sliding-window config, the reference's ring of
``min(max_len, window)`` slots and its ``slot_pos`` map, whose decode runs
the contiguous decode kernel (``ops.decode_attention_ring``). The SSM and
hybrid families carry recurrent state instead,
contiguous only: ``conv`` (L, B, K-1, d_inner+2N) in the model dtype and
``ssd`` (L, B, nheads, head_dim, N) in fp32, plus, for the hybrid, ``ak`` /
``av`` (n_apps, B, max_len, nkv, d) per shared-block application. Where JAX
scans the layers (the hybrid in groups of ``hybrid_period``) and donates
the cache across the jit boundary, this port loops over the layer index
and writes each layer's cache slice IN PLACE, so a dispatch never copies
the cache: the cache dict a caller passes in is updated and handed back.

Attention and the SSD scan go through ``repro_torch.kernels.ops``: the
hand-written CUDA kernels for tensors on the card, the plain versions for
CPU tensors. With ``kv_probe`` armed (the engine arms it in sanitize mode
on the paged layout, as the reference does) the paged decode and chunk
calls also return the KV sanitizer's probe, the largest |K| / |V| each row
may read; the model keeps every layer's on the device, and ``take_probe``
hands the caller their maximum once per dispatch. The QKV / O / FFN / SSM
in-out / LM-head projections stay ``@`` (the JAX package leaves them to
XLA outside any Pallas kernel).

Tensor parallelism (``sharder`` with a mesh; ``launch/steps.py`` builds
it): each rank holds the slices the reference's rule tables give it, heads
decided in whole heads, and runs the layers on them with an explicit
``Sharder.reduce`` (all_reduce SUM over ``model``) where the reference's
GSPMD inserts one: after the row-parallel ``wo`` and ``w_down`` (their
partial products summed in fp32 and rounded once, as the unsplit product
rounds; the biases added once, after the sum), after the MoE combine,
after the vocab-parallel embedding lookup (each rank looks up its own
vocab rows and writes zeros elsewhere) and after the vocab-parallel
logits (each rank's columns written into a zero buffer of the padded
vocab): sums with zeros, so the last two are exact. Where the rules cut
the KV cache by sequence (``cache_seq``, ``cache_seq_axes``: a prefill
step's cache, and a serve step's where the KV heads do not divide the
model axis) each rank holds every KV head of its slice of the positions
(``seq_slice``); a decode writes a token on the rank holding its
position (its KV heads gathered first where they are split) and merges
the slices' partials (``_split_attention``: the decode kernel's
log-sum-exp output, an all_gather of q and an all_to_all of the partials
where the query heads are split, an all_gather of them where they are
whole). As ``resolve`` does, the cut is decided leaf by leaf from the
leaf's own length (``seq_cuts``): a leaf the axes do not divide stays
whole on every rank, at the KV heads the rank projects, and its
attention runs on the whole leaf. ``init_cache`` records each K/V leaf's
length in ``kv_lengths``, where a decode reads which leaves are cut.

Where the ``seq`` rule cuts a prefill's activations by sequence (a big
prefill under the reference's ``build_rules``, or ``extra_rules``;
``_seq_axes`` decides it from the prompt's own length, as ``resolve``
decides ``("batch", "seq", None)``), the prefill runs Megatron-style
sequence parallelism: the residual stream, the norms' inputs, the
residual adds and the embedding's, attention's, FFN's, MoE's and Mamba2
mixer's outputs hold the rank's slice of the positions; each block
gathers the whole sequence first (``all_gather``) and computes at its
local heads or columns on it, so that flash, the SSD scan and the conv
see whole sequences and the MoE router every token; a row-parallel
product's fp32 partials are summed into the rank's slice
(``Sharder.reduce_scatter``, rounded once after the sum) where the
all_reduce would sum them whole, as does the vocab-parallel embedding;
a block whose weights are whole on every rank slices its own result.
The last position's hidden state comes from the rank that holds it (one
all_reduce of a zero-filled buffer). The K/V reach the cache as they do
without the rule. A train step (``loss_shard``) follows the same cut:
each gather, reduce-scatter and all_to_all carries its backward, the
replicated input of a split product is not summed again on the way back
(the gather's backward sums it), the vocab-parallel logits of the rank's
slice come by one all_to_all, and the rank's NLL is its slice's. Where ``resolve`` replicates
``kv_heads`` but splits ``heads`` on rules without ``cache_seq`` (the
train step's), a rank projects only the KV heads its query heads read
(global query head i reads KV head i // g), all of them in query order
when they do not form equal groups. With the batch split over ``data`` (``batch_axes``), the MoE's
capacity queues count the rows of the ranks before this one, so capacity
and drops are the whole batch's. The Mamba2 mixer splits by whole SSD
heads (``sharding.rules.MixerSplit``, decided by ``resolve`` over the
``ssm_heads`` count, whole where it does not divide): two all_reduces a
layer, the gated RMSNorm's sums of squares and the row-parallel
``w_out`` (``models/ssm.py``); the hybrid's shared block splits as a dense
layer does. The layout and these pieces live in ``TensorParallel``, which
the encoder-decoder shares. Under autograd (a mesh train step,
``launch/train_mesh.py``) each sum passes its gradient through unchanged
(the ranks then compute the same thing), the gated norm's sums of
squares send theirs back summed, and each replicated activation entering
a product whose weight is split sums its gradient over the ranks on the
way back (``Sharder.enter``); ``loss_shard`` is a rank's share of the
loss.

The VLM's vision tower is a stub, as in the reference: ``prefill`` takes
patch embeddings ``inputs["embeds"]`` (B, S, d_model) and M-RoPE position
streams ``inputs["positions"]`` (3, B, S), ``decode_step`` (B, 1, d_model)
embeds; from tokens (the engine) its three streams are identical. The
encoder-decoder is ``models/encdec.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, dtype_of, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (ParamDef, apply_m_rope, apply_rope,
                                       init_params, lm_cross_entropy,
                                       lm_nll_sum, make_norm, matmul_fp32,
                                       norm_schema, param_count, remat,
                                       schema_shapes, schema_specs,
                                       stack_schema, unbind_layers)
from repro_torch.sharding.rules import (Axes, MixerSplit, Sharder,
                                        leaf_index, shard_leaf, tree_shard)

IntLike = Union[int, torch.Tensor]


RECURRENT = ("ssm", "hybrid")       # families whose cache is SSM state
STATE_KEYS = ("conv", "ssd")        # per-row recurrent state, no seq axis


def kv_select(n_heads: int, n_kv: int, n_local: int, h_lo: int
              ) -> List[int]:
    """The KV heads a rank whose query heads are ``[h_lo, h_lo +
    n_local)`` holds where ``kv_heads`` is replicated and ``heads`` split:
    those its query heads read (global query head i reads KV head i // g),
    each once where they form equal groups, else one per query head in
    query order."""
    g = n_heads // n_kv
    need = [(h_lo + j) // g for j in range(n_local)]
    uniq = sorted(set(need))
    gl = n_local // len(uniq)
    grouped = gl * len(uniq) == len(need) and all(
        need[j] == uniq[j // gl] for j in range(len(need)))
    return uniq if grouped else need


# cache leaves holding K/V (the rest is recurrent state and positions)
KV_KEYS = ("k", "v", "ak", "av", "ck", "cv")


def cache_seq_axes(cfg: ArchConfig, sharder: Sharder) -> Axes:
    """The mesh axes a KV cache's sequence is cut over under
    ``sharder``'s rules (the reference's ``cache_seq`` rule, as
    ``resolve`` gives it the axes before ``kv_heads``); None where the
    cache holds whole sequences (no such rule, no KV heads, one rank)."""
    if not cfg.n_kv_heads or sharder.mesh is None:
        return None
    n = sharder.size(sharder.rules.get("cache_seq"))
    if n == 1:
        return None
    ax = sharder.spec(("cache_seq", "kv_heads"), (n, cfg.n_kv_heads))[0]
    return ax if sharder.size(ax) > 1 else None


class TensorParallel:
    """The tensor-parallel layout and the pieces that run on it, shared by
    ``LM`` and ``encdec.EncDecLM``. The model sets ``cfg``, ``device``,
    ``dtype``, ``_schema``, ``sharder`` and ``batch_axes``, then calls
    ``_tp_layout``; without a mesh every piece is the unsplit model's."""

    # ------------------------------------------------------------------ #
    # tensor-parallel layout
    # ------------------------------------------------------------------ #
    def _tp_layout(self) -> None:
        """This rank's heads, KV heads, SSD heads and vocab rows, and the
        mesh axes each row-parallel product sums over (None: nothing to
        sum)."""
        c, sh = self.cfg, self.sharder
        nh, nkv = c.n_heads, c.n_kv_heads
        self._heads_ax = (self._axes_of(("embed", "heads"), (c.d_model, nh))
                          if nh else None)
        self.n_heads_local = nh // sh.size(self._heads_ax)
        h_lo = sh.index(self._heads_ax) * self.n_heads_local \
            if self._heads_ax else 0
        kv_ax = self._kv_axes()
        self._kv_sel: Optional[List[int]] = None
        self.n_kv_local = nkv // sh.size(kv_ax)
        # a KV cache cut by sequence (``cache_seq``): every rank holds every
        # KV head of its slice of positions; where ``kv_heads`` is
        # replicated the rank projects them all (wk / wv whole) and its
        # query heads' attention reads those they need (``_attn_sel``)
        self._seq_ax = cache_seq_axes(c, sh)
        self._attn_sel: Optional[List[int]] = None
        if kv_ax is None and self._heads_ax is not None:
            sel = kv_select(nh, nkv, self.n_heads_local, h_lo)
            if self._seq_ax is None:
                self._kv_sel = sel
                self.n_kv_local = len(sel)
            elif sel != list(range(nkv)):
                self._attn_sel = sel
        self.n_kv_cache = nkv if self._seq_ax is not None else self.n_kv_local
        # each K/V leaf's positions, as ``init_cache`` last laid them out
        # (a decode reads from them which leaves are cut by sequence)
        self.kv_lengths: Dict[str, int] = {}
        # the local shape of the residual stream of the last prefill or
        # training forward (the rank's slice of the positions under the
        # ``seq`` rule)
        self.residual_shape: Optional[Tuple[int, ...]] = None
        if self._seq_ax is not None and self._heads_ax not in (
                None, self._seq_ax):
            raise ValueError(f"{c.name}: heads split over {self._heads_ax} "
                             f"and the cache's sequence over "
                             f"{self._seq_ax}")
        self._ffn_ax = None
        if c.d_ff:
            names = ("embed", "expert_ffn" if c.n_experts else "ffn")
            self._ffn_ax = self._axes_of(names, (c.d_model, c.d_ff))
        self._vocab_ax = self._axes_of(("vocab", "embed"),
                                       (c.padded_vocab, c.d_model), dim=0)
        self._vocab_lo = (sh.index(self._vocab_ax) * c.padded_vocab
                          // sh.size(self._vocab_ax)
                          if self._vocab_ax else 0)
        # the Mamba2 mixer: whole SSD heads, decided by ``resolve`` over
        # the head count as attention heads are
        self._ssm_ax, self._mixer = None, None
        if c.ssm_state:
            self._ssm_ax = self._axes_of(("ssm_heads",), (c.ssm_heads,),
                                         dim=0)
            n = c.ssm_heads // sh.size(self._ssm_ax)
            lo = sh.index(self._ssm_ax) * n if self._ssm_ax else 0
            self._mixer = MixerSplit(c.ssm_heads, c.ssm_head_dim,
                                     c.ssm_state, lo, lo + n)
        self.ssm_heads_local = self._mixer.hi - self._mixer.lo \
            if self._mixer else 0

    def _reduce(self, axes: Axes, grad: str = "identity", sp: Axes = None):
        """The partial-sum reduction over ``axes`` (None when unsplit);
        ``grad`` as ``Sharder.reduce`` takes it; with the sequence cut over
        ``sp`` (the same axes), the sum into this rank's slice of the
        positions (dimension 1)."""
        if axes is None:
            return None
        if sp is not None:
            return lambda x: self.sharder.reduce_scatter(x, axes, 1)
        return lambda x: self.sharder.reduce(x, axes, grad=grad)

    def _enter(self, x: torch.Tensor, axes: Axes, sp: Axes = None
               ) -> torch.Tensor:
        """``x``, replicated over the ranks of ``axes``, entering products
        whose weights are split over them (``Sharder.enter``: the
        gradient summed over the ranks in the backward pass); ``x`` when
        unsplit, and where the sequence is cut over ``sp`` (``x`` then
        comes from an all_gather, whose backward sums the ranks' partial
        gradients instead)."""
        if axes is None or sp is not None:
            return x
        return self.sharder.enter(x, axes)

    def _row_parallel(self, axes: Axes, sp: Axes = None):
        """``(x, w) -> x @ w`` for a weight whose rows are split over
        ``axes``: each rank's partial product in fp32, summed over the
        ranks in fp32 and rounded once to the activation dtype, as the
        unsplit product rounds its fp32 accumulation once (a bf16 partial
        per rank would round twice and drift from the unsplit model over
        the layers); with the sequence cut over ``sp`` (the same axes),
        summed into this rank's slice of the positions (dimension 1) by a
        reduce-scatter. None when unsplit."""
        if axes is None:
            return None
        total = self._reduce(axes, sp=sp)

        def product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
            return total(matmul_fp32(x, w)).to(x.dtype)
        return product

    # ------------------------------------------------------------------ #
    # sequence-split activations (the ``seq`` rule)
    # ------------------------------------------------------------------ #
    def _seq_axes(self, b: int, s: int) -> Axes:
        """The mesh axes the ``seq`` rule cuts an activation of ``b``
        local rows and ``s`` positions over, as ``resolve`` decides
        ``("batch", "seq", None)`` for the whole batch; None where it
        stays whole. Refuses axes other than those the tensor-parallel
        products split over (their partials could not be summed into the
        slice)."""
        sh = self.sharder
        if sh.mesh is None or sh.rules.get("seq") is None:
            return None
        rows = b * sh.size(self.batch_axes)
        ax = sh.spec(("batch", "seq", None), (rows, s, self.cfg.d_model))[1]
        if sh.size(ax) == 1:
            return None
        for name, t in (("heads", self._heads_ax), ("ffn", self._ffn_ax),
                        ("ssm_heads", self._ssm_ax),
                        ("vocab", self._vocab_ax)):
            if t not in (None, ax):
                raise NotImplementedError(
                    f"{self.cfg.name}: the sequence cut over {ax} and "
                    f"{name} split over {t}")
        return ax

    def train_seq_axes(self, batch: Dict) -> Axes:
        """The mesh axes the ``seq`` rule cuts a training ``batch`` (this
        rank's rows) over (``_seq_axes`` of its targets); None where the
        positions stay whole."""
        b, s = batch["targets"].shape
        return self._seq_axes(b, s)

    def _nll_sum(self, logits: torch.Tensor, batch: Dict, sp: Axes
                 ) -> torch.Tensor:
        """The summed NLL of ``logits`` against the batch's ``targets``
        under its ``mask``, over this rank's slice of the positions where
        the sequence is cut over ``sp``."""
        mask = batch.get("mask")
        return lm_nll_sum(logits, self._sp_cut(batch["targets"], sp),
                          None if mask is None else self._sp_cut(mask, sp),
                          self.cfg.vocab)

    def _sp_cut(self, x: torch.Tensor, sp: Axes) -> torch.Tensor:
        """This rank's slice of the positions (dimension 1) of ``x``,
        which holds the whole sequence; ``x`` where ``sp`` is None."""
        if sp is None:
            return x
        n = x.shape[1] // self.sharder.size(sp)
        lo = self.sharder.index(sp) * n
        return x[:, lo:lo + n]

    def _sp_whole(self, x: torch.Tensor, sp: Axes) -> torch.Tensor:
        """The whole sequence of ``x``, this rank's slice of the positions
        (one all_gather over ``sp``); ``x`` where ``sp`` is None."""
        return x if sp is None else self.sharder.all_gather(x, sp, dim=1)

    def _sp_last(self, x: torch.Tensor, last_pos: Optional[torch.Tensor],
                 sp: Axes) -> torch.Tensor:
        """Each row's hidden state at ``last_pos`` (default: the last
        position), (B, 1, d), from ``x``: the rows are taken on the rank
        whose slice holds the position, into a zero-filled buffer summed
        over ``sp`` (exact: sums with zeros)."""
        b, n = x.shape[0], x.shape[1]
        rows = torch.arange(b, device=x.device)
        if sp is None:
            if last_pos is None:
                return x[:, -1:, :]
            return x[rows, last_pos.long()][:, None, :]
        lo = self.sharder.index(sp) * n
        lp = (torch.full((b,), n * self.sharder.size(sp) - 1,
                         device=x.device) if last_pos is None
              else last_pos.long()) - lo
        mine = (lp >= 0) & (lp < n)
        got = x[rows, lp.clamp(0, n - 1)]
        buf = torch.where(mine[:, None], got, torch.zeros(
            (), dtype=x.dtype, device=x.device))
        return self.sharder.reduce(buf[:, None, :].contiguous(), sp)

    def _ffn_block(self, p: Dict, x: torch.Tensor, ln: Dict,
                   sp: Axes = None) -> torch.Tensor:
        """A dense FFN sub-block, without the residual: ``ffn_apply`` of
        ``x`` normed by ``ln``. With the sequence cut over ``sp`` (``x``
        the rank's slice): where the FFN's columns are split, on the
        gathered sequence with the ``w_down`` partials reduce-scattered;
        where it is whole, on the slice."""
        c = self.cfg
        if self._ffn_ax is None:
            sp = None
        h = self._enter(self.norm(self._sp_whole(x, sp), ln), self._ffn_ax,
                        sp)
        return ffn_mod.ffn_apply(p, h, c.act, c.gated_ffn,
                                 self._row_parallel(self._ffn_ax, sp))

    def _local_leaf(self, d: ParamDef, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of one full parameter (``shard_leaf``: heads in
        whole heads, the KV heads its query heads read where ``kv_heads``
        is replicated and ``heads`` split, the mixer by SSD head)."""
        return shard_leaf(full, d.names, self.sharder, self._head_dim,
                          self._kv_sel, self._mixer)

    def local_index(self, d: ParamDef) -> List[torch.Tensor]:
        """The global indices, per dimension, of the part of a parameter
        of schema entry ``d`` that ``_local_leaf`` keeps
        (``sharding.rules.leaf_index``)."""
        return leaf_index(d.shape, d.names, self.sharder, self._head_dim,
                          self._kv_sel, self._mixer)

    def shard_params(self, full: Dict) -> Dict:
        """This rank's local params from the full (unsplit) tree."""
        return tree_shard(full, self.param_specs(), self.sharder,
                          self._head_dim, self._kv_sel, self._mixer)

    @property
    def _head_dim(self) -> Optional[int]:
        """The attention head size (None without attention heads)."""
        return self.cfg.hd if self.cfg.n_heads else None

    def local_param_shapes(self) -> Dict:
        """The shapes of this rank's local params (sliced on the meta
        device by the same ``shard_leaf``)."""
        def walk(ref):
            if not isinstance(ref, ParamDef):
                return {k: walk(v) for k, v in ref.items()}
            meta = torch.empty(ref.shape, device="meta")
            return tuple(self._local_leaf(ref, meta).shape)
        return walk(self._schema)

    def shard_cache(self, full: Dict, rows: slice = slice(None)) -> Dict:
        """This rank's part of a full contiguous (or ring) cache: the
        ``rows`` it serves, its part of the K/V (``cache_part``) and, for
        the recurrent state, its SSD heads' ``conv`` channels (B and C
        whole) and ``ssd`` state."""
        if "block_tbl" in full:
            raise ValueError("shard_cache takes a contiguous cache")
        out = {"pos": full["pos"][rows].clone()}
        if "slot_pos" in full:
            out["slot_pos"] = full["slot_pos"].clone()
        specs = self.cache_specs()
        for key, t in full.items():
            if key in out:
                continue
            t = t[:, rows]
            if key in STATE_KEYS:
                names = tuple(None if n == "batch" else n
                              for n in specs[key])
                t = shard_leaf(t, names, self.sharder, mixer=self._mixer)
            else:
                t = self.cache_part(t, 2, 3)
            out[key] = t.contiguous()
        return out

    def cache_part(self, t: torch.Tensor, seq_dim: int, heads_dim: int
                   ) -> torch.Tensor:
        """This rank's part of a K/V cache tensor ``t`` holding every
        position and KV head: its slice of positions along ``seq_dim``
        (every head) where the cache is cut by sequence, else its KV heads
        along ``heads_dim`` (``shard_kv_heads``)."""
        if not self.seq_cuts(t.shape[seq_dim]):
            return self.shard_kv_heads(t, heads_dim)
        lo, n = self.seq_slice(t.shape[seq_dim])
        return t.narrow(seq_dim, lo, n)

    def seq_cuts(self, length: int) -> bool:
        """Whether a K/V leaf of ``length`` positions is cut by sequence:
        ``cache_seq`` over ``cache_seq_axes``, as ``resolve`` decides it
        for that length. A leaf the axes do not divide stays whole on
        every rank, holding the KV heads the rank projects (those
        ``resolve`` gives ``kv_heads`` then)."""
        if self._seq_ax is None:
            return False
        ax = self.sharder.spec(("cache_seq", "kv_heads"),
                               (length, self.cfg.n_kv_heads))[0]
        if self.sharder.size(ax) == 1:
            return False
        if ax != self._seq_ax:
            raise NotImplementedError(
                f"{self.cfg.name}: a cache of {length} positions cut over "
                f"{ax}, part of cache_seq's {self._seq_ax}")
        return True

    def seq_slice(self, length: int) -> Tuple[int, int]:
        """(first position, positions) of this rank's slice of a cache of
        ``length`` positions: (0, length) where the leaf is whole."""
        if not self.seq_cuts(length):
            return 0, length
        n = self.sharder.size(self._seq_ax)
        return self.sharder.index(self._seq_ax) * (length // n), length // n

    def kv_heads_of(self, length: int) -> int:
        """The KV heads this rank holds of a cache leaf of ``length``
        positions: every head where the leaf is cut by sequence, else
        the heads it projects."""
        return self.n_kv_cache if self.seq_cuts(length) else self.n_kv_local

    def _kv_cut(self, key: str) -> bool:
        """Whether the cache leaf ``key`` this model decodes on is cut by
        sequence, by its length in ``kv_lengths`` (cut wherever
        ``cache_seq`` is, when unrecorded)."""
        length = self.kv_lengths.get(key)
        if length is None:
            return self._seq_ax is not None
        return self.seq_cuts(length)

    def _whole_length(self, local: int) -> Tuple[int, int]:
        """(this rank's first position, the whole cache's length) for a
        cache slice of ``local`` positions."""
        n = self.sharder.size(self._seq_ax)
        return self.sharder.index(self._seq_ax) * local, n * local

    def kv_to_cache(self, t: torch.Tensor, length: Optional[int] = None
                    ) -> torch.Tensor:
        """A prompt's K or V (..., S, nkv_local, d), zero-padded to a cache
        of ``length`` positions (default S), as this rank's cache holds it:
        itself where sequences are whole; cut by sequence, the rank's slice
        of every head, by one all_to_all over the heads it projected where
        ``kv_heads`` is split, else its slice; a leaf the axes do not cut,
        itself."""
        s = t.shape[-3]
        if length is not None and length != s:
            full = t.new_zeros(t.shape[:-3] + (length,) + t.shape[-2:])
            full[..., :s, :, :] = t
            t = full
        if not self.seq_cuts(t.shape[-3]):
            return t
        if self.n_kv_local == self.n_kv_cache:
            lo, n = self.seq_slice(t.shape[-3])
            return t.narrow(-3, lo, n).contiguous()
        return self.sharder.all_to_all(t, self._seq_ax, t.ndim - 3,
                                       t.ndim - 2)

    def _attn_kv(self, k: torch.Tensor) -> torch.Tensor:
        """The projected K or V (B, S, nkv_local, d) that this rank's query
        heads attend: all of it, or, where the rank projects every KV head
        for a cache cut by sequence, those its query heads read."""
        if self._attn_sel is None:
            return k
        return k.index_select(2, torch.tensor(self._attn_sel,
                                              device=k.device))

    def _cached_attention(self, q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, pos: torch.Tensor,
                          ck: torch.Tensor, cv: torch.Tensor,
                          window: Optional[int] = None,
                          key: str = "k") -> torch.Tensor:
        """One token's attention against a layer's contiguous cache (the
        leaf ``key``): its K/V written at ``pos`` (clamped to the cache's
        end, in place), then the row's keys up to ``pos``. On a leaf cut
        by sequence the rank that holds the position writes it (the
        token's KV heads gathered first where they are split), and the
        attention is ``_split_attention`` at the local position."""
        if not self._kv_cut(key):
            attn.cache_write_token(ck, cv, k, v, pos)
            return kops.decode_attention(q, self._attn_kv(ck),
                                         self._attn_kv(cv), pos,
                                         window=window)
        lo, length = self._whole_length(ck.shape[1])
        attn.cache_write_token_slice(ck, cv, self._token_heads(k),
                                     self._token_heads(v), pos, lo, length)
        return self._split_attention(q, ck, cv, pos - lo, window,
                                     every_head=True)

    def _token_heads(self, t: torch.Tensor) -> torch.Tensor:
        """A decoded token's K or V (B, 1, n_kv_local, d) with every KV
        head, for a cache cut by sequence: gathered over the KV heads'
        axes where they are split."""
        if self.n_kv_local == self.n_kv_cache:
            return t
        return self.sharder.all_gather(t, self._kv_axes(), dim=2)

    def _split_attention(self, q: torch.Tensor, ck: torch.Tensor,
                         cv: torch.Tensor, local: torch.Tensor,
                         window: Optional[int] = None,
                         every_head: bool = False) -> torch.Tensor:
        """One token per row against a cache cut by sequence over
        ``_seq_ax``: every query head runs the decode kernel with its
        log-sum-exp output on this rank's slice at the local position
        ``local`` (B,), and the slices' fp32 partials merge
        (``attention.merge_partials``), rounded once to q's dtype. Where
        the query heads are split over the same ranks, q is gathered
        first and each rank receives its heads' partials (one all_gather,
        one all_to_all); where they are whole, every rank gathers every
        partial (one all_gather). q: (B, 1, nh_local, d) -> the same.
        ``every_head``: the caller wrote the new token's every KV head into
        the slices (the serve steps gather them where the KV heads are
        split); without it a layout whose KV heads are split refuses."""
        if self.n_kv_local != self.n_kv_cache and not every_head:
            raise NotImplementedError(
                f"{self.cfg.name}: decode on a cache cut by sequence with "
                f"the KV heads split (a prefill step's layout; "
                f"BuiltStep.store_cache lays it out by heads)")
        ax, sh = self._seq_ax, self.sharder
        b, _, _, d = q.shape
        split = self._heads_ax is not None
        qa = sh.all_gather(q, ax, dim=2) if split else q
        lse = torch.empty((b, qa.shape[2]), dtype=torch.float32,
                          device=q.device)
        o, lse = kops.decode_attention(qa, ck, cv, local, window=window,
                                       lse=lse)
        part = torch.cat([o.reshape(b, -1, d), lse[..., None]], dim=-1)
        if split:       # (n B, nh_local, d + 1): slice r's, my heads
            part = sh.all_to_all(part, ax, 1, 0)
        else:           # (n B, nh, d + 1): every slice's, every head
            part = sh.all_gather(part, ax, dim=0)
        part = part.reshape((-1, b, 1) + tuple(part.shape[1:]))
        return attn.merge_partials(part[..., :d], part[:, :, 0, :, d]
                                   ).to(q.dtype)

    def shard_kv_heads(self, t: torch.Tensor, axis: int) -> torch.Tensor:
        """The KV heads this rank's layout holds, along ``axis`` of a cache
        tensor ``t`` that holds them all (the heads its query heads read
        where ``kv_heads`` is replicated and ``heads`` split)."""
        if self._kv_sel is not None:
            sel = torch.tensor(self._kv_sel, device=t.device)
            return t.index_select(axis, sel)
        lo = self.sharder.index(self._kv_axes()) * self.n_kv_local
        return t.narrow(axis, lo, self.n_kv_local)

    def _kv_axes(self) -> Axes:
        c = self.cfg
        if not c.n_kv_heads:
            return None
        return self._axes_of(("embed", "kv_heads"), (c.d_model, c.n_kv_heads))

    def _axes_of(self, names, shape, dim: int = 1) -> Axes:
        """The mesh axes ``resolve`` splits dimension ``dim`` over (heads
        given as head counts); None when it is whole on every rank."""
        spec = self.sharder.spec(names, shape)
        ax = spec[dim] if spec else None
        return ax if self.sharder.size(ax) > 1 else None

    def init(self, seed: int = 0,
             generator: Optional[torch.Generator] = None) -> Dict:
        """Random params on the model's device from a seeded generator;
        under a mesh, this rank's local params, drawn leaf by leaf with
        the unsplit init's numbers."""
        gen = generator
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        local = self._local_leaf if self.sharder.mesh is not None else None
        return init_params(self._schema, gen, self.dtype, self.device,
                           local=local)

    def param_specs(self) -> Dict:
        return schema_specs(self._schema)

    def param_shapes(self) -> Dict:
        return schema_shapes(self._schema)

    def param_count(self) -> int:
        return param_count(self._schema)

    # ------------------------------------------------------------------ #
    # embedding / logits
    # ------------------------------------------------------------------ #
    def embed(self, params: Dict, tokens: torch.Tensor, sp: Axes = None
              ) -> torch.Tensor:
        """The tokens' embeddings; with the sequence cut over ``sp``, this
        rank's slice of the positions."""
        tok = params["embed"]["tok"]
        if self._vocab_ax is None:
            return tok[self._sp_cut(tokens, sp).long()]
        # vocab-parallel: this rank's rows, zeros elsewhere, then the sum
        # (into this rank's slice of the positions under ``sp``)
        t = tokens.long() - self._vocab_lo
        inside = (t >= 0) & (t < tok.shape[0])
        x = tok[t.clamp(0, tok.shape[0] - 1)]
        x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype,
                                                          device=x.device))
        if sp is not None:
            return self.sharder.reduce_scatter(x, self._vocab_ax, 1)
        return self.sharder.reduce(x, self._vocab_ax)

    def logits(self, params: Dict, x: torch.Tensor, sp: Axes = None
               ) -> torch.Tensor:
        """The padded-vocab logits of ``x``; with the sequence cut over
        ``sp`` (the training path), of this rank's slice of the positions:
        where the vocab is split, the gathered sequence's columns of this
        rank exchanged for every column of the slice (one all_to_all)."""
        if sp is not None and self._vocab_ax is not None:
            x = self._sp_whole(x, sp)
        else:
            x = self._enter(x, self._vocab_ax)
        if self.cfg.tie_embeddings:
            out = x @ params["embed"]["tok"].T
        else:
            out = x @ params["lm_head"]
        if self._vocab_ax is None:
            return out
        if sp is not None:
            return self.sharder.all_to_all(out, sp, 1, out.ndim - 1)
        # vocab-parallel: this rank's columns of a zero padded-vocab buffer
        full = out.new_zeros(out.shape[:-1] + (self.cfg.padded_vocab,))
        full[..., self._vocab_lo:self._vocab_lo + out.shape[-1]] = out
        return self.sharder.reduce(full, self._vocab_ax)

    def sample_greedy(self, logits: torch.Tensor) -> torch.Tensor:
        """Greedy next token over the un-padded vocab."""
        return torch.argmax(logits[..., :self.cfg.vocab], dim=-1)

    def _out_proj(self, p: Dict, o: torch.Tensor, sp: Axes = None
                  ) -> torch.Tensor:
        """The output projection of attention ``o`` over the whole
        sequence: with the sequence cut over ``sp``, this rank's slice of
        its positions (the partials reduce-scattered where the heads are
        split; the rank's rows of ``o`` projected where they are whole)."""
        o = o.reshape(o.shape[0], o.shape[1], -1)
        if self._heads_ax is None:
            o = self._sp_cut(o, sp) @ p["wo"]
        else:                                   # row-parallel: sum, then bo
            o = self._row_parallel(self._heads_ax, sp)(o, p["wo"])
        if "bo" in p:
            o = o + p["bo"]
        return o


class LM(TensorParallel):
    def __init__(self, cfg: ArchConfig, device: DeviceLike = None,
                 ssd_chunk: int = 128, kv_probe: bool = False,
                 remat: bool = True, sharder: Optional[Sharder] = None,
                 batch_axes: Axes = None,
                 remat_policy: Optional[str] = None):
        if cfg.family not in ("dense", "moe", "vlm") + RECURRENT \
                or cfg.is_encdec:
            raise ValueError(f"LM serves decoder-only families, not "
                             f"{cfg.name} ({cfg.family}; enc-dec: EncDecLM)")
        if cfg.family == "hybrid" and cfg.n_layers % cfg.hybrid_period:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} trunk layers are "
                             f"not whole groups of {cfg.hybrid_period}")
        self.cfg = cfg
        self.ssd_chunk = ssd_chunk
        # per-layer activation checkpointing in ``loss`` while autograd
        # records (the reference's ``remat``); serving never records
        self.remat = remat
        # the reference's ``remat_policy``: "save_block_out" keeps each
        # attention layer's attention and FFN outputs and recomputes the
        # rest (two checkpoints a layer instead of one; the same gradients)
        if remat_policy not in (None, "save_block_out"):
            raise ValueError(f"unknown remat_policy {remat_policy!r}")
        self.remat_policy = remat_policy
        # KV sanitizer probe on the paged attention calls; their (B, nh)
        # maxima since the last ``take_probe``, on the device
        self.kv_probe = kv_probe
        self._probes: List[torch.Tensor] = []
        self.device = resolve_device(device)
        self.dtype = dtype_of(cfg.dtype)
        self.norm = make_norm(cfg.norm)
        self._schema = self._build_schema()
        self.sharder = sharder or Sharder()
        # mesh axes the caller split the batch rows over (the steps set it)
        self.batch_axes = batch_axes
        self._tp_layout()

    def _queue_share(self, counts: torch.Tensor):
        """For the MoE under a batch split over ``batch_axes``: (the pairs
        per expert of the row shards before this rank's, the number of row
        shards), from one all_reduce of a zero-filled (shards, E) table."""
        ax = self.batch_axes
        n, i = self.sharder.size(ax), self.sharder.index(ax)
        table = counts.new_zeros((n, counts.shape[0]))
        table[i] = counts
        table = self.sharder.reduce(table, ax)
        return table[:i].sum(dim=0), n

    # ------------------------------------------------------------------ #
    # schema / params
    # ------------------------------------------------------------------ #
    def _attn_schema(self, in_dim: Optional[int] = None) -> Dict:
        c = self.cfg
        d_in = in_dim or c.d_model
        s = {
            "wq": ParamDef((d_in, c.n_heads * c.hd), ("embed", "heads")),
            "wk": ParamDef((d_in, c.n_kv_heads * c.hd),
                           ("embed", "kv_heads")),
            "wv": ParamDef((d_in, c.n_kv_heads * c.hd),
                           ("embed", "kv_heads")),
            "wo": ParamDef((c.n_heads * c.hd, c.d_model), ("heads", "embed")),
        }
        if c.qkv_bias:
            s["bq"] = ParamDef((c.n_heads * c.hd,), ("heads",), "zeros")
            s["bk"] = ParamDef((c.n_kv_heads * c.hd,), ("kv_heads",), "zeros")
            s["bv"] = ParamDef((c.n_kv_heads * c.hd,), ("kv_heads",), "zeros")
        if c.o_bias:
            s["bo"] = ParamDef((c.d_model,), ("embed",), "zeros")
        return s

    def _dense_layer_schema(self) -> Dict:
        c = self.cfg
        layer = {
            "ln_attn": norm_schema(c.norm, c.d_model),
            "attn": self._attn_schema(),
            "ln_mlp": norm_schema(c.norm, c.d_model),
        }
        if c.n_experts > 0:
            layer["moe"] = moe_mod.moe_schema(c.d_model, c.d_ff, c.n_experts,
                                              c.gated_ffn)
        else:
            layer["mlp"] = ffn_mod.ffn_schema(c.d_model, c.d_ff, c.gated_ffn,
                                              c.mlp_bias)
        return layer

    def _mamba_layer_schema(self) -> Dict:
        c = self.cfg
        return {
            "ln": norm_schema(c.norm, c.d_model),
            "mixer": ssm_mod.mamba2_schema(c.d_model, c.d_inner, c.ssm_state,
                                           c.ssm_heads, c.conv_width),
        }

    def _shared_block_schema(self) -> Dict:
        """Zamba2 shared transformer block: attention over concat(x, x0)."""
        c = self.cfg
        return {
            "ln_attn": norm_schema(c.norm, 2 * c.d_model),
            "attn": self._attn_schema(in_dim=2 * c.d_model),
            "ln_mlp": norm_schema(c.norm, c.d_model),
            "mlp": ffn_mod.ffn_schema(c.d_model, c.d_ff, c.gated_ffn,
                                      c.mlp_bias),
        }

    def _build_schema(self) -> Dict:
        c = self.cfg
        s = {
            "embed": {"tok": ParamDef((c.padded_vocab, c.d_model),
                                      ("vocab", "embed"))},
            "final_norm": norm_schema(c.norm, c.d_model),
        }
        if c.family in RECURRENT:
            s["layers"] = stack_schema(self._mamba_layer_schema(), c.n_layers)
            if c.family == "hybrid":
                s["shared"] = self._shared_block_schema()
        else:
            s["layers"] = stack_schema(self._dense_layer_schema(), c.n_layers)
        if not c.tie_embeddings:
            s["lm_head"] = ParamDef((c.d_model, c.padded_vocab),
                                    ("embed", "vocab"))
        return s

    # ------------------------------------------------------------------ #
    # attention layer bodies
    # ------------------------------------------------------------------ #
    def _qkv(self, p: Dict, x: torch.Tensor, positions: torch.Tensor,
             sp: Axes = None):
        """Projections and rotary positions: (3, B, S) streams under
        M-RoPE; otherwise (B, S) positions (the first stream of (3, B, S)
        ones, as the reference takes them). ``sp``: ``x`` was gathered
        over it (``_enter``)."""
        c = self.cfg
        x = self._enter(x, self._heads_ax, sp)
        q = x @ p["wq"]
        k = x @ p["wk"]
        v = x @ p["wv"]
        if "bq" in p:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        b, s = x.shape[0], x.shape[1]
        q = q.reshape(b, s, self.n_heads_local, c.hd)
        k = k.reshape(b, s, self.n_kv_local, c.hd)
        v = v.reshape(b, s, self.n_kv_local, c.hd)
        if c.m_rope:
            q = apply_m_rope(q, positions, c.rope_theta, c.mrope_sections)
            k = apply_m_rope(k, positions, c.rope_theta, c.mrope_sections)
        else:
            pos2 = positions[0] if positions.ndim == 3 else positions
            q = apply_rope(q, pos2, c.rope_theta)
            k = apply_rope(k, pos2, c.rope_theta)
        return q.contiguous(), k.contiguous(), v.contiguous()

    def _positions(self, q_pos: torch.Tensor) -> torch.Tensor:
        """(B, S) positions as ``_qkv`` takes them: broadcast to three
        identical streams under M-RoPE (text tokens)."""
        if self.cfg.m_rope:
            return q_pos[None].expand((3,) + tuple(q_pos.shape))
        return q_pos

    def _attn_full(self, p: Dict, x: torch.Tensor, positions,
                   sp: Axes = None):
        """Full-sequence causal attention of the normed ``x`` (the whole
        sequence); returns (out, k, v), ``out`` this rank's slice of the
        positions where the sequence is cut over ``sp``."""
        q, k, v = self._qkv(p, x, positions, sp)
        o = kops.flash_attention(q, self._attn_kv(k), self._attn_kv(v),
                                 causal=True, window=self.cfg.swa_window)
        return self._out_proj(p, o, sp), k, v

    def _probed(self, out):
        """An attention call's output; with the probe armed the call also
        returned its (B, nh) probe, kept on the device for
        ``take_probe``."""
        if not self.kv_probe:
            return out
        o, pmax = out
        self._probes.append(pmax)
        return o

    def take_probe(self) -> Optional[torch.Tensor]:
        """The largest readable |K| / |V| over every probed call since the
        last take (a 0-dim fp32 tensor on the device; None if none ran),
        and clear the record."""
        if not self._probes:
            return None
        worst = torch.cat([p.reshape(-1) for p in self._probes]).amax()
        self._probes = []
        return worst

    def _attn_decode_paged(self, p: Dict, x: torch.Tensor, pos, ck, cv,
                           block_tbl):
        """One-token attention against this layer's block pool: write the
        token through the block table (in place), attend over the pages."""
        q, k, v = self._qkv(p, x, self._positions(pos[:, None]))
        attn.cache_write_token_paged(ck, cv, k, v, pos, block_tbl)
        o = self._probed(kops.decode_attention_paged(
            q, ck, cv, block_tbl, pos, window=self.cfg.swa_window,
            probe=self.kv_probe))
        return self._out_proj(p, o)

    def _attn_decode(self, p: Dict, x: torch.Tensor, pos, ck, cv,
                     key: str = "k"):
        """One-token attention against this layer's contiguous cache (the
        leaf ``key``): write the token at ``pos`` (clamped to the row end,
        in place), attend the row's keys up to ``pos``
        (``_cached_attention``: on a leaf cut by sequence, the slices'
        partials merged over the ranks)."""
        q, k, v = self._qkv(p, x, self._positions(pos[:, None]))
        return self._out_proj(p, self._cached_attention(
            q, k, v, pos, ck, cv, window=self.cfg.swa_window, key=key))

    def _attn_decode_ring(self, p: Dict, x: torch.Tensor, pos, ck, cv,
                          slot_pos):
        """One-token attention against this layer's ring cache: write the
        token at slot ``pos % S_alloc`` (recording it in ``slot_pos``, in
        place), attend every slot the ring holds (the window is in its
        size)."""
        q, k, v = self._qkv(p, x, self._positions(pos[:, None]))
        if not self._kv_cut("k"):
            attn.cache_write_token_ring(ck, cv, k, v, pos, slot_pos)
            return self._out_proj(p, kops.decode_attention_ring(
                q, self._attn_kv(ck), self._attn_kv(cv), pos))
        # cut by sequence: the rank holding the slot writes it; the visible
        # slots [0, min(pos, S_alloc - 1)] at the local position
        lo = self._whole_length(ck.shape[1])[0]
        attn.cache_write_token_ring_slice(ck, cv, self._token_heads(k),
                                          self._token_heads(v), pos,
                                          slot_pos, lo)
        top = torch.clamp(pos, max=slot_pos.shape[0] - 1)
        return self._out_proj(p, self._split_attention(q, ck, cv, top - lo,
                                                       every_head=True))

    def _mlp_or_moe(self, p: Dict, x: torch.Tensor, sp: Axes = None
                    ) -> torch.Tensor:
        """The FFN or MoE sub-block, without the residual. With the
        sequence cut over ``sp`` (``x`` this rank's slice): the MoE routes
        the gathered sequence (every token competes for capacity, as
        unsplit) and its combine is reduce-scattered where the experts'
        FFN is split, sliced where it is whole; the FFN as
        ``_ffn_block``."""
        c = self.cfg
        if c.n_experts == 0:
            return self._ffn_block(p["mlp"], x, p["ln_mlp"], sp)
        h = self._enter(self.norm(self._sp_whole(x, sp), p["ln_mlp"]),
                        self._ffn_ax, sp)
        share = (self._queue_share
                 if self.sharder.size(self.batch_axes) > 1 else None)
        out, _, _ = moe_mod.moe_apply(
            p["moe"], h, c.moe_top_k, c.act, c.gated_ffn,
            reduce=self._reduce(self._ffn_ax, sp=sp), queue_share=share)
        return out if self._ffn_ax is not None else self._sp_cut(out, sp)

    def _mlp_or_moe_aux(self, p: Dict, x: torch.Tensor,
                        aux_tokens: Optional[int] = None, sp: Axes = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The training path's FFN sub-block: (``_mlp_or_moe``'s output,
        the MoE layer's load-balancing loss; 0 for a dense layer). With
        ``aux_tokens`` (a mesh step: the microbatch's tokens over every
        row shard) the loss is this rank's share of the whole
        microbatch's (``moe.moe_aux_shard``: its rows' router
        probabilities against the first choices of every row). With the
        sequence cut over ``sp`` the router sees the gathered sequence,
        as in ``_mlp_or_moe``, and the loss covers every position."""
        c = self.cfg
        if c.n_experts == 0:
            return (self._mlp_or_moe(p, x, sp),
                    torch.zeros((), dtype=torch.float32, device=x.device))
        split = self.sharder.size(self.batch_axes) > 1
        h = self._enter(self.norm(self._sp_whole(x, sp), p["ln_mlp"]),
                        self._ffn_ax, sp)
        out, probs, idx = moe_mod.moe_apply(
            p["moe"], h, c.moe_top_k, c.act, c.gated_ffn,
            reduce=self._reduce(self._ffn_ax, sp=sp),
            queue_share=self._queue_share if split else None)
        if self._ffn_ax is None:
            out = self._sp_cut(out, sp)
        if aux_tokens is None:
            return out, moe_mod.moe_aux(probs, idx)
        return out, moe_mod.moe_aux_shard(
            probs, idx, aux_tokens,
            self._reduce(self.batch_axes) if split else None)

    def _attn_block(self, p: Dict, x: torch.Tensor, positions,
                    sp: Axes = None) -> torch.Tensor:
        """An attention layer's attention sub-block (norm, attention, the
        output projection), without the residual; with the sequence cut
        over ``sp``, ``x`` and the output are this rank's slice."""
        a, _, _ = self._attn_full(
            p["attn"], self.norm(self._sp_whole(x, sp), p["ln_attn"]),
            positions, sp)
        return a

    def _dense_layer_train(self, p: Dict, x: torch.Tensor, positions,
                           aux_tokens: Optional[int] = None,
                           sp: Axes = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One attention layer of ``loss``: (x, its MoE aux loss)."""
        x = x + self._attn_block(p, x, positions, sp)
        m, aux = self._mlp_or_moe_aux(p, x, aux_tokens, sp)
        return x + m, aux

    def _dense_layer_saving(self, p: Dict, x: torch.Tensor, positions,
                            aux_tokens: Optional[int] = None,
                            sp: Axes = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``_dense_layer_train`` under ``remat_policy="save_block_out"``:
        the attention and FFN sub-blocks each rematerialised, their
        outputs (the reference's ``block_out``) kept."""
        x = x + remat(self.remat, self._attn_block, p, x, positions, sp)
        m, aux = remat(self.remat, self._mlp_or_moe_aux, p, x, aux_tokens,
                       sp)
        return x + m, aux

    @staticmethod
    def _layer(params: Dict, i: int) -> Dict:
        """Layer ``i``'s slice of the stacked layer params."""
        def pick(node):
            if isinstance(node, dict):
                return {k: pick(v) for k, v in node.items()}
            return node[i]
        return pick(params["layers"])

    def _dense_layer_chunk(self, p: Dict, x, q_pos, ck, cv, base,
                           block_tbl=None, lens=None, start=None):
        """Chunked-prefill layer body: write the chunk's K/V at
        [base, base+C) — through ``block_tbl`` into a block pool (columns
        past ``lens`` to the trash block), or into a contiguous cache from
        the host-side scalar ``start`` — and attend every query under its
        absolute position (``base``, per row, on the device)."""
        w = self.cfg.swa_window
        h = self.norm(x, p["ln_attn"])
        q, k, v = self._qkv(p["attn"], h, self._positions(q_pos))
        if block_tbl is not None:
            attn.cache_write_chunk_paged(ck, cv, k, v, base, block_tbl,
                                         lens=lens)
            # the probe covers the columns ``lens`` keeps: pad columns
            # write to the trash block, so the tail of a reused block past
            # the prompt's end may still hold poison that no real query
            # reads (the reference probes pad columns too, and raises
            # there: a deliberate difference, ROADMAP.md section C)
            o = self._probed(kops.chunk_attention_paged(
                q, ck, cv, block_tbl, base, window=w, probe=self.kv_probe,
                probe_cols=lens))
        else:
            if lens is not None:
                raise ValueError("column masking requires the paged path")
            attn.cache_write_chunk(ck, cv, k, v, start)
            o = kops.chunk_attention(q, ck, cv, base, window=w)
        x = x + self._out_proj(p["attn"], o)
        return x + self._mlp_or_moe(p, x)

    def _mamba_layer_fwd(self, p: Dict, x: torch.Tensor, sp: Axes = None):
        """A Mamba2 layer over whole prompts: (x, its final state). With
        the sequence cut over ``sp`` the mixer runs on the gathered
        sequence (the conv and the SSD scan see it whole) and ``x`` and
        the output are this rank's slice."""
        c = self.cfg
        h = self._enter(self.norm(self._sp_whole(x, sp), p["ln"]),
                        self._ssm_ax, sp)
        y, st = ssm_mod.mamba2_prefill(
            p["mixer"], h, c.d_inner, c.ssm_state, c.ssm_heads,
            c.ssm_head_dim, chunk=self.ssd_chunk, **self._mixer_tp(sp))
        if self._ssm_ax is None:
            y = self._sp_cut(y, sp)
        return x + y, st

    def _mixer_tp(self, sp: Axes = None) -> Dict:
        """The Mamba2 block's cross-rank sums (none when the mixer is
        whole on every rank): the gated norm's sums of squares and the
        row-parallel ``w_out`` (reduce-scattered into this rank's slice
        of the positions where the sequence is cut over ``sp``). Under
        autograd the first sends the gradient back summed over the ranks:
        each rank's heads use the summed squares."""
        return dict(reduce=self._reduce(self._ssm_ax, grad="sum"),
                    row_parallel=self._row_parallel(self._ssm_ax, sp))

    def _mamba_layer_step(self, p: Dict, x: torch.Tensor, conv: torch.Tensor,
                          ssd: torch.Tensor) -> torch.Tensor:
        """One-token Mamba2 layer; writes the layer's new ``conv`` / ``ssd``
        state into the cache slices it was given, in place."""
        c = self.cfg
        h = self.norm(x, p["ln"])
        y, st = ssm_mod.mamba2_step(
            p["mixer"], h, ssm_mod.SSMState(conv, ssd), c.d_inner,
            c.ssm_state, c.ssm_heads, c.ssm_head_dim, **self._mixer_tp())
        conv.copy_(st.conv)
        ssd.copy_(st.ssd)
        return x + y

    def _shared_block_fwd(self, p: Dict, x, x0, positions, sp: Axes = None):
        """Zamba2 shared block on concat(x, x0); returns (x, k, v). With
        the sequence cut over ``sp``, ``x`` and ``x0`` are this rank's
        slice and the concatenation is gathered once."""
        h = self.norm(self._sp_whole(torch.cat([x, x0], dim=-1), sp),
                      p["ln_attn"])
        a, k, v = self._attn_full(p["attn"], h, positions, sp)
        x = x + a
        return x + self._ffn_block(p["mlp"], x, p["ln_mlp"], sp), k, v

    def _shared_block_decode(self, p: Dict, x, x0, pos, ck, cv):
        h = self.norm(torch.cat([x, x0], dim=-1), p["ln_attn"])
        x = x + self._attn_decode(p["attn"], h, pos, ck, cv, key="ak")
        return x + self._ffn_block(p["mlp"], x, p["ln_mlp"])

    def _run_trunk_full(self, params: Dict, x: torch.Tensor, positions,
                        collect_kv: bool = True,
                        aux_tokens: Optional[int] = None, sp: Axes = None
                        ) -> Tuple[torch.Tensor, Dict]:
        """Full-sequence pass over all layers (prefill / train). Returns (x,
        the stacked per-layer state): ``k``/``v`` for the attention families;
        ``conv``/``ssd`` for SSM and hybrid, plus the hybrid's shared-block
        K/V ``ak``/``av``, one entry per application (it fires after every
        ``hybrid_period`` trunk layers, as the reference's grouped scan
        does). With ``collect_kv=False`` (``loss``) it keeps no state and
        returns ``{"aux": the MoE load-balancing losses summed over the
        layers}`` (0 without experts; ``aux_tokens`` as
        ``_mlp_or_moe_aux`` takes it), each layer under ``remat``. With
        the sequence cut over ``sp``, ``x`` in and out is this rank's
        slice of the positions; the state covers the whole sequence."""
        c = self.cfg
        if not collect_kv:
            return self._run_trunk_train(params, x, positions, aux_tokens,
                                         sp)
        state: Dict[str, list] = {}
        if c.family in RECURRENT:
            fire = c.shared_attn_positions()
            x0 = x
            for i in range(c.n_layers):
                x, st = self._mamba_layer_fwd(self._layer(params, i), x, sp)
                state.setdefault("conv", []).append(st.conv)
                state.setdefault("ssd", []).append(st.ssd)
                if i in fire:
                    x, k, v = self._shared_block_fwd(params["shared"], x, x0,
                                                     positions, sp)
                    state.setdefault("ak", []).append(k)
                    state.setdefault("av", []).append(v)
        else:
            for i in range(c.n_layers):
                p = self._layer(params, i)
                h = self.norm(self._sp_whole(x, sp), p["ln_attn"])
                a, k, v = self._attn_full(p["attn"], h, positions, sp)
                x = x + a
                x = x + self._mlp_or_moe(p, x, sp)
                state.setdefault("k", []).append(k)
                state.setdefault("v", []).append(v)
        return x, {key: torch.stack(vals) for key, vals in state.items()}

    def _run_trunk_train(self, params: Dict, x: torch.Tensor, positions,
                         aux_tokens: Optional[int] = None, sp: Axes = None
                         ) -> Tuple[torch.Tensor, Dict]:
        c = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        layers = unbind_layers(params["layers"])
        if c.family in RECURRENT:
            fire = c.shared_attn_positions()
            x0 = x
            for i, p in enumerate(layers):
                x = remat(self.remat,
                          lambda pl, h: self._mamba_layer_fwd(pl, h, sp)[0],
                          p, x)
                if i in fire:
                    x = remat(self.remat,
                              lambda pl, h, h0: self._shared_block_fwd(
                                  pl, h, h0, positions, sp)[0],
                              params["shared"], x, x0)
            return x, {"aux": aux}
        for p in layers:
            if self.remat_policy == "save_block_out":
                x, a = self._dense_layer_saving(p, x, positions, aux_tokens,
                                                sp)
            else:
                x, a = remat(self.remat, self._dense_layer_train, p, x,
                             positions, aux_tokens, sp)
            aux = aux + a
        return x, {"aux": aux}

    def _last(self, params: Dict, x: torch.Tensor,
              last_pos: Optional[torch.Tensor], sp: Axes = None
              ) -> torch.Tensor:
        """The logits at ``last_pos`` (default: the last position) of the
        trunk's output ``x``; under ``sp``, this rank's slice (the rows'
        hidden states taken from the ranks that hold them, then normed)."""
        if sp is None:
            last = self._sp_last(self.norm(x, params["final_norm"]),
                                 last_pos, None)
        else:
            last = self.norm(self._sp_last(x, last_pos, sp),
                             params["final_norm"])
        return self.logits(params, last)[:, 0, :]

    # ------------------------------------------------------------------ #
    # public: loss / caches / prefill / decode
    # ------------------------------------------------------------------ #
    def loss(self, params: Dict, batch: Dict) -> torch.Tensor:
        """Causal-LM cross entropy (the mean over ``mask``) plus, with
        experts, 0.01 x the layers' summed load-balancing loss / n_layers:
        the reference's ``LM.loss``. ``batch``: ``tokens`` (or ``embeds``
        (B, S, d_model) for the vision frontend), ``targets``, optional
        ``mask`` and ``positions`` (default arange; (3, B, S) identical
        streams under M-RoPE). On the card attention trains through the
        flash forward and backward kernels and the SSD scan through its
        forward and backward kernels."""
        c = self.cfg
        logits, aux = self._train_logits(params, batch)
        loss = lm_cross_entropy(logits, batch["targets"], batch.get("mask"),
                                c.vocab)
        if c.n_experts > 0:
            loss = loss + 0.01 * aux["aux"] / max(1, c.n_layers)
        return loss

    def loss_shard(self, params: Dict, batch: Dict, count: float,
                   tokens: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """This rank's share of a microbatch's ``loss`` in a mesh step
        (``launch/train_mesh.py``), whose rows ``batch`` holds: the summed
        NLL of its rows over ``count`` (the microbatch's mask sum over
        every row, at least 1) plus its share of the MoE loss
        (``_mlp_or_moe_aux`` over the microbatch's ``tokens``). Returns
        (the objective to differentiate, its value): the values summed
        over the row shards are the microbatch's ``loss``; the objective
        leaves the MoE loss to one rank of the expert FFN's split, since
        the router's gradient is summed over those ranks. With the
        sequence cut over the ``seq`` rule's axes (``train_seq_axes``)
        the NLL is over this rank's slice of the positions, one rank of
        those axes adds the MoE loss, and the values summed over the row
        shards and those axes are the microbatch's ``loss``."""
        c = self.cfg
        sp = self.train_seq_axes(batch)
        logits, aux = self._train_logits(params, batch, tokens, sp)
        nll = self._nll_sum(logits, batch, sp) / count
        if c.n_experts == 0:
            return nll, nll.detach()
        moe = 0.01 * aux["aux"] / max(1, c.n_layers)
        # the other ranks add it times 0: every rank's backward graph, and
        # so the order of its collectives, is the same
        if sp is not None:
            obj = nll + moe * float(self.sharder.index(sp) == 0)
            return obj, obj.detach()
        owner = self._ffn_ax is None or self.sharder.index(self._ffn_ax) == 0
        return nll + moe * float(owner), (nll + moe).detach()

    def _train_logits(self, params: Dict, batch: Dict,
                      aux_tokens: Optional[int] = None, sp: Axes = None
                      ) -> Tuple[torch.Tensor, Dict]:
        """``loss``'s forward up to the logits: (logits, the trunk's
        ``aux``); with the sequence cut over ``sp``, the logits of this
        rank's slice of the positions (the M-RoPE positions stay whole:
        attention runs on the gathered sequence)."""
        c = self.cfg
        if "embeds" in batch:
            x = self._sp_cut(batch["embeds"], sp).to(self.dtype)
        else:
            x = self.embed(params, batch["tokens"], sp)
        self.residual_shape = tuple(x.shape)
        positions = batch.get("positions")
        if positions is None:
            b, s = batch["targets"].shape
            positions = torch.arange(s, dtype=torch.int32, device=x.device
                                     )[None].expand(b, s)
            if c.m_rope:
                positions = positions[None].expand(3, b, s)
        x, aux = self._run_trunk_full(params, x, positions, collect_kv=False,
                                      aux_tokens=aux_tokens, sp=sp)
        x = self.norm(x, params["final_norm"])
        return self.logits(params, x, sp), aux

    def init_cache(self, batch: int, max_len: int, kv_layout: str = "contig",
                   n_blocks: int = 0, block_size: int = 16,
                   ring: bool = False) -> Dict:
        """Zero cache with per-row positions ``pos`` (batch,).

        ``kv_layout="contig"``: each row owns a linear ``max_len`` slice,
        ``k``/``v`` (L, batch, max_len, nkv, d); sliding windows apply by
        masking. With ``ring=True`` a sliding-window config gets the
        reference's ring instead: ``min(max_len, swa_window)`` slots per
        row and ``slot_pos`` (S_alloc,), -1 while a slot is empty (not an
        engine path: the engine names ``ring=False``).

        ``kv_layout="paged"``: a pool of ``n_blocks`` ``block_size``-token
        blocks (L, n_blocks, block, nkv, d) shared by all rows, and a
        per-row ``block_tbl`` (batch, ceil(max_len/block)) whose entry 0
        is the reserved trash block.

        SSM / hybrid (contig only; paged raises ``ValueError``): ``conv``
        (L, batch, K-1, d_inner+2N) in the model dtype, ``ssd`` (L, batch,
        nheads, head_dim, N) fp32, and for the hybrid ``ak``/``av``
        (n_apps, batch, max_len, nkv, d), one per shared-block
        application. Under tensor parallelism every shape is this rank's:
        its KV heads, or, on a leaf cut by sequence (``cache_seq``, where
        the axes divide its length), every KV head of its slice of the
        positions (``seq_slice``; a ring's ``slot_pos`` stays whole); its
        SSD heads (``d_inner`` and ``nheads`` local, N whole). Each K/V
        leaf's length goes to ``kv_lengths``."""
        c = self.cfg
        dev = self.device
        if kv_layout not in ("contig", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        if kv_layout == "paged" and c.family in RECURRENT:
            raise ValueError("paged KV requires attention caches")
        cache = {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}
        if c.family in RECURRENT:
            nh = self.ssm_heads_local
            cache["conv"] = torch.zeros(
                (c.n_layers, batch, c.conv_width - 1,
                 nh * c.ssm_head_dim + 2 * c.ssm_state), dtype=self.dtype,
                device=dev)
            cache["ssd"] = torch.zeros(
                (c.n_layers, batch, nh, c.ssm_head_dim, c.ssm_state),
                dtype=torch.float32, device=dev)
            if c.family == "hybrid":
                shape = (len(c.shared_attn_positions()), batch,
                         self.seq_slice(max_len)[1],
                         self.kv_heads_of(max_len), c.hd)
                cache["ak"] = torch.zeros(shape, dtype=self.dtype, device=dev)
                cache["av"] = torch.zeros(shape, dtype=self.dtype, device=dev)
                self.kv_lengths = {"ak": max_len, "av": max_len}
            return cache
        if kv_layout == "contig":
            ring = bool(ring and c.swa_window)
            s_alloc = min(max_len, c.swa_window) if ring else max_len
            shape = (c.n_layers, batch, self.seq_slice(s_alloc)[1],
                     self.kv_heads_of(s_alloc), c.hd)
            self.kv_lengths = {"k": s_alloc, "v": s_alloc}
            if ring:
                cache["slot_pos"] = torch.full((s_alloc,), -1,
                                               dtype=torch.int32, device=dev)
        else:
            if self._seq_ax is not None:
                raise ValueError("a paged cache is not cut by sequence "
                                 "(cache_seq)")
            max_blocks = -(-max_len // block_size)
            if n_blocks <= 0:
                n_blocks = batch * max_blocks + 1       # capacity == contig
            shape = (c.n_layers, n_blocks, block_size, self.n_kv_local,
                     c.hd)
            cache["block_tbl"] = torch.zeros((batch, max_blocks),
                                             dtype=torch.int32, device=dev)
        cache["k"] = torch.zeros(shape, dtype=self.dtype, device=dev)
        cache["v"] = torch.zeros(shape, dtype=self.dtype, device=dev)
        return cache

    def cache_specs(self) -> Dict:
        """Logical sharding names for cache entries (the reference's tree;
        ``pos`` is per row here)."""
        c = self.cfg
        specs: Dict = {"pos": ()}
        if c.family in RECURRENT:
            specs["conv"] = ("layers", "batch", None, "ssm_inner")
            specs["ssd"] = ("layers", "batch", "ssm_heads", None, None)
            if c.family == "hybrid":
                specs["ak"] = ("stack", "batch", "cache_seq",
                               "kv_heads", "head_dim")
                specs["av"] = specs["ak"]
        else:
            specs["k"] = ("layers", "batch", "cache_seq", "kv_heads",
                          "head_dim")
            specs["v"] = specs["k"]
            if c.swa_window:
                specs["slot_pos"] = (None,)
        return specs

    def prefill_kv(self, params: Dict, inputs: Dict,
                   last_pos: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict]:
        """Prompt ``inputs`` -> (logits at ``last_pos`` (default: last column),
        the stacked per-layer state the prompt leaves, as the reference's
        ``aux``: ``k``/``v`` (L,B,S,nkv,d) for the attention families;
        ``conv``/``ssd`` (L,B,...) and, hybrid, ``ak``/``av``
        (n_apps,B,S,nkv,d)). Right-padded rows are exact for attention
        under causal masking; recurrent state runs through pad columns,
        so the engine gives those families exact-length groups.

        ``inputs``: ``tokens`` (B, S), or the stubbed frontend's ``embeds``
        (B, S, d_model); ``positions`` ((3, B, S) under M-RoPE, else (B,
        S)) default to 0..S-1 in every stream. Under the ``seq`` rule
        (``_seq_axes``) the residual stream is this rank's slice of the
        positions (module docstring)."""
        prompt = inputs["embeds"] if "embeds" in inputs else inputs["tokens"]
        b, s = prompt.shape[0], prompt.shape[1]
        sp = self._seq_axes(b, s)
        if "embeds" in inputs:
            x = self._sp_cut(inputs["embeds"], sp).to(self.dtype)
        else:
            x = self.embed(params, inputs["tokens"], sp)
        positions = inputs.get("positions")
        if positions is None:
            positions = self._positions(
                torch.arange(s, device=x.device)[None].expand(b, s))
        x, aux = self._run_trunk_full(params, x, positions, sp=sp)
        self.residual_shape = tuple(x.shape)
        return self._last(params, x, last_pos, sp), aux

    def prefill(self, params: Dict, inputs: Dict,
                last_pos: Optional[torch.Tensor] = None,
                cache: Optional[Dict] = None, max_len: Optional[int] = None,
                ring: bool = False) -> Tuple[torch.Tensor, Dict]:
        """Prompt -> (last-position logits (B, Vpad), cache). ``inputs`` as
        ``prefill_kv`` takes them. With a paged ``cache`` (from
        ``init_cache`` with allocated tables) the prompt K/V are written
        through its block tables, in place; otherwise into a fresh
        contiguous cache of ``max_len`` (default: the prompt length)
        positions per row (SSM / hybrid: the final recurrent state, and the
        hybrid's shared-block K/V). ``ring=True`` gives a sliding-window
        config the ring cache, holding the prompt's last ``S_alloc``
        positions (position p at slot p % S_alloc) when it is longer."""
        prompt = inputs["embeds"] if "embeds" in inputs else inputs["tokens"]
        b, s = prompt.shape[0], prompt.shape[1]
        logits, aux = self.prefill_kv(params, inputs, last_pos)
        if cache is not None and "block_tbl" in cache:
            attn.cache_write_prefill_paged(cache["k"], cache["v"], aux["k"],
                                           aux["v"], cache["block_tbl"])
        else:
            length = max_len or s
            cache = self.init_cache(b, length, ring=ring)
            for key, val in aux.items():
                if key in STATE_KEYS:           # recurrent state: whole
                    cache[key].copy_(val)
                elif "slot_pos" in cache:       # K/V in the ring's layout
                    full, cache["slot_pos"] = attn.ring_prefill_layout(
                        val.to(self.dtype), cache["slot_pos"].shape[0])
                    cache[key] = self.kv_to_cache(full)
                elif self._seq_ax is not None:  # K/V cut by sequence
                    cache[key] = self.kv_to_cache(val.to(self.dtype), length)
                else:                           # K/V: the prompt's positions
                    cache[key][:, :, :s] = val.to(self.dtype)
        cache["pos"] = torch.full_like(cache["pos"], s)
        return logits, cache

    def prefill_chunk(self, params: Dict, cache: Dict, tokens: torch.Tensor,
                      base: IntLike, last_pos: Optional[torch.Tensor] = None,
                      block_tbl: Optional[torch.Tensor] = None,
                      lens: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict]:
        """Incremental prefill: a C-token chunk per row at absolute
        positions [base, base+C); queries attend the whole prefix under
        per-position masks, so consecutive chunks equal one full prefill.

        Two destinations, as the engine uses them: with ``block_tbl`` the
        ENGINE's pool, each of the B rows written through its own table row
        (engine-direct mode; ``lens`` masks columns >= lens into the trash
        block; the per-slot ``pos`` update is the caller's); without it a
        contiguous cache (one scalar ``base`` for every row), whose ``pos``
        becomes ``base + C``. Returns (logits at ``last_pos`` (default: last
        chunk column), the cache, updated in place)."""
        if self.cfg.family in RECURRENT:
            raise ValueError("chunked prefill requires attention caches "
                             f"({self.cfg.family} carries recurrent state)")
        if "slot_pos" in cache:
            raise ValueError("chunked prefill needs a linear cache, not a "
                             "ring")
        if self._seq_ax is not None:
            raise ValueError("chunked prefill needs whole sequences, not a "
                             "cache cut by sequence (cache_seq)")
        x = self.embed(params, tokens)
        b, cl = tokens.shape
        direct = block_tbl is not None
        base_t = torch.as_tensor(base, device=x.device).long()
        if not direct and ("block_tbl" in cache or base_t.ndim != 0):
            raise ValueError("without block_tbl the cache must be contiguous "
                             "and the base one scalar")
        bases = base_t.expand(b) if base_t.ndim == 0 else base_t
        q_pos = bases[:, None] + torch.arange(cl, device=x.device)[None, :]
        start = None if direct else int(base)
        for i in range(self.cfg.n_layers):
            x = self._dense_layer_chunk(self._layer(params, i), x, q_pos,
                                        cache["k"][i], cache["v"][i], bases,
                                        block_tbl=block_tbl, lens=lens,
                                        start=start)
        if not direct:
            cache["pos"] = torch.full_like(cache["pos"], int(base) + cl)
        return self._last(params, x, last_pos), cache

    def prefill_suffix(self, params: Dict, cache: Dict, tokens: torch.Tensor,
                       bases: torch.Tensor, block_tbl: torch.Tensor,
                       lens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """Prefix-sharing suffix prefill: each row's first ``bases[i]``
        tokens are already resident in the paged pool (shared-prefix blocks
        mapped through ``block_tbl``), so only the divergent suffix is
        computed: the rows' queries sit at [bases, bases + C) and attend
        the shared prefix through the table; the suffix K/V land from each
        row's own boundary, columns past ``lens`` in the trash block (and,
        with the probe armed, only the real columns are probed). Prefix
        activations are causally independent of the suffix, so this
        reproduces a full prefill's K/V and logits. Attention families on
        the paged pool only. Returns (logits at each row's last real
        suffix token, the cache, updated in place; the per-slot ``pos`` is
        the caller's)."""
        if self.cfg.family in RECURRENT:
            raise ValueError("suffix prefill requires attention-family KV "
                             "caches")
        return self.prefill_chunk(params, cache, tokens, bases,
                                  last_pos=lens - 1, block_tbl=block_tbl,
                                  lens=lens)

    def decode_step(self, params: Dict, cache: Dict, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict]:
        """One new token for every row. tokens: (B, 1), or (B, 1, d_model)
        embeds under a stubbed frontend. Writes the tokens' K/V (paged,
        contiguous or ring) or the layers' new recurrent state into the
        cache in place; returns (logits (B,1,Vpad), cache with ``pos``
        advanced)."""
        x = (tokens.to(self.dtype) if tokens.ndim == 3
             else self.embed(params, tokens))
        if self.cfg.family in RECURRENT:
            x = self._decode_recurrent(params, cache, x, cache["pos"])
        else:
            x = self._decode_attention(params, cache, x, cache["pos"])
        x = self.norm(x, params["final_norm"])
        cache["pos"] = cache["pos"] + 1
        return self.logits(params, x), cache

    def _decode_attention(self, params: Dict, cache: Dict, x: torch.Tensor,
                          pos: torch.Tensor) -> torch.Tensor:
        """Dense / MoE / VLM layers, each writing its token's K/V through
        the block tables (paged), at ``pos`` (contiguous) or at slot ``pos %
        S_alloc`` (ring)."""
        tbl = cache.get("block_tbl")
        slot_pos = cache.get("slot_pos")
        for i in range(self.cfg.n_layers):
            p = self._layer(params, i)
            ck, cv = cache["k"][i], cache["v"][i]
            if tbl is None and slot_pos is None:
                x = self._dense_layer_decode(p, x, pos, ck, cv)
                continue
            h = self.norm(x, p["ln_attn"])
            if tbl is not None:
                a = self._attn_decode_paged(p["attn"], h, pos, ck, cv, tbl)
            else:
                a = self._attn_decode_ring(p["attn"], h, pos, ck, cv,
                                           slot_pos)
            x = x + a
            x = x + self._mlp_or_moe(p, x)
        return x

    def _dense_layer_decode(self, p: Dict, x: torch.Tensor, pos, ck, cv
                            ) -> torch.Tensor:
        """One dense / MoE / VLM layer of a decode step against its
        contiguous cache slice ``ck`` / ``cv`` (B, S, nkv, d), written in
        place at ``pos`` (B,): the norm, attention, the residual, then the
        FFN or MoE sub-block. The unsplit decode and each stage of the
        pipeline-parallel step (``launch/pipeline.py``) run it."""
        x = x + self._attn_decode(p["attn"], self.norm(x, p["ln_attn"]),
                                  pos, ck, cv)
        return x + self._mlp_or_moe(p, x)

    def _decode_recurrent(self, params: Dict, cache: Dict, x: torch.Tensor,
                          pos: torch.Tensor) -> torch.Tensor:
        """Mamba2 steps over the trunk, each layer's ``conv``/``ssd`` state
        updated in place; the hybrid's shared block, after each group,
        writes and attends its application's contiguous ``ak``/``av`` at
        ``pos``."""
        fire = self.cfg.shared_attn_positions()
        x0 = x
        for i in range(self.cfg.n_layers):
            x = self._mamba_layer_step(self._layer(params, i), x,
                                       cache["conv"][i], cache["ssd"][i])
            if i in fire:
                g = fire.index(i)
                x = self._shared_block_decode(params["shared"], x, x0, pos,
                                              cache["ak"][g], cache["av"][g])
        return x
