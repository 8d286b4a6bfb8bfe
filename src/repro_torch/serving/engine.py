"""Continuous-batching engine on the paged block-KV pool or the contiguous
slot-row cache (port of ``repro/serving/engine.py``).

What carries over from the reference, with the same semantics and stats:

* **Paged, demand-allocated KV** — a pool of fixed-size token blocks
  shared by every slot, a per-slot block table (``serving/kv_blocks.py``),
  a reservation ledger booking each request's worst case while allocating
  only its prefill context, decode-time grow, ``kv_overcommit`` with
  preemption when a grow finds the pool dry (its KV exported
  position-exact and re-attached once capacity frees), bounded skip-ahead
  admission and headroom deferral. The victim is the slot whose
  re-admission ``cluster/recovery.py`` prices cheapest
  (``victim_policy="cost"``, priced off ``placement`` when one is given),
  fewest generated tokens breaking ties; ``"fewest"`` is the legacy rule.
* **Batched, bucketed prefill** — waiting requests are admitted in groups
  of ``prefill_group``, right-padded to a power-of-2 length bucket; the
  stacked prefill K/V is scattered straight into the owning slots' pool
  blocks (pad positions to the trash block).
* **Direct-to-pool chunked prefill** — contexts longer than
  ``prefill_chunk`` prefill chunk by chunk between decode steps, one
  dispatch per pending group, each chunk's K/V written through a snapshot
  of the members' block tables.
* **Masked decode** — dead and pending rows write through trash block 0
  and keep their position frozen.
* **Prefix-sharing KV** (``prefix_share=True``, paged layout) — a
  block-aligned prefix index (``serving/prefix_index.py``) is consulted at
  admission: a request extending a cached prefix maps the shared blocks
  into its table (refcounted, read-only), copies the partially shared
  boundary block on write (deferred to the suffix dispatch when its donor
  is admitted in the same call), and prefills only the divergent suffix
  through ``LM.prefill_suffix`` (per-row bases after the shared prefix).
  Freed blocks keep their content until reallocated, so a hot prefix
  survives its requests; ``hot_prefixes`` / ``warm_prefix`` carry
  shared-prefix payloads through the tensor store so a re-placed pipeline
  warms up instead of recomputing.
* **Legacy admission** (``admission="legacy"``, contiguous layout only) —
  the reference's baseline: one batch-1 exact-length ``LM.prefill`` per
  request, installed into its slot row, never chunked.
* **Contiguous layout** (``kv_layout="contig"``, and what ``"auto"`` picks
  for MoE) — each slot owns a ``max_len`` row of ``(L, max_batch, max_len,
  nkv, d)``; there is no block manager (``self.bm`` is None). A prefill
  group is installed by writing whole slot rows; a chunked group prefills
  into a transient group cache, from which finishers are scattered into
  their slot rows (``stats.chunk_scatters``); every row decodes, dead and
  pending rows writing at their frozen position, which is then restored.
* **Encoder-decoder** (whisper) — contiguous only (``"paged"`` raises):
  the stubbed frontend hands every request ``enc_frames`` = 8 zero frames;
  a prefill group runs the encoder and the decoder prompt and installs
  the self- and cross-attention caches (``k``/``v``, ``ck``/``cv``) into
  the slots' rows; a chunked group first warms its transient cache's
  cross-attention K/V with one encoder pass (``EncDecLM.cross_kv``, one
  warm-up shape per group size, as the reference's jit traces it), then
  runs decoder chunks; legacy admission prefills batch-1.
* **MoE admission** — expert capacity is shared across the flattened
  token stream, so padded or chunked prefill would change which tokens
  are dropped: MoE admits batch-1 at exact length, never chunked, and
  decodes all ``max_batch`` rows with dead rows fed token 0, as the
  reference does, so dead rows take expert capacity the same way.
* **SSM and hybrid** (mamba2, zamba2) — recurrent state runs through pad
  columns, so they admit exact-length groups of ``prefill_group`` (only
  prompts of equal length share a group), are never chunked, and ride the
  contiguous layout (``"auto"`` picks it; ``"paged"`` raises): a group's
  ``conv`` / ``ssd`` state and, hybrid, its shared-block K/V are installed
  as whole slot rows. Every row decodes; a dead row's state changes, which
  is harmless because the next install overwrites it whole.

Where JAX donates the cache into jit'd dispatches, this engine owns one
preallocated pool and every dispatch updates it in place. There is no JIT,
so the retrace counters count distinct dispatch shapes instead, one for
each shape the reference traces anew: ``prefill_retraces`` the prefill,
chunk, suffix and legacy prefill shapes (the bound ``prefill_retraces <=
len(bucket_lens())`` holds as in the reference), ``retraces`` those plus
the decode, install, copy-on-write and warm-up shapes.

* **KV sanitizer** (``kv_sanitize=True`` or ``REPRO_KV_SANITIZE=1``, paged
  layout) — the block manager's shadow ledger, released blocks poisoned
  on the device with ``KV_POISON``, and the device probe, armed as the
  reference arms it: the paged decode and chunk calls return the largest
  readable |K| / |V| of every layer, kept on the device, and the engine
  reads their maximum once per dispatch (the suffix dispatch too), raising
  ``KVSanitizerError`` before the dispatch's tokens are committed when it
  reaches the poison as the pool's dtype stores it (deliberate differences
  from the reference, ROADMAP.md section C: in a bf16 pool the threshold
  is 998,244,352, where the reference's ``< 1e9`` never fires; a chunk or
  suffix probes its real columns, not its pad columns). With the
  sanitizer off nothing is launched or synchronised for it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.cluster.recovery import (preemption_seconds,
                                          recompute_seconds)
from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, device_of, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.models.transformer import RECURRENT, STATE_KEYS
from repro_torch.serving.kv_blocks import (KV_POISON, BlockManager,
                                           KVSanitizerError)
from repro_torch.serving.prefix_index import PrefixIndex
from repro_torch.serving.request import ServeRequest


@dataclasses.dataclass
class EngineStats:
    prefills: int = 0           # requests prefilled (admissions)
    prefill_batches: int = 0    # batched prefill dispatches
    prefill_chunks: int = 0     # chunked-prefill chunk dispatches
    chunk_direct: int = 0       # paged chunks written in-place (no scatter)
    chunk_scatters: int = 0     # contig finisher scatters (transient path)
    decode_steps: int = 0
    tokens_out: int = 0
    retraces: int = 0           # distinct dispatch shapes (prefill+decode)
    prefill_retraces: int = 0   # distinct prefill shapes — bounded by buckets
    alloc_failures: int = 0     # paged admissions refused (backpressure)
    block_grows: int = 0        # blocks allocated on demand mid-decode
    preemptions: int = 0        # slots evicted when a grow found a dry pool
    kv_exports: int = 0         # KV block sets exported
    kv_imports: int = 0         # re-admissions that attached KV (no prefill)
    prefix_hits: int = 0        # admissions that mapped shared-prefix blocks
    prefix_shared_tokens: int = 0   # prefill tokens NOT recomputed
    cow_copies: int = 0         # boundary blocks copied before first write
    prefix_warmups: int = 0     # published prefixes attached from the store
    grow_ahead_skips: int = 0   # boundary crossings served by look-ahead
    admit_deferred: int = 0     # admissions deferred for free-block headroom


@dataclasses.dataclass
class _PendingMember:
    req: ServeRequest
    slot: int
    tokens: np.ndarray
    done: bool = False


@dataclasses.dataclass
class _PendingGroup:
    """Long-context admissions prefilled chunk by chunk as ONE batched
    dispatch per scheduling step (members share the chunk boundary)."""
    members: List[_PendingMember]
    base: int = 0
    cache: Optional[Dict] = None    # contig: the transient group cache


class Engine:
    def __init__(self, cfg: ArchConfig, params: Dict, max_batch: int = 8,
                 max_len: int = 256, device: DeviceLike = None,
                 prefill_group: int = 4, prefill_bucket: int = 16,
                 prefill_chunk: int = 0, admission: str = "bucketed",
                 kv_layout: str = "auto",
                 block_size: int = 16, n_blocks: int = 0,
                 kv_alloc: str = "lazy", kv_overcommit: float = 1.0,
                 admit_window: int = 4, prefix_share: bool = False,
                 grow_ahead: int = 1, admit_headroom: bool = True,
                 kv_sanitize: Optional[bool] = None,
                 victim_policy: str = "cost", placement: Any = None,
                 model_kw: Optional[Dict] = None):
        assert admission in ("bucketed", "legacy"), admission
        assert kv_layout in ("auto", "paged", "contig"), kv_layout
        assert kv_alloc in ("lazy", "upfront"), kv_alloc
        assert victim_policy in ("cost", "fewest"), victim_policy
        self.device = resolve_device(device)
        pdev = device_of(params)
        if pdev is None or pdev.type != self.device.type:
            raise ValueError(f"params live on {pdev}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.admission = admission
        self.prefill_chunk = int(prefill_chunk)
        # MoE expert capacity is computed over the flattened (batch, seq)
        # token stream, so pad tokens or rows would compete with real
        # tokens for expert slots: MoE admits batch-1 at exact length
        self._moe = cfg.n_experts > 0
        # SSM / hybrid state runs through pad columns: exact-length buckets
        self._recurrent = cfg.family in RECURRENT
        self._group = 1 if self._moe else max(1, min(prefill_group,
                                                     max_batch))
        self._min_bucket = max(1, min(prefill_bucket, max_len))
        # paged layout: attention caches only (SSM / hybrid carry recurrent
        # state, not KV rows; enc-dec has a second, cross-attention cache;
        # MoE rides the contig path with its batch-1 admission, as in the
        # reference). The legacy baseline predates the block table and
        # stays contiguous.
        paged_ok = not (cfg.is_encdec or self._moe or self._recurrent
                        or admission == "legacy")
        if kv_layout == "auto":
            kv_layout = "paged" if paged_ok else "contig"
        elif kv_layout == "paged" and not paged_ok:
            raise ValueError(f"kv_layout='paged' unsupported for {cfg.name} "
                             f"(family={cfg.family}, admission={admission})")
        self.kv_layout = kv_layout
        self.kv_alloc = kv_alloc
        self._lazy = kv_alloc == "lazy" and kv_layout == "paged"
        self._admit_window = max(0, int(admit_window))
        self._grow_ahead = max(1, int(grow_ahead))
        self._admit_headroom = bool(admit_headroom)
        # preemption-victim choice: "cost" picks the slot with the lowest
        # estimated re-admission cost (restore vs recompute, priced by
        # cluster/recovery); "fewest" is the legacy fewest-generated rule,
        # which remains the tie-break within a cost bucket. ``placement``
        # (core.estimator.Placement) prices the recompute branch; without
        # it only the restore (store round-trip) branch is priced.
        self._victim_policy = victim_policy
        self._placement = placement
        self._victim_costs: Dict[int, float] = {}
        self._victim_spec = None
        self._tbl_dirty = False
        self.bm: Optional[BlockManager] = None
        if kv_layout == "paged":
            mb = -(-max_len // block_size)
            if n_blocks <= 0:
                n_blocks = max_batch * mb + 1     # capacity-parity + trash
            self.bm = BlockManager(n_blocks, block_size, max_batch, mb,
                                   overcommit=kv_overcommit,
                                   sanitize=kv_sanitize)
        elif prefix_share:
            # legacy admission lands here too: it forces the contig layout
            raise ValueError("prefix_share requires kv_layout='paged'")
        self._prefix: Optional[PrefixIndex] = None
        if prefix_share:
            self._prefix = PrefixIndex(block_size, self.bm)
            self.bm.on_reuse = self._prefix.invalidate_block
        # the model AFTER the block manager: sanitize mode arms the device
        # probe on the paged layout (the port's model takes ssd_chunk and
        # kv_probe of the reference's model keywords)
        model_kw = dict(model_kw or {})
        if self.bm is not None:
            model_kw.setdefault("kv_probe", self.bm.sanitize)
        self._kv_probe = bool(model_kw.get("kv_probe", False))
        self.model = build_model(cfg, device=self.device, **model_kw)
        self.enc_frames = 8           # stubbed frontend frames per request
        if cfg.is_encdec:
            self.cache = self.model.init_cache(max_batch, max_len,
                                               s_enc=self.enc_frames)
        else:
            self.cache = self.model.init_cache(
                max_batch, max_len, kv_layout=kv_layout, n_blocks=n_blocks,
                block_size=block_size, ring=False)
        self.slots: List[Optional[ServeRequest]] = [None] * max_batch
        self.stats = EngineStats()
        self._pending: List[_PendingGroup] = []
        self._admit_finished: List[ServeRequest] = []
        # requests evicted by a dry-pool grow, with their exported KV
        # payloads; re-attached once capacity frees
        self._preempted: List[Tuple[ServeRequest, Dict]] = []
        self._shapes: set = set()
        # the probe's threshold: KV_POISON as the pool stores it (bf16
        # rounds 1e9 down to 998,244,352)
        self._poison = float(torch.tensor(KV_POISON, dtype=self.model.dtype))

    # -- dispatch helpers -------------------------------------------------------
    def _dev(self, x, dtype=torch.int32) -> torch.Tensor:
        """Host array -> a fresh tensor on the engine's device (a copy,
        never a view of the host ledger)."""
        # torchlint: disable=host-sync -- the upload helper: each call
        # site is a finding of its own
        return torch.tensor(x, dtype=dtype, device=self.device)

    def _frames(self, g: int) -> torch.Tensor:
        """The stubbed audio frontend's output for ``g`` rows: zeros."""
        return torch.zeros((g, self.enc_frames, self.cfg.d_model),
                           dtype=torch.float32, device=self.device)

    def _prompt(self, tokens) -> Dict[str, torch.Tensor]:
        """A prefill's model inputs from a (G, S) token array; enc-dec
        rows also get the stubbed frontend's frames."""
        inputs = {"tokens": self._dev(tokens)}
        if self.cfg.is_encdec:
            inputs["embeds"] = self._frames(len(tokens))
        return inputs

    def _note_shape(self, kind: str, shape, prefill: bool = True) -> None:
        """Retrace analogue: count each distinct dispatch shape once."""
        key = (kind,) + tuple(shape)
        if key not in self._shapes:
            self._shapes.add(key)
            self.stats.retraces += 1
            if prefill:
                self.stats.prefill_retraces += 1

    # -- buckets ----------------------------------------------------------------
    def bucket_lens(self) -> List[int]:
        """Prefill length buckets: powers of two up to max_len."""
        out, b = [], self._min_bucket
        while b < self.max_len:
            out.append(b)
            b *= 2
        out.append(self.max_len)
        return out

    def _bucket(self, n: int) -> int:
        if self._recurrent or self._moe:
            return n      # recurrent state / expert capacity: no padding
        b = self._min_bucket
        while b < n:
            b *= 2
        return min(b, self.max_len)

    def _use_chunked(self, n: int) -> bool:
        # MoE excluded: per-chunk expert capacity differs from full-prefill
        # capacity, changing token drops (the same exactness problem as pads);
        # SSM / hybrid: no chunked prefill of recurrent state
        if self.prefill_chunk <= 0 or self._moe or self._recurrent:
            return False
        n_chunks = -(-n // self.prefill_chunk)
        return n > self.prefill_chunk and \
            n_chunks * self.prefill_chunk <= self.max_len

    @staticmethod
    def _prefill_tokens(req: ServeRequest) -> List[int]:
        """Context to prefill: the full context *minus* the last generated
        token, which the first decode step feeds — so a recomputed cache is
        laid out identically to an uninterrupted run's."""
        ctx = req.full_context()
        return ctx[:-1] if req.generated else ctx

    @staticmethod
    def _total_tokens(req: ServeRequest) -> int:
        """Token capacity a request needs for its whole lifetime."""
        return req.ctx_len + req.max_new_tokens - len(req.generated)

    # -- slot management --------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def active(self) -> List[ServeRequest]:
        return [s for s in self.slots if s is not None]

    def _pending_slots(self) -> set:
        return {m.slot for g in self._pending for m in g.members
                if not m.done}

    def _free_blocks(self, slot: int) -> None:
        if self.bm is not None and self.bm.slot_blocks(slot):
            self.bm.free(slot)
            self._poison_released()
            self._tbl_dirty = True

    def _poison_released(self) -> None:
        """Sanitize mode: overwrite the device content of blocks whose last
        mapping just died with the finite ``KV_POISON`` sentinel, so a
        stale gather through a dangling table entry produces unmissable
        garbage instead of plausible old KV."""
        if self.bm is None or not self.bm.sanitize \
                or not self.bm.last_released:
            return
        ids = self._dev(self.bm.last_released, torch.long)
        self.cache["k"][:, ids] = KV_POISON
        self.cache["v"][:, ids] = KV_POISON
        self.bm.last_released = []

    def _check_probe(self) -> None:
        """Sanitize mode: read the maximum of the dispatch's probes (the
        one host sync it adds) and raise when a readable position held the
        poison, before the dispatch's tokens are committed."""
        if not self._kv_probe:
            return
        worst = self.model.take_probe()
        if worst is None:
            return
        # torchlint: disable=host-sync -- the sanitizer's one read a dispatch
        worst = float(worst)
        if not worst < self._poison:
            raise KVSanitizerError(
                f"poisoned KV block read through the block table (max "
                f"readable |kv| = {worst})")

    def _sync_block_tbl(self) -> None:
        """Push the host block table to the device when allocations
        changed since the last dispatch."""
        if self.bm is not None and self._tbl_dirty:
            self.cache["block_tbl"] = self._dev(self.bm.table)
            self._tbl_dirty = False

    def block_stats(self) -> Dict[str, int]:
        """Paged-pool occupancy/fragmentation counters (empty for contig)."""
        if self.bm is None:
            return {}
        return {"blocks_in_use": self.bm.blocks_in_use(),
                "blocks_free": self.bm.blocks_free(),
                "reserved_blocks": self.bm.reserved_blocks(),
                "outstanding_blocks": self.bm.outstanding_blocks(),
                "frag_tokens": self.bm.frag_tokens(),
                "peak_blocks": self.bm.peak_blocks,
                "block_size": self.bm.block_size,
                "n_blocks": self.bm.n_blocks,
                "block_grows": self.stats.block_grows,
                "preemptions": self.stats.preemptions,
                "alloc_failures": self.stats.alloc_failures,
                "prefix_hits": self.stats.prefix_hits,
                "cow_copies": self.stats.cow_copies}

    # -- admission --------------------------------------------------------------
    def admit(self, req: ServeRequest) -> bool:
        return bool(self.admit_many([req]))

    def admit_many(self, reqs: Sequence[ServeRequest]
                   ) -> List[ServeRequest]:
        """Admit from ``reqs`` in order, bounded by free slots and (paged)
        the block manager's reservation ledger. A request the pool can't
        cover is SKIPPED (up to ``admit_window`` failures) so smaller ones
        behind it still drain; the returned list is therefore not
        necessarily a prefix of ``reqs``. Requests are grouped by length
        bucket and prefilled in batches of ``prefill_group``; long contexts
        go to the chunked path. With prefix sharing, a request matching the
        index maps the shared blocks and joins a suffix group instead; the
        full-prefill groups dispatch first, since a suffix may read a donor
        admitted in the same call. Finished ones surface via ``step()``."""
        free = self.free_slots()
        admitted: List[ServeRequest] = []
        skipped = 0
        # free blocks live slots will claim at their NEXT boundary crossing;
        # admissions that would eat into it are deferred
        imminent = self._imminent_blocks() if (
            self._admit_headroom and self._lazy) else 0
        groups: Dict[int, List[Tuple[ServeRequest, List[int], int]]] = {}
        sgroups: Dict[int, List] = {}
        chunked: List[Tuple[ServeRequest, List[int], int]] = []
        # blocks pre-indexed THIS call whose content only materializes when
        # the full-prefill groups dispatch (before any suffix dispatch)
        fresh_this_call: set = set()
        for r in reqs:               # done reqs need no slot: pass through
            if r.done:
                self._admit_finished.append(r)
                admitted.append(r)
                continue
            if not free:
                break
            assert self._total_tokens(r) <= self.max_len, \
                "context exceeds engine max_len"
            slot = free[0]
            toks: Optional[List[int]] = None
            match = None
            if self.bm is not None:
                ctx = r.ctx_len - (1 if r.generated else 0)
                live = ctx if self._lazy else None
                if self._prefix is not None:
                    toks = self._prefill_tokens(r)
                    match = self._prefix.match(toks)
                shared = match.full if match is not None else None
                n_sh = len(shared) if shared else 0
                if imminent > 0:
                    fresh = max(0, self.bm.blocks_for(ctx) - n_sh)
                    if self.bm.blocks_free() - fresh < imminent:
                        self.stats.admit_deferred += 1
                        skipped += 1
                        if skipped >= self._admit_window:
                            break
                        continue
                boundary = match.boundary if match is not None else None
                if not self.bm.reserve(slot, self._total_tokens(r), live,
                                       shared=shared, boundary=boundary):
                    self.stats.alloc_failures += 1
                    skipped += 1
                    if skipped >= self._admit_window:
                        break        # backpressure: leave the rest queued
                    continue         # skip ahead: smaller reqs may still fit
                self.bm.note_live(slot, ctx)
                self._tbl_dirty = True
            free.pop(0)
            if toks is None:
                toks = self._prefill_tokens(r)
            if self.admission == "legacy":
                self._admit_one_legacy(r, toks, slot)
            elif match is not None and match.n_tokens > 0:
                cow = None
                if match.boundary is not None:
                    # copy the partially shared boundary block before any
                    # suffix write lands in it; a donor admitted in THIS
                    # call has not prefilled yet, so its copy waits for the
                    # suffix dispatch (the donor's mapping pins the source)
                    dst = int(self.bm.table[slot, len(match.full)])
                    if match.boundary in fresh_this_call:
                        cow = (match.boundary, dst)
                    else:
                        self._cow(match.boundary, dst)
                self.stats.prefix_hits += 1
                self.stats.prefix_shared_tokens += match.n_tokens
                sgroups.setdefault(
                    self._bucket(len(toks) - match.n_tokens), []).append(
                    (r, toks, slot, match.n_tokens, cow))
            elif self._use_chunked(len(toks)):
                self.slots[slot] = r
                chunked.append((r, toks, slot))
            else:
                groups.setdefault(self._bucket(len(toks)), []).append(
                    (r, toks, slot))
                if self._prefix is not None:
                    # pre-index so later requests in this SAME call share:
                    # every full-prefill group dispatches before the first
                    # suffix dispatch
                    self._index_insert(toks, slot)
                    fresh_this_call.update(self.bm.slot_blocks(slot))
            admitted.append(r)
        for blen, items in sorted(groups.items()):
            for i in range(0, len(items), self._group):
                self._admit_group(items[i:i + self._group], blen)
        for blen, items in sorted(sgroups.items()):
            for i in range(0, len(items), self._group):
                self._admit_group_suffix(items[i:i + self._group], blen)
        for i in range(0, len(chunked), self._group):
            members = [_PendingMember(r, slot, np.asarray(toks, np.int32))
                       for r, toks, slot in chunked[i:i + self._group]]
            self._pending.append(_PendingGroup(members))
        return admitted

    def _admit_group(self, items, blen: int) -> None:
        """One batched prefill for <= prefill_group requests sharing a
        length bucket, installed straight into the slots' pool blocks or
        contiguous rows."""
        g, n = self._group, len(items)
        tokens = np.zeros((g, blen), np.int32)
        lens = np.zeros((g,), np.int32)
        slots = np.zeros((g,), np.int32)
        for j, (r, toks, slot) in enumerate(items):
            tokens[j, :len(toks)] = toks
            lens[j] = len(toks)
            slots[j] = slot
        lens[n:] = lens[0]           # pad rows: computed, never installed
        self._note_shape("prefill", tokens.shape)
        # the reference's install jit sees the group's max_len cache and
        # g slots: one trace per group size, whatever the bucket
        self._note_shape("scatter", (g, g), prefill=False)
        logits, state = self.model.prefill_kv(self.params,
                                              self._prompt(tokens),
                                              self._dev(lens - 1))
        self._scatter_group({key: val[:, :n] for key, val in state.items()},
                            slots[:n], lens[:n])
        # torchlint: disable=host-sync -- first tokens fill req.generated
        first = self.model.sample_greedy(logits).tolist()
        self.stats.prefill_batches += 1
        for j, (r, toks, slot) in enumerate(items):
            self._install(r, slot, first[j])

    def _admit_group_suffix(self, items, blen: int) -> None:
        """Prefix-sharing admission: one batched SUFFIX prefill for <=
        prefill_group requests sharing a suffix-length bucket. Each row's
        shared prefix is already mapped through its block table; the
        dispatch computes and writes only the divergent suffix and samples
        the first token at each row's last real suffix position. Pad rows
        repeat row 0's tokens, base and length, as in the reference, but
        read and write through the trash table: their result is dropped
        and they never write a real block."""
        g, n = self._group, len(items)
        tokens = np.zeros((g, blen), np.int32)
        bases = np.zeros((g,), np.int32)
        lens = np.zeros((g,), np.int32)
        slots = np.zeros((n,), np.int32)
        for j, (r, toks, slot, n_sh, cow) in enumerate(items):
            if cow is not None:       # deferred COW: donor prefilled by now
                self._cow(*cow)
            suf = toks[n_sh:]
            tokens[j, :len(suf)] = suf
            bases[j] = n_sh
            lens[j] = len(suf)
            slots[j] = slot
        tokens[n:] = tokens[0]
        bases[n:] = bases[0]
        lens[n:] = lens[0]
        tbls = np.zeros((g, self.bm.table.shape[1]), np.int32)
        tbls[:n] = self.bm.table[slots]
        self._note_shape("suffix", tokens.shape)
        logits, _ = self.model.prefill_suffix(
            self.params, self.cache, self._dev(tokens), self._dev(bases),
            self._dev(tbls), self._dev(lens))
        self._check_probe()
        slots_t = self._dev(slots, torch.long)
        self.cache["pos"][slots_t] = self._dev(bases[:n] + lens[:n])
        # the device table row of each slot follows on the next dispatch
        # (``_sync_block_tbl``: the reservation marked it dirty)
        # torchlint: disable=host-sync -- first tokens fill req.generated
        first = self.model.sample_greedy(logits).tolist()
        self.stats.prefill_batches += 1
        for j, (r, toks, slot, n_sh, cow) in enumerate(items):
            self._index_insert(toks, slot)
            self._install(r, slot, first[j])

    def _cow(self, src: int, dst: int) -> None:
        """Copy a partially shared boundary block into the slot's own
        block before any divergent suffix write lands in it (an indexed
        copy into the pool, as the reference's ``.at[].set``)."""
        self._note_shape("cow", (), prefill=False)
        self.bm.note_cow(src, dst)
        for key in ("k", "v"):
            self.cache[key][:, dst] = self.cache[key][:, src]
        self.stats.cow_copies += 1

    def _index_insert(self, toks, slot: int) -> None:
        """Register a freshly prefilled context's blocks with the prefix
        index (BEFORE ``_install`` may free an immediately-done slot: a
        freed block's content stays valid, which is how a hot prefix
        survives its first request)."""
        if self._prefix is not None:
            self._prefix.insert(toks, self.bm.slot_blocks(slot))

    def _scatter_group(self, state: Dict[str, torch.Tensor], slots,
                       lens) -> None:
        """Install a group's stacked prefill state (every key of
        ``LM.prefill_kv``'s dict, rows on axis 1) into the slots and set
        their positions: paged, K/V (L, n, S, nkv, d) into the slots' pool
        blocks through their table rows (positions past each real length to
        the trash block); contig, as whole slot rows: K/V, the hybrid's
        ``ak``/``av`` and the enc-dec ``ck``/``cv`` zero past S, as the
        reference installs a ``max_len`` group cache row, and SSM
        ``conv``/``ssd`` state whole."""
        lens_t = self._dev(lens)
        slots_t = self._dev(slots, torch.long)
        if self.bm is not None:
            attn.cache_write_prefill_paged(
                self.cache["k"], self.cache["v"], state["k"], state["v"],
                self._dev(self.bm.table[slots]), lens=lens_t)
        else:
            for key, new in state.items():
                dst = self.cache[key]
                if key in STATE_KEYS:
                    dst[:, slots_t] = new.to(dst.dtype)
                    continue
                s = new.shape[2]
                dst[:, slots_t, :s] = new.to(dst.dtype)
                dst[:, slots_t, s:] = 0
        self.cache["pos"][slots_t] = lens_t

    def _install(self, req: ServeRequest, slot: int, first_tok) -> None:
        """Post-prefill bookkeeping shared by all admission paths."""
        self.slots[slot] = req
        self.stats.prefills += 1
        if not req.generated:        # fresh request: prefill emits 1st token
            req.generated.append(int(first_tok))
            self.stats.tokens_out += 1
        if req.done:
            self.slots[slot] = None
            self._free_blocks(slot)
            self._admit_finished.append(req)

    def _admit_one_legacy(self, req: ServeRequest, toks: List[int],
                          slot: int) -> None:
        """The reference's baseline admission: a batch-1 exact-length
        prefill into a fresh ``max_len`` cache, installed into the slot's
        row (one retrace per distinct length)."""
        self._note_shape("legacy", (len(toks),))
        kw = {} if self.cfg.is_encdec else {"ring": False}
        logits, one = self.model.prefill(self.params, self._prompt([toks]),
                                         max_len=self.max_len, **kw)
        for key, val in one.items():
            if key == "pos":
                self.cache["pos"][slot] = len(toks)
            else:
                self.cache[key][:, slot] = val[:, 0].to(self.cache[key].dtype)
        self.stats.prefill_batches += 1
        # torchlint: disable=host-sync -- the baseline's first token
        self._install(req, slot, self.model.sample_greedy(logits)[0].item())

    # -- chunked prefill --------------------------------------------------------
    def _advance_pending(self) -> None:
        """One chunk of prefill work per pending GROUP, interleaved between
        decode steps. Paged: each chunk's K/V lands straight in the owning
        slots' pool blocks through a snapshot of their block tables
        (``stats.chunk_direct``). Contig: the group prefills into its own
        transient cache, from which finishers are scattered."""
        c = self.prefill_chunk
        still: List[_PendingGroup] = []
        for grp in self._pending:
            g = len(grp.members)
            chunk = np.zeros((g, c), np.int32)
            last_idx = np.zeros((g,), np.int32)
            rem = np.zeros((g,), np.int32)
            for j, m in enumerate(grp.members):
                if m.done:
                    continue        # finished early: row computes pad zeros
                end = min(grp.base + c, len(m.tokens))
                chunk[j, :end - grp.base] = m.tokens[grp.base:end]
                last_idx[j] = min(c - 1, len(m.tokens) - 1 - grp.base)
                rem[j] = end - grp.base
            self._note_shape("chunk", chunk.shape)
            if self.bm is not None:
                # finished members (whose slots now decode, or were reused)
                # are routed wholesale to the trash block
                tbls = self.bm.table[[m.slot for m in grp.members]].copy()
                tbls[rem == 0] = 0
                if self.bm.sanitize:
                    for m, n_rem in zip(grp.members, rem.tolist()):
                        if n_rem:
                            self.bm.check_write(m.slot, grp.base,
                                                grp.base + n_rem)
                logits, _ = self.model.prefill_chunk(
                    self.params, self.cache, self._dev(chunk), grp.base,
                    last_pos=self._dev(last_idx), block_tbl=self._dev(tbls),
                    lens=self._dev(rem))
                self._check_probe()
                self.stats.chunk_direct += 1
            else:
                if grp.cache is None:
                    grp.cache = self._chunk_init(g)
                logits, _ = self.model.prefill_chunk(
                    self.params, grp.cache, self._dev(chunk), grp.base,
                    last_pos=self._dev(last_idx))
            self.stats.prefill_chunks += 1
            grp.base += c
            finishers = [(j, m) for j, m in enumerate(grp.members)
                         if not m.done and grp.base >= len(m.tokens)]
            if finishers:
                # torchlint: disable=host-sync -- finishers' first tokens
                # fill req.generated
                first = self.model.sample_greedy(logits).tolist()
                self._finish_pending(grp, finishers, first)
            if not all(m.done for m in grp.members):
                still.append(grp)
        self._pending = still

    def _chunk_init(self, g: int) -> Dict:
        """A contig chunked group's transient cache; an enc-dec group's
        has its cross-attention K/V warmed by one encoder pass over the
        stubbed frames (one warm-up shape per group size)."""
        if not self.cfg.is_encdec:
            return self.model.init_cache(g, self.max_len, ring=False)
        self._note_shape("enc_warm", (g,), prefill=False)
        cache = self.model.init_cache(g, self.max_len, s_enc=self.enc_frames)
        cache["ck"], cache["cv"] = self.model.cross_kv(
            self.params, self.model.encode(self.params, self._frames(g)))
        return cache

    def _finish_pending(self, grp: _PendingGroup, finishers, first) -> None:
        """Finish fully-prefilled members. Paged: every chunk is already in
        their pool blocks, so only the per-slot positions need setting.
        Contig: their rows of the group cache are scattered into their slot
        rows (one scatter for this step's finishers)."""
        slots = [m.slot for _, m in finishers]
        lens = [len(m.tokens) for _, m in finishers]
        if self.bm is not None:
            self.cache["pos"][self._dev(slots, torch.long)] = self._dev(lens)
        else:
            rows = self._dev([j for j, _ in finishers], torch.long)
            self._note_shape("scatter", (len(grp.members), len(finishers)),
                             prefill=False)
            self._scatter_group({key: val[:, rows]
                                 for key, val in grp.cache.items()
                                 if key != "pos"}, slots, lens)
            self.stats.chunk_scatters += 1
        for j, m in finishers:
            m.done = True
            self.slots[m.slot] = None     # _install re-marks the slot
            self._index_insert(m.tokens.tolist(), m.slot)
            self._install(m.req, m.slot, first[j])

    # -- decode-time grow / preemption ------------------------------------------
    def _victim_cost(self, slot: int) -> float:
        """Estimated re-admission cost of preempting this slot: the
        cheaper of the store restore round trip
        (``recovery.preemption_seconds``) and a context recompute
        (``recovery.recompute_seconds``, when a placement prices it). The
        context is bucketed to the block grid before pricing, so two slots
        whose KV occupies the same number of blocks cost the same and the
        fewest-generated rule stays the live tie-break. Costs are cached
        per bucket."""
        r = self.slots[slot]
        bs = self.bm.block_size if self.bm is not None else 16
        ctx_b = max(bs, -(-r.ctx_len // bs) * bs)
        c = self._victim_costs.get(ctx_b)
        if c is None:
            if self._victim_spec is None:
                self._victim_spec = self.cfg.to_modelspec()
            c = preemption_seconds(self._victim_spec, ctx_b)
            if self._placement is not None:
                c = min(c, recompute_seconds(
                    self._victim_spec, self._placement, ctx_b,
                    chunk=self.prefill_chunk, max_len=self.max_len))
            self._victim_costs[ctx_b] = c
        return c

    def _pick_victim(self, candidates: List[int]) -> Optional[int]:
        """Preemption victim. Policy "cost": the slot whose re-admission
        is estimated cheapest (``_victim_cost``); fewest generated tokens
        breaks cost ties (least progress to park), slot index breaks the
        rest. Policy "fewest": the legacy fewest-generated-only rule."""
        owned = [i for i in candidates if self.slots[i] is not None]
        if not owned:
            return None
        if self._victim_policy == "fewest":
            return min(owned, key=lambda i: (len(self.slots[i].generated),
                                             i))
        return min(owned, key=lambda i: (self._victim_cost(i),
                                         len(self.slots[i].generated), i))

    def _preempt(self, slot: int) -> None:
        """Evict a live slot to make room: export its KV (position-exact),
        free its blocks, and park (request, payload) for re-attachment."""
        req = self.slots[slot]
        payload = self.export_kv(slot)
        self.slots[slot] = None
        self.bm.free(slot)
        self._poison_released()
        self._tbl_dirty = True
        self.stats.preemptions += 1
        self._preempted.append((req, payload))

    def _ensure_grow(self, live: List[int]) -> List[int]:
        """Every slot decoding this step writes token ``pos``, so its block
        table must cover ``ctx_len`` tokens (no device sync needed). Grow
        crossing slots by a block; when the free list is dry, preempt
        victims until the grow fits. Returns the slots still decoding."""
        grows0 = self.bm.grows
        alive = list(live)
        k = self._grow_ahead
        for slot in list(live):
            if self.slots[slot] is None:        # preempted by an earlier grow
                continue
            need = self.slots[slot].ctx_len
            if k > 1:
                crossing = (self.bm.blocks_for(need)
                            > self.bm.blocks_for(need - 1))
                if crossing and (self.bm.covered_blocks(slot)
                                 >= self.bm.blocks_for(need)):
                    self.stats.grow_ahead_skips += 1
                    continue
            ahead = (k - 1 if k > 1
                     and self.bm.blocks_free() >= len(alive) + k else 0)
            while not self.bm.grow(slot, need, ahead=ahead):
                ahead = 0
                victim = self._pick_victim(alive)
                assert victim is not None, "grow failed with no live victim"
                self._preempt(victim)
                alive.remove(victim)
                if victim == slot:
                    break
        if self.bm.grows > grows0:
            self.stats.block_grows += self.bm.grows - grows0
            self._tbl_dirty = True
        return [i for i in alive if self.slots[i] is not None]

    def _imminent_blocks(self) -> int:
        """Free blocks live slots will need at their NEXT decode step's
        boundary crossing — the headroom admission must not consume."""
        if self.bm is None:
            return 0
        pend = self._pending_slots()
        n = 0
        for i, r in enumerate(self.slots):
            if r is None or r.done or i in pend:
                continue
            n += max(0, self.bm.blocks_for(r.ctx_len + 1)
                     - self.bm.covered_blocks(i))
        return n

    # -- decode -----------------------------------------------------------------
    def _decode(self, tokens: torch.Tensor, live: torch.Tensor
                ) -> torch.Tensor:
        """Masked decode dispatch: every row decodes, and dead/pending rows
        keep their position frozen. Paged, their writes go through the
        trash block (mid-chunk pending slots hold live chunk KV); contig,
        they write at their frozen position of their own row, which a later
        install overwrites whole."""
        self._note_shape("decode", tokens.shape, prefill=False)
        pos0 = self.cache["pos"]
        view = self.cache
        if self.bm is not None:
            tbl = self.cache["block_tbl"]
            view = dict(self.cache,
                        block_tbl=torch.where(live[:, None], tbl,
                                              torch.zeros_like(tbl)))
        logits, out = self.model.decode_step(self.params, view, tokens)
        self._check_probe()
        self.cache["pos"] = torch.where(live, out["pos"], pos0)
        return logits

    def step(self) -> List[ServeRequest]:
        """One scheduling iteration: re-attach preempted requests capacity
        now allows, advance chunked prefills, grow block tables crossing a
        block boundary (preempting victims when the pool is dry), then
        decode one token for every live slot; returns finished requests."""
        if self._preempted:
            self._readmit_preempted()
        if self._pending:
            self._advance_pending()
        finished = list(self._admit_finished)
        self._admit_finished.clear()
        pending = self._pending_slots()
        live = [i for i, s in enumerate(self.slots)
                if s is not None and i not in pending]
        if not live:
            return finished
        if self._lazy:           # upfront allocations can never need a grow
            live = self._ensure_grow(live)
            if not live:
                return finished
        tokens = np.zeros((self.max_batch, 1), np.int32)
        mask = np.zeros((self.max_batch,), bool)
        for i in live:
            tokens[i, 0] = self.slots[i].generated[-1]
            mask[i] = True
        if self.bm is not None and self.bm.sanitize:
            for i in live:
                # this dispatch reads each live slot's KV history and
                # writes the incoming token at position ctx_len - 1
                self.bm.check_read(i, self.slots[i].ctx_len - 1)
                self.bm.check_write(i, self.slots[i].ctx_len - 1,
                                    self.slots[i].ctx_len)
        self._sync_block_tbl()
        logits = self._decode(self._dev(tokens), self._dev(mask, torch.bool))
        # torchlint: disable=host-sync -- THE per-step sync point: sampled
        # tokens feed the next step's host-side scheduling
        nxt = self.model.sample_greedy(logits)[:, 0].tolist()
        for i in live:
            req = self.slots[i]
            req.generated.append(nxt[i])
            self.stats.tokens_out += 1
            if self.bm is not None:
                # tokens in the cache == ctx_len - 1 (§5.1 invariant)
                self.bm.note_live(i, req.ctx_len - 1)
            if req.done:
                finished.append(req)
                self.slots[i] = None
                self._free_blocks(i)
        self.stats.decode_steps += 1
        return finished

    def _readmit_preempted(self) -> None:
        """Re-attach parked preempted requests whose blocks now fit."""
        still: List[Tuple[ServeRequest, Dict]] = []
        for req, payload in self._preempted:
            if not self.import_kv(req, payload):
                still.append((req, payload))
        self._preempted = still

    def take_preempted(self) -> List[Tuple[ServeRequest, Dict]]:
        """Drain (request, KV payload) pairs evicted by dry-pool grows."""
        out, self._preempted = self._preempted, []
        return out

    def busy(self) -> bool:
        """Admitted work remains: live, prefilling, finished-but-unreported
        or preempted requests."""
        return bool(self.active() or self._pending or self._admit_finished
                    or self._preempted)

    def drain(self) -> List[ServeRequest]:
        """Run until every admitted request finishes."""
        out = []
        while self.busy():
            out.extend(self.step())
        return out

    def evict_all(self) -> List[ServeRequest]:
        """Simulated engine death: return in-flight requests (their
        ``generated`` lists are the preserved output), including preempted
        ones still parked for re-admission."""
        reqs = [s for s in self.slots if s is not None]
        reqs += [r for r, _ in self._preempted]
        reqs += [r for r in self._admit_finished if r not in reqs]
        self.slots = [None] * self.max_batch
        self._pending = []
        self._admit_finished = []
        self._preempted = []
        if self.bm is not None:
            self.bm.free_all()
            self._tbl_dirty = True
        return reqs

    # -- block-granular KV export / import --------------------------------------
    def export_kv(self, slot: int, pos: Optional[int] = None) -> Dict:
        """Snapshot a live slot's KV blocks. The payload is position-exact:
        importing it reproduces this engine's cache state for the request.
        ``pos`` defaults to ``ctx_len - 1`` (everything but the last
        generated token is in the cache), so no device sync is needed."""
        assert self.bm is not None, "KV export requires the paged layout"
        if pos is None:
            pos = self.slots[slot].ctx_len - 1
        self.bm.check_read(slot, pos)      # no-op unless sanitize mode
        nb = -(-pos // self.bm.block_size) if pos > 0 else 0
        ids = self._dev(self.bm.table[slot, :nb], torch.long)
        self.stats.kv_exports += 1
        return {"k": self.cache["k"][:, ids], "v": self.cache["v"][:, ids],
                "pos": int(pos), "block_size": self.bm.block_size,
                "arch": self.cfg.name}

    def export_live_kv(self) -> Dict[int, Dict]:
        """Payloads for every live, fully-prefilled slot, keyed by request
        id (mid-chunked-prefill slots are skipped); none for contig."""
        if self.bm is None:
            return {}
        pend = self._pending_slots()
        return {r.rid: self.export_kv(slot, r.ctx_len - 1)
                for slot, r in enumerate(self.slots)
                if r is not None and slot not in pend}

    def import_kv(self, req: ServeRequest, payload: Dict) -> bool:
        """Admit ``req`` by attaching an exported KV payload instead of
        recomputing its context. Returns False on any incompatibility (the
        contig layout included) or when capacity is short (the caller
        retries later)."""
        if self.bm is None or payload.get("arch") != self.cfg.name \
                or payload.get("block_size") != self.bm.block_size:
            return False
        if req.done or not req.generated:
            return False
        if payload["pos"] != req.ctx_len - 1:
            return False
        free = self.free_slots()
        if not free or self._total_tokens(req) > self.max_len:
            return False
        slot = free[0]
        live = payload["pos"] if self._lazy else None
        if not self.bm.reserve(slot, self._total_tokens(req), live):
            return False
        self.bm.note_live(slot, payload["pos"])
        self._tbl_dirty = True
        nb = payload["k"].shape[1]
        ids = self._dev(self.bm.table[slot, :nb], torch.long)
        self.cache["k"][:, ids] = payload["k"].to(self.cache["k"].dtype)
        self.cache["v"][:, ids] = payload["v"].to(self.cache["v"].dtype)
        self.cache["pos"][slot] = payload["pos"]
        self.slots[slot] = req
        self.stats.kv_imports += 1
        return True

    # -- shared-prefix publication / warm-up ------------------------------------
    def export_prefix(self, tokens) -> Optional[Dict]:
        """Snapshot the KV blocks of a fully indexed token run for
        publication to the tensor store (content-addressed by the run
        itself). Full blocks only: partial boundary blocks keep changing
        under decode and are never published."""
        if self._prefix is None:
            return None
        ids = self._prefix.full_run(tokens)
        if not ids:
            return None
        idx = self._dev(ids, torch.long)
        toks = [int(t) for t in tokens[:len(ids) * self.bm.block_size]]
        return {"k": self.cache["k"][:, idx], "v": self.cache["v"][:, idx],
                "tokens": toks, "block_size": self.bm.block_size,
                "arch": self.cfg.name}

    def hot_runs(self, min_hits: int = 2) -> List[Tuple[int, ...]]:
        """The hottest fully indexed token runs (matched at least
        ``min_hits`` times); cheap, no KV gather, so the server can
        content-address them against the store before exporting."""
        return [] if self._prefix is None else self._prefix.hot(min_hits)

    def hot_prefixes(self, min_hits: int = 2) -> List[Dict]:
        """Payloads of the hottest shared-prefix runs, for the store."""
        out = []
        for run in self.hot_runs(min_hits):
            p = self.export_prefix(run)
            if p is not None:
                out.append(p)
        return out

    def warm_prefix(self, payload: Dict) -> bool:
        """Attach a published shared-prefix payload: write its KV into
        free blocks, index them, and hand the blocks straight back to the
        free list (refcount 0): warm, fully reclaimable, and mapped
        read-only by the next admission matching the prefix. Returns False
        (recompute fallback) on any incompatibility or when the prefix is
        already resident."""
        if self._prefix is None or self.bm is None:
            return False
        if payload.get("arch") != self.cfg.name \
                or payload.get("block_size") != self.bm.block_size:
            return False
        toks = [int(t) for t in payload["tokens"]]
        nb = len(toks) // self.bm.block_size
        if nb <= 0 or payload["k"].shape[1] < nb:
            return False
        if len(self._prefix.full_run(toks)) >= nb:
            return False             # already warm (or computed locally)
        ids = self.bm.warm_blocks(nb)
        if ids is None:
            return False             # pool too tight right now
        self._note_shape("warm", payload["k"][:, :nb].shape, prefill=False)
        idx = self._dev(ids, torch.long)
        for key in ("k", "v"):
            self.cache[key][:, idx] = payload[key][:, :nb].to(
                device=self.device, dtype=self.cache[key].dtype)
        self._prefix.insert(toks[:nb * self.bm.block_size], ids)
        self.bm.warm_release(ids)
        self.stats.prefix_warmups += 1
        return True
