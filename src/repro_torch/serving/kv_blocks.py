"""Block-granular KV allocation for the paged cache layout (copy of
``repro/serving/kv_blocks.py``, plain numpy/Python; the port keeps its own
so that it imports nothing of the JAX package).

The contiguous layout pins a full ``max_len`` KV row per slot, so memory
utilization collapses at high slot counts with mixed context lengths — the
ROADMAP's paged-KV lift. Here the engine's KV pool is ``n_blocks`` fixed-size
token blocks shared by every slot; the ``BlockManager`` owns the free list
and a per-slot block table mapping virtual token positions to pool blocks:

    virtual position t of slot s  ->  pool block table[s, t // block_size],
                                      offset t % block_size

Block id 0 is RESERVED as the trash block: unallocated table entries point
at it, so jit'd scatters can route pad/dead-row writes somewhere harmless
without data-dependent shapes, and gathers through an unallocated entry read
garbage that position masking already hides. Real allocations hand out ids
from [1, n_blocks).

Allocation is DEMAND-PAGED through a reservation ledger. Admission books a
request's worst-case token need (``ceil(total_tokens / block_size)`` blocks)
as a *reservation* — so admission control stays sound — but only allocates
blocks covering the tokens it will write now (the prefill context);
``grow`` allocates the next block when decode crosses a block boundary.
The ledger may overcommit the pool (``overcommit`` > 1 books more reserved
blocks than physically exist), betting that EOS-early requests release
capacity before everyone reaches worst case; when the bet loses and a grow
finds the free list dry, the engine preempts a victim slot (its KV blocks
round-trip through the shared tensor store — see serving/engine.py).
A single request's worst case must always fit the pool physically, so a
slot that is alone can never wedge on its own reservation.

Blocks are SHAREABLE (prefix-sharing KV cache): a slot may map blocks
already mapped by other slots — its leading ``n_shared`` table entries are
read-only shared-prefix blocks, refcounted per block. ``free(slot)``
decrements refcounts and only blocks reaching zero return to the free
list. The ledger books only the FRESH (non-shared) worst case per slot and
admission is gated on *unique blocks in use + outstanding demand*
(outstanding = reserved-but-not-yet-allocated), so already-written blocks
no longer count against the ledger twice — the "shrinking reservation"
that lets ``kv_overcommit`` stay less aggressive for the same admitted
capacity. Without sharing this gate is numerically identical to the old
sum-of-reservations one.

A freed block's CONTENT stays valid until the block is reallocated, which
is what lets a prefix index keep pointing at free-list-resident blocks
(warm prefixes survive request completion). Blocks registered in
``indexed`` are handed out LAST by the free list, and when one is finally
overwritten the ``on_reuse`` callback lets the index drop its entries.

``reserve(slot, n, live_tokens=None)`` with the default ``live_tokens``
allocates everything up front — the pre-ledger behavior, kept as the
``kv_alloc="upfront"`` A/B baseline (``alloc`` is its alias).

``note_live`` records tokens actually written so ``frag_tokens`` reports
TRUE internal fragmentation (allocated capacity minus live occupancy), not
the smaller waste-vs-lifetime-reservation number.

SANITIZER MODE (``BlockManager(sanitize=True)`` or ``REPRO_KV_SANITIZE=1``,
see ``repro.analysis``): the manager keeps a SHADOW ledger — an
independently-updated mirror of the free set, per-slot mappings, and
refcounts — cross-checked against the primary structures after every
``reserve``/``grow``/``free``/warm op, so corruption (tampered refcounts,
free-list duplicates, table rows diverging from mappings) raises
``KVSanitizerError`` at the op that caused it instead of failing
``check_no_leak()`` at end of test. On top of the ledger it detects:

* double-free — ``free(slot)`` on an unmapped slot (the non-sanitizing
  path deliberately no-ops for engine convenience);
* refcount underflow — a block's refcount would go negative;
* use-after-free — ``check_read(slot, n)`` sees a table entry that is
  TRASH, unmapped, or whose content was released (poisoned);
* shared-block write — ``check_write(slot, start, end)`` (driven by the
  ``note_live`` write delta) covers a read-only shared-prefix entry or a
  block with refcount > 1 (COW should have run first).

``last_released`` lists the blocks whose content died at the most recent
``free`` (refcount hit 0 and no prefix index references them) — the
engine overwrites those device blocks with ``KV_POISON`` so any stale
gather produces blatant garbage. The sentinel is FINITE on purpose:
masked attention positions get probability exactly 0.0 and ``0.0 * 1e9 ==
0.0``, so poison is output-neutral for correct code, while NaN would
propagate through ``p @ v`` even at masked positions.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence, Set

import numpy as np

TRASH_BLOCK = 0

# Poison sentinel for released KV block content (sanitize mode). Finite:
# masked positions contribute exactly 0.0 * KV_POISON = 0.0, so correct
# masking hides it, while a genuine stale read is unmissable.
KV_POISON = 1e9


class KVSanitizerError(RuntimeError):
    """A KV-block invariant was violated (sanitize mode)."""


def _env_sanitize() -> bool:
    return os.environ.get("REPRO_KV_SANITIZE", "0").lower() not in (
        "", "0", "false", "off")


class BlockManager:
    def __init__(self, n_blocks: int, block_size: int, max_slots: int,
                 max_blocks_per_slot: int, overcommit: float = 1.0,
                 sanitize: Optional[bool] = None):
        assert n_blocks >= 2, "need at least the trash block plus one"
        assert block_size >= 1
        assert overcommit >= 1.0, "overcommit < 1 would idle physical blocks"
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.max_blocks_per_slot = max_blocks_per_slot
        self.overcommit = float(overcommit)
        # LIFO free list keeps recently-freed (cache-warm) blocks hot
        self._free: List[int] = list(range(n_blocks - 1, TRASH_BLOCK, -1))
        # per-slot block table; row width = blocks needed for max_len
        self.table = np.full((max_slots, max_blocks_per_slot), TRASH_BLOCK,
                             np.int32)
        self._mapped: Dict[int, List[int]] = {}   # table-order block ids
        self._n_shared: Dict[int, int] = {}       # leading read-only blocks
        self._reserved: Dict[int, int] = {}       # ledger: worst-case FRESH
        self._tokens: Dict[int, int] = {}         # requested lifetime tokens
        self._live: Dict[int, int] = {}           # tokens actually written
        self.refcount: Dict[int, int] = {}        # block id -> #slots mapping
        # free-list-resident blocks whose content a prefix index still
        # references; reallocated only when nothing else is free
        self.indexed: set = set()
        self.on_reuse: Optional[Callable[[int], None]] = None
        self.peak_blocks = 0
        self.grows = 0                        # decode-time block allocations
        # -- sanitizer shadow ledger (see module docstring) ------------------
        self.sanitize = _env_sanitize() if sanitize is None else bool(sanitize)
        self._sh_free: Set[int] = set(self._free)
        self._sh_borrowed: Set[int] = set()   # warm_blocks .. warm_release
        self._sh_slots: Dict[int, List[int]] = {}
        self._sh_shared: Dict[int, int] = {}
        self._sh_rc: Dict[int, int] = {}
        self._sh_poison: Set[int] = set()     # released, content dead
        self.last_released: List[int] = []    # content-dead blocks, last free

    # -- sizing -----------------------------------------------------------------
    def blocks_for(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 1) // self.block_size)

    def reservation_cap(self) -> int:
        """Ledger capacity: physical blocks scaled by the overcommit bet."""
        return int(self.overcommit * (self.n_blocks - 1))

    def reserved_blocks(self) -> int:
        return sum(self._reserved.values())

    def outstanding_blocks(self) -> int:
        """Reserved-but-not-yet-allocated fresh blocks across all slots —
        the demand the ledger still has to be able to satisfy."""
        return sum(max(0, self._reserved[s]
                       - (len(ids) - self._n_shared[s]))
                   for s, ids in self._mapped.items())

    def committed_blocks(self) -> int:
        """Unique blocks in use plus outstanding demand — the quantity the
        admission ledger actually gates on."""
        return self.blocks_in_use() + self.outstanding_blocks()

    def can_reserve(self, n_tokens: int, live_tokens: int = None,
                    n_shared: int = 0, n_reclaim: int = 0) -> bool:
        live = n_tokens if live_tokens is None else min(live_tokens, n_tokens)
        need_phys = self.blocks_for(n_tokens)
        fresh_live = max(0, self.blocks_for(live) - n_shared)
        fresh_total = max(0, need_phys - n_shared)
        return (need_phys <= self.max_blocks_per_slot
                # worst case must fit the pool physically: a slot running
                # alone must be able to grow to its reservation, or
                # preemption could thrash without ever making room
                and need_phys <= self.n_blocks - 1
                # committed = unique in-use + outstanding; without sharing
                # this equals the old sum-of-reservations gate exactly
                and self.committed_blocks() + n_reclaim + fresh_total
                <= self.reservation_cap()
                and fresh_live + n_reclaim <= len(self._free))

    def can_alloc(self, n_tokens: int) -> bool:
        return self.can_reserve(n_tokens)

    # -- free-list internals ----------------------------------------------------
    def _pop_free(self, avoid: Sequence[int] = ()) -> int:
        """Pop a free block, preferring blocks no prefix index references;
        overwriting an indexed block notifies ``on_reuse`` so the index
        drops its (now stale) entries."""
        for i in range(len(self._free) - 1, -1, -1):
            bid = self._free[i]
            if bid in avoid or bid in self.indexed:
                continue
            return self._free.pop(i)
        for i in range(len(self._free) - 1, -1, -1):
            bid = self._free[i]
            if bid in avoid:
                continue
            self._free.pop(i)
            self.indexed.discard(bid)
            if self.on_reuse is not None:
                self.on_reuse(bid)
            return bid
        raise AssertionError("pop from an exhausted free list")

    def _reclaim(self, bid: int) -> None:
        """Pull a specific free-list block back into use WITHOUT touching
        its content — re-sharing a warm prefix block."""
        self._free.remove(bid)

    # -- sanitizer (shadow ledger; see module docstring) ------------------------
    def _sh_take(self, bid: int, op: str) -> None:
        """Shadow side of a block entering use from the free set."""
        if bid in self._sh_free:
            self._sh_free.discard(bid)
            self._sh_poison.discard(bid)     # about to be overwritten
        else:
            raise KVSanitizerError(
                f"{op}: block {bid} entered use but the shadow ledger "
                f"does not have it free")

    def _sh_check(self, op: str) -> None:
        """Cross-check every primary structure against the shadow ledger;
        any divergence means an op (or outside tampering) corrupted state
        between the previous check and this one."""
        if len(set(self._free)) != len(self._free):
            raise KVSanitizerError(f"{op}: duplicate free-list entries")
        if set(self._free) != self._sh_free:
            raise KVSanitizerError(
                f"{op}: free list diverged from shadow "
                f"(only-real={sorted(set(self._free) - self._sh_free)}, "
                f"only-shadow={sorted(self._sh_free - set(self._free))})")
        if set(self._mapped) != set(self._sh_slots):
            raise KVSanitizerError(
                f"{op}: mapped slots diverged from shadow")
        mapped: Set[int] = set()
        for s, ids in self._mapped.items():
            mapped.update(ids)
            if ids != self._sh_slots[s]:
                raise KVSanitizerError(
                    f"{op}: slot {s} mapping diverged from shadow")
            if self._n_shared[s] != self._sh_shared[s]:
                raise KVSanitizerError(
                    f"{op}: slot {s} shared count diverged from shadow")
            row = self.table[s]
            if [int(b) for b in row[:len(ids)]] != ids or any(
                    int(b) != TRASH_BLOCK for b in row[len(ids):]):
                raise KVSanitizerError(
                    f"{op}: slot {s} table row diverged from its mapping")
        every = set(range(TRASH_BLOCK + 1, self.n_blocks))
        if self._sh_free | mapped | self._sh_borrowed != every \
                or self._sh_free & mapped:
            raise KVSanitizerError(
                f"{op}: blocks leaked or double-owned "
                f"(free+mapped+borrowed != pool)")
        if self._sh_poison & mapped:
            raise KVSanitizerError(
                f"{op}: poisoned (released) blocks are mapped: "
                f"{sorted(self._sh_poison & mapped)}")
        for b in set(self.refcount) | set(self._sh_rc):
            if self.refcount.get(b, 0) != self._sh_rc.get(b, 0):
                raise KVSanitizerError(
                    f"{op}: refcount of block {b} diverged "
                    f"({self.refcount.get(b, 0)} != shadow "
                    f"{self._sh_rc.get(b, 0)})")

    def check_read(self, slot: int, n_tokens: int) -> None:
        """Raise if reading ``slot``'s first ``n_tokens`` would touch a
        TRASH entry, a block the ledger doesn't map to this slot, or a
        block whose content was released (use-after-free)."""
        if not self.sanitize or n_tokens <= 0:
            return
        ids = self._mapped.get(slot)
        if ids is None:
            raise KVSanitizerError(
                f"use-after-free: read of unmapped slot {slot}")
        need = self.blocks_for(n_tokens)
        if need > len(ids):
            raise KVSanitizerError(
                f"read past allocation: slot {slot} covers {len(ids)} "
                f"block(s) but {n_tokens} tokens need {need}")
        for i in range(need):
            bid = int(self.table[slot, i])
            if bid == TRASH_BLOCK or bid != ids[i]:
                raise KVSanitizerError(
                    f"use-after-free: slot {slot} entry {i} reads block "
                    f"{bid}, ledger maps {ids[i]}")
            if bid in self._sh_poison or self._sh_rc.get(bid, 0) <= 0:
                raise KVSanitizerError(
                    f"use-after-free: slot {slot} entry {i} reads "
                    f"released block {bid}")

    def check_write(self, slot: int, start: int, end: int) -> None:
        """Raise if writing tokens ``[start, end)`` of ``slot`` would land
        in a read-only shared-prefix entry or a block mapped by another
        slot (refcount > 1 — COW must run first)."""
        if not self.sanitize or end <= start:
            return
        ids = self._mapped.get(slot)
        if ids is None:
            raise KVSanitizerError(
                f"use-after-free: write to unmapped slot {slot}")
        last = self.blocks_for(end)
        if last > len(ids):
            raise KVSanitizerError(
                f"write past allocation: slot {slot} covers {len(ids)} "
                f"block(s) but the write ends at token {end}")
        nsh = self._n_shared.get(slot, 0)
        for i in range(start // self.block_size, last):
            bid = ids[i]
            rc = self._sh_rc.get(bid, 0)
            if i < nsh:
                raise KVSanitizerError(
                    f"write to read-only shared-prefix block {bid} "
                    f"(slot {slot} entry {i})")
            if rc > 1 or self.refcount.get(bid, 0) > 1:
                raise KVSanitizerError(
                    f"write to shared block {bid} with refcount {rc} "
                    f"(slot {slot} entry {i}; COW required first)")

    def note_cow(self, src: int, dst: int) -> None:
        """Record a copy-on-write ``src -> dst``: the source's content
        must still be valid and the destination must be a private
        (refcount 1) block."""
        if not self.sanitize:
            return
        if src in self._sh_poison:
            raise KVSanitizerError(
                f"COW reads released block {src} (use-after-free)")
        if self._sh_rc.get(dst, 0) != 1:
            raise KVSanitizerError(
                f"COW into block {dst} with refcount "
                f"{self._sh_rc.get(dst, 0)} != 1")

    # -- reserve / grow / free --------------------------------------------------
    def reserve(self, slot: int, n_tokens: int, live_tokens: int = None,
                shared: Optional[Sequence[int]] = None,
                boundary: Optional[int] = None) -> bool:
        """Book ``slot``'s worst-case ``n_tokens`` in the ledger and
        allocate only the blocks covering ``live_tokens`` (demand paging;
        default = everything up front). All-or-nothing: returns False
        leaving ledger and free list untouched when the reservation or the
        immediate allocation can't be covered.

        ``shared``: full prefix blocks to map read-only (refcount++; blocks
        sitting on the free list are reclaimed content-intact).
        ``boundary``: a partially-matching prefix block to copy-on-write —
        the first FRESH block (``table[slot, len(shared)]``) is its
        destination; the caller copies content before any write lands. The
        boundary source itself is never popped within this reservation."""
        assert slot not in self._mapped, f"slot {slot} already allocated"
        live = n_tokens if live_tokens is None else min(live_tokens, n_tokens)
        sh = list(shared or [])
        assert len(sh) * self.block_size <= live, \
            "shared prefix exceeds the live context"
        n_reclaim = sum(1 for b in sh if self.refcount.get(b, 0) == 0)
        if not self.can_reserve(n_tokens, live, n_shared=len(sh),
                                n_reclaim=n_reclaim):
            return False
        fresh_live = max(0, self.blocks_for(live) - len(sh))
        avoid = set()
        if boundary is not None and self.refcount.get(boundary, 0) == 0:
            # the COW source lives on the free list: it must survive until
            # the caller's copy, so this reservation may not pop it
            avoid.add(boundary)
            if fresh_live + n_reclaim + 1 > len(self._free):
                return False
        for b in sh:
            if self.refcount.get(b, 0) == 0:
                self._reclaim(b)
        fresh = [self._pop_free(avoid) for _ in range(fresh_live)]
        ids = sh + fresh
        for b in ids:
            self.refcount[b] = self.refcount.get(b, 0) + 1
        self._mapped[slot] = ids
        self._n_shared[slot] = len(sh)
        self._reserved[slot] = max(0, self.blocks_for(n_tokens) - len(sh))
        self._tokens[slot] = n_tokens
        self._live[slot] = live
        self.table[slot, :len(ids)] = ids
        self.table[slot, len(ids):] = TRASH_BLOCK
        self.peak_blocks = max(self.peak_blocks, self.blocks_in_use())
        if self.sanitize:
            for b in sh:
                # shared blocks may already be mapped (rc > 0); the ones
                # reclaimed off the free list leave the shadow free set
                if self._sh_rc.get(b, 0) == 0:
                    self._sh_take(b, "reserve")
                self._sh_rc[b] = self._sh_rc.get(b, 0) + 1
            for b in fresh:
                # FRESH blocks must come from the free set, period — a
                # free-list entry aliasing a mapped block trips here
                self._sh_take(b, "reserve")
                self._sh_rc[b] = self._sh_rc.get(b, 0) + 1
            self._sh_slots[slot] = list(ids)
            self._sh_shared[slot] = len(sh)
            self._sh_check("reserve")
        return True

    def alloc(self, slot: int, n_tokens: int) -> bool:
        """Whole-request upfront allocation (the pre-ledger behavior, kept
        as the ``kv_alloc='upfront'`` baseline)."""
        return self.reserve(slot, n_tokens)

    def grow(self, slot: int, n_tokens: int, ahead: int = 0) -> bool:
        """Ensure ``slot``'s allocation covers ``n_tokens``, allocating the
        missing blocks (decode crossed a block boundary) plus up to
        ``ahead`` extra look-ahead blocks when the free list can spare them
        (grow hysteresis — fewer grow dispatches near block boundaries).
        True when the capacity already suffices; False when the free list
        can't cover the REQUIRED part (the caller preempts a victim and
        retries; look-ahead never forces a preemption)."""
        ids = self._mapped.get(slot)
        if self.sanitize and ids is None:
            raise KVSanitizerError(
                f"use-after-free: grow on unmapped slot {slot}")
        assert ids is not None, f"grow on unallocated slot {slot}"
        need = self.blocks_for(n_tokens)
        cap = self._n_shared[slot] + self._reserved[slot]
        assert need <= cap, f"slot {slot} growing past its reservation"
        must = need - len(ids)
        if must <= 0:
            return True
        if must > len(self._free):
            return False
        want = min(need + max(0, ahead), cap) - len(ids)
        take = max(must, min(want, len(self._free)))
        base = len(ids)
        new = [self._pop_free() for _ in range(take)]
        for b in new:
            self.refcount[b] = self.refcount.get(b, 0) + 1
        ids.extend(new)
        self.table[slot, base:base + take] = new
        self.grows += take
        self.peak_blocks = max(self.peak_blocks, self.blocks_in_use())
        if self.sanitize:
            for b in new:
                self._sh_take(b, "grow")
                self._sh_rc[b] = self._sh_rc.get(b, 0) + 1
            self._sh_slots[slot].extend(new)
            self._sh_check("grow")
        return True

    def note_live(self, slot: int, n_tokens: int) -> None:
        """Record tokens actually written to ``slot`` (frag accounting).
        In sanitize mode the live-token DELTA is the declared write range,
        so growing it through a shared block raises."""
        if slot in self._mapped:
            if self.sanitize and n_tokens > self._live[slot]:
                self.check_write(slot, self._live[slot], n_tokens)
            self._live[slot] = n_tokens

    def free(self, slot: int) -> int:
        """Unmap ``slot``'s blocks, release its reservation, zero its table
        row. Shared blocks only return to the pool once their LAST sharer
        frees (refcount 0); returns the number of blocks actually released.
        Released blocks keep their content until reallocated, so a prefix
        index may go on referencing them (``indexed``). Sanitize mode
        raises on double-free (the plain path deliberately no-ops) and on
        refcount underflow, and records content-dead releases in
        ``last_released`` for the engine to poison on device."""
        if self.sanitize and slot not in self._sh_slots:
            raise KVSanitizerError(
                f"double free: slot {slot} has no mapping")
        ids = self._mapped.pop(slot, [])
        self._n_shared.pop(slot, None)
        self._reserved.pop(slot, None)
        self._tokens.pop(slot, None)
        self._live.pop(slot, None)
        released = 0
        dead: List[int] = []
        for bid in reversed(ids):
            if self.sanitize:
                if self.refcount.get(bid, 0) <= 0 \
                        or self._sh_rc.get(bid, 0) <= 0:
                    raise KVSanitizerError(
                        f"refcount underflow on block {bid} freeing "
                        f"slot {slot}")
                self._sh_rc[bid] -= 1
                if self._sh_rc[bid] == 0:
                    self._sh_free.add(bid)
                    if bid not in self.indexed:
                        self._sh_poison.add(bid)
                        dead.append(bid)
            self.refcount[bid] -= 1
            assert self.refcount[bid] >= 0, f"refcount underflow on {bid}"
            if self.refcount[bid] == 0:
                self._free.append(bid)
                released += 1
        self.table[slot, :] = TRASH_BLOCK
        if self.sanitize:
            self._sh_slots.pop(slot)
            self._sh_shared.pop(slot)
            self.last_released = dead
            self._sh_check("free")
        return released

    def free_all(self) -> None:
        for slot in list(self._mapped):
            self.free(slot)

    # -- warm-up (cluster prefix warm path) -------------------------------------
    def warm_blocks(self, n: int) -> Optional[List[int]]:
        """Borrow ``n`` free blocks to fill with a published prefix payload.
        The caller writes their content, registers them with its index, and
        hands them straight back via ``warm_release`` — warm blocks stay on
        the free list (refcount 0, fully reclaimable), so warming NEVER
        reduces usable capacity."""
        if n <= 0 or n > len(self._free):
            return None
        ids = [self._pop_free() for _ in range(n)]
        if self.sanitize:
            for b in ids:
                self._sh_take(b, "warm_blocks")
                self._sh_borrowed.add(b)
            self._sh_check("warm_blocks")
        return ids

    def warm_release(self, ids: Sequence[int]) -> None:
        """Return warm blocks to the BOTTOM of the LIFO free list so they
        are overwritten last."""
        if self.sanitize:
            for b in ids:                     # validate BEFORE mutating
                if b not in self._sh_borrowed:
                    raise KVSanitizerError(
                        f"warm_release of non-borrowed block {b}")
        self._free[:0] = list(ids)
        if self.sanitize:
            for b in ids:
                self._sh_borrowed.discard(b)
                self._sh_free.add(b)
                self._sh_poison.discard(b)    # warm content is valid
            self._sh_check("warm_release")

    # -- introspection ----------------------------------------------------------
    def slot_blocks(self, slot: int) -> List[int]:
        return list(self._mapped.get(slot, []))

    def shared_blocks(self, slot: int) -> int:
        return self._n_shared.get(slot, 0)

    def covered_blocks(self, slot: int) -> int:
        return len(self._mapped.get(slot, ()))

    def blocks_in_use(self) -> int:
        """UNIQUE blocks in use: shared blocks count once however many
        slots map them."""
        return self.n_blocks - 1 - len(self._free)

    def blocks_free(self) -> int:
        return len(self._free)

    def live_tokens(self, slot: int) -> int:
        return self._live.get(slot, 0)

    def frag_tokens(self) -> int:
        """TRUE internal fragmentation: allocated token capacity beyond
        what the owning requests have actually written (live occupancy,
        not the lifetime reservation — mid-flight waste counts)."""
        return sum(len(ids) * self.block_size - self._live[s]
                   for s, ids in self._mapped.items())

    def check_no_leak(self) -> bool:
        """Every non-trash block is either free or mapped (shared blocks by
        several slots, counted once), refcounts match the mappings exactly
        (0 <= refcount; a block returns to the free list only at refcount
        0), and the ledger brackets every slot's allocation:
        live <= allocated capacity, fresh allocated <= fresh reserved."""
        rc: Dict[int, int] = {}
        for ids in self._mapped.values():
            for b in ids:
                rc[b] = rc.get(b, 0) + 1
        mapped = set(rc)
        free = set(self._free)
        if len(free) != len(self._free):             # free-list duplicates
            return False
        if free & mapped or TRASH_BLOCK in free or TRASH_BLOCK in mapped:
            return False
        if free | mapped != set(range(1, self.n_blocks)):
            return False
        for bid, c in self.refcount.items():
            if c < 0 or c != rc.get(bid, 0):
                return False
        if any(bid not in self.refcount for bid in mapped):
            return False
        if not (set(self._mapped) == set(self._reserved) == set(self._live)
                == set(self._n_shared) == set(self._tokens)):
            return False
        if not self.indexed <= set(range(1, self.n_blocks)):
            return False
        return all(self._live[s] <= len(ids) * self.block_size
                   and 0 <= self._n_shared[s] <= len(ids)
                   and len(ids) - self._n_shared[s] <= self._reserved[s]
                   for s, ids in self._mapped.items())
