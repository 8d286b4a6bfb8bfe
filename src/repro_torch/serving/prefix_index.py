"""Block-aligned prefix index for the prefix-sharing KV cache (copy of
``repro/serving/prefix_index.py``, plain Python; the port keeps its own so
that it imports nothing of the JAX package).

Maps token runs to resident pool blocks so admission can reuse the KV of a
shared prompt prefix instead of recomputing it (the largest source of
redundant prefill compute under production traffic with common system
prompts).

Structure — a radix tree over BLOCK-ALIGNED runs, stored flat:

* ``_full``:  tuple(toks[: (i+1) * block_size])  ->  pool block id holding
  that run's last block. An exact-tuple key per depth is the flattened form
  of a radix path; Python's tuple hashing makes lookup O(len) with NO
  collision false-positives (a hash-only index could alias two prompts).
* ``_partial``: tuple(full-block prefix) -> [(block id, tail tokens)] for
  prompts whose last block is only partially filled. A partial match is
  shared by COPY-ON-WRITE: the matching block is copied into the new
  slot's first fresh block before any divergent write lands. At most
  ``max_partials`` divergent tails are kept per aligned prefix; under cap
  pressure the COLDEST tail is evicted — fewest boundary-match hits,
  least-recently-used as the tie-break — so the hot tail survives however
  many one-off suffixes share its boundary block (hit-count LRU; the old
  FIFO evicted the hottest tail first precisely because it arrived
  first).

Indexed blocks may be LIVE (mapped by slots) or FREE (their owners
finished; content stays valid until the block manager reallocates them —
that is what lets a hot prefix survive request completion). The manager
prefers un-indexed free blocks and calls ``invalidate_block`` when it must
overwrite an indexed one.

Sharing always leaves at least ONE token to prefill: the suffix dispatch
must produce logits for the first sampled token, so a full-prompt match is
capped at ``len(prompt) - 1`` tokens.

``hits`` counts matches per full run; ``hot()`` surfaces the most-reused
maximal runs for cluster-wide publication through the tensor store.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.kv_blocks import BlockManager

TokenRun = Tuple[int, ...]


@dataclasses.dataclass
class PrefixMatch:
    n_tokens: int               # shared tokens (full blocks + partial tail)
    full: List[int]             # full shared block ids, prefix order
    boundary: Optional[int]     # partially-shared block to copy-on-write
    boundary_tokens: int        # valid tokens inside the boundary block


class PrefixIndex:
    def __init__(self, block_size: int, bm: BlockManager,
                 max_partials: int = 4):
        self.block_size = block_size
        self.bm = bm
        self.max_partials = max_partials
        self._full: Dict[TokenRun, int] = {}
        self._partial: Dict[TokenRun, List[Tuple[int, TokenRun]]] = {}
        # block id -> entries referencing it, for O(1) invalidation
        self._rev: Dict[int, List[Tuple]] = {}
        self.hits: Dict[TokenRun, int] = {}
        # (pkey, tail) -> [boundary hits, last-touched tick] driving the
        # hit-count LRU eviction of partial entries
        self._pstat: Dict[Tuple[TokenRun, TokenRun], List[int]] = {}
        self._tick = 0

    def __len__(self) -> int:
        return len(self._full) + sum(len(v) for v in self._partial.values())

    # -- insert -----------------------------------------------------------------
    def _link(self, bid: int, entry: Tuple) -> None:
        self._rev.setdefault(bid, []).append(entry)
        self.bm.indexed.add(bid)

    def insert(self, toks: Sequence[int], block_ids: Sequence[int]) -> None:
        """Register a freshly-prefilled context: ``block_ids`` (table
        order) hold its KV. Existing entries win — the first block to hold
        a run keeps serving it, so duplicates never fork the tree."""
        toks = [int(t) for t in toks]
        bs = self.block_size
        n_full = len(toks) // bs
        assert len(block_ids) >= self.bm.blocks_for(len(toks)) or not toks
        for i in range(n_full):
            key = tuple(toks[:(i + 1) * bs])
            if key in self._full:
                continue
            bid = int(block_ids[i])
            self._full[key] = bid
            self.hits.setdefault(key, 0)
            self._link(bid, ("f", key))
        rem = len(toks) - n_full * bs
        if rem > 0:
            pkey = tuple(toks[:n_full * bs])
            tail = tuple(toks[n_full * bs:])
            entries = self._partial.setdefault(pkey, [])
            bid = int(block_ids[n_full])
            if any(t == tail for _, t in entries):
                # duplicate tail re-inserted: evidence of reuse — bump it
                # so it outlives colder tails under cap pressure
                self._pbump(pkey, tail, hit=True)
                return
            if len(entries) >= self.max_partials:
                # hit-count LRU: evict the tail with the fewest boundary
                # hits, least-recently-touched as the tie-break
                old_bid, old_tail = min(
                    entries,
                    key=lambda e: tuple(self._pstat.get((pkey, e[1]),
                                                        [0, 0])))
                entries.remove((old_bid, old_tail))
                self._pstat.pop((pkey, old_tail), None)
                self._unlink(old_bid, ("p", pkey, old_tail))
            entries.append((bid, tail))
            self._pbump(pkey, tail, hit=False)
            self._link(bid, ("p", pkey, tail))

    def _pbump(self, pkey: TokenRun, tail: TokenRun, hit: bool) -> None:
        """Touch a partial entry's LRU stat (optionally counting a hit)."""
        self._tick += 1
        st = self._pstat.setdefault((pkey, tail), [0, 0])
        if hit:
            st[0] += 1
        st[1] = self._tick

    # -- match ------------------------------------------------------------------
    def match(self, toks: Sequence[int]) -> Optional[PrefixMatch]:
        """Longest indexed prefix of ``toks``, capped at ``len(toks) - 1``
        (at least one token must prefill to produce first-token logits).
        Returns None when nothing (useful) matches."""
        toks = [int(t) for t in toks]
        bs = self.block_size
        limit = len(toks) - 1
        full_ids: List[int] = []
        covered = 0
        while covered + bs <= limit:
            bid = self._full.get(tuple(toks[:covered + bs]))
            if bid is None:
                break
            full_ids.append(bid)
            covered += bs
        boundary, btoks, btail = None, 0, None
        pkey = tuple(toks[:covered])
        for bid, tail in self._partial.get(pkey, []):
            t = 0
            cap = min(len(tail), limit - covered)
            while t < cap and tail[t] == toks[covered + t]:
                t += 1
            if t > btoks:
                boundary, btoks, btail = bid, t, tail
        if covered == 0 and btoks == 0:
            return None
        if btail is not None:
            self._pbump(pkey, btail, hit=True)
        if full_ids:
            self.hits[tuple(toks[:covered])] += 1
        return PrefixMatch(covered + btoks, full_ids, boundary, btoks)

    def full_run(self, toks: Sequence[int]) -> List[int]:
        """Block ids of the longest FULLY-indexed block run of ``toks``
        (no one-token cap — used for export, not admission)."""
        toks = [int(t) for t in toks]
        bs, ids = self.block_size, []
        for i in range(len(toks) // bs):
            bid = self._full.get(tuple(toks[:(i + 1) * bs]))
            if bid is None:
                break
            ids.append(bid)
        return ids

    # -- invalidation -----------------------------------------------------------
    def _unlink(self, bid: int, entry: Tuple) -> None:
        entries = self._rev.get(bid)
        if entries is not None and entry in entries:
            entries.remove(entry)
            if not entries:
                del self._rev[bid]
                self.bm.indexed.discard(bid)

    def invalidate_block(self, bid: int) -> None:
        """The manager reallocated an indexed block: its content is about
        to be overwritten, so every entry referencing it — and every DEEPER
        full entry extending through it — must go."""
        for entry in self._rev.pop(bid, []):
            if entry[0] == "f":
                key = entry[1]
                self._full.pop(key, None)
                self.hits.pop(key, None)
                # runs extending through the dead block are unreachable
                # (match walks block-by-block) but would leak; sweep them
                dead = [k for k in self._full
                        if len(k) > len(key) and k[:len(key)] == key]
                for k in dead:
                    b2 = self._full.pop(k)
                    self.hits.pop(k, None)
                    self._unlink(b2, ("f", k))
                deadp = [pk for pk in self._partial
                         if len(pk) >= len(key) and pk[:len(key)] == key]
                for pk in deadp:
                    for b2, tail in self._partial.pop(pk):
                        self._pstat.pop((pk, tail), None)
                        self._unlink(b2, ("p", pk, tail))
            else:
                _, pkey, tail = entry
                entries = self._partial.get(pkey)
                if entries is not None:
                    entries[:] = [(b, t) for b, t in entries
                                  if not (b == bid and t == tail)]
                    if not entries:
                        del self._partial[pkey]
                self._pstat.pop((pkey, tail), None)
        self.bm.indexed.discard(bid)

    # -- hot runs (cluster warm-up) ---------------------------------------------
    def hot(self, min_hits: int = 2) -> List[TokenRun]:
        """Maximal full-block runs matched at least ``min_hits`` times,
        hottest first — candidates for tensor-store publication."""
        cand = [k for k, h in self.hits.items()
                if h >= min_hits and k in self._full]
        maximal = [k for k in cand
                   if not any(len(o) > len(k) and o[:len(k)] == k
                              for o in cand)]
        return sorted(maximal, key=lambda k: (-self.hits[k], len(k)))
