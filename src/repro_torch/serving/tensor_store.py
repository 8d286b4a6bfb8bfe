"""Shared tensor store — paper §5.2 (port of ``repro/serving/tensor_store.py``).

The paper's store is a separate process exporting CUDA-IPC handles so that a
NEW inference-engine process can attach to model weights already resident in
GPU memory, decoupling the engine lifecycle from weight lifetime and
avoiding the duplicate-allocation OOM that forces vLLM to terminate the old
engine before starting the new one.

As in the reference, the store lives in the serving process: weights live in
the store, keyed by (model, partition); engines hold references, never
copies. Creating a new engine against a partition already in the store is
O(1) — ``attach`` returns the same ``torch.Tensor`` objects (no copy, no
``.to()``), so on the card an attached engine pins no second copy of its
weights — while a cold partition pays the (simulated or real) load cost
once. The store also tracks load timings so concurrent-initialization
benchmarks can report the paper's Fig-16 breakdown.

Beyond weights, the store carries migrated KV-block payloads (one key per
interrupted request — see serving/server.py), so residency is no longer
monotone: ``evict_to`` reclaims unreferenced keys in LRU order down to a
byte budget (``budget_bytes`` enforces it automatically on every insert),
keeping published KV from pinning memory forever.

Accounting invariant (regression-tested): every resident key has exactly
one entry in each of the params/refcount/bytes/LRU maps, whichever path
inserted it (``put``, ``put_or_attach`` or ``load``), so
``resident_bytes``/``refcount`` can never drift between paths.

SANITIZER MODE (``TensorStore(sanitize=True)`` or ``REPRO_KV_SANITIZE=1``,
same switch as the BlockManager shadow ledger): a shadow ledger mirrors
every publish/evict/pin/refcount transition through the store's own
notification points and cross-checks the real maps after every operation.
It turns silent misuse into typed errors at the offending call:

- ``DoubleEvictError``    — a key dropped that the ledger says is not
                            resident (evicted twice, or never published)
- ``PinnedEvictError``    — a key dropped while the ledger holds
                            references on it (an engine still attached)
- ``RefcountUnderflowError`` — ``detach`` on a key with no outstanding
                            reference (unbalanced attach/detach)
- ``StoreSanitizerError`` — shadow/real divergence: some path mutated
                            store state without going through the single
                            bookkeeping path

The tolerant production behavior (``detach`` no-ops on underflow, ``take``
returns None) is unchanged when disarmed.

BANDWIDTH HOOK: ``on_transfer(kind, nbytes)`` fires on every byte-moving
operation ("put" inserts, "take" consumes, "load" cold loads) so a host —
e.g. the discrete-event cluster simulator's ``NetworkLink`` — can account
store traffic on a contended link instead of assuming it free.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

Key = Tuple[str, str]


class StoreSanitizerError(RuntimeError):
    """A TensorStore accounting invariant was violated (sanitize mode)."""


class DoubleEvictError(StoreSanitizerError):
    """A key was dropped that the shadow ledger has no record of."""


class PinnedEvictError(StoreSanitizerError):
    """A key was dropped while references were still outstanding."""


class RefcountUnderflowError(StoreSanitizerError):
    """``detach`` on a key with no outstanding reference."""


def _env_sanitize() -> bool:
    return os.environ.get("REPRO_KV_SANITIZE", "0").lower() not in (
        "", "0", "false", "off")


class _StoreShadow:
    """Independent mirror of the store's residency/refcount state.

    Maintained through explicit transition notifications (never by reading
    the store's maps), so a store-side bookkeeping bug shows up as a
    divergence instead of being silently mirrored."""

    def __init__(self) -> None:
        self.entries: Dict[Key, list] = {}    # key -> [refcount, nbytes]

    def on_register(self, key: Key, nbytes: int) -> None:
        e = self.entries.get(key)
        if e is None:
            self.entries[key] = [0, nbytes]
        else:
            e[1] = nbytes          # re-publish over a resident key

    def on_acquire(self, key: Key) -> None:
        if key not in self.entries:
            raise DoubleEvictError(
                f"attach of non-resident key {key} (evicted or never put)")
        self.entries[key][0] += 1

    def on_detach(self, key: Key) -> None:
        e = self.entries.get(key)
        if e is None or e[0] <= 0:
            raise RefcountUnderflowError(
                f"detach of key {key} with no outstanding reference")
        e[0] -= 1

    def on_drop(self, key: Key) -> None:
        e = self.entries.get(key)
        if e is None:
            raise DoubleEvictError(f"evict of non-resident key {key} "
                                   "(double evict)")
        if e[0] > 0:
            raise PinnedEvictError(
                f"evict of key {key} with refcount {e[0]} "
                "(engines still attached)")
        del self.entries[key]

    def crosscheck(self, store: "TensorStore", op: str) -> None:
        real_keys = set(store._store)
        if real_keys != set(self.entries):
            raise StoreSanitizerError(
                f"after {op}: resident keys diverged "
                f"(store-only={real_keys - set(self.entries)}, "
                f"shadow-only={set(self.entries) - real_keys})")
        for k, (rc, nb) in self.entries.items():
            if store._refcount.get(k, 0) != rc:
                raise StoreSanitizerError(
                    f"after {op}: refcount of {k} diverged "
                    f"(store={store._refcount.get(k, 0)}, shadow={rc})")
            if store._bytes.get(k, -1) != nb:
                raise StoreSanitizerError(
                    f"after {op}: bytes of {k} diverged "
                    f"(store={store._bytes.get(k, -1)}, shadow={nb})")


@dataclasses.dataclass
class LoadRecord:
    key: Key
    wall_s: float
    cold: bool


class TensorStore:
    def __init__(self, load_time_model: Optional[Callable[[int], float]] = None,
                 budget_bytes: Optional[int] = None,
                 pin_hot_k: int = 0,
                 sanitize: Optional[bool] = None,
                 on_transfer: Optional[Callable[[str, int], None]] = None):
        """load_time_model: bytes -> seconds, used by the virtual clock to
        model remote-storage fetch (paper: custom raw-binary shards so each
        node downloads only its partition). budget_bytes: soft cap enforced
        by LRU eviction of unreferenced keys on every insert (None = no
        cap; referenced keys are never evicted, so the store may exceed the
        budget while every byte is pinned). pin_hot_k: budget-capped LRU
        additionally skips the top-k keys by read-hit count — a hot
        published prefix is read (``peek``/``attach``) far more often than
        it is inserted, so pure recency would evict exactly the payload
        every pipeline warms from (``evict_unreferenced`` still reclaims
        everything). sanitize: arm the shadow ledger (None = follow
        REPRO_KV_SANITIZE). on_transfer: ``f(kind, nbytes)`` byte-movement
        hook ("put" inserts, "take" consumes) for link accounting."""
        self._store: Dict[Key, Any] = {}
        self._refcount: Dict[Key, int] = {}
        self._bytes: Dict[Key, int] = {}
        self._last_used: Dict[Key, int] = {}
        self._hits: Dict[Key, int] = {}
        self._clock = 0
        self.loads: list[LoadRecord] = []
        self.load_time_model = load_time_model or (lambda nbytes: 0.0)
        self.budget_bytes = budget_bytes
        self.pin_hot_k = pin_hot_k
        self.sanitize = _env_sanitize() if sanitize is None else sanitize
        self._shadow = _StoreShadow() if self.sanitize else None
        self.on_transfer = on_transfer

    # -- internal bookkeeping (single path for every insert/acquire) ------------
    def _check(self, op: str) -> None:
        if self._shadow is not None:
            self._shadow.crosscheck(self, op)

    def _touch(self, key: Key) -> None:
        self._clock += 1
        self._last_used[key] = self._clock

    def _register(self, key: Key, params: Any) -> None:
        self._store[key] = params
        self._bytes[key] = _tree_bytes(params)
        self._refcount.setdefault(key, 0)
        self._touch(key)
        if self._shadow is not None:
            self._shadow.on_register(key, self._bytes[key])
        if self.on_transfer is not None:
            self.on_transfer("put", self._bytes[key])
        if self.budget_bytes is not None:
            self.evict_to(self.budget_bytes)

    def _hit(self, key: Key) -> None:
        self._hits[key] = self._hits.get(key, 0) + 1

    def _acquire(self, key: Key) -> Any:
        if self._shadow is not None:
            self._shadow.on_acquire(key)
        self._refcount[key] += 1
        self._hit(key)
        self._touch(key)
        return self._store[key]

    # -- public API -------------------------------------------------------------
    def put(self, model: str, partition: str, params: Any) -> None:
        """Publish without acquiring: the key is resident at refcount 0
        (evictable) until someone attaches."""
        self._register((model, partition), params)
        self._check("put")

    def contains(self, model: str, partition: str) -> bool:
        return (model, partition) in self._store

    def attach(self, model: str, partition: str) -> Any:
        """Zero-copy: returns the stored arrays themselves."""
        out = self._acquire((model, partition))
        self._check("attach")
        return out

    def put_or_attach(self, model: str, partition: str,
                      params: Any) -> Tuple[Any, bool]:
        """Idempotent publish: the first caller stores the partition (cold);
        every later caller attaches to the resident arrays. Returns
        (params, cold) — the concurrent-initialization fast path, §5.2."""
        key = (model, partition)
        cold = key not in self._store
        if cold:
            self._register(key, params)
        out = self._acquire(key), cold
        self._check("put_or_attach")
        return out

    def peek(self, model: str, partition: str) -> Optional[Any]:
        """Non-consuming read: return the resident params (or None) WITHOUT
        acquiring a reference or dropping the key. Multi-consumer payloads
        — e.g. shared-prefix warm-up, where every new pipeline reads the
        same published blocks — use this instead of ``take``. Touches the
        LRU clock so hot payloads outlive cold ones under a byte budget."""
        key = (model, partition)
        if key not in self._store:
            return None
        self._hit(key)
        self._touch(key)
        return self._store[key]

    def keys(self, model: Optional[str] = None) -> list[Key]:
        """Resident (model, partition) keys, LRU order (stalest first),
        optionally filtered to one model namespace."""
        ks = sorted(self._store, key=lambda k: self._last_used[k])
        return [k for k in ks if model is None or k[0] == model]

    def take(self, model: str, partition: str) -> Optional[Any]:
        """Consume a key: return its params and drop it from the store
        (single-consumer payloads, e.g. a migrated request's KV blocks).
        None when absent — or when the key is PINNED (refcount > 0):
        ``evict_to`` promises referenced keys stay resident, so consuming
        one would yank a partition out from under its attached engines."""
        key = (model, partition)
        if key not in self._store or self._refcount.get(key, 0) > 0:
            return None
        params = self._store[key]
        nbytes = self._bytes.get(key, 0)
        self._drop(key)
        if self.on_transfer is not None:
            self.on_transfer("take", nbytes)
        self._check("take")
        return params

    def resident_bytes(self) -> int:
        """Total bytes pinned by the store (capacity-planning metric)."""
        return sum(self._bytes.values())

    def detach(self, model: str, partition: str) -> None:
        key = (model, partition)
        if self._shadow is not None:
            self._shadow.on_detach(key)     # raises on underflow
        if key in self._refcount and self._refcount[key] > 0:
            self._refcount[key] -= 1
        self._check("detach")

    def refcount(self, model: str, partition: str) -> int:
        return self._refcount.get((model, partition), 0)

    def hits(self, model: str, partition: str) -> int:
        """Read hits (peek/attach) recorded against a key."""
        return self._hits.get((model, partition), 0)

    def hot_keys(self) -> list[Key]:
        """The resident keys pinned by ``pin_hot_k`` (top-k by hit count,
        hottest first; zero-hit keys never pin)."""
        if self.pin_hot_k <= 0:
            return []
        ranked = sorted(
            (k for k in self._store if self._hits.get(k, 0) > 0),
            key=lambda k: (-self._hits[k], -self._last_used[k]))
        return ranked[:self.pin_hot_k]

    def _drop(self, key: Key) -> None:
        if self._shadow is not None:
            self._shadow.on_drop(key)       # raises on double/pinned evict
        self._store.pop(key, None)
        self._refcount.pop(key, None)
        self._bytes.pop(key, None)
        self._last_used.pop(key, None)
        self._hits.pop(key, None)

    def evict_unreferenced(self) -> int:
        """Drop partitions with no attached engine (memory reclamation)."""
        dead = [k for k, c in self._refcount.items() if c == 0]
        for k in dead:
            self._drop(k)
        self._check("evict_unreferenced")
        return len(dead)

    def evict_to(self, budget_bytes: int) -> int:
        """LRU-evict unreferenced keys until ``resident_bytes`` fits the
        budget (referenced keys are pinned and never touched; so are the
        ``pin_hot_k`` hottest keys by hit count — the budget may stay
        exceeded rather than evict the prefix every pipeline warms from).
        Returns bytes freed."""
        freed = 0
        resident = self.resident_bytes()
        hot = set(self.hot_keys())
        victims = sorted((k for k, c in self._refcount.items()
                          if c == 0 and k not in hot),
                         key=lambda k: self._last_used[k])
        for k in victims:
            if resident <= budget_bytes:
                break
            freed += self._bytes[k]
            resident -= self._bytes[k]
            self._drop(k)
        self._check("evict_to")
        return freed

    def load(self, model: str, partition: str,
             loader: Callable[[], Any]) -> Tuple[Any, float]:
        """Fetch-or-load. Returns (params, virtual_load_seconds)."""
        key = (model, partition)
        if key in self._store:
            self.loads.append(LoadRecord(key, 0.0, cold=False))
            out = self._acquire(key), 0.0
            self._check("load")
            return out
        t0 = time.perf_counter()
        params = loader()
        virtual = self.load_time_model(_tree_bytes(params))
        self._register(key, params)
        self.loads.append(LoadRecord(key, time.perf_counter() - t0,
                                     cold=True))
        out = self._acquire(key), virtual
        self._check("load")
        return out

    def check_consistent(self) -> bool:
        """The accounting invariant: all four maps key-identical."""
        keys = set(self._store)
        return (keys == set(self._refcount) == set(self._bytes)
                == set(self._last_used))


def _tree_bytes(tree: Any) -> int:
    """Bytes of every tensor in a nested dict / list / tuple; any other
    leaf (a position, a block size, an arch name) counts 0. A KV payload on
    the card pins these bytes of HBM until it is taken or evicted."""
    if isinstance(tree, torch.Tensor):
        return tree.nbytes
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return 0
