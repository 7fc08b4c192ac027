"""Paged KV state: block pool, block tables, prefix sharing, freeze/thaw.

The dense serving cache allocates ``max_seq`` KV rows per decode slot up
front, so a slot's memory cost is its *worst case* and a request's state
lives and dies with its engine.  This module is the host-side half of
``decode_mode="paged"``:

* :class:`BlockPool` — a refcounted allocator over ``num_blocks`` fixed
  ``block_size``-row KV blocks.  Block 0 is a pinned **trash block**:
  table entries that don't (yet) map a real block point at it, so masked
  decode writes from inactive slots land somewhere harmless and gathers
  of not-yet-written positions read garbage that the causal mask zeroes
  out (``decode_attention`` *replaces* masked scores with ``NEG_INF``,
  so garbage beyond ``pos`` contributes exactly 0 — the paged dense view
  is bit-identical to the dense cache).
* **Block tables** — the pool hands each slot a row of a host
  ``(slots, max_seq // block_size)`` int32 table.  Tables are *runtime
  data*: they ride into the jitted paged step as an ordinary array
  argument of constant shape, so occupancy changes never recompile and
  the :class:`~repro_torch.serving.compile_cache.CompileCache` key stays
  ``(cfg, opts, slots, max_seq, domain)``.
* **Prefix sharing** — prompts are left-padded to power-of-two buckets
  that are always block-aligned, so a prompt's KV occupies whole blocks
  whose content is a pure function of the *padded* token prefix through
  the block (attention is causal).  The pool keeps a chain-hash →
  block index; after a burst prefill, freshly written blocks whose
  hashes already map a live block are merged (the duplicate is freed,
  the survivor increfed) — same-system-prompt admissions share prefill
  blocks, copy-on-write: decode writes always target a private tail
  block, and :meth:`BlockPool.needs_copy` guards the invariant.
* :class:`PrefixCache` — a full-prompt index over finished prefills
  (blocks + the last-position logits row + the non-KV cache leaves), so
  re-admitting an already-seen padded prompt skips the prefill jit call
  entirely: blocks are increfed, the first token is sampled from the
  cached logits row with the request's own key (bit-identical to a real
  prefill), and ``prefill_calls`` does not grow.
* :class:`FrozenRequest` — ``freeze(rid)`` serializes a request's pages
  (trimmed to ``pos`` and densified, so the blob is portable across
  block sizes and into dense engines), its non-KV cache leaves, its
  *advanced* sampling key and its consumed-token count into a host
  blob; ``thaw`` re-materializes it on any engine whose
  ``(cfg, opts, params_version)`` fingerprint matches — zero token
  loss, zero re-prefill.  This is the migration primitive the fleet
  controller uses to move in-flight work off an evicted device.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["DEFAULT_BLOCK_SIZE", "BlockPool", "PrefixCache", "PrefixEntry",
           "FrozenRequest", "block_hash_chain", "blocks_needed"]

DEFAULT_BLOCK_SIZE = 16

# table entries that don't map a real block point here; never allocated
TRASH_BLOCK = 0


def blocks_needed(n_rows: int, block_size: int) -> int:
    """Blocks required to hold ``n_rows`` KV rows."""
    return -(-n_rows // block_size)


def kv_bytes_per_block(n_attn: int, block_size: int, num_kv_heads: int,
                       head_dim: int, kv_dtype: str = "auto",
                       kv_cache_dtype: str = "bfloat16") -> int:
    """Device bytes one pool block costs (K + V, plus int8 scale planes).

    ``kv_dtype`` mirrors ``RuntimeOptions.kv_dtype``: ``"auto"`` stores
    blocks in ``kv_cache_dtype``; ``"int8"`` stores one byte per element
    plus a ``(n_attn, block_size)`` f32 scale plane per side — the
    denominator of the bench's residency-gain axis (how many more slots
    fit in the same pool budget when the KV store is quantized)."""
    elems = n_attn * block_size * num_kv_heads * head_dim
    if kv_dtype == "int8":
        return 2 * (elems + 4 * n_attn * block_size)
    itemsize = {"float32": 4, "bfloat16": 2, "float16": 2,
                "fp8": 1}.get(kv_cache_dtype, 2)
    return 2 * elems * itemsize


def block_hash_chain(padded_tokens: np.ndarray, block_size: int,
                     salt: Any = None) -> List[bytes]:
    """Chain hashes of a left-padded prompt, one per *full* block.

    The hash of block ``b`` covers padded positions ``[0, (b+1)*bs)`` —
    causal attention makes a block's KV content a pure function of that
    prefix — so equal hashes ⇒ bit-identical block content for the same
    ``(cfg, opts, params)``.  ``salt`` folds anything else that changes
    content (e.g. the engine's params_version) into every hash."""
    toks = np.ascontiguousarray(padded_tokens, dtype=np.int32)
    out: List[bytes] = []
    h = hashlib.blake2b(repr(salt).encode(), digest_size=16)
    for b in range(len(toks) // block_size):
        h.update(toks[b * block_size:(b + 1) * block_size].tobytes())
        out.append(h.digest())
        h = hashlib.blake2b(h.digest(), digest_size=16)
    return out


class BlockPool:
    """Host-side refcounted allocator over the device block pool.

    Owns the per-slot block tables and the chain-hash index used for
    prefix dedup.  Purely host bookkeeping — device arrays live in the
    engine; the pool only decides *which* block index goes where."""

    def __init__(self, slots: int, num_blocks: int, block_size: int,
                 max_seq: int):
        if num_blocks < 2:
            raise ValueError("pool needs at least one real block + trash")
        if max_seq % block_size:
            raise ValueError(f"block_size {block_size} must divide "
                             f"max_seq {max_seq}")
        self.slots = slots
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.blocks_per_slot = max_seq // block_size
        self.tables = np.zeros((slots, self.blocks_per_slot), np.int32)
        self.refs = np.zeros(num_blocks, np.int64)
        self.refs[TRASH_BLOCK] = 1          # pinned forever
        self._free: Deque[int] = deque(range(1, num_blocks))
        # chain-hash index for prefix dedup: hash -> live block id
        self._hash_block: Dict[bytes, int] = {}
        self._block_hash: Dict[int, bytes] = {}

    # ------------------------------------------------------------- gauges --
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        """Real blocks currently referenced (trash excluded)."""
        return self.num_blocks - 1 - len(self._free)

    @property
    def shared_blocks(self) -> int:
        return int((self.refs[1:] > 1).sum())

    # -------------------------------------------------------- alloc/free --
    def alloc(self, n: int = 1) -> Optional[List[int]]:
        """``n`` fresh blocks at refcount 1, or ``None`` (nothing taken)
        when the pool can't satisfy the whole request."""
        if len(self._free) < n:
            return None
        ids = [self._free.popleft() for _ in range(n)]
        for b in ids:
            self.refs[b] = 1
        return ids

    def incref(self, bid: int) -> None:
        if bid != TRASH_BLOCK:
            self.refs[bid] += 1

    def decref(self, bid: int) -> bool:
        """Drop one reference; returns True when the block was freed."""
        if bid == TRASH_BLOCK:
            return False
        self.refs[bid] -= 1
        if self.refs[bid] > 0:
            return False
        h = self._block_hash.pop(bid, None)
        if h is not None and self._hash_block.get(h) == bid:
            del self._hash_block[h]
        self._free.append(bid)
        return True

    # ------------------------------------------------------------ tables --
    def assign(self, slot: int, idx: int, bid: int) -> None:
        self.tables[slot, idx] = bid

    def release_slot(self, slot: int) -> int:
        """Drop the slot's references; returns number of blocks freed."""
        freed = 0
        for idx in range(self.blocks_per_slot):
            bid = int(self.tables[slot, idx])
            if bid != TRASH_BLOCK:
                freed += self.decref(bid)
            self.tables[slot, idx] = TRASH_BLOCK
        return freed

    def needs_copy(self, slot: int, pos: int) -> bool:
        """Copy-on-write guard: True when the block the next decode write
        lands in is shared (refcount > 1).  Prompt buckets are
        block-aligned and thawed blocks are private, so this is an
        invariant check rather than a hot path."""
        bid = int(self.tables[slot, pos // self.block_size])
        return bid != TRASH_BLOCK and self.refs[bid] > 1

    # ------------------------------------------------------ prefix dedup --
    def register_hash(self, bid: int, chash: bytes) -> None:
        self._block_hash[bid] = chash
        self._hash_block.setdefault(chash, bid)

    def shared_for(self, chash: bytes) -> Optional[int]:
        """A live block already holding content for this chain hash."""
        bid = self._hash_block.get(chash)
        if bid is not None and self.refs[bid] > 0:
            return bid
        return None

    def dedup_slot_prefix(self, slot: int, hashes: List[bytes]) -> int:
        """After a burst prefill wrote ``len(hashes)`` fresh prompt blocks
        into ``slot``'s table, merge any block whose chain hash already
        maps a live block: the slot adopts the shared block (incref) and
        the freshly written duplicate is freed.  First writer registers.
        Returns the number of blocks merged away."""
        merged = 0
        for idx, chash in enumerate(hashes):
            own = int(self.tables[slot, idx])
            shared = self.shared_for(chash)
            if shared is not None and shared != own:
                self.incref(shared)
                self.decref(own)
                self.tables[slot, idx] = shared
                merged += 1
            else:
                self.register_hash(own, chash)
        return merged


@dataclass
class PrefixEntry:
    """A finished prefill, reusable by any later identical padded prompt.

    Holds pool block ids (the entry owns one reference each), the
    last-position logits row (device array — sampling a new request's
    first token from it with its *own* key reproduces a real prefill bit
    for bit), and the non-KV batch=1 cache leaves at ``pos`` (``pos``;
    an encoder-decoder's cross K/V), copied on the device."""
    block_ids: Tuple[int, ...]
    logits_row: Any                       # (vocab,) device array
    leaves: Dict[str, Any]                # non-KV batch=1 cache leaves
    pos: int
    hits: int = 0


class PrefixCache:
    """LRU full-prompt index: padded-prompt key → :class:`PrefixEntry`.

    Entries hold block references, so a cached prefix survives its
    original request; under pool pressure the engine evicts LRU entries
    to reclaim blocks before declaring exhaustion."""

    def __init__(self, capacity: int = 32):
        self.capacity = capacity
        self._entries: "OrderedDict[Any, PrefixEntry]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def key_of(self, padded_tokens: np.ndarray, salt: Any) -> Any:
        return (repr(salt), len(padded_tokens),
                np.ascontiguousarray(padded_tokens, np.int32).tobytes())

    def lookup(self, key: Any) -> Optional[PrefixEntry]:
        e = self._entries.get(key)
        if e is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        e.hits += 1
        return e

    def insert(self, key: Any, entry: PrefixEntry, pool: BlockPool) -> None:
        if key in self._entries or entry.pos <= 0:
            return
        for bid in entry.block_ids:
            pool.incref(bid)
        self._entries[key] = entry
        while len(self._entries) > self.capacity:
            self._evict_one(pool)

    def _evict_one(self, pool: BlockPool) -> int:
        _, e = self._entries.popitem(last=False)
        return sum(pool.decref(b) for b in e.block_ids)

    def evict_for_blocks(self, n: int, pool: BlockPool) -> int:
        """Free entries (LRU-first) until ``n`` blocks are available or
        the cache is empty.  Returns blocks actually freed."""
        freed = 0
        while pool.free_blocks < n and self._entries:
            freed += self._evict_one(pool)
        return freed

    def clear(self, pool: BlockPool) -> None:
        while self._entries:
            self._evict_one(pool)


@dataclass
class FrozenRequest:
    """A request's serialized in-flight state: everything needed to
    resume decoding on a compatible engine with zero re-prefill.

    ``leaves`` is the batch=1 cache as host (CPU) tensors, with the dense
    ``k``/``v`` trimmed to ``pos`` rows — densified so the blob is
    portable across block sizes, into dense-batched engines and into the
    per-slot reference loop.  ``sample`` carries the *advanced* PRNG key
    plus temperature/top-k, so the thawed stream continues bit-identical
    to the uninterrupted one.  ``fingerprint`` is
    ``(cfg, opts, params_version)``: thawing against different weights
    would silently reuse stale KV, so a mismatch falls back to the
    legacy requeue-with-re-prefill path."""
    rid: int
    pos: int
    consumed: int                          # len(generated) at freeze time
    leaves: Dict[str, Any]
    sample: Dict[str, Any]
    fingerprint: Tuple[Any, Any, Any]
    reason: str = "freeze"

    @property
    def kv_rows(self) -> int:
        k = self.leaves.get("k")
        return 0 if k is None else int(k.shape[2])
