"""Block-granular prompt-prefix KV reuse for the paged engine.

Reference: vLLM's automatic prefix caching (block hashing + refcounted
copy-on-read KV blocks) and the reference's ``ray.llm``
``routing_policies/kv_aware`` prefix-aware routing. A prompt is chunked
into KV-block-sized runs of token ids; each FULL block gets a chain hash
(its tokens mixed with the previous block's hash, so a block's key pins
the entire prefix behind it). After a request prefills, its full prompt
blocks are registered here; a later request whose prompt shares the
prefix matches the longest cached chain and prefills only its suffix.

Ownership model (host-side bookkeeping only — the blocks themselves live
in the engine's device pool):

- a cached block is REFCOUNTED: every admitted request using it holds one
  ref; the engine's release path decrefs instead of freeing.
- refs can drop to zero without eviction: the block stays cached (a warm
  prefix survives between conversation turns) but becomes *evictable* —
  the engine reclaims LRU zero-ref blocks when the free list runs short,
  so caching never deadlocks admission.
- eviction is leaf-first: a block whose chain-children are still cached
  is pinned (evicting a parent would leave unreachable children holding
  pool blocks forever).

Pure host-side data structure: no asyncio, no JAX — unit-testable alone.
All mutation happens from the engine's single admission/step context.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

__all__ = ["PrefixCache", "chain_keys"]


def chain_keys(prompt_ids: List[int], block_size: int) -> List[bytes]:
    """Chain hash per FULL block of the prompt: key_i commits to tokens
    [0, (i+1)*block_size) — equal keys mean equal whole prefixes, so a
    match can splice the cached blocks in without comparing tokens."""
    keys: List[bytes] = []
    prev = b""
    for start in range(0, len(prompt_ids) - block_size + 1, block_size):
        chunk = prompt_ids[start:start + block_size]
        h = hashlib.blake2b(digest_size=16)
        h.update(prev)
        h.update(b",".join(str(int(t)).encode() for t in chunk))
        prev = h.digest()
        keys.append(prev)
    return keys


@dataclass
class _Entry:
    block: int                   # physical block id in the engine pool
    refs: int = 0                # admitted requests currently using it
    parent: Optional[bytes] = None
    children: Set[bytes] = field(default_factory=set)
    last_use: int = 0            # LRU tick


class PrefixCache:
    def __init__(self, block_size: int, max_entries: int = 4096):
        self.block_size = int(block_size)
        self.max_entries = int(max_entries)
        self._entries: Dict[bytes, _Entry] = {}
        self._by_block: Dict[int, bytes] = {}
        self._tick = 0
        # counters surfaced through engine stats / the metrics plane
        self.hits = 0            # match() calls that reused >= 1 block
        self.block_hits = 0      # total blocks served from cache
        self.misses = 0
        self.evictions = 0

    # -- lookup -----------------------------------------------------------

    def match(self, keys: List[bytes]) -> List[int]:
        """Blocks for the longest cached prefix of ``keys``, INCREF'd —
        the caller owns one ref per returned block and must decref via
        :meth:`decref_block` (the engine's release path) or
        :meth:`cancel_match` on admission failure."""
        self._tick += 1
        out: List[int] = []
        for k in keys:
            e = self._entries.get(k)
            if e is None:
                break
            e.refs += 1
            e.last_use = self._tick
            out.append(e.block)
        if out:
            self.hits += 1
            self.block_hits += len(out)
        else:
            self.misses += 1
        return out

    def cancel_match(self, blocks: List[int]):
        for b in blocks:
            self.decref_block(b)

    # -- registration -----------------------------------------------------

    def register(self, keys: List[bytes], blocks: List[int]) -> List[int]:
        """Cache a freshly prefilled prompt's full blocks. ``blocks[i]``
        holds the KV for chain key ``keys[i]``. Entries that already exist
        (the matched prefix, already ref'd by this request via match) are
        left alone; new tails are inserted with refs=1 — the registering
        request's own ref. Returns blocks evicted to respect max_entries
        (hand them back to the engine's free list)."""
        evicted: List[int] = []
        self._tick += 1
        prev: Optional[bytes] = None
        for k, b in zip(keys, blocks):
            e = self._entries.get(k)
            if e is not None:
                # already cached (this request matched it, or an identical
                # cold request registered first) — never double-insert; if
                # the existing entry maps a DIFFERENT physical block, this
                # request's private copy stays uncached and frees normally
                e.last_use = self._tick
                prev = k
                continue
            if int(b) in self._by_block:
                # this physical block already backs another chain (should
                # not happen with disjoint allocation, but never corrupt
                # the block->key map)
                prev = None
                continue
            if len(self._entries) >= self.max_entries:
                evicted.extend(self.evict(1))
                if len(self._entries) >= self.max_entries:
                    break  # everything left is pinned; stop caching
            e = _Entry(block=int(b), refs=1, parent=prev,
                       last_use=self._tick)
            self._entries[k] = e
            self._by_block[int(b)] = k
            if prev is not None and prev in self._entries:
                self._entries[prev].children.add(k)
            prev = k
        return evicted

    # -- release / eviction ----------------------------------------------

    def decref_block(self, block: int) -> bool:
        """True if the block is cache-owned (it stays resident, evictable
        once refs hit zero); False = not ours, caller frees it."""
        k = self._by_block.get(int(block))
        if k is None:
            return False
        e = self._entries[k]
        e.refs = max(0, e.refs - 1)
        return True

    def owns_block(self, block: int) -> bool:
        return int(block) in self._by_block

    def _evictable(self) -> List[bytes]:
        """Zero-ref LEAF entries (no cached children), oldest first."""
        out = [
            k for k, e in self._entries.items()
            if e.refs == 0 and not (e.children & self._entries.keys())
        ]
        out.sort(key=lambda k: self._entries[k].last_use)
        return out

    def evict(self, want: int) -> List[int]:
        """Free up to ``want`` blocks from zero-ref subtrees (LRU leaves
        first, walking toward roots as leaves fall). Returns the physical
        blocks for the engine's free list."""
        freed: List[int] = []
        while len(freed) < want:
            leaves = self._evictable()
            if not leaves:
                break
            for k in leaves:
                if len(freed) >= want:
                    break
                e = self._entries.pop(k)
                self._by_block.pop(e.block, None)
                if e.parent is not None and e.parent in self._entries:
                    self._entries[e.parent].children.discard(k)
                freed.append(e.block)
                self.evictions += 1
        return freed

    def clear(self) -> List[int]:
        """Drop everything (device pool was rebuilt — the cached blocks no
        longer hold valid KV). Returns all previously cached blocks."""
        blocks = [e.block for e in self._entries.values()]
        self._entries.clear()
        self._by_block.clear()
        return blocks

    # -- introspection ----------------------------------------------------

    def __len__(self) -> int:
        return len(self._entries)

    def evictable_blocks(self) -> int:
        """Blocks reclaimable RIGHT NOW plus those pinned only by cached
        children — i.e. every cached block no active request holds. The
        engine counts these as available capacity (repeated eviction
        rounds reach the whole zero-ref subtree)."""
        return sum(1 for e in self._entries.values() if e.refs == 0)

    def stats(self) -> dict:
        return {
            "entries": len(self._entries),
            "evictable": self.evictable_blocks(),
            "hits": self.hits,
            "block_hits": self.block_hits,
            "misses": self.misses,
            "evictions": self.evictions,
        }
