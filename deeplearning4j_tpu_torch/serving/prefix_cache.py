"""Content-addressed prefix index for cross-request KV page sharing — a
copy of the JAX package's `serving/prefix_cache.py` (framework-free host
code; the port keeps its own copy so it never imports that package).

A radix trie keyed on page-aligned token-id CHUNKS (one chunk = one full
page's worth of token ids), where each node owns exactly one physical
pool page whose K/V holds that chunk, written by some earlier request's
prefill.

The index stores only bookkeeping — token tuples and page ids. All
policy (refcounts, copy-on-write forks, when a page may be freed) lives
in `decode_loop.DecodeLoop`, which owns the pool:

- `match(prompt)` walks the trie over the prompt's full chunks and
  returns the longest cached run of page ids (LRU-touching every node
  on the path). Only FULL chunks match.
- `insert(tokens, pages, skip=)` adopts a retired request's full prompt
  pages chunk-by-chunk; chunks already present keep their existing page,
  and the walk stops at the first page in `skip` (forked pages — their
  bytes diverged from the pure token sequence).
- `evict_lru(evictable)` removes the least-recently-used LEAF whose
  page the caller's predicate allows (refcount zero) and hands its page
  back for reallocation. Leaf-only eviction keeps every cached path
  gap-free.

The trie never touches device memory: sharing pool pages between slots
is pure page-table bookkeeping.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["PrefixIndex"]

_Chunk = Tuple[int, ...]


class _Node:
    __slots__ = ("chunk", "page", "parent", "children", "tick")

    def __init__(self, chunk: _Chunk, page: int,
                 parent: Optional["_Node"]):
        self.chunk = chunk
        self.page = page
        self.parent = parent
        self.children: Dict[_Chunk, "_Node"] = {}
        self.tick = 0


class PrefixIndex:
    """Radix trie over page-aligned token chunks -> pool page ids."""

    def __init__(self, page_size: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = int(page_size)
        self._roots: Dict[_Chunk, _Node] = {}
        self._by_page: Dict[int, _Node] = {}
        self._tick = 0

    def __len__(self) -> int:
        return len(self._by_page)

    def owns(self, page: int) -> bool:
        """True when this page's K/V is retained by the index (it must
        not be written in place or returned to the free list while the
        node lives)."""
        return int(page) in self._by_page

    def pages(self):
        """View of every page the index retains."""
        return self._by_page.keys()

    def iter_sequences(self):
        """Yield every MAXIMAL cached token sequence (root-to-leaf token
        path, one flat list per leaf), most recently touched leaf
        first. This is the corpus view the prompt-lookup drafter feeds
        on (serving/speculation.NgramDrafter): the trie already retains
        the recent prompt population, so speculative decoding gets its
        n-gram source for free — no second index, no device reads."""
        leaves = [n for n in self._by_page.values() if not n.children]
        leaves.sort(key=lambda n: n.tick, reverse=True)
        for leaf in leaves:
            parts: List[_Chunk] = []
            node: Optional[_Node] = leaf
            while node is not None:
                parts.append(node.chunk)
                node = node.parent
            yield [t for chunk in reversed(parts) for t in chunk]

    def head_paths(self, max_chunks: int = 16):
        """Yield every cached token path (root-to-leaf, most recently
        touched leaf first) truncated to its first `max_chunks` chunks
        — the fleet KV plane's summary corpus (ROADMAP item 10e).
        Affinity fingerprints only ever cover the HEAD of a path, so
        deep generation tails are cut before flattening; duplicates
        from leaves sharing a head collapse in the caller's hash
        dedup. Only retained tokens appear: a request that opted out
        of the prefix cache never seeded the trie, so nothing about
        it can surface here."""
        leaves = [n for n in self._by_page.values() if not n.children]
        leaves.sort(key=lambda n: n.tick, reverse=True)
        for leaf in leaves:
            parts: List[_Chunk] = []
            node: Optional[_Node] = leaf
            while node is not None:
                parts.append(node.chunk)
                node = node.parent
            head = list(reversed(parts))[:max_chunks]
            yield [t for chunk in head for t in chunk]

    def _chunks(self, tokens: Sequence[int]) -> List[_Chunk]:
        ps = self.page_size
        return [tuple(int(t) for t in tokens[j * ps:(j + 1) * ps])
                for j in range(len(tokens) // ps)]

    # ------------------------------------------------------- lookup
    def match(self, prompt: Sequence[int]) -> List[int]:
        """Longest cached prefix of `prompt` as a run of page ids, one
        per matched FULL chunk, LRU-touching the whole path."""
        self._tick += 1
        out: List[int] = []
        children = self._roots
        for chunk in self._chunks(prompt):
            node = children.get(chunk)
            if node is None:
                break
            node.tick = self._tick
            out.append(node.page)
            children = node.children
        return out

    # ------------------------------------------------------- insert
    def insert(self, tokens: Sequence[int], pages: Sequence[int],
               skip=()) -> int:
        """Adopt `pages[j]` for chunk j of `tokens` wherever the trie
        has no entry yet; returns how many pages were adopted. Existing
        chunks keep their page (the caller frees its duplicate via the
        normal refcount release). Stops at the first chunk whose page
        is in `skip` or already owned — adopting it would alias one
        physical page under two nodes."""
        self._tick += 1
        adopted = 0
        children = self._roots
        parent: Optional[_Node] = None
        for j, chunk in enumerate(self._chunks(tokens)):
            if j >= len(pages):
                break
            node = children.get(chunk)
            if node is None:
                page = int(pages[j])
                if page in skip or page in self._by_page:
                    break
                node = _Node(chunk, page, parent)
                children[chunk] = node
                self._by_page[page] = node
                adopted += 1
            node.tick = self._tick
            parent = node
            children = node.children
        return adopted

    # ------------------------------------------------------- evict
    def evict_lru(self, evictable: Callable[[int], bool]
                  ) -> Optional[int]:
        """Drop the least-recently-used LEAF whose page satisfies
        `evictable` (the loop passes refcount == 0); returns the freed
        page id, or None when nothing can go."""
        best: Optional[_Node] = None
        for node in self._by_page.values():
            if node.children:
                continue
            if not evictable(node.page):
                continue
            if best is None or node.tick < best.tick:
                best = node
        if best is None:
            return None
        if best.parent is None:
            del self._roots[best.chunk]
        else:
            del best.parent.children[best.chunk]
        del self._by_page[best.page]
        return best.page

    def snapshot(self) -> dict:
        return {"nodes": len(self._by_page),
                "roots": len(self._roots)}
