"""Paged KV cache for serving, ported from ``workloads/paged.py``.

The cache is a POOL of fixed-size pages plus a per-sequence page table.
Page allocation is host-side Python (``PagePool``); the device side is
two tensors (k, v), each ``[layers, n_pages + 1, kv_heads, page_size,
head_dim]`` with the head axis inside the page, so one (page, kv head)
tile is contiguous.  The extra LAST page is the TRASH page: table
padding and parked rows point at it, so writes from padded prompt
positions or empty batch slots land somewhere harmless.

Where the JAX package returns new pools from jitted functions that
donate the old ones, the port updates the pools IN PLACE and returns the
same tensors.  Decode runs the paged-attention kernel
(``ops.paged_attention``) over each row's live pages; prefill gathers a
dense view of the prompt's pages, runs ``generate.decode_block`` over it
and scatters the pages back.

The prefix indexes (``PrefixCache``, ``RadixKV`` and their
``_chain_key``) are host control plane over ``PagePool``'s refcounts,
copied from the JAX package; the engine moves their pages' bytes with
``read_pages``/``write_page``.

JAX clamps out-of-range gather indices; torch raises (CPU) or faults
(CUDA).  Every index the JAX code relied on clamping is made explicitly
in range here: the decode write column and the emitted-logits row.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field

import torch

from . import prng, resolve_device
from .generate import decode_block, filter_logits, sample_logits
from .model import (
    ModelConfig,
    _rmsnorm,
    apply_rope,
    causal_mask,
    masked_attention,
    project_qkv,
    rope_tables,
    weight,
)
from .moe import ffn
from .multi_lora import apply_qkv, apply_wo
from .ops.paged_attention import paged_attention


@dataclass
class PagePool:
    """Host-side control plane: which physical pages are free, and each
    sequence's page table.  Hands out indices 0 .. n_pages-1; the device
    pools' extra trash page at index ``n_pages`` is never allocated."""

    n_pages: int
    page_size: int
    free: list = field(init=False)
    tables: dict = field(init=False, default_factory=dict)  # seq_id -> [int]
    refcounts: dict = field(init=False, default_factory=dict)  # page -> int
    # High-water mark of concurrently held pages.
    peak_used: int = field(init=False, default=0)

    def __post_init__(self):
        self.free = list(range(self.n_pages - 1, -1, -1))

    @property
    def trash(self) -> int:
        """The sacrificial page index in the device pools (which hold
        n_pages + 1 pages): table padding should point here."""
        return self.n_pages

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def allocate(self, seq_id, n_tokens: int) -> list:
        """A fresh table covering ``n_tokens`` positions."""
        if seq_id in self.tables:
            raise ValueError(
                f"sequence {seq_id!r} already holds a table — release it "
                "first (silently replacing it would leak its pages)"
            )
        need = self.pages_needed(n_tokens)
        if len(self.free) < need:
            raise RuntimeError(
                f"page pool exhausted: need {need}, free {len(self.free)}"
            )
        table = [self.free.pop() for _ in range(need)]
        for p in table:
            self.refcounts[p] = 1
        self.tables[seq_id] = table
        self.peak_used = max(self.peak_used, self.used_pages)
        return table

    def extend(self, seq_id, n_tokens: int) -> list:
        """Grow ``seq_id``'s table to cover ``n_tokens`` positions."""
        table = self.tables[seq_id]
        while len(table) < self.pages_needed(n_tokens):
            if not self.free:
                raise RuntimeError("page pool exhausted")
            page = self.free.pop()
            self.refcounts[page] = 1
            table.append(page)
        self.peak_used = max(self.peak_used, self.used_pages)
        return table

    def fork(self, parent_id, child_id, shared_tokens: int) -> list:
        """A child sequence sharing the parent's full pages for the prefix
        of ``shared_tokens`` positions (read-only sharing); the fork point
        must be a page boundary."""
        if child_id in self.tables:
            raise ValueError(
                f"sequence {child_id!r} already holds a table — release it "
                "first (silently replacing it would leak its pages)"
            )
        if shared_tokens % self.page_size:
            raise ValueError(
                f"fork point {shared_tokens} is not a multiple of "
                f"page_size {self.page_size}: a partial tail page cannot "
                "be shared — fork at a page boundary (and replay the "
                "remainder into the child)"
            )
        shared = self.tables[parent_id][: shared_tokens // self.page_size]
        for p in shared:
            self.refcounts[p] += 1
        self.tables[child_id] = list(shared)
        return self.tables[child_id]

    def release(self, seq_id) -> None:
        for p in self.tables.pop(seq_id):
            self._unref(p)

    def take_page(self) -> int:
        """Claim one free page with no table attached (refcount 1, owned
        by the caller).  Pair with release_page."""
        if not self.free:
            raise RuntimeError("page pool exhausted: no free page to take")
        page = self.free.pop()
        self.refcounts[page] = 1
        self.peak_used = max(self.peak_used, self.used_pages)
        return page

    def retain_page(self, page: int) -> None:
        """Pin one allocated page independently of any table.  Pair with
        release_page."""
        if page not in self.refcounts:
            raise ValueError(f"page {page} is not allocated")
        self.refcounts[page] += 1

    def release_page(self, page: int) -> None:
        self._unref(page)

    def _unref(self, page: int) -> None:
        self.refcounts[page] -= 1
        if self.refcounts[page] == 0:
            del self.refcounts[page]
            self.free.append(page)

    def adopt(self, seq_id, pages: list) -> list:
        """A fresh table referencing already-allocated pages (read-only
        sharing from an explicit page list)."""
        if seq_id in self.tables:
            raise ValueError(
                f"sequence {seq_id!r} already holds a table — release it "
                "first (silently replacing it would leak its pages)"
            )
        for p in pages:
            if p not in self.refcounts:
                raise ValueError(f"page {p} is not allocated")
        for p in pages:
            self.refcounts[p] += 1
        self.tables[seq_id] = list(pages)
        return self.tables[seq_id]

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self.free)


def _chain_key(prev: bytes, block: list[int]) -> bytes:
    """One chain-hash step: the digest committing to ``block`` AND every
    block before it (``prev`` is the previous digest, or the salt for
    block 0).  Shared by the flat PrefixCache and the RadixKV tree so
    their key spaces cannot drift."""
    h = hashlib.blake2b(digest_size=16)
    h.update(prev)
    h.update(b",".join(str(t).encode() for t in block))
    return h.digest()


class PrefixCache:
    """Cross-request prefix index over a PagePool: token blocks → the
    physical pages already holding their k/v.  The FLAT baseline of the
    KV-cache hierarchy — ``RadixKV`` below supersedes it as the
    engine's default (``prefix_cache=True``); this stays as
    ``prefix_cache="flat"``, the comparison arm.

    Two independent requests with the same system prompt should not
    re-prefill it, nor store its k/v twice.  Keys are CHAIN hashes of
    page-sized token blocks (block i's key commits to every token before
    it, so equal keys mean equal full prefixes); values are page indices
    pinned through the pool's refcounts (``retain_page``), so a cached
    page can never be freed or reallocated under an active reader.
    Eviction is LRU over entries whose page no live sequence shares
    (refcount == 1, index-only) — called by the engine exactly when an
    allocation would otherwise exhaust the pool, so an idle cache can
    hold every free page at zero cost.

    Hit granularity is the caller's choice (ServeEngine caps hits to
    prefill-bucket-aligned page counts so the partial prefill reuses the
    chunked-prefill chunks' page-aligned shapes).

    Mechanism per the vLLM-style automatic prefix caching design, on
    this pool's refcounts.
    """

    def __init__(self, ctrl: PagePool):
        self.ctrl = ctrl
        self.page_size = ctrl.page_size
        # chain key -> page, in insertion/use order (LRU via move_to_end).
        self._index: "OrderedDict[bytes, int]" = OrderedDict()
        self.hits = 0  # pages served from cache
        self.misses = 0  # lookups that found nothing

    def _keys(
        self, tokens: list[int], n_pages: int, salt: str = ""
    ) -> list[bytes]:
        """Chain keys of the first ``n_pages`` full blocks.  ``salt``
        partitions the key space — the engine passes the adapter id, so
        cached pages (which hold ADAPTED k/v under multi-LoRA) are never
        shared across adapters."""
        ps = self.page_size
        keys, prev = [], salt.encode()
        for i in range(n_pages):
            prev = _chain_key(prev, tokens[i * ps : (i + 1) * ps])
            keys.append(prev)
        return keys

    def lookup(
        self, tokens: list[int], max_pages: int, granularity: int = 1,
        salt: str = "",
    ) -> list[int]:
        """Longest cached prefix of ``tokens``, as pages, capped at
        ``max_pages`` and floored to a multiple of ``granularity`` (the
        engine passes its bucket page count so partial prefill keeps its
        static shapes).  Touches only the RETURNED entries' LRU position,
        and counts only them as hits.  Chain keys hash INCREMENTALLY —
        the walk stops at the first missing block, so a miss-heavy
        stream never pays for hashing the whole prompt."""
        ps = self.page_size
        keys, pages, prev = [], [], salt.encode()
        for i in range(min(max_pages, len(tokens) // ps)):
            prev = _chain_key(prev, tokens[i * ps : (i + 1) * ps])
            page = self._index.get(prev)
            if page is None:
                break
            keys.append(prev)
            pages.append(page)
        keep = len(pages) // granularity * granularity
        keys, pages = keys[:keep], pages[:keep]
        for key in keys:
            self._index.move_to_end(key)
        if pages:
            self.hits += len(pages)
        else:
            self.misses += 1
        return pages

    def insert(
        self, tokens: list[int], table: list[int], salt: str = ""
    ) -> None:
        """Register the fully-written prompt pages of a just-prefilled
        sequence (the first len(tokens)//page_size entries of its table).
        New entries pin their page; known entries just refresh LRU."""
        full = len(tokens) // self.page_size
        for key, page in zip(self._keys(tokens, full, salt), table[:full]):
            if key in self._index:
                self._index.move_to_end(key)
                continue
            self.ctrl.retain_page(page)
            self._index[key] = page

    def evict(self, n_pages: int) -> int:
        """Free up to ``n_pages`` pages by dropping LRU entries whose page
        only the index holds (refcount 1); entries shared with live
        sequences are skipped.  Returns the number actually freed."""
        freed = 0
        for key in list(self._index):
            if freed >= n_pages:
                break
            page = self._index[key]
            if self.ctrl.refcounts.get(page) == 1:
                self.ctrl.release_page(page)
                del self._index[key]
                freed += 1
        return freed

    def clear(self) -> None:
        for key, page in list(self._index.items()):
            self.ctrl.release_page(page)
            del self._index[key]

    @property
    def cached_pages(self) -> int:
        return len(self._index)


class RadixNode:
    """One page-sized token block in the RadixKV tree.  Exactly one of
    ``page`` (resident: a pool page pinned through the pool refcounts)
    or ``host`` (offloaded: the page's k/v bytes in host RAM, engine-
    provided blob) is set for a real node — or neither, when ``disk``
    alone holds the page's chain-key hex and the bytes live in the disk
    tier's file (``disk`` may also coexist with either as a record that
    a durable copy exists); the per-salt root has none of the three.
    ``key`` is the node's chain hash (``_chain_key`` from the root's
    salt), computed once at creation — it names the disk file, so the
    same prefix page written by any tree maps to the same file.
    ``last_use`` is the tree's LRU clock at the node's last
    hit/insert."""

    __slots__ = (
        "block", "parent", "children", "page", "host", "disk", "key",
        "last_use",
    )

    def __init__(self, block, parent):
        self.block = block
        self.parent = parent
        self.children: dict = {}
        self.page: int | None = None
        self.host = None
        self.disk: str | None = None
        self.key: bytes | None = None
        self.last_use = 0


class RadixKV:
    """Radix-tree prefix index over a PagePool, with an optional
    host-RAM offload tier and a disk tier below it: the KV-cache
    hierarchy.

    Same contract as the flat ``PrefixCache`` where they overlap
    (lookup/insert/evict/clear, adapter-salted key space, pages pinned
    through the pool refcounts, promissory inserts safe because a
    sequence's own table holds every inserted page at refcount >= 2
    until retirement), plus what the tree structure buys:

      * **longest-prefix match** walks page-sized token blocks from the
        per-salt root, so two prompts sharing ONLY a system prompt
        still share those pages — and ``match_depth`` exposes the walk
        read-only, the fleet router's affinity score;
      * **structural eviction**: LRU victims are chosen leaf-first and
        eviction walks UP the tree (dropping a leaf exposes its
        parent) — an interior node with children is never dropped, so
        a reachable suffix can never be orphaned behind a missing
        block, the flat index's silent-garbage mode;
      * **offload tier**: with a host-page budget, a victim's page
        SPILLS to pinned host memory (the caller's ``spill`` callback
        copies the bytes out) instead of dropping, and a later lookup
        RELOADS it through the ``reload`` callback — thousands of idle
        conversations hold state without holding HBM.  Spill/reload
        round-trips are bit-exact (byte copies of the same dtype), so
        streams are bit-identical offload on/off (pinned by
        tests/test_torch_kv_hierarchy.py);
      * **disk tier**: with a ``durable.KVDiskTier`` attached, a full host budget demotes its
        coldest page to a chain-key-named, checksummed file instead of
        forcing a leaf drop; lookups reload disk pages through the same
        callback, files survive the process, and ``attach_disk`` /
        ``flush_to_disk`` are the restart-rehydration and checkpoint
        halves.  Same bit-exactness contract: a disk round trip is the
        host round trip plus a verified file copy.

    Control plane only, a copy of the JAX package's: the engine owns the
    device copies (read_pages/write_page below).  Mechanism per the
    SGLang RadixAttention design, on this pool's refcounts.
    """

    def __init__(
        self, ctrl: PagePool, host_pages: int | None = 0, disk=None,
    ):
        self.ctrl = ctrl
        self.page_size = ctrl.page_size
        # host_pages: 0 disables the offload tier (evictions drop),
        # None is an unbounded host budget, N caps offloaded pages.
        if host_pages is not None and host_pages < 0:
            raise ValueError(
                f"host_pages must be >= 0 or None (unbounded), got "
                f"{host_pages}"
            )
        self.host_pages = host_pages
        # The tier below host RAM: a durable.KVDiskTier (or None).  When
        # the host budget is exhausted, the COLDEST host-tier page
        # demotes to its chain-key file instead of forcing a leaf drop;
        # lookups reload disk pages through the same reload callback
        # (file -> host blob -> write_page), and files survive the
        # process — restart rehydration is ``attach_disk``.
        self.disk = disk
        self._roots: dict[str, RadixNode] = {}
        self._clock = 0
        # Pages matched by an IN-PROGRESS lookup: a reload mid-walk may
        # recurse into evict (making room for the reloaded page), which
        # must not victimize pages the walk already matched — they are
        # pinned only by the index (refcount 1) until the caller adopts
        # them.
        self._locked: set[int] = set()
        self.hits = 0  # pages served from the index (reloads included)
        self.misses = 0  # lookups that matched nothing
        self.reloads = 0  # pages brought back from the host tier
        self.spills = 0  # pages pushed out to the host tier
        self.grafts = 0  # pages adopted from another index's handoff
        self.demotions = 0  # host-tier pages pushed down to disk
        self.disk_reloads = 0  # pages brought back from the disk tier
        self._resident = 0
        self._offloaded = 0
        self._disked = 0  # nodes whose ONLY copy is the disk tier

    # ---- tree walks -----------------------------------------------------

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _root(self, salt: str) -> RadixNode:
        """The per-salt root, created on demand.  Its ``key`` is the
        salt bytes — block 0's chain hash starts from it, matching
        ``PrefixCache._keys`` so the two indexes (and every disk file)
        share one key space."""
        root = self._roots.get(salt)
        if root is None:
            root = RadixNode(None, None)
            root.key = salt.encode()
            self._roots[salt] = root
        return root

    def _child_of(self, node: RadixNode, block: tuple) -> RadixNode:
        """Create (and key) a new child under ``node``."""
        child = RadixNode(block, node)
        child.key = _chain_key(node.key, list(block))
        node.children[block] = child
        return child

    def match_depth(self, tokens: list[int], salt: str = "") -> int:
        """Pages of ``tokens`` this index knows — resident OR offloaded
        (an offloaded page is still a prefill the owner saved) — the
        fleet router's per-replica affinity score.  Read-only: no LRU
        touch, no hit/miss accounting."""
        node = self._roots.get(salt)
        if node is None:
            return 0
        ps, depth = self.page_size, 0
        for i in range(len(tokens) // ps):
            node = node.children.get(tuple(tokens[i * ps : (i + 1) * ps]))
            if node is None:
                break
            depth += 1
        return depth

    def lookup(
        self, tokens: list[int], max_pages: int, granularity: int = 1,
        salt: str = "", reload=None,
    ) -> list[int]:
        """Longest known prefix of ``tokens``, as RESIDENT pages, capped
        at ``max_pages`` and floored to a ``granularity`` multiple (the
        engine's bucket page count — partial prefill keeps its static
        shapes).  An OFFLOADED node on the path reloads through
        ``reload(host_blob) -> page | None`` (the engine restores the
        bytes into a freshly taken pool page); without a reload
        callback, or when it cannot make room, the match stops there —
        a shorter hit, never a failure.  The walk is stepwise against
        the live tree, so an evict fired by a mid-walk reload can never
        hand back a freed page.

        The walk is bounded UP FRONT by the granularity-floored known
        depth (match_depth, offloaded nodes included): reloading a page
        the floor would then drop pays a full HBM <-> host round trip
        for zero shared pages — and thrashes, because the unused
        reloaded page is the next eviction's coldest victim.  A reload
        also refreshes the node's LRU tick (bringing a page back IS a
        use), so a reload that a mid-walk failure strands beyond the
        floor cannot be immediately re-spilled."""
        ps = self.page_size
        node = self._roots.get(salt)
        matched: list[RadixNode] = []
        if node is not None:
            bound = min(max_pages, len(tokens) // ps)
            usable = (
                min(self.match_depth(tokens, salt), bound)
                // granularity * granularity
            )
            try:
                for i in range(usable):
                    child = node.children.get(
                        tuple(tokens[i * ps : (i + 1) * ps])
                    )
                    if child is None:
                        break
                    if child.page is None:
                        if reload is None:
                            break
                        blob, from_disk = child.host, False
                        if blob is None:
                            # Disk-only: pull the blob back through the
                            # chain-key file.  A missing/corrupt file is
                            # a shorter hit, never a failure — the walk
                            # stops and prefill rebuilds the page.
                            if self.disk is None or child.disk is None:
                                break
                            blob = self.disk.get(child.disk)
                            if blob is None:
                                break
                            from_disk = True
                        page = reload(blob)
                        if page is None:
                            break
                        child.page = page
                        child.host = None
                        if from_disk:
                            self._disked -= 1
                            self.disk_reloads += 1
                        else:
                            self._offloaded -= 1
                        self._resident += 1
                        self.reloads += 1
                        child.last_use = self._tick()
                    matched.append(child)
                    self._locked.add(child.page)
                    node = child
            finally:
                self._locked.clear()
        keep = len(matched) // granularity * granularity
        pages = []
        for n in matched[:keep]:
            n.last_use = self._tick()
            pages.append(n.page)
        if pages:
            self.hits += len(pages)
        else:
            self.misses += 1
        return pages

    def insert(
        self, tokens: list[int], table: list[int], salt: str = ""
    ) -> None:
        """Register a just-prefilled sequence's full prompt pages (the
        first len(tokens)//page_size entries of its table).  New nodes
        pin their page; known resident nodes just refresh LRU; an
        OFFLOADED node whose blocks this prefill re-wrote re-anchors to
        the freshly written page (same bytes by construction) and drops
        its host copy."""
        ps = self.page_size
        node = self._root(salt)
        for i in range(len(tokens) // ps):
            block = tuple(tokens[i * ps : (i + 1) * ps])
            child = node.children.get(block)
            if child is None:
                child = self._child_of(node, block)
            if child.page is None:
                if child.host is not None:
                    child.host = None
                    self._offloaded -= 1
                elif child.disk is not None:
                    # Disk-only node re-anchors to the freshly written
                    # page; the file stays (same bytes — it is still the
                    # durable copy).
                    self._disked -= 1
                self.ctrl.retain_page(table[i])
                child.page = table[i]
                self._resident += 1
            child.last_use = self._tick()
            node = child

    # ---- eviction / offload ---------------------------------------------

    def _nodes(self):
        for root in self._roots.values():
            stack = list(root.children.values())
            while stack:
                n = stack.pop()
                stack.extend(n.children.values())
                yield n

    def _droppable(self, node: RadixNode) -> bool:
        """May this node leave the tree outright?  Leaves only: an
        interior node anchors the chain its descendants are reachable
        through (offloaded descendants included)."""
        return not node.children

    def _drop(self, node: RadixNode) -> None:
        if node.page is not None:
            self.ctrl.release_page(node.page)
            self._resident -= 1
        elif node.host is not None:
            node.host = None
            self._offloaded -= 1
        elif node.disk is not None:
            # The node leaves the tree; its FILE stays — the disk tier's
            # budget owns file lifetime, and a restart's attach_disk can
            # still find the page.
            self._disked -= 1
        del node.parent.children[node.block]

    def _host_budget_left(self) -> bool:
        return self.host_pages is None or self._offloaded < self.host_pages

    def _demote_to_disk(self, n: int = 1) -> int:
        """Push the coldest host-tier page(s) down to their chain-key
        files — the host budget's relief valve, called when an eviction
        wants to spill but host RAM is full.  A failed put (disk fault
        seam, dead volume) leaves the blob in host RAM: durability
        degrades, correctness does not."""
        if self.disk is None:
            return 0
        demotable = sorted(
            (nd for nd in self._nodes() if nd.host is not None),
            key=lambda nd: nd.last_use,
        )
        moved = 0
        for nd in demotable[:n]:
            key = nd.key.hex()
            if not self.disk.put(key, nd.host):
                break
            nd.host = None
            nd.disk = key
            self._offloaded -= 1
            self._disked += 1
            self.demotions += 1
            moved += 1
        return moved

    def evict(self, n_pages: int, spill=None) -> int:
        """Free up to ``n_pages`` POOL pages, coldest (LRU) first, from
        nodes whose page only the index holds (pool refcount 1 — live
        readers are never victims).  With a ``spill(page) -> blob``
        callback and host budget left, a victim OFFLOADS (page freed,
        node survives in the host tier); otherwise only LEAF nodes drop
        outright, and dropping a leaf exposes its parent to the next
        pass — eviction walks up the tree.  Returns pages freed."""
        freed = 0
        while freed < n_pages:
            victims = sorted(
                (
                    n for n in self._nodes()
                    if n.page is not None
                    and n.page not in self._locked
                    and self.ctrl.refcounts.get(n.page) == 1
                ),
                key=lambda n: n.last_use,
            )
            progress = False
            for node in victims:
                if freed >= n_pages:
                    break
                if spill is not None and not self._host_budget_left():
                    # Host RAM is full: demote its coldest page to the
                    # disk tier so this victim can still spill instead
                    # of dropping — the hierarchy's third level.
                    self._demote_to_disk(1)
                if spill is not None and self._host_budget_left():
                    blob = spill(node.page)
                    if blob is not None:
                        self.ctrl.release_page(node.page)
                        node.page = None
                        node.host = blob
                        self._resident -= 1
                        self._offloaded += 1
                        self.spills += 1
                        freed += 1
                        progress = True
                        continue
                if self._droppable(node):
                    self._drop(node)
                    freed += 1
                    progress = True
            if not progress:
                break
        return freed

    def park(
        self, tokens: list[int], salt: str = "", spill=None,
        spill_many=None,
    ) -> int:
        """Preemption-via-offload: push THIS path's resident pages out
        to the host tier NOW (LRU coldness notwithstanding), so a
        preempted stream's prefix stops holding HBM the moment its slot
        is reclaimed.  Walks the ``tokens`` path under ``salt`` and
        spills every resident page only the index holds (pool refcount
        1 — a page another live sequence still reads stays put); already-offloaded nodes
        are skipped, and without a spill callback or host budget
        nothing moves (graceful degrade: the pages stay resident and
        ordinary LRU pressure evicts them later).  Returns the pages
        parked; resumption is just a lookup — the reload callback
        brings them back bit-exactly.

        ``spill_many(pages) -> blobs`` is the BATCHED spill seam: the
        whole path's victims are collected first and copied out in one
        gathered call (the engine pays one gathered copy and one
        synchronise per park instead of one round trip per page); ``spill(page) -> blob``
        remains as the per-page fallback.  Both produce identical blobs
        (pinned), so which seam ran can never change a stream."""
        if spill is None and spill_many is None:
            return 0
        node = self._roots.get(salt)
        if node is None:
            return 0
        ps = self.page_size
        victims: list[RadixNode] = []
        for i in range(len(tokens) // ps):
            node = node.children.get(tuple(tokens[i * ps : (i + 1) * ps]))
            if node is None:
                break
            if node.page is None:
                continue  # already in the host tier
            if self.ctrl.refcounts.get(node.page) != 1:
                continue  # a live reader still holds it
            if self.host_pages is not None and (
                self._offloaded + len(victims) >= self.host_pages
            ):
                break
            victims.append(node)
        if not victims:
            return 0
        if spill_many is not None:
            blobs = list(spill_many([n.page for n in victims]))
        else:
            blobs = [spill(n.page) for n in victims]
        parked = 0
        for n, blob in zip(victims, blobs):
            if blob is None:
                break
            self.ctrl.release_page(n.page)
            n.page = None
            n.host = blob
            self._resident -= 1
            self._offloaded += 1
            self.spills += 1
            parked += 1
        return parked

    # ---- cross-engine KV handoff ----------------------------------------

    def export_path(self, tokens, salt: str = "", copy_many=None) -> list:
        """The ``tokens`` path's page payloads, in path order — the KV
        handoff EXPORT half.  Offloaded nodes contribute their host blob
        by reference (blobs are immutable once written, so trees can
        share them); resident nodes copy their bytes out through
        ``copy_many(pages) -> blobs`` (the engine's gathered spill:
        one gathered copy and one synchronise for the whole path) WITHOUT releasing or
        moving anything: exporting never changes what this index
        holds.  The payload is always a CONTIGUOUS prefix of the path
        — it stops at the first unknown block, or at the first
        resident node when no ``copy_many`` is given."""
        node = self._roots.get(salt)
        if node is None:
            return []
        ps = self.page_size
        entries: list[tuple[str, object]] = []
        for i in range(len(tokens) // ps):
            node = node.children.get(tuple(tokens[i * ps : (i + 1) * ps]))
            if node is None:
                break
            if node.host is not None:
                entries.append(("host", node.host))
            elif node.page is not None:
                if copy_many is None:
                    break  # cannot copy a resident page: stop before it
                entries.append(("page", node.page))
            else:
                break  # defensive: a payload gap ends the contiguous run
        pages = [p for kind, p in entries if kind == "page"]
        copies = iter(copy_many(pages)) if pages else iter(())
        return [
            payload if kind == "host" else next(copies)
            for kind, payload in entries
        ]

    def graft(self, tokens, blobs: list, salt: str = "") -> int:
        """Adopt another index's exported payload as OFFLOADED nodes —
        the KV handoff IMPORT half: ``blobs`` are ``export_path``'s
        host blobs for the first ``len(blobs)`` page blocks of
        ``tokens``.  Blocks this tree already knows (resident or
        offloaded) just refresh LRU — their bytes are identical by
        construction — and new nodes land in the host tier under the
        ordinary ``host_pages`` budget (a partial graft is a shorter
        future hit, never an error).  The next lookup reloads grafted
        pages through the usual reload callback, riding the admission
        sweep like any offloaded hit; the round trip is bit-exact, so
        a grafted continuation streams identically to a re-prefilled
        one (pinned by tests/test_torch_kv_hierarchy.py)."""
        ps = self.page_size
        if len(blobs) > len(tokens) // ps:
            raise ValueError(
                f"graft got {len(blobs)} page blobs but tokens cover "
                f"only {len(tokens) // ps} full pages"
            )
        node = self._root(salt)
        grafted = 0
        for i, blob in enumerate(blobs):
            block = tuple(tokens[i * ps : (i + 1) * ps])
            child = node.children.get(block)
            if child is None:
                if blob is None or not self._host_budget_left():
                    break
                child = self._child_of(node, block)
                child.host = blob
                self._offloaded += 1
                self.grafts += 1
                grafted += 1
            child.last_use = self._tick()
            node = child
        return grafted

    def clear(self) -> None:
        """Drop the whole index: resident pages release back to the
        pool, host blobs free — the close/quarantine-flush path (an
        offloaded page must not outlive the cache that owns it).  DISK
        files deliberately stay: they are the durable tier, and pages
        outliving this index (and this process) is their whole point —
        ``attach_disk`` finds them again."""
        for root in self._roots.values():
            stack = list(root.children.values())
            while stack:
                n = stack.pop()
                stack.extend(n.children.values())
                if n.page is not None:
                    self.ctrl.release_page(n.page)
        self._roots.clear()
        self._resident = 0
        self._offloaded = 0
        self._disked = 0

    # ---- durable (disk) tier --------------------------------------------

    def attach_disk(self, tokens: list[int], salt: str = "") -> int:
        """Restart rehydration: walk ``tokens``' page blocks, recompute
        their chain keys, and adopt every block whose file exists in
        the disk tier as a disk-backed node — the durable counterpart
        of ``graft`` (files instead of host blobs, contains() instead
        of payloads, so attaching a long path costs stat calls, not
        reads).  The walk stops at the first unknown block (a disk page
        behind a gap would never be reachable as a prefix).  The next
        lookup reloads attached pages through the ordinary reload
        callback.  Returns the nodes attached."""
        if self.disk is None:
            return 0
        ps = self.page_size
        node = self._root(salt)
        attached = 0
        for i in range(len(tokens) // ps):
            block = tuple(tokens[i * ps : (i + 1) * ps])
            child = node.children.get(block)
            if child is None:
                key = _chain_key(node.key, list(block))
                if not self.disk.contains(key.hex()):
                    break
                child = self._child_of(node, block)
                child.disk = key.hex()
                self._disked += 1
                attached += 1
            child.last_use = self._tick()
            node = child
        return attached

    def flush_to_disk(
        self, tokens: list[int], salt: str = "", copy_many=None,
    ) -> int:
        """Persist the ``tokens`` path's pages to the disk tier WITHOUT
        changing what this index holds — the session checkpoint's
        parked-page-manifest half: after a flush, a process restart can
        rebuild this prefix from files alone.  Host-tier nodes write
        their blob (a key already on disk is a dedup touch, not a
        write); resident nodes copy their bytes out through
        ``copy_many(pages) -> blobs`` (the engine's gathered spill,
        same seam as ``export_path``).  Returns how many of the path's
        pages have a durable copy afterwards."""
        if self.disk is None:
            return 0
        node = self._roots.get(salt)
        if node is None:
            return 0
        ps = self.page_size
        path_nodes: list[RadixNode] = []
        for i in range(len(tokens) // ps):
            node = node.children.get(tuple(tokens[i * ps : (i + 1) * ps]))
            if node is None:
                break
            path_nodes.append(node)
        resident = [
            n for n in path_nodes
            if n.page is not None and n.host is None
        ]
        copies: dict[int, object] = {}
        if resident and copy_many is not None:
            for n, blob in zip(
                resident, copy_many([n.page for n in resident])
            ):
                copies[id(n)] = blob
        durable = 0
        for n in path_nodes:
            if n.disk is not None and self.disk.contains(n.disk):
                durable += 1
                continue
            blob = n.host if n.host is not None else copies.get(id(n))
            if blob is None:
                continue
            key = n.key.hex()
            if self.disk.put(key, blob):
                n.disk = key
                durable += 1
        return durable

    # ---- accounting -----------------------------------------------------

    @property
    def cached_pages(self) -> int:
        """POOL pages currently pinned by the index (a drained engine
        holds exactly these) — offloaded entries hold none."""
        return self._resident

    @property
    def offloaded_pages(self) -> int:
        return self._offloaded

    @property
    def disked_pages(self) -> int:
        """Nodes whose ONLY copy is the disk tier (tree-local view; the
        tier's file count is ``self.disk.pages`` — larger, because
        files are shared across trees and survive ``clear()``)."""
        return self._disked

    @property
    def node_count(self) -> int:
        return sum(1 for _ in self._nodes())


def init_page_pools(
    config: ModelConfig, n_pages: int, page_size: int, device=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The device-side (k, v) pools, each [layers, n_pages + 1, kv_heads,
    page_size, head_dim]; the last page is the trash page.  ``device``
    None means ``cuda`` (``resolve_device``)."""
    device = resolve_device(device)
    shape = (
        config.n_layers, n_pages + 1, config.kv_heads, page_size,
        config.head_dim,
    )
    return (
        torch.zeros(shape, dtype=config.dtype, device=device),
        torch.zeros(shape, dtype=config.dtype, device=device),
    )


def table_array(
    tables: list[list[int]], max_pages: int, fill: int = 0, device=None
) -> torch.Tensor:
    """Stack host tables into a padded [batch, max_pages] int32 tensor on
    ``device`` (None means ``cuda``, ``resolve_device``).  ``fill`` pads
    short tables; rows PARKED with positions outside their table must
    fill with the pool's trash index."""
    out = []
    for t in tables:
        if len(t) > max_pages:
            raise ValueError(f"table length {len(t)} exceeds {max_pages}")
        out.append(list(t) + [fill] * (max_pages - len(t)))
    return torch.tensor(out, dtype=torch.int32, device=resolve_device(device))


def _page_index(page, device) -> torch.Tensor:
    """Page ids (an int, a list, or a tensor) as an int64 index on
    ``device``; a device tensor stays on the device (no host read).  Host
    ids go to the card through pinned memory without a synchronise, so
    a page op queues behind the work in flight instead of waiting for
    it."""
    if isinstance(page, torch.Tensor):
        return page.to(device).long().reshape(-1)
    idx = torch.as_tensor(page, dtype=torch.long).reshape(-1)
    if torch.device(device).type == "cuda":
        return idx.pin_memory().to(device, non_blocking=True)
    return idx


def read_page(pools: tuple[torch.Tensor, torch.Tensor], src):
    """Copy ONE physical page (all layers, k and v) out of the pools:
    (k [L, Hkv, ps, hd], v [L, Hkv, ps, hd]), new tensors that later pool
    writes do not change."""
    idx = _page_index(src, pools[0].device)
    return tuple(pool.index_select(1, idx)[:, 0] for pool in pools)


def read_pages(pools: tuple[torch.Tensor, torch.Tensor], srcs):
    """Copy N physical pages out of the pools in one gather per pool:
    (k [L, n, Hkv, ps, hd], v [L, n, Hkv, ps, hd]); column ``i`` holds
    exactly ``read_page(srcs[i])``'s bytes."""
    idx = _page_index(srcs, pools[0].device)
    return tuple(pool.index_select(1, idx) for pool in pools)


def write_page(
    pools: tuple[torch.Tensor, torch.Tensor], k_page, v_page, dst
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write one page's k/v ([L, Hkv, ps, hd] each) into the pools at
    physical page ``dst``, IN PLACE; returns the same pool tensors (a
    captured CUDA graph holds their addresses, so they are never
    rebound).  ``read_page`` -> ``write_page`` round-trips bit-exactly.
    A page in pinned host memory goes up without a synchronise, queued
    on the stream (the caching host allocator keeps its block until the
    copy has run); a pageable one is copied before this returns."""
    idx = _page_index(dst, pools[0].device)
    for pool, page in zip(pools, (k_page, v_page)):
        page = page.to(pool.device, pool.dtype, non_blocking=page.is_pinned())
        pool.index_copy_(1, idx, page[:, None])
    return pools


def copy_page(
    pools: tuple[torch.Tensor, torch.Tensor], src, dst
) -> tuple[torch.Tensor, torch.Tensor]:
    """Duplicate one physical page (all layers, k and v) onto ``dst``, IN
    PLACE; returns the same pool tensors."""
    device = pools[0].device
    src_idx, dst_idx = _page_index(src, device), _page_index(dst, device)
    for pool in pools:
        pool.index_copy_(1, dst_idx, pool.index_select(1, src_idx))
    return pools


def _write_slots(
    pool: torch.Tensor, layer: int, page: torch.Tensor, slot: torch.Tensor,
    new: torch.Tensor,
) -> None:
    """pool[layer, page[b], :, slot[b]] = new[b] for every row, as one
    in-place index_put_.  Parked rows all write the trash page's slot 0;
    which of those duplicate writes lands is unspecified, and only trash
    bytes depend on it."""
    pool[layer, page, :, slot] = new.to(pool.dtype)


def _decode_core(
    params: dict,
    pools: tuple[torch.Tensor, torch.Tensor],
    tables: torch.Tensor,
    token: torch.Tensor,
    positions: torch.Tensor,
    config: ModelConfig,
    attention_fn=None,
    lora=None,
    reduce=None,
    moe_reads=None,
):
    """One token per row through the paged cache: write the new k/v into
    each row's current page slot, then run paged attention over the
    row's live pages under the layer's window, with the layer's rotary
    kind and FFN (``moe.ffn``; ``moe_reads``, an int64 [1] device
    tensor or None, gains the experts the step's expert-layer calls
    read, ``_count_reads``).
    positions: [batch], each row's own position.
    ``attention_fn(q, k_pages, v_pages, tables, lengths, layer)``
    replaces the attention op (as in the JAX package), e.g. to hold the
    kernel against its plain version inside a whole step.
    ``lora=(stacked, idx, alpha)`` applies PER-ROW adapter deltas
    (``multi_lora.py``): row b's q/k/v and output projections gain
    ``alpha * (h @ a[idx[b]]) @ b[idx[b]]``.  ``reduce`` (None:
    identity) takes the output of every ``wo`` and ``w_down`` product,
    after the adapter's delta: a tensor-parallel rank's row-parallel
    all-reduce (``tp_serve.py``), where the params, the pools and the
    adapters are the rank's own cut.  Returns (logits [batch, vocab],
    pools updated in place)."""
    k_pages, v_pages = pools
    batch = token.shape[0]
    page_size = k_pages.shape[3]
    positions = positions.long()
    row = torch.arange(batch, device=token.device)
    # jax clamps this gather column; say so explicitly.
    col = (positions // page_size).clamp(max=tables.shape[1] - 1)
    page = tables[row, col].long()
    slot = positions % page_size
    lengths = (positions + 1).to(torch.int32)
    angles = rope_tables(positions[:, None], config)  # kind -> ([batch, 1, half], scale)
    if lora is not None:
        stacked, aidx, alpha = lora
    offs = [] if moe_reads is not None else None

    x = params["embed"].to(config.dtype)[token.long()][:, None]  # [b, 1, d]
    for i, layer in enumerate(params["layers"]):
        h = _rmsnorm(x, layer["ln1"])
        q, k, v = project_qkv(h, layer)  # [b, 1, H|Hkv, hd]
        if lora is not None:
            q, k, v = apply_qkv(q, k, v, h, stacked[i], aidx, config, alpha, config.dtype)
        a, scale = angles[config.layer_rope_kind(i)]
        q, k = apply_rope(q, a, scale), apply_rope(k, a, scale)
        _write_slots(k_pages, i, page, slot, k[:, 0])
        _write_slots(v_pages, i, page, slot, v[:, 0])
        if attention_fn is None:
            attn = paged_attention(
                q[:, 0].contiguous(), k_pages, v_pages, tables, lengths,
                layer=i, window=config.layer_window(i),
            )
        else:
            attn = attention_fn(q[:, 0].contiguous(), k_pages, v_pages, tables, lengths, i)
        proj = torch.einsum("bhk,hkd->bd", attn, weight(layer["wo"], x.dtype))
        if lora is not None:
            proj = apply_wo(proj, attn, stacked[i], aidx, alpha)
        if reduce is not None:
            proj = reduce(proj)
        x = x + proj[:, None]
        x = x + ffn(_rmsnorm(x, layer["ln2"]), layer, config, reduce, offs)
    if offs:
        _count_reads(moe_reads, offs)
    logits = x[:, 0].float() @ weight(params["unembed"], torch.float32)
    return logits, (k_pages, v_pages)


def _count_reads(moe_reads: torch.Tensor, offs: list) -> None:
    """Add to ``moe_reads`` the experts that received at least one row in
    each of a step's expert-layer calls (``offs``, each call's
    cumulative ends of rows), counted once a step."""
    ends = torch.stack(offs)
    counts = torch.diff(ends, dim=1, prepend=ends.new_zeros(ends.shape[0], 1))
    moe_reads.add_((counts > 0).sum())


@torch.inference_mode()
def paged_decode_step(
    params: dict,
    pools: tuple[torch.Tensor, torch.Tensor],
    tables: torch.Tensor,
    token: torch.Tensor,
    positions,
    config: ModelConfig,
    lora=None,
):
    """One token through the paged cache.  tables: [batch, max_pages]
    int32; token: [batch]; positions: an int (lockstep) or [batch]
    (each row at its own depth).  ``lora``: per-row adapters (see
    ``_decode_core``).  Returns (logits [batch, vocab], pools) with the
    pools updated in place."""
    positions = torch.as_tensor(positions, device=token.device)
    positions = torch.broadcast_to(positions, token.shape)
    return _decode_core(params, pools, tables, token, positions, config, lora=lora)


@torch.inference_mode()
def paged_decode_chunk(
    params: dict,
    pools: tuple[torch.Tensor, torch.Tensor],
    tables: torch.Tensor,
    token: torch.Tensor,
    positions: torch.Tensor,
    occupancy: torch.Tensor,
    rng: torch.Tensor | None,
    temperature: float,
    top_k: int,
    top_p: float,
    config: ModelConfig,
    chunk: int,
    sampling: bool,
    lora=None,
    reduce=None,
    moe_reads=None,
):
    """``chunk`` decode steps (the JAX package's lax.scan, as a loop);
    sampling draws step ``i`` from ``split(rng, chunk)[i]``.
    token/positions: [batch], each row's current token and position.
    occupancy: [batch] bool; rows marked False are parked — their
    position and token freeze and their all-trash table swallows the
    dead write.  tables must cover positions + chunk for occupied rows.
    ``lora=(stacked, idx, alpha)``: per-row adapters (see
    ``_decode_core``); idx is data.  ``moe_reads`` (None: not counted)
    gains the expert layers' reads (``_decode_core``).  Returns (tokens [batch,
    chunk], pools updated in place)."""
    tok = token.long()
    pos = torch.broadcast_to(
        torch.as_tensor(positions, device=token.device), token.shape
    ).long()
    keys = prng.split(rng, chunk) if sampling else None
    toks = []
    for i in range(chunk):
        logits, pools = _decode_core(params, pools, tables, tok, pos, config, lora=lora,
                                     reduce=reduce, moe_reads=moe_reads)
        nxt = sample_logits(
            logits, keys[i] if sampling else None, temperature, top_k, top_p
        )
        pos = torch.where(occupancy, pos + 1, pos)
        tok = torch.where(occupancy, nxt, tok)
        toks.append(nxt)
    return torch.stack(toks, dim=1), pools


def decode_superstep_step(
    params: dict,
    pools: tuple[torch.Tensor, torch.Tensor],
    tables: torch.Tensor,
    tok: torch.Tensor,
    pos: torch.Tensor,
    live: torch.Tensor,
    budget: torch.Tensor,
    eos: torch.Tensor,
    key: torch.Tensor | None,
    temperature: float,
    top_k: int,
    top_p: float,
    config: ModelConfig,
    sampling: bool,
    lora=None,
    reduce=None,
    moe_reads=None,
):
    """ONE decode step with device-side retirement, the body of
    ``paged_decode_superstep`` (and the step ``decode_graph`` captures):
    emit a token for every row, advance live rows, then retire a row on
    the step it emits ``eos`` or exhausts its ``budget``; retired and
    parked rows freeze their position and token.  ``key`` is the step's
    own sampling key.  Returns (emitted
    [batch], tok, pos, live, budget); the pools update in place.
    ``lora``: per-row adapters (see ``_decode_core``); ``moe_reads``
    as ``paged_decode_chunk``'s."""
    logits, _ = _decode_core(params, pools, tables, tok, pos, config, lora=lora,
                             reduce=reduce, moe_reads=moe_reads)
    nxt = sample_logits(
        logits, key if sampling else None, temperature, top_k, top_p
    )
    pos = torch.where(live, pos + 1, pos)
    tok = torch.where(live, nxt, tok)
    budget = torch.where(live, budget - 1, budget)
    # Retire AFTER the emit: the terminal token is this step's output.
    live = live & (nxt != eos) & (budget > 0)
    return nxt, tok, pos, live, budget


@torch.inference_mode()
def paged_decode_superstep(
    params: dict,
    pools: tuple[torch.Tensor, torch.Tensor],
    tables: torch.Tensor,
    token: torch.Tensor,
    positions: torch.Tensor,
    live: torch.Tensor,
    budget: torch.Tensor,
    eos: torch.Tensor,
    rngs: torch.Tensor | None,
    temperature: float,
    top_k: int,
    top_p: float,
    config: ModelConfig,
    chunk: int,
    k: int,
    sampling: bool,
    lora=None,
    reduce=None,
    moe_reads=None,
):
    """``k`` chained decode chunks (``k * chunk`` steps) with device-side
    retirement, the JAX package's ``paged_decode_superstep`` as a loop.
    live: [batch] bool, False rows (empty slots, rows retired earlier)
    frozen like ``paged_decode_chunk``'s parked rows; budget: [batch]
    remaining tokens; eos: [batch] ids (-1 = none).  rngs: [k, 2], one
    engine key a chunk, each split ``chunk`` ways as
    ``paged_decode_chunk`` splits its key, so the draws are the k chunk
    calls'.  tables must
    cover each live row up to its retirement ceiling: a retired row keeps
    writing its frozen position.  Returns (tokens [batch, k*chunk], tok,
    pos, live, budget, pools): the carry after the last step, on the
    device, and the pools updated in place.  ``lora``: per-row adapters
    (see ``_decode_core``); ``moe_reads`` as ``paged_decode_chunk``'s."""
    tok = token.long()
    pos = torch.broadcast_to(
        torch.as_tensor(positions, device=token.device), token.shape
    ).long()
    keys = prng.split(rngs, chunk).reshape(k * chunk, 2) if sampling else None
    toks = []
    for i in range(k * chunk):
        nxt, tok, pos, live, budget = decode_superstep_step(
            params, pools, tables, tok, pos, live, budget, eos,
            keys[i] if sampling else None,
            temperature, top_k, top_p, config, sampling, lora=lora, reduce=reduce,
            moe_reads=moe_reads,
        )
        toks.append(nxt)
    return torch.stack(toks, dim=1), tok, pos, live, budget, pools


def _redirect_padding(
    tables_slice: torch.Tensor, covered_lengths: torch.Tensor, page_size: int,
    trash: int,
) -> torch.Tensor:
    """Table columns beyond each row's real coverage point at the trash
    page, so view scatters from padded positions never write another
    sequence's page."""
    real = (covered_lengths.long() + page_size - 1) // page_size
    col = torch.arange(tables_slice.shape[1], device=tables_slice.device)[None, :]
    return torch.where(col < real[:, None], tables_slice.long(), trash)


def _gather_view(pool: torch.Tensor, t_cov: torch.Tensor, page_size: int) -> torch.Tensor:
    """[L, pages, Hkv, ps, hd] pool -> dense [L, b, cover*ps, Hkv, hd]
    view of each row's t_cov-mapped pages (decode_block's cache layout)."""
    g = pool[:, t_cov]  # [L, b, cover, Hkv, ps, hd]
    g = g.permute(0, 1, 2, 4, 3, 5)
    return g.reshape(g.shape[0], g.shape[1], t_cov.shape[1] * page_size, *g.shape[4:])


def _scatter_view(
    pool: torch.Tensor, view: torch.Tensor, t_cov: torch.Tensor, page_size: int,
    start_col: int = 0,
) -> None:
    """Inverse of _gather_view, in place: write the view's pages from
    table column ``start_col`` on back into the pool.  A page may appear
    in ``t_cov`` more than once: trash padding, and prefix pages that
    several rows share (a cache hit, a fan-out fork).  The index put
    with duplicate indices lets an arbitrary writer land (CUDA picks
    any), so callers send every shared page's column to the trash page
    in all rows but its writer's (``paged_prefill_chunk``'s
    ``row_start``): only the trash page, garbage by contract, is ever
    written twice."""
    pv = view.reshape(
        view.shape[0], view.shape[1], t_cov.shape[1], page_size, *view.shape[3:]
    )
    pv = pv.permute(0, 1, 2, 4, 3, 5)[:, :, start_col:]
    pool[:, t_cov[:, start_col:]] = pv


def _last_hidden_logits(params, hidden, idx):
    """Unembed the hidden row ``idx[b]`` of each row b (idx in range)."""
    batch = hidden.shape[0]
    h_last = hidden[torch.arange(batch, device=hidden.device), idx]
    return h_last.float() @ weight(params["unembed"], torch.float32)


@torch.inference_mode()
def paged_prefill(
    params: dict,
    pools: tuple[torch.Tensor, torch.Tensor],
    tables: torch.Tensor,
    prompts: torch.Tensor,
    lengths: torch.Tensor,
    config: ModelConfig,
    lora=None,
    reduce=None,
):
    """Prefill a batch of fresh prompts into the paged pools in one block
    forward.  prompts: [batch, P] right-padded; lengths: [batch] true
    lengths (1..P).  Rows start at position 0; their tables must cover
    their own ceil(length / page_size) pages within the first
    ceil(P / page_size) columns, and padding columns are redirected to
    the trash page.  ``lora``: per-row adapters (see ``_decode_core``;
    the engine's batch-1 admissions pass idx=[adapter]).  Returns
    (next-token logits [batch, vocab] at each row's last true position,
    pools updated in place)."""
    k_pages, v_pages = pools
    P = prompts.shape[1]
    page_size = k_pages.shape[3]
    prefill_pages = -(-P // page_size)
    trash = k_pages.shape[1] - 1
    t_pp = _redirect_padding(tables[:, :prefill_pages], lengths, page_size, trash)
    view = torch.stack(
        [_gather_view(k_pages, t_pp, page_size), _gather_view(v_pages, t_pp, page_size)],
        dim=1,
    )
    hidden, view = decode_block(params, view, prompts, 0, config, unembed="hidden",
                                lora=lora, reduce=reduce)
    logits = _last_hidden_logits(params, hidden, (lengths.long() - 1).clamp(0, P - 1))
    _scatter_view(k_pages, view[:, 0], t_pp, page_size)
    _scatter_view(v_pages, view[:, 1], t_pp, page_size)
    return logits, pools


@torch.inference_mode()
def paged_prefill_chunk(
    params: dict,
    pools: tuple[torch.Tensor, torch.Tensor],
    tables: torch.Tensor,
    chunk_tokens: torch.Tensor,
    lengths: torch.Tensor,
    config: ModelConfig,
    start_page: int,
    cover_pages: int,
    emit: bool,
    row_start: torch.Tensor | None = None,
    lora=None,
    reduce=None,
):
    """Chunked prefill: one page-aligned slice of the prompts through the
    paged pools.  chunk_tokens: [batch, C] at absolute positions
    ``start_page * page_size .. +C-1`` (C a multiple of page_size),
    right-padded past each row's true length; lengths: [batch] true
    total prompt lengths; tables cover ``cover_pages = start_page +
    C/page_size`` columns.  The chunk attends over all pages up to its
    end.

    ``emit`` returns logits at each row's true last position provided
    it falls inside this chunk (other rows get a clipped, meaningless
    row).  ``row_start`` ([batch] pages) marks columns before each row's
    own start as already written: reads see them, the scatter-back sends
    them to the trash page.  ``lora``: per-row adapters (see
    ``_decode_core``).  Returns (logits | None, pools updated in
    place)."""
    k_pages, v_pages = pools
    C = chunk_tokens.shape[1]
    page_size = k_pages.shape[3]
    if C % page_size:
        raise ValueError(
            f"chunk width {C} must be a multiple of page_size {page_size}"
        )
    if cover_pages != start_page + C // page_size:
        raise ValueError(
            f"cover_pages {cover_pages} must equal start_page {start_page} "
            f"+ chunk pages {C // page_size}"
        )
    start = start_page * page_size
    trash = k_pages.shape[1] - 1
    t_cov = _redirect_padding(tables[:, :cover_pages], lengths, page_size, trash)
    view = torch.stack(
        [_gather_view(k_pages, t_cov, page_size), _gather_view(v_pages, t_cov, page_size)],
        dim=1,
    )
    hidden, view = decode_block(
        params, view, chunk_tokens, start, config,
        unembed="hidden" if emit else "none", lora=lora, reduce=reduce,
    )
    logits = None
    if emit:
        idx = (lengths.long() - 1 - start).clamp(0, C - 1)
        logits = _last_hidden_logits(params, hidden, idx)
    t_write = t_cov
    if row_start is not None:
        col = torch.arange(t_cov.shape[1], device=t_cov.device)[None, :]
        t_write = torch.where(col < row_start.long()[:, None], trash, t_cov)
    _scatter_view(k_pages, view[:, 0], t_write, page_size, start_page)
    _scatter_view(v_pages, view[:, 1], t_write, page_size, start_page)
    return logits, pools


# ---- speculative decoding over the paged caches --------------------------
#
# A round is three phases: DRAFT (gamma + 1 draft decode steps through
# _decode_core, and so through the paged-attention kernel), VERIFY (one
# rowwise block forward of the target over a gathered view, dense
# masked attention) and COMMIT (each row's accepted prefix plus the
# target's correction).  The JAX package runs rounds and supersteps as
# jitted scans; here they are loops, and on the card the engine replays
# one captured round (``decode_graph.SpecGraph``).


def _rowwise_block_core(
    params: dict,
    pools: tuple[torch.Tensor, torch.Tensor],
    tables: torch.Tensor,
    block: torch.Tensor,
    positions: torch.Tensor,
    config: ModelConfig,
    lora=None,
    reduce=None,
):
    """``s`` consecutive tokens PER ROW at per-row start positions through
    the paged pools in one forward, the paged, batched counterpart of
    ``generate.decode_block`` (speculative verification: rows at
    different depths each score a block in one target forward).

    block: [batch, s] at positions ``positions[b] .. +s-1``; returns
    (logits [batch, s, vocab] float32, where logits[:, i] predicts the
    token after position positions[b]+i, pools updated in place).  Each
    row's table-mapped pages are gathered into a dense view, the layers
    run with per-row rotary angles and per-row causal (and window)
    masks, the block's k/v go into the view at per-row offsets in one
    indexed write, and the view's real pages are scattered back (columns
    past each row's post-block coverage go to the trash page).  The
    offsets are clamped to keep the block inside the view, as JAX's
    ``dynamic_update_slice`` clamps them.  Callers bound the table width
    to the pages live (a cover), so the gather is O(cover).  ``lora``:
    per-row adapters and ``reduce`` the row-parallel all-reduce (see
    ``_decode_core``)."""
    k_pages, v_pages = pools
    batch, s = block.shape
    device = block.device
    page_size = k_pages.shape[3]
    trash = k_pages.shape[1] - 1
    T = tables.shape[1] * page_size
    positions = positions.long()
    t_cov = _redirect_padding(tables, positions + s, page_size, trash)
    view_k = _gather_view(k_pages, t_cov, page_size)  # [L, b, T, Hkv, hd]
    view_v = _gather_view(v_pages, t_cov, page_size)

    offs = torch.arange(s, device=device)
    pos_grid = positions[:, None] + offs[None, :]  # [b, s]
    angles = rope_tables(pos_grid, config)  # kind -> ([b, s, half], scale)
    k_pos = torch.arange(T, device=device)[None, None, :]
    masks = {w: causal_mask(pos_grid[:, :, None], k_pos, w)[:, None]
             for w in config.windows}  # [b, 1, s, T]
    rows = torch.arange(batch, device=device)[:, None].expand(batch, s)
    cols = positions.clamp(0, max(T - s, 0))[:, None] + offs[None, :]
    if lora is not None:
        stacked, aidx, alpha = lora

    x = params["embed"].to(config.dtype)[block.long()]  # [b, s, d]
    for i, layer in enumerate(params["layers"]):
        h = _rmsnorm(x, layer["ln1"])
        q, k, v = project_qkv(h, layer)
        if lora is not None:
            q, k, v = apply_qkv(q, k, v, h, stacked[i], aidx, config, alpha, config.dtype)
        a, scale = angles[config.layer_rope_kind(i)]
        q, k = apply_rope(q, a, scale), apply_rope(k, a, scale)
        view_k[i, rows, cols] = k.to(view_k.dtype)
        view_v[i, rows, cols] = v.to(view_v.dtype)
        attn = masked_attention(q, view_k[i], view_v[i], masks[config.layer_window(i)],
                                config.head_dim)
        proj = torch.einsum("bshk,hkd->bsd", attn, weight(layer["wo"], x.dtype))
        if lora is not None:
            proj = apply_wo(proj, attn, stacked[i], aidx, alpha)
        if reduce is not None:
            proj = reduce(proj)
        x = x + proj
        x = x + ffn(_rmsnorm(x, layer["ln2"]), layer, config, reduce)
    logits = x.float() @ weight(params["unembed"], torch.float32)
    _scatter_view(k_pages, view_k, t_cov, page_size)
    _scatter_view(v_pages, view_v, t_cov, page_size)
    return logits, pools


def _spec_accept(
    drafts: torch.Tensor, q: torch.Tensor, p: torch.Tensor,
    rng: torch.Tensor,
):
    """Batched speculative REJECTION SAMPLING, the lossless acceptance
    rule: drafts [b, gamma] were drawn from the draft distributions
    q [b, gamma, vocab]; p [b, gamma+1, vocab] are the target's at the
    same positions and the bonus one.  Per row, draft i is accepted with
    probability min(1, p_i(x_i)/q_i(x_i)); at the first rejection n a
    correction is drawn from normalize(max(p_n - q_n, 0)); with all gamma
    accepted, a bonus token from p_gamma.  The committed tokens are then
    distributed exactly as sequential sampling from p, whatever q is.

    Two draws, as the JAX package's: the uniforms under
    ``fold_in(rng, 0)``, the correction under ``fold_in(rng, 1)``
    (``categorical`` over the log of its distribution).  Returns
    (committed [b, gamma+1], n [b]): row b's new tokens are
    committed[b, :n[b]+1]."""
    batch, gamma = drafts.shape
    row = torch.arange(batch, device=drafts.device)
    idx = drafts.long()[..., None]
    p_x = torch.gather(p[:, :gamma], -1, idx)[..., 0]
    q_x = torch.gather(q, -1, idx)[..., 0]
    u = prng.uniform(prng.fold_in(rng, 0), (batch, gamma))
    # u*q < p  <=>  u < p/q (q_x > 0: x was drawn from q); no divide.
    accept = u * q_x < p_x
    n = torch.argmin(
        torch.cat([accept, torch.zeros((batch, 1), dtype=torch.bool, device=drafts.device)],
                  dim=1).to(torch.uint8),
        dim=1,
    )
    # The residual at each row's own n; at n == gamma (all accepted) q
    # is taken as 0, so the residual is p_gamma itself.
    q_pad = torch.cat([q, torch.zeros_like(q[:, :1])], dim=1)
    p_n = p[row, n]
    resid = torch.clamp_min(p_n - q_pad[row, n], 0.0)
    norm = resid.sum(dim=-1, keepdim=True)
    # A degenerate residual (p <= q everywhere, or float cancellation)
    # falls back to p_n: under exact arithmetic it has probability 0.
    dist = torch.where(norm > 1e-9, resid / torch.clamp_min(norm, 1e-9), p_n)
    corr = prng.categorical(prng.fold_in(rng, 1), torch.log(torch.clamp_min(dist, 1e-38)))
    committed = torch.cat(
        [drafts.long(), torch.zeros((batch, 1), dtype=torch.long, device=drafts.device)],
        dim=1,
    )
    committed[row, n] = corr
    return committed, n


def _greedy_commit(drafts: torch.Tensor, picks: torch.Tensor):
    """Greedy agreement: each row's longest prefix with
    drafts[j] == picks[j], then the target's pick at that row's own n
    (the correction, or the bonus token after a fully agreeing block).
    Returns (committed [b, gamma+1], n [b])."""
    batch = drafts.shape[0]
    row = torch.arange(batch, device=drafts.device)
    agree = drafts == picks[:, :-1]
    n = torch.argmin(
        torch.cat([agree, torch.zeros((batch, 1), dtype=torch.bool, device=drafts.device)],
                  dim=1).to(torch.uint8),
        dim=1,
    )
    committed = torch.cat(
        [drafts.long(), torch.zeros((batch, 1), dtype=torch.long, device=drafts.device)],
        dim=1,
    )
    committed[row, n] = picks[row, n].long()
    return committed, n


def _draft_steps(d_params, d_pools, tables, cur, positions, d_config, gamma,
                 attention_fn=None, sampling=False, rng=None,
                 temperature=0.0, top_k=0, top_p=1.0, reduce=None):
    """The draft phase: gamma + 1 draft decode steps from ``cur`` at
    per-row ``positions`` (step i at positions + i, so the kernel's page
    walk sees each step's own length); the extra step writes the final
    proposal's k/v, so a fully accepted round leaves no hole in the
    draft cache.  Sampling proposes from the draft's filtered
    distribution (the target's knobs) under ``fold_in(rng, 2 + i)`` and
    keeps it for the rejection rule.  Returns (drafts [b, gamma], last [b], q [b, gamma, vocab] or
    None)."""
    tok, proposals, qs = cur.long(), [], []
    for i in range(gamma + 1):
        logits, _ = _decode_core(d_params, d_pools, tables, tok, positions + i, d_config,
                                 attention_fn, reduce=reduce)
        if sampling:
            f = filter_logits(logits, temperature, top_k, top_p)
            tok = prng.categorical(prng.fold_in(rng, 2 + i), f)
            qs.append(torch.softmax(f, dim=-1))
        else:
            tok = torch.argmax(logits, dim=-1)
        proposals.append(tok)
    drafts = torch.stack(proposals[:gamma], dim=1)
    q = torch.stack(qs[:gamma], dim=1) if sampling else None
    return drafts, proposals[-1], q


def _spec_round_core(
    t_params, d_params, t_pools, d_pools, tables, cur, positions, t_config, d_config,
    gamma, cover_pages=None, d_attention_fn=None, occupancy=None, sampling=False,
    rng=None, temperature=0.0, top_k=0, top_p=1.0, pin_parked=True, t_lora=None,
    reduce=None,
):
    """One batched speculative round: the draft proposes ``gamma`` tokens
    a row, the target scores every row's block [cur, d_1..d_gamma] in one
    rowwise forward, and each row commits its own accepted prefix plus
    the correction (greedy agreement, or ``_spec_accept`` under
    ``sampling``, which draws under ``rng``: the draft's proposals from
    ``fold_in(rng, 2 + i)``, the uniforms and the correction from
    ``fold_in(rng, 0)`` and ``fold_in(rng, 1)``).  Both pool pairs update in
    place.  ``cover_pages`` slices the tables to the columns live.

    With ``occupancy`` it also returns the chained next-round state
    (new_cur, new_pos): occupied rows advance by their own n + 1, the
    rest pass through.  Parked rows' positions pin to 0, inside any
    cover, unless ``pin_parked=False``: the chained-retirement superstep
    keeps a frozen row at its real position, since position 0 would aim
    its dead writes at first pages the prefix cache or a fan-out group
    may share; its caller keeps every parked position inside the
    cover-sliced table.  ``t_lora=(stacked, idx, alpha)`` adapts the
    TARGET's verify per row; the draft stays unadapted, so the committed
    tokens are the adapted model's and speculation stays lossless per
    tenant (a worse guesser only lowers acceptance).  ``reduce`` is the
    row-parallel all-reduce of both models on a tensor-parallel rank
    (see ``_decode_core``).  Returns (committed [b, gamma+1], n [b]) or
    (committed, n, new_cur, new_pos)."""
    if sampling and rng is None:
        raise ValueError("sampling speculative round requires an rng key")
    batch = cur.shape[0]
    if cover_pages is not None:
        tables = tables[:, :cover_pages].contiguous()  # the kernel takes it contiguous
    positions = positions.long()
    if occupancy is not None and pin_parked:
        positions = torch.where(occupancy, positions, 0)
    drafts, _, q = _draft_steps(
        d_params, d_pools, tables, cur, positions, d_config, gamma, d_attention_fn,
        sampling, rng, temperature, top_k, top_p, reduce=reduce,
    )
    block = torch.cat([cur.long()[:, None], drafts], dim=1)
    t_logits, _ = _rowwise_block_core(t_params, t_pools, tables, block, positions, t_config,
                                      lora=t_lora, reduce=reduce)
    if sampling:
        p = torch.softmax(filter_logits(t_logits, temperature, top_k, top_p), dim=-1)
        committed, n = _spec_accept(drafts, q, p, rng)
    else:
        committed, n = _greedy_commit(drafts, torch.argmax(t_logits, dim=-1))
    if occupancy is None:
        return committed, n
    row = torch.arange(batch, device=cur.device)
    new_cur = torch.where(occupancy, committed[row, n], cur.long())
    new_pos = torch.where(occupancy, positions + n + 1, positions)
    return committed, n, new_cur, new_pos


@torch.inference_mode()
def paged_spec_round(
    t_params, d_params, t_pools, d_pools, tables, cur, positions, t_config, d_config,
    gamma, cover_pages=None, sampling=False, rng=None, temperature=0.0, top_k=0,
    top_p=1.0, t_lora=None,
):
    """One batched speculative round over the paged caches.  cur: [batch]
    the latest committed token a row, at positions[b]; tables must cover
    positions + gamma + 1.  Returns (committed [batch, gamma+1], n
    [batch], t_pools, d_pools), the pools updated in place: row b's new
    tokens are committed[b, :n[b]+1] and its position advances by
    n[b]+1.  Rejected drafts' k/v stay as stale slots: every mask admits
    positions only up to each row's committed length, and later rounds
    overwrite them first.  ``sampling`` switches greedy agreement for
    lossless speculative sampling (``_spec_accept``) under
    temperature/top_k/top_p, drawing under the key ``rng``.  ``t_lora``
    adapts the target's verify per row (see ``_spec_round_core``)."""
    committed, n = _spec_round_core(
        t_params, d_params, t_pools, d_pools, tables, cur, positions, t_config, d_config,
        gamma, cover_pages, sampling=sampling, rng=rng,
        temperature=temperature, top_k=top_k, top_p=top_p, t_lora=t_lora,
    )
    return committed, n, t_pools, d_pools


@torch.inference_mode()
def paged_spec_round_chained(
    t_params, d_params, t_pools, d_pools, tables, cur, positions, occupancy, t_config,
    d_config, gamma, cover_pages=None, sampling=False, rng=None, temperature=0.0,
    top_k=0, top_p=1.0, t_lora=None,
):
    """``paged_spec_round`` with the chained next-round state on the
    device: returns (committed, n, new_cur, new_pos, t_pools, d_pools),
    so the next round can start before this one's tokens reach the host.
    Parked rows (occupancy False) are reset, not frozen: their position
    pins to 0 and comes back 0, their token passes through; a caller
    re-admitting a row injects its host-side (cur, pos)."""
    out = _spec_round_core(
        t_params, d_params, t_pools, d_pools, tables, cur, positions, t_config, d_config,
        gamma, cover_pages, occupancy=occupancy, sampling=sampling, rng=rng,
        temperature=temperature, top_k=top_k, top_p=top_p, t_lora=t_lora,
    )
    return (*out, t_pools, d_pools)


def _spec_superstep_core(
    t_params, d_params, t_pools, d_pools, tables, cur, positions, occupancy, t_config,
    d_config, gamma, k, cover_pages=None, d_attention_fn=None, sampling=False,
    rng=None, temperature=0.0, top_k=0, top_p=1.0, t_lora=None, reduce=None,
):
    """``k`` chained rounds (``paged_spec_round_chained``'s body in a
    loop), round ``i`` drawing under ``split(rng, k)[i]``; returns
    (committed [k, b, gamma+1], n [k, b], new_cur, new_pos)."""
    if sampling and rng is None:
        raise ValueError("sampling speculative superstep requires an rng key")
    keys = prng.split(rng, k) if sampling else None
    committed, ns = [], []
    cur, pos = cur.long(), positions.long()
    for i in range(k):
        c, n, cur, pos = _spec_round_core(
            t_params, d_params, t_pools, d_pools, tables, cur, pos, t_config, d_config,
            gamma, cover_pages, d_attention_fn, occupancy=occupancy, sampling=sampling,
            rng=keys[i] if sampling else None, temperature=temperature, top_k=top_k,
            top_p=top_p, t_lora=t_lora, reduce=reduce,
        )
        committed.append(c)
        ns.append(n)
    return torch.stack(committed), torch.stack(ns), cur, pos


@torch.inference_mode()
def paged_spec_superstep(
    t_params, d_params, t_pools, d_pools, tables, cur, positions, occupancy, t_config,
    d_config, gamma, k, cover_pages=None, sampling=False, rng=None,
    temperature=0.0, top_k=0, top_p=1.0, t_lora=None, reduce=None,
):
    """``k`` chained speculative rounds in one dispatch (lookahead): the
    host leaves the loop for k rounds.  Tables must already cover
    positions + k*(gamma+1) for occupied rows; rows that retire mid-way
    compute dead rounds to the end (the consumer stops emitting at
    eos/max_new).  Returns (committed [k, batch, gamma+1], n [k, batch],
    new_cur, new_pos, t_pools, d_pools), per round in execution order
    and the state after round k."""
    out = _spec_superstep_core(
        t_params, d_params, t_pools, d_pools, tables, cur, positions, occupancy,
        t_config, d_config, gamma, k, cover_pages, sampling=sampling,
        rng=rng, temperature=temperature, top_k=top_k, top_p=top_p,
        t_lora=t_lora, reduce=reduce,
    )
    return (*out, t_pools, d_pools)


def spec_retire(committed, n, live, budget, eos):
    """The engine's emission rule (``ServeEngine._emit``) as device data,
    after one round: a committed token is seen iff it sits at index
    <= n and inside the remaining ``budget``, and a live row retires iff
    a seen token is its ``eos`` or the round exhausted its budget.
    Returns (new_live, new_budget)."""
    idx = torch.arange(committed.shape[1], device=committed.device)[None, :]
    seen = (idx <= n[:, None]) & (idx < budget[:, None])
    hit_eos = (seen & (committed == eos[:, None])).any(dim=1)
    new_budget = torch.where(live, budget - (n + 1).to(budget.dtype), budget)
    new_live = live & ~hit_eos & (new_budget > 0)
    return new_live, new_budget


def spec_chained_round(
    t_params, d_params, t_pools, d_pools, tables, cur, pos, live, budget, eos, t_config,
    d_config, gamma, cover_pages=None, d_attention_fn=None, sampling=False,
    rng=None, temperature=0.0, top_k=0, top_p=1.0, t_lora=None, reduce=None,
):
    """One round of the chained-retirement superstep (and the round
    ``decode_graph.SpecGraph`` captures): the round with ``live`` as its
    occupancy and frozen rows kept at their position, then the emission
    rule.  ``rng`` is the round's own key (the chained superstep passes
    ``split(key, 1)[0]`` of its engine key, the lookahead superstep
    ``split(rng, k)[i]``).  Returns (committed, n, new_cur, new_pos, new_live,
    new_budget)."""
    committed, n, new_cur, new_pos = _spec_round_core(
        t_params, d_params, t_pools, d_pools, tables, cur, pos, t_config, d_config, gamma,
        cover_pages, d_attention_fn, occupancy=live, sampling=sampling,
        rng=rng, temperature=temperature, top_k=top_k, top_p=top_p,
        pin_parked=False, t_lora=t_lora, reduce=reduce,
    )
    new_live, new_budget = spec_retire(committed, n, live, budget, eos)
    return committed, n, new_cur, new_pos, new_live, new_budget


def _spec_superstep_chained_core(
    t_params, d_params, t_pools, d_pools, tables, cur, positions, occupancy, live,
    budget, eos, t_config, d_config, gamma, k, cover_pages=None, d_attention_fn=None,
    sampling=False, rngs=None, temperature=0.0, top_k=0, top_p=1.0, t_lora=None,
    reduce=None,
):
    """``paged_spec_superstep_chained``'s body.  Empty slots (occupancy
    False: all-trash tables) pin to position 0 once at entry; rows that
    freeze mid-way keep their real position (see ``_spec_round_core``'s
    ``pin_parked``).  Entry positions of occupied rows are inside the
    cover by the engine's pre-extension, and frozen positions never
    grow.  Round ``i`` draws under ``split(rngs[i], 1)[0]``, the k=1
    superstep's one split of its engine key, as in the JAX package."""
    pos = torch.where(occupancy, positions.long(), 0)
    live = live & occupancy
    cur, budget = cur.long(), budget.clone()
    keys = prng.split(rngs, 1)[:, 0] if sampling else None
    committed, ns, lives = [], [], []
    for i in range(k):
        lives.append(live)
        c, n, cur, pos, live, budget = spec_chained_round(
            t_params, d_params, t_pools, d_pools, tables, cur, pos, live, budget, eos,
            t_config, d_config, gamma, cover_pages, d_attention_fn, sampling,
            keys[i] if sampling else None, temperature, top_k, top_p, t_lora=t_lora,
            reduce=reduce,
        )
        committed.append(c)
        ns.append(n)
    return (torch.stack(committed), torch.stack(ns), torch.stack(lives), cur, pos, live,
            budget)


@torch.inference_mode()
def paged_spec_superstep_chained(
    t_params, d_params, t_pools, d_pools, tables, cur, positions, occupancy, live,
    budget, eos, t_config, d_config, gamma, k, cover_pages=None, sampling=False,
    rngs=None, temperature=0.0, top_k=0, top_p=1.0, t_lora=None, reduce=None,
):
    """``k`` chained draft -> verify -> commit rounds in one dispatch with
    device-side acceptance masks and retirement: per round the engine's
    emission rule (``spec_retire``) flips a row's ``live`` mask the round
    its terminal token lands, freezing its token and position (its dead
    rounds write only its own overwritable slots or trash, never
    position 0, where shared pages live).  budget/eos: [batch] (eos -1 =
    none); rngs: [k, 2], one engine key a round.  Tables must cover
    min(positions + k*(gamma+1), positions + budget + gamma + 1) for live
    rows.  Returns (committed [k, batch,
    gamma+1], n [k, batch], round_live [k, batch] (the mask at each
    round's entry, the host's emission gate), new_cur, new_pos, new_live,
    new_budget, t_pools, d_pools).  ``t_lora`` adapts the target's verify
    per row (see ``_spec_round_core``)."""
    out = _spec_superstep_chained_core(
        t_params, d_params, t_pools, d_pools, tables, cur, positions, occupancy, live,
        budget, eos, t_config, d_config, gamma, k, cover_pages, sampling=sampling,
        rngs=rngs, temperature=temperature, top_k=top_k, top_p=top_p,
        t_lora=t_lora, reduce=reduce,
    )
    return (*out, t_pools, d_pools)


# Per-phase probes: each phase of a round on its own, operation for
# operation as the fused round runs it, so a round's device time can be
# split into draft, verify and commit.


@torch.inference_mode()
def paged_spec_draft_phase(d_params, d_pools, tables, cur, positions, d_config, gamma,
                           cover_pages=None):
    """Only the draft phase: gamma + 1 draft decode steps from ``cur``.
    Returns (drafts [batch, gamma], last [batch], d_pools)."""
    if cover_pages is not None:
        tables = tables[:, :cover_pages].contiguous()  # the kernel takes it contiguous
    drafts, last, _ = _draft_steps(d_params, d_pools, tables, cur, positions.long(),
                                   d_config, gamma)
    return drafts, last, d_pools


@torch.inference_mode()
def paged_spec_verify_phase(t_params, t_pools, tables, block, positions, t_config,
                            cover_pages=None, t_lora=None):
    """Only the verify phase: one rowwise block forward of ``block``
    [batch, gamma+1] through the target (adapted per row with
    ``t_lora``).  Returns (picks [batch, gamma+1], t_pools)."""
    if cover_pages is not None:
        tables = tables[:, :cover_pages].contiguous()  # the kernel takes it contiguous
    t_logits, _ = _rowwise_block_core(t_params, t_pools, tables, block, positions, t_config,
                                      lora=t_lora)
    return torch.argmax(t_logits, dim=-1), t_pools


@torch.inference_mode()
def spec_commit_phase(drafts, picks):
    """Only the commit phase: greedy agreement, the fused round's ops.
    Returns (committed [batch, gamma+1], n [batch])."""
    return _greedy_commit(drafts, picks)
