"""Radix-tree prefix cache over a paged KV block pool.

Every KV-reuse path in the engine — local shared-prefix admission,
multi-turn session history, disagg handoff adoption — lands here. The
previous design (an aligned-bucket LRU of monolithic batch-1 slabs)
could only hit on `prefix_align` boundaries and paid a slab copy for
every insert/evict/handoff. This rebuild follows the literature the
repo tracks in PAPERS.md:

  - RadixAttention (SGLang): a radix tree over token sequences makes
    EVERY shared prefix reusable — multi-turn histories of arbitrary
    length, agent trees, shared system prompts — not just the ones that
    happen to end on an alignment boundary.
  - PagedAttention (vLLM): KV lives in fixed-size blocks drawn from a
    fixed pool, so cache membership is pointer arithmetic: insert is a
    scatter of NEW blocks only, adoption of already-resident content is
    a refcount bump, and eviction frees block ids without touching HBM.

Split of responsibilities: this module is pure host-side bookkeeping
(block ids, refcounts, the tree) with no JAX dependency — the engine
owns the device-side pool array (`[L, n_blocks, block_tokens, K, D]`)
and the two compiled programs that move KV in and out of it
(`insert_from_blocks` gather-seed, `write_blocks` scatter-store). The
pool's shapes are FIXED at construction: a fixed block size, a fixed
block count, index vectors padded to each bucket's block count — zero
steady-state recompiles (symlint R3 guards the programs themselves).

Design points:

  - Match granularity is ONE BLOCK (`block_tokens`, default 16), not
    one bucket: lookup walks the tree in whole blocks and returns the
    longest block-aligned strict prefix with resident KV. Strictly
    partial only — the suffix (>= 1 token) produces the first sampled
    token, same contract as before.
  - Nodes own block lists; children are keyed by their edge's first
    block (siblings always diverge within their first block — insert
    splits edges at block boundaries to keep that invariant).
  - Eviction is leaf-LRU and frees blocks, never copies: the
    least-recently-touched leaf whose blocks are unpinned is detached
    and its block ids returned to the free list. Interior nodes become
    evictable once their children go.
  - Pins are per-block refcounts. A block's refcount is 1 while only
    the tree owns it; a `RadixHit` holds +1 on every matched block
    until `release()` (the engine releases once the seed gather out of
    the pool is dispatched). Blocks with refcount > 1 are never freed.
  - Insert is two-phase: `plan_insert` allocates block ids for the
    UNCOVERED tail (evicting leaf-LRU as needed) without touching the
    tree; the engine scatters KV into those blocks on device and then
    `commit()`s the plan (or `abort()`s on a failed dispatch, returning
    the ids). The tree therefore never references a block whose KV
    write was not dispatched.

Thread contract: all mutating calls happen on the scheduler's engine
thread. stats() may be read cross-thread — it snapshots plain ints
under the GIL, the same discipline as the scheduler's metrics dict
(no tree walks, no dict iteration over mutable containers).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any

from symmetry_tpu_torch.utils.metrics import METRICS, MetricName


def prefix_digest(token_bytes: bytes) -> bytes:
    """Content digest used for block manifests (handoff frames) and the
    prefill tier's shipped-block ledger. A block's KV depends on EVERY
    token at or before it (causal attention), so block j's digest
    covers tokens[: (j+1) * block_tokens] — two blocks share a digest
    iff their full causal context matches."""
    return hashlib.blake2b(token_bytes, digest_size=16).digest()


def token_bytes(tokens) -> bytes:
    import numpy as np

    return np.asarray(tokens, dtype=np.int32).tobytes()


def block_digests(tokens, p: int, block_tokens: int) -> list[str]:
    """Hex digests for the p // block_tokens blocks covering
    tokens[:p], each over its full causal context (see prefix_digest).
    One running hash, copied per block — O(p) total, not O(p^2)."""
    if block_tokens < 1 or p % block_tokens:
        raise ValueError(
            f"prefix length {p} is not a multiple of block size "
            f"{block_tokens}")
    buf = token_bytes(tokens[:p])
    step = block_tokens * 4  # int32 tokens
    h = hashlib.blake2b(digest_size=16)
    out: list[str] = []
    for j in range(p // block_tokens):
        h.update(buf[j * step: (j + 1) * step])
        out.append(h.copy().digest().hex())
    return out


class BlockPool:
    """Refcounted free list over a fixed set of KV block ids.

    Block id 0 is the TRASH block: scatter dispatches are padded to each
    bucket's full block count, and every pad lane writes to the trash
    block, whose content nobody ever reads. It is never allocated.
    Ids 1..n_blocks are the allocatable pool."""

    TRASH = 0

    def __init__(self, n_blocks: int, block_tokens: int,
                 block_bytes: int) -> None:
        if n_blocks < 1:
            raise ValueError("block pool needs at least one block")
        if block_tokens < 1:
            raise ValueError("block size must be >= 1 token")
        self.n_blocks = int(n_blocks)
        self.block_tokens = int(block_tokens)
        self.block_bytes = int(block_bytes)
        # refcount per id (index 0 = trash, never allocated): 0 = free,
        # 1 = tree-owned, > 1 = tree-owned and pinned by hits in flight.
        self._refs = [0] * (self.n_blocks + 1)
        self._free = list(range(self.n_blocks, 0, -1))  # pop() -> 1 first
        self._in_use = 0
        self._pinned = 0          # blocks with refs > 1
        self._high_water = 0      # peak blocks in use (bytes via property)
        self._m_in_use = METRICS.gauge(
            MetricName.PREFIX_BLOCKS_IN_USE,
            "KV blocks currently owned by the radix prefix cache")

    # ------------------------------------------------------------ queries

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self._in_use

    @property
    def pinned(self) -> int:
        return self._pinned

    @property
    def bytes_in_use(self) -> int:
        return self._in_use * self.block_bytes

    @property
    def budget_bytes(self) -> int:
        return self.n_blocks * self.block_bytes

    @property
    def hbm_high_water_bytes(self) -> int:
        """Peak pool occupancy in bytes — the per-session memory-economics
        number ROADMAP item 3 asks the bench to report. (The device pool
        array itself is allocated once at construction; this tracks how
        much of it the cache has ever actually owned.)"""
        return self._high_water * self.block_bytes

    def refcount(self, block_id: int) -> int:
        return self._refs[block_id]

    # ----------------------------------------------------------- mutation

    def alloc(self, n: int) -> list[int] | None:
        """Allocate `n` blocks at refcount 1, or None (all-or-nothing)
        when the free list is short — the caller evicts and retries."""
        if n < 0:
            raise ValueError("alloc of negative block count")
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        for i in ids:
            self._refs[i] = 1
        self._in_use += n
        self._high_water = max(self._high_water, self._in_use)
        self._m_in_use.set(self._in_use)
        return ids

    def ref(self, ids) -> None:
        for i in ids:
            if self._refs[i] < 1:
                raise RuntimeError(f"ref of free block {i}")
            self._refs[i] += 1
            if self._refs[i] == 2:
                self._pinned += 1

    def unref(self, ids) -> None:
        """Drop one reference per id; a block reaching refcount 0 goes
        back to the free list."""
        for i in ids:
            r = self._refs[i] - 1
            if r < 0:
                raise RuntimeError(f"unref of free block {i}")
            self._refs[i] = r
            if r == 1:
                self._pinned -= 1
            elif r == 0:
                self._in_use -= 1
                self._free.append(i)
        self._m_in_use.set(self._in_use)


class RadixNode:
    """One tree node: an edge of whole blocks from its parent."""

    __slots__ = ("tokens", "blocks", "children", "parent", "last_used")

    def __init__(self, tokens: tuple[int, ...], blocks: list[int],
                 parent: "RadixNode | None") -> None:
        self.tokens = tokens          # edge label; len == len(blocks)*BS
        self.blocks = blocks          # pool ids, one per edge block
        self.children: dict[tuple[int, ...], RadixNode] = {}
        self.parent = parent
        self.last_used = 0


@dataclass
class RadixHit:
    """A pinned lookup result: `blocks` hold the KV of
    `prompt[:length]`, in order. Call release() once the gather out of
    the pool has been dispatched (idempotent — safe from cleanup
    paths). `group_key` partitions scheduler admissions: requests with
    equal (node, matched_len) share one seed dispatch."""

    node: RadixNode
    length: int                    # matched tokens (multiple of block size)
    blocks: tuple[int, ...]
    tokens: tuple[int, ...]        # the matched prefix itself
    _index: "RadixIndex | None" = field(repr=False, default=None)
    _released: bool = False

    @property
    def group_key(self) -> tuple[int, int]:
        return (id(self.node), self.length)

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._index.pool.unref(self.blocks)


@dataclass
class InsertPlan:
    """Blocks allocated for an insert's uncovered tail; the tree learns
    about them only at commit() — after the device scatter dispatched.
    The plan PINS the matched prefix path for its lifetime: the
    eviction its own allocation may trigger (and any other eviction
    between plan and commit) must never free the blocks the new tail
    extends."""

    tokens: tuple[int, ...]        # the FULL prefix being inserted
    matched_len: int               # tokens already resident (tree-covered)
    new_ids: list[int]             # one per new block, in prefix order
    matched_blocks: tuple[int, ...] = ()   # pinned until commit/abort
    _index: "RadixIndex | None" = field(repr=False, default=None)
    _done: bool = False

    def commit(self) -> None:
        if self._done:
            raise RuntimeError("insert plan already resolved")
        self._done = True
        try:
            self._index._commit(self)
        finally:
            self._index.pool.unref(self.matched_blocks)

    def abort(self) -> None:
        if not self._done:
            self._done = True
            self._index.pool.unref(self.new_ids)
            self._index.pool.unref(self.matched_blocks)


class RadixIndex:
    """The radix tree over token sequences, indexing pool blocks."""

    def __init__(self, pool: BlockPool) -> None:
        self.pool = pool
        self.block_tokens = pool.block_tokens
        self._root = RadixNode((), [], None)
        self._tick = 0
        self._n_nodes = 0
        # Eviction candidates in LRU order (oldest first): every LEAF,
        # keyed by id(node), re-ordered on touch. Kept incrementally so
        # an insert-under-pressure pays O(evicted leaves), not a full
        # tree scan per freed leaf. A node whose last child is evicted
        # re-enters at the tail — slightly fresher than its last_used
        # tick says, a deliberate approximation (its subtree WAS in use
        # more recently than the tick).
        self._leaves: "dict[int, RadixNode]" = {}
        self.stats_counters = {
            "hits": 0, "misses": 0, "insertions": 0, "evictions": 0,
            "rejected": 0, "tokens_reused": 0, "nodes_evicted": 0,
        }
        self._m_evicted = METRICS.counter(
            MetricName.PREFIX_BLOCKS_EVICTED,
            "KV blocks freed by leaf-LRU eviction")
        self._m_hit_depth = METRICS.histogram(
            MetricName.PREFIX_HIT_DEPTH,
            "blocks matched per radix lookup hit")

    # ------------------------------------------------------------ queries

    def __len__(self) -> int:
        return self._n_nodes

    @property
    def bytes_used(self) -> int:
        return self.pool.bytes_in_use

    def _now(self) -> int:
        self._tick += 1
        return self._tick

    def _walk(self, tokens, limit_blocks: int,
              touch: bool) -> tuple[RadixNode, list[int], int]:
        """Descend from the root matching whole blocks of `tokens`, at
        most `limit_blocks`. Returns (deepest node reached, matched
        block ids in order, matched token count). `touch` refreshes
        LRU recency along the path."""
        bs = self.block_tokens
        node = self._root
        blocks: list[int] = []
        pos = 0
        now = self._now() if touch else 0
        while len(blocks) < limit_blocks:
            key = tuple(tokens[pos:pos + bs])
            child = node.children.get(key)
            if child is None:
                break
            nb = len(child.blocks)
            take = 1  # the key IS the first edge block
            while (take < nb and len(blocks) + take < limit_blocks
                   and child.tokens[take * bs:(take + 1) * bs]
                   == tuple(tokens[pos + take * bs:pos + (take + 1) * bs])):
                take += 1
            blocks.extend(child.blocks[:take])
            pos += take * bs
            if touch:
                child.last_used = now
                if not child.children:
                    # Refresh the leaf's LRU position (dicts preserve
                    # insertion order; re-inserting moves it to the
                    # tail = most recently used).
                    self._leaves.pop(id(child), None)
                    self._leaves[id(child)] = child
            node = child
            if take < nb:
                break  # diverged (or hit the limit) inside this edge
        return node, blocks, pos

    def lookup(self, prompt_ids) -> RadixHit | None:
        """Longest block-aligned strict prefix of `prompt_ids` with
        resident KV, pinned; None on miss. Does NOT touch the hit/miss
        counters — the engine counts per ADMITTED request via
        note_reuse/note_miss (a request may be looked up several times
        before it actually admits), so hit_rate means 'fraction of
        admissions that reused cached KV'."""
        n = len(prompt_ids)
        limit = (n - 1) // self.block_tokens  # suffix must keep >= 1 token
        if limit <= 0:
            return None
        node, blocks, pos = self._walk(prompt_ids, limit, touch=True)
        if not blocks:
            return None
        self.pool.ref(blocks)
        self._m_hit_depth.observe(len(blocks))
        return RadixHit(node=node, length=pos, blocks=tuple(blocks),
                        tokens=tuple(prompt_ids[:pos]), _index=self)

    def match_len(self, tokens) -> int:
        """Resident coverage of `tokens` in whole blocks (token count;
        NOT capped below len(tokens) — used by insert planning and
        adoption, where full coverage means nothing to do)."""
        _, _, pos = self._walk(tokens, len(tokens) // self.block_tokens,
                               touch=False)
        return pos

    def covers(self, tokens) -> bool:
        """True when every whole block of `tokens` is already resident
        (used to skip redundant store dispatches)."""
        p = (len(tokens) // self.block_tokens) * self.block_tokens
        return p == 0 or self.match_len(tokens) >= p

    # ----------------------------------------------------------- mutation

    def plan_insert(self, tokens) -> InsertPlan | None:
        """Allocate blocks for the uncovered tail of `tokens` (whose
        length must be a whole number of blocks), evicting leaf-LRU
        until they fit. The matched prefix path is PINNED (refcounted)
        for the plan's lifetime — the eviction this very allocation
        triggers must never free the blocks the tail extends. None when
        `tokens` is fully resident, empty, or cannot fit even after
        eviction (counted as rejected)."""
        bs = self.block_tokens
        p = len(tokens)
        if p == 0 or p % bs:
            return None
        _node, matched, m = self._walk(tokens, p // bs, touch=True)
        need = (p - m) // bs
        if need == 0:
            return None
        self.pool.ref(matched)
        ids = None
        try:
            ids = self.pool.alloc(need)
            while ids is None and self._evict_one():
                ids = self.pool.alloc(need)
            if ids is not None:
                return InsertPlan(tokens=tuple(tokens), matched_len=m,
                                  new_ids=ids,
                                  matched_blocks=tuple(matched),
                                  _index=self)
        except Exception:
            # An eviction failure (or anything else between alloc and
            # the plan handoff) must not leak the matched-prefix pin or
            # the freshly allocated blocks.
            if ids is not None:
                self.pool.unref(ids)
            self.pool.unref(matched)
            raise
        self.pool.unref(matched)
        self.stats_counters["rejected"] += 1
        return None

    def _commit(self, plan: InsertPlan) -> None:
        """Attach the plan's blocks to the tree, splitting the edge at
        the divergence boundary when needed so siblings keep diverging
        within their first block."""
        bs = self.block_tokens
        tokens = plan.tokens
        # Re-walk: the tree may have changed between plan and commit
        # only via THIS thread (engine-thread contract), and a commit
        # always directly follows its plan — but re-walking keeps the
        # structure correct even if that ever changes, at negligible
        # cost. The matched coverage is the plan's by construction.
        node, _, pos = self._walk(tokens, plan.matched_len // bs,
                                  touch=False)
        if pos != plan.matched_len:
            # The resident prefix changed between plan and commit —
            # engine-thread contract broken. Fail loudly, free the ids.
            self.pool.unref(plan.new_ids)
            raise RuntimeError(
                f"radix commit raced an eviction/insert: planned match "
                f"{plan.matched_len}, found {pos}")
        # `node` is the deepest node on the path; if the match ended
        # INSIDE node's edge, split it at the boundary.
        depth_into = pos - self._depth_of_parent(node)
        if node is not self._root and depth_into < len(node.tokens):
            node = self._split(node, depth_into)
        child = RadixNode(tokens=tuple(tokens[pos:]),
                          blocks=list(plan.new_ids), parent=node)
        child.last_used = self._now()
        node.children[tuple(tokens[pos:pos + bs])] = child
        self._leaves.pop(id(node), None)   # gained a child: not a leaf
        self._leaves[id(child)] = child
        self._n_nodes += 1
        self.stats_counters["insertions"] += 1

    def _depth_of_parent(self, node: RadixNode) -> int:
        """Token depth at which `node`'s edge starts."""
        d = 0
        cur = node.parent
        while cur is not None:
            d += len(cur.tokens)
            cur = cur.parent
        return d

    def _split(self, node: RadixNode, at: int) -> RadixNode:
        """Split `node`'s edge at token offset `at` (a block boundary
        inside the edge); returns the new upper node. Block ownership
        moves with the tokens; refcounts are untouched (same owners)."""
        bs = self.block_tokens
        assert 0 < at < len(node.tokens) and at % bs == 0
        upper = RadixNode(tokens=node.tokens[:at],
                          blocks=node.blocks[:at // bs],
                          parent=node.parent)
        upper.last_used = node.last_used
        parent_key = node.tokens[:bs]
        node.parent.children[parent_key] = upper
        node.tokens = node.tokens[at:]
        node.blocks = node.blocks[at // bs:]
        node.parent = upper
        upper.children[node.tokens[:bs]] = node
        self._n_nodes += 1
        return upper

    def _evict_one(self) -> bool:
        """Detach the least-recently-used LEAF whose blocks are all
        unpinned and free its blocks; False when nothing is safely
        evictable. Walks the incrementally-maintained LRU leaf registry,
        skipping pinned leaves in place — O(pinned prefix) per evicted
        leaf, never a tree scan, never on the lookup fast path."""
        victim: RadixNode | None = None
        for node in self._leaves.values():
            if all(self.pool.refcount(b) == 1 for b in node.blocks):
                victim = node
                break  # oldest unpinned leaf
        if victim is None:
            return False
        del self._leaves[id(victim)]
        del victim.parent.children[victim.tokens[:self.block_tokens]]
        parent = victim.parent
        if parent is not self._root and not parent.children:
            self._leaves[id(parent)] = parent  # exposed: evictable next
        self.pool.unref(victim.blocks)
        self._n_nodes -= 1
        self.stats_counters["evictions"] += len(victim.blocks)
        self.stats_counters["nodes_evicted"] += 1
        self._m_evicted.inc(len(victim.blocks))
        return True

    # --------------------------------------------------------- accounting

    def note_reuse(self, n_requests: int, prefix_len: int) -> None:
        """Account `n_requests` ADMITTED via cached KV (one hit each)
        and the prefill tokens their dispatch skipped."""
        self.stats_counters["hits"] += n_requests
        self.stats_counters["tokens_reused"] += n_requests * prefix_len

    def note_miss(self, n_requests: int) -> None:
        self.stats_counters["misses"] += n_requests

    def summary(self, max_digests: int = 64) -> dict[str, Any] | None:
        """Compact cache summary for pool gossip: up to `max_digests`
        block digests along the HOTTEST root→leaf paths (most recently
        used first — the prefixes a session-affine router should chase)
        plus a depth histogram of those paths, in blocks. Rides the
        stats probe as a heartbeat payload field; the PoolRouter on the
        provider side intersects a request's own digests against it to
        predict hit depth.

        Digests are the same causal blake2b-16 hexes as the handoff
        manifests (`block_digests`), so router-side digests computed
        from the routing tokenizer's prompt ids match exactly.

        Unlike every mutating call, this may run OFF the engine thread
        (the host's serve loop answers STATS while the engine thread
        inserts/evicts). Reads are GIL-atomic snapshots but a racing
        split/evict can garble one path — a garbled digest is only a
        wrong routing hint, so the whole walk is exception-guarded:
        degrade (None → load-only placement), never wedge."""
        if max_digests <= 0:
            return None
        try:
            digests: dict[str, None] = {}  # ordered de-dup
            depths: dict[int, int] = {}
            for leaf in reversed(list(self._leaves.values())):
                if len(digests) >= max_digests:
                    break
                # Root-path tokens via the parent chain (leaf-upward,
                # then reversed into prefix order).
                parts: list[tuple[int, ...]] = []
                node: RadixNode | None = leaf
                while node is not None and node.parent is not None:
                    parts.append(node.tokens)
                    node = node.parent
                tokens: list[int] = []
                for part in reversed(parts):
                    tokens.extend(part)
                p = (len(tokens) // self.block_tokens) * self.block_tokens
                if p == 0:
                    continue
                depth = p // self.block_tokens
                depths[depth] = depths.get(depth, 0) + 1
                for d in block_digests(tokens, p, self.block_tokens):
                    digests.setdefault(d, None)
            if not digests:
                return None
            return {"block_tokens": self.block_tokens,
                    "digests": list(digests)[:max_digests],
                    "depths": {str(k): v
                               for k, v in sorted(depths.items())}}
        except Exception:
            return None

    def stats(self) -> dict[str, Any]:
        out: dict[str, Any] = dict(self.stats_counters)
        pool = self.pool
        out["nodes"] = self._n_nodes
        out["block_tokens"] = pool.block_tokens
        out["blocks_total"] = pool.n_blocks
        out["blocks_in_use"] = pool.in_use
        out["blocks_free"] = pool.free_count
        out["pinned"] = pool.pinned
        out["bytes"] = pool.bytes_in_use
        out["budget_bytes"] = pool.budget_bytes
        out["hbm_high_water_bytes"] = pool.hbm_high_water_bytes
        n = out["hits"] + out["misses"]
        out["hit_rate"] = round(out["hits"] / n, 4) if n else 0.0
        return out
