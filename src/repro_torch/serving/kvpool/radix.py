"""Token-prefix radix cache over KV pages: shared prompt prefixes, COW.
Twin of ``repro/serving/kvpool/radix.py``, kept as the port's own copy.

A trie keyed by page-grid-aligned token chunks. Node ``i`` on a root-path
covers prompt positions ``[i*P, i*P + len(node.tokens))`` and owns exactly
ONE page:

  * FULL nodes (``len(tokens) == P``) sit in their parent's ``children``
    dict keyed by the full P-token chunk and may have descendants;
  * PARTIAL nodes (``len(tokens) < P``) are tail leaves in their parent's
    ``partials`` list — a prompt ending mid-page. They cannot have
    children; a longer prompt through the same region inserts a NEW
    (longer) sibling node with its own page, and the shorter one ages out
    via LRU. Matching picks the longest usable entry either way.

Payloads carry family-specific substance: for the LSTM family each node
stores the recurrent state snapshot AFTER its last token, which is what
makes a prefix hit a true prefill-compute skip (``lstm_forward`` resumes
from the snapshot bit-exactly — a restarted loop is the same op sequence).
A payload is a tensor nothing writes later: the port's stream caches are
updated in place, so ``PagedDecodeStream`` inserts clones and resumes
from copies.
Attention families leave payloads ``None``; their substance is the page's
physical KV rows in the pool store.

``match`` returns both granularities a caller might use: ``n_tokens``
(token-granular coverage, including a partial hit INSIDE a node — usable
by attention families, whose pages hold per-token rows) and ``n_full``
(coverage through fully-matched nodes only — the LSTM boundary, since a
state snapshot exists only at node ends).

The cache holds one pool reference per node; ``reclaim`` (wired as the
pool's allocation-pressure hook) evicts LRU leaves whose page has no other
holder, cascading upward as parents become leaves.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

MAX_PARTIALS = 8      # per-node cap on partial-tail variants (LRU-pruned)


class _Node:
    __slots__ = ("tokens", "page", "payload", "children", "partials",
                 "parent", "stamp")

    def __init__(self, tokens: tuple, page: int, payload=None, parent=None):
        self.tokens = tokens
        self.page = page
        self.payload = payload
        self.children: Dict[tuple, "_Node"] = {}
        self.partials: List["_Node"] = []
        self.parent = parent
        self.stamp = 0

    @property
    def is_leaf(self) -> bool:
        return not self.children and not self.partials


def _common_prefix(a: Sequence[int], b: Sequence[int]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


@dataclass
class PrefixMatch:
    """Longest cached coverage of one prompt.

    ``chain``: fully-matched nodes root→deep, ``[(page, n_tokens)]`` —
    every entry but possibly the last has ``n == page_size``. ``tail``:
    a partial hit inside one more node (attention families only).
    ``payload`` is the deepest fully-matched node's payload (the LSTM
    resume state at ``n_full``)."""
    n_tokens: int = 0
    n_full: int = 0
    chain: List[Tuple[int, int]] = field(default_factory=list)
    tail: Optional[Tuple[int, int]] = None
    payload: Any = None


class RadixCache:
    def __init__(self, pool):
        self.pool = pool
        self.page_size = pool.page_size
        self.root = _Node((), -1)
        self._clock = 0
        self.nodes = 0
        self.evictions = 0
        # token-weighted hit accounting, recorded by the stream AFTER it
        # knows how many matched tokens its family can actually use
        self.lookups = 0
        self.lookup_hits = 0
        self.tokens_hit = 0
        self.tokens_total = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # -- lookup ---------------------------------------------------------------
    def match(self, tokens: Sequence[int], peek: bool = False) -> PrefixMatch:
        """Longest cached prefix of ``tokens``. ``peek=True`` (admission
        cost estimates) leaves LRU stamps and stats untouched."""
        toks = tuple(int(t) for t in tokens)
        P = self.page_size
        m = PrefixMatch()
        node = self.root
        while m.n_tokens < len(toks):
            rest = toks[m.n_tokens:]
            child = node.children.get(rest[:P]) if len(rest) >= P else None
            if child is not None:                   # full-node fast path
                m.chain.append((child.page, P))
                m.n_tokens += P
                m.n_full = m.n_tokens
                m.payload = child.payload
                if not peek:
                    child.stamp = self._tick()
                node = child
                continue
            # longest partial coverage: a tail node, or the head of a full
            # node the prompt diverges inside (per-token KV rows still help
            # attention families)
            best, best_n = None, 0
            for cand in list(node.children.values()) + node.partials:
                n = _common_prefix(cand.tokens, rest)
                if n > best_n:
                    best, best_n = cand, n
            if best is not None:
                if best_n == len(best.tokens):      # whole (partial) node
                    m.chain.append((best.page, best_n))
                    m.n_tokens += best_n
                    m.n_full = m.n_tokens
                    m.payload = best.payload
                else:
                    m.tail = (best.page, best_n)
                    m.n_tokens += best_n
                if not peek:
                    best.stamp = self._tick()
            break
        return m

    def record(self, tokens_used: int, tokens_total: int) -> None:
        """One join's hit accounting — ``tokens_used`` is what the stream's
        family actually reused: ``n_full`` for LSTM (prefill compute
        skipped), full shared pages × P for attention (storage deduped)."""
        self.lookups += 1
        self.lookup_hits += int(tokens_used > 0)
        self.tokens_hit += int(tokens_used)
        self.tokens_total += int(tokens_total)

    # -- insertion --------------------------------------------------------------
    def insert(self, tokens: Sequence[int], pages: Sequence[int],
               payloads: Optional[Sequence[Any]] = None) -> int:
        """Register a prompt's page chain. ``pages[i]`` backs grid chunk
        ``i`` (``tokens[i*P:(i+1)*P]``); ``payloads[i]`` (optional) is the
        family payload after that chunk. Existing nodes are reused (the
        caller's duplicate page is simply not pinned); each NEW node takes
        one pool reference on its page. Returns the number of new nodes."""
        toks = tuple(int(t) for t in tokens)
        P = self.page_size
        chunks = [toks[i:i + P] for i in range(0, len(toks), P)]
        if len(pages) != len(chunks):
            raise ValueError(f"{len(pages)} pages for {len(chunks)} chunks")
        node, created = self.root, 0
        for i, chunk in enumerate(chunks):
            payload = payloads[i] if payloads is not None else None
            if len(chunk) == P:
                child = node.children.get(chunk)
                if child is None:
                    child = _Node(chunk, self.pool.retain(pages[i]),
                                  payload, parent=node)
                    node.children[chunk] = child
                    self.nodes += 1
                    created += 1
                elif child.payload is None:
                    child.payload = payload
                child.stamp = self._tick()
                node = child
            else:
                existing = next((p for p in node.partials
                                 if p.tokens == chunk), None)
                if existing is not None:
                    if existing.payload is None:
                        existing.payload = payload
                    existing.stamp = self._tick()
                else:
                    tail = _Node(chunk, self.pool.retain(pages[i]),
                                 payload, parent=node)
                    tail.stamp = self._tick()
                    node.partials.append(tail)
                    self.nodes += 1
                    created += 1
                    if len(node.partials) > MAX_PARTIALS:
                        lru = min(node.partials, key=lambda p: p.stamp)
                        self._drop(lru)
        return created

    # -- eviction ---------------------------------------------------------------
    def _drop(self, node: _Node) -> None:
        parent = node.parent
        if len(node.tokens) == self.page_size:
            del parent.children[node.tokens]
        else:
            parent.partials.remove(node)
        self.pool.release(node.page)
        self.nodes -= 1
        self.evictions += 1

    def _leaves(self) -> List[_Node]:
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            for c in n.children.values():
                (out if c.is_leaf else stack).append(c)
            out.extend(n.partials)      # partial tails are always leaves
        return out

    def reclaim(self, n_pages: int) -> int:
        """Free >= ``n_pages`` pages by evicting LRU leaves whose page has
        no holder besides this cache (releasing a stream-shared page would
        not free memory, so such leaves are skipped). Cascades: a parent
        whose last child is evicted becomes a leaf candidate. Returns the
        number of pages actually freed."""
        freed = 0
        while freed < n_pages:
            cands = [lf for lf in self._leaves()
                     if self.pool.ref(lf.page) == 1]
            if not cands:
                break
            self._drop(min(cands, key=lambda lf: lf.stamp))
            freed += 1
        return freed

    def clear(self) -> int:
        """Release every cached page (shared ones stay live with their
        streams). Returns nodes dropped."""
        dropped = 0
        while True:
            leaves = self._leaves()
            if not leaves:
                break
            for lf in leaves:
                self._drop(lf)
                dropped += 1
        return dropped

    # -- telemetry ----------------------------------------------------------------
    def evictable_pages(self) -> int:
        """Pages this cache could free under pressure (sole-holder nodes —
        an estimate: a sole-holder inner node with a pinned descendant
        frees only after that descendant does)."""
        count, stack = 0, [self.root]
        while stack:
            n = stack.pop()
            for c in list(n.children.values()) + n.partials:
                if self.pool.ref(c.page) == 1:
                    count += 1
                stack.append(c)
        return count

    @property
    def hit_rate(self) -> float:
        """Token-weighted prefix hit rate over all recorded joins."""
        return self.tokens_hit / self.tokens_total if self.tokens_total \
            else 0.0

    def telemetry(self) -> dict:
        return {
            "nodes": self.nodes,
            "lookups": self.lookups,
            "lookup_hits": self.lookup_hits,
            "tokens_hit": self.tokens_hit,
            "tokens_total": self.tokens_total,
            "hit_rate": self.hit_rate,
            "evictions": self.evictions,
            "evictable_pages": self.evictable_pages(),
        }
