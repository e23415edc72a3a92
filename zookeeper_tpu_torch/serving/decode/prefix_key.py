"""Page-chunk prefix keying, shared by the radix prefix cache and the
router's prefix index.

The port of ``zookeeper_tpu/serving/decode/prefix_key.py``, pure Python.
:class:`~zookeeper_tpu_torch.serving.decode.pages.RadixPrefixCache` keys
its trie on full ``page_size`` token chunks (one node = one page) with a
longest-common-prefix partial tail. A fleet router must predict that
trie's match length without holding any pages, so both sides walk it
with the same code:

- :func:`common_prefix` / :func:`walk_match` / :func:`walk_insert`: the
  chunking and the match and insert walks, used by the cache's
  ``lookup``/``insert`` and by :class:`PrefixIndex`;
- :class:`PrefixIndex`: the pageless mirror of the trie, one per replica:
  ``observe()`` every prompt routed there, ``match()`` a candidate to
  predict how many tokens that replica's cache would serve warm.

Any node with ``.chunk`` (a token tuple) and ``.children`` (a
``{chunk: node}`` dict) rides the walks.
"""

from typing import Any, Callable, List, Sequence, Tuple

__all__ = ["PrefixIndex", "common_prefix", "walk_insert", "walk_match"]


def common_prefix(a: Sequence[int], b: Sequence[int]) -> int:
    """Length of the longest common prefix of two token sequences."""
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


def walk_match(root: Any, tokens: Sequence[int], page_size: int):
    """The match walk: exact full-chunk descents from ``root``, then the
    longest common prefix against any child's chunk for the partial
    tail. Returns ``(t, visited)``: the first ``t`` tokens are covered by
    the ``visited`` nodes in walk order (the last may cover its part of
    ``t`` only partially: the cache's copy-on-write case)."""
    ps = int(page_size)
    node = root
    visited: List[Any] = []
    t = 0
    n = len(tokens)
    while t + ps <= n:
        child = node.children.get(tuple(tokens[t:t + ps]))
        if child is None:
            break
        visited.append(child)
        t += ps
        node = child
    rest = tokens[t:]
    if rest:
        best, bestq = None, 0
        for child in node.children.values():
            q = common_prefix(child.chunk, rest)
            if q > bestq:
                best, bestq = child, q
        if best is not None:
            visited.append(best)
            t += bestq
    return t, visited


def walk_insert(
    root: Any,
    tokens: Sequence[int],
    page_size: int,
    make_node: Callable[[Tuple[int, ...], int, Any], Any],
    *,
    tail: bool = True,
):
    """The insert walk: descend or create one node per full chunk
    (``make_node(chunk, chunk_index, parent)`` builds a missing one), plus
    the partial tail chunk when ``tail`` is set (the cache skips it when
    no page covers those positions). Returns ``[(node, created), ...]`` in
    walk order."""
    ps = int(page_size)
    tokens = [int(x) for x in tokens]
    node = root
    out: List[Tuple[Any, bool]] = []
    n_full = len(tokens) // ps
    for i in range(n_full):
        chunk = tuple(tokens[i * ps:(i + 1) * ps])
        child = node.children.get(chunk)
        created = child is None
        if created:
            child = make_node(chunk, i, node)
            node.children[chunk] = child
        out.append((child, created))
        node = child
    rest = tuple(tokens[n_full * ps:])
    if rest and tail:
        child = node.children.get(rest)
        created = child is None
        if created:
            child = make_node(rest, n_full, node)
            node.children[rest] = child
        out.append((child, created))
    return out


class _IndexNode:
    __slots__ = ("chunk", "children")

    def __init__(self, chunk: Tuple[int, ...]) -> None:
        self.chunk = chunk
        self.children = {}


class PrefixIndex:
    """Pageless mirror of the radix prefix-cache trie.

    ``observe()`` records a prompt routed to the replica (the replica's
    cache inserts exactly that prompt's pages after prefill); ``match()``
    walks the same chunking the cache does. Predictions are optimistic:
    the real cache evicts under pool pressure and is invalidated by a
    weight swap, which only costs a colder route than predicted. Past
    ``max_nodes`` the index empties (counted in ``resets``) and rewarms
    from later traffic."""

    def __init__(self, page_size: int, max_nodes: int = 65536) -> None:
        if page_size < 1:
            raise ValueError(f"page_size={page_size} must be >= 1.")
        if max_nodes < 1:
            raise ValueError(f"max_nodes={max_nodes} must be >= 1.")
        self.page_size = int(page_size)
        self.max_nodes = int(max_nodes)
        self._root = _IndexNode(())
        self.nodes = 0
        self.resets = 0

    def observe(self, tokens: Sequence[int]) -> int:
        """Record a routed prompt (full chunks and the partial tail).
        Returns the nodes created."""
        created = sum(
            1 for _, was_created in walk_insert(
                self._root, tokens, self.page_size,
                lambda chunk, i, parent: _IndexNode(chunk))
            if was_created
        )
        self.nodes += created
        if self.nodes > self.max_nodes:
            self.clear()
            self.resets += 1
        return created

    def match(self, tokens: Sequence[int]) -> int:
        """Predicted warm match length: the ``t`` the replica's
        ``RadixPrefixCache.lookup`` would return."""
        t, _ = walk_match(self._root, [int(x) for x in tokens], self.page_size)
        return t

    def predict(self, tokens: Sequence[int]) -> int:
        """Predicted shared tokens at admission: the match capped at
        ``len(tokens) - 1``, as ``PagePool.assign_prompt`` caps it."""
        n = len(tokens)
        if n == 0:
            return 0
        return min(self.match(tokens), n - 1)

    def clear(self) -> None:
        self._root = _IndexNode(())
        self.nodes = 0
