"""Paged KV cache: block tables over a shared page pool.

The KV lives in a shared page pool per layer::

    k_pages / v_pages : (num_layers, num_pages, page_size, n_kv, head_dim)

and each request owns an int32 *block table* row ``(pages_per_seq,)`` of
physical page indices (-1 = unassigned).  Page 0 is reserved as a garbage
page: writes from masked-out lanes are redirected there.

Two forwards:

* ``paged_prefill_chunk`` — one fixed-size chunk of prompt tokens for ONE
  request (batch=1), attending to the request's previously written pages
  plus in-chunk causality.
* ``paged_decode_step`` — one token for EVERY slot.  ``attn_impl="kernel"``
  (the default) runs the hand-written CUDA paged decode kernel on a card
  (its plain version on the CPU); ``"ref"`` gathers K/V through the block
  tables and runs the plain ``attention._attend_direct``.

With ``kv_quant="int8"`` the pages hold int8 codes and per-(page, slot,
kv-head) fp32 scales live beside them, indexed by physical page like the
pages, so every pool mechanism (COW fork, prefix cache, retention, page
transfer) carries them.  Each position is quantized once, when written.

Unlike the JAX package, whose jitted step returns a new pool, both forwards
write K/V (and scales) into the pool tensors IN PLACE (indexed assignment),
and never copy the pool.  Quantized weights (``quant.quantize_params``) are
dequantized one layer at a time inside the layer loop.  Supported
families: dense and MoE (whose MoE layers take ``moe_mode``; a chunk's
padded lanes are routed and take expert capacity, as in the reference).
"""
from __future__ import annotations

import heapq
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import torch_dtype
from repro_torch.kernels.paged_decode_attention import paged_decode_attention
from repro_torch.models import attention, module
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (_last_position_logits,
                                            _unembed, layers, mlp_residual)


class PagedKVCache(NamedTuple):
    k_pages: torch.Tensor  # (num_layers, num_pages, page_size, n_kv, head_dim)
    v_pages: torch.Tensor
    # kv_quant="int8": pages hold int8 codes, and these hold the fp32
    # per-(page, slot, kv-head) scales, (num_layers, num_pages, page_size,
    # n_kv).  None = full precision.
    k_scales: Optional[torch.Tensor] = None
    v_scales: Optional[torch.Tensor] = None

    def layer_pages(self, layer: int):
        """One layer's (k_pages, v_pages), or (k, v, k_scales, v_scales)
        when quantized — views into the pool."""
        if self.k_scales is None:
            return (self.k_pages[layer], self.v_pages[layer])
        return (self.k_pages[layer], self.v_pages[layer],
                self.k_scales[layer], self.v_scales[layer])


GARBAGE_PAGE = 0  # physical page 0 is never allocated to a request

_KV_SCALE_EPS = 1e-12  # zero-row guard for per-token absmax scales


def quantize_kv(x):
    """Symmetric int8 per-(token, kv-head) quantization of a K/V tensor.

    x: (..., n_kv, head_dim) -> (int8 codes of the same shape, fp32 scales
    (..., n_kv))."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=_KV_SCALE_EPS) / 127.0
    codes = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale


class PagePool:
    """Reference-counted host-side allocator over the physical page pool.

    Copy-on-write prefix sharing for GRPO prompt groups: the G candidates of
    one prompt alias the prompt's fully-filled pages (refcount G) and own
    only their partial tail page + decode region privately.  A page returns
    to the free list when its last reference is released, so any mix of
    finish / abort / retain / resume orderings across the group composes —
    the refcount IS the ownership protocol.

    Page 0 stays the reserved garbage target (never allocated, refcount
    pinned to 0): masked-out engine lanes keep writing there.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("pool needs >= 2 pages (page 0 is garbage)")
        self.num_pages = num_pages
        self.page_size = page_size
        self._ref = np.zeros((num_pages,), np.int32)
        self._free: List[int] = list(range(1, num_pages))
        self.peak_pages_in_use = 0

    # ------------------------------------------------------------- counters
    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - 1 - len(self._free)

    @property
    def pages_shared(self) -> int:
        """Pages aliased by >= 2 holders (COW prompt prefixes)."""
        return int((self._ref >= 2).sum())

    @property
    def pages_private(self) -> int:
        """Pages exclusively owned by one lane / retained record."""
        return int((self._ref == 1).sum())

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    # ----------------------------------------------------------- operations
    def alloc(self, n: int) -> List[int]:
        assert n <= len(self._free), "page pool exhausted"
        pages, self._free = self._free[:n], self._free[n:]
        for p in pages:
            self._ref[p] = 1
        self.peak_pages_in_use = max(self.peak_pages_in_use, self.pages_in_use)
        return pages

    def share(self, pages: List[int]) -> None:
        """Add one reference to each page (must already be allocated)."""
        for p in pages:
            assert self._ref[p] > 0, f"share of unallocated page {p}"
            self._ref[p] += 1

    def release(self, pages: List[int]) -> None:
        """Drop one reference per page; last reference frees the page."""
        for p in pages:
            assert self._ref[p] > 0, f"double release of page {p}"
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)

    def fork_prefix(self, block_pages: List[int],
                    upto_token: int) -> Tuple[List[int], Optional[int]]:
        """COW fork of a lane's prefix covering positions [0, upto_token).

        Fully-filled pages are shared in place (one new reference each); the
        partial tail page — the only page the forked lane will keep writing —
        cannot be aliased.  Returns ``(shared_pages, tail_src)`` where
        ``tail_src`` is the physical page the caller must copy into a freshly
        owned page (None when upto_token lands exactly on a page boundary).
        """
        full = upto_token // self.page_size
        shared = list(block_pages[:full])
        self.share(shared)
        tail_src = (int(block_pages[full]) if upto_token % self.page_size
                    else None)
        return shared, tail_src


class _RadixNode:
    """One fully-filled page of cached KV.  The node's *path* from the root
    spells the token prefix the page's KV was computed under — KV at position
    i depends on the whole token prefix [0, i], so content-addressing must
    key on the path, which a radix tree gives for free."""

    __slots__ = ("key", "page", "children", "parent", "last_used")

    def __init__(self, key, page: int, parent, last_used: int):
        self.key = key                       # tuple of page_size token ids
        self.page = page                     # physical page holding the KV
        self.children: Dict[tuple, "_RadixNode"] = {}
        self.parent = parent
        self.last_used = last_used


class RadixCache:
    """Automatic cross-prompt prefix cache over the refcounted ``PagePool``.

    vLLM-style automatic prefix caching at page granularity: finished (or
    aborted) requests insert their fully-filled pages into a radix tree
    keyed on token content; a new request walks the tree to find the longest
    cached page-aligned prefix and aliases those pages into its block table
    (COW through the pool refcounts) instead of re-prefilling them.  The
    cache holds exactly ONE reference per tree node — live requests stack
    their own references on top, so any mix of finish/abort/retain/resume
    composes, and a cached page is evictable precisely when its refcount
    is 1 (only the cache holds it).

    LRU eviction walks leaves first, cascading upward as children disappear.
    A node is *freeable* iff only the cache holds its page (refcount 1) AND
    its whole subtree is freeable — a refcount-1 interior node pinned by a
    live descendant (possible via mid-prefill extension, which shares only
    the continuation pages, not the path above them) can never become a
    leaf, so it must not be promised to admission control.
    ``evictable_pages`` counts exactly the set ``evict()`` can reach.
    """

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.page_size = pool.page_size
        self.root = _RadixNode(key=None, page=-1, parent=None, last_used=0)
        # Optional observer of tree mutations (duck-typed: ``on_insert(path)``
        # per new node, ``on_evict(path)`` per dropped node, ``on_clear()``
        # on flush; ``path`` = tuple of page keys root→node).  The fleet
        # router hangs its global prefix index here.  Callbacks fire on the
        # replica's own loop thread with no cache-side lock held — the
        # listener does its own synchronization.
        self.listener = None
        self._clock = 0
        self.lookups = 0          # admission-time matches
        self.hits = 0             # admission-time matches that returned pages
        self.ext_hits = 0         # mid-prefill extensions that returned pages
        self.hit_tokens = 0       # tokens skipped (admission + extension)
        self.inserted_pages = 0
        self.evicted_pages = 0
        self.flushes = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _page_key(self, tokens, i: int) -> tuple:
        ps = self.page_size
        return tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])

    # ------------------------------------------------------------- queries
    def _walk(self, tokens) -> List[_RadixNode]:
        """Longest cached path covering full pages of ``tokens`` (no side
        effects beyond nothing; callers bump LRU stamps)."""
        node, path = self.root, []
        for i in range(len(tokens) // self.page_size):
            child = node.children.get(self._page_key(tokens, i))
            if child is None:
                break
            path.append(child)
            node = child
        return path

    def peek(self, tokens) -> int:
        """Number of cached full pages matching ``tokens`` (no refcounts)."""
        return len(self._walk(tokens))

    def match(self, tokens, from_page: int = 0, *,
              extend: bool = False) -> List[int]:
        """Pages ``[from_page, k)`` of the longest cached page-aligned
        prefix of ``tokens`` (k = matched full pages).

        Shares each returned page (the caller owns one new reference per
        page — releasing them composes through the pool) and bumps the whole
        matched path's LRU stamps.  ``from_page`` supports mid-prefill
        extension: a request that already wrote pages [0, from_page) asks
        only for the cached continuation.  Extension probes run once per
        prefill chunk and mostly return nothing — with ``extend=True`` they
        skip the lookup/hit counters (``ext_hits`` records the productive
        ones) so hit-rate stats keep meaning one-admission-one-lookup."""
        if not extend:
            self.lookups += 1
        path = self._walk(tokens)
        stamp = self._tick()
        for n in path:
            n.last_used = stamp
        pages = [n.page for n in path[from_page:]]
        if pages:
            if extend:
                self.ext_hits += 1
            else:
                self.hits += 1
            self.hit_tokens += len(pages) * self.page_size
            self.pool.share(pages)
        return pages

    # ----------------------------------------------------------- mutation
    def insert(self, tokens, pages: List[int]) -> int:
        """Insert ``pages[i]`` (KV of ``tokens[i*ps:(i+1)*ps]`` computed
        under the preceding prefix) for every fully-filled page.

        The cache takes its OWN reference on each newly inserted page (the
        caller keeps and later releases its reference as usual).  Pages whose
        content is already cached are skipped — the caller's duplicate copy
        is freed whenever the caller releases it.  Returns #new nodes."""
        node = self.root
        stamp = self._tick()
        new = 0
        path: List[tuple] = []
        for i, page in enumerate(pages):
            key = self._page_key(tokens, i)
            path.append(key)
            child = node.children.get(key)
            if child is None:
                child = _RadixNode(key=key, page=int(page), parent=node,
                                   last_used=stamp)
                node.children[key] = child
                self.pool.share([int(page)])
                self.inserted_pages += 1
                new += 1
                if self.listener is not None:
                    self.listener.on_insert(tuple(path))
            else:
                child.last_used = stamp
            node = child
        return new

    def evict(self, want_pages: int) -> int:
        """Free up to ``want_pages`` pages by dropping LRU leaves whose page
        only the cache still holds, cascading upward as parents become
        childless.  One tree walk + a heap — not one walk per page freed.
        Returns the number actually freed."""
        heap: List[Tuple[int, int, _RadixNode]] = []
        tie = 0
        stack = [self.root]
        while stack:
            n = stack.pop()
            for c in n.children.values():
                if c.children:
                    stack.append(c)
                elif self.pool.refcount(c.page) == 1:
                    heap.append((c.last_used, tie, c))
                    tie += 1
        heapq.heapify(heap)
        freed = 0
        while freed < want_pages and heap:
            _, _, leaf = heapq.heappop(heap)
            parent = leaf.parent
            if self.listener is not None:
                self.listener.on_evict(self._node_path(leaf))
            del parent.children[leaf.key]
            self.pool.release([leaf.page])
            self.evicted_pages += 1
            freed += 1
            if (parent is not self.root and not parent.children
                    and self.pool.refcount(parent.page) == 1):
                heapq.heappush(heap, (parent.last_used, tie, parent))
                tie += 1
        return freed

    def clear(self) -> None:
        """Drop every cache hold (e.g. on a weight update: all cached KV was
        computed under the old policy).  Pages still aliased by running
        requests stay allocated until their holders release them."""
        stack = [self.root]
        while stack:
            n = stack.pop()
            for c in n.children.values():
                stack.append(c)
                self.pool.release([c.page])
        self.root.children = {}
        self.flushes += 1
        if self.listener is not None:
            self.listener.on_clear()

    # ---------------------------------------------------------- enumeration
    @staticmethod
    def _node_path(node: _RadixNode) -> tuple:
        """Tuple of page keys root→``node`` (the node's content address)."""
        keys = []
        while node is not None and node.parent is not None:
            keys.append(node.key)
            node = node.parent
        return tuple(reversed(keys))

    def paths(self) -> List[tuple]:
        """Every node's root path — the cache's full content listing, used
        by ``fleet_audit`` to cross-check the router's global index."""
        out: List[tuple] = []
        stack: List[Tuple[_RadixNode, tuple]] = [(self.root, ())]
        while stack:
            n, prefix = stack.pop()
            for c in n.children.values():
                p = prefix + (c.key,)
                out.append(p)
                stack.append((c, p))
        return out

    # ------------------------------------------------------------ counters
    @property
    def num_nodes(self) -> int:
        count, stack = 0, [self.root]
        while stack:
            n = stack.pop()
            count += len(n.children)
            stack.extend(n.children.values())
        return count

    @property
    def evictable_pages(self) -> int:
        """Pages freeable by (cascading) leaf-first eviction: nodes whose
        page only the cache holds AND whose entire subtree is likewise
        cache-only (a pinned descendant keeps an ancestor from ever
        becoming a leaf).  Exactly what ``evict()`` can deliver — admission
        control must not be promised more, or ``pool.alloc`` would assert
        instead of queueing the request."""
        count = 0

        def freeable(n: _RadixNode) -> bool:
            nonlocal count
            ok = all([freeable(c) for c in n.children.values()])
            if n is self.root:
                return ok
            ok = ok and self.pool.refcount(n.page) == 1
            if ok:
                count += 1
            return ok

        freeable(self.root)
        return count

    def held_pages(self) -> List[int]:
        """Every physical page the cache holds a reference on (audit)."""
        pages, stack = [], [self.root]
        while stack:
            n = stack.pop()
            for c in n.children.values():
                stack.append(c)
                pages.append(c.page)
        return pages


def supports_paged(cfg: ModelConfig) -> bool:
    """The dense and MoE families (the reference's ``paged.py:436``): the
    VLM's and the enc-dec's caches are slot caches only."""
    return cfg.family in ("dense", "moe")


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     kv_quant: str = "off", *, device) -> PagedKVCache:
    if not supports_paged(cfg):
        raise ValueError(f"paged KV cache requires an attention family, got {cfg.family}")
    hd = cfg.resolved_head_dim
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads, hd)
    if kv_quant == "off":
        dt = torch_dtype(cfg.dtype)
        return PagedKVCache(k_pages=torch.zeros(shape, dtype=dt, device=device),
                            v_pages=torch.zeros(shape, dtype=dt, device=device))
    if kv_quant != "int8":
        raise ValueError(f"unknown kv_quant {kv_quant!r} (expected off | int8)")

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    return PagedKVCache(k_pages=zeros(shape, torch.int8),
                        v_pages=zeros(shape, torch.int8),
                        k_scales=zeros(shape[:-1], torch.float32),
                        v_scales=zeros(shape[:-1], torch.float32))


def pages_per_seq(max_total_len: int, page_size: int) -> int:
    return -(-max_total_len // page_size)


# ---------------------------------------------------------------------------
# per-request dense view (debug / tests / reference attention)
# ---------------------------------------------------------------------------

def gather_request_view(layer_pages, block_row):
    """Dense (S_view, n_kv, hd) K/V view of one request's table row, plus
    its (S_view,) validity.  ``layer_pages`` is one layer's
    ``(k_pages, v_pages)`` — or the 4-tuple with scales under
    ``kv_quant="int8"``, in which case the view is dequantized to fp32.
    ``S_view = pages_per_seq * page_size``.  Positions beyond the request's
    written length hold stale pool contents — callers must mask by length."""
    k_pages, v_pages = layer_pages[0], layer_pages[1]
    page_size, nkv, hd = k_pages.shape[1], k_pages.shape[2], k_pages.shape[3]
    idx = torch.clamp(block_row.long(), min=0)
    k = k_pages[idx].reshape(-1, nkv, hd)
    v = v_pages[idx].reshape(-1, nkv, hd)
    if len(layer_pages) > 2:
        k = k.float() * layer_pages[2][idx].reshape(-1, nkv)[..., None]
        v = v.float() * layer_pages[3][idx].reshape(-1, nkv)[..., None]
    valid = torch.repeat_interleave(block_row >= 0, page_size)
    return k, v, valid


class PageTransfer(NamedTuple):
    """Host-side buffer of extracted physical pages — the unit of
    cross-replica KV movement.  CPU tensors in the pool's dtype (int8 codes
    under ``kv_quant="int8"``, with their fp32 scales: a page without its
    scales dequantizes to garbage), shaped like the pool with the page axis
    narrowed to the extracted set::

        k / v           : (num_layers, n, page_size, n_kv, head_dim)
        k/v_scales      : (num_layers, n, page_size, n_kv)   (int8 only)
    """

    k: torch.Tensor
    v: torch.Tensor
    k_scales: Optional[torch.Tensor] = None
    v_scales: Optional[torch.Tensor] = None

    @property
    def num_pages(self) -> int:
        return int(self.k.shape[1])

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self
                   if t is not None)


def _page_index(pages, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(pages, np.int64), device=device)


def export_pages(cache: PagedKVCache, pages) -> PageTransfer:
    """Extract physical pages into one host-side ``PageTransfer``: one
    batched gather of K and V together and a single device-to-host copy —
    never a per-page dispatch."""
    idx = _page_index(pages, cache.k_pages.device)
    kv = torch.stack([cache.k_pages[:, idx], cache.v_pages[:, idx]]).cpu()
    if cache.k_scales is None:
        return PageTransfer(k=kv[0], v=kv[1])
    sc = torch.stack([cache.k_scales[:, idx], cache.v_scales[:, idx]]).cpu()
    return PageTransfer(k=kv[0], v=kv[1], k_scales=sc[0], v_scales=sc[1])


def import_pages(cache: PagedKVCache, dst_pages,
                 transfer: PageTransfer) -> PagedKVCache:
    """Re-admit an exported buffer into this pool's ``dst_pages`` (one
    batched scatter per tensor, in place), scales included.
    ``len(dst_pages)`` must equal ``transfer.num_pages``; the source and
    destination pools must agree on quantization mode."""
    dst = _page_index(dst_pages, cache.k_pages.device)
    if dst.shape[0] != transfer.num_pages:
        raise ValueError(
            f"import of {transfer.num_pages} pages into {dst.shape[0]} slots")
    if (cache.k_scales is None) != (transfer.k_scales is None):
        raise ValueError("kv_quant mismatch between transfer and pool")
    for pool, src in zip(cache, transfer):
        if pool is not None:
            pool[:, dst] = src.to(pool.device, pool.dtype)
    return cache


def copy_pages(cache: PagedKVCache, src, dst) -> PagedKVCache:
    """Copy whole physical pages ``src[i] -> dst[i]`` across every layer,
    in place: the device half of a COW fork (the group's partial prompt-tail
    page duplicated into each forked lane's own page)."""
    device = cache.k_pages.device
    src, dst = _page_index(src, device), _page_index(dst, device)
    for pool in cache:
        if pool is not None:
            pool[:, dst] = pool[:, src]
    return cache


def _write_kv(layer_pages, phys, off, k, v) -> None:
    """Write K/V rows into the pool in place — quantized once per written
    position when the pool holds int8 codes.  Masked lanes all target the
    garbage page 0; indexed assignment with duplicate indices leaves the
    stored value (codes and scales alike) undefined, which is harmless only
    because page 0 is never read unmasked."""
    k_pages, v_pages = layer_pages[0], layer_pages[1]
    if len(layer_pages) > 2:
        # K and V quantized together: one pass of launches instead of two
        codes, scales = quantize_kv(torch.stack([k, v]))
        k_pages[phys, off] = codes[0]
        v_pages[phys, off] = codes[1]
        layer_pages[2][phys, off] = scales[0]
        layer_pages[3][phys, off] = scales[1]
        return
    k_pages[phys, off] = k.to(k_pages.dtype)
    v_pages[phys, off] = v.to(v_pages.dtype)


# ---------------------------------------------------------------------------
# chunked prefill (batch=1, one chunk of one request)
# ---------------------------------------------------------------------------

def _paged_attn_prefill(p, cfg: ModelConfig, x, positions, valid, layer_pages,
                        block_row):
    """x: (1, C, D); positions/valid: (1, C); block_row: (P,).

    Writes the chunk's K/V into the request's pages (invalid lanes land in
    the garbage page) and attends causally over the request's whole table
    — earlier chunks included."""
    q = attention._project_q(p, cfg, x, positions)
    k, v = attention._project_kv(p, cfg, x, positions)
    page_size = layer_pages[0].shape[1]
    logical = torch.clamp(positions[0] // page_size, 0, block_row.shape[0] - 1)
    phys = torch.where(valid[0], block_row[logical.long()], GARBAGE_PAGE)
    phys = torch.clamp(phys, min=GARBAGE_PAGE).long()    # -1 -> garbage
    _write_kv(layer_pages, phys, (positions[0] % page_size).long(), k[0], v[0])

    # in-chunk queries read their own K/V back through the (possibly
    # quantized) pool — prefill attends to exactly what decode will see.
    kd, vd, page_valid = gather_request_view(layer_pages, block_row)
    kv_pos = torch.arange(kd.shape[0], dtype=torch.int32, device=x.device)[None, :]
    # causality (kv_pos <= q_pos) masks every not-yet-written position;
    # invalid query lanes get q_pos = -1 (fully masked).
    q_pos = torch.where(valid, positions, -1)
    out = attention.attend(q, kd[None], vd[None], q_pos, kv_pos,
                           page_valid[None], window=cfg.sliding_window,
                           softcap=cfg.attn_logit_softcap)
    # the dequantized fp32 view promotes the attention output: cast back to
    # the residual dtype (identity when unquantized)
    return out.reshape(1, x.shape[1], cfg.q_dim).to(x.dtype) @ p["wo"]


def paged_prefill_chunk(params, cfg: ModelConfig, tokens, valid, start: int,
                        block_row, cache: PagedKVCache, *, moe_mode: str = "ep"):
    """One prefill chunk of one request.

    tokens/valid: (1, C); start: the chunk's first position; block_row:
    (pages_per_seq,) int32.  Writes the pool in place and returns
    (last-valid-position logits (1, V) fp32, cache)."""
    x = params["embed"][tokens]
    positions = start + torch.arange(tokens.shape[1], dtype=torch.int32,
                                     device=x.device)[None, :]
    for layer, lp in layers(params):
        y = _paged_attn_prefill(lp["attn"], cfg,
                                module.rmsnorm(lp["ln1"], x, cfg.norm_eps),
                                positions, valid, cache.layer_pages(layer),
                                block_row)
        x, _ = mlp_residual(lp, cfg, x, y, moe_mode)
    return _last_position_logits(params, cfg, x, valid), cache


# ---------------------------------------------------------------------------
# decode (one token for every slot, through the block tables)
# ---------------------------------------------------------------------------

def _paged_attn_decode(p, cfg: ModelConfig, x, pos, layer_pages, block_tables,
                       *, attn_impl: str):
    """x: (B, 1, D); pos: (B,); block_tables: (B, P) (-1 rows = masked slot)."""
    b = x.shape[0]
    positions = pos[:, None]
    q = attention._project_q(p, cfg, x, positions)           # (B,1,KV,G,hd)
    k_new, v_new = attention._project_kv(p, cfg, x, positions)
    k_pages, v_pages = layer_pages[0], layer_pages[1]
    k_scales, v_scales = (layer_pages[2:] if len(layer_pages) > 2
                          else (None, None))
    page_size = k_pages.shape[1]

    logical = torch.clamp(pos // page_size, 0, block_tables.shape[1] - 1)
    phys = torch.gather(block_tables, 1, logical[:, None].long())[:, 0]
    phys = torch.clamp(phys, min=GARBAGE_PAGE).long()    # masked -> garbage
    _write_kv(layer_pages, phys, (pos % page_size).long(), k_new[:, 0],
              v_new[:, 0])

    if attn_impl == "kernel":
        out = paged_decode_attention(
            q.reshape(b, cfg.num_heads, cfg.resolved_head_dim), k_pages,
            v_pages, block_tables, pos + 1, k_scales=k_scales,
            v_scales=v_scales, softcap=cfg.attn_logit_softcap)
    elif attn_impl == "ref":
        nkv, hd = k_pages.shape[2], k_pages.shape[3]
        idx = torch.clamp(block_tables.long(), min=0)
        kd = k_pages[idx].reshape(b, -1, nkv, hd)
        vd = v_pages[idx].reshape(b, -1, nkv, hd)
        if k_scales is not None:
            kd = kd.float() * k_scales[idx].reshape(b, -1, nkv)[..., None]
            vd = vd.float() * v_scales[idx].reshape(b, -1, nkv)[..., None]
        kv_pos = torch.arange(kd.shape[1], dtype=torch.int32,
                              device=x.device)[None, :].expand(b, -1)
        kv_valid = torch.repeat_interleave(block_tables >= 0, page_size, dim=1)
        out = attention._attend_direct(q, kd, vd, positions, kv_pos, kv_valid,
                                       window=cfg.sliding_window,
                                       softcap=cfg.attn_logit_softcap)
    else:
        raise ValueError(f"unknown attn_impl {attn_impl!r} (expected kernel | ref)")
    # cast back to the residual dtype (identity when unquantized)
    return out.reshape(b, 1, cfg.q_dim).to(x.dtype) @ p["wo"]


def paged_decode_step(params, cfg: ModelConfig, token, pos,
                      cache: PagedKVCache, block_tables, *,
                      attn_impl: str = "kernel", moe_mode: str = "ep"):
    """One-token decode for every slot. token/pos: (B,) int32;
    block_tables: (B, P) int32 (pass -1 rows for slots that must not step).
    Writes the pool in place and returns (logits (B, V) fp32, cache)."""
    x = params["embed"][token][:, None, :]
    for layer, lp in layers(params):
        y = _paged_attn_decode(lp["attn"], cfg,
                               module.rmsnorm(lp["ln1"], x, cfg.norm_eps),
                               pos, cache.layer_pages(layer), block_tables,
                               attn_impl=attn_impl)
        x, _ = mlp_residual(lp, cfg, x, y, moe_mode)
    return _unembed(params, cfg, x)[:, 0, :], cache
