"""Paged-KV continuous-batching engine: chunked prefill, abort→resume,
copy-on-write prefix sharing for GRPO prompt groups, and a radix prefix
cache — the port of the JAX package's ``rollout/paged_engine.py``.  It
serves the families with paged KV views (dense and MoE; an MoE layer
routes each prefill chunk, padded lanes included, as one dispatch group,
and each decode token as its own).

Observable behaviour (admission, page accounting, counters, the tokens a
greedy run decodes) is the JAX engine's.  What differs is how a step runs:

* The JAX engine's single jitted step (prefill chunk and decode fused,
  ``lax.cond``-gated) is an eager Python step here: the prefill chunk if
  any, decode for every unmasked slot if any, then one sampler call each.
* ``block_tables``, ``cur_token`` and ``pos`` live on the host as numpy
  mirrors.  Per-request updates touch only those; ``step()`` uploads every
  per-step input in ONE host→device copy and reads the sampled tokens back
  in ONE device→host copy.  Nothing else synchronises per request.
* The pool is written in place by the model (no functional update, no
  donation, no copy of the pool per step).
* Sampling draws from a ``torch.Generator`` seeded with ``seed``; tokens
  under temperature > 0 differ from ``jax.random``'s.
* Quantize-on-sync (``quant_mode`` int8 / fp8): the engine holds the codes
  and the paged forwards dequantize one layer at a time inside their layer
  loop (the JAX step dequantizes the whole tree at trace time and lets XLA
  fuse the multiply into each matmul).  ``kv_quant="int8"`` keeps int8
  pages with fp32 scales, read by the int8 variant of the decode kernel.

Implements ``repro_torch.core.llm_proxy.InferenceEngine`` plus the
retain/resume and group-submit extensions.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.types import GenerationResult
from repro_torch.device import resolve_device
from repro_torch.models import paged
from repro_torch.models.api import ModelAPI
from repro_torch.quant import core as quant
from repro_torch.rollout.sampler import sample_tokens

_PREFILL = "prefill"
_DECODE = "decode"
_FORKWAIT = "forkwait"   # group follower parked until the leader's prefill


@dataclasses.dataclass
class _SlotState:
    request_id: int
    prompt: np.ndarray
    tokens: List[int]
    logprobs: List[float]
    remaining: int
    phase: str = _PREFILL
    prefill_done: int = 0
    carried_last: Optional[int] = None   # last sampled token of a resumed prefix
    followers: List[int] = dataclasses.field(default_factory=list)
    group_leader: Optional[int] = None   # follower pre-fork: leader's slot
    # token content backing the slot's written KV region: positions
    # [0, len(content_prefix)) hold content_prefix, sampled tokens append
    # after it.  Equals ``prompt`` except for resumed-decode slots, whose
    # written region already includes previously decoded tokens.
    content_prefix: Optional[np.ndarray] = None
    # weight epoch the slot's KV was (first) computed under: pages are only
    # published to the prefix cache while this matches the engine's current
    # epoch.
    epoch: int = 0


@dataclasses.dataclass
class _Retained:
    """A parked request: pages stay allocated (refs held), state frozen."""
    pages: List[int]
    phase: str
    prompt: np.ndarray
    prefill_done: int
    length: int                          # KV positions written (pos value)
    last_token: int
    # full token content of the written region (plus the pending last token
    # for decode-phase records): lets the prefix cache index these pages
    # if the record is released instead of resumed.
    content: Optional[np.ndarray] = None
    epoch: int = 0                       # weight epoch the KV was computed under


def _check_mode(kind: str, mode: str, known) -> None:
    if mode not in known:
        raise ValueError(f"unknown {kind} {mode!r} (expected {' | '.join(known)})")


class PagedDecodeEngine:
    """Continuous-batching engine over a refcounted paged KV pool.

    ``attn_impl``: "kernel" (the hand-written CUDA paged decode kernel on a
    card, its plain version on the CPU) or "ref" (gather through the block
    tables + plain attention).  ``device``: the card unless the caller
    passes another; it must be the device of ``api``.
    """

    supports_retain = True
    supports_group = True

    def __init__(self, api: ModelAPI, params, *, num_slots: int = 8,
                 max_total_len: int = 128, page_size: int = 16,
                 prefill_chunk: int = 16, num_pages: Optional[int] = None,
                 eos_id: int = 2, temperature: float = 1.0, top_k: int = 0,
                 pad_id: int = 0, seed: int = 0, attn_impl: str = "kernel",
                 prefix_cache: bool = False, quant_mode: str = "off",
                 kv_quant: str = "off", device=None):
        cfg = api.cfg
        if api.init_paged_cache is None:
            raise ValueError(f"family {cfg.family} has no paged-KV support "
                             "(use the slot DecodeEngine)")
        self.device = resolve_device(device)
        if api.device != self.device:
            raise ValueError(f"engine device {self.device} differs from the "
                             f"model API's {api.device}")
        if cfg.sliding_window is not None and cfg.sliding_window < max_total_len:
            raise ValueError("engine requires cache >= max_total_len "
                             "(enlarge window or shorten sequences)")
        _check_mode("quant_mode", quant_mode, quant.MODES)
        _check_mode("kv_quant", kv_quant, quant.KV_MODES)
        if attn_impl not in ("kernel", "ref"):
            raise ValueError(f"unknown attn_impl {attn_impl!r} (expected kernel | ref)")
        self.api = api
        # quantize-on-sync: the trainer's tree is quantized HERE, at
        # construction and on every update_weights
        self.quant_mode = quant_mode
        self.kv_quant = kv_quant
        self.params = self._checked(quant.quantize_params(params, quant_mode))
        self.total_weight_syncs_quantized = 0
        self.num_slots = num_slots
        self.max_total_len = max_total_len
        self.page_size = page_size
        self.prefill_chunk = prefill_chunk
        self.pages_per_seq = paged.pages_per_seq(max_total_len, page_size)
        if num_pages is None:
            num_pages = 1 + num_slots * self.pages_per_seq  # +1: garbage page
        self.num_pages = num_pages
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.temperature = temperature
        self.top_k = top_k
        self.attn_impl = attn_impl
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

        self.cache = api.init_paged_cache(num_pages, page_size,
                                          kv_quant=kv_quant)
        # host mirrors; step() uploads them once per step
        self.block_tables = np.full((num_slots, self.pages_per_seq), -1,
                                    np.int32)
        self.cur_token = np.full((num_slots,), pad_id, np.int32)
        self.pos = np.zeros((num_slots,), np.int32)
        self.pool = paged.PagePool(num_pages, page_size)
        # automatic cross-prompt prefix caching (radix tree over page
        # contents); None = disabled, every page frees on release.
        self.prefix_cache: Optional[paged.RadixCache] = \
            paged.RadixCache(self.pool) if prefix_cache else None
        self._weight_epoch = 0
        self._slot_pages: Dict[int, List[int]] = {}
        self.slots: Dict[int, _SlotState] = {}
        self.req_to_slot: Dict[int, int] = {}
        self.retained: Dict[int, _Retained] = {}
        self._rr = 0

        self.total_decode_steps = 0
        self.total_tokens_decoded = 0
        self.total_prefill_chunks = 0
        self.total_prefill_tokens = 0
        self.total_groups_forked = 0
        # batched-dispatch accounting: fork tail copies and cross-replica
        # transfers each issue ONE gather/scatter device call per request.
        self.total_copy_ops = 0          # batched fork-tail device copies
        self.total_pages_copied = 0      # pages moved by those copies
        self.pages_transferred_in = 0    # cross-replica pages imported
        self.pages_transferred_out = 0   # cross-replica pages exported
        self.transfer_bytes_in = 0
        self.transfer_bytes_out = 0
        self.transfer_device_ops = 0     # batched export/import dispatches

    def _checked(self, params):
        # embed is never quantized: its device is the tree's
        if params["embed"].device != self.device:
            raise ValueError(f"params on {params['embed'].device}, engine on "
                             f"{self.device}")
        return params

    # ------------------------------------------------------------ protocol
    @property
    def num_free_slots(self) -> int:
        return self.num_slots - len(self.slots)

    @property
    def num_free_pages(self) -> int:
        return self.pool.pages_free

    @property
    def pages_free(self) -> int:
        return self.pool.pages_free

    @property
    def pages_shared(self) -> int:
        return self.pool.pages_shared

    @property
    def pages_private(self) -> int:
        return self.pool.pages_private

    @property
    def peak_pages_in_use(self) -> int:
        return self.pool.peak_pages_in_use

    @property
    def active_request_ids(self) -> List[int]:
        return list(self.req_to_slot)

    # ------------------------------------------------- prefix-cache counters
    @property
    def cache_lookups(self) -> int:
        return self.prefix_cache.lookups if self.prefix_cache else 0

    @property
    def cache_hits(self) -> int:
        return self.prefix_cache.hits if self.prefix_cache else 0

    @property
    def cache_ext_hits(self) -> int:
        """Productive mid-prefill extensions (concurrent-preamble pickups)."""
        return self.prefix_cache.ext_hits if self.prefix_cache else 0

    @property
    def cache_hit_tokens(self) -> int:
        """Prefill tokens skipped by aliasing cached prefix pages."""
        return self.prefix_cache.hit_tokens if self.prefix_cache else 0

    @property
    def cache_evicted_pages(self) -> int:
        return self.prefix_cache.evicted_pages if self.prefix_cache else 0

    @property
    def cache_pages_held(self) -> int:
        return len(self.prefix_cache.held_pages()) if self.prefix_cache else 0

    def set_quant_mode(self, mode: str) -> None:
        """Change the weight-quantization mode mid-run.  Takes effect at the
        NEXT ``update_weights``: the current tree is already (lossily)
        quantized, and the next sync ships full-precision weights."""
        _check_mode("quant_mode", mode, quant.MODES)
        self.quant_mode = mode

    def update_weights(self, params) -> None:
        self.params = self._checked(quant.quantize_params(params,
                                                          self.quant_mode))
        if self.quant_mode != "off":
            self.total_weight_syncs_quantized += 1
        # bump the epoch even with the cache off: slot/retained records
        # stamped with an older epoch must never publish their (now
        # stale-policy) KV if the cache is enabled later.
        self._weight_epoch += 1
        if self.prefix_cache is not None:
            # every cached page was computed under the old policy: new
            # admissions must not alias stale KV.
            self.prefix_cache.clear()

    def _pages_needed(self, total_len: int) -> int:
        return -(-total_len // self.page_size)

    def _can_cover(self, n: int) -> bool:
        """Whether ``n`` pages can be produced right now: free pages first,
        cache-evictable holds as the fallback — the cache must never cause
        an admission failure."""
        if n <= self.pool.pages_free:
            return True
        if self.prefix_cache is None:
            return False
        return n <= self.pool.pages_free + self.prefix_cache.evictable_pages

    def _alloc(self, n: int) -> List[int]:
        """Pool alloc that evicts LRU cache leaves when free pages run dry."""
        short = n - self.pool.pages_free
        if short > 0 and self.prefix_cache is not None:
            self.prefix_cache.evict(short)
        return self.pool.alloc(n)

    def can_admit(self, prompt_len: int, max_new_tokens: int) -> bool:
        if self.num_free_slots <= 0:
            return False
        return self._can_cover(self._pages_needed(prompt_len + max_new_tokens))

    def can_cover_pages(self, prompt_len: int, max_new_tokens: int) -> bool:
        """Page-only admission check (ignores slots), for SLO preemption."""
        return self._can_cover(self._pages_needed(prompt_len + max_new_tokens))

    def num_decoded(self, request_id: int) -> int:
        """Decode progress of an active request (0 if unknown)."""
        slot = self.req_to_slot.get(request_id)
        if slot is None:
            return 0
        return len(self.slots[slot].tokens)

    def _set_table_row(self, slot: int, pages: List[int]) -> None:
        self.block_tables[slot] = -1
        self.block_tables[slot, :len(pages)] = pages

    def _free_slot_id(self) -> int:
        return next(i for i in range(self.num_slots) if i not in self.slots)

    def add_request(self, request_id: int, prompt_tokens,
                    max_new_tokens: int) -> None:
        assert self.num_free_slots > 0, "no free slot"
        prompt = np.asarray(prompt_tokens, np.int32).ravel()
        plen = len(prompt)
        assert plen + max_new_tokens <= self.max_total_len, "sequence budget"
        slot = self._free_slot_id()
        # automatic prefix caching: alias the longest cached page-aligned
        # prefix; the final prompt token must always prefill.
        cached: List[int] = []
        if self.prefix_cache is not None and plen > 1:
            cached = self.prefix_cache.match(prompt[:plen - 1])
        pages = cached + self._alloc(
            self._pages_needed(plen + max_new_tokens) - len(cached))
        self._set_table_row(slot, pages)
        self._slot_pages[slot] = pages
        self.slots[slot] = _SlotState(request_id=request_id, prompt=prompt,
                                      tokens=[], logprobs=[],
                                      remaining=max_new_tokens,
                                      prefill_done=len(cached) * self.page_size,
                                      content_prefix=prompt,
                                      epoch=self._weight_epoch)
        self.req_to_slot[request_id] = slot

    # -------------------------------------------------- group (COW) submit
    def _group_page_plan(self, prompt_len: int,
                         max_new_tokens: int) -> Tuple[int, int]:
        """(shared-prefix pages, private pages per lane) for one group lane."""
        total = self._pages_needed(prompt_len + max_new_tokens)
        full = prompt_len // self.page_size
        return full, total - full

    def can_admit_group(self, prompt_len: int, group_size: int,
                        max_new_tokens: int) -> bool:
        full, priv = self._group_page_plan(prompt_len, max_new_tokens)
        return (self.num_free_slots >= group_size
                and self._can_cover(full + group_size * priv))

    def group_fits_pool(self, prompt_len: int, group_size: int,
                        max_new_tokens: int) -> bool:
        """Whether the group could EVER be admitted as a unit."""
        full, priv = self._group_page_plan(prompt_len, max_new_tokens)
        return (group_size <= self.num_slots
                and full + group_size * priv <= self.num_pages - 1)

    def submit_group(self, request_ids: List[int], prompt_tokens,
                     max_new_tokens: int) -> None:
        """Admit the G candidates of ONE prompt as a COW group: the first
        request prefills (a normal chunked prefill), the rest park in
        ``forkwait`` holding only their private pages until
        ``_fork_followers`` aliases the prompt pages into them."""
        g = len(request_ids)
        assert g >= 1
        prompt = np.asarray(prompt_tokens, np.int32).ravel()
        plen = len(prompt)
        assert plen + max_new_tokens <= self.max_total_len, "sequence budget"
        assert self.num_free_slots >= g, "not enough free slots for group"
        full, priv = self._group_page_plan(plen, max_new_tokens)
        assert self._can_cover(full + g * priv), "page pool exhausted"

        leader = self._free_slot_id()
        cached: List[int] = []
        if self.prefix_cache is not None and plen > 1:
            cached = self.prefix_cache.match(prompt[:plen - 1])
        pages = cached + self._alloc(full + priv - len(cached))
        self._set_table_row(leader, pages)
        self._slot_pages[leader] = pages
        lst = _SlotState(request_id=request_ids[0], prompt=prompt,
                         tokens=[], logprobs=[], remaining=max_new_tokens,
                         prefill_done=len(cached) * self.page_size,
                         content_prefix=prompt, epoch=self._weight_epoch)
        self.slots[leader] = lst
        self.req_to_slot[request_ids[0]] = leader

        for rid in request_ids[1:]:
            slot = self._free_slot_id()
            self._slot_pages[slot] = self._alloc(priv)
            self.slots[slot] = _SlotState(
                request_id=rid, prompt=prompt, tokens=[], logprobs=[],
                remaining=max_new_tokens, phase=_FORKWAIT, group_leader=leader,
                content_prefix=prompt, epoch=self._weight_epoch)
            self.req_to_slot[rid] = slot
            lst.followers.append(slot)

    def _fork_followers(self, leader: int, chunk_logits,
                        first_tok: int, first_lp: float) -> None:
        """The COW fork: alias the prompt's fully-filled pages into every
        follower and copy only the partial tail page (one batched device
        copy).  Each follower samples its own first token from the final
        prefill logits (greedy reuses the leader's)."""
        st = self.slots[leader]
        plen = len(st.prompt)
        nf = len(st.followers)
        if self.temperature <= 0.0:
            firsts = [(first_tok, first_lp)] * nf
        else:
            ftok, flp = sample_tokens(self._gen, chunk_logits.expand(nf, -1),
                                      temperature=self.temperature,
                                      top_k=self.top_k)
            host = torch.stack([ftok.double(), flp.double()]).cpu().numpy()
            firsts = [(int(t), float(lp)) for t, lp in zip(host[0], host[1])]
        srcs: List[int] = []
        dsts: List[int] = []
        for fslot, (t0, l0) in zip(st.followers, firsts):
            fst = self.slots[fslot]
            shared, tail_src = self.pool.fork_prefix(
                self._slot_pages[leader], plen)
            priv = self._slot_pages[fslot]
            if tail_src is not None:
                srcs.append(tail_src)
                dsts.append(priv[0])
            pages = shared + priv
            self._slot_pages[fslot] = pages
            self._set_table_row(fslot, pages)
            fst.phase = _DECODE
            fst.group_leader = None
            fst.tokens.append(t0)
            fst.logprobs.append(l0)
            fst.remaining -= 1
            fst.prefill_done = plen
            self.cur_token[fslot] = t0
            self.pos[fslot] = plen
        st.followers = []
        self.total_groups_forked += 1
        if srcs:
            self.cache = paged.copy_pages(self.cache, srcs, dsts)
            self.total_copy_ops += 1
            self.total_pages_copied += len(srcs)

    def _promote_follower(self, st: _SlotState, leader_pages: List[int]) -> None:
        """The group's prefill leader was aborted before the fork: hand its
        page allocation (prefilled content intact) to the first waiting
        follower, which continues the chunked prefill where it stopped."""
        new_leader = st.followers[0]
        nst = self.slots[new_leader]
        self.pool.release(self._slot_pages[new_leader])
        self._slot_pages[new_leader] = leader_pages
        self._set_table_row(new_leader, leader_pages)
        nst.phase = _PREFILL
        nst.group_leader = None
        nst.prefill_done = st.prefill_done
        nst.followers = st.followers[1:]
        for f in nst.followers:
            self.slots[f].group_leader = new_leader

    # ------------------------------------------ content-addressed release
    def _written_content(self, st: _SlotState, slot: int):
        """(token content, written length) of the slot's written KV region."""
        if st.phase == _DECODE:
            content = np.concatenate(
                [st.content_prefix, np.asarray(st.tokens, np.int32)])
            return content, int(self.pos[slot])
        if st.phase == _PREFILL:
            return st.content_prefix, st.prefill_done
        return st.content_prefix, 0          # forkwait: nothing written yet

    def _release_pages(self, pages: List[int], content, written: int,
                       epoch: int) -> None:
        """Release a request's pages, first indexing every fully-written
        page in the prefix cache (unless its KV predates the current weight
        epoch)."""
        if (self.prefix_cache is not None and written >= self.page_size
                and epoch == self._weight_epoch):
            full = written // self.page_size
            self.prefix_cache.insert(content[:full * self.page_size],
                                     pages[:full])
        self.pool.release(pages)

    def peek_tokens(self, request_id: int, start: int = 0) -> List[int]:
        """Decoded tokens[start:] of an active request (streaming hook)."""
        slot = self.req_to_slot.get(request_id)
        if slot is None:
            return []
        return list(self.slots[slot].tokens[start:])

    # --------------------------------------------------- retain / resume
    def abort(self, request_id: int, *, retain: bool = False) -> GenerationResult:
        slot = self.req_to_slot.pop(request_id)
        st = self.slots.pop(slot)
        pages = self._slot_pages.pop(slot)
        self.block_tables[slot] = -1
        if st.phase == _FORKWAIT:
            # pre-fork follower: it has no KV yet — nothing to retain.
            leader = self.slots.get(st.group_leader)
            if leader is not None and slot in leader.followers:
                leader.followers.remove(slot)
            self.pool.release(pages)
            retain = False
        elif st.followers:
            # pre-fork group leader: its pages keep serving the group.
            self._promote_follower(st, pages)
            retain = False
        elif retain:
            content, length = self._written_content(st, slot)
            self.retained[request_id] = _Retained(
                pages=pages, phase=st.phase, prompt=st.prompt,
                prefill_done=st.prefill_done,
                length=length if st.phase == _DECODE else 0,
                last_token=int(self.cur_token[slot]), content=content,
                epoch=st.epoch)
        else:
            content, written = self._written_content(st, slot)
            self._release_pages(pages, content, written, st.epoch)
        return GenerationResult(
            request_id=request_id, task=None,
            tokens=np.asarray(st.tokens, np.int32),
            logprobs=np.asarray(st.logprobs, np.float32),
            version_started=-1, aborted=True, partial=True, resumable=retain)

    def _resume_pages_needed(self, ret: _Retained, max_new_tokens: int) -> int:
        base = ret.length if ret.phase == _DECODE else len(ret.prompt)
        return self._pages_needed(base + max_new_tokens)

    def can_resume(self, request_id: int, max_new_tokens: int) -> bool:
        ret = self.retained.get(request_id)
        if ret is None or self.num_free_slots == 0:
            return False
        extra = self._resume_pages_needed(ret, max_new_tokens) - len(ret.pages)
        return extra <= 0 or self._can_cover(extra)

    def resume_request(self, request_id: int, new_request_id: int,
                       max_new_tokens: int) -> None:
        """Re-attach a retained request: its pages come back verbatim — zero
        prefix recomputation; a larger budget tops the table up."""
        ret = self.retained.pop(request_id)
        assert self.num_free_slots > 0, "no free slot"
        base = ret.length if ret.phase == _DECODE else len(ret.prompt)
        assert base + max_new_tokens <= self.max_total_len, "sequence budget"
        slot = self._free_slot_id()
        pages = ret.pages
        need = self._resume_pages_needed(ret, max_new_tokens)
        if need > len(pages):
            pages = pages + self._alloc(need - len(pages))
        self._set_table_row(slot, pages)
        self._slot_pages[slot] = pages
        st = _SlotState(request_id=new_request_id, prompt=ret.prompt,
                        tokens=[], logprobs=[], remaining=max_new_tokens,
                        phase=ret.phase, prefill_done=ret.prefill_done,
                        carried_last=(ret.last_token if ret.phase == _DECODE
                                      else None),
                        content_prefix=(ret.content if ret.content is not None
                                        else ret.prompt),
                        epoch=ret.epoch)
        self.slots[slot] = st
        self.req_to_slot[new_request_id] = slot
        if ret.phase == _DECODE:
            self.cur_token[slot] = ret.last_token
            self.pos[slot] = ret.length

    def release_retained(self, request_id: int) -> None:
        ret = self.retained.pop(request_id, None)
        if ret is not None:
            written = ret.length if ret.phase == _DECODE else ret.prefill_done
            content = ret.content if ret.content is not None else ret.prompt
            self._release_pages(ret.pages, content, written, ret.epoch)

    # ------------------------------------------- cross-replica page transfer
    def export_retained(self, request_id: int) -> Optional[dict]:
        """Extract a retained request's pages into a host-side record another
        replica can ``import_retained``.  The local record is NOT released."""
        ret = self.retained.get(request_id)
        if ret is None:
            return None
        t = paged.export_pages(self.cache, ret.pages)
        self.pages_transferred_out += t.num_pages
        self.transfer_bytes_out += t.nbytes
        self.transfer_device_ops += 1
        return {
            "transfer": t, "phase": ret.phase, "prompt": ret.prompt,
            "prefill_done": ret.prefill_done, "length": ret.length,
            "last_token": ret.last_token, "content": ret.content,
            "epoch": ret.epoch, "home_epoch": self._weight_epoch,
            "kv_quant": self.kv_quant,
        }

    def import_retained(self, request_id: int, record: dict) -> bool:
        """Re-admit an exported retained record into THIS replica's pool
        (one batched scatter).  Returns False, importing nothing, on a
        quant-mode mismatch, a rid collision or a pool that can't cover it."""
        t: paged.PageTransfer = record["transfer"]
        if (record.get("kv_quant", "off") != self.kv_quant
                or request_id in self.retained
                or not self._can_cover(t.num_pages)):
            return False
        pages = self._alloc(t.num_pages)
        self.cache = paged.import_pages(self.cache, pages, t)
        self.pages_transferred_in += t.num_pages
        self.transfer_bytes_in += t.nbytes
        self.transfer_device_ops += 1
        # the KV is current-policy only if it was current at home AND home
        # and here sit at the same weight epoch.
        current = (record["epoch"] == record["home_epoch"]
                   and record["home_epoch"] == self._weight_epoch)
        self.retained[request_id] = _Retained(
            pages=pages, phase=record["phase"], prompt=record["prompt"],
            prefill_done=record["prefill_done"], length=record["length"],
            last_token=record["last_token"], content=record["content"],
            epoch=self._weight_epoch if current else self._weight_epoch - 1)
        return True

    def export_prefix(self, tokens) -> Optional[dict]:
        """Extract this replica's cached prefix pages for ``tokens`` (match
        capped at ``len(tokens) - 1``, as at admission)."""
        if self.prefix_cache is None or len(tokens) < 2:
            return None
        tokens = np.asarray(tokens, np.int32).ravel()
        path = self.prefix_cache._walk(tokens[:len(tokens) - 1])
        if not path:
            return None
        pages = [n.page for n in path]
        t = paged.export_pages(self.cache, pages)
        self.pages_transferred_out += t.num_pages
        self.transfer_bytes_out += t.nbytes
        self.transfer_device_ops += 1
        covered = tokens[:len(pages) * self.page_size].copy()
        return {"transfer": t, "tokens": covered,
                "home_epoch": self._weight_epoch, "kv_quant": self.kv_quant}

    def import_prefix(self, record: dict) -> int:
        """Admit a pulled prefix record into this replica's radix cache.
        Never evicts, never imports cross-epoch KV, dedups against pages
        already cached.  Returns the number of pages imported."""
        if (self.prefix_cache is None
                or record.get("kv_quant", "off") != self.kv_quant
                or record["home_epoch"] != self._weight_epoch):
            return 0
        t: paged.PageTransfer = record["transfer"]
        tokens = record["tokens"]
        have_nodes = self.prefix_cache._walk(tokens)
        have = len(have_nodes)
        if have >= t.num_pages:
            return 0
        need = t.num_pages - have
        if need > self.pool.pages_free:
            return 0
        sub = paged.PageTransfer(*(None if x is None else x[:, have:]
                                   for x in t))
        pages = self._alloc(need)
        self.cache = paged.import_pages(self.cache, pages, sub)
        self.pages_transferred_in += need
        self.transfer_bytes_in += sub.nbytes
        self.transfer_device_ops += 1
        full = [n.page for n in have_nodes] + pages
        self.prefix_cache.insert(tokens, full)
        self.pool.release(pages)
        return need

    # ------------------------------------------------------------ auditing
    def audit_pages(self) -> None:
        """Assert the refcount invariant: every page's refcount equals its
        number of appearances across live block tables, retained records and
        prefix-cache holds, and a page is free exactly when its refcount is
        zero."""
        expect = np.zeros((self.num_pages,), np.int64)
        for pages in self._slot_pages.values():
            for p in pages:
                expect[p] += 1
        for ret in self.retained.values():
            for p in ret.pages:
                expect[p] += 1
        if self.prefix_cache is not None:
            for p in self.prefix_cache.held_pages():
                expect[p] += 1
        actual = np.asarray([self.pool.refcount(p)
                             for p in range(self.num_pages)], np.int64)
        assert (expect == actual).all(), \
            f"refcount leak: expected {expect.tolist()} got {actual.tolist()}"
        free = set(self.pool._free)
        assert paged.GARBAGE_PAGE not in free
        for p in range(1, self.num_pages):
            assert (p in free) == (actual[p] == 0), \
                f"page {p}: refcount {actual[p]} vs free={p in free}"

    # --------------------------------------------------------------- step
    def _run_model(self, toks, valid, start: int, row, decode_mask,
                   do_prefill: bool, do_decode: bool):
        """The device half of a step: one upload of every per-step input,
        the prefill chunk and/or the decode, and one download of what was
        sampled.  Returns (host int32 array, chunk logits or None)."""
        c, s, p = self.prefill_chunk, self.num_slots, self.pages_per_seq
        tables = np.where(decode_mask[:, None], self.block_tables, -1)
        packed = np.concatenate([toks.ravel(), valid.ravel(), row,
                                 tables.ravel(), self.cur_token,
                                 self.pos]).astype(np.int32)
        dev = torch.from_numpy(packed).to(self.device)
        toks_d, valid_d, row_d, tables_d, cur_d, pos_d = torch.split(
            dev, [c, c, p, s * p, s, s])
        outs = []
        chunk_logits = None
        if do_prefill:
            chunk_logits, self.cache = self.api.prefill_chunk(
                self.params, toks_d.view(1, c), valid_d.view(1, c).bool(),
                start, row_d, self.cache)
            ptok, plp = sample_tokens(self._gen, chunk_logits,
                                      temperature=self.temperature,
                                      top_k=self.top_k)
            outs += [ptok.to(torch.int32), plp.view(torch.int32)]
        if do_decode:
            dec_logits, self.cache = self.api.decode_paged(
                self.params, cur_d, pos_d, self.cache, tables_d.view(s, p),
                attn_impl=self.attn_impl)
            dtok, dlp = sample_tokens(self._gen, dec_logits,
                                      temperature=self.temperature,
                                      top_k=self.top_k)
            outs += [dtok.to(torch.int32), dlp.view(torch.int32)]
        # logprobs ride as their fp32 bit patterns: ONE device->host copy
        return torch.cat(outs).cpu().numpy(), chunk_logits

    def step(self) -> List[Tuple[int, np.ndarray, np.ndarray]]:
        """One engine step; returns finished (rid, tokens, logprobs)."""
        if not self.slots:
            return []
        finished: List[Tuple[int, np.ndarray, np.ndarray]] = []
        # finish BEFORE stepping: the last sampled (or carried) token may
        # already terminate the request.
        for slot in list(self.slots):
            st = self.slots[slot]
            if st.phase != _DECODE:
                continue
            last = st.tokens[-1] if st.tokens else st.carried_last
            if last is not None and (last == self.eos_id or st.remaining <= 0):
                finished.append(self._finish(slot))
        if not self.slots:
            return finished

        prefill_slots = [s for s, st in sorted(self.slots.items())
                         if st.phase == _PREFILL]
        decode_slots = [s for s, st in self.slots.items()
                        if st.phase == _DECODE]

        c = self.prefill_chunk
        chunk_slot = None
        n_chunk = 0
        toks = np.full((c,), self.pad_id, np.int32)
        valid = np.zeros((c,), np.int32)
        start = 0
        row = np.full((self.pages_per_seq,), -1, np.int32)
        if prefill_slots:
            chunk_slot = prefill_slots[self._rr % len(prefill_slots)]
            self._rr += 1
            st = self.slots[chunk_slot]
            if self.prefix_cache is not None:
                self._extend_cached_prefix(chunk_slot, st)
            start = st.prefill_done
            chunk = st.prompt[start:start + c]
            n_chunk = len(chunk)
            toks[:n_chunk] = chunk
            valid[:n_chunk] = 1
            row = self.block_tables[chunk_slot]

        decode_mask = np.zeros((self.num_slots,), bool)
        decode_mask[decode_slots] = True
        host, chunk_logits = self._run_model(
            toks, valid, start, row, decode_mask, chunk_slot is not None,
            bool(decode_slots))

        if chunk_slot is not None:
            t0, l0 = int(host[0]), float(host[1:2].view(np.float32)[0])
            host = host[2:]
            st = self.slots[chunk_slot]
            st.prefill_done += n_chunk
            self.total_prefill_chunks += 1
            self.total_prefill_tokens += n_chunk
            if (self.prefix_cache is not None
                    and st.epoch == self._weight_epoch):
                # publish freshly completed prompt pages immediately so
                # concurrent same-prefix requests pick them up mid-prefill.
                full = st.prefill_done // self.page_size
                if full:
                    self.prefix_cache.insert(
                        st.prompt[:full * self.page_size],
                        self._slot_pages[chunk_slot][:full])
            if st.prefill_done >= len(st.prompt):
                st.phase = _DECODE
                st.tokens.append(t0)
                st.logprobs.append(l0)
                st.remaining -= 1
                self.cur_token[chunk_slot] = t0
                self.pos[chunk_slot] = len(st.prompt)
                if st.followers:
                    self._fork_followers(chunk_slot, chunk_logits, t0, l0)

        if decode_slots:
            self.total_decode_steps += 1
            n = self.num_slots
            tok_np, lp_np = host[:n], host[n:2 * n].view(np.float32)
            self.cur_token[decode_mask] = tok_np[decode_mask]
            self.pos[decode_mask] += 1
            for s in decode_slots:
                st = self.slots[s]
                st.tokens.append(int(tok_np[s]))
                st.logprobs.append(float(lp_np[s]))
                st.remaining -= 1
                self.total_tokens_decoded += 1
        return finished

    def _extend_cached_prefix(self, slot: int, st: _SlotState) -> None:
        """Mid-prefill cache extension: at a page boundary, swap the slot's
        unwritten pages for cached ones a concurrent request just published
        and jump ``prefill_done`` forward (pure bookkeeping)."""
        if st.prefill_done % self.page_size:
            return                       # mid-page: cannot swap whole pages
        plen = len(st.prompt)
        j = st.prefill_done // self.page_size
        ext = self.prefix_cache.match(st.prompt[:plen - 1], from_page=j,
                                      extend=True)
        if not ext:
            return
        pages = self._slot_pages[slot]
        k = j + len(ext)
        swapped_out = pages[j:k]
        pages[j:k] = ext
        self.pool.release(swapped_out)
        self._set_table_row(slot, pages)
        st.prefill_done = k * self.page_size

    def _finish(self, slot: int) -> Tuple[int, np.ndarray, np.ndarray]:
        st = self.slots.pop(slot)
        self.req_to_slot.pop(st.request_id, None)
        content, written = self._written_content(st, slot)
        self._release_pages(self._slot_pages.pop(slot), content, written,
                            st.epoch)
        self.block_tables[slot] = -1
        return (st.request_id, np.asarray(st.tokens, np.int32),
                np.asarray(st.logprobs, np.float32))
