"""Slot-based continuous-batching decode engine — the port of the JAX
package's ``rollout/engine.py``.

The engine holds a fixed number of decode *slots*, each owning one row of a
statically shaped cache: a dense KV cache (``attention.KVCache``: the
dense and MoE families), a recurrent state (``rwkv6.RWKVState``) or both
(the hybrid's
``transformer.HybridCache``).  ADD claims the first free slot and
prefills the prompt into that row; every ``step()`` advances ALL slots by
one token in one forward (inactive rows are computed and discarded, and
their positions keep advancing, as in the reference); finish/ABORT releases
the slot.  This is the LLMProxy's step-wise inference contract (§4.2).  It
serves the decoder-only families (dense, MoE, RWKV-6, RecurrentGemma,
PaliGemma), the ones without paged KV included.  An MoE prompt's bucket
padding is routed and takes expert capacity, as in the reference.  A VLM
is served text-only, as the reference's engine does (its prefill passes
only ``tokens`` and ``valid``): no patches, and a cache widened by
``num_image_tokens`` that the text never reaches.  The enc-dec
(``audio``) is refused at construction: the reference's engine has no
frames to prefill it with (its ``add_request`` fails on the missing
``frames``).

What differs from the JAX engine is how a step runs:

* ``cur_token``, ``pos`` and ``active`` live on the host as numpy mirrors;
  a decode step uploads ``cur_token`` and ``pos`` in ONE host->device copy
  and reads the sampled tokens and logprobs back in ONE device->host copy.
* The cache is written in place.  A prefill resets its slot's row (k/v and
  states zero, positions -1) and fills it through a view, leaving the row
  exactly as the reference's ``_insert_slot`` does: the whole row replaced,
  so a reused slot never sees its previous request.
* Sampling draws from a ``torch.Generator`` seeded with ``seed``; tokens
  under temperature > 0 differ from ``jax.random``'s.
* ``attn_impl``: "kernel" (the hand-written decode-attention kernel of
  dense, MoE and hybrid decode steps, the WKV scan kernel of every RWKV-6
  forward, the RG-LRU scan kernel of every hybrid forward) or "ref" (their
  plain versions).  Prefill attention runs plain attention in both, as in
  the reference.
* Quantize-on-sync (``quant_mode`` int8 / fp8): the engine holds the codes
  (in the reference's scale groups, ``transformer.block_groups``) and the
  forwards dequantize one layer at a time inside their layer loop.

Implements ``repro_torch.core.llm_proxy.InferenceEngine``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.types import GenerationResult
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.api import ModelAPI
from repro_torch.quant import core as quant
from repro_torch.rollout.sampler import sample_tokens

@dataclasses.dataclass
class _SlotState:
    request_id: int
    tokens: List[int]
    logprobs: List[float]
    remaining: int


def _check_mode(kind: str, mode: str, known) -> None:
    if mode not in known:
        raise ValueError(f"unknown {kind} {mode!r} (expected {' | '.join(known)})")


def _reset_rows(cache) -> None:
    """An empty row, as ``init_cache`` makes it: positions -1, the rest 0
    (every part of a ``HybridCache``)."""
    for name, t in cache._asdict().items():
        if isinstance(t, torch.Tensor):
            t.fill_(-1 if name == "pos" else 0)
        elif hasattr(t, "_asdict"):
            _reset_rows(t)


def refuse_audio(cfg, what: str) -> None:
    """The enc-dec family cannot be served: the reference's slot engine
    prefills ``tokens`` and ``valid`` only, and the enc-dec's prefill needs
    the encoder's ``frames``."""
    if cfg.family == "audio":
        raise ValueError(
            f"{what}: the enc-dec (audio) family cannot be served: the slot engine "
            "prefills tokens only and the encoder needs frames, which the reference's "
            "engine has no way to take either; drive api.prefill / api.decode_step "
            "with batch['frames'] instead")


class DecodeEngine:
    """``attn_impl``: "kernel" or "ref" (see the module docstring).
    ``device``: the card unless the caller passes another; it must be the
    device of ``api``."""

    def __init__(self, api: ModelAPI, params, *, num_slots: int = 8,
                 max_total_len: int = 128, eos_id: int = 2,
                 temperature: float = 1.0, top_k: int = 0,
                 pad_id: int = 0, seed: int = 0,
                 prefill_bucket: Optional[int] = 16,
                 quant_mode: str = "off", attn_impl: str = "kernel",
                 device=None):
        cfg = api.cfg
        self.device = resolve_device(device)
        if api.device != self.device:
            raise ValueError(f"engine device {self.device} differs from the "
                             f"model API's {api.device}")
        _check_mode("quant_mode", quant_mode, quant.MODES)
        _check_mode("attn_impl", attn_impl, ("kernel", "ref"))
        refuse_audio(cfg, "DecodeEngine")
        if cfg.sliding_window is not None and cfg.sliding_window < max_total_len:
            raise ValueError("engine requires cache >= max_total_len "
                             "(enlarge window or shorten sequences)")
        self.api = api
        # quantize-on-sync: the trainer's tree is quantized HERE, at
        # construction and on every update_weights
        self.quant_mode = quant_mode
        self.params = self._quantized(params)
        self.num_slots = num_slots
        self.max_total_len = max_total_len
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.temperature = temperature
        self.top_k = top_k
        self.attn_impl = attn_impl
        # recurrent state ingests every fed position: exact-length prefill
        self.prefill_bucket = (None if cfg.family in ("ssm", "hybrid")
                               else prefill_bucket)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.cache = api.init_cache(num_slots, max_total_len)
        # host mirrors; step() uploads them once per step
        self.cur_token = np.full((num_slots,), pad_id, np.int32)
        self.pos = np.zeros((num_slots,), np.int32)
        self.active = np.zeros((num_slots,), bool)
        self.slots: Dict[int, _SlotState] = {}      # slot -> state
        self.req_to_slot: Dict[int, int] = {}
        self.total_decode_steps = 0
        self.total_tokens_decoded = 0

    def _quantized(self, params):
        params = quant.quantize_params(params, self.quant_mode,
                                       groups=transformer.block_groups(self.api.cfg))
        # embed is never quantized: its device is the tree's
        if params["embed"].device != self.device:
            raise ValueError(f"params on {params['embed'].device}, engine on "
                             f"{self.device}")
        return params

    def _sample(self, logits):
        """Sample every row; ONE device->host copy of tokens and logprobs
        (the logprobs ride as their fp32 bit patterns)."""
        tok, lp = sample_tokens(self._gen, logits, temperature=self.temperature,
                                top_k=self.top_k)
        host = torch.cat([tok.to(torch.int32), lp.view(torch.int32)]).cpu().numpy()
        n = logits.shape[0]
        return host[:n], host[n:].view(np.float32)

    # ------------------------------------------------------------ protocol
    @property
    def num_free_slots(self) -> int:
        return self.num_slots - len(self.slots)

    @property
    def active_request_ids(self) -> List[int]:
        return list(self.req_to_slot)

    def set_quant_mode(self, mode: str) -> None:
        """Change quantization mid-run; applies at the next update_weights
        (the held tree is already lossily quantized)."""
        _check_mode("quant_mode", mode, quant.MODES)
        self.quant_mode = mode

    def update_weights(self, params) -> None:
        self.params = self._quantized(params)

    def add_request(self, request_id: int, prompt_tokens, max_new_tokens: int) -> None:
        assert self.num_free_slots > 0, "no free slot"
        slot = next(i for i in range(self.num_slots) if not self.active[i])
        prompt = np.asarray(prompt_tokens, np.int32).ravel()
        plen = len(prompt)
        assert plen + max_new_tokens <= self.max_total_len, "sequence budget"

        if self.prefill_bucket:
            padded = int(np.ceil(plen / self.prefill_bucket) * self.prefill_bucket)
        else:
            padded = plen
        packed = np.zeros((2, padded), np.int32)     # tokens, valid
        packed[0] = self.pad_id
        packed[0, :plen] = prompt
        packed[1, :plen] = 1
        dev = torch.from_numpy(packed).to(self.device)
        row = self.cache.rows(slot, slot + 1)
        _reset_rows(row)
        with torch.no_grad():
            logits, _ = self.api.prefill(
                self.params, {"tokens": dev[0:1], "valid": dev[1:2].bool()}, row,
                attn_impl=self.attn_impl)
            tok, lp = self._sample(logits)      # last-real-position logits (1, V)
        tok_i, lp_f = int(tok[0]), float(lp[0])

        self.cur_token[slot] = tok_i
        self.pos[slot] = plen
        self.active[slot] = True
        self.slots[slot] = _SlotState(request_id=request_id, tokens=[tok_i],
                                      logprobs=[lp_f], remaining=max_new_tokens - 1)
        self.req_to_slot[request_id] = slot

    def peek_tokens(self, request_id: int, start: int = 0) -> List[int]:
        """Decoded tokens[start:] of an active request (streaming hook)."""
        slot = self.req_to_slot.get(request_id)
        if slot is None:
            return []
        return list(self.slots[slot].tokens[start:])

    def abort(self, request_id: int) -> GenerationResult:
        slot = self.req_to_slot.pop(request_id)
        st = self.slots.pop(slot)
        self.active[slot] = False
        return GenerationResult(
            request_id=request_id, task=None,
            tokens=np.asarray(st.tokens, np.int32),
            logprobs=np.asarray(st.logprobs, np.float32),
            version_started=-1, aborted=True, partial=True)

    def step(self) -> List[Tuple[int, np.ndarray, np.ndarray]]:
        """One decode step for every slot; returns finished requests."""
        if not self.slots:
            return []
        finished: List[Tuple[int, np.ndarray, np.ndarray]] = []
        # check eos/budget BEFORE decoding the next token: the last sampled
        # token may already terminate the request.
        for slot in list(self.slots):
            st = self.slots[slot]
            if st.tokens and (st.tokens[-1] == self.eos_id or st.remaining <= 0):
                finished.append(self._finish(slot))
        if not self.slots:
            return finished

        dev = torch.from_numpy(np.stack([self.cur_token, self.pos])).to(self.device)
        with torch.no_grad():
            logits, _ = self.api.decode_step(self.params, dev[0], dev[1], self.cache,
                                             attn_impl=self.attn_impl)
            tok_np, lp_np = self._sample(logits)
        self.total_decode_steps += 1
        self.cur_token = tok_np.copy()
        self.pos = self.pos + 1
        for slot, st in list(self.slots.items()):
            st.tokens.append(int(tok_np[slot]))
            st.logprobs.append(float(lp_np[slot]))
            st.remaining -= 1
            self.total_tokens_decoded += 1
        return finished

    def _finish(self, slot: int) -> Tuple[int, np.ndarray, np.ndarray]:
        st = self.slots.pop(slot)
        self.req_to_slot.pop(st.request_id, None)
        self.active[slot] = False
        return (st.request_id, np.asarray(st.tokens, np.int32),
                np.asarray(st.logprobs, np.float32))
