"""The port's paged layer against the JAX package: host-side page
accounting must be identical, and the device forwards must give the same
logits and write the same pages from the same weights and block tables."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny
from repro.models import get_api as jget_api
from repro.models import paged as jpaged
from repro_torch.convert import params_from_jax
from repro_torch.models import get_api
from repro_torch.models import paged
from repro_torch.models.config import ModelConfig

# tiny shapes: one torch thread, so the suite's parallel workers keep their
# cores (torch's pool would otherwise spin on all of them)
torch.set_num_threads(1)


class _Listener:
    def __init__(self):
        self.events = []

    def on_insert(self, path):
        self.events.append(("insert", path))

    def on_evict(self, path):
        self.events.append(("evict", path))

    def on_clear(self):
        self.events.append(("clear",))


def _pool_state(pool, cache):
    return dict(ref=pool._ref.tolist(), free=list(pool._free),
                pages_free=pool.pages_free, in_use=pool.pages_in_use,
                shared=pool.pages_shared, private=pool.pages_private,
                peak=pool.peak_pages_in_use, nodes=cache.num_nodes,
                evictable=cache.evictable_pages,
                held=sorted(cache.held_pages()), paths=sorted(cache.paths()),
                counters=(cache.lookups, cache.hits, cache.ext_hits,
                          cache.hit_tokens, cache.inserted_pages,
                          cache.evicted_pages, cache.flushes))


def _scripted(mod):
    """One fixed sequence of allocator and radix-cache operations."""
    log = []
    pool = mod.PagePool(14, 4)
    cache = mod.RadixCache(pool)
    cache.listener = _Listener()
    toks = np.arange(1, 25, dtype=np.int32)
    other = np.concatenate([toks[:8], np.arange(90, 98, dtype=np.int32)])
    a = pool.alloc(4)
    log.append(a)
    log.append(pool.fork_prefix(a, 10))
    b = pool.alloc(3)
    log.append(b)
    log.append(cache.insert(toks[:16], a))
    log.append(cache.insert(other, a[:2] + b[:2]))
    log.append(cache.peek(toks))
    log.append(cache.match(toks[:15]))
    log.append(cache.match(toks[:15], from_page=2, extend=True))
    log.append(cache.match(other[:11], from_page=1, extend=True))
    log.append(_pool_state(pool, cache))
    pool.release(a)
    pool.release(b)
    pool.release(a[:2])                       # the fork's shared references
    log.append(_pool_state(pool, cache))
    log.append(cache.evict(3))
    log.append(_pool_state(pool, cache))
    c = pool.alloc(2)
    pool.share(c)
    log.append(cache.insert(np.arange(50, 58, dtype=np.int32), c))
    pool.release(c)
    pool.release(c)
    cache.clear()
    log.append(_pool_state(pool, cache))
    log.append(cache.listener.events)
    return log


def test_page_pool_and_radix_cache_match_the_jax_package_step_for_step():
    want, got = _scripted(jpaged), _scripted(paged)
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g == w, f"step {i}: {g} != {w}"


def _setup(dtype="float32"):
    cfg = tiny("qwen3-4b", dtype=dtype)
    japi = jget_api(cfg)
    jp = japi.init(jax.random.PRNGKey(0))
    tapi = get_api(ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return cfg, japi, jp, tapi, tp


@pytest.mark.parametrize("jax_impl,port_impl", [("ref", "ref"),
                                                ("kernel_interpret", "kernel")])
def test_prefill_chunks_and_decode_steps_match(jax_impl, port_impl):
    cfg, japi, jp, tapi, tp = _setup()
    page_size, chunk = 8, 8
    rows = np.asarray([[3, 7, 1, 5], [2, 8, 6, 4], [-1, -1, -1, -1]], np.int32)
    jcache = japi.init_paged_cache(9, page_size)
    tcache = tapi.init_paged_cache(9, page_size)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in (11, 5)]
    first = []
    for r, prompt in enumerate(prompts):
        for start in range(0, len(prompt), chunk):
            piece = prompt[start:start + chunk]
            toks = np.zeros((1, chunk), np.int32)
            toks[0, :len(piece)] = piece
            valid = np.zeros((1, chunk), bool)
            valid[0, :len(piece)] = True
            jl, jcache = japi.prefill_chunk(jp, jnp.asarray(toks), jnp.asarray(valid),
                                            jnp.int32(start), jnp.asarray(rows[r]),
                                            jcache)
            tl, tcache = tapi.prefill_chunk(tp, torch.from_numpy(toks),
                                            torch.from_numpy(valid), start,
                                            torch.from_numpy(rows[r]), tcache)
            np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=1e-5, atol=1e-5)
        first.append(int(np.argmax(np.asarray(jl))))
    token = np.asarray(first + [0], np.int32)
    pos = np.asarray([len(p) for p in prompts] + [0], np.int32)
    for _ in range(3):
        jl, jcache = japi.decode_paged(jp, jnp.asarray(token), jnp.asarray(pos), jcache,
                                       jnp.asarray(rows), attn_impl=jax_impl)
        tl, tcache = tapi.decode_paged(tp, torch.from_numpy(token), torch.from_numpy(pos),
                                       tcache, torch.from_numpy(rows), attn_impl=port_impl)
        # row 2 is a masked slot: it reads only the garbage page, whose
        # content duplicate writes leave undefined.
        np.testing.assert_allclose(np.asarray(jl)[:2], tl.numpy()[:2],
                                   rtol=1e-5, atol=1e-5)
        token = np.asarray(np.argmax(np.asarray(jl), axis=-1), np.int32)
        pos = pos + 1
    for jpages, tpages in ((jcache.k_pages, tcache.k_pages),
                           (jcache.v_pages, tcache.v_pages)):
        np.testing.assert_allclose(np.asarray(jpages)[:, 1:], tpages.numpy()[:, 1:],
                                   rtol=1e-5, atol=1e-5)
    # the request view gathers what was written, through the table
    k, v, valid = tapi.cache_view(tcache.layer_pages(1), torch.from_numpy(rows[0]))
    jk, jv, jvalid = jpaged.gather_request_view(
        (jcache.k_pages[1], jcache.v_pages[1]), jnp.asarray(rows[0]))
    np.testing.assert_allclose(np.asarray(jk), k.numpy(), rtol=1e-5, atol=1e-5)
    assert valid.tolist() == np.asarray(jvalid).tolist()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_copy_pages_and_export_import_round_trip(dtype):
    cfg, japi, _, tapi, _ = _setup(dtype)
    rng = np.random.default_rng(1)
    shape = (cfg.num_layers, 7, 4, cfg.num_kv_heads, cfg.resolved_head_dim)
    k, v = rng.normal(size=shape).astype(np.float32), rng.normal(size=shape).astype(np.float32)
    tdt = getattr(torch, dtype)
    tcache = paged.PagedKVCache(torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt))
    jcache = jpaged.PagedKVCache(jnp.asarray(k, dtype), jnp.asarray(v, dtype))

    jcache = jpaged.copy_pages(jcache, jnp.asarray([1, 2]), jnp.asarray([5, 6]))
    tcache = paged.copy_pages(tcache, [1, 2], [5, 6])
    assert np.array_equal(np.asarray(jcache.k_pages, np.float32), tcache.k_pages.float().numpy())
    assert np.array_equal(np.asarray(jcache.v_pages, np.float32), tcache.v_pages.float().numpy())

    t = paged.export_pages(tcache, [3, 1])
    jt = jpaged.export_pages(jcache, [3, 1])
    assert t.num_pages == jt.num_pages == 2 and t.nbytes == jt.nbytes
    assert t.k.device.type == "cpu" and t.k.dtype == tdt
    other = tapi.init_paged_cache(7, 4)
    other = paged.import_pages(other, [2, 4], t)
    assert torch.equal(other.k_pages[:, [2, 4]], tcache.k_pages[:, [3, 1]])
    assert torch.equal(other.v_pages[:, [2, 4]], tcache.v_pages[:, [3, 1]])
    assert not other.k_pages[:, [0, 1, 3, 5, 6]].any()
    with pytest.raises(ValueError, match="import of 2 pages"):
        paged.import_pages(other, [1], t)
