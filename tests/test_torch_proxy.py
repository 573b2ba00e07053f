"""The port's LLMProxy over the port's engine serves RolloutTasks exactly as
the JAX LLMProxy over the JAX engine does under greedy decoding, including
a task expanded by ``num_return_sequences`` into a COW group."""
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from conftest import tiny
from repro.core.llm_proxy import LLMProxy as JaxProxy
from repro.core.types import RolloutTask as JaxTask
from repro.models import get_api as jget_api
from repro.rollout.paged_engine import PagedDecodeEngine as JaxEngine
from repro_torch.convert import params_from_jax
from repro_torch.core.llm_proxy import LLMProxy
from repro_torch.core.types import RolloutTask
from repro_torch.models import get_api
from repro_torch.models.config import ModelConfig
from repro_torch.rollout import PagedDecodeEngine

# tiny shapes: one torch thread, so the suite's parallel workers keep their
# cores (torch's pool would otherwise spin on all of them)
torch.set_num_threads(1)

ENGINE = dict(num_slots=8, max_total_len=64, page_size=8, prefill_chunk=8,
              eos_id=99, temperature=0.0, prefix_cache=True)


def _serve(proxy_cls, task_cls, engine, n_want=7, timeout=120):
    rng = np.random.default_rng(11)
    pre = rng.integers(1, 30, 16)
    lock = threading.Lock()
    results = []
    done = threading.Event()

    def callback(res):
        with lock:
            results.append(res)
            if len(results) == n_want:
                done.set()

    proxy = proxy_cls(engine).start()
    try:
        for i, n in enumerate((5, 11, 20, 7)):
            prompt = np.concatenate([pre, rng.integers(1, 30, n)]).astype(np.int32) \
                if i % 2 else rng.integers(1, 30, n).astype(np.int32)
            meta = {"num_return_sequences": 4} if i == 3 else {}
            proxy.generate(task_cls(task_id=1000 + i, prompt_id=i, replica_idx=0,
                                    prompt_tokens=prompt, max_new_tokens=6,
                                    meta=meta),
                           version=0, callback=callback)
        assert done.wait(timeout), f"{len(results)}/{n_want} callbacks fired"
    finally:
        proxy.stop()
    assert not proxy._thread.is_alive()
    engine.audit_pages()
    return {(r.task.prompt_id, r.task.replica_idx): (r.tokens.tolist(), r.aborted)
            for r in results}, proxy


@pytest.mark.timeout(300)
def test_proxy_results_equal_the_jax_proxy_under_greedy():
    cfg = tiny("qwen3-4b", dtype="float32", vocab_size=32)
    japi = jget_api(cfg)
    jp = japi.init(jax.random.PRNGKey(0))
    tapi = get_api(ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")

    want, jproxy = _serve(JaxProxy, JaxTask, JaxEngine(japi, jp, **ENGINE))
    teng = PagedDecodeEngine(tapi, tp, device="cpu", **ENGINE)
    got, tproxy = _serve(LLMProxy, RolloutTask, teng)
    assert len(got) == 7 and got == want
    assert all(not aborted and len(toks) == 6 for toks, aborted in got.values())
    assert tproxy.requests_completed == jproxy.requests_completed == 7
    assert tproxy.cache_stats == jproxy.cache_stats
    assert teng.total_groups_forked == 1 and tproxy.load() == 0
