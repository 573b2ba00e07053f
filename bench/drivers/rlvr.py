"""The asynchronous RL step: ``build_rlvr_pipeline(...).run`` (one replica and
the trainer on one card), at the mix's ``alpha`` (0: the synchronous
baseline, a blocking 3-phase weight sync; above 0: the mix's
``weight_sync``).

Set-up: the kernels, the pipeline, the benchmark's weights put in the
trainer's state and every engine, then RL step 0: it runs every shape of
the window (prefill chunks, the decode step, the train step's minibatch)
and the reference follows its first optimizer steps.  The window runs from
the end of step 0 to the end of the last step that ends within
``--seconds``; the sample buffer is closed at that instant, so the step
under way ends the run.  The traced run measures ``trace_steps`` steps,
then runs one step more for the reference (see below).

What the reference checks: step 0's batch, decoded with the initial
weights before any sync; its first optimizer steps; samples that later
steps trained and that were started at version 1, against the weights the
trainer published after step 0 (the reference follows all of step 0's
optimizer steps to work them out, rounded to the dtype the engines serve);
and, at the end, that every engine holds the tree the trainer last
published and that no sample was staler than alpha.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from bench.drivers import train as train_driver
from bench.lib import check, faults, flops, host, traffic, weights
from bench.lib.cell import Context, Record, free_device, model_config
from bench.lib.trace import Tracer
from bench.reference import grpo
from bench.reference.qwen3 import Qwen3


class _Ends(list):
    """The controller's ``stats``: stamps each step's end and runs a hook."""

    def __init__(self, hook):
        super().__init__()
        self.ends, self.hook = [], hook

    def append(self, item) -> None:
        super().append(item)
        self.ends.append(time.perf_counter())
        self.hook(len(self))


def _settings(ctx: Context):
    from repro_torch.launch.pipeline import PipelineSettings
    m = ctx.mix
    return PipelineSettings(
        async_generation_ratio=m["alpha"], weight_sync=m["weight_sync"],
        pg_variant=m["pg_variant"], rollout_batch_size=m["prompts"] * m["group"],
        num_return_sequences_in_group=m["group"], max_new_tokens=m["max_new_tokens"],
        max_seq_len=m["max_seq_len"], num_slots=m["slots"], minibatches=m["minibatches"],
        ppo_epochs=m["ppo_epochs"], learning_rate=m["learning_rate"], seed=ctx.seed,
        page_size=m["page_size"], prefill_chunk=m["prefill_chunk"],
        prefix_cache=m["prefix_cache"], num_rollout_replicas=1,
        rollout_quant=ctx.overrides.get("rollout_quant", "off"))


def _as_dict(sample) -> dict:
    return {"prompt": np.asarray(sample.prompt_tokens), "response": np.asarray(sample.response_tokens),
            "logprobs": np.asarray(sample.logprobs, np.float32), "reward": float(sample.reward),
            "group_id": sample.group_id,
            "version": (sample.version_started, sample.version_finished)}


def run(ctx: Context) -> Record:
    import torch
    from repro_torch.launch.pipeline import build_rlvr_pipeline
    from repro_torch.models.transformer import init_lm

    rec = Record(ctx)
    mix, mcfg = ctx.mix, model_config(ctx.cfg)
    s = _settings(ctx)
    pipe = build_rlvr_pipeline(mcfg, s, task=traffic.SeededPrompts(mix, mcfg.vocab_size, ctx.seed),
                               reward_fn=lambda smp: traffic.parity_reward(smp.response_tokens),
                               device=ctx.device)
    w = weights.stacked(ctx.cfg, ctx.seed, ctx.device)
    tree = weights.port_tree(w)
    weights.check_like(tree, init_lm(mcfg, 0, device=torch.device("meta")))
    for e in pipe.engines:
        e.update_weights(tree)
    train_driver.install(pipe.trainer, tree, ctx.device)
    faults.plant_trainer(ctx, pipe.trainer)
    faults.plant_sync(ctx, pipe.controller)
    probe = check.TrainProbe(pipe.trainer, dict(check.leaves(tree)), mix["check_steps"])
    del tree, w

    batches, train = [], pipe.controller.train_fn

    def recorded(samples):
        batches.append([_as_dict(x) for x in samples])
        return train(samples)

    pipe.controller.train_fn = recorded
    tracer = Tracer(ctx.device) if ctx.trace else None
    watch = host.HostWindow(ctx.device)
    marks = {}
    closer = threading.Timer(1e9, pipe.buffer.close)

    def at_step_end(n: int) -> None:
        marks[n] = _counters(pipe)
        if n == 1:                                   # step 0 ended: the window opens
            if tracer:
                tracer.start()
            watch.start()
            marks["t0"] = time.perf_counter()
            rec.setup_s = marks["t0"] - ctx.process_start
            closer.interval = ctx.seconds
            closer.start()
            return
        marks[n, "host"] = watch.read()
        if tracer and n == 1 + mix["trace_steps"]:
            tracer.stop()
        elif tracer and n == 2 + mix["trace_steps"]:
            # one step more: it trains samples started after the first sync,
            # which the reference compares
            pipe.buffer.close()

    pipe.controller.stats = _Ends(at_step_end)
    with faults.sampler(ctx):
        try:
            pipe.run(1 << 30, timeout=600)
        except RuntimeError as err:                  # the closed buffer ends the run
            if not pipe.buffer.closed or "t0" not in marks:
                raise
            if "insufficient samples" not in str(err):
                raise
        finally:
            closer.cancel()
    if tracer and tracer.active:
        tracer.stop()
    stats, ends = pipe.controller.stats, pipe.controller.stats.ends
    t0 = marks["t0"]
    if tracer:                                       # the traced steps
        last = mix["trace_steps"] if len(ends) > mix["trace_steps"] else None
    else:
        last = max((i for i in range(1, len(ends)) if ends[i] <= t0 + ctx.seconds),
                   default=None)
    if last is None:
        if not ctx.overrides.get("readings_only"):
            raise RuntimeError(f"no RL step ended within {ctx.seconds} s of step 0")
        last = 0
    rec.window, rec.tracer = (t0, ends[last]), tracer
    rec.counters = {k: v - marks[1][k] for k, v in marks[last + 1].items()}
    window_steps = range(1, last + 1)
    rec.steps = [{"wait_s": stats[i].wait_time, "train_s": stats[i].train_time,
                  "sync_s": stats[i].sync_time, "samples": len(batches[i]),
                  "lengths": train_driver.real_lengths(batches[i], s.max_seq_len)}
                 for i in window_steps]
    rec.attempted = sum(st["samples"] for st in rec.steps)
    rec.readings.update(marks.get((last + 1, "host"), {}))
    rec.readings["step_s"] = [round(b - a, 3) for a, b in zip(ends[:last], ends[1:last + 1])]
    if ctx.device.type == "cuda":
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated(ctx.device)
    n_mat, n_head = flops.matmul_params(ctx.cfg), flops.head_params(ctx.cfg)
    c = rec.counters
    rec.flops = (sum(train_driver.step_flops(ctx.cfg, st["lengths"], s) for st in rec.steps)
                 + 2.0 * n_mat * c["total_tokens_decoded"]
                 + 2.0 * (n_mat - n_head) * c["total_prefill_tokens"]
                 + 2.0 * n_head * c["total_prefill_chunks"])

    # what the window leaves to check: the last published tree is every
    # engine's, and no sample was staler than alpha
    final = pipe.trainer.get_weights()
    if s.rollout_quant == "off":         # a quantizing engine holds its own codes
        rec.check("sync_mismatch", sum(e.params is not final for e in pipe.engines))
    rec.check("staleness_excess", max(0, max(st.staleness_max for st in stats) - mix["alpha"]))
    pipe.trainer.state = None
    for e in pipe.engines:
        e.params = e.cache = None
    del pipe, final
    free_device(ctx.device)
    _check(ctx, rec, probe, batches)
    return rec


def _counters(pipe) -> dict:
    keys = ("total_decode_steps", "total_tokens_decoded", "total_prefill_tokens",
            "total_prefill_chunks")
    return {k: sum(getattr(e, k) for e in pipe.engines) for k in keys}


def _pick(samples: list, n: int, rng: np.random.Generator) -> list:
    """The longest of ``samples`` and ``n - 1`` others drawn by ``rng``."""
    longest = max(range(len(samples)), key=lambda i: len(samples[i]["response"]))
    rest = [i for i in range(len(samples)) if i != longest]
    size = min(len(rest), n - 1)
    return [samples[i] for i in [longest] + [int(i) for i in rng.choice(rest, size=size,
                                                                         replace=False)]]


def _served(ctx: Context, w: dict, samples: list):
    """(engine logprobs, reference logprobs) of each sample under ``w``."""
    import torch
    model = Qwen3(ctx.cfg, w)
    served, ref = [], []
    with torch.no_grad():
        for x in samples:
            p = torch.as_tensor(x["prompt"].astype(np.int64), device=ctx.device)
            r = torch.as_tensor(x["response"].astype(np.int64), device=ctx.device)
            ref.append(model.response_logprobs(p, r).cpu().numpy())
            served.append(x["logprobs"])
    return served, ref


def _check(ctx: Context, rec: Record, probe, batches: list) -> None:
    """Against the reference: the logprobs the engine served for samples
    drawn from the seed, the longest in each draw, of step 0's batch (the
    initial weights) and of the later batches' samples started at version
    1 (the weights after step 0), together; the trainer's first optimizer
    steps."""
    import torch
    mix = ctx.mix
    rng = np.random.default_rng(ctx.seed ^ 0xC0FFEE)
    w = weights.stacked(ctx.cfg, ctx.seed, ctx.device)
    served, ref = _served(ctx, w, _pick(batches[0], mix["check_requests"], rng))
    gaps = {}

    def at_step(follower) -> None:
        if follower.step_count == probe.steps:
            gaps.update(check.train_gaps(probe, follower))

    step0 = mix["minibatches"] * mix["ppo_epochs"]
    follower = grpo.follow(ctx.cfg, w, batches, train_driver.reference_settings(ctx),
                           steps=max(step0, probe.steps), at_step=at_step)
    for name, value in gaps.items():
        rec.check(name, value)
    synced = [x for b in batches[1:] for x in b if x["version"][0] == 1]
    rec.readings["synced_samples"] = len(synced)
    if follower.step_count == step0 and synced:
        v1 = {k: t.detach().to(w[k].dtype) for k, t in follower.w.items()}
        del follower
        more = _served(ctx, v1, _pick(synced, mix["check_requests"], rng))
        served, ref = served + more[0], ref + more[1]
    # a run with no sample decoded after a weight sync has not shown one
    rec.check("synced_unchecked", int(not synced))
    for name, value in check.served_gaps(served, ref).items():
        rec.check(name, value)
