"""The train step alone: ``HostTrainer.train_on_samples`` as
``make_trainer`` builds it, on seeded batches of ``prompts`` x ``group``
samples (every batch a new one, each with the mix's same set of lengths).

Set-up: the kernels, the weights (the benchmark's, put in the trainer's
state in place of the ones it drew itself), then the first calls, enough
for ``check_steps`` optimizer steps: the reference follows those.  The
window opens after them; it ends with the last call that ends within
``--seconds``.  The traced run measures ``trace_steps`` calls only.
"""
from __future__ import annotations

import time

from bench.lib import check, faults, flops, host, traffic, weights
from bench.lib.cell import Context, Record, free_device, model_config
from bench.lib.trace import Tracer
from bench.reference import grpo


def settings(ctx: Context):
    from repro_torch.launch.pipeline import PipelineSettings
    m = ctx.mix
    return PipelineSettings(pg_variant=m["pg_variant"], minibatches=m["minibatches"],
                            ppo_epochs=m["ppo_epochs"], max_seq_len=m["max_seq_len"],
                            learning_rate=m["learning_rate"], seed=ctx.seed)


def reference_settings(ctx: Context) -> grpo.Settings:
    m = ctx.mix
    return grpo.Settings(max_seq_len=m["max_seq_len"], group_size=m["group"],
                         minibatches=m["minibatches"], learning_rate=m["learning_rate"],
                         warmup_steps=m["warmup_steps"])


def install(trainer, tree, device) -> None:
    """Give ``trainer`` the benchmark's weights and a fresh optimizer state
    for them, the state it drew from its seed freed first."""
    from repro_torch.train.optimizer import init_opt_state
    trainer.state = None
    free_device(device)
    trainer.state = {"params": tree, "opt": init_opt_state(tree)}


def real_lengths(samples: list, max_seq_len: int) -> list:
    """Tokens of each sample that the padded batch holds (prompt's last
    ``max_seq_len``, then as much of the response as fits)."""
    out = []
    for x in samples:
        p = min(len(x["prompt"]), max_seq_len)
        out.append(p + min(len(x["response"]), max_seq_len - p))
    return out


def to_samples(batch: list, gid_base: int):
    from repro_torch.core.types import Sample
    out = []
    for i, x in enumerate(batch):
        x["group_id"] = gid_base + x["group"]
        out.append(Sample(sample_id=gid_base * 1000 + i, prompt_id=x["group_id"],
                          replica_idx=i, prompt_tokens=x["prompt"],
                          response_tokens=x["response"], logprobs=x["logprobs"],
                          reward=x["reward"], group_id=x["group_id"],
                          is_positive=x["reward"] > 0))
    return out


def step_flops(cfg: dict, lengths: list, s) -> float:
    """Model FLOPs of one ``train_on_samples``: the proximal pass (a forward)
    and, per epoch, every minibatch's forward and backward."""
    prox = int(s.pg_variant == "decoupled_ppo" or s.minibatches > 1)
    return (prox + 3 * s.ppo_epochs) * flops.forward_flops(cfg, lengths)


def flash_per_step(cfg: dict, n: int, s) -> dict:
    """Launches and least time of the flash kernels in one call: per layer a
    forward over the whole batch for the proximal pass, then per minibatch
    a forward and a backward."""
    layers, _, h, kv, hd, _, _ = flops.shapes(cfg)
    prox = int(s.pg_variant == "decoupled_ppo" or s.minibatches > 1)
    steps = s.ppo_epochs * s.minibatches
    b = n // s.minibatches
    t = (prox * flops.flash_bound(n, h, kv, s.max_seq_len, hd, False)["seconds"]
         + steps * (flops.flash_bound(b, h, kv, s.max_seq_len, hd, False)["seconds"]
                    + flops.flash_bound(b, h, kv, s.max_seq_len, hd, True)["seconds"]))
    return {"fwd": layers * (prox + steps), "bwd": layers * steps, "seconds": layers * t}


def flash_counts():
    from repro_torch.kernels.flash_attention import flash_attention as fa
    return fa.launches_fwd, fa.launches_bwd


def run(ctx: Context) -> Record:
    import torch
    from repro_torch.launch.pipeline import make_trainer
    from repro_torch.models import get_api
    from repro_torch.models.transformer import init_lm

    rec = Record(ctx)
    mix, mcfg = ctx.mix, model_config(ctx.cfg)
    s = settings(ctx)
    api = get_api(mcfg, device=ctx.device)
    trainer = make_trainer(api, s, mix["group"])
    w = weights.stacked(ctx.cfg, ctx.seed, ctx.device)
    tree = weights.port_tree(w)
    weights.check_like(tree, init_lm(mcfg, 0, device=torch.device("meta")))
    install(trainer, tree, ctx.device)
    faults.plant_trainer(ctx, trainer)
    probe = check.TrainProbe(trainer, dict(check.leaves(tree)), ctx.mix["check_steps"])
    del tree, w
    batches = traffic.train_batches(mix, mcfg.vocab_size, ctx.seed)
    calls, gid = [], 0
    while len(probe.losses) < probe.steps:          # set-up: the steps the reference follows
        batch = next(batches)
        calls.append(batch)
        trainer.train_on_samples(to_samples(batch, gid))
        gid += mix["prompts"]
    probe.release()

    tracer = Tracer(ctx.device) if ctx.trace else None
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    if tracer:
        tracer.start()
    f0, b0 = flash_counts()
    watch = host.HostWindow(ctx.device)
    watch.start()
    t0 = time.perf_counter()
    rec.setup_s = t0 - ctx.process_start
    steps = []
    while not ctx.overrides.get("readings_only"):
        batch = next(batches)
        samples = to_samples(batch, gid)
        gid += mix["prompts"]
        trainer.train_on_samples(samples)
        t = time.perf_counter()
        lengths = real_lengths(batch, s.max_seq_len)
        steps.append({"end": t, "lengths": lengths, "positions": len(batch) * s.max_seq_len})
        if (tracer and len(steps) == mix["trace_steps"]) or t >= t0 + ctx.seconds:
            break
    f1, b1 = flash_counts()
    if tracer and tracer.active:
        tracer.stop()
    host_readings = watch.read()
    if not tracer:
        steps = [st for st in steps if st["end"] <= t0 + ctx.seconds]
    if not steps and not ctx.overrides.get("readings_only"):
        raise RuntimeError(f"no train step ended within {ctx.seconds} s")
    rec.window, rec.tracer, rec.steps = (t0, steps[-1]["end"] if steps else t0), tracer, steps
    rec.attempted = len(steps)
    rec.readings.update(host_readings)
    ends = [t0] + [st["end"] for st in steps]
    rec.readings["step_s"] = [round(b - a, 3) for a, b in zip(ends, ends[1:])]
    if ctx.device.type == "cuda":
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated(ctx.device)
    rec.flops = sum(step_flops(ctx.cfg, st["lengths"], s) for st in steps)
    per = flash_per_step(ctx.cfg, mix["prompts"] * mix["group"], s)
    rec.counters = {"flash_fwd": f1 - f0, "flash_bwd": b1 - b0,
                    "flash_fwd_expected": per["fwd"] * len(steps),
                    "flash_bwd_expected": per["bwd"] * len(steps)}
    if tracer:
        rec.flash_bound_s = per["seconds"] * len(steps)

    trainer.state = None
    del trainer, api
    free_device(ctx.device)
    w = weights.stacked(ctx.cfg, ctx.seed, ctx.device)
    follower = grpo.follow(ctx.cfg, w, calls, reference_settings(ctx), steps=probe.steps)
    for name, value in check.train_gaps(probe, follower).items():
        rec.check(name, value)
    return rec

