"""Faults planted under the timed path, for the tests and the control run
(``bench/control.py``) only: ``run.py`` never plants one.  Each shows that
``correct`` comes out false when the program goes wrong in that way.

* ``frozen_step``: the train step returns its state unchanged.
* ``half_batch``: the train step sees half of its minibatch's rows, the
  loss its mean over those.
* ``altered_token``: the sampler hands back the next token id to the one
  it drew (its logprob unchanged), where tokens are produced.
* ``skewed_sync``: every weight sync hands the engines a copy of the
  published tree with each attention output matrix negated, so that
  only what is decoded after a sync goes wrong.
"""
from __future__ import annotations

import contextlib

FAULTS = ("frozen_step", "half_batch", "altered_token", "skewed_sync")


def plant_trainer(ctx, trainer) -> None:
    """Wrap ``trainer``'s step as ``ctx.overrides["fault"]`` says."""
    fault = ctx.overrides.get("fault")
    inner = trainer._train_step
    if fault == "frozen_step":
        import torch

        def frozen(state, mini):
            return state, {"loss": torch.zeros(())}
        trainer._train_step = frozen
    elif fault == "half_batch":
        def half(state, mini):
            n = mini["tokens"].shape[0]
            return inner(state, {k: v[: max(1, n // 2)] for k, v in mini.items()})
        trainer._train_step = half


def plant_sync(ctx, controller) -> None:
    """Wrap the weights ``controller`` publishes when ``ctx.overrides["fault"]``
    is ``skewed_sync``."""
    if ctx.overrides.get("fault") != "skewed_sync":
        return
    inner = controller.get_weights_fn

    def skewed():
        tree = inner()
        blocks = [dict(b, attn=dict(b["attn"], wo=-b["attn"]["wo"])) for b in tree["blocks"]]
        return dict(tree, blocks=blocks)
    controller.get_weights_fn = skewed


@contextlib.contextmanager
def sampler(ctx):
    """While open, the paged engine's sampler alters every token it draws
    when ``ctx.overrides["fault"]`` is ``altered_token``."""
    if ctx.overrides.get("fault") != "altered_token":
        yield
        return
    from repro_torch.rollout import paged_engine
    inner = paged_engine.sample_tokens

    def altered(gen, logits, **kw):
        tokens, lp = inner(gen, logits, **kw)
        return (tokens + 1) % logits.shape[-1], lp
    paged_engine.sample_tokens = altered
    try:
        yield
    finally:
        paged_engine.sample_tokens = inner
