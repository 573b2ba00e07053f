"""The traffic generator: the same seed gives the same traffic, and every
seed the same set of sizes in another order."""
import itertools

import numpy as np

from bench.lib import traffic

TRAIN = {"prompts": 2, "group": 4, "prompt_len": [64, 256],
         "response_len": {"log_uniform": [32, 768]}}


def test_every_seed_draws_the_same_sizes():
    mix = {"prompt_len": [8, 24], "pool": 8}
    for seed in (1, 2, 2 ** 31 + 11):
        stream = traffic.SeededPrompts(mix, 512, seed).prompt_stream(group_size=4)
        prompts = [t for _, t in itertools.islice(stream, 4 * mix["pool"])][::4]
        assert sorted(len(t) for t in prompts) == \
            sorted(traffic.quantiles(mix["prompt_len"], mix["pool"]).tolist())
        assert all(traffic.FIRST_ID <= t.min() and t.max() < 512 for t in prompts)


def test_quantiles_stay_in_range_and_spread():
    q = traffic.quantiles({"log_uniform": [32, 384]}, 512)
    assert q.min() >= 32 and q.max() <= 384
    assert np.median(q) < (32 + 384) / 2            # log-uniform: most requests are short
    u = traffic.quantiles([64, 192], 129)
    assert u.min() == 64 and u.max() == 192


def test_train_batches_repeat_and_keep_their_lengths():
    a = next(traffic.train_batches(TRAIN, 1000, 9))
    b = next(traffic.train_batches(TRAIN, 1000, 9))
    assert all(np.array_equal(x["response"], y["response"]) for x, y in zip(a, b))
    gen = traffic.train_batches(TRAIN, 1000, 10)
    first, second = next(gen), next(gen)
    for batch in (a, first, second):
        assert sorted(len(x["response"]) for x in batch) == \
            sorted(traffic.quantiles(TRAIN["response_len"], 8).tolist())
        assert all(x["reward"] == traffic.parity_reward(x["response"]) for x in batch)
        assert all(np.all(x["logprobs"] <= 0) for x in batch)
    assert [len(x["prompt"]) for x in first] != [] and first[0]["response"].tolist() != \
        second[0]["response"].tolist()


def test_seeded_prompts_repeat_each_prompt_for_its_group():
    mix = {"prompt_len": [64, 192], "pool": 64}
    stream = traffic.SeededPrompts(mix, 1000, 4).prompt_stream(group_size=8)
    first = list(itertools.islice(stream, 16))
    assert [pid for pid, _ in first] == [0] * 8 + [1] * 8
    assert all(np.array_equal(first[0][1], t) for _, t in first[:8])
    again = list(itertools.islice(traffic.SeededPrompts(mix, 1000, 4).prompt_stream(group_size=8), 16))
    assert all(np.array_equal(x[1], y[1]) for x, y in zip(first, again))


def test_parity_reward():
    assert traffic.parity_reward([2, 4, 5]) == 1.0
    assert traffic.parity_reward([2, 3]) == 0.0
    assert traffic.parity_reward([]) == 0.0
