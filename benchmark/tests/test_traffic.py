"""Traffic from the seed: the same work for every seed, in another order."""

import numpy as np

from yardstick import traffic as tf


def test_prompts_are_distinct_and_seeded():
    p = tf.prompts(np.random.default_rng(1), 8)
    assert len(set(p)) == 8
    assert p == tf.prompts(np.random.default_rng(1), 8)
    assert sorted(len(s.split()) for s in p) == sorted(w + 2 for w in tf.PROMPT_WORDS)


def test_every_seed_gets_the_same_word_counts():
    for n in (4, 8, 11):
        counts = [sorted(len(s.split()) for s in tf.prompts(np.random.default_rng(seed), n))
                  for seed in (1, 2, 2 ** 31 + 7)]
        assert counts[0] == counts[1] == counts[2]


def test_call_seeds_are_fixed_by_the_seed():
    a, b = tf.seeds(np.random.default_rng(5), 6), tf.seeds(np.random.default_rng(5), 6)
    assert a == b and a != tf.seeds(np.random.default_rng(6), 6)
    assert all(0 <= s < 2 ** 31 - 1 for s in a)
