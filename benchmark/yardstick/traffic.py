"""Traffic from a seed: prompts and the calls' seeds.  One general
generator per kind; a traffic file holds only numbers.

Every seed gets the same amount of work: prompts are of fixed word counts
drawn in another order.
"""

from __future__ import annotations

from typing import List

import numpy as np

WORDS = (
    "dog barking distance heavy rain tin roof car engine starting birds chirping forest "
    "footsteps gravel phone ringing another room waves crashing beach espresso machine "
    "steaming milk thunder rolling hills crowd cheering stadium wind howling through trees "
    "church bells ringing town square baby laughing kitchen pots clanging train passing "
    "crossing typing keyboard office cat purring softly fire crackling camp helicopter "
    "flying overhead water dripping cave violin playing slowly drums marching band door "
    "creaking open old house river flowing rocks sirens wailing city street"
).split()
PROMPT_WORDS = (4, 5, 6, 7, 8, 9, 10, 11)


def prompts(rng: np.random.Generator, n: int) -> List[str]:
    """``n`` distinct prompts whose word counts cycle through PROMPT_WORDS."""
    counts = np.resize(np.asarray(PROMPT_WORDS), n)
    rng.shuffle(counts)
    out = []
    for i, k in enumerate(counts):
        words = rng.choice(WORDS, size=int(k), replace=True)
        out.append(" ".join(words) + f" take {i}")
    return out


def seeds(rng: np.random.Generator, n: int) -> List[int]:
    return [int(s) for s in rng.integers(0, 2 ** 31 - 1, size=n)]
