"""Seeds of the port's explicit torch generators."""

from __future__ import annotations

import numpy as np


def fold_seed(seed: int, step: int) -> int:
    """A 63-bit seed for (``seed``, ``step``), the counterpart of
    ``jax.random.fold_in(PRNGKey(seed), step)``: it depends on the pair
    alone, so a step's draws do not depend on what ran before it."""
    words = np.random.SeedSequence([seed & 0xFFFFFFFF, step & 0xFFFFFFFF]).generate_state(2)
    return (int(words[0]) << 31 | int(words[1]) >> 1) & (2 ** 63 - 1)
