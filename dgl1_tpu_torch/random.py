"""Process-wide host RNG with seed control (the port's
``dgl1_tpu/random.py``).

Every host-side sampler draws from one numpy Generator unless it is given
an explicit ``rng=``. Device-side randomness uses ``torch.Generator``s
passed explicitly and is unaffected.
"""

from __future__ import annotations

import numpy as np

__all__ = ["seed", "default_rng"]

_GLOBAL: np.random.Generator = np.random.default_rng()


def seed(val: int) -> None:
    """Re-seed the process-wide sampler RNG."""
    global _GLOBAL
    _GLOBAL = np.random.default_rng(val)


def default_rng() -> np.random.Generator:
    """The process-wide Generator used when a sampler gets ``rng=None``."""
    return _GLOBAL
