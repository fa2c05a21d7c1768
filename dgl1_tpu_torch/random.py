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


# The reference's in-script parameter draws (``jax.random``'s default
# threefry2x32 generator, the "partitionable" counter layout) reproduced
# in numpy, for the trainers whose script draws its weights from a
# ``PRNGKey`` rather than a module initialiser.

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k1, k2, x1, x2):
    """The threefry-2x32 hash (20 rounds) of the counter pairs (x1, x2)
    under the key (k1, k2), uint32 arrays."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x = [x1.astype(np.uint32) + ks[0], x2.astype(np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = (x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))
                x[1] = x[0] ^ x[1]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _counters(n: int):
    idx = np.arange(n, dtype=np.uint64)
    return ((idx >> np.uint64(32)).astype(np.uint32),
            (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32 bits."""
    s = np.uint64(seed)
    return np.array([s >> np.uint64(32), s & np.uint64(0xFFFFFFFF)],
                    dtype=np.uint32)


def prng_split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) keys."""
    b1, b2 = _threefry2x32(key[0], key[1], *_counters(num))
    return np.stack([b1, b2], axis=-1)


def _erfinv32(x):
    """XLA's float32 inverse error function (Giles' polynomials in
    ``w = -log1p(-x^2)``)."""
    x = np.asarray(x, np.float32)
    w = -np.log1p(-x * x)
    small = w < np.float32(5.0)
    ws = w - np.float32(2.5)
    wl = np.sqrt(w) - np.float32(3.0)
    p_s = np.float32(2.81022636e-08)
    for c in (3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
              0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
              1.50140941):
        p_s = np.float32(c) + p_s * ws
    p_l = np.float32(-0.000200214257)
    for c in (0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
              -0.0076224613, 0.00943887047, 1.00167406, 2.83297682):
        p_l = np.float32(c) + p_l * wl
    out = np.where(small, p_s, p_l) * x
    return np.where(np.abs(x) == 1, np.copysign(np.inf, x), out).astype(
        np.float32)


def prng_normal(key, shape) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32: uniform bits on
    (-1, 1), then ``sqrt(2) * erfinv``."""
    n = int(np.prod(shape))
    b1, b2 = _threefry2x32(key[0], key[1], *_counters(n))
    bits = (b1 ^ b2) >> np.uint32(9) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo, floats * (np.float32(1.0) - lo) + lo)
    return (np.float32(np.sqrt(2)) * _erfinv32(u)).reshape(shape)
