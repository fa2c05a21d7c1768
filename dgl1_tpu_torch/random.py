"""Process-wide host RNG with seed control (the port's
``dgl1_tpu/random.py``).

Every host-side sampler draws from one numpy Generator unless it is given
an explicit ``rng=``. Device-side randomness uses ``torch.Generator``s
passed explicitly and is unaffected.
"""

from __future__ import annotations

import numpy as np

__all__ = ["seed", "default_rng", "prng_key", "prng_split", "prng_fold_in",
           "prng_normal", "prng_uniform", "prng_glorot_uniform"]

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


def prng_fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the hash of the counter pair
    (0, data) under ``key``."""
    b1, b2 = _threefry2x32(key[0], key[1], np.zeros(1, np.uint32),
                           np.array([data], np.uint32))
    return np.array([b1[0], b2[0]], dtype=np.uint32)


def _unit_floats(key, n: int) -> np.ndarray:
    """``n`` float32 values in [1, 2): 23 random mantissa bits under a
    fixed exponent, as ``jax.random`` makes them."""
    b1, b2 = _threefry2x32(key[0], key[1], *_counters(n))
    bits = (b1 ^ b2) >> np.uint32(9) | np.uint32(0x3F800000)
    return bits.view(np.float32)


def prng_uniform(key, shape, minval: float = 0.0,
                 maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    floats = _unit_floats(key, int(np.prod(shape))) - np.float32(1.0)
    return np.maximum(lo, _fma32(floats, hi - lo, lo)).reshape(shape)


def prng_glorot_uniform(key, shape) -> np.ndarray:
    """``jax.nn.initializers.glorot_uniform()(key, shape)`` of a 2-d
    kernel (fan in ``shape[0]``, fan out ``shape[1]``): uniform on
    (-1, 1) times ``sqrt(3 * variance)``, the variance ``2 / (fan_in +
    fan_out)`` rounded to float32."""
    variance = np.float32(1.0 / ((shape[0] + shape[1]) / 2))
    scale = np.sqrt(np.float32(3) * variance)
    return prng_uniform(key, shape, -1.0) * scale


def _fma32(a, b, c):
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product of two float32 values is exact in float64."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _hex32(*vals):
    return [np.float32(float.fromhex(v)) for v in vals]


# XLA's CPU float32 log1p: a Cephes rational approximation where |a| <
# sqrt(2) - 1, else its log of 1 + a (exponent and mantissa split, a
# polynomial in the mantissa); each multiply feeding one add is fused.
_L1P_DEN = _hex32("0x1.e2035ap+3", "0x1.4c30b6p+6", "0x1.bb865ap+7",
                  "0x1.351946p+8", "0x1.b0db14p+7", "0x1.e0f304p+5")
_L1P_NUM = _hex32("0x1.7bc096p-15", "0x1.fe818ap-2", "0x1.a509f4p+2",
                  "0x1.de9738p+4", "0x1.e798ecp+5", "0x1.c8e75ap+5",
                  "0x1.40a202p+4")
_LOG_C = _hex32("0x1.204376p-4", "-0x1.d7a370p-4", "-0x1.fcba9ep-4",
                "0x1.23d37ep-3", "0x1.999d58p-3", "-0x1.fffff8p-3",
                "0x1.de4a34p-4", "-0x1.555ca0p-3", "0x1.555554p-2",
                "-0x1.bd0106p-13", "0x1.630000p-1")


def _log1p32(a):
    a = np.asarray(a, np.float32)
    one, half = np.float32(1.0), np.float32(0.5)
    # |a| < sqrt(2) - 1: a - a^2/2 + a^3 * P(a) / Q(a).
    a2 = a * a
    q = np.ones_like(a)
    for c in _L1P_DEN:
        q = _fma32(q, a, c)
    p = np.full_like(a, _L1P_NUM[0])
    for c in _L1P_NUM[1:]:
        p = _fma32(p, a, c)
    small = a + _fma32(a2, -half, (a * a2) * (p / q))
    # Else log(1 + a) = e * ln 2 + log(m), m in [sqrt(1/2), sqrt(2)).
    b = a + one
    b = np.where(b > np.float32(2.0 ** -126), b, np.float32(2.0 ** -126))
    bits = b.view(np.uint32)
    e = ((bits >> np.uint32(23)).astype(np.int32) - 127).astype(
        np.float32) + one
    m = (bits & np.uint32(0x7FFFFF) | np.uint32(0x3F000000)).view(
        np.float32)
    low = m < np.float32(float.fromhex("0x1.6a09e6p-1"))
    x = (m - one) + np.where(low, m, np.float32(0.0))
    e = e - np.where(low, one, np.float32(0.0))
    c = _LOG_C
    z = x * x
    x3 = z * x
    s = _fma32(_fma32(_fma32(x, c[0], c[1]), x, c[6]), x3,
               _fma32(_fma32(x, c[2], c[3]), x, c[7]))
    s = _fma32(s, x3, _fma32(_fma32(x, c[4], c[5]), x, c[8]))
    y = _fma32(s, x3, e * c[9])
    large = _fma32(e, c[10], _fma32(-z, half, x) + y)
    large = np.where(a + one == 0, np.float32(-np.inf), large)
    return np.where(np.abs(a) < np.float32(float.fromhex("0x1.a8279ap-2")),
                    small, large)


def _erfinv32(x):
    """XLA's float32 inverse error function (Giles' polynomials in
    ``w = -log1p(-x^2)``, each step a fused multiply-add)."""
    x = np.asarray(x, np.float32)
    w = -_log1p32(-x * x)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    cs = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
          0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
          1.50140941)
    cl = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
          0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
          2.83297682)
    p = np.where(small, np.float32(cs[0]), np.float32(cl[0]))
    for a, b in zip(cs[1:], cl[1:]):
        p = _fma32(p, w, np.where(small, np.float32(a), np.float32(b)))
    out = p * x
    return np.where(np.abs(x) == 1, np.copysign(np.inf, x), out).astype(
        np.float32)


def prng_normal(key, shape) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32: uniform bits on
    (-1, 1), then ``sqrt(2) * erfinv``."""
    floats = _unit_floats(key, int(np.prod(shape))) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo, floats * (np.float32(1.0) - lo) + lo)
    return (np.float32(np.sqrt(2)) * _erfinv32(u)).reshape(shape)
