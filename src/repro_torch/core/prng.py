"""The random draws of Sizey's decision path, reproduced on the host.

Every full retrain draws the MLP's initial weights (``normal``) and the
forest's bootstrap weights (``poisson(1.0)``) from one key made from an
integer seed. The reference implementation takes these draws from JAX's
threefry2x32 generator, so the port reproduces that generator bit for bit;
a ``torch.Generator`` would start the models from other states and no
decision could be compared.

What is reproduced (JAX's default configuration: threefry2x32 with
``jax_threefry_partitionable=True``, 32-bit integers):

  * ``prng_key(seed)``  -- the raw key ``[seed >> 32, seed & 0xFFFFFFFF]``;
  * ``split(key, n)``   -- the fold-like split: the i-th key is the hash of
    the 64-bit counter i split into two 32-bit words;
  * ``fold_in(key, d)`` -- the hash of the counter words (0, d);
  * ``random_bits``     -- the hash of the flat row-major counter, the two
    output words XOR-ed;
  * ``uniform``         -- mantissa fill of ``[1, 2)`` minus one, scaled;
  * ``normal``          -- ``sqrt(2) * erfinv(u)`` with ``u`` uniform on
    ``(-1, 1)``; erfinv is Giles' single-precision polynomial over XLA's
    ``log1p``, as XLA's CPU backend lowers it;
  * ``poisson(key, lam)`` for ``lam < 10`` -- Knuth's loop, one split per
    iteration, summing XLA's single-precision logarithm.

XLA's CPU backend evaluates ``log`` and ``log1p`` as Cephes polynomials
with fused multiply-adds, which differ from a correctly rounded logarithm
in about one value in seven; the port writes those polynomials out
(``log_f32``, ``log1p_f32``) so that the Poisson loop's comparison with
``-lam`` and the normals come out as JAX's. The tests hold keys, bits,
uniforms, normals and Poisson counts bitwise equal to ``jax.random``'s
(tests/test_torch_prng.py); a normal may differ by at most 0 ulp.

All of it is numpy on the host: the draws are small (at most a few dozen
normals and 8 x CAP counts per fit) and are uploaded once per fit.
"""
from __future__ import annotations

import numpy as np

_U32 = np.uint32
_F32 = np.float32

_ROT0 = (13, 15, 26, 6)
_ROT1 = (17, 29, 16, 24)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << _U32(r)) | (v >> _U32(32 - r))


def threefry2x32(k1, k2, x1: np.ndarray, x2: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of counter words (x1, x2) under
    key (k1, k2); uint32 in, uint32 out, elementwise."""
    k1, k2 = _U32(k1), _U32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        a = np.asarray(x1, _U32) + ks[0]
        b = np.asarray(x2, _U32) + ks[1]
        for i in range(5):
            for r in (_ROT0 if i % 2 == 0 else _ROT1):
                a = a + b
                b = _rotl(b, r) ^ a
            a = a + ks[(i + 1) % 3]
            b = b + ks[(i + 2) % 3] + _U32(i + 1)
    return a, b


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a 32-bit integer seed."""
    seed = int(seed)
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed {seed} is outside the int32 range")
    return np.asarray([0, seed & 0xFFFFFFFF], _U32)


def _counters(n: int):
    idx = np.arange(n, dtype=np.uint64)
    return ((idx >> np.uint64(32)).astype(_U32),
            (idx & np.uint64(0xFFFFFFFF)).astype(_U32))


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` -> (num, 2) uint32 keys."""
    hi, lo = _counters(num)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return np.stack([b1, b2], axis=-1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for a 32-bit integer ``data``:
    the hash of the counter words (0, data) under ``key``."""
    b1, b2 = threefry2x32(key[0], key[1], np.zeros(1, _U32),
                          np.asarray([int(data) & 0xFFFFFFFF], _U32))
    return np.concatenate([b1, b2])


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """32 random bits per element of ``shape`` (row-major counters)."""
    shape = tuple(shape)
    hi, lo = _counters(int(np.prod(shape, dtype=np.int64)))
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return (b1 ^ b2).reshape(shape)


def uniform(key: np.ndarray, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform`` in float32 on ``[minval, maxval)``."""
    bits = random_bits(key, shape)
    fl = ((bits >> _U32(9)) | _U32(0x3F800000)).view(_F32) - _F32(1.0)
    lo, hi = _F32(minval), _F32(maxval)
    return np.maximum(lo, fl * (hi - lo) + lo)


def _fma(a, b, c) -> np.ndarray:
    """Single-precision fused multiply-add: the product of two float32
    values is exact in float64, so one float64 add and one rounding back
    reproduce fmaf (up to a double rounding that never showed in 2M
    samples)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """Giles' single-precision erfinv, in XLA's form."""
    x = np.asarray(x, _F32)
    w = -log1p_f32((-x) * x)
    lt = w < _F32(5.0)
    with np.errstate(invalid="ignore"):
        w = np.where(lt, w - _F32(2.5), np.sqrt(w) - _F32(3.0))
    p = np.where(lt, _F32(_ERFINV_LT5[0]), _F32(_ERFINV_GE5[0]))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, np.where(lt, _F32(c_lt), _F32(c_ge)))
    with np.errstate(over="ignore", invalid="ignore"):
        return np.where(np.abs(x) == _F32(1.0), x * _F32(np.inf),
                        p * x).astype(_F32)


def normal(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.normal`` in float32."""
    lo = np.nextafter(_F32(-1.0), _F32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return (_F32(np.sqrt(2)) * erfinv_f32(u)).astype(_F32)


_LOG_P = tuple(_F32(v) for v in (
    7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
    1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
    3.3333331174E-1))


def log_f32(x: np.ndarray) -> np.ndarray:
    """Natural log of positive float32 values as XLA's CPU backend
    computes it (Cephes polynomial, fused multiply-adds); 0 -> -inf."""
    x = np.asarray(x, _F32)
    t = np.maximum(x, np.asarray(0x00800000, _U32).view(_F32))
    bits = t.view(_U32)
    e = _F32(1.0) + ((bits >> _U32(23)).astype(np.int32) - 0x7F).astype(_F32)
    t = ((bits & _U32(0x807FFFFF)) | _F32(0.5).view(_U32)).view(_F32)
    small = t < _F32(0.707106781186547524)
    t1 = np.where(small, t, _F32(0.0))
    t = t - _F32(1.0)
    e = e - np.where(small, _F32(1.0), _F32(0.0))
    t = t + t1
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P
    y = _fma(t, p[0], p[1])
    y1 = _fma(t, p[3], p[4])
    y2 = _fma(t, p[6], p[7])
    y = _fma(y, t, p[2])
    y1 = _fma(y1, t, p[5])
    y2 = _fma(y2, t, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, _F32(-2.12194440e-4) * e)
    t = _fma(_F32(-0.5), x2, t)
    t = t + y
    t = _fma(_F32(0.693359375), e, t)
    return np.where(x == _F32(0.0), _F32(-np.inf), t).astype(_F32)


_LOG1P_NUM = (4.5270000862445199635E-5, 4.9854102823193375972E-1,
               6.5787325942061044846E0, 2.9911919328553073277E1,
               6.0949667980987787057E1, 5.7112963590585538103E1,
               2.0039553499201281259E1)
_LOG1P_DEN = (1., 1.5062909083469192198E1, 8.3047565967967209469E1,
              2.2176239823732856465E2, 3.0909872225312059774E2,
              2.1642788614495947685E2, 6.0118660497603843919E1)


def log1p_f32(x: np.ndarray) -> np.ndarray:
    """log(1 + x) for float32 ``x > -1`` as XLA's CPU backend computes it:
    a Cephes rational function below sqrt(2) - 1 in magnitude, else
    ``log_f32(1 + x)``."""
    x = np.asarray(x, _F32)
    num = np.zeros_like(x)
    den = np.zeros_like(x)
    for c in _LOG1P_NUM:
        num = _fma(num, x, _F32(c))
    for c in _LOG1P_DEN:
        den = _fma(den, x, _F32(c))
    x2 = x * x
    small = x + _fma(_F32(-0.5), x2, (x * x2) * (num / den))
    return np.where(np.abs(x) < _F32(0.41421356237309504880), small,
                    log_f32(x + _F32(1.0))).astype(_F32)


def poisson(key: np.ndarray, lam: float, shape) -> np.ndarray:
    """``jax.random.poisson(key, lam, shape)`` (int32) for ``lam < 10``:
    Knuth's loop, splitting the key once per iteration."""
    if not 0.0 <= lam < 10.0:
        raise ValueError("only the Knuth branch (0 <= lam < 10) is ported")
    shape = tuple(shape)
    if lam == 0.0:
        return np.zeros(shape, np.int32)
    neg_lam = _F32(-lam)
    k = np.zeros(shape, np.int32)
    log_prod = np.zeros(shape, _F32)
    rng = key
    while bool(np.any(log_prod > neg_lam)):
        rng, sub = split(rng)
        k = np.where(log_prod > neg_lam, k + 1, k)
        log_prod = log_prod + log_f32(uniform(sub, shape))
    return (k - 1).astype(np.int32)
