"""JAX's default PRNG (threefry2x32, partitionable mode) in numpy.

The reference draws its ALS factor init from ``jax.random``: a key from
the integer seed, one ``split`` into two keys, then ``normal`` of a 2-D
shape under each.  The port draws the same numbers without JAX, so one
``engine.json`` trains to the same factors in both packages.  Written
from the algorithm (Salmon et al., "Parallel random numbers: as easy as
1, 2, 3", SC 2011: Threefry-2x32 with 20 rounds) and from the way JAX
lays out its counters in partitionable mode:

- a key is two uint32 words, ``(0, seed mod 2**32)``;
- ``split(key, n)`` hashes the 64-bit counters ``0 .. n-1`` (high word,
  low word) under the key; key ``i`` is the two output words of
  counter ``i``;
- ``fold_in(key, data)`` hashes the one counter pair ``(0, data)``
  (the key JAX makes of ``data`` as a seed) under the key; the new key
  is its two output words;
- 32-bit ``random_bits(key, shape)`` hashes the row-major flat index of
  each element the same way and XORs the two output words;
- ``normal``: the top 23 bits become a float in [1, 2), shifted to
  [0, 1), scaled onto (nextafter(-1, 0), 1), then ``√2 · erfinv``, with
  erfinv by Giles' single-precision approximation (M. Giles,
  "Approximating the erfinv function", GPU Computing Gems, 2011), the
  one XLA evaluates.

The bits are exact.  The normals agree with JAX's within 2 float32 ulps
(the ``log1p`` inside erfinv rounds differently in numpy and XLA);
``torch.erfinv``, another approximation, is off by up to 87 ulps in the
tails.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

__all__ = ["seed_key", "split", "fold_in", "random_bits", "normal",
           "erfinv"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
# Counters hashed per numpy pass: small enough that a pass's few
# temporaries stay in the CPU's cache (about 3x faster than one pass
# over tens of millions of elements).
_CHUNK = 1 << 16
# Giles' coefficients, highest power first: w = -log(1 - x²) below 5
# (polynomial in w - 2.5) and above (polynomial in √w - 3).
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def seed_key(seed: int) -> np.ndarray:
    """The key of an integer seed: uint32 ``[0, seed mod 2**32]``, as
    ``jax.random.PRNGKey`` makes it with 64-bit types off (JAX's default,
    which the reference keeps): the seed is taken as 32 bits, so the
    high word is 0, negative seeds included."""
    return np.array([0, int(seed) & 0xFFFFFFFF], dtype=np.uint32)


def _threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32, 20 rounds, of the counter pairs ``(x0, x1)`` under
    ``key``, in place; uint32 in, uint32 out (wrapping arithmetic)."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ _PARITY)
    t = np.empty_like(x1)
    with np.errstate(over="ignore"):
        x0 += ks[0]
        x1 += ks[1]
        for block in range(5):
            for r in _ROTATIONS[block % 2]:
                x0 += x1
                np.left_shift(x1, np.uint32(r), out=t)    # x1 = rotl(x1, r)
                x1 >>= np.uint32(32 - r)
                x1 |= t
                x1 ^= x0
            x0 += ks[(block + 1) % 3]
            x1 += ks[(block + 2) % 3] + np.uint32(block + 1)
    return x0, x1


def _hash_counters(key: np.ndarray, start: int, stop: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Both output words for the 64-bit counters ``start .. stop-1``."""
    lo = np.arange(start, stop, dtype=np.uint64)
    hi = (lo >> np.uint64(32)).astype(np.uint32)
    return _threefry2x32(np.asarray(key, np.uint32), hi, lo.astype(np.uint32))


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``num`` new keys, uint32 ``[num, 2]`` (``jax.random.split`` in
    partitionable mode)."""
    return np.stack(_hash_counters(key, 0, int(num)), axis=1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """The key ``jax.random.fold_in(key, data)`` makes, uint32 ``[2]``:
    ``data`` taken as 32 bits, as a seed is."""
    x0 = np.zeros(1, np.uint32)
    x1 = np.array([int(data) & 0xFFFFFFFF], np.uint32)
    w0, w1 = _threefry2x32(np.asarray(key, np.uint32), x0, x1)
    return np.array([w0[0], w1[0]], np.uint32)


def _bits_into(key: np.ndarray, out: np.ndarray, start: int) -> None:
    w0, w1 = _hash_counters(key, start, start + out.size)
    np.bitwise_xor(w0, w1, out=out)


def random_bits(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """Uniform uint32 bits of ``shape`` (``jax.random.bits`` at 32 bits,
    partitionable mode)."""
    shape = tuple(int(d) for d in shape)
    out = np.empty(int(np.prod(shape)), np.uint32)
    for start in range(0, out.size, _CHUNK):
        _bits_into(key, out[start:start + _CHUNK], start)
    return out.reshape(shape)


def erfinv(x: np.ndarray) -> np.ndarray:
    """Inverse error function of float32 ``x`` in (-1, 1), float32."""
    x = np.asarray(x, np.float32)
    w = -np.log1p(x * -x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for a, c in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p *= w
        p += np.where(lt, np.float32(a), np.float32(c))
    p *= x
    return p


def normal(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """Standard normal float32 numpy of ``shape`` (``jax.random.normal``)."""
    shape = tuple(int(d) for d in shape)
    out = np.empty(int(np.prod(shape)), np.float32)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    bits = np.empty(min(out.size, _CHUNK), np.uint32)
    for start in range(0, out.size, _CHUNK):
        n = min(_CHUNK, out.size - start)
        b = bits[:n]
        _bits_into(key, b, start)
        b >>= np.uint32(32 - 23)
        b |= np.uint32(0x3F800000)             # [1, 2)
        f = b.view(np.float32)
        f -= np.float32(1.0)                     # [0, 1)
        f *= np.float32(1.0) - lo                # (lo, 1)
        f += lo
        np.maximum(f, lo, out=f)
        out[start:start + n] = erfinv(f)
    out *= np.float32(np.sqrt(2.0))
    return out.reshape(shape)
