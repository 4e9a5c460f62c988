"""Threefry-2x32 keys and draws, bit for bit those of ``jax.random`` (port
of the parts of ``jax._src.prng`` and ``jax._src.random`` that the
serving stack uses, with ``jax_threefry_partitionable`` on, the default of
jax 0.9).

A key is a pair of uint32 words. Torch has no full uint32 arithmetic, so
every word here is an int64 tensor holding a value in [0, 2^32); sums and
shifts are masked back to 32 bits. Keys are ``(..., 2)`` int64 tensors:
a batch of keys is a batch dimension in front of the pair.

  * ``PRNGKey(seed)``           -> (..., 2): (seed >> 32, seed & 0xFFFFFFFF)
                                   of a 32-bit seed, i.e. (0, seed mod 2^32)
  * ``fold_in(key, data)``      threefry(key, (0, data))
  * ``split(key, num)``         threefry(key, (0, i)) for i < num
  * ``random_bits(key, shape)`` 32 bits per element: the two threefry
                                words of the element's flat index, xor'ed
  * ``uniform``, ``randint``, ``gumbel`` and ``categorical`` from those
    bits, as ``jax.random`` builds them.

Integer results are bitwise JAX's. Floats made from the bits by exact
operations (the uniforms) are too; ``gumbel``'s two logarithms may differ
from XLA's by an ulp.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & _M32) | (x >> (32 - d))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher (20 rounds), elementwise over the
    broadcast of its four uint32 operands. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def PRNGKey(seed, device=None) -> torch.Tensor:  # noqa: N802 (JAX's name)
    """Raw key of a 32-bit integer seed (or a tensor of them): (..., 2)."""
    s = torch.as_tensor(seed, dtype=torch.int64, device=device)
    if ((s < -2 ** 31) | (s >= 2 ** 31)).any():
        raise OverflowError("seeds must fit in 32 bits (jax_enable_x64 off)")
    return torch.stack([torch.zeros_like(s), s & _M32], dim=-1)


def _words(key: torch.Tensor):
    key = torch.as_tensor(key, dtype=torch.int64)
    return key[..., 0], key[..., 1]


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """A new key from ``key`` and 32-bit integer ``data`` (broadcast over a
    batch of keys)."""
    k1, k2 = _words(key)
    d = torch.as_tensor(data, device=k1.device).to(torch.int64) & _M32
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` new keys from one key: (num, 2)."""
    k1, k2 = _words(key)
    i = torch.arange(num, dtype=torch.int64, device=k1.device)
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(i), i)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element of ``shape`` (int64 in [0, 2^32)). A
    batch of keys (..., 2) gives (..., *shape), one draw per key."""
    k1, k2 = _words(key)
    n = 1
    for d in shape:
        n *= int(d)
    lead = k1.shape
    idx = torch.arange(n, dtype=torch.int64, device=k1.device)
    k1 = k1.reshape(lead + (1,))
    k2 = k2.reshape(lead + (1,))
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(idx), idx)
    return (y1 ^ y2).reshape(tuple(lead) + tuple(shape))


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """f32 uniforms in [minval, maxval): the top 23 bits as the mantissa of
    a float in [1, 2), minus 1, scaled, shifted and floored at minval."""
    bits = random_bits(key, shape)
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fb.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=floats.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=floats.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """int32 values in [minval, maxval): 64 random bits per value reduced
    modulo the span in wrapping uint32 arithmetic, as ``jax.random``."""
    k = split(key, 2)
    hi_bits = random_bits(k[0], shape)
    lo_bits = random_bits(k[1], shape)
    span = (maxval - minval) & _M32 if maxval > minval else 1
    mult = 2 ** 16 % span
    mult = ((mult * mult) & _M32) % span     # uint32: wraps for span > 2^16
    off = (((hi_bits % span) * mult) & _M32) + lo_bits % span
    off = (off & _M32) % span
    return (minval + off).to(torch.int32)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """f32 standard Gumbel noise -log(-log(u)), u uniform in [tiny, 1)
    (``jax.random.gumbel``'s default "low" mode)."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row of (..., V) ``logits`` under a batch of keys
    (..., 2): argmax(logits + Gumbel noise indexed by vocabulary id), the
    Gumbel-max trick of ``jax.random.categorical`` on a (1, V) row."""
    noise = gumbel(key.to(logits.device), logits.shape[-1:])
    return torch.argmax(noise.to(logits.dtype) + logits, dim=-1)
