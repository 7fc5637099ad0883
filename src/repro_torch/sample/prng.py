"""The parts of ``jax.random`` the sampler uses, bit for bit, in PyTorch.

JAX's default generator is threefry2x32 (Salmon et al., "Parallel random
numbers: as easy as 1, 2, 3", 2011) over uint32 key pairs, with
``jax_threefry_partitionable`` on (the default since jax 0.5):

- ``prng_key(seed)`` is ``[seed >> 32, seed & 0xFFFFFFFF]``; seeds are
  32-bit (JAX without x64), so the high word is 0;
- ``split(key)`` hashes the key over the two-word iota of the output shape
  (``threefry2x32(key, iota_hi, iota_lo)``): row ``i`` of the result is
  ``[bits1[i], bits2[i]]``;
- ``fold_in(key, d)`` is ``threefry2x32(key, [0], [d])``;
- 32-bit ``random_bits`` is ``bits1 ^ bits2`` over the same iota;
- ``uniform`` puts the top 23 bits in the mantissa of a float in [1, 2),
  subtracts 1, scales into ``[minval, maxval)`` and clamps at ``minval``;
- ``gumbel`` (mode "low") is ``-log(-log(uniform(tiny, 1)))``.

PyTorch has almost no arithmetic on ``uint32``, so words are held as
``int64`` tensors with values in ``[0, 2**32)`` and every sum and shift is
masked back to 32 bits.  A key is a ``(..., 2)`` int64 tensor; leading axes
batch keys (one per lane), and everything runs on the key's device.

The float results follow the bits exactly as far as ``uniform`` over
``[0, 1)`` and ``[tiny, 1)``; ``gumbel`` takes two ``log``s, whose last bit
differs between XLA's and PyTorch's implementations (one ulp of the result,
below 1e-6 absolute).  A hash is some 175 elementwise launches on the card;
a sampling step runs two (the keys' ``split`` and the Gumbel draw).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = 1.1754943508222875e-38          # float32 smallest normal


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & _MASK) | (x >> (32 - d))


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash (20 rounds) of the counter pair ``(x1, x2)``
    under the key ``(k1, k2)``: uint32 words as int64 tensors (or ints),
    broadcast against each other.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x[0], x[1]


def prng_key(seed: int, *, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: (2,) int64."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is not a 32-bit integer")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: (..., 2) -> (..., 2)."""
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], 0, int(data) & _MASK)
    return torch.stack([b1, b2], dim=-1)


def _iota(shape, device):
    """The low word of JAX's two-word iota over ``shape`` (row-major); the
    high word is 0 below 2**32 elements."""
    size = math.prod(shape)
    if size >= 2 ** 32:
        raise ValueError(f"{size} random words exceed the 32-bit iota")
    return torch.arange(size, dtype=torch.int64, device=device).reshape(shape)


def _hash_iota(key: torch.Tensor, shape):
    """threefry2x32 of every key in ``key`` (..., 2) over the iota of
    ``shape``: two (..., *shape) words."""
    shape = tuple(shape)
    lead = key.shape[:-1]
    expand = (slice(None),) * len(lead) + (None,) * len(shape)
    k1, k2 = key[..., 0][expand], key[..., 1][expand]
    return threefry2x32(k1, k2, 0, _iota(shape, key.device))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` (vmapped over leading axes):
    (..., 2) -> (..., num, 2)."""
    b1, b2 = _hash_iota(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` for 32 bits: (..., *shape) int64 in
    ``[0, 2**32)``."""
    b1, b2 = _hash_iota(key, shape)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    bits = random_bits(key, shape)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    # the bounds and their difference rounded to float32 on the host, as
    # JAX converts them, and passed as numbers: a tensor made from a host
    # number on the card would be a blocking copy on every call
    lo = float(np.float32(minval))
    scale = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp_min(floats * scale + lo, lo)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` in mode "low" (float32)."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0)))
