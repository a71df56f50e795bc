"""Counter-based random numbers, bit-equal to ``jax.random``'s default
threefry2x32 implementation for the calls the stitcher makes:
``PRNGKey(seed)``, ``fold_in(key, data)`` and ``uniform(key, shape)``
(float32 in [0, 1)), with ``jax_threefry_partitionable`` on — the default
since JAX 0.5.0, which is how ``random_bits`` lays counters out below.

RANSAC draws its hypotheses from these, so the port samples the same
4-point sets as the JAX package; with another generator the fits land in
other near-tied consensus basins.

Keys are int64 tensors of two 32-bit words [hi, lo]. Words are carried in
int64 and masked to 32 bits after every add and shift, because PyTorch has
no full uint32 arithmetic. A key may live on the host or on the device:
the edge plan (``models/registration.py::plan_rows``) folds its edge ids
into a key on the card (``fold_in`` takes the data as a tensor), so its
CUDA graph depends on no edge's value, as the JAX package's scan depends
on none; a host key drawing counters on the card gives its words as
Python ints, so nothing is uploaded. The bits are the same either way.
"""
from __future__ import annotations

import torch

from ..core.programs import const

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def _key_schedule(key: torch.Tensor, like: torch.Tensor):
    """Threefry's key words (k0, k1, k0 ^ k1 ^ C240): Python ints for a
    host key and counters on the card (no upload), else 0-dim tensors on
    the counters' device (a key on the card never comes to the host)."""
    if key.device.type == "cpu" and like.device.type != "cpu":
        k0 = int(key[0]) & _M32
        k1 = int(key[1]) & _M32
        return k0, k1, k0 ^ k1 ^ 0x1BD11BDA
    k = key.to(like.device) & _M32
    return k[0], k[1], k[0] ^ k[1] ^ 0x1BD11BDA


def threefry2x32(key: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011) on counter words
    (x0, x1) under ``key`` — the block function of jax.random."""
    ks = _key_schedule(key, x0)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: [0, seed]."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64)


def prng_key_on(seed: int, device) -> torch.Tensor:
    """``prng_key(seed)`` on ``device``, uploaded once and cached
    (``core/programs.py::const``): what a program reads. Never write into
    it."""
    return const([0, int(seed) & _M32], torch.int64, device)


def fold_in(key: torch.Tensor, data: int | torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: threefry of the counter pair
    [0, data] under ``key``, on the key's device. ``data``: an int, or an
    integer tensor of one element (its low 32 bits, as JAX's uint32), read
    on the device."""
    if isinstance(data, torch.Tensor):
        x1 = data.to(device=key.device, dtype=torch.int64).reshape(1) & _M32
    else:
        x1 = torch.tensor([int(data) & _M32], dtype=torch.int64,
                          device=key.device)
    y0, y1 = threefry2x32(key, torch.zeros_like(x1), x1)
    return torch.cat([y0, y1])


def random_bits(key: torch.Tensor, shape: tuple[int, ...],
                device: torch.device | str = "cpu") -> torch.Tensor:
    """32-bit words of ``jax.random.bits(key, shape)`` (partitionable
    layout: element i hashes the 64-bit counter i; the two output words
    are xored). Returned in int64."""
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key, (idx >> 32) & _M32, idx & _M32)
    return (y0 ^ y1).reshape(shape)


def uniform(key: torch.Tensor, shape: tuple[int, ...],
            device: torch.device | str = "cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1) from the top
    23 bits of each word, as 1.xxx - 1."""
    bits = random_bits(key, shape, device)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0
