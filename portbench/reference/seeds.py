"""Dropout bits worked out from a step's seed.

The program keys every dropout site by the step's seed folded with the
site's place in the model (splitmix64 steps, :func:`fold_seed`). Hidden
dropout draws u8 bits with ``torch.randint`` from a ``torch.Generator`` on
the device seeded with the site's seed; the training attention's keep mask
is a Philox4x32-10 function of (site seed, sample, head, query row, key
column), element j taking byte j % 16 of the call counted by column // 16
(Salmon et al., SC'11)."""
from __future__ import annotations

import torch

M64 = 0xFFFFFFFFFFFFFFFF
_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def fold_seed(seed: int | None, *path: int) -> int | None:
    """``seed`` folded with each integer of ``path`` (None stays None)."""
    if seed is None:
        return None
    x = seed & M64
    for p in path:
        z = (x ^ ((p + 1) * 0x9E3779B97F4A7C15)) & M64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & M64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & M64
        x = z ^ (z >> 31)
    return x


def keep_threshold(rate: float) -> int:
    """The u8 threshold t: keep where the bits are below t."""
    if rate <= 0.0:
        return 256
    return max(int(round((1.0 - rate) * 256.0)), 1)


def hidden_keep(seed: int, shape, t: int, device) -> torch.Tensor:
    """Bool keep mask of a hidden dropout site of ``shape`` at threshold t."""
    g = torch.Generator(device).manual_seed(seed)
    bits = torch.randint(0, 256, tuple(shape), generator=g, device=device,
                         dtype=torch.uint8)
    return bits < t


def _mulhilo(a: int, b: torch.Tensor):
    t_lo = a * (b & 0xFFFF)
    t_hi = a * (b >> 16)
    lo = (t_lo + ((t_hi & 0xFFFF) << 16)) & _M32
    hi = (t_hi + (t_lo >> 16)) >> 16
    return hi, lo


def philox(c0, c1, c2, c3, seed: int):
    """Philox4x32-10 on int64 tensors of 32-bit counter words; the key is
    the 64-bit seed, low word first."""
    k0, k1 = seed & _M32, (seed >> 32) & _M32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def attention_keep(seed: int, B: int, H: int, S: int, t: int,
                   device) -> torch.Tensor:
    """Bool [B, H, S, S] keep mask of the training attention."""
    G = -(-S // 16)

    def axis(n, dim):
        shape = [1, 1, 1, 1]
        shape[dim] = n
        return torch.arange(n, device=device, dtype=torch.int64).view(shape)

    words = philox(axis(G, 3), axis(S, 2), axis(H, 1), axis(B, 0), seed & M64)
    w = torch.stack([x.expand(B, H, S, G) for x in words], -1)
    shifts = torch.arange(0, 32, 8, device=device, dtype=torch.int64)
    bits = (w[..., None] >> shifts) & 0xFF
    return bits.reshape(B, H, S, G * 16)[..., :S] < t
