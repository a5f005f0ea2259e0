"""Seeds of the run's parts, all derived from ``--seed`` (any integer)."""
from __future__ import annotations

import hashlib


def sub(seed: int, tag: str, bits: int = 63) -> int:
    """A ``bits``-bit seed for the part ``tag`` of the run keyed by ``seed``."""
    h = hashlib.blake2b(f"{int(seed)}:{tag}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") >> (64 - bits)
