"""Seeds: every random stream of a run derives from ``--seed`` and a tag."""

from __future__ import annotations

import hashlib

import torch


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of run ``seed`` (any integer,
    negative or past 64 bits included)."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, tag))
    return g
