"""The frame's counter-based random numbers, written out from their
definition (the reference renderer's shaders/random.glsl:34-102, which
the JAX package's ops/rng.py follows): a pixel is seeded with
tea(pixel index, frame word), and each draw advances a 32-bit PCG state
and takes the top 23 bits of its output as a float in [0, 1).

Words are uint32 values held in int64 tensors, masked after every step.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def tea(v0, v1, rounds: int = 16):
    """TEA hash of two words (random.glsl:34-48)."""
    v0, v1 = torch.broadcast_tensors(v0 & M32, v1 & M32)
    s = 0
    for _ in range(rounds):
        s = (s + 0x9E3779B9) & M32
        v0 = (v0 + ((((v1 << 4) + 0xA341316C) & M32) ^ ((v1 + s) & M32)
                    ^ (((v1 >> 5) + 0xC8013EA4) & M32))) & M32
        v1 = (v1 + ((((v0 << 4) + 0xAD90777D) & M32) ^ ((v0 + s) & M32)
                    ^ (((v0 >> 5) + 0x7E95761E) & M32))) & M32
    return v0


def rand(state):
    """(next state, a float64 in [0, 1)): the LCG step, PCG's output
    permutation, the word's top 23 bits over 2^23 (random.glsl:59-102)."""
    state = (state * 747796405 + 2891336453) & M32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & M32
    word = (word >> 22) ^ word
    return state, (word >> 9).to(torch.float64) / float(1 << 23)


def seed_pixels(h: int, w: int, frame_word: int, device):
    """The (h, w) seeds of a frame: tea(row * w + column, frame word)."""
    idx = torch.arange(h * w, dtype=torch.int64, device=device).reshape(h, w)
    return tea(idx, torch.tensor(int(frame_word) & M32, dtype=torch.int64,
                                 device=device))
