"""Deterministic, restart-safe synthetic data (counterpart of
``repro.data.pipeline``): every batch is a pure function of ``(seed,
step)``, so a restarted job replays the exact token stream from any
checkpointed step with no pipeline state to persist.

The tokens are a mixture of Markov chains with 10 % noise, so losses have
structure to learn. The stream is the reference's, bit for bit in
``tokens`` and ``labels``: the reference draws it with ``jax.random``
(threefry2x32, the partitionable key derivation of ``jax_threefry_
partitionable=True``), which this module replays in numpy: ``PRNGKey``,
``fold_in``, ``split``, the 32-bit random bits, ``randint``'s two-draw
multiply-mod and ``uniform``'s mantissa fill, every value a uint32 held in
a uint64 and masked. ``embeds`` and ``vision`` are ``0.02 * normal``,
which JAX computes as ``sqrt(2) * erfinv(u)`` with XLA's f32 erfinv (Giles'
polynomial); here the same polynomial runs in numpy f32, whose ``log1p``
and roundings differ from XLA's in the last place, so those two agree with
the reference within ~1e-8, not bit for bit. The batch is made on the host
and moved to ``device``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.config import resolve_device

_M32 = np.uint64(0xFFFFFFFF)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# XLA's f32 erfinv (Giles, "Approximating the erfinv function"): the
# polynomial in w - 2.5 for w = -log1p(-x^2) < 5, in sqrt(w) - 3 beyond
_ERFINV_W_LT5 = np.array([
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941],
    np.float32)
_ERFINV_W_GE5 = np.array([
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682],
    np.float32)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    batch: int = 8
    seq_len: int = 128
    n_chains: int = 7  # markov mixture size


def _u32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.uint64) & _M32


def _threefry2x32(key, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x1, x2)
    under ``key`` = (k1, k2); uint32 values in uint64 arrays."""
    k1, k2 = _u32(key[0]), _u32(key[1])
    ks = (k1, k2, k1 ^ k2 ^ np.uint64(0x1BD11BDA))
    a, b = (_u32(x1) + ks[0]) & _M32, (_u32(x2) + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M32
            b = ((b << np.uint64(r)) | (b >> np.uint64(32 - r))) & _M32
            b = a ^ b
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + np.uint64(i + 1)) & _M32
    return a, b


def prng_key(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2**31: (0, seed)."""
    return (np.uint64(0), _u32(seed))


def fold_in(key: tuple, data: int) -> tuple:
    a, b = _threefry2x32(key, 0, int(data) & 0xFFFFFFFF)
    return (a, b)


def split(key: tuple, num: int) -> list:
    a, b = _threefry2x32(key, np.zeros(num, np.uint64),
                         np.arange(num, dtype=np.uint64))
    return [(a[i], b[i]) for i in range(num)]


def random_bits(key: tuple, shape) -> np.ndarray:
    """32 random bits a slot: the hash of the flat slot index."""
    size = int(np.prod(shape))
    a, b = _threefry2x32(key, np.zeros(size, np.uint64),
                         np.arange(size, dtype=np.uint64))
    return (a ^ b).reshape(shape)


def randint(key: tuple, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint`` (int32): two 32-bit draws folded mod the span;
    every product wraps at 2**32 as the reference's uint32 arithmetic."""
    k1, k2 = split(key, 2)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    span = np.uint64(max(maxval - minval, 1))
    mult = np.uint64(2 ** 16) % span
    mult = ((mult * mult) & _M32) % span
    off = (((hi % span) * mult) & _M32) + lo % span
    off = (off & _M32) % span
    return (minval + off.astype(np.int64)).astype(np.int32)


def uniform(key: tuple, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform`` in f32: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled and shifted in f32."""
    bits = (random_bits(key, shape) >> np.uint64(9)) | np.uint64(0x3F800000)
    floats = bits.astype(np.uint32).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


def _erfinv32(x: np.ndarray) -> np.ndarray:
    w = -np.log1p(-x * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    p = np.where(lt, _ERFINV_W_LT5[0], _ERFINV_W_GE5[0])
    for c_lt, c_ge in zip(_ERFINV_W_LT5[1:], _ERFINV_W_GE5[1:]):
        p = np.where(lt, c_lt, c_ge) + p * w
    return np.where(np.abs(x) == 1, x * np.finfo(np.float32).max, p * x)


def normal(key: tuple, shape) -> np.ndarray:
    """``jax.random.normal`` in f32: sqrt(2) * erfinv(u) for u uniform in
    (-1, 1)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return np.float32(np.sqrt(2)) * _erfinv32(uniform(key, shape, lo, 1.0))


def make_batch(dcfg: DataConfig, step: int, vocab: int,
               embeddings_in: bool = False, d_model: int = 0,
               n_vision_tokens: int = 0, device=None) -> dict:
    """The batch for ``step``: {"tokens" | "embeds", "labels"[, "vision"]}
    on ``device`` (None = the CUDA card); tokens and labels int32."""
    dev = resolve_device(device)
    key = fold_in(prng_key(dcfg.seed), step)
    k1, k2, k3, k4 = split(key, 4)
    B, S = dcfg.batch, dcfg.seq_len
    # mixture-of-chains tokens: x_{t+1} = (a_c * x_t + b_c) mod vocab
    chain = randint(k1, (B,), 0, dcfg.n_chains).astype(np.int64)
    a, b = 1 + 2 * chain, 3 + 5 * chain  # odd multipliers
    x = randint(k2, (B,), 0, vocab).astype(np.int64)
    toks = np.empty((B, S + 1), np.int64)
    for t in range(S + 1):
        x = (a * x + b) % vocab
        toks[:, t] = x
    noise = uniform(k3, (B, S + 1)) < np.float32(0.1)  # bernoulli(0.1)
    rand = randint(k4, (B, S + 1), 0, vocab)
    toks = np.where(noise, rand, toks).astype(np.int32)
    batch = {"labels": toks[:, 1:]}
    if embeddings_in:
        emb = normal(fold_in(key, 17), (B, S, d_model))
        batch["embeds"] = np.float32(0.02) * emb
    else:
        batch["tokens"] = toks[:, :-1]
    if n_vision_tokens:
        vis = normal(fold_in(key, 23), (B, n_vision_tokens, d_model))
        batch["vision"] = np.float32(0.02) * vis
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


def batch_for(cfg: ModelConfig, dcfg: DataConfig, step: int,
              device=None) -> dict:
    return make_batch(dcfg, step, cfg.vocab, cfg.embeddings_in, cfg.d_model,
                      cfg.n_vision_tokens, device=device)
