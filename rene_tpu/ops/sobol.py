"""Padded 2D Sobol sampler with hash-based Owen scrambling.

A replacement for the `Sampler "sobol"` directive the
reference parses-and-ignores (rene/src/scene.rs:120-122): per sampling
decision (a "pair": camera jitter, one bounce's BSDF (u1,u2), one
bounce's NEE point, ...) every pixel draws the SAME base (0,2)-sequence
point — dimension 1 is van der Corput, dimension 2 the classic Sobol
direction numbers — with a per-(pixel, pair, chunk) hash-based Owen
scramble and an Owen shuffle of the sample index (Burley,
"Practical Hash-based Owen Scrambling", JCGT 2020). Padding 2D points
this way keeps each decision's samples (0,2)-stratified while the
scramble decorrelates pixels and pairs; distinct render chunks fold
their seed into the hash, giving independent Owen realizations
(unbiased across chunks, stratified within one).

Everything is XOR / AND / shifts / uint32 multiply-add + the mantissa
bitcast. The integrators do not call it yet (ROADMAP R2): they sample
independently and warn on `Sampler "sobol"`.
"""
from __future__ import annotations

import numpy as np

import jax.numpy as jnp


def _sobol2_dirs():
    """32 direction numbers of Sobol dimension 2 (poly x+1) as 32-bit
    binary fractions, MSB-aligned."""
    m = np.zeros(32, np.uint64)
    m[0] = 1
    for i in range(1, 32):
        m[i] = m[i - 1] ^ (m[i - 1] << 1)
        m[i] &= (1 << (i + 1)) - 1
    return [int(m[i] << (31 - i)) for i in range(32)]


SOBOL2_DIRS = _sobol2_dirs()
# sample indices are < 2^16 in practice (spp chunks); the ladders stop
# at 16 steps to halve the op count
INDEX_BITS = 16


def reverse32(x):
    """Bitwise reversal of uint32 (5-step shift-mask ladder)."""
    x = ((x & jnp.uint32(0x55555555)) << jnp.uint32(1)) \
        | ((x >> jnp.uint32(1)) & jnp.uint32(0x55555555))
    x = ((x & jnp.uint32(0x33333333)) << jnp.uint32(2)) \
        | ((x >> jnp.uint32(2)) & jnp.uint32(0x33333333))
    x = ((x & jnp.uint32(0x0F0F0F0F)) << jnp.uint32(4)) \
        | ((x >> jnp.uint32(4)) & jnp.uint32(0x0F0F0F0F))
    x = ((x & jnp.uint32(0x00FF00FF)) << jnp.uint32(8)) \
        | ((x >> jnp.uint32(8)) & jnp.uint32(0x00FF00FF))
    return (x << jnp.uint32(16)) | (x >> jnp.uint32(16))


def hash_u32(x):
    """finalizer-style uint32 hash (xxhash/murmur avalanche constants)."""
    x = x ^ (x >> jnp.uint32(16))
    x = x * jnp.uint32(0x85EBCA6B)
    x = x ^ (x >> jnp.uint32(13))
    x = x * jnp.uint32(0xC2B2AE35)
    return x ^ (x >> jnp.uint32(16))


def _laine_karras(x, seed):
    """Laine-Karras style hash: scrambles the LOW bits of x with a
    per-`seed` permutation that is Owen-uniform after reversal."""
    x = x + seed
    x = x ^ (x * jnp.uint32(0x6C50B47C))
    x = x ^ (x * jnp.uint32(0xB82F1E52))
    x = x ^ (x * jnp.uint32(0xC7AFE638))
    x = x ^ (x * jnp.uint32(0x8D22F6E6))
    return x


def owen_scramble(v, seed):
    """Nested uniform (Owen) scramble of a 32-bit fraction v."""
    return reverse32(_laine_karras(reverse32(v), seed))


def sobol2_16(idx):
    """Dimension-2 Sobol value of `idx` (< 2^16) as a 32-bit fraction."""
    y = idx * jnp.uint32(0)
    for b in range(INDEX_BITS):
        bit = (idx >> jnp.uint32(b)) & jnp.uint32(1)
        y = y ^ (bit * jnp.uint32(SOBOL2_DIRS[b]))
    return y


def ld2_bits(idx, key):
    """Owen-scrambled (0,2)-sequence point as a pair of uint32
    fractions. `idx`: per-pixel sample number (< 2^16); `key`: hash
    input mixing (pixel, pair id, chunk seed).

    The index first gets a per-key Owen SHUFFLE (rev-LK-rev, Burley
    2020): it is MSB-triangular on the index so aligned dyadic index
    blocks map to aligned blocks (any such block of a (0,2)-sequence
    is a net — per-pair stratification survives), and — unlike an XOR
    digital shift, which is linear and merely composes into the value
    scramble (measured: cross-key value correlation stays ±0.78) — it
    is NONLINEAR, so conjugated through the generator matrices it
    genuinely re-pairs the two pads' sample sets and restores the
    variance reduction padding is supposed to give."""
    sidx = reverse32(_laine_karras(
        reverse32(idx), hash_u32(key ^ jnp.uint32(0x9E3779B9)))) \
        & jnp.uint32((1 << INDEX_BITS) - 1)
    # dim 1 = van der Corput: bit-reverse the index
    u = owen_scramble(reverse32(sidx), hash_u32(key))
    v = owen_scramble(sobol2_16(sidx),
                      hash_u32(key ^ jnp.uint32(0x6A09E667)))
    return u, v
