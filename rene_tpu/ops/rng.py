"""Vectorized PCG32si RNG (32-bit state, RXS-M-XS output).

Bitwise-compatible port of the reference's device RNG
(/root/reference/rene-shader/src/rand.rs:4-54), vectorized over uint32 state
arrays so every ray lane carries its own stream. All ops are lane-wise
integer math.

Functional style: every draw returns (value, new_state).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# numpy scalars, not jax arrays: a module-level jax array closed over by
# jitted code becomes a hoisted constant, and JAX 0.9's dispatch fast path
# drops such constants on the second call of a later jit that shares
# them ("Execution supplied N buffers but compiled program expected M")
_MULT = np.uint32(747796405)
_INC = np.uint32(2891336453)
_OUT_MULT = np.uint32(277803737)


def _step(state):
    return (state * _MULT + _INC).astype(jnp.uint32)


def _output(state):
    shift = (state >> jnp.uint32(28)) + jnp.uint32(4)
    word = ((state >> shift) ^ state) * _OUT_MULT
    return ((word >> jnp.uint32(22)) ^ word).astype(jnp.uint32)


def pcg_init(seed):
    """PCG32si::new: step, add seed, step (rand.rs:24-30)."""
    seed = jnp.asarray(seed, dtype=jnp.uint32)
    state = _step(seed)
    state = (state + seed).astype(jnp.uint32)
    return _step(state)


def next_u32(state):
    return _output(state), _step(state)


def next_f32(state):
    """24-bit-mantissa uniform in [0,1) (rand.rs:38-47)."""
    u, state = next_u32(state)
    value = (u >> jnp.uint32(8)).astype(jnp.float32)
    return value * jnp.float32(1.0 / (1 << 24)), state


def next_f32_range(state, lo, hi):
    u, state = next_f32(state)
    return lo + (hi - lo) * u, state
