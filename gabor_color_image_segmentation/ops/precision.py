"""Shared matmul-precision policy (single source of truth).

On the GPU a float32 matmul or convolution at ``Precision.DEFAULT`` may run
in TF32, which keeps about three decimal digits; XLA's CPU backend computes
it in full f32. Policy, per operand dtype:

* float32 operands (parity mode, and the exact-f32 score, affinity and
  init paths) -> ``Precision.HIGHEST`` on every dot and convolution
* bfloat16 operands (production mode) -> ``Precision.DEFAULT``: the
  rounding already happened, and the products accumulate in f32

tests/test_precision.py lowers each preset in float32 and fails if any f32
dot or convolution is left at DEFAULT.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST
DEFAULT = jax.lax.Precision.DEFAULT


def precision_for(dtype) -> jax.lax.Precision:
    """HIGHEST for f32 compute dtype (parity-grade), DEFAULT for bf16."""
    return HIGHEST if dtype == jnp.float32 else DEFAULT
