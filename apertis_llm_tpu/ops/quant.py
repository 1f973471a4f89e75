"""int8 serving matmuls in plain XLA.

Quantized linears store ``{w_q: int8 (K, N), w_s: (1, N)}`` with symmetric
per-output-channel scales (models/quantize.py). Two ways to multiply by
them:

  * weight-only: ``x @ (w_q * w_s)`` in the activation dtype, the product
    on the bf16 tensor cores;
  * dynamic int8 (:func:`quant_matmul_dyn_xla`): per-row symmetric int8
    activations, ``int8 x int8 -> int32`` on the int8 tensor cores, scales
    applied once at the end (~0.5% activation rounding error).

``APERTIS_QUANT_MATMUL=auto`` (default) picks by row count
(:func:`use_dyn`); ``weightonly`` and ``dyn`` pin one path. MoE prefill's
grouped matmuls (``ops/moe.moe_ragged``) are the exception: weight-only
unless the mode is ``dyn``.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

# Row count from which ``auto`` takes the dynamic int8 dot. On the H100, in
# a compiled chain of 20 of the flagship's FFN layers (PERF.md, PR 1),
# weight-only was as fast or faster from 64 to 1,024 rows (13-15% at 512
# and 1,024) and dynamic int8 faster from 2,048 rows (6%) to 8,192 (23%).
DYN_MIN_ROWS = 2048


def quant_mode() -> str:
    """``APERTIS_QUANT_MATMUL``: ``auto`` | ``weightonly`` | ``dyn``."""
    mode = os.environ.get("APERTIS_QUANT_MATMUL", "auto")
    if mode not in ("auto", "weightonly", "dyn"):
        raise ValueError(f"APERTIS_QUANT_MATMUL={mode!r}: expected auto, "
                         "weightonly or dyn")
    return mode


def use_dyn(rows: int) -> bool:
    """Whether an int8 matmul over ``rows`` activation rows takes the
    dynamic int8 dot (else weight-only dequant)."""
    mode = quant_mode()
    return mode == "dyn" or (mode == "auto" and rows >= DYN_MIN_ROWS)


def quantize_rows(x: jnp.ndarray):
    """Symmetric per-row int8: x ~= x_q * x_s, scales over the K axis."""
    absmax = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=-1, keepdims=True)
    scale = jnp.maximum(absmax, 1e-8) / 127.0
    q = jnp.clip(jnp.round(x.astype(jnp.float32) / scale),
                 -127, 127).astype(jnp.int8)
    return q, scale


@jax.custom_vjp
def quant_matmul_dyn_xla(x: jnp.ndarray, w_q: jnp.ndarray, w_s: jnp.ndarray):
    """x (..., K) @ dequant(w_q (K, N), w_s) through XLA's int8 dot:
    per-row quantize x, ``lax.dot_general(int8, int8) -> int32``, scale
    once."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    x_q, x_s = quantize_rows(x2)
    acc = jax.lax.dot_general(
        x_q, w_q, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)
    out = (acc.astype(jnp.float32) * x_s
           * w_s.reshape(1, -1).astype(jnp.float32)).astype(x.dtype)
    return out.reshape(*lead, w_q.shape[-1])


def _dyn_fwd(x, w_q, w_s):
    return quant_matmul_dyn_xla(x, w_q, w_s), (x, w_q, w_s)


def _dyn_bwd(res, g):
    x, w_q, w_s = res
    # Quantized weights are serving weights: dx flows through the
    # dequantized weight and the weights get zero cotangents.
    w = w_q.astype(g.dtype) * w_s.reshape(1, -1).astype(g.dtype)
    return g @ w.T, jnp.zeros_like(w_q), jnp.zeros_like(w_s)


quant_matmul_dyn_xla.defvjp(_dyn_fwd, _dyn_bwd)
