"""Normalisation layers (functional).

Parity notes:
  * RMSNorm follows the reference formulation ``x / (||x||_2 / sqrt(D) + eps)``
    — the epsilon is added to the RMS value itself, not to the variance
    (reference: src/model/core.py:30-59).
  * LayerNorm matches torch.nn.LayerNorm semantics (biased variance, eps under
    the sqrt) with weight+bias.

Both run in float32 internally and cast back, which keeps bf16 activations
stable without a separate mixed-precision wrapper.
"""

from __future__ import annotations

import jax.numpy as jnp


def rms_norm(x: jnp.ndarray, scale: jnp.ndarray, eps: float = 1e-6) -> jnp.ndarray:
    dtype = x.dtype
    xf = x.astype(jnp.float32)
    # RMS = ||x||_2 / sqrt(D); epsilon added to the RMS, not the variance.
    #
    # All-zero rows are routine in training: the pad embedding row is
    # zero-initialised (reference: core.py:1051) and selective-SSM layers
    # propagate exact zeros at trailing pad positions. torch's ``x.norm()``
    # defines the subgradient at the origin as 0, but a naive
    # ``sqrt(sum(x^2))`` has infinite slope there and NaNs the whole
    # backward pass — guard the sqrt so the gradient at 0 is 0 (forward
    # values are bit-identical: sqrt(0) was already 0).
    # The division is factored through an inverse that is EXACTLY ZERO on
    # all-zero rows: the forward is unchanged (0 * anything = 0 there), but
    # the backward's d out/d x picks up the zero factor instead of
    # scale/eps ≈ 1e6. Without this, pad rows (zero-initialised embedding,
    # zeros propagated by the SSM residual stream) amplify cotangents by
    # 1/eps per layer and overflow fp32 within two MoE layers — the
    # reference's formulation has the same latent explosion; it only never
    # trains on padded batches in its own tests.
    ss = jnp.sum(xf * xf, axis=-1, keepdims=True)
    rms = jnp.where(ss > 0, jnp.sqrt(jnp.where(ss > 0, ss, 1.0)), 0.0)
    rms = rms * (x.shape[-1] ** -0.5)
    inv = jnp.where(ss > 0, 1.0 / (rms + eps), 0.0)
    out = xf * inv * scale.astype(jnp.float32)
    return out.astype(dtype)


def layer_norm(
    x: jnp.ndarray,
    weight: jnp.ndarray,
    bias: jnp.ndarray,
    eps: float = 1e-12,
) -> jnp.ndarray:
    dtype = x.dtype
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(xf - mean), axis=-1, keepdims=True)
    # Constant rows (var == 0, e.g. exact-zero pad rows): the normalised
    # term is 0 either way, but rsqrt(eps) ≈ 1e6 would scale the backward;
    # a zero inverse keeps the forward identical and the gradient bounded
    # (see rms_norm above for the failure mode this prevents).
    inv = jnp.where(var > 0, jnp.reciprocal(jnp.sqrt(var + eps)), 0.0)
    out = (xf - mean) * inv
    out = out * weight.astype(jnp.float32) + bias.astype(jnp.float32)
    return out.astype(dtype)
