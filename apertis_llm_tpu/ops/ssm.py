"""Selective-SSM primitives: associative scan + depthwise causal conv.

The Apertis selective mixer's recurrence (reference: src/model/core.py:337-353)
is, per batch/head/state-channel:

    h_t = Abar_t * h_{t-1} + B_t          y_t = C_t * h_t

with ``Abar_t = exp(delta_t * A)``, ``A = -exp(A_log)`` diagonal. Note the
reference feeds the *projected* B directly as the recurrence input — the raw
``u`` activations enter only through the projection that produced B — and this
behaviour is preserved exactly.

The training-time scan here uses a numerically sound first-order linear
associative operator

    (a2, b2) o (a1, b1) = (a1*a2, a2*b1 + b2)

instead of the reference's cumsum-of-logs / cumulative-divide trick
(core.py:324-335), which underflows for long sequences. The carry runs in
float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp


def _combine(left, right):
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, a2 * b1 + b2


def selective_scan(
    a_bar: jnp.ndarray,   # (B, H, L, N) decay factors in (0, 1]
    b_term: jnp.ndarray,  # (B, H, L, N) recurrence inputs
    h_init: Optional[jnp.ndarray] = None,  # (B, H, N) carried state
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """All-timestep hidden states via parallel scan.

    Returns ``(h, h_last)`` with ``h`` of shape (B, H, L, N) and ``h_last``
    the final carry (B, H, N) for chunked/sequence-parallel composition.
    """
    dtype = b_term.dtype
    a = a_bar.astype(jnp.float32)
    b = b_term.astype(jnp.float32)
    if h_init is not None:
        # Fold the carried state into the first step: b_0' = a_0 * h_init + b_0
        b = b.at[:, :, 0, :].add(a[:, :, 0, :] * h_init.astype(jnp.float32))
    _, h = jax.lax.associative_scan(_combine, (a, b), axis=2)
    return h.astype(dtype), h[:, :, -1, :].astype(dtype)


def ssm_mix(
    delta: jnp.ndarray,     # (B, L, H) float32 softplus'd timescales
    a_cont: jnp.ndarray,    # (H, N) float32 continuous-time A (negative)
    b_term: jnp.ndarray,    # (B, L, H, N) recurrence inputs
    c_mod: jnp.ndarray,     # (B, L, H, N) output gates
    seq_mask: Optional[jnp.ndarray] = None,  # (B, L) 1 = real token
    out_dtype=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fused selective mixer: ``y = C * scan(exp(delta*A), B)``.

    The full-sequence SSM hot path (prefill + training). Returns
    ``(y, h_last)`` with ``y`` of shape (B, L, H*N) in ``out_dtype``
    (default ``b_term.dtype``) and ``h_last`` (B, H, N) float32.

    Masked (padded) steps become identity transitions (a=1, b=0) so
    ``h_last`` equals the state after the last real token (reference
    recurrence: src/model/core.py:324-353).
    """
    b, l, h, n = b_term.shape
    out_dtype = jnp.dtype(out_dtype or b_term.dtype)
    # Scan over axis 1 in the natural layout (associative_scan is
    # layout-agnostic, so nothing is transposed).
    a_bar = jnp.exp(delta.astype(jnp.float32)[..., None]
                    * a_cont.astype(jnp.float32))               # (B, L, H, N)
    bb = b_term.astype(jnp.float32)
    if seq_mask is not None:
        m = seq_mask[:, :, None, None].astype(jnp.float32)
        a_bar = a_bar * m + (1.0 - m)
        bb = bb * m
    _, hs = jax.lax.associative_scan(_combine, (a_bar, bb), axis=1)
    y = (c_mod.astype(jnp.float32) * hs).reshape(b, l, h * n)
    return y.astype(out_dtype), hs[:, -1]


def selective_scan_step(
    h: jnp.ndarray,      # (B, H, N) previous state
    a_bar_t: jnp.ndarray,  # (B, H, N)
    b_t: jnp.ndarray,      # (B, H, N)
) -> jnp.ndarray:
    """One recurrence step for decode: h_t = Abar_t * h + B_t."""
    return a_bar_t * h + b_t


def depthwise_causal_conv(
    x: jnp.ndarray,  # (B, L, C)
    weight: jnp.ndarray,  # (C, K) per-channel taps, torch Conv1d layout squeezed
    bias: Optional[jnp.ndarray] = None,  # (C,)
) -> jnp.ndarray:
    """Causal depthwise conv: out[t] = sum_j w[j] * x[t - K + 1 + j] (+ bias).

    Matches torch ``Conv1d(C, C, K, groups=C, padding=K-1)`` truncated to the
    first L outputs (reference: core.py:308-312, 373). K is small (default 4)
    so the unrolled shifted-sum fuses into one elementwise pass.
    """
    k = weight.shape[-1]
    pad = jnp.pad(x, ((0, 0), (k - 1, 0), (0, 0)))
    l = x.shape[1]
    out = jnp.zeros_like(x)
    for j in range(k):
        out = out + pad[:, j:j + l, :] * weight[:, j]
    if bias is not None:
        out = out + bias
    return out


def depthwise_conv_step(
    conv_state: jnp.ndarray,  # (B, K-1, C) trailing inputs
    x_t: jnp.ndarray,         # (B, C) current input
    weight: jnp.ndarray,      # (C, K)
    bias: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Single-token causal conv using the carried window.

    Returns ``(y_t, new_conv_state)``.
    """
    window = jnp.concatenate([conv_state, x_t[:, None, :]], axis=1)  # (B, K, C)
    y = jnp.einsum("bkc,ck->bc", window, weight)
    if bias is not None:
        y = y + bias
    return y, window[:, 1:, :]
