"""Multi-head attention compute paths.

Entry points:
  * :func:`mha` — plain XLA softmax attention with an additive mask; the
    parity oracle. (Fused attention, ``use_flash_attention``, is
    ``jax.nn.dot_product_attention``; see models/apertis._mha_full.)
  * :func:`decode_attention` — single-query attention against a preallocated
    KV cache with a length mask; the hot op of autoregressive decode.

The causal-mask convention matches the reference's cached-decode offset: query
``i`` (within the current block) at absolute position ``kv_len - q_len + i``
may attend key ``j`` iff ``kv_len - q_len + i >= j``
(reference: src/model/core.py:793-830).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp


NEG_INF = float(jnp.finfo(jnp.float32).min)


def causal_mask_bias(q_len: int, kv_len: int, dtype=jnp.float32) -> jnp.ndarray:
    """Additive (q_len, kv_len) causal bias with decode offset."""
    rows = jnp.arange(q_len)[:, None] + (kv_len - q_len)
    cols = jnp.arange(kv_len)[None, :]
    allowed = rows >= cols
    return jnp.where(allowed, 0.0, NEG_INF).astype(dtype)


def mha(
    q: jnp.ndarray,  # (B, H, Lq, Dh)
    k: jnp.ndarray,  # (B, H, Lkv, Dh)
    v: jnp.ndarray,  # (B, H, Lkv, Dh)
    bias: Optional[jnp.ndarray] = None,  # additive, broadcastable to (B, H, Lq, Lkv)
    causal: bool = True,
) -> jnp.ndarray:
    """Softmax attention; returns (B, H, Lq, Dh). Scores in float32."""
    head_dim = q.shape[-1]
    scale = head_dim ** -0.5
    scores = jnp.einsum(
        "bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32) * scale
    if bias is not None:
        scores = scores + bias.astype(jnp.float32)
    elif causal and q.shape[2] > 1:
        scores = scores + causal_mask_bias(q.shape[2], k.shape[2])
    probs = jnp.exp(scores - jnp.max(scores, axis=-1, keepdims=True))
    probs = probs / jnp.sum(probs, axis=-1, keepdims=True)
    probs = probs.astype(v.dtype)
    return jnp.einsum("bhqk,bhkd->bhqd", probs, v,
                      preferred_element_type=jnp.float32).astype(v.dtype)


def mha_with_probs(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    bias: Optional[jnp.ndarray] = None,
    causal: bool = True,
):
    """As :func:`mha` but also returns the attention probabilities (for
    ``output_attentions`` parity)."""
    head_dim = q.shape[-1]
    scale = head_dim ** -0.5
    scores = jnp.einsum(
        "bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32) * scale
    if bias is not None:
        scores = scores + bias.astype(jnp.float32)
    elif causal and q.shape[2] > 1:
        scores = scores + causal_mask_bias(q.shape[2], k.shape[2])
    probs = jnp.exp(scores - jnp.max(scores, axis=-1, keepdims=True))
    probs = probs / jnp.sum(probs, axis=-1, keepdims=True)
    out = jnp.einsum("bhqk,bhkd->bhqd", probs.astype(v.dtype), v,
                     preferred_element_type=jnp.float32).astype(v.dtype)
    return out, probs


def decode_attention(
    q: jnp.ndarray,        # (B, H, 1, Dh)
    k_cache: jnp.ndarray,  # (B, H, Lmax, Dh)
    v_cache: jnp.ndarray,  # (B, H, Lmax, Dh)
    valid: jnp.ndarray,    # (B, Lmax) bool — which cache slots may be attended
) -> jnp.ndarray:
    """Single-token attention against a fixed-size cache.

    ``valid`` combines cache occupancy and the padding mask, so the cache can
    be preallocated at ``decode_max_length`` with static shapes.
    """
    head_dim = q.shape[-1]
    scale = head_dim ** -0.5
    scores = jnp.einsum(
        "bhqd,bhkd->bhqk", q, k_cache, preferred_element_type=jnp.float32) * scale
    scores = jnp.where(valid[:, None, None, :], scores, NEG_INF)
    probs = jnp.exp(scores - jnp.max(scores, axis=-1, keepdims=True))
    probs = probs / jnp.sum(probs, axis=-1, keepdims=True)
    return jnp.einsum("bhqk,bhkd->bhqd", probs.astype(v_cache.dtype), v_cache,
                      preferred_element_type=jnp.float32).astype(v_cache.dtype)


def decode_attention_selfterm(
    q: jnp.ndarray,        # (B, H, 1, Dh)
    k_cache: jnp.ndarray,  # (B, H, Lmax, Dh) OLD cache (new slot stale)
    v_cache: jnp.ndarray,  # (B, H, Lmax, Dh)
    k_new: jnp.ndarray,    # (B, H, 1, Dh) this token's key
    v_new: jnp.ndarray,    # (B, H, 1, Dh) this token's value
    valid_cache: jnp.ndarray,  # (B, Lmax) bool; must EXCLUDE the stale slot
    k_scale: jnp.ndarray = None,  # (B, H, Lmax, 1): k_cache is int8 * scale
    v_scale: jnp.ndarray = None,  # (B, H, Lmax, 1): v_cache is int8 * scale
) -> jnp.ndarray:
    """Single-token attention over the old cache plus an explicit self-term.

    Numerically the same softmax/context as writing ``(k_new, v_new)`` into
    the cache slot and running :func:`decode_attention` with that slot valid
    (the self column just moves to the end of the reduction) — reorganised
    so a decode step never materialises an updated cache before attending:
    the serving engine writes every layer's new slot with one post-scan
    slot-column update instead (models/apertis.decode_step).

    With ``k_scale``/``v_scale`` the cache is int8 (APERTIS_QUANT_KV) and
    dequantizes EXACTLY inside the contractions: per-slot K scales multiply
    the scores after the dot (scale constant over the contracted head_dim),
    per-slot V scales fold into the probabilities before the context dot —
    the int8 payload is what streams from HBM."""
    head_dim = q.shape[-1]
    scale = head_dim ** -0.5
    acc_t = q.dtype
    scores = jnp.einsum(
        "bhqd,bhkd->bhqk", q, k_cache.astype(acc_t),
        preferred_element_type=jnp.float32) * scale
    if k_scale is not None:
        scores = scores * jnp.swapaxes(k_scale, -1, -2)  # (B, H, 1, Lmax)
    scores = jnp.where(valid_cache[:, None, None, :], scores, NEG_INF)
    self_score = jnp.einsum(
        "bhqd,bhqd->bhq", q, k_new.astype(acc_t),
        preferred_element_type=jnp.float32)[..., None] * scale  # (B, H, 1, 1)
    m = jnp.maximum(jnp.max(scores, axis=-1, keepdims=True), self_score)
    probs = jnp.exp(scores - m)
    p_self = jnp.exp(self_score - m)
    denom = jnp.sum(probs, axis=-1, keepdims=True) + p_self
    probs = probs / denom
    if v_scale is not None:
        probs = probs * jnp.swapaxes(v_scale, -1, -2)
    ctx = jnp.einsum("bhqk,bhkd->bhqd", probs.astype(acc_t),
                     v_cache.astype(acc_t),
                     preferred_element_type=jnp.float32)
    ctx = ctx + (p_self / denom) * v_new.astype(jnp.float32)
    return ctx.astype(v_new.dtype)
