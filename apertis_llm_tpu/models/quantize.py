"""Weight-only int8 quantization for serving.

Decode at serving batch sizes is bound by weight reads from device memory
(the whole parameter set streams through the chip every step). Symmetric
per-output-channel int8 storage halves that traffic; ops/quant.py holds the
matmuls that consume it.

Projection matrices inside linear-layer dicts (leaf key ``"w"``) and MoE
expert stacks (``"w1"``/``"w2"``, dequantised on use in ops/moe.py) are
quantized; embeddings (gathered, also the tied LM head — kept high
precision for logit quality), norms, biases, router, and SSM per-channel
parameters stay in their original dtype.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax.numpy as jnp

Params = Dict[str, Any]

# Linear-dict keys the quantizer is allowed to touch. Plain linears store
# 2-D "w" (stacked 3-D over layers); MoE expert stacks store 3-D "w1"/"w2"
# (E, in, out), stacked 4-D over layers — the contraction axis is -2 in
# every case, so per-output-channel scales come from the same reduction.
# "in_proj_w" is the ViT attention's bare fused-QKV weight (models/vit.py).
_QUANT_KEYS = {"w": (2, 3), "w1": (3, 4), "w2": (3, 4), "in_proj_w": (2, 3)}
# Parent names whose weights stay high-precision.
_SKIP_PARENTS = {"embed", "abs_pos", "final_norm", "pre_norm", "router",
                 "router_ln", "dt_proj", "conv", "lm_head"}
# Whole subtrees left untouched by default: the ViT runs only at prefill
# (not decode-bandwidth-bound) and reads its weights directly.
# APERTIS_QUANT_VIT=1 (or quantize_vision=True) opts the ViT in, for
# memory-constrained serving.
_SKIP_SUBTREES = {"vision", "vision_proj", "cross_modal", "encoder"}
_VISION_SUBTREES = {"vision", "vision_proj"}


def quantize_weight(w: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Symmetric per-output-channel int8: w ~= w_q * w_s.

    Scales reduce over the contraction axis (-2), so (in, out) weights get
    (1, out) scales and stacked (L, in, out) weights get (L, 1, out)."""
    absmax = jnp.max(jnp.abs(w), axis=-2, keepdims=True)
    scale = jnp.maximum(absmax, 1e-8) / 127.0
    q = jnp.clip(jnp.round(w / scale), -127, 127).astype(jnp.int8)
    return q, scale.astype(jnp.float32)


INT4_GROUP = 128  # contraction rows per packing group (see below)


def quantize_weight_int4(
        w: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Group-wise symmetric int4:
    ``w ~= unpack_int4(w_q4, w_sh) * w_s`` (w_sh = per-group shifts).

    Every (128-contraction-row group, output channel) gets its OWN
    effective scale — constrained to a power-of-two multiple of the
    channel's base scale — without giving up a single int8 dot: values store as int4 in [-7, 7], and the unpack multiplies each
    group by its shift factor ``2^e`` (e in 0..3), yielding int8 in
    [-56, 56]. With base scale = channel_absmax/56, a group whose absmax
    sits 8x below the channel max uses an 8x finer grid (up to 3 extra
    bits vs the round-4 per-channel layout); every group's grid is within
    2x of its ideal group-wise scale. The shift factors travel as an int8
    (..., in/128, out) array — 1/64 of the packed weight bytes.

    Two 4-bit values pack into one int8 byte paired WITHIN each 128-row
    contraction group: byte row ``128g + j`` (j < 64) holds contraction
    row ``128g + j`` in its low nibble and row ``128g + j + 64`` in its
    high nibble, so any contraction slice aligned to 128 rows unpacks
    independently. The contraction axis (-2) must be a multiple of 128."""
    k = w.shape[-2]
    if k % INT4_GROUP:
        raise ValueError(f"int4 contraction axis must be a multiple of "
                         f"{INT4_GROUP}, got {k}")
    lead = w.shape[:-2]
    n = w.shape[-1]
    wf = w.astype(jnp.float32)
    wg = wf.reshape(lead + (k // INT4_GROUP, INT4_GROUP, n))
    gmax = jnp.max(jnp.abs(wg), axis=-2)                  # lead+(G, n)
    cmax = jnp.max(gmax, axis=-2, keepdims=True)          # lead+(1, n)
    scale = jnp.maximum(cmax, 1e-8) / 56.0
    # Smallest e in 0..3 with 7 * scale * 2^e >= group absmax.
    e = jnp.clip(jnp.ceil(jnp.log2(jnp.maximum(gmax / (7.0 * scale), 1.0))),
                 0, 3)
    shift = jnp.exp2(e)                                   # lead+(G, n) f32
    grid = scale[..., None, :, :] * shift[..., None, :]   # lead+(G, 1, n)
    q = jnp.clip(jnp.round(wg / grid), -7, 7).astype(jnp.int32)
    q = q.reshape(lead + (k // INT4_GROUP, 2, INT4_GROUP // 2, n))
    lo, hi = q[..., 0, :, :], q[..., 1, :, :]
    packed = ((lo & 0xF) | (hi << 4)).astype(jnp.int8)
    return (packed.reshape(lead + (k // 2, n)), scale.astype(jnp.float32),
            shift.astype(jnp.int8))


def unpack_int4(packed: jnp.ndarray, shifts: jnp.ndarray = None
                ) -> jnp.ndarray:
    """Invert :func:`quantize_weight_int4`'s packing: (..., in/2, out) int8
    bytes -> (..., in, out) int8 values — in [-7, 7], or scaled by the
    per-(group, channel) ``shifts`` factors to [-56, 56]. Pure
    reshape/arithmetic (group-local interleave + one broadcast integer
    multiply)."""
    lead = packed.shape[:-2]
    kh, n = packed.shape[-2], packed.shape[-1]
    p = packed.astype(jnp.int32)
    lo = (p << 28) >> 28                      # sign-extend low nibble
    hi = p >> 4                               # arithmetic: sign-extends
    half = INT4_GROUP // 2
    lo = lo.reshape(lead + (kh // half, 1, half, n))
    hi = hi.reshape(lead + (kh // half, 1, half, n))
    full = jnp.concatenate([lo, hi], axis=-3)
    if shifts is not None:
        full = full * shifts.astype(jnp.int32).reshape(
            lead + (kh // half, 1, 1, n))
    return full.astype(jnp.int8).reshape(lead + (2 * kh, n))


def dequantize_int4(packed: jnp.ndarray, scale: jnp.ndarray,
                    shifts: jnp.ndarray = None,
                    dtype=jnp.float32) -> jnp.ndarray:
    """Reconstruct the full (in, out) weight (XLA fallback path)."""
    return unpack_int4(packed, shifts).astype(dtype) * scale.astype(dtype)


def quantize_params(params: Params, min_size: int = 1 << 16,
                    quantize_vision: bool | None = None) -> Params:
    """Return a copy of the tree with eligible projection weights stored as
    ``{"w_q": int8, "w_s": float32}`` (consumed transparently by the model's
    ``_linear``). ``min_size`` skips small matrices where quantization
    overhead outweighs the bandwidth win. ``quantize_vision`` additionally
    quantizes the ViT encoder + projection (default: ``APERTIS_QUANT_VIT``)."""
    import os

    if quantize_vision is None:
        quantize_vision = os.environ.get("APERTIS_QUANT_VIT", "0") == "1"

    def walk(tree, name):
        if not isinstance(tree, dict):
            return tree
        if name in _SKIP_SUBTREES and not (
                quantize_vision and name in _VISION_SUBTREES):
            return tree
        out = {}
        for key, value in tree.items():
            if (key in _QUANT_KEYS and isinstance(value, jnp.ndarray)
                    and value.ndim in _QUANT_KEYS[key]
                    and value.size >= min_size
                    and jnp.issubdtype(value.dtype, jnp.floating)
                    and name not in _SKIP_PARENTS):
                q, s = quantize_weight(value)
                out[key + "_q"], out[key + "_s"] = q, s
            elif isinstance(value, dict):
                out[key] = walk(value, key)
            else:
                out[key] = value
        return out

    return walk(params, "")


def tree_is_quantized(params: Params) -> bool:
    """True if any linear in the tree carries int8 serving weights."""
    if not isinstance(params, dict):
        return False
    if any(k.endswith("_q") for k in params):
        return True
    return any(tree_is_quantized(v) for v in params.values()
               if isinstance(v, dict))


def quantize_tied_head(params: Params) -> Params:
    """Attach a serving-side int8 copy of the tied LM head.

    The quantizer keeps the embedding table high-precision (it is gathered
    per token AND doubles as the tied head), which leaves the decode step's
    single largest projection — (B, H) x (H, V) — reading the full bf16
    table every token (155 MB at the 1.2B flagship's V=32000, H=2432).
    This attaches ``lm_head = {"w_q": (H, V) int8, "w_s": (1, V)}``
    consumed by ``_lm_head`` through the standard ``_linear`` dispatch,
    halving the head's weight read at ~+V*H bytes of device memory (the
    bf16 table stays for embedding lookups). Greedy parity with the bf16 head is pinned in
    tests/test_quantize.py; disable with APERTIS_QUANT_HEAD=0."""
    if "lm_head" in params or "embed" not in params:
        return params
    emb = params["embed"].get("tok")
    if emb is None or not jnp.issubdtype(emb.dtype, jnp.floating):
        return params
    q, s = quantize_weight(emb.T)
    out = dict(params)
    out["lm_head"] = {"w_q": q, "w_s": s}
    return out


def quantization_error(params: Params, quantized: Params) -> float:
    """Max relative reconstruction error across quantized weights."""
    worst = 0.0

    def walk(p, q):
        nonlocal worst
        if isinstance(p, dict):
            for key in _QUANT_KEYS:
                if key in p and key + "_q" in q:
                    recon = q[key + "_q"].astype(jnp.float32) * q[key + "_s"]
                    denom = jnp.maximum(jnp.max(jnp.abs(p[key])), 1e-8)
                    err = float(jnp.max(jnp.abs(recon - p[key])) / denom)
                    worst = max(worst, err)
            for key in p:
                if key in q and isinstance(p[key], dict):
                    walk(p[key], q[key])

    walk(params, quantized)
    return worst
