"""Apertis decoder-only LM — functional forward passes.

JAX redesign of the reference model (reference: src/model/core.py):
  * parameters are stacked per-layer pytrees; depth is traversed with
    ``lax.scan`` (one compiled layer body regardless of depth),
  * the decode path uses preallocated static-shape caches — KV ring for
    standard MHA, (conv window, ssm state) for the selective mixer — so the
    whole autoregressive loop stays inside one compiled program,
  * everything is a pure function of (params, inputs, rng); dropout is driven
    by explicit PRNG keys and a ``training`` flag.

Architecture semantics match the reference exactly in eval mode (see
tests/test_parity.py): pre-norm residual attention (MHA with full-width
interleaved RoPE, or Mamba-style selective SSM), pre-norm residual FFN
(dense / SwiGLU / adaptive-expert MoE), final post-norm, tied LM head.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import os

import jax
import jax.numpy as jnp

from apertis_llm_tpu import backend
from apertis_llm_tpu.config import ApertisConfig
from apertis_llm_tpu.ops import attention as attn_ops
from apertis_llm_tpu.ops import moe as moe_ops
from apertis_llm_tpu.ops import quant as quant_ops
from apertis_llm_tpu.ops import ssm as ssm_ops
from apertis_llm_tpu.ops.activations import get_activation, silu
from apertis_llm_tpu.ops.norms import layer_norm, rms_norm
from apertis_llm_tpu.ops.rope import apply_rope, rope_tables

Params = Dict[str, Any]


class LMOutput(NamedTuple):
    loss: Optional[jnp.ndarray]
    logits: jnp.ndarray
    lb_loss: jnp.ndarray
    rz_loss: jnp.ndarray
    attentions: Optional[jnp.ndarray] = None  # (num_layers, B, H, L, L) when requested
    hidden_states: Optional[jnp.ndarray] = None  # (num_layers + 1, B, L, D) when requested


class PrefillOutput(NamedTuple):
    logits: jnp.ndarray          # (B, L_text, V) logits over the text positions
    cache: Params
    length: jnp.ndarray          # scalar int32: tokens written to the cache


# ---------------------------------------------------------------------------
# small helpers
# ---------------------------------------------------------------------------

def _decode_unroll(num_layers: int) -> int:
    """Unroll factor for the decode-step layer scan (APERTIS_DECODE_UNROLL,
    default 1). Parity is bit-exact either way (test_decode_unroll_parity);
    its effect on the GPU's decode step is not measured."""
    env = os.environ.get("APERTIS_DECODE_UNROLL", "").strip()
    if env:
        return max(1, min(int(env), num_layers))
    return 1


def _apply_norm(p: Params, x: jnp.ndarray, eps: float) -> jnp.ndarray:
    if "scale" in p:
        return rms_norm(x, p["scale"], eps=eps)
    return layer_norm(x, p["w"], p["b"], eps=eps)


def _linear(p: Params, x: jnp.ndarray) -> jnp.ndarray:
    """``x @ w (+ b)`` for plain, int8 (``w_q``/``w_s``) and int4-packed
    (``w_q4``/``w_s``/``w_sh``) linears. Quantized weights take the dynamic
    int8 dot or the weight-only dequant by row count (ops/quant.py)."""
    if "w_q4" in p or "w_q" in p:
        if "w_q4" in p:
            from apertis_llm_tpu.models.quantize import unpack_int4

            w_q = unpack_int4(p["w_q4"], p.get("w_sh"))
        else:
            w_q = p["w_q"]
        rows = x.size // x.shape[-1]
        if quant_ops.use_dyn(rows):
            y = quant_ops.quant_matmul_dyn_xla(x, w_q, p["w_s"])
        else:
            y = x @ (w_q.astype(x.dtype) * p["w_s"].astype(x.dtype))
    else:
        y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def _dropout(rng: Optional[jax.Array], x: jnp.ndarray, rate: float, training: bool) -> jnp.ndarray:
    if not training or rate <= 0.0 or rng is None:
        return x
    keep = jax.random.bernoulli(rng, 1.0 - rate, x.shape)
    return jnp.where(keep, x / (1.0 - rate), 0.0).astype(x.dtype)


# ---------------------------------------------------------------------------
# attention sublayer (full-sequence)
# ---------------------------------------------------------------------------

def _sp_ctx():
    """Active sequence-parallel context (trace-time), or None."""
    from apertis_llm_tpu.parallel import context as par_ctx

    ctx = par_ctx.current()
    return ctx if ctx.active else None


def _ep_ctx(num_tokens: int):
    """Active expert-parallel context, if the token count shards evenly.

    Returns (ctx, token_axes) where token_axes is the full dim-0 sharding of
    the flat token array: batch, expert (extra data parallelism), and — when
    SP is also on — the sequence axis (the (B, L) flatten merges them in
    that order)."""
    from apertis_llm_tpu.parallel import context as par_ctx

    ctx = par_ctx.current()
    if not ctx.ep_active:
        return None
    token_axes = []
    if ctx.batch_axis:
        token_axes.append(ctx.batch_axis)
    token_axes.append(ctx.ep_axis)
    if ctx.active:
        token_axes.append(ctx.sp_axis)
    shards = 1
    for a in token_axes:
        shards *= ctx.mesh.shape.get(a, 1)
    if num_tokens % shards:
        return None
    return ctx, tuple(token_axes)


def _mha_full(
    lp: Params,
    config: ApertisConfig,
    x: jnp.ndarray,                  # (B, L, D) pre-normed
    bias: Optional[jnp.ndarray],     # additive mask or None (-> causal)
    pos_ids: jnp.ndarray,            # (B, L)
    cos_t: jnp.ndarray,
    sin_t: jnp.ndarray,
    *,
    training: bool,
    rng: Optional[jax.Array],
    want_cache: bool,
    want_probs: bool,
    cp_kv_valid: Optional[jnp.ndarray] = None,  # (B, L) key validity for CP
):
    b, l, d = x.shape
    heads, head_dim = config.num_attention_heads, config.head_dim
    q = _linear(lp["q"], x)
    k = _linear(lp["k"], x)
    v = _linear(lp["v"], x)
    if config.position_embedding_type == "rotary":
        # Reference quirk: RoPE over the full hidden width, pre head-split.
        q = apply_rope(q, pos_ids, cos_t, sin_t)
        k = apply_rope(k, pos_ids, cos_t, sin_t)

    def split_heads(t):
        return t.reshape(b, l, heads, head_dim).transpose(0, 2, 1, 3)

    qh, kh, vh = split_heads(q), split_heads(k), split_heads(v)
    probs = None
    sp = _sp_ctx()
    if want_probs:
        ctx, probs = attn_ops.mha_with_probs(qh, kh, vh, bias=bias, causal=True)
    elif (sp is not None and not want_cache
          and l % sp.mesh.shape[sp.sp_axis] == 0):
        # Context parallelism: ring attention over the sequence axis. The
        # padding mask (when any) rides the ring as per-key validity — exact
        # vs the additive-bias path (tests/test_ring_attention.py).
        from apertis_llm_tpu.parallel.ring_attention import ring_attention

        ctx = ring_attention(qh, kh, vh, sp.mesh, sp.sp_axis, causal=True,
                             kv_valid=cp_kv_valid, batch_axis=sp.batch_axis)
    elif bias is None and config.use_flash_attention:
        # Fused attention, gated like the reference's flash path: enabled,
        # no padding mask, no attention-probs output (core.py:731-740).
        # cuDNN's fused kernel on the GPU (backend.py), XLA's elsewhere.
        ctx = jax.nn.dot_product_attention(
            qh.transpose(0, 2, 1, 3), kh.transpose(0, 2, 1, 3),
            vh.transpose(0, 2, 1, 3), is_causal=True,
            implementation=backend.fused_attention_implementation(
                qh.dtype, l),
        ).transpose(0, 2, 1, 3)
    else:
        ctx = attn_ops.mha(qh, kh, vh, bias=bias, causal=True)
    if training and config.attention_probs_dropout_prob > 0 and rng is not None:
        # Matching reference semantics exactly would require dropping
        # attention probabilities; dropping the context is the fused-kernel
        # equivalent used here (same expected value).
        ctx = _dropout(rng, ctx, config.attention_probs_dropout_prob, training)
    ctx = ctx.transpose(0, 2, 1, 3).reshape(b, l, d)
    out = _linear(lp["o"], ctx)
    cache = None
    if want_cache:
        cache = {"k": kh, "v": vh}  # (B, H, L, Dh)
    return out, cache, probs


def _ssm_delta_bc(lp: Params, config: ApertisConfig, x_act: jnp.ndarray):
    """SSM parameterisation front-end: x_act (..., d_inner) ->
    (delta (..., H) float32, a_cont (H, N) float32, b, c (..., H, N))."""
    heads, d_state = config.num_attention_heads, config.ssm_d_state
    dt_rank = config.ssm_dt_rank
    raw = _linear(lp["x_param_proj"], x_act)
    dt_feats = raw[..., :dt_rank]
    b_raw = raw[..., dt_rank:dt_rank + heads * d_state]
    c_raw = raw[..., dt_rank + heads * d_state:]
    delta = jax.nn.softplus(_linear(lp["dt_proj"], dt_feats).astype(jnp.float32))
    a_cont = -jnp.exp(lp["A_log"].astype(jnp.float32))              # (H, N)
    shape = x_act.shape[:-1] + (heads, d_state)
    return delta, a_cont, b_raw.reshape(shape), c_raw.reshape(shape)


def _ssm_compute_params(lp: Params, config: ApertisConfig, x_act: jnp.ndarray):
    """Shared SSM parameterisation: x_act (..., d_inner) ->
    (a_bar, b_term, c_mod) each (..., H, N) with delta in float32."""
    delta, a_cont, b, c = _ssm_delta_bc(lp, config, x_act)
    a_bar = jnp.exp(delta[..., None] * a_cont)                       # (..., H, N)
    return a_bar, b, c


def _ssm_full(
    lp: Params,
    config: ApertisConfig,
    x: jnp.ndarray,  # (B, L, D) pre-normed
    *,
    want_cache: bool,
    seq_mask: Optional[jnp.ndarray] = None,   # (B, L) 1 = real token
    seq_lens: Optional[jnp.ndarray] = None,   # (B,) real lengths (for cache)
):
    """Selective-SSM mixer over a full sequence.

    When ``seq_mask`` is given (prefill with right-padded/bucketed prompts),
    padded steps become identity transitions (a=1, b=0) so the carried state
    after the scan equals the state after the last REAL token, and the cached
    conv window is gathered at each row's true length. The unmasked variant
    reproduces the reference exactly (which ignores the attention mask,
    core.py:356-401).
    """
    b, l, _ = x.shape
    x_proj = _linear(lp["in_proj_x"], x)                  # (B, L, d_inner)
    z = _linear(lp["in_proj_z"], x)
    dtype = x.dtype
    d_inner = config.ssm_d_inner
    k = config.ssm_conv_kernel
    x_conv = ssm_ops.depthwise_causal_conv(x_proj, lp["conv"]["w"], lp["conv"]["b"])
    x_act = silu(x_conv)

    sp = _sp_ctx()
    if sp is not None and l % sp.mesh.shape[sp.sp_axis] == 0:
        # Sequence parallelism: shard L over the seq axis; cross-chunk
        # traffic is one all-gather of (B, H, N) chunk summaries.
        from apertis_llm_tpu.parallel.sequence import (
            ssm_scan_sequence_parallel)

        a_bar, b_term, c_mod = _ssm_compute_params(lp, config, x_act)
        a_bar = a_bar.transpose(0, 2, 1, 3)               # (B, H, L, N)
        b_term = b_term.transpose(0, 2, 1, 3).astype(a_bar.dtype)
        c_mod = c_mod.transpose(0, 2, 1, 3)
        if seq_mask is not None:
            m = seq_mask[:, None, :, None].astype(a_bar.dtype)
            a_bar = a_bar * m + (1.0 - m)   # identity transition on pads
            b_term = b_term * m
        h, h_last = ssm_scan_sequence_parallel(
            a_bar, b_term, sp.mesh, sp.sp_axis, batch_axis=sp.batch_axis)
        y = (c_mod.astype(h.dtype) * h).astype(dtype)    # (B, H, L, N)
        y = y.transpose(0, 2, 1, 3).reshape(b, l, d_inner)
        h_last_f32 = h_last.astype(jnp.float32)
    else:
        delta, a_cont, b_nat, c_nat = _ssm_delta_bc(lp, config, x_act)
        y, h_last_f32 = ssm_ops.ssm_mix(
            delta, a_cont, b_nat, c_nat, seq_mask=seq_mask,
            out_dtype=dtype)                              # (B, L, d_inner)
    y = y + lp["D"] * x_act
    out = _linear(lp["out_proj"], y * silu(z))

    cache = None
    if want_cache:
        # Conv window carries the last K-1 *pre-conv* projected inputs
        # (reference: core.py:372); SSM state is the final recurrence carry.
        pad = jnp.pad(x_proj, ((0, 0), (k - 1, 0), (0, 0)))  # (B, L+K-1, C)
        if k <= 1:
            conv_state = jnp.zeros((b, 0, d_inner), dtype)
        elif seq_lens is None:
            conv_state = pad[:, -(k - 1):, :]
        else:
            # Rows of padded x_proj at [len, len+K-2] are original positions
            # [len-K+1, len-1] — the window ending at the last real token.
            idx = seq_lens[:, None] + jnp.arange(k - 1)[None, :]   # (B, K-1)
            conv_state = jnp.take_along_axis(pad, idx[:, :, None], axis=1)
        cache = {"conv": conv_state, "ssm": h_last_f32}
    return out, cache


# ---------------------------------------------------------------------------
# FFN sublayer
# ---------------------------------------------------------------------------

def _ffn(
    lp: Params,
    config: ApertisConfig,
    x: jnp.ndarray,  # (B, L, D) pre-normed
    *,
    training: bool,
    rng: Optional[jax.Array],
):
    zero = jnp.zeros((), jnp.float32)
    eps = config.layer_norm_eps
    if config.use_swiglu:
        h = silu(_linear(lp["w_gate"], x)) * _linear(lp["w_up"], x)
        out = _linear(lp["w_down"], h)
        out = _dropout(rng, out, config.hidden_dropout_prob, training)
        return out, zero, zero
    if config.use_expert_system and config.num_experts > 0:
        b, l, d = x.shape
        flat = x.reshape(b * l, d)
        noise_rng = drop_rng = None
        if training and rng is not None:
            noise_rng, drop_rng = jax.random.split(rng)
        routing = moe_ops.route(
            flat,
            lp["router_ln"]["w"], lp["router_ln"]["b"],
            lp["router"]["w"], lp["router"]["b"],
            config.experts_per_token,
            layer_norm_eps=eps,
            training=training,
            noise_rng=noise_rng,
            w_noise=lp.get("w_noise"),
            noisy_routing_alpha=config.noisy_routing_alpha,
            load_balancing_loss_coef=config.load_balancing_loss_coef,
            router_z_loss_coef=config.router_z_loss_coef,
            use_load_balancing_loss=config.use_load_balancing_loss,
            use_router_z_loss=config.use_router_z_loss,
        )
        active = None
        if (training and config.use_expert_dropout
                and config.expert_dropout_prob > 0 and drop_rng is not None):
            active = moe_ops.expert_dropout_mask(
                drop_rng, config.num_experts, config.expert_dropout_prob)
        s = b * l
        ep = _ep_ctx(s)
        if ep is not None:
            # Explicit expert parallelism: all-to-all dispatch/combine over
            # the expert mesh axis (ops/moe_ep.py), replacing GSPMD-inferred
            # comms for the expert-sharded tree.
            from apertis_llm_tpu.ops.moe_ep import moe_expert_parallel

            ctx, token_axes = ep
            out = moe_expert_parallel(
                flat, routing, lp["experts"], config.hidden_act, eps,
                mesh=ctx.mesh, expert_axis=ctx.ep_axis,
                token_axes=token_axes,
                capacity_factor=config.ep_capacity_factor,
                active_mask=active)
        elif training and config.use_expert_capacity_limit:
            capacity = max(1, int((s / config.num_experts) * config.expert_capacity_factor))
            out = moe_ops.moe_dispatch(
                flat, routing, lp["experts"], config.hidden_act, eps,
                capacity=capacity, active_mask=active)
        elif s <= max(config.num_experts, config.moe_dense_threshold_tokens):
            # Small token counts (decode steps): every expert's weights come
            # off device memory regardless of routing, so the dense
            # all-expert combine is equally memory-bound while skipping the
            # argsort/scatter/gather of the ragged path entirely.
            if not training and "fat" in lp["experts"]:
                # Combine-folded two-fat-GEMM form (models/moe_fuse.py),
                # attached by the inference engine at load time.
                out = moe_ops.moe_dense_fat(
                    flat, routing, lp["experts"], config.hidden_act, eps,
                    active_mask=active)
            else:
                out = moe_ops.moe_dense(
                    flat, routing, lp["experts"], config.hidden_act, eps,
                    active_mask=active)
        else:
            out = moe_ops.moe_ragged(
                flat, routing, lp["experts"], config.hidden_act, eps,
                active_mask=active)
        return out.reshape(b, l, d), routing.lb_loss, routing.rz_loss
    # dense FFN: Linear -> act -> Dropout -> Linear
    act = get_activation(config.hidden_act)
    h = act(_linear(lp["w1"], x))
    h = _dropout(rng, h, config.hidden_dropout_prob, training)
    return _linear(lp["w2"], h), zero, zero


# ---------------------------------------------------------------------------
# one decoder layer (full sequence)
# ---------------------------------------------------------------------------

def _layer_full(
    lp: Params,
    config: ApertisConfig,
    h: jnp.ndarray,
    bias: Optional[jnp.ndarray],
    pos_ids: jnp.ndarray,
    cos_t: jnp.ndarray,
    sin_t: jnp.ndarray,
    *,
    training: bool,
    rng: Optional[jax.Array],
    want_cache: bool,
    want_probs: bool = False,
    seq_mask: Optional[jnp.ndarray] = None,
    seq_lens: Optional[jnp.ndarray] = None,
    cp_kv_valid: Optional[jnp.ndarray] = None,
):
    rngs = jax.random.split(rng, 4) if rng is not None else [None] * 4
    eps = config.layer_norm_eps

    normed = _apply_norm(lp["attn"]["pre_norm"], h, eps)
    if config.attention_type == "selective_ssm":
        attn_out, cache = _ssm_full(lp["attn"], config, normed,
                                    want_cache=want_cache,
                                    seq_mask=seq_mask, seq_lens=seq_lens)
        probs = None
    else:
        attn_out, cache, probs = _mha_full(
            lp["attn"], config, normed, bias, pos_ids, cos_t, sin_t,
            training=training, rng=rngs[0], want_cache=want_cache,
            want_probs=want_probs, cp_kv_valid=cp_kv_valid)
    h = h + _dropout(rngs[1], attn_out, config.hidden_dropout_prob, training)

    normed = _apply_norm(lp["ffn"]["pre_norm"], h, eps)
    ffn_out, lb, rz = _ffn(lp["ffn"], config, normed, training=training,
                           rng=rngs[2])
    h = h + _dropout(rngs[3], ffn_out, config.hidden_dropout_prob, training)
    return h, cache, lb, rz, probs


# ---------------------------------------------------------------------------
# input assembly (embeddings + multimodal prefix)
# ---------------------------------------------------------------------------

def assemble_inputs(
    params: Params,
    config: ApertisConfig,
    input_ids: jnp.ndarray,                   # (B, L_text)
    attention_mask: Optional[jnp.ndarray],    # (B, L_text) 1/0
    position_ids: Optional[jnp.ndarray],      # (B, L_text)
    pixel_values: Optional[jnp.ndarray],      # (B, 3, S, S)
):
    """Token embeddings + optional image prefix; returns
    (embeds, pos_ids, attention_mask, num_img_tokens)."""
    from apertis_llm_tpu.models.vit import vit_encode

    b, l = input_ids.shape
    embeds = jnp.take(params["embed"]["tok"], input_ids, axis=0)
    if position_ids is None:
        position_ids = jnp.broadcast_to(jnp.arange(l, dtype=jnp.int32)[None, :], (b, l))
    if attention_mask is None:
        attention_mask = jnp.ones((b, l), jnp.int32)

    num_img = 0
    if config.multimodal and pixel_values is not None:
        if pixel_values.dtype == jnp.uint8 or pixel_values.shape[-1] == 3:
            # Raw (B, H, W, 3) images: resize + normalise in-graph. Shipping
            # uint8 quarters the host->device transfer at prefill.
            from apertis_llm_tpu.models.vit import preprocess_images

            pixel_values = preprocess_images(pixel_values, config.image_size)
        img = vit_encode(params["vision"], config, pixel_values)
        if "vision_proj" in params:
            img = _linear(params["vision_proj"], img)
        img = img.astype(embeds.dtype)
        num_img = img.shape[1]
        embeds = jnp.concatenate([img, embeds], axis=1)
        img_pos = jnp.broadcast_to(
            jnp.arange(num_img, dtype=jnp.int32)[None, :], (b, num_img))
        position_ids = jnp.concatenate([img_pos, position_ids + num_img], axis=1)
        attention_mask = jnp.concatenate(
            [jnp.ones((b, num_img), attention_mask.dtype), attention_mask], axis=1)

    if config.position_embedding_type == "absolute" and "abs_pos" in params:
        embeds = embeds + jnp.take(params["abs_pos"]["emb"], position_ids, axis=0)
    return embeds, position_ids, attention_mask, num_img


def _rope_tables_if_needed(config: ApertisConfig):
    """RoPE tables for the MHA path; None for SSM/absolute models (the
    tables are (P, D/2) arrays — not worth materialising when unused)."""
    if (config.attention_type == "selective_ssm"
            or config.position_embedding_type != "rotary"):
        return None, None
    return rope_tables(config.hidden_size, config.max_position_embeddings,
                       config.rope_theta)


def _build_bias(attention_mask: jnp.ndarray, q_len: int, past_len: int,
                dtype=jnp.float32) -> jnp.ndarray:
    """Combined causal x padding additive bias (B, 1, q_len, kv_len)
    (reference: core.py:1088-1139)."""
    kv_len = past_len + q_len
    causal = attn_ops.causal_mask_bias(q_len, kv_len, dtype)[None, None]
    padding = jnp.where(attention_mask[:, None, None, :kv_len] > 0, 0.0, attn_ops.NEG_INF)
    return causal + padding.astype(dtype)


# ---------------------------------------------------------------------------
# full-sequence forward (training / eval / parity)
# ---------------------------------------------------------------------------

def forward(
    params: Params,
    config: ApertisConfig,
    input_ids: jnp.ndarray,
    attention_mask: Optional[jnp.ndarray] = None,
    position_ids: Optional[jnp.ndarray] = None,
    pixel_values: Optional[jnp.ndarray] = None,
    labels: Optional[jnp.ndarray] = None,
    *,
    training: bool = False,
    rng: Optional[jax.Array] = None,
    output_attentions: bool = False,
    output_hidden_states: bool = False,
) -> LMOutput:
    """Full-sequence forward; returns logits over the TEXT positions (the
    image prefix is sliced off, reference: core.py:1399-1408) and, when
    ``labels`` given, shifted-CE loss + MoE aux losses."""
    l_text = input_ids.shape[1]
    mask_was_none = attention_mask is None
    embeds, pos_ids, attention_mask, num_img = assemble_inputs(
        params, config, input_ids, attention_mask, position_ids, pixel_values)

    # No user mask -> pure causal attention; bias=None statically enables the
    # fused flash kernel (mirrors the reference's mask-is-None gating,
    # core.py:1088-1108). With a mask, build the combined causal+padding bias.
    # SSM mixers never read the bias (the reference's SSM also ignores the
    # attention mask, core.py:356-401) — skip the O(L^2) buffer entirely so
    # long-context (32K) SSM forward stays O(L) memory.
    bias = (None if (mask_was_none or config.attention_type == "selective_ssm")
            else _build_bias(attention_mask, embeds.shape[1], 0, jnp.float32))

    rngs = jax.random.split(rng, 2) if rng is not None else [None, None]
    h = _dropout(rngs[0], embeds, config.hidden_dropout_prob, training)

    sp = _sp_ctx()
    cp_kv_valid = None
    if sp is not None and h.shape[1] % sp.mesh.shape[sp.sp_axis] == 0:
        # Sequence parallelism: pin activations L-sharded for the whole layer
        # stack — GSPMD splits all pointwise/matmul work over `seq`; the scan
        # and attention route through explicit shard_maps (see _ssm_full /
        # _mha_full). The MHA ring needs per-key validity instead of the
        # (B,1,L,L) bias; SSM keeps the reference's mask-ignoring training
        # semantics (core.py:356-401).
        from jax.sharding import NamedSharding, PartitionSpec as P_

        h = jax.lax.with_sharding_constraint(
            h, NamedSharding(sp.mesh, P_(sp.batch_axis, sp.sp_axis, None)))
        if config.attention_type != "selective_ssm":
            cp_kv_valid = None if mask_was_none else attention_mask
            bias = None   # the ring applies causal+validity masking itself

    cos_t, sin_t = _rope_tables_if_needed(config)

    num_layers = config.num_hidden_layers

    def body(carry, xs):
        h, lb_acc, rz_acc = carry
        lp, idx = xs
        layer_rng = (jax.random.fold_in(rngs[1], idx)
                     if rngs[1] is not None else None)
        h_in = h
        h, _, lb, rz, probs = _layer_full(
            lp, config, h, bias, pos_ids, cos_t, sin_t,
            training=training, rng=layer_rng, want_cache=False,
            want_probs=output_attentions, cp_kv_valid=cp_kv_valid)
        ys = probs
        if output_hidden_states:
            ys = (probs, h_in)
        return (h, lb_acc + lb, rz_acc + rz), ys

    zero = jnp.zeros((), jnp.float32)
    if config.remat and training:
        body = jax.checkpoint(body)
    (h, lb_loss, rz_loss), scan_ys = jax.lax.scan(
        body, (h, zero, zero),
        (params["layers"], jnp.arange(num_layers)))
    if output_hidden_states:
        all_probs, layer_inputs = scan_ys
    else:
        all_probs, layer_inputs = scan_ys, None

    h = _apply_norm(params["final_norm"], h, config.layer_norm_eps)
    all_hidden = None
    if output_hidden_states:
        # Per-layer inputs plus the final post-norm output
        # (reference: core.py:1249, 1295).
        all_hidden = jnp.concatenate([layer_inputs, h[None]], axis=0)

    if num_img > 0:
        h_text = h[:, num_img:, :]
    else:
        h_text = h
    logits = _lm_head(params, h_text)

    loss = None
    if labels is not None:
        loss = cross_entropy_loss(logits, labels, ignore_index=-100)
        if config.use_expert_system:
            loss = loss + lb_loss + rz_loss
    del l_text
    return LMOutput(loss, logits, lb_loss, rz_loss,
                    all_probs if output_attentions else None,
                    all_hidden)


def _lm_head(params: Params, h: jnp.ndarray) -> jnp.ndarray:
    if "lm_head" in params:
        return _linear(params["lm_head"], h)
    return h @ params["embed"]["tok"].T


def cross_entropy_loss(
    logits: jnp.ndarray, labels: jnp.ndarray, ignore_index: int = -100
) -> jnp.ndarray:
    """Shifted next-token CE with ignore_index masking
    (reference: core.py:1414-1451)."""
    shift_logits = logits[:, :-1, :].astype(jnp.float32)
    shift_labels = labels[:, 1:]
    valid = shift_labels != ignore_index
    safe_labels = jnp.where(valid, shift_labels, 0)
    log_probs = jax.nn.log_softmax(shift_logits, axis=-1)
    nll = -jnp.take_along_axis(log_probs, safe_labels[..., None], axis=-1)[..., 0]
    nll = jnp.where(valid, nll, 0.0)
    count = jnp.maximum(jnp.sum(valid), 1)
    return jnp.sum(nll) / count


# ---------------------------------------------------------------------------
# decode: cache init / prefill / single step
# ---------------------------------------------------------------------------

def init_cache(config: ApertisConfig, batch_size: int, max_length: Optional[int] = None,
               dtype=None) -> Params:
    """Preallocate the static-shape decode cache (stacked over layers)."""
    if max_length is None:
        max_length = config.decode_max_length
    if dtype is None:
        dtype = jnp.dtype(config.dtype)
    nl = config.num_hidden_layers
    if config.attention_type == "selective_ssm":
        return {
            "conv": jnp.zeros(
                (nl, batch_size, max(config.ssm_conv_kernel - 1, 0), config.ssm_d_inner),
                dtype),
            "ssm": jnp.zeros(
                (nl, batch_size, config.num_attention_heads, config.ssm_d_state),
                jnp.float32),
        }
    heads, head_dim = config.num_attention_heads, config.head_dim
    if _quant_kv():
        # int8 KV serving cache (APERTIS_QUANT_KV=1): values quantize
        # symmetrically per (layer, row, head, slot) with the scale over the
        # head_dim axis. This halves the MHA decode step's largest memory
        # read (the whole cache) and the cache's footprint. Scales dequantize exactly into
        # the score/context contractions (ops/attention). The in-flight
        # token's K/V stay bf16 through the self-term; only the persisted
        # slots are quantized.
        return {
            "k": jnp.zeros((nl, batch_size, heads, max_length, head_dim),
                           jnp.int8),
            "k_s": jnp.zeros((nl, batch_size, heads, max_length, 1),
                             jnp.float32),
            "v": jnp.zeros((nl, batch_size, heads, max_length, head_dim),
                           jnp.int8),
            "v_s": jnp.zeros((nl, batch_size, heads, max_length, 1),
                             jnp.float32),
        }
    return {
        "k": jnp.zeros((nl, batch_size, heads, max_length, head_dim), dtype),
        "v": jnp.zeros((nl, batch_size, heads, max_length, head_dim), dtype),
    }


def _quant_kv() -> bool:
    return os.environ.get("APERTIS_QUANT_KV", "0") == "1"


def _quantize_kv(t: jnp.ndarray):
    """Symmetric per-slot int8: scale over the trailing head_dim axis."""
    absmax = jnp.max(jnp.abs(t.astype(jnp.float32)), axis=-1, keepdims=True)
    scale = jnp.maximum(absmax, 1e-8) * (1.0 / 127.0)
    q = jnp.clip(jnp.round(t.astype(jnp.float32) / scale),
                 -127, 127).astype(jnp.int8)
    return q, scale


def prefill(
    params: Params,
    config: ApertisConfig,
    cache: Params,
    input_ids: jnp.ndarray,
    attention_mask: Optional[jnp.ndarray] = None,
    position_ids: Optional[jnp.ndarray] = None,
    pixel_values: Optional[jnp.ndarray] = None,
    logit_positions: Optional[jnp.ndarray] = None,
) -> PrefillOutput:
    """Run the prompt through the model, filling the decode cache.

    ``logit_positions`` (B,) — text positions whose logits are needed (the
    serving engine only consumes each row's last real token). When given,
    the lm_head runs on those single positions instead of the whole
    sequence (saves ~2*V*D FLOPs per skipped position and the (B, L, V)
    logits materialisation) and ``logits`` has shape (B, 1, V)."""
    embeds, pos_ids, attention_mask, num_img = assemble_inputs(
        params, config, input_ids, attention_mask, position_ids, pixel_values)
    l_total = embeds.shape[1]
    # SSM prefill handles padding via identity transitions (seq_mask below);
    # the O(L^2) additive bias is MHA-only — skipping it keeps 32K-token
    # SSM prefill at O(L) memory.
    bias = (None if config.attention_type == "selective_ssm"
            else _build_bias(attention_mask, l_total, 0, jnp.float32))
    cos_t, sin_t = _rope_tables_if_needed(config)
    seq_mask = attention_mask
    seq_lens = jnp.sum(attention_mask.astype(jnp.int32), axis=1)

    def body(h, lp):
        h, layer_cache, _, _, _ = _layer_full(
            lp, config, h, bias, pos_ids, cos_t, sin_t,
            training=False, rng=None, want_cache=True,
            seq_mask=seq_mask, seq_lens=seq_lens)
        return h, layer_cache

    h, stacked_cache = jax.lax.scan(body, embeds, params["layers"])
    h = _apply_norm(params["final_norm"], h, config.layer_norm_eps)
    h_text = h[:, num_img:, :] if num_img > 0 else h
    if logit_positions is not None:
        h_text = jnp.take_along_axis(
            h_text, logit_positions.astype(jnp.int32)[:, None, None], axis=1)
    logits = _lm_head(params, h_text)

    if config.attention_type == "selective_ssm":
        new_cache = {"conv": stacked_cache["conv"], "ssm": stacked_cache["ssm"]}
    elif "k_s" in cache:
        # int8 KV cache: quantize the prompt's K/V per slot on the way in.
        kq, ks = _quantize_kv(stacked_cache["k"])
        vq, vs = _quantize_kv(stacked_cache["v"])
        new_cache = {
            "k": jax.lax.dynamic_update_slice(cache["k"], kq, (0, 0, 0, 0, 0)),
            "k_s": jax.lax.dynamic_update_slice(
                cache["k_s"], ks, (0, 0, 0, 0, 0)),
            "v": jax.lax.dynamic_update_slice(cache["v"], vq, (0, 0, 0, 0, 0)),
            "v_s": jax.lax.dynamic_update_slice(
                cache["v_s"], vs, (0, 0, 0, 0, 0)),
        }
    else:
        kc, vc = stacked_cache["k"], stacked_cache["v"]
        # stacked (nl, B, H, L, Dh) -> write into preallocated ring at [0:L]
        new_cache = {
            "k": jax.lax.dynamic_update_slice(
                cache["k"], kc.astype(cache["k"].dtype), (0, 0, 0, 0, 0)),
            "v": jax.lax.dynamic_update_slice(
                cache["v"], vc.astype(cache["v"].dtype), (0, 0, 0, 0, 0)),
        }
    return PrefillOutput(logits, new_cache, jnp.asarray(l_total, jnp.int32))


def decode_step(
    params: Params,
    config: ApertisConfig,
    cache: Params,
    token_ids: jnp.ndarray,     # (B,) current tokens
    t: jnp.ndarray,             # scalar int32: cache slot to write
    attn_mask_row: Optional[jnp.ndarray] = None,  # (B, Lmax) validity incl. new token
    positions: Optional[jnp.ndarray] = None,      # (B,) logical positions for RoPE
) -> Tuple[jnp.ndarray, Params]:
    """One autoregressive step: returns (logits (B, V), updated cache).

    ``t`` indexes the physical cache slot; ``positions`` (defaulting to ``t``)
    are the logical sequence positions used for rotary/absolute embeddings —
    they differ when prompts were right-padded to a bucket length.
    """
    b = token_ids.shape[0]
    h = jnp.take(params["embed"]["tok"], token_ids, axis=0)[:, None, :]  # (B,1,D)
    if positions is None:
        pos = jnp.full((b, 1), t, jnp.int32)
    else:
        pos = positions.astype(jnp.int32)[:, None]
    if config.position_embedding_type == "absolute" and "abs_pos" in params:
        h = h + jnp.take(params["abs_pos"]["emb"], pos, axis=0)

    eps = config.layer_norm_eps
    is_ssm = config.attention_type == "selective_ssm"
    if is_ssm or config.position_embedding_type != "rotary":
        # SSM decode never touches RoPE; don't build the (P, D/2) tables
        # inside the decode loop body.
        cos_t = sin_t = None
    else:
        cos_t, sin_t = rope_tables(
            config.hidden_size, config.max_position_embeddings, config.rope_theta)

    if not is_ssm:
        max_len = cache["k"].shape[3]
        if attn_mask_row is None:
            valid = jnp.arange(max_len)[None, :] <= t
            valid = jnp.broadcast_to(valid, (b, max_len))
        else:
            valid = attn_mask_row > 0
        # The cache is read, never rewritten, inside the layer scan: each
        # layer reads its old-cache slice (scan xs), attends to the new
        # token through an explicit self-term (the old cache's slot ``t``
        # is stale and masked out), and emits its new K/V slot as a small
        # (B, H, 1, Dh) scan output. One dynamic_update_slice after the
        # scan writes every layer's slot column in place, so a step moves
        # O(cache) bytes once (the attention read), not three times.
        valid_cache = valid & (jnp.arange(max_len)[None, :] != t)
        quant_kv = "k_s" in cache

        def body_mha(hc, xs):
            if quant_kv:
                lp, k_l, ks_l, v_l, vs_l = xs
            else:
                lp, k_l, v_l = xs
                ks_l = vs_l = None
            normed = _apply_norm(lp["attn"]["pre_norm"], hc, eps)
            attn_out, kh, vh = _mha_decode_step(
                lp["attn"], config, normed, k_l, v_l, pos, valid_cache,
                cos_t, sin_t, k_scale=ks_l, v_scale=vs_l)
            hc = hc + attn_out
            normed = _apply_norm(lp["ffn"]["pre_norm"], hc, eps)
            ffn_out, _, _ = _ffn(lp["ffn"], config, normed, training=False,
                                 rng=None)
            return hc + ffn_out, (kh, vh)

        xs_scan = ((params["layers"], cache["k"], cache["k_s"], cache["v"],
                    cache["v_s"]) if quant_kv
                   else (params["layers"], cache["k"], cache["v"]))
        h, (kh_stack, vh_stack) = jax.lax.scan(
            body_mha, h, xs_scan,
            unroll=_decode_unroll(config.num_hidden_layers))
        if quant_kv:
            kq, ks = _quantize_kv(kh_stack)
            vq, vs = _quantize_kv(vh_stack)
            new_cache = {
                "k": jax.lax.dynamic_update_slice(
                    cache["k"], kq, (0, 0, 0, t, 0)),
                "k_s": jax.lax.dynamic_update_slice(
                    cache["k_s"], ks, (0, 0, 0, t, 0)),
                "v": jax.lax.dynamic_update_slice(
                    cache["v"], vq, (0, 0, 0, t, 0)),
                "v_s": jax.lax.dynamic_update_slice(
                    cache["v_s"], vs, (0, 0, 0, t, 0)),
            }
        else:
            new_cache = {
                "k": jax.lax.dynamic_update_slice(
                    cache["k"], kh_stack.astype(cache["k"].dtype),
                    (0, 0, 0, t, 0)),
                "v": jax.lax.dynamic_update_slice(
                    cache["v"], vh_stack.astype(cache["v"].dtype),
                    (0, 0, 0, t, 0)),
            }
        h = _apply_norm(params["final_norm"], h, eps)
        logits = _lm_head(params, h)[:, 0, :]
        return logits, new_cache

    def body(h, xs):
        lp, layer_cache = xs
        normed = _apply_norm(lp["attn"]["pre_norm"], h, eps)
        attn_out, new_layer_cache = _ssm_decode_step(
            lp["attn"], config, normed[:, 0, :], layer_cache)
        h = h + attn_out[:, None, :]
        normed = _apply_norm(lp["ffn"]["pre_norm"], h, eps)
        ffn_out, _, _ = _ffn(lp["ffn"], config, normed, training=False,
                             rng=None)
        return h + ffn_out, new_layer_cache

    h, new_cache = jax.lax.scan(
        body, h, (params["layers"], cache),
        unroll=_decode_unroll(config.num_hidden_layers))
    h = _apply_norm(params["final_norm"], h, eps)
    logits = _lm_head(params, h)[:, 0, :]
    return logits, new_cache


def _mha_decode_step(lp, config, x, k_l, v_l, pos, valid_cache, cos_t, sin_t,
                     k_scale=None, v_scale=None):
    """Single-token MHA step reading the layer's OLD cache slice.

    The new token's K/V never touch the cache here: attention runs over
    the stale-slot-masked old slice plus an explicit self-term
    (:func:`ops.attention.decode_attention_selfterm`), and the fresh
    (B, H, 1, Dh) slot is returned for the caller's single post-scan
    slot-column write. ``k_scale``/``v_scale`` dequantize an int8 cache
    (APERTIS_QUANT_KV) inside the attention contractions."""
    b = x.shape[0]
    heads, head_dim = config.num_attention_heads, config.head_dim
    q = _linear(lp["q"], x)
    k = _linear(lp["k"], x)
    v = _linear(lp["v"], x)
    if config.position_embedding_type == "rotary":
        q = apply_rope(q, pos, cos_t, sin_t)
        k = apply_rope(k, pos, cos_t, sin_t)

    def split_heads(z):
        return z.reshape(b, 1, heads, head_dim).transpose(0, 2, 1, 3)

    qh, kh, vh = split_heads(q), split_heads(k), split_heads(v)
    out_dtype = jnp.dtype(config.dtype)
    ctx = attn_ops.decode_attention_selfterm(
        qh, k_l, v_l, kh.astype(out_dtype), vh.astype(out_dtype),
        valid_cache, k_scale=k_scale, v_scale=v_scale)
    ctx = ctx.transpose(0, 2, 1, 3).reshape(b, 1, heads * head_dim)
    return _linear(lp["o"], ctx), kh, vh


def _ssm_decode_step(lp, config, x, layer_cache):
    """Single-token selective-SSM update carrying (conv window, ssm state)."""
    b = x.shape[0]
    d_inner = config.ssm_d_inner
    x_proj = _linear(lp["in_proj_x"], x)             # (B, d_inner)
    z = _linear(lp["in_proj_z"], x)
    y_conv, new_conv = ssm_ops.depthwise_conv_step(
        layer_cache["conv"], x_proj, lp["conv"]["w"], lp["conv"]["b"])
    x_act = silu(y_conv)
    a_bar, b_term, c_mod = _ssm_compute_params(lp, config, x_act)  # (B, H, N)
    h_new = ssm_ops.selective_scan_step(
        layer_cache["ssm"], a_bar, b_term.astype(jnp.float32))
    y = (c_mod.astype(jnp.float32) * h_new).reshape(b, d_inner).astype(x.dtype)
    y = y + lp["D"] * x_act
    out = _linear(lp["out_proj"], y * silu(z))
    return out, {"conv": new_conv.astype(layer_cache["conv"].dtype), "ssm": h_new}
