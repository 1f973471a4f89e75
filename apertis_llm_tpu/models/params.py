"""Parameter initialisation for the Apertis model.

Parameters are plain nested dicts of jnp arrays. Per-layer parameters are
STACKED along a leading ``num_hidden_layers`` axis so the forward pass can
``lax.scan`` over depth (fast compiles, natural pipeline-parallel sharding
axis).

Linear weights are stored as (in_features, out_features) — JAX convention,
transposed from torch. Initialisation distributions follow the reference's
``_init_weights`` (src/model/core.py:1045-1062): normal(0, initializer_range)
for linears/embeddings, zero biases, unit norm scales; SSM specials
(dt bias ~ U(log 1e-3, log 1e-2), A_log ~ U(log .5, log .99), D = 1) per
core.py:314-318; depthwise-conv follows torch Conv1d default
U(+-1/sqrt(fan_in)).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import jax
import jax.numpy as jnp

from apertis_llm_tpu.config import ApertisConfig

Params = Dict[str, Any]


def _split(rng, n):
    return list(jax.random.split(rng, n))


def _linear(rng, fan_in: int, fan_out: int, std: float, bias: bool, dtype) -> Params:
    p = {"w": jax.random.normal(rng, (fan_in, fan_out), dtype) * std}
    if bias:
        p["b"] = jnp.zeros((fan_out,), dtype)
    return p


def _norm(config: ApertisConfig, dim: int, dtype) -> Params:
    if config.use_rmsnorm:
        return {"scale": jnp.ones((dim,), dtype)}
    return {"w": jnp.ones((dim,), dtype), "b": jnp.zeros((dim,), dtype)}


def _layer_norm_params(dim: int, dtype) -> Params:
    return {"w": jnp.ones((dim,), dtype), "b": jnp.zeros((dim,), dtype)}


def init_attention_params(rng, config: ApertisConfig, dtype) -> Params:
    h = config.hidden_size
    std = config.initializer_range
    p: Params = {"pre_norm": _norm(config, h, dtype)}
    if config.attention_type == "selective_ssm":
        d_inner = config.ssm_d_inner
        heads, d_state = config.num_attention_heads, config.ssm_d_state
        dt_rank = config.ssm_dt_rank
        k = config.ssm_conv_kernel
        rngs = _split(rng, 8)
        p["in_proj_x"] = _linear(rngs[0], h, d_inner, std, bias=False, dtype=dtype)
        p["in_proj_z"] = _linear(rngs[1], h, d_inner, std, bias=False, dtype=dtype)
        conv_bound = 1.0 / math.sqrt(k)
        p["conv"] = {
            "w": jax.random.uniform(rngs[2], (d_inner, k), dtype, -conv_bound, conv_bound),
            "b": jax.random.uniform(rngs[3], (d_inner,), dtype, -conv_bound, conv_bound),
        }
        p["x_param_proj"] = _linear(
            rngs[4], d_inner, dt_rank + 2 * heads * d_state, std, bias=False, dtype=dtype)
        p["dt_proj"] = {
            "w": jax.random.normal(rngs[5], (dt_rank, heads), dtype) * std,
            "b": jax.random.uniform(
                rngs[6], (heads,), dtype, math.log(1e-3), math.log(1e-2)),
        }
        p["A_log"] = jax.random.uniform(
            rngs[7], (heads, d_state), dtype, math.log(0.5), math.log(0.99))
        p["D"] = jnp.ones((d_inner,), dtype)
        p["out_proj"] = _linear(_split(rngs[0], 2)[1], d_inner, h, std, bias=False, dtype=dtype)
    else:
        bias = config.qkv_bias
        rngs = _split(rng, 4)
        p["q"] = _linear(rngs[0], h, h, std, bias, dtype)
        p["k"] = _linear(rngs[1], h, h, std, bias, dtype)
        p["v"] = _linear(rngs[2], h, h, std, bias, dtype)
        p["o"] = _linear(rngs[3], h, h, std, bias, dtype)
    return p


def init_ffn_params(rng, config: ApertisConfig, dtype) -> Params:
    h, inter = config.hidden_size, config.intermediate_size
    std = config.initializer_range
    p: Params = {"pre_norm": _norm(config, h, dtype)}
    if config.use_swiglu:
        ffn_dim = config.swiglu_ffn_dim
        rngs = _split(rng, 3)
        p["w_gate"] = _linear(rngs[0], h, ffn_dim, std, bias=False, dtype=dtype)
        p["w_up"] = _linear(rngs[1], h, ffn_dim, std, bias=False, dtype=dtype)
        p["w_down"] = _linear(rngs[2], ffn_dim, h, std, bias=False, dtype=dtype)
    elif config.use_expert_system and config.num_experts > 0:
        e = config.num_experts
        rngs = _split(rng, 4)
        p["router_ln"] = _layer_norm_params(h, dtype)
        p["router"] = _linear(rngs[0], h, e, std, bias=True, dtype=dtype)
        if config.use_noisy_top_k_routing:
            p["w_noise"] = jnp.zeros((e,), dtype)
        p["experts"] = {
            "ln_w": jnp.ones((e, h), dtype),
            "ln_b": jnp.zeros((e, h), dtype),
            "w1": jax.random.normal(rngs[1], (e, h, inter), dtype) * std,
            "b1": jnp.zeros((e, inter), dtype),
            "w2": jax.random.normal(rngs[2], (e, inter, h), dtype) * std,
            "b2": jnp.zeros((e, h), dtype),
        }
    else:
        rngs = _split(rng, 2)
        p["w1"] = _linear(rngs[0], h, inter, std, bias=True, dtype=dtype)
        p["w2"] = _linear(rngs[1], inter, h, std, bias=True, dtype=dtype)
    return p


def init_layer_params(rng, config: ApertisConfig, dtype) -> Params:
    r1, r2 = jax.random.split(rng)
    return {
        "attn": init_attention_params(r1, config, dtype),
        "ffn": init_ffn_params(r2, config, dtype),
    }


def init_vision_params(rng, config: ApertisConfig, dtype) -> Params:
    """ViT encoder parameters (reference: src/multimodal/module.py:10-119).

    Per-layer params are stacked for scan-over-depth. Attention uses a packed
    qkv in_proj like torch's TransformerEncoderLayer.
    """
    dv = config.vision_embed_dim
    patches = (config.image_size // config.vision_patch_size) ** 2
    rngs = _split(rng, 8)

    def vit_layer(r):
        rs = _split(r, 4)
        # torch MultiheadAttention in_proj is xavier_uniform.
        bound = math.sqrt(6.0 / (dv + 3 * dv))
        return {
            "ln1": _layer_norm_params(dv, dtype),
            "in_proj_w": jax.random.uniform(rs[0], (dv, 3 * dv), dtype, -bound, bound),
            "in_proj_b": jnp.zeros((3 * dv,), dtype),
            "attn_out": _linear(rs[1], dv, dv, 0.02, bias=True, dtype=dtype),
            "ln2": _layer_norm_params(dv, dtype),
            "linear1": _linear(rs[2], dv, 4 * dv, 0.02, bias=True, dtype=dtype),
            "linear2": _linear(rs[3], 4 * dv, dv, 0.02, bias=True, dtype=dtype),
        }

    # vmap over the stacked layer keys: bit-identical to stacking per-layer
    # inits (JAX random primitives batch per-key), but the traced body is
    # ONE layer — at 44-layer flagship depth this cuts the init program's
    # jaxpr ~layers-fold and with it the init compile time (r3's 53-128 s
    # "model init" was mostly XLA chewing the unrolled init graph).
    layer_rngs = jax.random.split(rngs[3], config.vision_layers)
    layers = jax.vmap(vit_layer)(layer_rngs)

    return {
        "patch_embed": {
            "w": jax.random.normal(
                rngs[0],
                (3 * config.vision_patch_size ** 2, dv), dtype) * 0.02,
            "b": jnp.zeros((dv,), dtype),
        },
        "cls_token": jax.random.normal(rngs[1], (1, 1, dv), dtype) * 0.02,
        "pos_embed": jax.random.normal(rngs[2], (1, patches + 1, dv), dtype) * 0.02,
        "layers": layers,
        "final_ln": _layer_norm_params(dv, dtype),
    }


def init_params(rng: jax.Array, config: ApertisConfig, dtype=None) -> Params:
    """Initialise the full ApertisForCausalLM parameter tree."""
    if dtype is None:
        dtype = jnp.dtype(config.param_dtype)
    h = config.hidden_size
    std = config.initializer_range
    rngs = _split(rng, 6)

    embed = jax.random.normal(rngs[0], (config.vocab_size, h), dtype) * std
    embed = embed.at[config.pad_token_id].set(0.0)
    params: Params = {"embed": {"tok": embed}}

    if config.position_embedding_type == "absolute":
        params["abs_pos"] = {
            "emb": jax.random.normal(
                rngs[1], (config.max_position_embeddings, h), dtype) * std}

    if config.multimodal:
        params["vision"] = init_vision_params(rngs[2], config, dtype)
        if config.vision_embed_dim != h:
            params["vision_proj"] = _linear(
                rngs[3], config.vision_embed_dim, h, std, bias=True, dtype=dtype)

    # Single vmapped layer body instead of num_hidden_layers traced copies
    # (bit-identical values; see the vision-layer note above).
    layer_rngs = jax.random.split(rngs[4], config.num_hidden_layers)
    params["layers"] = jax.vmap(
        lambda r: init_layer_params(r, config, dtype))(layer_rngs)

    params["final_norm"] = _norm(config, h, dtype)
    if not config.tie_word_embeddings:
        params["lm_head"] = _linear(rngs[5], h, config.vocab_size, std, bias=False, dtype=dtype)
    return params


def count_params(params: Params) -> int:
    return sum(x.size for x in jax.tree.leaves(params))
