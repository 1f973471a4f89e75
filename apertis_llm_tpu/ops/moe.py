"""Adaptive Expert System (token-choice top-k MoE).

Replaces the reference's Python double loop over (k_choice x expert) with
static-shape dispatch (reference: src/model/core.py:470-607). Two compute
paths share one routing front-end:

  * :func:`moe_dense` — every expert runs on every token, combined by routing
    weights. Exact (bit-for-bit up to fp reassociation) match of the reference
    eval path, and actually optimal when S is small (decode) since there is no
    gather/scatter. E x FLOPs for large S.
  * :func:`moe_dispatch` — Switch-style capacity-bucketed dispatch: cumsum
    position assignment, scatter into (E, C, H) buckets, batched expert
    matmuls, gather-combine. Used for training with a capacity limit.

Routing semantics preserved from the reference:
  * router LayerNorm -> linear -> float32 logits (core.py:481-482)
  * learnable noisy top-k: logits += N(0,1) * softplus(w_noise) * alpha,
    training only (core.py:485-488)
  * load-balancing loss  coef * E * sum(f_i * P_i)  computed PRE-capacity
    (core.py:499-505)
  * router z-loss  coef * mean(logsumexp(logits)^2)  (core.py:523-526)
  * top-k weights renormalised by their sum + 1e-6 (core.py:529)
  * whole-expert dropout, training only (core.py:513-521)
  * capacity floor(S/E * capacity_factor), training only (core.py:507-511)

Deviation (documented, SURVEY.md §7.4): overflow drop order. The reference
drops greedily per (k, expert) pair ordered by gate weight; here overflow is
resolved in flattened (k-major, token-order) priority, which is deterministic
and static-shape. Loss values are unaffected (computed pre-capacity); eval is
exactly equal (capacity only applies in training).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from apertis_llm_tpu.ops import quant as quant_ops
from apertis_llm_tpu.ops.activations import get_activation
from apertis_llm_tpu.ops.norms import layer_norm


class RouterOutput(NamedTuple):
    weights: jnp.ndarray       # (S, K) renormalised combine weights
    indices: jnp.ndarray       # (S, K) expert ids
    lb_loss: jnp.ndarray       # scalar
    rz_loss: jnp.ndarray       # scalar


def route(
    x: jnp.ndarray,            # (S, H)
    router_ln_w: jnp.ndarray,
    router_ln_b: jnp.ndarray,
    router_w: jnp.ndarray,     # (H, E)
    router_b: jnp.ndarray,     # (E,)
    top_k: int,
    *,
    layer_norm_eps: float,
    training: bool = False,
    noise_rng: Optional[jax.Array] = None,
    w_noise: Optional[jnp.ndarray] = None,
    noisy_routing_alpha: float = 0.0,
    load_balancing_loss_coef: float = 0.0,
    router_z_loss_coef: float = 0.0,
    use_load_balancing_loss: bool = True,
    use_router_z_loss: bool = True,
) -> RouterOutput:
    num_experts = router_w.shape[-1]
    normed = layer_norm(x, router_ln_w, router_ln_b, eps=layer_norm_eps)
    logits = (normed.astype(jnp.float32) @ router_w.astype(jnp.float32)
              + router_b.astype(jnp.float32))

    if training and w_noise is not None and noise_rng is not None and noisy_routing_alpha > 0:
        noise_scale = jax.nn.softplus(w_noise.astype(jnp.float32)) * noisy_routing_alpha
        logits = logits + jax.random.normal(noise_rng, logits.shape) * noise_scale[None, :]

    gates = jax.nn.softmax(logits, axis=-1)                     # (S, E)
    top_w, top_i = _top_k_gates(gates, top_k)                   # (S, K)

    lb_loss = jnp.zeros((), jnp.float32)
    if training and use_load_balancing_loss and load_balancing_loss_coef > 0:
        p_i = jnp.mean(gates, axis=0)
        sel = jnp.sum(jax.nn.one_hot(top_i, num_experts, dtype=jnp.float32), axis=1)
        sel = jnp.minimum(sel, 1.0)  # 1 iff expert in token's top-k
        f_i = jnp.mean(sel, axis=0)
        lb_loss = load_balancing_loss_coef * num_experts * jnp.sum(f_i * p_i)

    rz_loss = jnp.zeros((), jnp.float32)
    if training and use_router_z_loss and router_z_loss_coef > 0:
        log_z = jax.nn.logsumexp(logits, axis=-1)
        rz_loss = router_z_loss_coef * jnp.mean(jnp.square(log_z))

    weights = top_w / (jnp.sum(top_w, axis=-1, keepdims=True) + 1e-6)
    return RouterOutput(weights, top_i, lb_loss, rz_loss)


def _top_k_gates(gates: jnp.ndarray, k: int):
    """Top-k over the (small) expert axis.

    ``lax.top_k`` lowers to a generic sort pipeline; for the k<=2 routing
    that runs once per layer per decode step, two argmax passes over E<=64
    gates are two reductions with identical tie-breaking (first index
    wins)."""
    if k > 2 or gates.shape[-1] > 64:
        return jax.lax.top_k(gates, k)
    i1 = jnp.argmax(gates, axis=-1)
    w1 = jnp.take_along_axis(gates, i1[:, None], axis=-1)[:, 0]
    if k == 1:
        return w1[:, None], i1[:, None].astype(jnp.int32)
    masked = gates.at[jnp.arange(gates.shape[0]), i1].set(-jnp.inf)
    i2 = jnp.argmax(masked, axis=-1)
    w2 = jnp.take_along_axis(gates, i2[:, None], axis=-1)[:, 0]
    return (jnp.stack([w1, w2], axis=-1),
            jnp.stack([i1, i2], axis=-1).astype(jnp.int32))


def _expert_mlp(
    x: jnp.ndarray,            # (..., H) tokens already grouped per expert
    ln_w: jnp.ndarray, ln_b: jnp.ndarray,       # (H,)
    w1: jnp.ndarray, b1: jnp.ndarray,           # (H, I), (I,)
    w2: jnp.ndarray, b2: jnp.ndarray,           # (I, H), (H,)
    act_fn,
    layer_norm_eps: float,
) -> jnp.ndarray:
    h = layer_norm(x, ln_w, ln_b, eps=layer_norm_eps)
    h = act_fn(h @ w1 + b1)
    return h @ w2 + b2


def _use_dyn_int8(expert_params: dict, rows: int) -> bool:
    """Dense-path mirror of models.apertis._linear: dynamic int8 expert
    GEMMs by the same row-count rule (ops/quant.use_dyn)."""
    if "w1_q" not in expert_params or "w2_q" not in expert_params:
        return False
    return quant_ops.use_dyn(rows)


def _maybe_dequant_experts(expert_params: dict, dtype) -> dict:
    """Resolve int8 expert stacks ({w1_q, w1_s} from models/quantize.py) to
    compute-dtype weights. The dequant multiply is a broadcast over the
    output channel, which XLA fuses into the consuming (ragged) matmul's
    operand load — expert weight traffic stays at int8 width."""
    if "w1_q" not in expert_params and "w2_q" not in expert_params:
        return expert_params
    out = dict(expert_params)
    for key in ("w1", "w2"):
        if key + "_q" in out:
            out[key] = (out.pop(key + "_q").astype(dtype)
                        * out.pop(key + "_s").astype(dtype))
    return out


def _dyn_int8_batched(x: jnp.ndarray, w_q: jnp.ndarray, w_s: jnp.ndarray):
    """Batched dynamic-activation int8 matmul: (E,S,K) @ (E,K,N).

    Per-(expert,row) activation scales; same contract as
    ops.quant.quant_matmul_dyn_xla with a leading batch dim."""
    e, s, k = x.shape
    x_q, x_s = quant_ops.quantize_rows(x.reshape(e * s, k))
    acc = jax.lax.dot_general(
        x_q.reshape(e, s, k), w_q, (((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.int32)                  # (E, S, N)
    # w_s comes keepdims-shaped (E, 1, N) from quantize_weight.
    return (acc.astype(jnp.float32) * x_s.reshape(e, s, 1)
            * w_s.reshape(e, 1, -1).astype(jnp.float32)).astype(x.dtype)


def _moe_dense_int8(x, expert_params, act_fn, layer_norm_eps):
    """All-expert forward with dynamic int8 expert GEMMs (decode hot path)."""
    ep = expert_params
    xn = jax.vmap(lambda lw, lb: layer_norm(x, lw, lb, eps=layer_norm_eps))(
        ep["ln_w"], ep["ln_b"])                            # (E, S, H)
    h = _dyn_int8_batched(xn, ep["w1_q"], ep["w1_s"])
    h = act_fn(h + ep["b1"][:, None, :])
    y = _dyn_int8_batched(h, ep["w2_q"], ep["w2_s"])
    return y + ep["b2"][:, None, :]                        # (E, S, H)


def moe_dense(
    x: jnp.ndarray,            # (S, H)
    routing: RouterOutput,
    expert_params: dict,       # stacked: ln_w/ln_b (E,H), w1 (E,H,I), b1 (E,I), w2 (E,I,H), b2 (E,H)
    hidden_act: str,
    layer_norm_eps: float,
    active_mask: Optional[jnp.ndarray] = None,  # (E,) bool
) -> jnp.ndarray:
    """Run every expert on every token; combine with routing weights."""
    act_fn = get_activation(hidden_act)
    if _use_dyn_int8(expert_params, x.shape[0]):
        all_out = _moe_dense_int8(x, expert_params, act_fn, layer_norm_eps)
        num_experts = expert_params["w1_q"].shape[0]
    else:
        expert_params = _maybe_dequant_experts(expert_params, x.dtype)
        num_experts = expert_params["w1"].shape[0]
        all_out = jax.vmap(
            lambda lw, lb, w1, b1, w2, b2: _expert_mlp(
                x, lw, lb, w1, b1, w2, b2, act_fn, layer_norm_eps)
        )(expert_params["ln_w"], expert_params["ln_b"],
          expert_params["w1"], expert_params["b1"],
          expert_params["w2"], expert_params["b2"])          # (E, S, H)

    combine = _combine_weights(routing, num_experts, x.dtype, active_mask)
    return jnp.einsum("se,esh->sh", combine, all_out)


def _combine_weights(
    routing: RouterOutput,
    num_experts: int,
    dtype,
    active_mask: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """(S, E) combine matrix: routing weight where expert selected, else 0."""
    onehot = jax.nn.one_hot(routing.indices, num_experts, dtype=dtype)  # (S, K, E)
    combine = jnp.einsum("ske,sk->se", onehot, routing.weights.astype(dtype))
    if active_mask is not None:
        combine = combine * active_mask.astype(combine.dtype)[None, :]
    return combine


def moe_dense_fat(
    x: jnp.ndarray,            # (S, H)
    routing: RouterOutput,
    expert_params: dict,       # carries the "fat" stack (models/moe_fuse.py)
    hidden_act: str,
    layer_norm_eps: float,
    active_mask: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Dense all-expert combine as TWO plain 2D int8 GEMMs.

    sum_e combine[s,e] * (act(LN_e(x) @ W1_e + b1_e) @ W2_e + b2_e)
    re-associates into (S,H)@(H,E*I) and (S,E*I)@(E*I,H) with the combine
    weights folded into the hidden activations (inactive experts' entries
    are exactly zero) and sum_e combine[s,e]*b2_e = combine @ b2 added
    outside — no batched dots, sorts, or gathers. Same math as moe_dense
    up to int8 rounding; W2's shared-per-channel scales are the one extra
    quantization coarsening (models/moe_fuse._fuse_one_fat)."""
    quantize_rows = quant_ops.quantize_rows
    fat = expert_params["fat"]
    act_fn = get_activation(hidden_act)
    num_experts = expert_params["b2"].shape[0]
    s, h = x.shape
    ei = fat["b1t"].shape[0]

    # Shared un-affine LayerNorm (affines live in W1/b1). quantize_rows is
    # scale-invariant per row, so quantizing (x - mean) and folding the
    # normalisation inverse into the row scale is exact.
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(xf - mean), axis=-1, keepdims=True)
    inv = jnp.where(var > 0, jax.lax.rsqrt(var + layer_norm_eps), 0.0)
    xq, xs = quantize_rows(xf - mean)
    xs = xs * inv

    w1t, w2t = fat["w1t_q"], fat["w2t_q"]
    acc1 = jax.lax.dot_general(xq, w1t, (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)  # (S, E*I)
    hidden = act_fn(acc1.astype(jnp.float32) * xs
                    * fat["w1t_s"].astype(jnp.float32) + fat["b1t"])

    combine = _combine_weights(routing, num_experts, jnp.float32, active_mask)
    hidden = hidden * jnp.repeat(combine, ei // num_experts, axis=1)

    hq, hs = quantize_rows(hidden)
    acc2 = jax.lax.dot_general(hq, w2t, (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)  # (S, H)
    out = (acc2.astype(jnp.float32) * hs * fat["w2t_s"].astype(jnp.float32)
           + combine @ expert_params["b2"].astype(jnp.float32))
    return out.astype(x.dtype)


def moe_dispatch(
    x: jnp.ndarray,            # (S, H)
    routing: RouterOutput,
    expert_params: dict,
    hidden_act: str,
    layer_norm_eps: float,
    capacity: int,
    active_mask: Optional[jnp.ndarray] = None,  # (E,) bool
) -> jnp.ndarray:
    """Capacity-bucketed static-shape dispatch -> batched expert MLP -> combine.

    Tokens overflowing an expert's capacity contribute zero for that choice
    (graceful drop, matching the reference's behaviour for over-capacity
    tokens).
    """
    s, h = x.shape
    expert_params = _maybe_dequant_experts(expert_params, x.dtype)
    num_experts = expert_params["w1"].shape[0]
    k = routing.indices.shape[1]
    act_fn = get_activation(hidden_act)

    # Flatten (k-major, token-order) so priority is deterministic.
    flat_idx = routing.indices.T.reshape(-1)                  # (K*S,)
    flat_w = routing.weights.T.reshape(-1)                    # (K*S,)
    onehot = jax.nn.one_hot(flat_idx, num_experts, dtype=jnp.int32)  # (K*S, E)
    # Position of each (token, choice) within its expert's bucket.
    pos_in_expert = jnp.cumsum(onehot, axis=0) - onehot        # (K*S, E)
    pos = jnp.sum(pos_in_expert * onehot, axis=-1)             # (K*S,)
    keep = pos < capacity
    if active_mask is not None:
        keep = keep & active_mask[flat_idx]

    slot = jnp.where(keep, flat_idx * capacity + pos, num_experts * capacity)
    token = jnp.tile(jnp.arange(s), k)                         # (K*S,)

    # Scatter tokens into buckets; the extra trailing slot absorbs drops.
    buckets = jnp.zeros((num_experts * capacity + 1, h), dtype=x.dtype)
    buckets = buckets.at[slot].add(x[token] * keep[:, None].astype(x.dtype))
    buckets = buckets[:-1].reshape(num_experts, capacity, h)

    out_buckets = jax.vmap(
        lambda xe, lw, lb, w1, b1, w2, b2: _expert_mlp(
            xe, lw, lb, w1, b1, w2, b2, act_fn, layer_norm_eps)
    )(buckets, expert_params["ln_w"], expert_params["ln_b"],
      expert_params["w1"], expert_params["b1"],
      expert_params["w2"], expert_params["b2"])                # (E, C, H)

    flat_out = out_buckets.reshape(num_experts * capacity, h)
    gathered = flat_out[jnp.clip(slot, 0, num_experts * capacity - 1)]
    gathered = gathered * (flat_w * keep.astype(flat_w.dtype))[:, None].astype(x.dtype)

    out = jnp.zeros_like(x)
    out = out.at[token].add(gathered)
    return out


def moe_ragged(
    x: jnp.ndarray,            # (S, H)
    routing: RouterOutput,
    expert_params: dict,
    hidden_act: str,
    layer_norm_eps: float,
    active_mask: Optional[jnp.ndarray] = None,  # (E,) bool
) -> jnp.ndarray:
    """Sort-based dispatch with grouped matmuls (``jax.lax.ragged_dot``).

    Token-choice pairs are sorted by expert; each expert's contiguous row
    group multiplies its own weights in one grouped matmul. No
    capacity limit: every selected (token, expert) pair is computed, so the
    result equals :func:`moe_dense` exactly (up to fp reassociation) at
    1/E of its FLOPs. This is the default training/prefill path.
    """
    s, h = x.shape
    k = routing.indices.shape[1]
    # int8 ragged_dot is opt-in (APERTIS_QUANT_MATMUL=dyn): the grouped
    # GEMM's int32 accumulators leave the custom call unfused. Its cost on
    # the GPU is not measured.
    int8 = "w1_q" in expert_params and quant_ops.quant_mode() == "dyn"
    if not int8:
        expert_params = _maybe_dequant_experts(expert_params, x.dtype)
    num_experts = expert_params["ln_w"].shape[0]
    act_fn = get_activation(hidden_act)

    flat_e = routing.indices.reshape(-1)                 # (S*K) token-major
    flat_w = routing.weights.reshape(-1).astype(x.dtype)
    if active_mask is not None:
        flat_w = flat_w * active_mask[flat_e].astype(flat_w.dtype)

    order = jnp.argsort(flat_e)                          # stable sort
    tok = order // k                                     # source token per slot
    e_sorted = flat_e[order]
    group_sizes = jnp.bincount(flat_e, length=num_experts).astype(jnp.int32)

    xs = x[tok]                                          # (S*K, H) grouped
    xn = layer_norm(xs, expert_params["ln_w"][e_sorted],
                    expert_params["ln_b"][e_sorted], eps=layer_norm_eps)
    if int8:
        # Dynamic-activation int8 grouped matmuls: the expert weights
        # stream at int8 width with no dequantized copy.
        quantize_rows = quant_ops.quantize_rows
        ep = expert_params
        xq, xss = quantize_rows(xn)
        acc1 = jax.lax.ragged_dot(xq, ep["w1_q"], group_sizes,
                                  preferred_element_type=jnp.int32)
        hmid = (acc1.astype(jnp.float32) * xss
                * ep["w1_s"].reshape(num_experts, -1)[e_sorted])
        hmid = act_fn(hmid + ep["b1"][e_sorted])
        hq, hss = quantize_rows(hmid)
        acc2 = jax.lax.ragged_dot(hq, ep["w2_q"], group_sizes,
                                  preferred_element_type=jnp.int32)
        y = (acc2.astype(jnp.float32) * hss
             * ep["w2_s"].reshape(num_experts, -1)[e_sorted])
        y = (y + ep["b2"][e_sorted]).astype(x.dtype)
    else:
        hmid = jax.lax.ragged_dot(xn, expert_params["w1"], group_sizes)
        hmid = act_fn(hmid + expert_params["b1"][e_sorted])
        y = jax.lax.ragged_dot(hmid, expert_params["w2"], group_sizes)
        y = y + expert_params["b2"][e_sorted]

    y = y * flat_w[order][:, None]
    out = jnp.zeros_like(x)
    return out.at[tok].add(y)


def expert_dropout_mask(
    rng: jax.Array,
    num_experts: int,
    expert_dropout_prob: float,
) -> jnp.ndarray:
    """Drop whole experts for a step (training only). At least one expert
    always survives (reference: core.py:513-521)."""
    num_to_drop = int(num_experts * expert_dropout_prob)
    if num_to_drop >= num_experts:
        num_to_drop = num_experts - 1
    mask = jnp.ones((num_experts,), dtype=bool)
    if num_to_drop <= 0:
        return mask
    perm = jax.random.permutation(rng, num_experts)
    return mask.at[perm[:num_to_drop]].set(False)
