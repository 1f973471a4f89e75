"""Expert-parallel MoE dispatch with explicit all-to-all (SURVEY.md §2.8).

The GSPMD path (``ops.moe.moe_ragged`` under an expert-sharded weight tree)
is numerically correct but leaves the communication pattern to the compiler.
This module is the engineered path: a ``shard_map`` over the ``expert`` mesh
axis in which each device

  1. buckets its local (token, choice) pairs by DESTINATION device
     (``global_expert_id // experts_per_device``) into a static
     (n_devices, capacity, H) send buffer,
  2. exchanges buffers with ONE ``jax.lax.all_to_all`` between devices,
  3. runs its local expert stack on the received tokens (sort-by-local-expert
     + ``jax.lax.ragged_dot`` grouped matmul, same engine as moe_ragged),
  4. returns outputs with a second ``all_to_all`` and combines them into the
     source tokens with the routing weights.

Comm volume per MoE layer per device = 2 x n_dev x capacity x H x dtype
~= 2 x S_local x K x capacity_factor x H bytes — independent of the expert
count, the signature of true all-to-all dispatch (an activation all-gather
would be n_dev x that). tests/test_moe_ep.py asserts both numerics and the
presence of all-to-all (and absence of all-gather) in the compiled HLO.

Capacity semantics: pairs overflowing a (source device -> destination
device) bucket are dropped (contribute zero), like Switch-style capacity
dispatch. With ``capacity_factor`` >= n_dev the bucket can hold every local
pair, making the result exactly equal to ``moe_dense``/``moe_ragged``.

Replaces: the reference's single-device Python dispatch loop
(/root/reference/src/model/core.py:547-605) at multi-chip scale.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from apertis_llm_tpu.ops.activations import get_activation
from apertis_llm_tpu.ops.moe import RouterOutput, _maybe_dequant_experts
from apertis_llm_tpu.ops.norms import layer_norm


def ep_capacity(s_local: int, k: int, n_dev: int, capacity_factor: float) -> int:
    """Per-(src, dst) bucket slots: expected load x factor, >= 1."""
    return max(1, int((s_local * k / n_dev) * capacity_factor))


def moe_expert_parallel(
    x: jnp.ndarray,            # (S, H) flat tokens
    routing: RouterOutput,
    expert_params: dict,       # stacked (E, ...) leaves, expert-sharded
    hidden_act: str,
    layer_norm_eps: float,
    mesh: Mesh,
    expert_axis: str = "expert",
    token_axes: Sequence[str] = ("data", "expert"),
    capacity_factor: float = 2.0,
    active_mask: Optional[jnp.ndarray] = None,   # (E,) bool
) -> jnp.ndarray:
    """All-to-all expert dispatch; same contract as ``moe_ragged``.

    ``token_axes`` is the COMPLETE dim-0 sharding of the token array and
    must contain ``expert_axis`` — the expert axis doubles as extra data
    parallelism for non-MoE compute (the trainer lays batches out this
    way). Expert stacks shard dim 0 over ``expert_axis``.
    """
    s, h = x.shape
    k = routing.indices.shape[1]
    n_dev = mesh.shape[expert_axis]
    num_experts = expert_params["w1"].shape[0]
    if expert_axis not in tuple(token_axes):
        raise ValueError(f"token_axes {token_axes} must include {expert_axis}")
    if num_experts % n_dev:
        raise ValueError(f"{num_experts} experts not divisible by "
                         f"expert axis {n_dev}")
    e_loc = num_experts // n_dev
    tok_shards = 1
    for a in token_axes:
        tok_shards *= mesh.shape.get(a, 1)
    if s % tok_shards:
        raise ValueError(f"{s} tokens not divisible by {tok_shards} shards")
    s_loc = s // tok_shards
    cap = ep_capacity(s_loc, k, n_dev, capacity_factor)
    act_fn = get_activation(hidden_act)
    expert_params = _maybe_dequant_experts(expert_params, x.dtype)

    tok_spec = P(tuple(token_axes), None)
    param_specs = jax.tree.map(
        lambda leaf: P(*((expert_axis,) + (None,) * (leaf.ndim - 1))),
        expert_params)

    has_active = active_mask is not None

    def body(x_loc, w_loc, i_loc, ep, *rest):
        amask = rest[0] if has_active else None
        flat_e = i_loc.reshape(-1)                        # (S_loc*K) token-major
        flat_w = w_loc.reshape(-1).astype(x_loc.dtype)
        if amask is not None:
            flat_w = flat_w * amask[flat_e].astype(flat_w.dtype)
        token = jnp.arange(s_loc * k) // k

        # 1. Bucket by destination device.
        dest = flat_e // e_loc                            # (S_loc*K)
        onehot = jax.nn.one_hot(dest, n_dev, dtype=jnp.int32)
        pos = jnp.cumsum(onehot, axis=0) - onehot
        pos = jnp.sum(pos * onehot, axis=-1)
        keep = pos < cap
        slot = jnp.where(keep, dest * cap + pos, n_dev * cap)
        keepf = keep.astype(x_loc.dtype)

        send = jnp.zeros((n_dev * cap + 1, h), x_loc.dtype)
        send = send.at[slot].add(x_loc[token] * keepf[:, None])
        eid = jnp.zeros((n_dev * cap + 1,), jnp.int32)
        eid = eid.at[slot].add(jnp.where(keep, flat_e % e_loc, 0))

        # 2. Exchange buckets (the dispatch all-to-all).
        recv = jax.lax.all_to_all(
            send[:-1].reshape(n_dev, cap, h), expert_axis, 0, 0)
        recv_eid = jax.lax.all_to_all(
            eid[:-1].reshape(n_dev, cap), expert_axis, 0, 0)

        # 3. Local expert compute: sort received rows by local expert id and
        # run ONE grouped matmul per projection (empty send slots are zero
        # rows in expert 0's group; their outputs are discarded at combine).
        rows = recv.reshape(n_dev * cap, h)
        eids = recv_eid.reshape(-1)
        order = jnp.argsort(eids)
        rows_sorted = rows[order]
        e_sorted = eids[order]
        group_sizes = jnp.bincount(eids, length=e_loc).astype(jnp.int32)
        xn = layer_norm(rows_sorted, ep["ln_w"][e_sorted],
                        ep["ln_b"][e_sorted], eps=layer_norm_eps)
        hmid = jax.lax.ragged_dot(xn, ep["w1"], group_sizes)
        hmid = act_fn(hmid + ep["b1"][e_sorted])
        y = jax.lax.ragged_dot(hmid, ep["w2"], group_sizes)
        y = y + ep["b2"][e_sorted]
        y_slots = jnp.zeros_like(rows).at[order].set(y)

        # 4. Return outputs (the combine all-to-all) and merge into tokens.
        ret = jax.lax.all_to_all(
            y_slots.reshape(n_dev, cap, h), expert_axis, 0, 0)
        flat_ret = ret.reshape(n_dev * cap, h)
        g = flat_ret[jnp.clip(slot, 0, n_dev * cap - 1)]
        g = g * (flat_w * keepf)[:, None]
        out = jnp.zeros_like(x_loc).at[token].add(g)
        return out

    in_specs = [tok_spec, tok_spec, tok_spec, param_specs]
    args = [x, routing.weights, routing.indices, expert_params]
    if has_active:
        in_specs.append(P(None))
        args.append(active_mask)

    return jax.shard_map(
        body, mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=tok_spec,
        check_vma=False,
    )(*args)
