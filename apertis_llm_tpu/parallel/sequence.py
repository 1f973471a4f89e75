"""Sequence/context parallelism for the selective-SSM mixer.

The SSM's linear recurrence composes associatively across sequence chunks,
so long-context training can shard L over a mesh axis: each device scans its
local chunk, the tiny (decay-product, final-state) chunk summaries are
exchanged with one all-gather between devices, and an exclusive prefix-combine
gives every device its incoming state. This single mechanism covers the
CP/ring-attention role for the SSM path (SURVEY.md §2.8: the reference has
no sequence parallelism of any kind).

Math: for chunk c with local zero-init scan h0[t] and cumulative decay
A[t] = prod_{s<=t} a[s], the true states are

    h[t]   = h0[t] + A[t] * h_in(c)
    h_in(c) = fold over chunks d < c of  h <- P(d) * h + S(d)

where P(d), S(d) are chunk d's total decay product and zero-init final
state.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from apertis_llm_tpu.ops.ssm import selective_scan


def ssm_scan_sequence_parallel(
    a_bar: jnp.ndarray,   # (B, H, L, N), L sharded over `axis`
    b_term: jnp.ndarray,
    mesh: Mesh,
    axis: str = "model",
    batch_axis: str = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Sequence-sharded scan; same contract as ops.ssm.selective_scan.

    Returns (h, h_last): ``h`` sharded along L like the inputs; ``h_last``
    replicated over `axis`. Cross-chunk traffic is one all-gather of
    (B, H, N)-sized summaries. ``batch_axis`` preserves an existing
    data-parallel batch sharding (SP composes with DP on one mesh).
    """
    seq_spec = P(batch_axis, None, axis, None)

    def body(a_blk, b_blk):
        # Local chunk scan + cumulative decay products (scan of (a, 0) from 1).
        h0, s_last = selective_scan(a_blk, b_blk)
        cum, p_last = selective_scan(
            a_blk, jnp.zeros_like(b_blk),
            h_init=jnp.ones_like(a_blk[:, :, 0, :]))

        p_all = jax.lax.all_gather(p_last, axis)   # (n_dev, B, H, N)
        s_all = jax.lax.all_gather(s_last, axis)
        idx = jax.lax.axis_index(axis)
        n = p_all.shape[0]

        def step(c, carry):
            h_in, h_total = carry
            p_c = jax.lax.dynamic_index_in_dim(p_all, c, 0, keepdims=False)
            s_c = jax.lax.dynamic_index_in_dim(s_all, c, 0, keepdims=False)
            combined = p_c * h_total + s_c
            # h_in freezes once we reach this device's own chunk.
            h_in = jnp.where(c < idx, combined, h_in)
            return h_in, combined

        zero = jnp.zeros_like(s_last)
        h_in, h_total = jax.lax.fori_loop(0, n, step, (zero, zero))
        h = h0 + cum * h_in[:, :, None, :]
        return h, h_total

    # h_total is mathematically identical on every device (each folds ALL
    # chunk summaries), which shard_map cannot infer -> check_vma=False.
    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(seq_spec, seq_spec),
        out_specs=(seq_spec, P(batch_axis, None, None)),
        check_vma=False,
    )(a_bar, b_term)
