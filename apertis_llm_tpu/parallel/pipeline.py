"""Pipeline parallelism: GPipe microbatch schedule over the stacked layer axis.

The model's per-layer parameters are stacked along depth, so sharding that
leading axis over a mesh dimension gives each device a contiguous block of
layers (a stage). This module runs the classic GPipe schedule inside
``shard_map``: at tick t, stage s processes microbatch (t - s) and hands its
activations to stage s+1 with one ``ppermute`` hop. Differentiating
through the schedule reverses the permutes automatically, so the same code
path trains (GPipe with full activation stashing).

The reference has no pipeline parallelism (SURVEY.md §2.8); this is a
capability upgrade for depth-dominated models.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def pipeline_apply(
    layer_params,                 # pytree; leaves (L, ...) sharded over `axis`
    inputs: jnp.ndarray,          # (M, mB, T, D) microbatched activations
    layer_fn: Callable,           # (lp_block, h) -> h   applies ONE layer
    mesh: Mesh,
    axis: str = "model",
) -> jnp.ndarray:
    """Run ``inputs`` through all layers with a GPipe schedule.

    ``layer_fn`` receives one layer's parameter slice and a (mB, T, D)
    activation block. Returns (M, mB, T, D) outputs (replicated).
    """
    n_stages = mesh.shape[axis]
    num_micro = inputs.shape[0]

    def stage_body(local_params, inp):
        s = jax.lax.axis_index(axis)

        def apply_local(h):
            def scan_fn(h, lp):
                return layer_fn(lp, h), None

            h, _ = jax.lax.scan(scan_fn, h, local_params)
            return h

        ticks = num_micro + n_stages - 1
        h_cur = jnp.zeros_like(inp[0])
        outputs = jnp.zeros_like(inp)

        def tick(t, carry):
            h_cur, outputs = carry
            # Stage 0 ingests microbatch t (when one remains).
            feed = jnp.clip(t, 0, num_micro - 1)
            h_in = jnp.where(s == 0, inp[feed], h_cur)
            y = apply_local(h_in)
            # Last stage records its finished microbatch (t - (P-1)).
            out_idx = jnp.clip(t - (n_stages - 1), 0, num_micro - 1)
            write = (s == n_stages - 1) & (t >= n_stages - 1)
            outputs = jax.lax.dynamic_update_index_in_dim(
                outputs,
                jnp.where(write, y, outputs[out_idx]),
                out_idx, 0)
            # Hand activations to the next stage.
            h_next = jax.lax.ppermute(
                y, axis, [(i, (i + 1) % n_stages) for i in range(n_stages)])
            return h_next, outputs

        h_cur, outputs = jax.lax.fori_loop(0, ticks, tick, (h_cur, outputs))
        # Broadcast the last stage's outputs to every device.
        mask = (s == n_stages - 1).astype(outputs.dtype)
        return jax.lax.psum(outputs * mask, axis)

    param_specs = jax.tree.map(lambda _: P(axis), layer_params)
    return jax.shard_map(
        stage_body, mesh=mesh,
        in_specs=(param_specs, P()),
        out_specs=P(),
        check_vma=False,
    )(layer_params, inputs)


def shard_layers_for_pipeline(layer_params, mesh: Mesh, axis: str = "model"):
    """Place stacked layer params with depth sharded over the stage axis."""
    return jax.device_put(
        layer_params,
        jax.tree.map(lambda _: NamedSharding(mesh, P(axis)), layer_params))


def microbatch(x: jnp.ndarray, num_micro: int) -> jnp.ndarray:
    """(B, ...) -> (M, B/M, ...)"""
    b = x.shape[0]
    assert b % num_micro == 0, f"batch {b} not divisible by {num_micro}"
    return x.reshape(num_micro, b // num_micro, *x.shape[1:])
