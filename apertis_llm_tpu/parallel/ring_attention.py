"""Ring attention: context parallelism for the standard-MHA path.

Shards the sequence axis of Q/K/V over a mesh axis and rotates K/V chunks
around the ring with ``ppermute``, merging per-chunk attention with the
online-softmax rule — every device only ever holds O(L/n) keys, enabling
contexts that exceed one chip's memory. This is the MHA counterpart of the
SSM's carried-state sequence parallelism (SURVEY.md §2.8: "for the MHA
path, splash/ring attention kernel optional" — the reference has nothing).

Causal masking uses global positions reconstructed from each chunk's source
device, so the result matches single-device causal attention exactly.
Differentiating through the loop reverses the permutes (same property the
GPipe schedule relies on).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

NEG_INF = -1e30


def ring_attention(
    q: jnp.ndarray,  # (B, H, L, D), L sharded over `axis`
    k: jnp.ndarray,
    v: jnp.ndarray,
    mesh: Mesh,
    axis: str = "model",
    causal: bool = True,
    kv_valid: jnp.ndarray = None,   # (B, L) 1 = real key; None = all valid
    batch_axis: str = None,
) -> jnp.ndarray:
    """Sequence-sharded attention; output keeps the input sharding.

    ``kv_valid`` masks padded keys (the engine/trainer's right-padded
    batches) — it rotates around the ring with its K/V chunk. ``batch_axis``
    preserves an existing data-parallel batch sharding.
    """
    seq_spec = P(batch_axis, None, axis, None)
    b_all = q.shape[0]
    if kv_valid is None:
        kv_valid = jnp.ones((b_all, q.shape[2]), jnp.int32)

    def body(q_blk, k_blk, v_blk, valid_blk):
        n = jax.lax.axis_size(axis)
        idx = jax.lax.axis_index(axis)
        b, h, c, d = q_blk.shape
        scale = d ** -0.5
        qf = q_blk.astype(jnp.float32) * scale
        rows = idx * c + jnp.arange(c)                     # global q positions

        def step(s, carry):
            kc, vc, validc, m, l, acc = carry
            src = (idx - s) % n                            # chunk's home device
            cols = src * c + jnp.arange(c)
            scores = jnp.einsum("bhqd,bhkd->bhqk", qf,
                                kc.astype(jnp.float32))
            mask = (validc[:, None, None, :] > 0)          # (B,1,1,C)
            if causal:
                mask = mask & (rows[:, None] >= cols[None, :])[None, None]
            scores = jnp.where(mask, scores, NEG_INF)
            m_new = jnp.maximum(m, jnp.max(scores, axis=-1, keepdims=True))
            p = jnp.exp(scores - m_new)
            alpha = jnp.exp(m - m_new)
            l = l * alpha + jnp.sum(p, axis=-1, keepdims=True)
            acc = acc * alpha + jnp.einsum(
                "bhqk,bhkd->bhqd", p, vc.astype(jnp.float32))
            # Rotate K/V (+ validity) to the next device (a ring over the mesh axis).
            perm = [(i, (i + 1) % n) for i in range(n)]
            kc = jax.lax.ppermute(kc, axis, perm)
            vc = jax.lax.ppermute(vc, axis, perm)
            validc = jax.lax.ppermute(validc, axis, perm)
            return kc, vc, validc, m_new, l, acc

        # The constants start axis-invariant but the loop makes them
        # device-varying (over every manual axis in scope); declare that up
        # front so the carry types match.
        axes = (axis,) if batch_axis is None else (axis, batch_axis)

        def _varying(x):
            pcast = getattr(jax.lax, "pcast", None)
            if pcast is not None:
                return pcast(x, axes, to="varying")
            return jax.lax.pvary(x, axes)

        m0 = _varying(jnp.full((b, h, c, 1), NEG_INF, jnp.float32))
        l0 = _varying(jnp.zeros((b, h, c, 1), jnp.float32))
        acc0 = _varying(jnp.zeros((b, h, c, d), jnp.float32))
        _, _, _, _, l, acc = jax.lax.fori_loop(
            0, n, step, (k_blk, v_blk, valid_blk, m0, l0, acc0))
        return (acc / jnp.maximum(l, 1e-30)).astype(q_blk.dtype)

    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(seq_spec, seq_spec, seq_spec, P(batch_axis, axis)),
        out_specs=seq_spec,
    )(q, k, v, kv_valid.astype(jnp.int32))
