"""Decode-time MoE FFN weight preparation (combine-folded fat layout).

The dense all-expert decode combine (ops/moe.moe_dense, reference behaviour:
src/model/core.py:547-605) computes, per expert e,

    y_e = act(LN_e(x) @ W1_e + b1_e) @ W2_e + b2_e
    out = sum_e combine[s, e] * y_e[s]

:func:`attach_fused_decode_params` re-lays each layer's expert stack so that
sum becomes two plain 2D int8 GEMMs (ops/moe.moe_dense_fat). Built once by
the inference engine (inference/engine.py) and attached under
``params['layers']['ffn']['experts']['fat']``.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp

from apertis_llm_tpu.models.quantize import quantize_weight

Params = Dict[str, jnp.ndarray]


def _dequant(experts: Params, key: str) -> jnp.ndarray:
    if key + "_q" in experts:
        return (experts[key + "_q"].astype(jnp.float32)
                * experts[key + "_s"].astype(jnp.float32))
    return experts[key].astype(jnp.float32)


def _fuse_one_fat(experts: Params) -> Params:
    """Combine-folded two-fat-2D-GEMM layout for one layer's expert stack.

    The dense all-expert combine sum re-associates into two PLAIN 2D GEMMs
    (sum_e A_e @ B_e == [A_1 .. A_E] @ [B_1; ..; B_E]):

        H1  = xhat_q @ W1_flat            # (S,H) @ (H, E*I), shared x
        out = (combine . act(H1))_q @ W2_flat   # (S, E*I) @ (E*I, H)

    with the per-expert LayerNorm affine folded into W1,
        LN_e(x) @ W1_e = xhat @ (diag(lw_e) W1_e) + (lb_e @ W1_e),
    xhat being the un-affine layer norm shared by every expert, and the routing-combine weights folded into the hidden activations —
    inactive experts' hidden entries are exactly zero, so no batched dots,
    sorts, or gathers remain. W2_flat needs ONE int8 scale per output
    channel shared across experts (the contraction mixes experts), which is
    coarser than per-(expert, channel): experts whose W2 magnitudes sit far
    below the per-channel max lose effective bits (pinned in
    tests/test_moe_fused.py). The b2 term re-enters exactly as combine @ b2
    outside the GEMMs."""
    e, h, i = experts["ln_w"].shape[0], experts["ln_w"].shape[1], (
        experts["w1_q"].shape[-1] if "w1_q" in experts else experts["w1"].shape[-1])
    ln_w = experts["ln_w"].astype(jnp.float32)
    ln_b = experts["ln_b"].astype(jnp.float32)
    w1 = _dequant(experts, "w1")                      # (E, H, I)
    b1 = experts["b1"].astype(jnp.float32)

    w1f = ln_w[:, :, None] * w1
    b1f = b1 + jnp.einsum("eh,ehi->ei", ln_b, w1)     # (E, I)
    w1_flat = jnp.transpose(w1f, (1, 0, 2)).reshape(h, e * i)
    w2_flat = _dequant(experts, "w2").reshape(e * i, h)
    q1, s1 = quantize_weight(w1_flat)                 # scales (1, E*I)
    q2, s2 = quantize_weight(w2_flat)                 # scales (1, H) shared
    return {"w1t_q": q1, "w1t_s": s1, "b1t": b1f.reshape(e * i),
            "w2t_q": q2, "w2t_s": s2}


def fuse_moe_decode_params_fat(experts: Params) -> Params:
    """Layer-stacked variant of :func:`_fuse_one_fat`."""
    fn = _fuse_one_fat
    # ln_w is (E, H) per layer; every extra leading axis is a stack dim.
    for _ in range(experts["ln_w"].ndim - 2):
        fn = jax.vmap(fn)
    return fn(experts)


def attach_fused_decode_params(params):
    """Return ``params`` with the fat decode stack attached (idempotent;
    consumed by ops/moe.moe_dense_fat). No-op for trees without a stacked
    MoE FFN. The original expert tensors stay in place: prefill's ragged
    path and training still read them."""
    layers = params.get("layers") if isinstance(params, dict) else None
    ffn = layers.get("ffn") if isinstance(layers, dict) else None
    experts = ffn.get("experts") if isinstance(ffn, dict) else None
    if not isinstance(experts, dict) or "fat" in experts:
        return params
    if "w1" not in experts and "w1_q" not in experts:
        return params
    new_params = dict(params)
    new_params["layers"] = dict(layers)
    new_params["layers"]["ffn"] = dict(ffn)
    new_params["layers"]["ffn"]["experts"] = {
        **experts, "fat": jax.jit(fuse_moe_decode_params_fat)(experts)}
    return new_params
