"""MoE serving paths: the fat decode layout (models/moe_fuse.py +
ops/moe.moe_dense_fat) and the ragged prefill (ops/moe.moe_ragged).

The fat path re-associates the all-expert combine into two plain int8
GEMMs; its only deviation from ops/moe.moe_dense is int8 rounding, so the
tests pin tolerance against the float dense path and exercise the engine
attach/dispatch wiring end to end.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from apertis_llm_tpu.config import ApertisConfig
from apertis_llm_tpu.models.moe_fuse import (
    attach_fused_decode_params, fuse_moe_decode_params_fat)
from apertis_llm_tpu.models.params import init_params
from apertis_llm_tpu.models.quantize import quantize_params
from apertis_llm_tpu.ops import moe as moe_ops


def _expert_stack(rng, e=4, h=64, i=128, scale_spread=False):
    r = np.random.default_rng(rng)
    ln_w = 1.0 + 0.1 * r.normal(size=(e, h))
    ln_b = 0.05 * r.normal(size=(e, h))
    w1 = 0.08 * r.normal(size=(e, h, i))
    w2 = 0.08 * r.normal(size=(e, i, h))
    if scale_spread:
        # Per-expert magnitude spread exercises the sigma factor.
        mags = np.geomspace(0.1, 10.0, e)[:, None, None]
        w1, w2 = w1 * mags, w2 * mags
    return {
        "ln_w": jnp.asarray(ln_w, jnp.float32),
        "ln_b": jnp.asarray(ln_b, jnp.float32),
        "w1": jnp.asarray(w1, jnp.float32),
        "b1": jnp.asarray(0.02 * r.normal(size=(e, i)), jnp.float32),
        "w2": jnp.asarray(w2, jnp.float32),
        "b2": jnp.asarray(0.02 * r.normal(size=(e, h)), jnp.float32),
    }


def _routing(rng, s, e, k=2):
    r = np.random.default_rng(rng)
    logits = jnp.asarray(r.normal(size=(s, e)), jnp.float32)
    gates = jax.nn.softmax(logits, axis=-1)
    w, i = jax.lax.top_k(gates, k)
    w = w / (jnp.sum(w, axis=-1, keepdims=True) + 1e-6)
    zero = jnp.zeros((), jnp.float32)
    return moe_ops.RouterOutput(w, i.astype(jnp.int32), zero, zero)


@pytest.mark.parametrize("spread", [False, True])
def test_fat_from_quantized_stack_matches_dense(spread):
    """The fat stack built from the int8 serving tree (the engine's input)
    stays within the int8 band of the float dense path."""
    e, h, i, s = 4, 64, 128, 8
    experts = _expert_stack(3, e, h, i, scale_spread=spread)
    routing = _routing(4, s, e)
    x = jnp.asarray(np.random.default_rng(5).normal(size=(s, h)), jnp.float32)
    ref = moe_ops.moe_dense(x, routing, experts, "gelu", 1e-12)
    qtree = quantize_params({"e": experts}, min_size=0)["e"]
    assert "w1_q" in qtree and "w2_q" in qtree
    fat = {**qtree, "fat": fuse_moe_decode_params_fat(qtree)}
    got = moe_ops.moe_dense_fat(x, routing, fat, "gelu", 1e-12)
    denom = float(jnp.max(jnp.abs(ref))) + 1e-6
    tol = 0.12 if spread else 0.06
    assert float(jnp.max(jnp.abs(got - ref))) / denom < tol


def test_fat_odd_rows_and_wide_intermediate():
    e, h, i, s = 2, 32, 256, 13
    experts = _expert_stack(9, e, h, i)
    routing = _routing(10, s, e)
    x = jnp.asarray(np.random.default_rng(11).normal(size=(s, h)), jnp.float32)
    ref = moe_ops.moe_dense(x, routing, experts, "gelu", 1e-12)
    fat = {**experts, "fat": fuse_moe_decode_params_fat(experts)}
    got = moe_ops.moe_dense_fat(x, routing, fat, "gelu", 1e-12)
    assert got.shape == (s, h)
    denom = float(jnp.max(jnp.abs(ref))) + 1e-6
    assert float(jnp.max(jnp.abs(got - ref))) / denom < 0.06


def test_fat_layer_stacked_matches_per_layer():
    """The layer-stacked fat build equals building each layer alone (the
    decode scan slices the stack per layer)."""
    stacked = jax.tree.map(lambda *t: jnp.stack(t),
                           _expert_stack(12), _expert_stack(13))
    fat = fuse_moe_decode_params_fat(stacked)
    for li in range(2):
        one = fuse_moe_decode_params_fat(
            jax.tree.map(lambda t: t[li], stacked))
        for k in one:
            np.testing.assert_array_equal(np.asarray(fat[k][li]),
                                          np.asarray(one[k]))


def test_ragged_prefill_matches_dense():
    """Sort-based ragged_dot dispatch at prefill-scale row counts with
    uneven expert loads equals the all-expert dense combine."""
    e, h, i, s = 4, 64, 256, 300
    experts = _expert_stack(20, e, h, i)
    r = np.random.default_rng(21)
    # Skewed routing: expert 0 takes most first choices.
    logits = jnp.asarray(r.normal(size=(s, e)) + np.array([2.0, 0, 0, -1]),
                         jnp.float32)
    w, idx = jax.lax.top_k(jax.nn.softmax(logits, -1), 2)
    zero = jnp.zeros((), jnp.float32)
    routing = moe_ops.RouterOutput(w / jnp.sum(w, -1, keepdims=True),
                                   idx.astype(jnp.int32), zero, zero)
    x = jnp.asarray(r.normal(size=(s, h)), jnp.float32)
    ref = moe_ops.moe_dense(x, routing, experts, "gelu", 1e-12)
    got = moe_ops.moe_ragged(x, routing, experts, "gelu", 1e-12)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


def test_engine_attaches_and_generates():
    from apertis_llm_tpu.inference.engine import InferenceEngine

    cfg = _moe_config()
    params = quantize_params(init_params(jax.random.PRNGKey(0), cfg),
                             min_size=0)
    eng = InferenceEngine(cfg, params)
    assert "fat" in eng.params["layers"]["ffn"]["experts"]
    assert "fused" not in eng.params["layers"]["ffn"]["experts"]

    prompt = np.array([[5, 7, 9, 11]], np.int32)
    out = eng.generate(prompt, max_new_tokens=4, do_sample=False)
    assert out.shape == (1, 8)


def test_engine_moe_greedy_matches_full_forward():
    """Engine prefill (ragged path) + fat decode produce the greedy tokens
    of repeated full forwards on the same bf16 tree."""
    from apertis_llm_tpu.inference.engine import InferenceEngine
    from apertis_llm_tpu.models import apertis as model_lib

    cfg = ApertisConfig(
        vocab_size=256, hidden_size=128, num_hidden_layers=2,
        num_attention_heads=8, intermediate_size=256,
        attention_type="selective_ssm", ssm_d_state=16,
        use_expert_system=True, num_experts=4, experts_per_token=2,
        moe_dense_threshold_tokens=8,   # prompt rows take the ragged path
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        max_position_embeddings=64)
    params = init_params(jax.random.PRNGKey(3), cfg)
    prompt = np.asarray([[3, 17, 29, 5, 9, 11, 2, 7]], np.int32)
    got = InferenceEngine(cfg, params).generate(
        prompt, max_new_tokens=6, eos_token_id=(), do_sample=False,
        rng=jax.random.PRNGKey(0))[0].tolist()
    ids = prompt
    for _ in range(6):
        logits = model_lib.forward(params, cfg, jnp.asarray(ids)).logits
        nxt = int(jnp.argmax(logits[0, -1]))
        ids = np.concatenate([ids, [[nxt]]], axis=1)
    assert got == ids[0].tolist()


@pytest.mark.parametrize("spread", [False, True])
def test_fat_matches_dense(spread):
    """Combine-folded two-fat-2D-GEMM path vs the float dense path. The
    spread case exercises W2's shared-per-channel scales (the one extra
    coarsening this layout carries)."""
    e, h, i, s = 4, 64, 128, 16
    experts = _expert_stack(0, e, h, i, scale_spread=spread)
    routing = _routing(1, s, e)
    x = jnp.asarray(np.random.default_rng(2).normal(size=(s, h)), jnp.float32)

    ref = moe_ops.moe_dense(x, routing, experts, "gelu", 1e-12)
    fat = {**experts, "fat": fuse_moe_decode_params_fat(experts)}
    got = moe_ops.moe_dense_fat(x, routing, fat, "gelu", 1e-12)

    denom = float(jnp.max(jnp.abs(ref))) + 1e-6
    rel = float(jnp.max(jnp.abs(got - ref))) / denom
    tol = 0.12 if spread else 0.06
    assert rel < tol, f"fat deviates {rel:.4f} from dense (spread={spread})"


def test_fat_active_mask():
    e, h, i, s = 4, 32, 64, 8
    experts = _expert_stack(6, e, h, i)
    routing = _routing(7, s, e)
    x = jnp.asarray(np.random.default_rng(8).normal(size=(s, h)), jnp.float32)
    mask = jnp.asarray([True, False, True, True])

    ref = moe_ops.moe_dense(x, routing, experts, "gelu", 1e-12,
                            active_mask=mask)
    fat = {**experts, "fat": fuse_moe_decode_params_fat(experts)}
    got = moe_ops.moe_dense_fat(x, routing, fat, "gelu", 1e-12,
                                active_mask=mask)
    denom = float(jnp.max(jnp.abs(ref))) + 1e-6
    assert float(jnp.max(jnp.abs(got - ref))) / denom < 0.06


def test_fat_stacked_shapes():
    cfg = _moe_config()
    params = init_params(jax.random.PRNGKey(0), cfg)
    qparams = quantize_params(params, min_size=0)
    fat = fuse_moe_decode_params_fat(qparams["layers"]["ffn"]["experts"])
    L, E, H, I = 2, 4, 64, 128
    assert fat["w1t_q"].shape == (L, H, E * I)
    assert fat["w1t_q"].dtype == jnp.int8
    assert fat["w1t_s"].shape == (L, 1, E * I)
    assert fat["b1t"].shape == (L, E * I)
    assert fat["w2t_q"].shape == (L, E * I, H)
    assert fat["w2t_s"].shape == (L, 1, H)


def _moe_config():
    return ApertisConfig(
        vocab_size=128, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        attention_type="selective_ssm", ssm_d_state=8,
        use_expert_system=True, num_experts=4, experts_per_token=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        max_position_embeddings=256)


def test_attach_idempotent_and_nonmoe_noop():
    cfg = _moe_config()
    params = quantize_params(init_params(jax.random.PRNGKey(0), cfg),
                             min_size=0)
    once = attach_fused_decode_params(params)
    twice = attach_fused_decode_params(once)
    assert once["layers"]["ffn"]["experts"]["fat"] is \
        twice["layers"]["ffn"]["experts"]["fat"]

    dense_cfg = ApertisConfig(
        vocab_size=128, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        attention_type="selective_ssm", ssm_d_state=8,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    dense = init_params(jax.random.PRNGKey(1), dense_cfg)
    assert attach_fused_decode_params(dense) is dense
