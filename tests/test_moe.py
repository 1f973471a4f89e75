"""MoE dispatch-path equivalence and determinism (SURVEY.md §4: add the MoE
dispatch-determinism tests the reference lacked)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from apertis_llm_tpu.ops import moe as moe_ops


def _setup(s=64, h=32, inter=64, e=4, k=2, seed=0):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(s, h)), jnp.float32)
    params = {
        "ln_w": jnp.ones((e, h)),
        "ln_b": jnp.zeros((e, h)),
        "w1": jnp.asarray(rng.normal(size=(e, h, inter)) * 0.05, jnp.float32),
        "b1": jnp.zeros((e, inter)),
        "w2": jnp.asarray(rng.normal(size=(e, inter, h)) * 0.05, jnp.float32),
        "b2": jnp.zeros((e, h)),
    }
    router = {
        "ln_w": jnp.ones((h,)), "ln_b": jnp.zeros((h,)),
        "w": jnp.asarray(rng.normal(size=(h, e)) * 0.1, jnp.float32),
        "b": jnp.zeros((e,)),
    }
    routing = moe_ops.route(
        x, router["ln_w"], router["ln_b"], router["w"], router["b"], k,
        layer_norm_eps=1e-12)
    return x, routing, params


def test_ragged_equals_dense():
    x, routing, params = _setup()
    dense = moe_ops.moe_dense(x, routing, params, "gelu", 1e-12)
    ragged = moe_ops.moe_ragged(x, routing, params, "gelu", 1e-12)
    np.testing.assert_allclose(np.asarray(dense), np.asarray(ragged),
                               rtol=1e-5, atol=1e-5)


def test_ragged_int8_matches_bf16_path():
    """Dynamic-activation int8 grouped matmuls (the prefill path on int8
    serving trees) stay within the activation-rounding band of the
    dequantized bf16 ragged path and keep the routing/dispatch exact."""
    import os

    from apertis_llm_tpu.models.quantize import quantize_weight

    x, routing, params = _setup(s=96, h=64, inter=128)
    qparams = dict(params)
    for key in ("w1", "w2"):
        q, sc = quantize_weight(params[key])
        qparams[key + "_q"], qparams[key + "_s"] = q, sc
        del qparams[key]
    ref = moe_ops.moe_ragged(x, routing, params, "gelu", 1e-12)
    os.environ["APERTIS_QUANT_MATMUL"] = "dyn"   # int8 ragged_dot is opt-in
    try:
        got = moe_ops.moe_ragged(x, routing, qparams, "gelu", 1e-12)
    finally:
        del os.environ["APERTIS_QUANT_MATMUL"]
    scale = float(jnp.max(jnp.abs(ref))) + 1e-6
    err = float(jnp.max(jnp.abs(got - ref))) / scale
    assert err < 2e-2, err


def test_dispatch_with_ample_capacity_equals_dense():
    x, routing, params = _setup()
    dense = moe_ops.moe_dense(x, routing, params, "gelu", 1e-12)
    dispatched = moe_ops.moe_dispatch(x, routing, params, "gelu", 1e-12,
                                      capacity=x.shape[0] * 2)
    np.testing.assert_allclose(np.asarray(dense), np.asarray(dispatched),
                               rtol=1e-5, atol=1e-5)


def test_dispatch_determinism():
    x, routing, params = _setup()
    a = moe_ops.moe_dispatch(x, routing, params, "gelu", 1e-12, capacity=8)
    b = moe_ops.moe_dispatch(x, routing, params, "gelu", 1e-12, capacity=8)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_capacity_drops_overflow_gracefully():
    x, routing, params = _setup()
    tight = moe_ops.moe_dispatch(x, routing, params, "gelu", 1e-12, capacity=1)
    assert np.isfinite(np.asarray(tight)).all()
    # Some tokens must differ from the uncapped result (drops happened).
    full = moe_ops.moe_dense(x, routing, params, "gelu", 1e-12)
    assert not np.allclose(np.asarray(tight), np.asarray(full))


def test_expert_dropout_mask_keeps_one():
    mask = moe_ops.expert_dropout_mask(jax.random.PRNGKey(0), 4, 0.99)
    assert int(jnp.sum(mask)) >= 1


def test_training_with_all_moe_features():
    """Noisy routing + capacity limit + expert dropout + both aux losses,
    all active in a real train step (grads finite, aux losses non-zero)."""
    from apertis_llm_tpu.config import ApertisConfig
    from apertis_llm_tpu.models import apertis as model_lib
    from apertis_llm_tpu.models.params import init_params
    from apertis_llm_tpu.training.step import (
        create_train_state, make_optimizer, make_train_step)

    config = ApertisConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        use_expert_system=True, num_experts=4, experts_per_token=2,
        use_noisy_top_k_routing=True, use_expert_capacity_limit=True,
        use_expert_dropout=True, expert_dropout_prob=0.3,
        use_router_z_loss=True, use_load_balancing_loss=True,
        hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.0)
    params = init_params(jax.random.PRNGKey(0), config)

    ids = jnp.asarray(np.random.default_rng(0).integers(4, 64, (4, 16)))
    out = model_lib.forward(params, config, ids, labels=ids,
                            training=True, rng=jax.random.PRNGKey(1))
    assert float(out.lb_loss) > 0.0
    assert float(out.rz_loss) > 0.0
    assert np.isfinite(float(out.loss))

    tx, _ = make_optimizer(1e-3, 10)
    step = jax.jit(make_train_step(config, tx))
    state = create_train_state(params, tx, jax.random.PRNGKey(2))
    batch = {"input_ids": ids, "attention_mask": jnp.ones_like(ids),
             "labels": ids}
    for _ in range(3):
        state, metrics = step(state, batch)
        assert np.isfinite(float(metrics["loss"]))
        assert np.isfinite(float(metrics["grad_norm"]))


def test_ragged_grads_match_dense():
    x, routing, params = _setup(s=32)

    def loss(fn, params):
        return jnp.sum(fn(x, routing, params, "gelu", 1e-12) ** 2)

    gd = jax.grad(lambda p: loss(moe_ops.moe_dense, p))(params)
    gr = jax.grad(lambda p: loss(moe_ops.moe_ragged, p))(params)
    for key in gd:
        np.testing.assert_allclose(np.asarray(gd[key]), np.asarray(gr[key]),
                                   rtol=1e-4, atol=1e-5, err_msg=key)


def test_dense_int8_dyn_close_to_fp(monkeypatch):
    """The dynamic int8 dense path (the large-row MoE decode path) stays within dynamic
    activation-quantization error of the fp dense combine."""
    import numpy as np
    from apertis_llm_tpu.models.quantize import quantize_params

    rng = np.random.default_rng(11)
    s, h, i, e, k = 256, 64, 128, 4, 2
    x = jnp.asarray(rng.normal(size=(s, h)) * 0.5, jnp.float32)
    ep = {
        "ln_w": jnp.asarray(rng.normal(size=(e, h)) * 0.1 + 1, jnp.float32),
        "ln_b": jnp.asarray(rng.normal(size=(e, h)) * 0.1, jnp.float32),
        "w1": jnp.asarray(rng.normal(size=(e, h, i)) * 0.1, jnp.float32),
        "b1": jnp.asarray(rng.normal(size=(e, i)) * 0.1, jnp.float32),
        "w2": jnp.asarray(rng.normal(size=(e, i, h)) * 0.1, jnp.float32),
        "b2": jnp.asarray(rng.normal(size=(e, h)) * 0.1, jnp.float32),
    }
    router = {
        "ln_w": jnp.ones((h,), jnp.float32), "ln_b": jnp.zeros((h,), jnp.float32),
        "w": jnp.asarray(rng.normal(size=(h, e)) * 0.3, jnp.float32),
        "b": jnp.zeros((e,), jnp.float32),
    }
    routing = moe_ops.route(x, router["ln_w"], router["ln_b"], router["w"],
                            router["b"], k, layer_norm_eps=1e-5)
    ref = moe_ops.moe_dense(x, routing, ep, "gelu", 1e-5)

    epq = quantize_params({"layers": {"experts": ep}}, min_size=0)["layers"]["experts"]
    assert "w1_q" in epq
    monkeypatch.setenv("APERTIS_QUANT_MATMUL", "dyn")
    got = moe_ops.moe_dense(x, routing, epq, "gelu", 1e-5)
    err = np.abs(np.asarray(got - ref)) / (np.abs(np.asarray(ref)) + 1e-2)
    assert float(np.median(err)) < 0.02
    assert float(np.mean(err)) < 0.05

    # weight-only mode on the same quantized tree also stays close
    monkeypatch.setenv("APERTIS_QUANT_MATMUL", "weightonly")
    wo = moe_ops.moe_dense(x, routing, epq, "gelu", 1e-5)
    err = np.abs(np.asarray(wo - ref)) / (np.abs(np.asarray(ref)) + 1e-2)
    assert float(np.median(err)) < 0.02
