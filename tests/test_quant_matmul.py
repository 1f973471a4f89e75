"""int8 serving matmuls (ops/quant.py) vs the dequant reference."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from apertis_llm_tpu.models.apertis import _linear
from apertis_llm_tpu.models.quantize import quantize_weight
from apertis_llm_tpu.ops import quant as quant_ops
from apertis_llm_tpu.ops.quant import quant_matmul_dyn_xla, quantize_rows


@pytest.mark.parametrize("m,k,n", [(4, 64, 96), (17, 608, 2432), (32, 2432, 608)])
def test_quant_matmul_matches_dequant(m, k, n, monkeypatch):
    """Weight-only path of _linear: exact dequant math."""
    monkeypatch.setenv("APERTIS_QUANT_MATMUL", "weightonly")
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(m, k)), jnp.float32)
    w = jnp.asarray(rng.normal(size=(k, n)) * 0.05, jnp.float32)
    w_q, w_s = quantize_weight(w)

    ref = x @ (w_q.astype(jnp.float32) * w_s)
    got = _linear({"w_q": w_q, "w_s": w_s}, x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)


def test_quant_matmul_batched_leading_dims(monkeypatch):
    monkeypatch.setenv("APERTIS_QUANT_MATMUL", "weightonly")
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(2, 5, 64)), jnp.float32)
    w = jnp.asarray(rng.normal(size=(64, 128)) * 0.1, jnp.float32)
    w_q, w_s = quantize_weight(w)
    ref = x @ (w_q.astype(jnp.float32) * w_s)
    got = _linear({"w_q": w_q, "w_s": w_s, "b": jnp.zeros(128)}, x)
    assert got.shape == (2, 5, 128)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)


def test_quant_matmul_grad_flows_to_x(monkeypatch):
    """Both paths differentiate in x through the dequantized weight."""
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.normal(size=(4, 64)), jnp.float32)
    w = jnp.asarray(rng.normal(size=(64, 96)) * 0.1, jnp.float32)
    w_q, w_s = quantize_weight(w)
    wd = w_q.astype(jnp.float32) * w_s
    g_ref = jax.grad(lambda x: jnp.sum((x @ wd) ** 2))(x)
    for mode, tol in (("weightonly", 2e-4), ("dyn", 0.05)):
        monkeypatch.setenv("APERTIS_QUANT_MATMUL", mode)
        g = jax.grad(lambda x: jnp.sum(
            _linear({"w_q": w_q, "w_s": w_s}, x) ** 2))(x)
        np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref),
                                   rtol=tol, atol=tol, err_msg=mode)


def test_auto_mode_chooses_by_row_count(monkeypatch):
    """auto: dynamic int8 from DYN_MIN_ROWS rows up, weight-only below;
    the pinned modes ignore the row count; anything else is refused."""
    monkeypatch.delenv("APERTIS_QUANT_MATMUL", raising=False)
    t = quant_ops.DYN_MIN_ROWS
    assert not quant_ops.use_dyn(t - 1) and quant_ops.use_dyn(t)
    monkeypatch.setenv("APERTIS_QUANT_MATMUL", "dyn")
    assert quant_ops.use_dyn(1)
    monkeypatch.setenv("APERTIS_QUANT_MATMUL", "weightonly")
    assert not quant_ops.use_dyn(1 << 20)
    monkeypatch.setenv("APERTIS_QUANT_MATMUL", "pallas")
    with pytest.raises(ValueError):
        quant_ops.use_dyn(1)


class TestDynamicActivationInt8:
    """quant_matmul_dyn_xla: int8 x int8 math with per-row activation
    scales."""

    @pytest.mark.parametrize("m,k,n", [(4, 64, 96), (17, 608, 2432),
                                       (256, 2432, 608)])
    def test_matches_integer_emulation(self, m, k, n):
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.normal(size=(m, k)), jnp.float32)
        w = jnp.asarray(rng.normal(size=(k, n)) * 0.05, jnp.float32)
        w_q, w_s = quantize_weight(w)
        x_q, x_s = quantize_rows(x)

        # Integer accumulation is exact (|acc| <= 127*127*K < 2^24), so the
        # dot must match the f32 emulation of the same quantized math.
        ref = (x_q.astype(jnp.float32) @ w_q.astype(jnp.float32)) * x_s * w_s
        got = quant_matmul_dyn_xla(x, w_q, w_s)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=2e-4, atol=2e-4)

    def test_close_to_float_matmul(self):
        rng = np.random.default_rng(1)
        x = jnp.asarray(rng.normal(size=(32, 512)), jnp.float32)
        w = jnp.asarray(rng.normal(size=(512, 256)) * 0.05, jnp.float32)
        w_q, w_s = quantize_weight(w)
        ref = x @ w
        got = np.asarray(quant_matmul_dyn_xla(x, w_q, w_s), np.float32)
        denom = np.maximum(np.abs(np.asarray(ref)), 1.0)
        assert np.max(np.abs(got - np.asarray(ref)) / denom) < 0.06

    def test_batched_leading_dims_and_grad(self):
        rng = np.random.default_rng(2)
        x = jnp.asarray(rng.normal(size=(2, 5, 64)), jnp.float32)
        w = jnp.asarray(rng.normal(size=(64, 128)) * 0.1, jnp.float32)
        w_q, w_s = quantize_weight(w)
        out = quant_matmul_dyn_xla(x, w_q, w_s)
        assert out.shape == (2, 5, 128)

        g = jax.grad(lambda x: jnp.sum(quant_matmul_dyn_xla(x, w_q, w_s) ** 2))(
            x.reshape(10, 64))
        wd = w_q.astype(jnp.float32) * w_s
        g_ref = jax.grad(lambda x: jnp.sum((x @ wd) ** 2))(x.reshape(10, 64))
        # Backward flows through the dequantised weight (same as weight-only);
        # forward rounding shifts the cotangent slightly.
        np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref),
                                   rtol=0.05, atol=0.05)

    def test_dyn_xla_matches_integer_emulation(self):
        rng = np.random.default_rng(3)
        x = jnp.asarray(rng.normal(size=(256, 608)), jnp.float32)
        w = jnp.asarray(rng.normal(size=(608, 384)) * 0.05, jnp.float32)
        w_q, w_s = quantize_weight(w)
        x_q, x_s = quantize_rows(x)
        ref = (x_q.astype(jnp.float32) @ w_q.astype(jnp.float32)) * x_s * w_s
        got = quant_matmul_dyn_xla(x, w_q, w_s)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=2e-4, atol=2e-4)
        g = jax.grad(lambda x: jnp.sum(quant_matmul_dyn_xla(x, w_q, w_s)))(x)
        assert g.shape == x.shape


@pytest.mark.parametrize("rows,dyn", [(quant_ops.DYN_MIN_ROWS - 1, False),
                                      (quant_ops.DYN_MIN_ROWS, True)])
def test_auto_dispatch_lowers_to_the_chosen_dot(rows, dyn, monkeypatch):
    """auto lowers to an int8 x int8 dot from DYN_MIN_ROWS rows up and to
    a dequantized float dot below."""
    monkeypatch.delenv("APERTIS_QUANT_MATMUL", raising=False)
    w_q, w_s = quantize_weight(jnp.ones((64, 32)) * 0.1)
    x = jnp.ones((rows, 64), jnp.bfloat16)
    text = str(jax.make_jaxpr(
        lambda x: _linear({"w_q": w_q, "w_s": w_s}, x))(x))
    assert ("preferred_element_type=int32" in text) == dyn


def test_moe_dense_dispatch_follows_the_row_rule(monkeypatch):
    from apertis_llm_tpu.ops.moe import _use_dyn_int8

    monkeypatch.delenv("APERTIS_QUANT_MATMUL", raising=False)
    experts = {"w1_q": 0, "w2_q": 0}
    assert not _use_dyn_int8(experts, quant_ops.DYN_MIN_ROWS - 1)
    assert _use_dyn_int8(experts, quant_ops.DYN_MIN_ROWS)
    assert not _use_dyn_int8({"w1": 0, "w2": 0}, 1 << 20)


def test_quantize_rows_zero_row_and_scale():
    x = jnp.asarray([[0.0, 0.0, 0.0], [1.0, -2.0, 0.5]])
    q, s = quantize_rows(x)
    assert q.dtype == jnp.int8 and s.shape == (2, 1)
    np.testing.assert_array_equal(np.asarray(q[0]), 0)
    np.testing.assert_array_equal(np.asarray(q[1]), [64, -127, 32])
    np.testing.assert_allclose(float(s[1, 0]), 2.0 / 127.0, rtol=1e-6)
