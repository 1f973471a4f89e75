"""The token mixers' full-sequence paths against independent references on
the CPU.

The SSM mixer's associative scan (``ops/ssm.ssm_mix``, ``selective_scan``)
runs against a step-by-step recurrence, forward and backward; the
fused-attention path (``use_flash_attention``) runs
``jax.nn.dot_product_attention`` against the plain softmax attention.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from apertis_llm_tpu.ops import ssm as ssm_mod


def _inputs(b, l, h, n, seed=0, dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    delta = jnp.asarray(rng.uniform(0.01, 2.0, (b, l, h)), jnp.float32)
    a_cont = -jnp.asarray(rng.uniform(0.1, 1.5, (h, n)), jnp.float32)
    bt = jnp.asarray(rng.normal(size=(b, l, h, n)), dtype)
    ct = jnp.asarray(rng.normal(size=(b, l, h, n)), dtype)
    return delta, a_cont, bt, ct


def _mask(b, l, lens):
    return jnp.asarray(np.arange(l)[None, :] < np.asarray(lens)[:, None],
                       jnp.int32)


def _sequential(delta, a_cont, bt, ct, mask=None, h_init=None):
    """The recurrence one step at a time (``selective_scan_step``, the
    decode update): padded steps keep the state, ``h_init`` is the state
    before step 0."""
    b, l, h, n = bt.shape
    a_bar = jnp.exp(delta[..., None] * a_cont)
    bb = bt.astype(jnp.float32)
    if mask is not None:
        m = mask[:, :, None, None].astype(bool)
        a_bar = jnp.where(m, a_bar, 1.0)
        bb = jnp.where(m, bb, 0.0)
    h0 = (jnp.zeros((b, h, n), jnp.float32) if h_init is None
          else h_init.astype(jnp.float32))

    def step(hc, xs):
        hc = ssm_mod.selective_scan_step(hc, *xs)
        return hc, hc

    h_last, hs = jax.lax.scan(step, h0, (jnp.swapaxes(a_bar, 0, 1),
                                         jnp.swapaxes(bb, 0, 1)))
    hs = jnp.swapaxes(hs, 0, 1)
    return (ct.astype(jnp.float32) * hs).reshape(b, l, h * n), h_last


def _mix(delta, a_cont, bt, ct, mask=None):
    return ssm_mod.ssm_mix(delta, a_cont, bt, ct, seq_mask=mask)


@pytest.mark.parametrize("b,l,h,n", [(2, 13, 3, 16), (2, 16, 3, 16),
                                     (1, 37, 2, 8), (2, 1, 3, 16),
                                     (3, 6, 4, 4)])
def test_ssm_mix_forward_shapes_and_lengths(b, l, h, n):
    """Lengths of one step, odd and power-of-two lengths, several widths."""
    delta, a_cont, bt, ct = _inputs(b, l, h, n)
    y, h_last = _mix(delta, a_cont, bt, ct)
    y_ref, h_ref = _sequential(delta, a_cont, bt, ct)
    assert y.shape == (b, l, h * n) and h_last.shape == (b, h, n)
    assert h_last.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(h_last), np.asarray(h_ref),
                               rtol=1e-5, atol=1e-5)


def test_ssm_mix_masked_rows_carry_last_real_state():
    """Padded steps are identity transitions: h_last is the state after each
    row's last real token."""
    delta, a_cont, bt, ct = _inputs(2, 21, 2, 8, seed=1)
    mask = _mask(2, 21, [21, 9])
    y, h_last = _mix(delta, a_cont, bt, ct, mask)
    y_ref, h_ref = _sequential(delta, a_cont, bt, ct, mask)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(h_last), np.asarray(h_ref),
                               rtol=1e-5, atol=1e-5)
    _, h9 = _sequential(delta[1:, :9], a_cont, bt[1:, :9], ct[1:, :9])
    np.testing.assert_allclose(np.asarray(h_last[1]), np.asarray(h9[0]),
                               rtol=1e-5, atol=1e-5)


def test_selective_scan_h_init():
    """The carried state folds into step 0 (what the sequence-parallel
    composition relies on)."""
    delta, a_cont, bt, ct = _inputs(2, 11, 2, 8, seed=2)
    h0 = jnp.asarray(np.random.default_rng(3).normal(size=(2, 2, 8)),
                     jnp.float32)
    a_bar = jnp.exp(delta[..., None] * a_cont)
    hs, h_last = ssm_mod.selective_scan(jnp.transpose(a_bar, (0, 2, 1, 3)),
                                        jnp.transpose(bt, (0, 2, 1, 3)), h0)
    y_ref, h_ref = _sequential(delta, a_cont, bt, ct, h_init=h0)
    y = (ct * jnp.transpose(hs, (0, 2, 1, 3))).reshape(y_ref.shape)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(h_last), np.asarray(h_ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked,b,l", [(False, 2, 19), (True, 2, 19),
                                        (True, 3, 8), (False, 1, 33)])
def test_ssm_mix_gradients(masked, b, l):
    """Autodiff of the associative scan against autodiff of the step-by-step
    recurrence, for every differentiable input."""
    h, n = 2, 8
    delta, a_cont, bt, ct = _inputs(b, l, h, n, seed=4)
    mask = _mask(b, l, [l] + [l // 2] * (b - 1)) if masked else None

    def loss(fn):
        def f(d, a, bb, cc):
            y, hl = fn(d, a, bb, cc, mask)
            return jnp.sum(jnp.sin(y)) + jnp.sum(hl ** 2)
        return f

    got = jax.grad(loss(_mix), argnums=range(4))(delta, a_cont, bt, ct)
    want = jax.grad(loss(_sequential), argnums=range(4))(
        delta, a_cont, bt, ct)
    for name, g, r in zip(["delta", "A", "b", "c"], got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), rtol=2e-4,
                                   atol=2e-4, err_msg=f"d{name}")


def test_ssm_mix_bf16_io():
    """bf16 b/c in, bf16 y out (the serving dtype); the state stays float32."""
    delta, a_cont, bt, ct = _inputs(1, 10, 2, 8, seed=6, dtype=jnp.bfloat16)
    y, h_last = _mix(delta, a_cont, bt, ct)
    y_ref, h_ref = _sequential(delta, a_cont, bt, ct)
    assert y.dtype == jnp.bfloat16 and h_last.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(y, np.float32), np.asarray(y_ref),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(np.asarray(h_last), np.asarray(h_ref),
                               rtol=1e-5, atol=1e-5)


def test_ssm_mix_out_dtype():
    delta, a_cont, bt, ct = _inputs(2, 9, 2, 8, seed=7)
    y, _ = ssm_mod.ssm_mix(delta, a_cont, bt, ct, out_dtype=jnp.bfloat16)
    y_ref, _ = _sequential(delta, a_cont, bt, ct)
    assert y.dtype == jnp.bfloat16
    np.testing.assert_allclose(np.asarray(y, np.float32), np.asarray(y_ref),
                               rtol=2e-2, atol=2e-2)


def _mha_config(flash):
    from apertis_llm_tpu.config import ApertisConfig

    return ApertisConfig(vocab_size=64, hidden_size=64, num_hidden_layers=2,
                         num_attention_heads=4, intermediate_size=128,
                         use_flash_attention=flash, hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0)


@pytest.mark.parametrize("l", [8, 33])
def test_fused_attention_forward_matches_plain(l):
    """use_flash_attention routes unmasked full-sequence attention through
    jax.nn.dot_product_attention; logits equal the plain path's."""
    from apertis_llm_tpu.models import apertis as model_lib
    from apertis_llm_tpu.models.params import init_params

    params = init_params(jax.random.PRNGKey(0), _mha_config(False))
    ids = jnp.asarray(np.random.default_rng(l).integers(1, 64, (2, l)))
    plain = model_lib.forward(params, _mha_config(False), ids).logits
    fused = model_lib.forward(params, _mha_config(True), ids).logits
    np.testing.assert_allclose(np.asarray(fused), np.asarray(plain),
                               rtol=1e-5, atol=1e-5)


def test_fused_attention_gradients_match_plain():
    from apertis_llm_tpu.models import apertis as model_lib
    from apertis_llm_tpu.models.params import init_params

    params = init_params(jax.random.PRNGKey(1), _mha_config(False))
    ids = jnp.asarray(np.random.default_rng(0).integers(1, 64, (2, 12)))

    def loss(config):
        return lambda p: model_lib.forward(p, config, ids, labels=ids).loss

    g_plain = jax.grad(loss(_mha_config(False)))(params)
    g_fused = jax.grad(loss(_mha_config(True)))(params)
    for a, b in zip(jax.tree.leaves(g_fused), jax.tree.leaves(g_plain)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


def test_fused_attention_implementation_choice():
    """cuDNN only on the GPU and only for 16-bit inputs; the plain-XLA
    context turns every kernel off."""
    from apertis_llm_tpu import backend

    assert backend.fused_attention_implementation(jnp.bfloat16, 1024) is None
    assert backend.fused_attention_implementation(jnp.float32, 1024) is None
