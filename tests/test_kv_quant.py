"""int8 KV cache for MHA serving (APERTIS_QUANT_KV=1).

The MHA decode step's largest memory read is the whole KV cache;
per-slot int8 K/V halve it (and the cache footprint). Scales dequantize
exactly inside the score/context contractions
(ops/attention.decode_attention_selfterm), so the only numerics delta vs
the bf16 cache is the per-slot int8 rounding. Reference counterpart: none —
the reference's KV cache is fp16/fp32 (src/model/core.py:705-832); this is
a serving bandwidth/memory lever.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from apertis_llm_tpu.config import ApertisConfig
from apertis_llm_tpu.models import apertis as model_lib
from apertis_llm_tpu.models.params import init_params
from apertis_llm_tpu.ops.attention import (decode_attention,
                                           decode_attention_selfterm)


def _tiny_mha_config(**kw):
    return ApertisConfig(
        vocab_size=128, hidden_size=128, num_hidden_layers=3,
        num_attention_heads=4, intermediate_size=256,
        attention_type="standard_mha", multimodal=False,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        max_position_embeddings=64, **kw)


def test_cache_structure_and_footprint():
    config = _tiny_mha_config()
    os.environ["APERTIS_QUANT_KV"] = "1"
    try:
        cache = model_lib.init_cache(config, 2, max_length=16)
    finally:
        del os.environ["APERTIS_QUANT_KV"]
    assert set(cache) == {"k", "k_s", "v", "v_s"}
    assert cache["k"].dtype == jnp.int8
    assert cache["k_s"].shape == cache["k"].shape[:-1] + (1,)
    plain = model_lib.init_cache(config, 2, max_length=16)
    q_bytes = sum(t.size * t.dtype.itemsize for t in cache.values())
    p_bytes = sum(t.size * t.dtype.itemsize for t in plain.values())
    assert q_bytes < 0.6 * p_bytes  # ~0.53x: int8 payload + f32/Dh scales


def test_selfterm_quantized_matches_dequantized():
    r = np.random.default_rng(0)
    b, h, L, d = 2, 4, 16, 64
    q = jnp.asarray(r.standard_normal((b, h, 1, d)), jnp.bfloat16)
    k = jnp.asarray(r.standard_normal((b, h, L, d)), jnp.float32)
    v = jnp.asarray(r.standard_normal((b, h, L, d)), jnp.float32)
    k_new = jnp.asarray(r.standard_normal((b, h, 1, d)), jnp.bfloat16)
    v_new = jnp.asarray(r.standard_normal((b, h, 1, d)), jnp.bfloat16)
    valid = jnp.asarray(r.random((b, L)) > 0.3)

    kq, ks = model_lib._quantize_kv(k)
    vq, vs = model_lib._quantize_kv(v)
    got = decode_attention_selfterm(q, kq, vq, k_new, v_new, valid,
                                    k_scale=ks, v_scale=vs)
    ref = decode_attention_selfterm(
        q, (kq.astype(jnp.float32) * ks).astype(jnp.bfloat16),
        (vq.astype(jnp.float32) * vs).astype(jnp.bfloat16),
        k_new, v_new, valid)
    err = float(jnp.max(jnp.abs(got.astype(jnp.float32)
                                - ref.astype(jnp.float32))))
    assert err < 2e-2, err  # bf16 rounding band; same quantized payload


def test_selfterm_equals_full_cache_attention():
    """The self-term reorganisation (quantized or not) must equal writing
    the new slot into the cache and attending over everything."""
    r = np.random.default_rng(1)
    b, h, L, d = 2, 4, 12, 32
    t = 7
    q = jnp.asarray(r.standard_normal((b, h, 1, d)), jnp.float32)
    k = jnp.asarray(r.standard_normal((b, h, L, d)), jnp.float32)
    v = jnp.asarray(r.standard_normal((b, h, L, d)), jnp.float32)
    k_new = jnp.asarray(r.standard_normal((b, h, 1, d)), jnp.float32)
    v_new = jnp.asarray(r.standard_normal((b, h, 1, d)), jnp.float32)
    valid = jnp.asarray(np.arange(L)[None, :].repeat(b, 0) <= t)

    k_full = k.at[:, :, t:t + 1, :].set(k_new)
    v_full = v.at[:, :, t:t + 1, :].set(v_new)
    ref = decode_attention(q, k_full, v_full, valid)
    got = decode_attention_selfterm(
        q, k, v, k_new, v_new, valid & (jnp.arange(L)[None, :] != t))
    err = float(jnp.max(jnp.abs(got - ref)))
    assert err < 1e-5, err


def test_decode_step_quant_kv_close_to_bf16():
    config = _tiny_mha_config()
    params = init_params(jax.random.PRNGKey(0), config)
    toks = jnp.asarray([3, 5], jnp.int32)
    prompt = jnp.asarray([[1, 9, 17], [2, 11, 23]], jnp.int32)
    amask = jnp.ones_like(prompt)

    def run():
        cache = model_lib.init_cache(config, 2, max_length=16)
        pre = model_lib.prefill(params, config, cache, prompt,
                                attention_mask=amask)
        logits, _ = model_lib.decode_step(
            params, config, pre.cache, toks, jnp.asarray(3, jnp.int32))
        return pre.logits, logits

    pre_plain, dec_plain = run()
    os.environ["APERTIS_QUANT_KV"] = "1"
    try:
        pre_q, dec_q = run()
    finally:
        del os.environ["APERTIS_QUANT_KV"]
    # Prefill logits don't read the cache — identical; decode logits sit
    # within the per-slot int8 rounding band.
    assert float(jnp.max(jnp.abs(pre_q.astype(jnp.float32)
                                 - pre_plain.astype(jnp.float32)))) < 1e-6
    scale = float(jnp.max(jnp.abs(dec_plain))) + 1e-6
    err = float(jnp.max(jnp.abs(dec_q.astype(jnp.float32)
                                - dec_plain.astype(jnp.float32)))) / scale
    assert err < 2e-2, err
    assert jnp.array_equal(jnp.argmax(dec_plain, -1), jnp.argmax(dec_q, -1))


def test_engine_generate_quant_kv():
    from apertis_llm_tpu.inference.engine import InferenceEngine

    config = _tiny_mha_config()
    params = init_params(jax.random.PRNGKey(0), config)
    prompt = np.asarray([[1, 17, 93, 41]], np.int32)

    eng = InferenceEngine(config, params)
    out_plain = eng.generate(prompt, max_new_tokens=10, do_sample=False,
                             eos_token_id=(), rng=jax.random.PRNGKey(0))
    os.environ["APERTIS_QUANT_KV"] = "1"
    try:
        eng_q = InferenceEngine(config, params)
        out_q = eng_q.generate(prompt, max_new_tokens=10, do_sample=False,
                               eos_token_id=(), rng=jax.random.PRNGKey(0))
    finally:
        del os.environ["APERTIS_QUANT_KV"]
    a, b = np.asarray(out_plain[0]), np.asarray(out_q[0])
    n = min(len(a), len(b))
    assert (a[:n] == b[:n]).mean() >= 0.8  # int8-KV greedy tracks bf16
