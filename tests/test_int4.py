"""int4-packed linears (``w_q4``/``w_s``/``w_sh``).

Covers the packing scheme (models/quantize.quantize_weight_int4 — group-128
interleaved nibble pairs) and its consumer, the in-graph unpack of
models/apertis._linear, at decode and prefill row counts. Reference
counterpart: none — the reference serves fp16/bf16
(src/inference/interface.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from apertis_llm_tpu.ops import quant as quant_ops
from apertis_llm_tpu.models.quantize import (
    dequantize_int4, quantize_weight_int4, unpack_int4)


def test_pack_unpack_bijection():
    r = np.random.default_rng(0)
    for shape in [(256, 384), (3, 384, 256), (2, 4, 128, 256)]:
        w = jnp.asarray(r.standard_normal(shape), jnp.float32)
        p, s, sh = quantize_weight_int4(w)
        assert p.shape == shape[:-2] + (shape[-2] // 2, shape[-1])
        assert p.dtype == jnp.int8
        assert sh.shape == shape[:-2] + (shape[-2] // 128, shape[-1])
        assert bool(jnp.all(jnp.isin(sh, jnp.asarray([1, 2, 4, 8],
                                                     jnp.int8))))
        # Direct re-derivation of the group-wise grid: each group's values
        # quantize on scale*shift and unpack returns them PRE-multiplied
        # by the shift (int8 in [-56, 56]).
        grid = s[..., None, :, :] * sh.astype(jnp.float32)[..., :, None, :]
        wg = w.reshape(shape[:-2] + (shape[-2] // 128, 128, shape[-1]))
        q_direct = (jnp.clip(jnp.round(wg / grid), -7, 7)
                    * sh.astype(jnp.float32)[..., :, None, :]
                    ).astype(jnp.int8).reshape(shape)
        assert bool(jnp.all(unpack_int4(p, sh) == q_direct))
        # Per-element error is bounded by HALF each group's own grid —
        # at least as tight as the round-4 per-channel bound everywhere.
        err = jnp.abs(dequantize_int4(p, s, sh) - w)
        bound = jnp.broadcast_to(grid / 2 + 1e-6, wg.shape).reshape(shape)
        assert bool(jnp.all(err <= bound))


def test_groupwise_beats_per_channel_on_varied_groups():
    """Channels whose 128-row groups have very different magnitudes get up
    to 3 extra bits: construct one and check reconstruction error shrinks
    vs the per-channel-scale grid."""
    r = np.random.default_rng(11)
    w = np.asarray(r.standard_normal((512, 64)), np.float32) * 0.01
    w[:128] *= 100.0       # one loud group per channel dominates absmax
    w = jnp.asarray(w)
    p, s, sh = quantize_weight_int4(w)
    err_grouped = float(jnp.max(jnp.abs(dequantize_int4(p, s, sh) - w)[128:]))
    per_chan_grid = float(jnp.max(jnp.abs(w)) / 7.0)
    # Quiet groups' error must be far below the per-channel grid step.
    assert err_grouped < per_chan_grid / 4


def test_pack_rejects_misaligned_contraction():
    with pytest.raises(ValueError):
        quantize_weight_int4(jnp.zeros((130, 8)))


def test_group_local_tiles_unpack_independently():
    """Any 128-aligned contraction slice of the packed tensor must unpack to
    the same rows as slicing the unpacked tensor — the property the fused
    kernels' GEMM2 tiling relies on."""
    r = np.random.default_rng(1)
    w = jnp.asarray(r.standard_normal((512, 256)), jnp.float32)
    p, s, sh = quantize_weight_int4(w)
    full = unpack_int4(p, sh)
    for start in (0, 128, 256):
        tile = unpack_int4(p[start // 2:(start + 256) // 2, :],
                           sh[start // 128:(start + 256) // 128, :])
        assert bool(jnp.all(tile == full[start:start + 256, :]))


def test_linear_int4_fallback_matches_dequant():
    from apertis_llm_tpu.models.apertis import _linear

    r = np.random.default_rng(2)
    w = jnp.asarray(r.standard_normal((256, 192)) * 0.05, jnp.float32)
    b = jnp.asarray(r.standard_normal((192,)) * 0.01, jnp.float32)
    x = jnp.asarray(r.standard_normal((5, 256)), jnp.float32)
    p, s, sh = quantize_weight_int4(w)
    got = _linear({"w_q4": p, "w_s": s, "w_sh": sh, "b": b}, x)
    ref = x @ dequantize_int4(p, s, sh) + b
    assert float(jnp.max(jnp.abs(got - ref))) < 1e-4


@pytest.mark.parametrize("rows", [4, quant_ops.DYN_MIN_ROWS])
def test_linear_int4_both_dispatch_paths_match_dequant(rows):
    """Below DYN_MIN_ROWS the unpacked weights take the weight-only dequant;
    from it up, the dynamic int8 dot (activation rounding only)."""
    from apertis_llm_tpu.models.apertis import _linear

    r = np.random.default_rng(3)
    w = jnp.asarray(r.standard_normal((256, 128)) * 0.05, jnp.float32)
    x = jnp.asarray(r.standard_normal((rows, 256)), jnp.float32)
    p, s, sh = quantize_weight_int4(w)
    got = _linear({"w_q4": p, "w_s": s, "w_sh": sh}, x)
    ref = x @ dequantize_int4(p, s, sh)
    rel = float(jnp.max(jnp.abs(got - ref)) / jnp.max(jnp.abs(ref)))
    assert rel < 0.02, rel


def _int4_ffn_tree(config, seed=0):
    """Params whose dense-FFN weights are int4-packed, and the same tree
    with those weights dequantized to float32."""
    from apertis_llm_tpu.models.params import init_params

    params = init_params(jax.random.PRNGKey(seed), config)
    packed = jax.tree.map(lambda x: x, params)
    ref = jax.tree.map(lambda x: x, params)
    for name in ("w1", "w2"):
        w = params["layers"]["ffn"][name]["w"]
        q4, sc, sh = quantize_weight_int4(w)
        packed["layers"]["ffn"][name] = {
            "w_q4": q4, "w_s": sc, "w_sh": sh,
            "b": params["layers"]["ffn"][name]["b"]}
        ref["layers"]["ffn"][name] = {
            "w": dequantize_int4(q4, sc, sh),
            "b": params["layers"]["ffn"][name]["b"]}
    return packed, ref


def test_decode_step_int4_tree_matches_dequant():
    """A decode step on an int4-packed FFN tree equals the step on the
    dequantized float tree up to the weight-only path's rounding."""
    from apertis_llm_tpu.config import ApertisConfig
    from apertis_llm_tpu.models import apertis as model_lib

    config = ApertisConfig(
        vocab_size=128, hidden_size=128, num_hidden_layers=2,
        num_attention_heads=8, intermediate_size=256,
        attention_type="selective_ssm", ssm_d_state=16,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        max_position_embeddings=64)
    packed, ref = _int4_ffn_tree(config)
    cache = model_lib.init_cache(config, 4, max_length=16)
    toks = jnp.asarray([3, 5, 7, 9], jnp.int32)
    t = jnp.asarray(0, jnp.int32)
    got, _ = model_lib.decode_step(packed, config, cache, toks, t)
    want, _ = model_lib.decode_step(ref, config, cache, toks, t)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_forward_int4_tree_matches_dequant_at_prefill_rows():
    """Full-sequence forward (>= DYN_MIN_ROWS rows: dynamic int8 dot on the
    unpacked weights) stays within activation rounding of the float tree;
    greedy tokens agree."""
    from apertis_llm_tpu.config import ApertisConfig
    from apertis_llm_tpu.models import apertis as model_lib

    config = ApertisConfig(
        vocab_size=128, hidden_size=128, num_hidden_layers=2,
        num_attention_heads=8, intermediate_size=256,
        attention_type="selective_ssm", ssm_d_state=16,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        max_position_embeddings=256)
    packed, ref = _int4_ffn_tree(config, seed=1)
    ids = jnp.asarray(np.random.default_rng(4).integers(
        4, 128, (quant_ops.DYN_MIN_ROWS // 128, 128)))
    got = model_lib.forward(packed, config, ids).logits
    want = model_lib.forward(ref, config, ids).logits
    scale = float(jnp.max(jnp.abs(want)))
    assert float(jnp.max(jnp.abs(got - want))) / scale < 0.03
    agree = float(jnp.mean(jnp.argmax(got, -1) == jnp.argmax(want, -1)))
    assert agree > 0.95, agree
