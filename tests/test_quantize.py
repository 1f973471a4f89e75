"""Int8 weight-only quantization: reconstruction, decode quality, engine use."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from apertis_llm_tpu.config import ApertisConfig
from apertis_llm_tpu.models import apertis as model_lib
from apertis_llm_tpu.models.params import init_params
from apertis_llm_tpu.models.quantize import (
    quantization_error, quantize_params, quantize_weight)


def test_quantize_weight_roundtrip():
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.normal(size=(64, 128)), jnp.float32)
    q, s = quantize_weight(w)
    assert q.dtype == jnp.int8 and s.shape == (1, 128)
    recon = q.astype(jnp.float32) * s
    assert float(jnp.max(jnp.abs(recon - w))) < float(jnp.max(s))  # < 1 LSB

    w3 = jnp.asarray(rng.normal(size=(4, 64, 128)), jnp.float32)
    q3, s3 = quantize_weight(w3)
    assert s3.shape == (4, 1, 128)


def test_quantize_params_structure_and_error():
    config = ApertisConfig(vocab_size=128, hidden_size=128,
                           num_hidden_layers=2, num_attention_heads=4,
                           intermediate_size=256,
                           attention_type="selective_ssm", ssm_d_state=8,
                           hidden_dropout_prob=0.0,
                           attention_probs_dropout_prob=0.0)
    params = init_params(jax.random.PRNGKey(0), config)
    qparams = quantize_params(params, min_size=1024)

    # Projections quantized, embeddings/norms untouched.
    assert "w_q" in qparams["layers"]["attn"]["in_proj_x"]
    assert qparams["layers"]["attn"]["in_proj_x"]["w_q"].dtype == jnp.int8
    assert "w" in qparams["embed"].get("tok", {"w": None}) or \
        qparams["embed"]["tok"].dtype != jnp.int8
    assert "scale" in qparams["layers"]["attn"]["pre_norm"] or \
        "w" in qparams["layers"]["attn"]["pre_norm"]
    assert quantization_error(params, qparams) < 0.01


def test_quantized_decode_close_to_fp32():
    config = ApertisConfig(vocab_size=128, hidden_size=128,
                           num_hidden_layers=2, num_attention_heads=4,
                           intermediate_size=256,
                           attention_type="selective_ssm", ssm_d_state=8,
                           hidden_dropout_prob=0.0,
                           attention_probs_dropout_prob=0.0)
    params = init_params(jax.random.PRNGKey(0), config)
    qparams = quantize_params(params, min_size=1024)

    ids = jnp.asarray(np.random.default_rng(0).integers(4, 128, (2, 12)))
    full = model_lib.forward(params, config, ids).logits
    quant = model_lib.forward(qparams, config, ids).logits
    # int8 weight error stays small relative to the logit scale.
    denom = float(jnp.std(full))
    err = float(jnp.max(jnp.abs(full - quant))) / denom
    assert err < 0.35

    # Greedy argmax agrees on the vast majority of positions.
    agree = float(jnp.mean(
        (jnp.argmax(full, -1) == jnp.argmax(quant, -1)).astype(jnp.float32)))
    assert agree > 0.85


def test_quantized_multimodal_forward():
    """Vision subtree must stay untouched (its weights are read directly)."""
    config = ApertisConfig(vocab_size=128, hidden_size=128,
                           num_hidden_layers=1, num_attention_heads=4,
                           intermediate_size=256, multimodal=True,
                           image_size=32, vision_patch_size=8,
                           vision_embed_dim=64, vision_layers=1,
                           vision_heads=4,
                           hidden_dropout_prob=0.0,
                           attention_probs_dropout_prob=0.0)
    params = init_params(jax.random.PRNGKey(0), config)
    qparams = quantize_params(params, min_size=1024)
    assert "w" in qparams["vision"]["patch_embed"]  # not quantized
    ids = jnp.asarray([[1, 5, 9]])
    pixels = jnp.zeros((1, 3, 32, 32), jnp.float32)
    out = model_lib.forward(qparams, config, ids, pixel_values=pixels)
    assert np.isfinite(np.asarray(out.logits)).all()


def test_engine_runs_with_quantized_params():
    from apertis_llm_tpu.inference.engine import InferenceEngine

    config = ApertisConfig(vocab_size=128, hidden_size=128,
                           num_hidden_layers=1, num_attention_heads=4,
                           intermediate_size=256,
                           attention_type="selective_ssm", ssm_d_state=8,
                           hidden_dropout_prob=0.0,
                           attention_probs_dropout_prob=0.0)
    params = quantize_params(init_params(jax.random.PRNGKey(0), config),
                             min_size=1024)
    engine = InferenceEngine(config, params)
    out = engine.generate(np.asarray([[1, 5, 9]], np.int32),
                          max_new_tokens=4, eos_token_id=())
    assert out.shape == (1, 7)


def test_dyn_mode_decode_close_to_weightonly(monkeypatch):
    """APERTIS_QUANT_MATMUL=dyn routes through the int8-dot path end to end;
    greedy logits stay close to the weight-only dequant path."""
    monkeypatch.setenv("APERTIS_QUANT_MATMUL", "dyn")
    config = ApertisConfig(vocab_size=128, hidden_size=128,
                           num_hidden_layers=2, num_attention_heads=4,
                           intermediate_size=256,
                           attention_type="selective_ssm", ssm_d_state=8,
                           hidden_dropout_prob=0.0,
                           attention_probs_dropout_prob=0.0)
    params = init_params(jax.random.PRNGKey(0), config)
    qparams = quantize_params(params, min_size=1024)
    ids = jnp.asarray(np.random.default_rng(1).integers(4, 128, (2, 12)))

    dyn = model_lib.forward(qparams, config, ids).logits
    monkeypatch.setenv("APERTIS_QUANT_MATMUL", "weightonly")
    wo = model_lib.forward(qparams, config, ids).logits
    # Per-row int8 activation rounding: close but not identical.
    scale = float(jnp.max(jnp.abs(wo)))
    assert float(jnp.max(jnp.abs(dyn - wo))) < 0.05 * max(scale, 1.0)
    assert (jnp.argmax(dyn[:, -1], -1) == jnp.argmax(wo[:, -1], -1)).all()


def test_quantize_moe_expert_stacks():
    """Expert stacks (w1/w2, 4-D with the layer axis) quantize to int8 with
    per-output-channel scales; forward stays close to bf16 and the router
    stays full precision."""
    config = ApertisConfig(vocab_size=128, hidden_size=128,
                           num_hidden_layers=2, num_attention_heads=4,
                           intermediate_size=256, use_expert_system=True,
                           num_experts=4, experts_per_token=2,
                           hidden_dropout_prob=0.0,
                           attention_probs_dropout_prob=0.0)
    params = init_params(jax.random.PRNGKey(0), config)
    qparams = quantize_params(params, min_size=1024)

    experts = qparams["layers"]["ffn"]["experts"]
    assert experts["w1_q"].dtype == jnp.int8
    assert experts["w2_q"].dtype == jnp.int8
    assert experts["w1_q"].shape == params["layers"]["ffn"]["experts"]["w1"].shape
    # scales reduce the contraction axis (-2)
    assert experts["w1_s"].shape[-2] == 1
    assert "w" in qparams["layers"]["ffn"]["router"], "router must stay fp"
    assert quantization_error(params, qparams) < 0.01

    ids = jnp.asarray(np.random.default_rng(2).integers(4, 128, (2, 16)))
    full = model_lib.forward(params, config, ids).logits
    quant = model_lib.forward(qparams, config, ids).logits
    scale = float(jnp.max(jnp.abs(full)))
    assert float(jnp.max(jnp.abs(full - quant))) < 0.05 * max(scale, 1.0)


def test_quantized_tree_shards_under_tp_ep():
    """Quantized leaves inherit the base weight's sharding (scales keep the
    output-channel axis but replicate their size-1 contraction axis), so
    int8 serving composes with tensor/expert parallelism."""
    from apertis_llm_tpu.parallel.mesh import create_mesh
    from apertis_llm_tpu.parallel.sharding import param_specs, shard_params

    config = ApertisConfig(vocab_size=128, hidden_size=128,
                           num_hidden_layers=2, num_attention_heads=4,
                           intermediate_size=256, use_expert_system=True,
                           num_experts=4, experts_per_token=2,
                           attention_type="selective_ssm", ssm_d_state=8,
                           hidden_dropout_prob=0.0,
                           attention_probs_dropout_prob=0.0)
    params = init_params(jax.random.PRNGKey(0), config)
    qparams = quantize_params(params, min_size=1024)
    specs = param_specs(qparams)

    ssm = specs["layers"]["attn"]
    assert tuple(ssm["in_proj_x"]["w_q"]) == (None, None, "model")
    assert tuple(ssm["in_proj_x"]["w_s"]) == (None, None, "model")
    assert tuple(ssm["out_proj"]["w_q"]) == (None, "model", None)
    # row-parallel scale: contraction axis is size 1 -> replicated
    assert tuple(ssm["out_proj"]["w_s"]) == (None, None, None)
    experts = specs["layers"]["ffn"]["experts"]
    assert tuple(experts["w1_q"]) == (None, "expert", None, "model")
    assert tuple(experts["w2_s"]) == (None, "expert", None, None)

    mesh = create_mesh(jax.devices()[:8], (2, 2, 2))
    sharded = shard_params(qparams, mesh)
    ids = jnp.asarray(np.random.default_rng(3).integers(4, 128, (2, 12)))
    ref = model_lib.forward(qparams, config, ids).logits
    got = model_lib.forward(sharded, config, ids).logits
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), atol=2e-2)


def test_int8_greedy_token_parity_moe_vision():
    """Done criterion of int8 serving: greedy decode under int8 serving
    matches bf16 token-for-token on a MoE + vision model (short horizon).
    Weight-only int8 perturbs logits by <1% of their scale, which must not
    flip the argmax at any step of a 16-token greedy rollout."""
    from apertis_llm_tpu.inference.engine import InferenceEngine

    config = ApertisConfig(vocab_size=128, hidden_size=128,
                           num_hidden_layers=2, num_attention_heads=4,
                           intermediate_size=256,
                           attention_type="selective_ssm", ssm_d_state=8,
                           multimodal=True, image_size=32,
                           vision_patch_size=8, vision_embed_dim=64,
                           vision_layers=1, vision_heads=4,
                           use_expert_system=True, num_experts=4,
                           experts_per_token=2,
                           hidden_dropout_prob=0.0,
                           attention_probs_dropout_prob=0.0)
    params = init_params(jax.random.PRNGKey(0), config)
    qparams = quantize_params(params, min_size=1024)

    rng = np.random.default_rng(7)
    prompt = rng.integers(4, 128, (2, 12)).astype(np.int32)
    pixels = rng.integers(0, 255, (2, 32, 32, 3)).astype(np.uint8)

    out_bf16 = InferenceEngine(config, params).generate(
        prompt, pixel_values=pixels, max_new_tokens=16, eos_token_id=(),
        do_sample=False)
    out_int8 = InferenceEngine(config, qparams).generate(
        prompt, pixel_values=pixels, max_new_tokens=16, eos_token_id=(),
        do_sample=False)
    np.testing.assert_array_equal(np.asarray(out_bf16), np.asarray(out_int8))


@pytest.mark.parametrize("mode", ["dyn", "weightonly"])
def test_int8_linear_matches_dequant_reference(mode, monkeypatch):
    """Both int8 matmul paths of _linear stay within dynamic int8 rounding
    of the exact dequantised matmul, at odd row/K/N sizes."""
    from apertis_llm_tpu.models.apertis import _linear

    monkeypatch.setenv("APERTIS_QUANT_MATMUL", mode)
    rng = np.random.default_rng(0)
    for (m, k, n) in [(64, 256, 128), (37, 600, 300), (513, 2432, 1024)]:
        x = jnp.asarray(rng.normal(size=(m, k)), jnp.bfloat16)
        w_q = jnp.asarray(rng.integers(-127, 128, size=(k, n)), jnp.int8)
        w_s = jnp.asarray(np.abs(rng.normal(size=(1, n))) * 0.01, jnp.float32)
        got = _linear({"w_q": w_q, "w_s": w_s}, x).astype(jnp.float32)
        ref = x.astype(jnp.float32) @ (w_q.astype(jnp.float32) * w_s)
        denom = float(jnp.max(jnp.abs(ref))) + 1e-9
        rel = float(jnp.max(jnp.abs(got - ref))) / denom
        assert rel < 0.03, (m, k, n, rel)


def test_quantize_vision_opt_in():
    """quantize_vision=True int8-quantizes the ViT (patch embed, fused QKV,
    attn out, FFN) and the vision projection; encoded features stay within
    per-channel-int8 error of the bf16 ViT and the multimodal forward runs.
    Default (flag off) keeps the vision subtree untouched
    (test_quantized_multimodal_forward)."""
    from apertis_llm_tpu.models.vit import vit_encode

    config = ApertisConfig(vocab_size=128, hidden_size=128,
                           num_hidden_layers=1, num_attention_heads=4,
                           intermediate_size=256, multimodal=True,
                           image_size=32, vision_patch_size=8,
                           vision_embed_dim=64, vision_layers=2,
                           vision_heads=4,
                           hidden_dropout_prob=0.0,
                           attention_probs_dropout_prob=0.0)
    params = init_params(jax.random.PRNGKey(0), config)
    qparams = quantize_params(params, min_size=1024, quantize_vision=True)

    vtree = qparams["vision"]
    assert "w_q" in vtree["patch_embed"] and "w" not in vtree["patch_embed"]
    assert "in_proj_w_q" in vtree["layers"] and "in_proj_w" not in vtree["layers"]
    for lin in ("attn_out", "linear1", "linear2"):
        assert "w_q" in vtree["layers"][lin], lin
    if "vision_proj" in qparams:
        assert "w_q" in qparams["vision_proj"]

    pixels = jnp.asarray(
        np.random.default_rng(0).normal(size=(2, 3, 32, 32)), jnp.float32)
    ref = np.asarray(vit_encode(params["vision"], config, pixels),
                     np.float32)
    got = np.asarray(vit_encode(vtree, config, pixels), np.float32)
    rel = np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-9)
    assert rel < 0.05, rel

    ids = jnp.asarray([[1, 5, 9], [2, 6, 10]])
    out = model_lib.forward(qparams, config, ids, pixel_values=pixels)
    assert np.isfinite(np.asarray(out.logits)).all()


@pytest.mark.parametrize("swiglu", [False, True])
def test_int8_forward_dyn_matches_weightonly(swiglu, monkeypatch):
    """The int8 forward through dynamic int8 dots stays within activation
    rounding of the weight-only (exact dequant) forward on the same tree;
    greedy tokens agree."""
    config = ApertisConfig(vocab_size=128, hidden_size=128,
                           num_hidden_layers=2, num_attention_heads=4,
                           intermediate_size=256, use_swiglu=swiglu,
                           attention_type="selective_ssm", ssm_d_state=8,
                           hidden_dropout_prob=0.0,
                           attention_probs_dropout_prob=0.0)
    params = init_params(jax.random.PRNGKey(0), config)
    qparams = quantize_params(params, min_size=1024)
    ids = jnp.asarray(np.random.default_rng(1).integers(4, 128, (2, 12)))

    monkeypatch.setenv("APERTIS_QUANT_MATMUL", "weightonly")
    base = model_lib.forward(qparams, config, ids).logits
    monkeypatch.setenv("APERTIS_QUANT_MATMUL", "dyn")
    dyn = model_lib.forward(qparams, config, ids).logits
    np.testing.assert_allclose(np.asarray(dyn, np.float32),
                               np.asarray(base, np.float32),
                               rtol=0, atol=0.05)
    agree = float(jnp.mean(
        (jnp.argmax(base, -1) == jnp.argmax(dyn, -1)).astype(jnp.float32)))
    assert agree == 1.0


def test_int8_vit_dyn_matches_weightonly(monkeypatch):
    """The int8 ViT (APERTIS_QUANT_VIT) through dynamic int8 dots matches
    its weight-only encode within activation rounding."""
    from apertis_llm_tpu.models.vit import vit_encode

    config = ApertisConfig(vocab_size=128, hidden_size=128,
                           num_hidden_layers=1, num_attention_heads=4,
                           intermediate_size=256, multimodal=True,
                           image_size=32, vision_patch_size=8,
                           vision_embed_dim=64, vision_layers=2,
                           vision_heads=4,
                           attention_type="selective_ssm", ssm_d_state=8,
                           hidden_dropout_prob=0.0,
                           attention_probs_dropout_prob=0.0)
    params = init_params(jax.random.PRNGKey(0), config)
    qparams = quantize_params(params, min_size=1024, quantize_vision=True)
    pixels = jnp.asarray(
        np.random.default_rng(0).normal(size=(2, 3, 32, 32)), jnp.float32)

    monkeypatch.setenv("APERTIS_QUANT_MATMUL", "weightonly")
    base = np.asarray(vit_encode(qparams["vision"], config, pixels),
                      np.float32)
    monkeypatch.setenv("APERTIS_QUANT_MATMUL", "dyn")
    dyn = np.asarray(vit_encode(qparams["vision"], config, pixels),
                     np.float32)
    rel = np.max(np.abs(dyn - base)) / (np.max(np.abs(base)) + 1e-9)
    assert rel < 0.05, rel


def test_quantized_tied_head_attaches_and_matches(monkeypatch):
    """The engine attaches a serving int8 copy of the tied LM head for
    quantized trees (APERTIS_QUANT_HEAD, default on): greedy decode must
    match the bf16-head engine token-for-token on the test model, under
    BOTH quant dispatch modes (weight-only = the small-row path; dyn = the
    large-row path with activation rounding)."""
    from apertis_llm_tpu.inference.engine import InferenceEngine
    from apertis_llm_tpu.models.quantize import (
        quantize_tied_head, tree_is_quantized)

    config = ApertisConfig(vocab_size=128, hidden_size=128,
                           num_hidden_layers=2, num_attention_heads=4,
                           intermediate_size=256,
                           attention_type="selective_ssm", ssm_d_state=8,
                           hidden_dropout_prob=0.0,
                           attention_probs_dropout_prob=0.0)
    params = init_params(jax.random.PRNGKey(0), config)
    qparams = quantize_params(params, min_size=1024)
    assert tree_is_quantized(qparams) and not tree_is_quantized(params)

    prompt = np.random.default_rng(11).integers(4, 128, (2, 12)).astype(np.int32)
    for mode in ("weightonly", "dyn"):
        monkeypatch.setenv("APERTIS_QUANT_MATMUL", mode)
        engine = InferenceEngine(config, qparams)
        assert "lm_head" in engine.params
        assert engine.params["lm_head"]["w_q"].dtype == jnp.int8
        assert engine.params["lm_head"]["w_q"].shape == (128, 128)
        out_q = engine.generate(prompt, max_new_tokens=12, eos_token_id=(),
                                do_sample=False)
        monkeypatch.setenv("APERTIS_QUANT_HEAD", "0")
        plain = InferenceEngine(config, qparams)
        assert "lm_head" not in plain.params
        out_ref = plain.generate(prompt, max_new_tokens=12, eos_token_id=(),
                                 do_sample=False)
        monkeypatch.delenv("APERTIS_QUANT_HEAD")
        np.testing.assert_array_equal(np.asarray(out_q), np.asarray(out_ref))

    # bf16 trees never get a quantized head attached.
    bf16_engine = InferenceEngine(config, params)
    assert "lm_head" not in bf16_engine.params
