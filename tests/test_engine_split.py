"""Split-program generation (prefill+first-token / dynamic-length decode
loop) must be token-exact with the monolithic whole-generation program.

The split path is the serving bring-up fix: the prefill
graph compiles once per (bucket, batch, sampling mode) and ONE decode-loop
program — generation length a dynamic scalar — serves every
``max_new_tokens`` up to ``config.decode_max_length``.
"""

import os

import numpy as np
import pytest

import jax

from apertis_llm_tpu.config import ApertisConfig
from apertis_llm_tpu.inference.engine import InferenceEngine
from apertis_llm_tpu.models.params import init_params

BASE = dict(
    vocab_size=131,
    hidden_size=64,
    num_hidden_layers=2,
    num_attention_heads=4,
    intermediate_size=128,
    max_position_embeddings=128,
    attention_type="selective_ssm",
    ssm_d_state=8,
    decode_max_length=64,
    hidden_dropout_prob=0.0,
    attention_probs_dropout_prob=0.0,
)


def _engine(**overrides):
    kwargs = dict(BASE)
    kwargs.update(overrides)
    config = ApertisConfig.from_dict(kwargs)
    params = init_params(jax.random.PRNGKey(0), config)
    return config, InferenceEngine(config, params)


def _gen(engine, split: bool, prompt, **kw):
    os.environ["APERTIS_ENGINE_SPLIT"] = "1" if split else "0"
    try:
        return engine.generate(prompt, rng=jax.random.PRNGKey(7), **kw)
    finally:
        os.environ.pop("APERTIS_ENGINE_SPLIT", None)


@pytest.mark.parametrize("sampling", ["greedy", "penalty", "sampled"])
def test_split_matches_monolith(sampling):
    _, engine = _engine()
    prompt = np.array([[1, 5, 9, 33, 70, 4, 18],
                       [2, 8, 1, 1, 1, 1, 1]], dtype=np.int32)
    mask = np.array([[1] * 7, [1, 1, 1, 0, 0, 0, 0]], dtype=np.int32)
    kw = dict(attention_mask=mask, max_new_tokens=12, eos_token_id=(),
              do_sample=False)
    if sampling == "penalty":
        kw.update(repetition_penalty=1.3)
    elif sampling == "sampled":
        kw.update(do_sample=True, temperature=0.8, top_k=20, top_p=0.9)
    a = _gen(engine, False, prompt, **kw)
    b = _gen(engine, True, prompt, **kw)
    np.testing.assert_array_equal(a, b)


def test_split_matches_monolith_multimodal_and_eos():
    config, engine = _engine(multimodal=True, image_size=32,
                             vision_patch_size=16, vision_layers=1,
                             vision_heads=2, vision_embed_dim=32)
    prompt = np.array([[3, 4, 5, 6]], dtype=np.int32)
    pixels = np.random.default_rng(0).random(
        (1, 3, 32, 32), dtype=np.float32)
    kw = dict(pixel_values=pixels, max_new_tokens=10, eos_token_id=9,
              do_sample=False)
    a = _gen(engine, False, prompt, **kw)
    b = _gen(engine, True, prompt, **kw)
    np.testing.assert_array_equal(a, b)


def test_split_ttft_call_skips_decode_program_and_reuses_prefill():
    _, engine = _engine()
    prompt = np.array([[1, 5, 9]], dtype=np.int32)
    out = _gen(engine, True, prompt, max_new_tokens=1, eos_token_id=(),
               do_sample=False)
    assert out.shape == (1, 4)
    keys = list(engine._compiled)
    assert any(k[0] == "split_prefill" for k in keys)
    assert not any(k[0] == "split_decode" for k in keys)
    # Longer generations reuse the SAME two programs: the decode length is
    # a dynamic scalar, so max_new_tokens is not part of the cache key.
    _gen(engine, True, prompt, max_new_tokens=5, eos_token_id=(),
         do_sample=False)
    _gen(engine, True, prompt, max_new_tokens=30, eos_token_id=(),
         do_sample=False)
    keys = list(engine._compiled)
    assert sum(k[0] == "split_prefill" for k in keys) == 1
    assert sum(k[0] == "split_decode" for k in keys) == 1


def test_split_capacity_overflow_recompiles():
    _, engine = _engine()  # decode_max_length = 64
    prompt = np.array([[1, 5, 9]], dtype=np.int32)
    out = _gen(engine, True, prompt, max_new_tokens=80, eos_token_id=(),
               do_sample=False)
    assert out.shape == (1, 3 + 80)
    caps = {k[-1] for k in engine._compiled if k[0] == "split_decode"}
    assert caps == {1024}  # rounded up past decode_max_length
