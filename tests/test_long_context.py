"""Long-context serving: prompts past the static bucket table.

The reference advertises 32K context on the SSM path (its O(1) recurrent
state is the whole point, reference: src/model/core.py:337-353,
docs/README.md:589). These tests pin that the compiled engine is
token-exact for prompts longer than the largest static bucket (2048) and
that SSM decode memory is flat in prompt length.

The oracle is our own uncompiled full forward, which is itself
logit-parity-pinned against the PyTorch reference in tests/test_parity.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from apertis_llm_tpu.config import ApertisConfig
from apertis_llm_tpu.inference.engine import InferenceEngine, _round_up_bucket
from apertis_llm_tpu.models import apertis as model_lib
from apertis_llm_tpu.models.params import init_params

BASE = dict(
    vocab_size=131,
    hidden_size=64,
    num_hidden_layers=2,
    num_attention_heads=4,
    intermediate_size=128,
    max_position_embeddings=128,
    hidden_dropout_prob=0.0,
    attention_probs_dropout_prob=0.0,
    attention_type="selective_ssm",
    ssm_d_state=8,
)


def _ssm_engine(**overrides):
    kwargs = dict(BASE)
    kwargs.update(overrides)
    config = ApertisConfig.from_dict(kwargs)
    params = init_params(jax.random.PRNGKey(0), config)
    return config, params, InferenceEngine(config, params)


def _greedy_oracle(params, config, prompt: np.ndarray, n: int):
    """Uncompiled full-forward greedy loop (no cache, no bucketing)."""
    ids = prompt.copy()
    out = []
    for _ in range(n):
        logits = model_lib.forward(params, config, jnp.asarray(ids)).logits
        nxt = int(jnp.argmax(logits[0, -1]))
        out.append(nxt)
        ids = np.concatenate([ids, [[nxt]]], axis=1)
    return out


def test_bucket_rounding_never_truncates():
    buckets = InferenceEngine.PROMPT_BUCKETS
    for n in (1, 32, 33, 2048, 2049, 2100, 8192, 32000, 32768):
        assert _round_up_bucket(n, buckets) >= n


@pytest.mark.parametrize("plen", [2100, 8192])
def test_long_prompt_generate_token_exact(plen):
    """Prompts past the 2048 bucket decode token-exact."""
    config, params, engine = _ssm_engine()
    rng = np.random.default_rng(plen)
    prompt = rng.integers(1, config.vocab_size, size=(1, plen)).astype(np.int32)

    want = _greedy_oracle(params, config, prompt, 5)
    out = engine.generate(prompt, max_new_tokens=5, eos_token_id=())
    assert out.shape == (1, plen + 5)
    assert out[0, :plen].tolist() == prompt[0].tolist()
    assert out[0, plen:].tolist() == want


def test_long_prompt_stream_matches_generate():
    config, params, engine = _ssm_engine()
    rng = np.random.default_rng(7)
    prompt = rng.integers(1, config.vocab_size, size=(1, 2100)).astype(np.int32)
    batch = engine.generate(prompt, max_new_tokens=4, eos_token_id=())
    streamed = list(engine.stream(prompt, max_new_tokens=4, eos_token_id=None))
    assert streamed == batch[0, -4:].tolist()


def test_32k_prompt_decodes_with_flat_state():
    """32K-token prompt prefills and decodes; the SSM decode state is O(1)
    in prompt length (conv window + recurrence carry only)."""
    config, params, engine = _ssm_engine()
    rng = np.random.default_rng(3)
    plen = 32_000
    prompt = rng.integers(1, config.vocab_size, size=(1, plen)).astype(np.int32)

    out = engine.generate(prompt, max_new_tokens=3, eos_token_id=())
    assert out.shape == (1, plen + 3)

    # First generated token matches the uncompiled forward's argmax.
    logits = model_lib.forward(params, config, jnp.asarray(prompt)).logits
    assert int(out[0, plen]) == int(jnp.argmax(logits[0, -1]))

    # Flat memory: the decode cache doesn't grow with prompt length.
    small = model_lib.init_cache(config, 1, max_length=64)
    large = model_lib.init_cache(config, 1, max_length=plen + 3)
    small_bytes = sum(x.nbytes for x in jax.tree.leaves(small))
    large_bytes = sum(x.nbytes for x in jax.tree.leaves(large))
    assert small_bytes == large_bytes


def test_mha_past_position_table_raises():
    """MHA-rotary models have a hard positional limit (the reference crashes
    there; we raise a clear error instead of silently clamping)."""
    kwargs = dict(BASE)
    kwargs.pop("attention_type")
    kwargs.pop("ssm_d_state")
    config = ApertisConfig.from_dict(kwargs)   # max_position_embeddings=128
    params = init_params(jax.random.PRNGKey(0), config)
    engine = InferenceEngine(config, params)
    prompt = np.ones((1, 200), np.int32)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        engine.generate(prompt, max_new_tokens=4, eos_token_id=())
    with pytest.raises(ValueError, match="max_position_embeddings"):
        list(engine.stream(prompt, max_new_tokens=4, eos_token_id=None))
