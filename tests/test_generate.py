"""Compiled-generate parity vs the reference's sampling loop.

Greedy (and greedy + repetition penalty) are deterministic, so tokens must
match exactly even though prompts are bucketed/right-padded internally.
"""

import numpy as np
import pytest

from tests.reference_oracle import load_reference

core = load_reference()
requires_ref = pytest.mark.skipif(core is None, reason="reference oracle unavailable")

import jax
import jax.numpy as jnp

from apertis_llm_tpu.config import ApertisConfig
from apertis_llm_tpu.inference.engine import InferenceEngine
from apertis_llm_tpu.models.convert import from_torch_state_dict

BASE = dict(
    vocab_size=131,
    hidden_size=64,
    num_hidden_layers=2,
    num_attention_heads=4,
    intermediate_size=128,
    max_position_embeddings=128,
    hidden_dropout_prob=0.0,
    attention_probs_dropout_prob=0.0,
)


def _build(overrides):
    import torch

    kwargs = dict(BASE)
    kwargs.update(overrides)
    torch.manual_seed(1)
    ref_model = core.ApertisForCausalLM(core.ApertisConfig(**kwargs))
    ref_model.eval()
    sd = {k: v.detach().numpy() for k, v in ref_model.state_dict().items()}
    config = ApertisConfig.from_dict(kwargs)
    params = from_torch_state_dict(sd, config)
    return ref_model, InferenceEngine(config, params)


@requires_ref
@pytest.mark.parametrize("variant", ["mha", "ssm"])
def test_greedy_generate_matches_reference(variant):
    import torch

    over = {} if variant == "mha" else dict(attention_type="selective_ssm",
                                            ssm_d_state=8)
    ref_model, engine = _build(over)
    prompt = np.array([[1, 5, 9, 33, 70, 4, 18]], dtype=np.int64)

    with torch.no_grad():
        ref = ref_model.generate(
            input_ids=torch.from_numpy(prompt), max_new_tokens=12,
            do_sample=False, eos_token_id=[])
    ref_new = ref[0, prompt.shape[1]:].tolist()

    out = engine.generate(prompt.astype(np.int32), max_new_tokens=12,
                          eos_token_id=())
    ours_new = out[0, -12:].tolist()
    assert ours_new == ref_new, f"{variant}: {ours_new} != {ref_new}"


@requires_ref
def test_greedy_multimodal_generate_self_consistent():
    """Image-prefixed cached decode matches a full-forward greedy loop.

    Note: the REFERENCE's own multimodal generate crashes (its generate
    pre-offsets position_ids for the image prefix AND model.forward prefixes
    them again, producing mismatched RoPE shapes — core.py:1562-1571 vs
    1212-1221), so token-level parity is pinned against our full forward
    (which IS logit-parity-tested against the reference in
    test_parity.py::test_logit_parity_multimodal) instead of against the
    broken reference loop.
    """
    import jax.numpy as jnp

    from apertis_llm_tpu.models import apertis as model_lib

    _, engine = _build(dict(multimodal=True, image_size=32,
                            vision_patch_size=8, vision_embed_dim=48,
                            vision_layers=1, vision_heads=4))
    config, params = engine.config, engine.params
    rng = np.random.default_rng(5)
    prompt = np.array([[1, 5, 9, 33]], dtype=np.int32)
    pixels = rng.normal(size=(1, 3, 32, 32)).astype(np.float32)

    # Uncached greedy loop through the full forward.
    ids = prompt.copy()
    for _ in range(6):
        logits = model_lib.forward(params, config, jnp.asarray(ids),
                                   pixel_values=jnp.asarray(pixels)).logits
        nxt = int(jnp.argmax(logits[0, -1]))
        ids = np.concatenate([ids, [[nxt]]], axis=1)
    ref_new = ids[0, prompt.shape[1]:].tolist()

    out = engine.generate(prompt, pixel_values=pixels,
                          max_new_tokens=6, eos_token_id=())
    assert out[0, -6:].tolist() == ref_new


@requires_ref
def test_greedy_with_repetition_penalty_matches_reference():
    import torch

    ref_model, engine = _build({})
    prompt = np.array([[1, 5, 9, 33, 70]], dtype=np.int64)
    with torch.no_grad():
        ref = ref_model.generate(
            input_ids=torch.from_numpy(prompt), max_new_tokens=10,
            do_sample=False, repetition_penalty=1.7, eos_token_id=[])
    ref_new = ref[0, 5:].tolist()
    out = engine.generate(prompt.astype(np.int32), max_new_tokens=10,
                          repetition_penalty=1.7, eos_token_id=())
    assert out[0, -10:].tolist() == ref_new


@requires_ref
def test_batched_ragged_prompts_match_row_by_row():
    """Each row of a ragged batch must decode exactly as it would alone."""
    import torch

    ref_model, engine = _build({})
    p0 = np.array([[1, 5, 9, 33, 70, 4, 18]], dtype=np.int64)
    p1 = np.array([[2, 8]], dtype=np.int64)

    singles = []
    for p in (p0, p1):
        with torch.no_grad():
            r = ref_model.generate(input_ids=torch.from_numpy(p),
                                   max_new_tokens=8, do_sample=False,
                                   eos_token_id=[])
        singles.append(r[0, p.shape[1]:].tolist())

    batch = np.full((2, 7), 0, np.int32)
    batch[0, :7] = p0[0]
    batch[1, :2] = p1[0]
    mask = np.zeros((2, 7), np.int32)
    mask[0, :7] = 1
    mask[1, :2] = 1
    out = engine.generate(batch, attention_mask=mask, max_new_tokens=8,
                          eos_token_id=())
    assert out[0, -8:].tolist() == singles[0]
    assert out[1, -8:].tolist() == singles[1]


def test_eos_stops_generation():
    _, engine = _build({}) if core else (None, None)
    if engine is None:
        pytest.skip("reference oracle unavailable")
    prompt = np.array([[1, 5, 9]], dtype=np.int32)
    # Greedy decode; find what the model emits first, then use it as EOS.
    first = engine.generate(prompt, max_new_tokens=1, eos_token_id=())[0, -1]
    out = engine.generate(prompt, max_new_tokens=10, eos_token_id=(int(first),))
    new = out[0, 3:].tolist()
    assert new[0] == int(first)
    assert all(t == engine.config.pad_token_id for t in new[1:])


def test_min_new_tokens_overrides_early_eos():
    if core is None:
        pytest.skip("reference oracle unavailable")
    _, engine = _build({})
    prompt = np.array([[1, 5, 9]], dtype=np.int32)
    first = int(engine.generate(prompt, max_new_tokens=1, eos_token_id=())[0, -1])
    # EOS would fire immediately, but min_new_tokens keeps the loop running.
    out = engine.generate(prompt, max_new_tokens=6, min_new_tokens=4,
                          eos_token_id=(first,))
    assert out.shape[1] - 3 >= 4


def test_multiple_eos_ids():
    if core is None:
        pytest.skip("reference oracle unavailable")
    _, engine = _build({})
    prompt = np.array([[1, 5, 9]], dtype=np.int32)
    seq = engine.generate(prompt, max_new_tokens=6, eos_token_id=())[0, 3:]
    # Use the SECOND emitted token as one of several eos ids.
    second = int(seq[1])
    out = engine.generate(prompt, max_new_tokens=6,
                          eos_token_id=(99999 % engine.config.vocab_size, second))
    new = out[0, 3:].tolist()
    stop = new.index(second)
    assert all(t == engine.config.pad_token_id for t in new[stop + 1:])


def test_stream_matches_generate():
    if core is None:
        pytest.skip("reference oracle unavailable")
    _, engine = _build({})
    prompt = np.array([[1, 5, 9, 33]], dtype=np.int32)
    batch_out = engine.generate(prompt, max_new_tokens=6, eos_token_id=())
    streamed = list(engine.stream(prompt, max_new_tokens=6, eos_token_id=None))
    assert streamed == batch_out[0, -6:].tolist()


def test_sampled_generation_reproducible():
    if core is None:
        pytest.skip("reference oracle unavailable")
    _, engine = _build({})
    prompt = np.array([[1, 5, 9, 33]], dtype=np.int32)
    kw = dict(max_new_tokens=8, do_sample=True, temperature=0.9, top_k=20,
              top_p=0.95, eos_token_id=())
    a = engine.generate(prompt, rng=jax.random.PRNGKey(7), **kw)
    b = engine.generate(prompt, rng=jax.random.PRNGKey(7), **kw)
    c = engine.generate(prompt, rng=jax.random.PRNGKey(8), **kw)
    assert a.tolist() == b.tolist()
    assert a.shape == c.shape


def test_decode_unroll_parity(monkeypatch):
    """The decode-step layer-scan unroll (auto for deep-skinny stacks,
    models/apertis.py:_decode_unroll) is a pure scheduling knob: logits and
    caches must be bit-identical to unroll=1."""
    from apertis_llm_tpu.models import apertis as model_lib
    from apertis_llm_tpu.models.params import init_params

    config = ApertisConfig.from_dict(dict(
        BASE, num_hidden_layers=5, attention_type="selective_ssm",
        ssm_d_state=8, use_expert_system=True, num_experts=4,
        experts_per_token=2))
    params = init_params(jax.random.PRNGKey(0), config)
    cache = model_lib.init_cache(config, 2, max_length=32)
    ids = jnp.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], jnp.int32)
    out = model_lib.prefill(params, config, cache, ids)
    tok = jnp.asarray([9, 10], jnp.int32)
    t = jnp.asarray(4, jnp.int32)

    monkeypatch.setenv("APERTIS_DECODE_UNROLL", "1")
    logits1, cache1 = model_lib.decode_step(params, config, out.cache, tok, t)
    monkeypatch.setenv("APERTIS_DECODE_UNROLL", "3")
    logits3, cache3 = model_lib.decode_step(params, config, out.cache, tok, t)

    assert jnp.array_equal(logits1, logits3)
    for a, b in zip(jax.tree_util.tree_leaves(cache1),
                    jax.tree_util.tree_leaves(cache3)):
        assert jnp.array_equal(a, b)


def test_compile_effort_knob_parses_and_preserves_tokens(monkeypatch):
    """APERTIS_COMPILE_EFFORT feeds XLA's exec_time_optimization_effort
    into the engine's prefill programs (not the decode loop). Effort is a
    scheduling/optimisation trade: greedy tokens must be unchanged."""
    from apertis_llm_tpu.inference.engine import (InferenceEngine,
                                                  _compiler_options)
    from apertis_llm_tpu.models.params import init_params

    assert _compiler_options() is None
    monkeypatch.setenv("APERTIS_COMPILE_EFFORT", "-1.0")
    assert _compiler_options() == {"exec_time_optimization_effort": -1.0}
    assert _compiler_options(decode=True) is None

    config = ApertisConfig.from_dict(dict(
        BASE, attention_type="selective_ssm", ssm_d_state=8))
    params = init_params(jax.random.PRNGKey(0), config)
    prompt = np.random.default_rng(3).integers(
        4, BASE["vocab_size"], (2, 9)).astype(np.int32)
    out_effort = InferenceEngine(config, params).generate(
        prompt, max_new_tokens=8, eos_token_id=(), do_sample=False)
    monkeypatch.delenv("APERTIS_COMPILE_EFFORT")
    out_default = InferenceEngine(config, params).generate(
        prompt, max_new_tokens=8, eos_token_id=(), do_sample=False)
    np.testing.assert_array_equal(np.asarray(out_effort),
                                  np.asarray(out_default))


@pytest.mark.parametrize("variant", ["mha", "ssm", "ssm_images", "moe"])
def test_last_token_logits_match_full_forward(variant):
    """InferenceEngine.last_token_logits (the serving prefill program,
    bucket-padded) equals the full forward's logits at each prompt's last
    token: the check chip_smoke.py runs against its float32 reference."""
    from apertis_llm_tpu.models import apertis as model_lib
    from apertis_llm_tpu.models.params import init_params

    overrides = {
        "mha": dict(attention_type="standard_mha"),
        "ssm": dict(attention_type="selective_ssm", ssm_d_state=8),
        "ssm_images": dict(attention_type="selective_ssm", ssm_d_state=8,
                           multimodal=True, image_size=32,
                           vision_patch_size=8, vision_embed_dim=32,
                           vision_layers=1, vision_heads=2),
        "moe": dict(attention_type="selective_ssm", ssm_d_state=8,
                    use_expert_system=True, num_experts=4,
                    experts_per_token=2),
    }[variant]
    config = ApertisConfig.from_dict(dict(BASE, **overrides))
    params = init_params(jax.random.PRNGKey(2), config)
    r = np.random.default_rng(5)
    ids = r.integers(4, BASE["vocab_size"], (3, 13)).astype(np.int32)
    pixels = (r.integers(0, 255, (3, 32, 32, 3)).astype(np.uint8)
              if variant == "ssm_images" else None)
    got = InferenceEngine(config, params).last_token_logits(ids, pixels)
    want = model_lib.forward(
        params, config, jnp.asarray(ids),
        pixel_values=None if pixels is None else jnp.asarray(pixels)
    ).logits[:, -1]
    assert got.shape == (3, BASE["vocab_size"])
    # The engine serves MoE decode-sized token counts through the int8 fat
    # expert stack it attaches (models/moe_fuse.py): int8 rounding there.
    atol = 0.06 * float(jnp.max(jnp.abs(want))) if variant == "moe" else 1e-5
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=atol)
