"""Golden-logit parity vs the PyTorch reference (eval mode, fp32).

Each variant builds a small reference model, converts its weights, and checks
our logits match within 1e-3 (the parity bar) — usually far tighter.
"""

import numpy as np
import pytest

from tests.reference_oracle import load_reference

core = load_reference()
requires_ref = pytest.mark.skipif(core is None, reason="reference oracle unavailable")

import jax
import jax.numpy as jnp

from apertis_llm_tpu.config import ApertisConfig
from apertis_llm_tpu.models import apertis as model_lib
from apertis_llm_tpu.models.convert import from_torch_state_dict

BASE = dict(
    vocab_size=97,
    hidden_size=64,
    num_hidden_layers=2,
    num_attention_heads=4,
    intermediate_size=128,
    max_position_embeddings=64,
    hidden_dropout_prob=0.0,
    attention_probs_dropout_prob=0.0,
)

VARIANTS = {
    "mha_dense": {},
    "mha_dense_dropout_cfg": dict(hidden_dropout_prob=0.1,
                                  attention_probs_dropout_prob=0.1),
    "mha_rmsnorm_swiglu": dict(use_rmsnorm=True, use_swiglu=True),
    "ssm_dense": dict(attention_type="selective_ssm", ssm_d_state=8),
    "ssm_swiglu": dict(attention_type="selective_ssm", ssm_d_state=8,
                       use_swiglu=True, use_rmsnorm=True),
    "mha_moe": dict(use_expert_system=True, num_experts=4, experts_per_token=2),
    "ssm_moe": dict(attention_type="selective_ssm", ssm_d_state=8,
                    use_expert_system=True, num_experts=4, experts_per_token=2),
    "absolute_pos": dict(position_embedding_type="absolute"),
}


def _build_pair(overrides):
    import torch

    cfg_kwargs = dict(BASE)
    cfg_kwargs.update(overrides)
    torch.manual_seed(0)
    ref_config = core.ApertisConfig(**cfg_kwargs)
    ref_model = core.ApertisForCausalLM(ref_config)
    ref_model.eval()
    sd = {k: v.detach().numpy() for k, v in ref_model.state_dict().items()}
    config = ApertisConfig.from_dict(cfg_kwargs)
    params = from_torch_state_dict(sd, config)
    return ref_model, config, params


def _ref_logits(ref_model, input_ids, attention_mask=None):
    import torch

    with torch.no_grad():
        out = ref_model(
            input_ids=torch.from_numpy(input_ids),
            attention_mask=(torch.from_numpy(attention_mask)
                            if attention_mask is not None else None),
            use_cache=False,
        )
    return out[1].numpy()


@requires_ref
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_logit_parity(variant):
    ref_model, config, params = _build_pair(VARIANTS[variant])
    rng = np.random.default_rng(42)
    input_ids = rng.integers(4, config.vocab_size, size=(2, 17)).astype(np.int64)

    ref = _ref_logits(ref_model, input_ids)
    ours = model_lib.forward(params, config, jnp.asarray(input_ids)).logits
    ours = np.asarray(ours)

    assert ref.shape == ours.shape
    err = np.max(np.abs(ref - ours))
    assert err < 1e-3, f"{variant}: max logit error {err}"


@requires_ref
def test_logit_parity_multimodal():
    """ViT prefix fusion: identical pixel tensors -> identical text logits
    (pins the in-graph ViT against torch TransformerEncoderLayer)."""
    import torch

    overrides = dict(multimodal=True, image_size=32, vision_patch_size=8,
                     vision_embed_dim=48, vision_layers=2, vision_heads=4)
    ref_model, config, params = _build_pair(overrides)

    rng = np.random.default_rng(11)
    input_ids = rng.integers(4, config.vocab_size, size=(2, 9)).astype(np.int64)
    pixels = rng.normal(size=(2, 3, 32, 32)).astype(np.float32)

    with torch.no_grad():
        ref = ref_model(input_ids=torch.from_numpy(input_ids),
                        pixel_values=torch.from_numpy(pixels),
                        use_cache=False)[1].numpy()
    ours = np.asarray(model_lib.forward(
        params, config, jnp.asarray(input_ids),
        pixel_values=jnp.asarray(pixels)).logits)

    assert ref.shape == ours.shape  # logits sliced to text positions
    err = np.max(np.abs(ref - ours))
    assert err < 1e-3, f"multimodal: max logit error {err}"


@requires_ref
def test_logit_parity_padded_batch():
    ref_model, config, params = _build_pair({})
    rng = np.random.default_rng(7)
    input_ids = rng.integers(4, config.vocab_size, size=(2, 12)).astype(np.int64)
    attention_mask = np.ones((2, 12), dtype=np.int64)
    attention_mask[0, :4] = 0  # left padding on row 0
    input_ids[0, :4] = config.pad_token_id

    ref = _ref_logits(ref_model, input_ids, attention_mask)
    ours = model_lib.forward(
        params, config, jnp.asarray(input_ids),
        attention_mask=jnp.asarray(attention_mask)).logits
    ours = np.asarray(ours)

    # Compare only on non-pad query positions (masked positions produce
    # garbage logits in both frameworks but are not bit-identical).
    valid = attention_mask.astype(bool)
    err = np.max(np.abs(ref[valid] - ours[valid]))
    assert err < 1e-3, f"padded: max logit error {err}"


@requires_ref
def test_loss_parity():
    ref_model, config, params = _build_pair({})
    import torch

    rng = np.random.default_rng(3)
    input_ids = rng.integers(4, config.vocab_size, size=(2, 10)).astype(np.int64)
    labels = input_ids.copy()
    labels[:, :2] = -100
    with torch.no_grad():
        ref_out = ref_model(
            input_ids=torch.from_numpy(input_ids),
            labels=torch.from_numpy(labels),
            use_cache=False,
        )
    ref_loss = float(ref_out[0])
    ours = model_lib.forward(
        params, config, jnp.asarray(input_ids), labels=jnp.asarray(labels))
    assert abs(ref_loss - float(ours.loss)) < 1e-4
