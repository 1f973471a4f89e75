"""Sequence-parallel SSM scan: sharded-L result equals the single-device scan."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from apertis_llm_tpu.ops.ssm import selective_scan
from apertis_llm_tpu.parallel.mesh import create_mesh
from apertis_llm_tpu.parallel.sequence import ssm_scan_sequence_parallel

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 (virtual) devices")


def test_sequence_parallel_scan_matches_single_device():
    rng = np.random.default_rng(0)
    b, h, l, n = 2, 3, 256, 8    # L shards over 4 devices -> 64 per chunk
    a = jnp.asarray(rng.uniform(0.4, 0.999, (b, h, l, n)), jnp.float32)
    bt = jnp.asarray(rng.normal(size=(b, h, l, n)), jnp.float32)

    ref_h, ref_last = selective_scan(a, bt)

    mesh = create_mesh(jax.devices()[:4], (1, 4, 1))
    shard = NamedSharding(mesh, P(None, None, "model", None))
    a_s = jax.device_put(a, shard)
    b_s = jax.device_put(bt, shard)

    h, h_last = jax.jit(
        lambda a, b: ssm_scan_sequence_parallel(a, b, mesh, "model")
    )(a_s, b_s)

    np.testing.assert_allclose(np.asarray(h), np.asarray(ref_h),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(h_last), np.asarray(ref_last),
                               rtol=1e-5, atol=1e-5)
    # Output keeps the sequence sharding (no implicit gather of activations).
    assert h.sharding.spec == P(None, None, "model", None)


def test_sequence_parallel_grads_flow():
    rng = np.random.default_rng(1)
    b, h, l, n = 1, 2, 128, 4
    a = jnp.asarray(rng.uniform(0.4, 0.999, (b, h, l, n)), jnp.float32)
    bt = jnp.asarray(rng.normal(size=(b, h, l, n)), jnp.float32)

    mesh = create_mesh(jax.devices()[:4], (1, 4, 1))
    shard = NamedSharding(mesh, P(None, None, "model", None))
    a_s, b_s = jax.device_put(a, shard), jax.device_put(bt, shard)

    def loss_sp(a, b):
        return jnp.sum(ssm_scan_sequence_parallel(a, b, mesh, "model")[0] ** 2)

    def loss_ref(a, b):
        return jnp.sum(selective_scan(a, b)[0] ** 2)

    gsp = jax.jit(jax.grad(loss_sp, argnums=(0, 1)))(a_s, b_s)
    gref = jax.grad(loss_ref, argnums=(0, 1))(a, bt)
    np.testing.assert_allclose(np.asarray(gsp[0]), np.asarray(gref[0]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(gsp[1]), np.asarray(gref[1]),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# User-facing wiring: the trainer's 4th mesh axis routes the model through
# sequence-parallel scan / ring attention.
# ---------------------------------------------------------------------------

def _config(**over):
    from apertis_llm_tpu.config import ApertisConfig

    base = dict(
        vocab_size=128,
        hidden_size=64,
        num_hidden_layers=2,
        num_attention_heads=4,
        intermediate_size=128,
        max_position_embeddings=64,
        hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0,
    )
    base.update(over)
    return ApertisConfig.from_dict(base)


@pytest.mark.parametrize("variant", ["ssm", "mha", "mha_padded"])
def test_sp_loss_matches_single_device(variant):
    """Forward+loss with L sharded 4-way == unsharded, to 1e-4."""
    from apertis_llm_tpu.models.params import init_params
    from apertis_llm_tpu.parallel.context import parallel_context
    from apertis_llm_tpu.training.step import loss_fn

    over = (dict(attention_type="selective_ssm", ssm_d_state=8)
            if variant == "ssm" else {})
    config = _config(**over)
    params = init_params(jax.random.PRNGKey(0), config)

    rng = np.random.default_rng(3)
    b, l = 4, 16
    ids = rng.integers(4, config.vocab_size, size=(b, l)).astype(np.int32)
    mask = np.ones((b, l), np.int32)
    labels = ids.copy()
    if variant == "mha_padded":
        mask[1, 10:] = 0
        mask[3, 5:] = 0
        labels = np.where(mask > 0, labels, -100)
    batch = {"input_ids": jnp.asarray(ids),
             "attention_mask": jnp.asarray(mask),
             "labels": jnp.asarray(labels)}

    single = float(loss_fn(params, config, batch, None)[0])

    mesh = create_mesh(jax.devices()[:8], (2, 1, 1, 4))
    sharded = jax.device_put(params, NamedSharding(mesh, P()))
    sharded_batch = jax.device_put(batch, NamedSharding(mesh, P("data")))

    def sp_loss(p, bt):
        with parallel_context(mesh, sp_axis="seq", batch_axis="data"):
            return loss_fn(p, config, bt, None)[0]

    dist = float(jax.jit(sp_loss)(sharded, sharded_batch))
    assert abs(single - dist) < 1e-4, f"{variant}: {single} vs {dist}"


@pytest.mark.parametrize("variant", ["ssm", "mha"])
def test_sp_grads_match_single_device(variant):
    """Gradients through the SP-routed model match unsharded training."""
    from apertis_llm_tpu.models.params import init_params
    from apertis_llm_tpu.parallel.context import parallel_context
    from apertis_llm_tpu.training.step import loss_fn

    over = (dict(attention_type="selective_ssm", ssm_d_state=8)
            if variant == "ssm" else {})
    config = _config(**over)
    params = init_params(jax.random.PRNGKey(0), config)
    rng = np.random.default_rng(4)
    ids = rng.integers(4, config.vocab_size, size=(4, 16)).astype(np.int32)
    batch = {"input_ids": jnp.asarray(ids),
             "attention_mask": jnp.ones((4, 16), jnp.int32),
             "labels": jnp.asarray(ids)}

    gref = jax.grad(lambda p: loss_fn(p, config, batch, None)[0])(params)

    mesh = create_mesh(jax.devices()[:8], (2, 1, 1, 4))
    sharded = jax.device_put(params, NamedSharding(mesh, P()))
    sharded_batch = jax.device_put(batch, NamedSharding(mesh, P("data")))

    def sp_loss(p, bt):
        with parallel_context(mesh, sp_axis="seq", batch_axis="data"):
            return loss_fn(p, config, bt, None)[0]

    gsp = jax.jit(jax.grad(sp_loss))(sharded, sharded_batch)
    flat_ref = jax.tree.leaves(gref)
    flat_sp = jax.tree.leaves(gsp)
    for r, s in zip(flat_ref, flat_sp):
        np.testing.assert_allclose(np.asarray(s), np.asarray(r),
                                   rtol=2e-4, atol=2e-4)


def test_train_from_config_sequence_parallel(tmp_path):
    """train_from_config with mesh_shape [2,1,1,4]: the SP knob is reachable
    from the user-facing training config and optimises identically to the
    data-parallel-only mesh."""
    import json

    from apertis_llm_tpu.training import train_from_config

    vocab = {"<pad>": 0, "<bos>": 1, "<eos>": 2, "<unk>": 3}
    words = ["the", "cat", "sat", "on", "mat", "dog", "ran", "fast"]
    for i, w in enumerate(words):
        vocab[w] = 4 + i
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    rng = np.random.default_rng(0)
    lines = [json.dumps({"text": " ".join(rng.choice(words, 10))})
             for _ in range(16)]
    (tmp_path / "train.jsonl").write_text("\n".join(lines))

    def cfg(mesh_shape, out):
        return {
            "data_config": {
                "train_data_path": str(tmp_path / "train.jsonl"),
                "tokenizer_path": str(tmp_path / "vocab.json"),
                "max_length": 16,
            },
            "model_config": {
                "target_param_count": "10M",
                "attention_type": "selective_ssm",
                "ssm_d_state": 8,
                "config_overrides": {
                    "hidden_size": 64, "num_hidden_layers": 2,
                    "num_attention_heads": 4, "intermediate_size": 128,
                    "hidden_dropout_prob": 0.0,
                    "attention_probs_dropout_prob": 0.0,
                },
            },
            "training_config": {
                "task_type": "pretrain",
                "output_dir": str(tmp_path / out),
                "batch_size": 8,
                "learning_rate": 1e-3,
                "num_epochs": 1,
                "gradient_accumulation_steps": 1,
                "bf16": False,
                "use_gradient_checkpointing": False,
                "mesh_shape": mesh_shape,
            },
        }

    p_sp = tmp_path / "sp.json"
    p_sp.write_text(json.dumps(cfg([2, 1, 1, 4], "out_sp")))
    p_dp = tmp_path / "dp.json"
    p_dp.write_text(json.dumps(cfg([8, 1, 1, 1], "out_dp")))

    hist_sp = train_from_config(str(p_sp))
    hist_dp = train_from_config(str(p_dp))
    assert np.isfinite(hist_sp["train_loss"][0])
    assert abs(hist_sp["train_loss"][0] - hist_dp["train_loss"][0]) < 1e-4
