"""End-to-end training: config file -> train_from_config -> checkpoints ->
resume -> fine-tune, all on the virtual 8-device CPU mesh."""

import json
from pathlib import Path

import numpy as np
import pytest

import jax


def _write_pretrain_setup(tmp_path: Path, n_items=32, max_length=24):
    vocab = {"<pad>": 0, "<bos>": 1, "<eos>": 2, "<unk>": 3}
    words = ["the", "cat", "sat", "on", "mat", "dog", "ran", "fast", "sun", "moon"]
    for i, w in enumerate(words):
        vocab[w] = 4 + i
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))

    rng = np.random.default_rng(0)
    lines = []
    for _ in range(n_items):
        n = int(rng.integers(4, 12))
        lines.append(json.dumps({"text": " ".join(rng.choice(words, n))}))
    (tmp_path / "train.jsonl").write_text("\n".join(lines))
    (tmp_path / "val.jsonl").write_text("\n".join(lines[:8]))

    config = {
        "data_config": {
            "train_data_path": str(tmp_path / "train.jsonl"),
            "val_data_path": str(tmp_path / "val.jsonl"),
            "tokenizer_path": str(tmp_path / "vocab.json"),
            "max_length": max_length,
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
            "output_dir": str(tmp_path / "out"),
            "batch_size": 8,
            "learning_rate": 1e-3,
            "num_epochs": 2,
            "gradient_accumulation_steps": 1,
            "bf16": False,
            "use_gradient_checkpointing": False,
        },
    }
    cfg_path = tmp_path / "train_config.json"
    cfg_path.write_text(json.dumps(config))
    return cfg_path, config


def test_pretrain_end_to_end(tmp_path):
    from apertis_llm_tpu.training import train_from_config

    cfg_path, _ = _write_pretrain_setup(tmp_path)
    history = train_from_config(str(cfg_path))

    assert len(history["train_loss"]) == 2
    assert history["train_loss"][1] < history["train_loss"][0]
    out = tmp_path / "out"
    final = out / "final"
    assert (final / "pytorch_model.bin").exists()
    assert (final / "config.json").exists()
    assert (final / "state").exists()       # full train state (numpy)
    assert (final / "vocab.json").exists()  # tokenizer copied alongside
    best = out / "best_model"
    if best.exists():
        # best_model is the weights-only inference artifact (r5: skipping
        # the optimizer-state D2H); resume state lives in final/epoch dirs.
        assert (best / "pytorch_model.bin").exists()
        assert not (best / "state").exists()

    # The exported checkpoint round-trips through the inference loader.
    from apertis_llm_tpu.models.convert import load_pretrained

    config, params = load_pretrained(final)
    assert config.attention_type == "selective_ssm"
    assert params["embed"]["tok"].shape[0] == config.vocab_size


def test_resume_from_checkpoint(tmp_path):
    from apertis_llm_tpu.training import train_from_config

    cfg_path, config = _write_pretrain_setup(tmp_path)
    first = train_from_config(str(cfg_path))

    config["training_config"]["resume_from"] = str(tmp_path / "out" / "final")
    config["training_config"]["num_epochs"] = 1
    config["training_config"]["output_dir"] = str(tmp_path / "out2")
    cfg2 = tmp_path / "resume_config.json"
    cfg2.write_text(json.dumps(config))
    history = train_from_config(str(cfg2))
    # Resumed training continues from trained weights + optimizer state:
    # its first epoch is better than the fresh run's first epoch AND no
    # worse than where the first run ended.
    assert history["train_loss"][0] < first["train_loss"][0]
    assert history["train_loss"][0] <= first["train_loss"][-1] + 0.05


def test_finetune_from_pretrained(tmp_path):
    from apertis_llm_tpu.training import train_from_config

    cfg_path, config = _write_pretrain_setup(tmp_path)
    train_from_config(str(cfg_path))

    ft_lines = [json.dumps({"instruction": "say cat", "output": "cat sat"})] * 16
    (tmp_path / "ft.jsonl").write_text("\n".join(ft_lines))
    ft_config = {
        "data_config": {
            "train_data_path": str(tmp_path / "ft.jsonl"),
            "tokenizer_path": str(tmp_path / "vocab.json"),
            "max_length": 24,
        },
        "model_config": {},
        "training_config": {
            "task_type": "finetune",
            "pretrained_model_path_for_finetune": str(tmp_path / "out" / "final"),
            "output_dir": str(tmp_path / "ft_out"),
            "batch_size": 8,
            "learning_rate": 1e-3,
            "num_epochs": 1,
            "gradient_accumulation_steps": 1,
            "bf16": False,
            "use_gradient_checkpointing": False,
        },
    }
    cfg2 = tmp_path / "ft_config.json"
    cfg2.write_text(json.dumps(ft_config))
    history = train_from_config(str(cfg2))
    assert np.isfinite(history["train_loss"][0])
    assert (tmp_path / "ft_out" / "final" / "pytorch_model.bin").exists()


def test_finetune_embedding_resize():
    from apertis_llm_tpu.config import ApertisConfig
    from apertis_llm_tpu.models.params import init_params
    from apertis_llm_tpu.training.pipeline import resize_embeddings

    config = ApertisConfig(vocab_size=100, hidden_size=32,
                           num_hidden_layers=1, num_attention_heads=2,
                           intermediate_size=64)
    params = init_params(jax.random.PRNGKey(0), config)
    resized = resize_embeddings(params, config, 150)
    assert resized["embed"]["tok"].shape == (150, 32)
    np.testing.assert_array_equal(
        np.asarray(resized["embed"]["tok"][:100]),
        np.asarray(params["embed"]["tok"]))


@pytest.mark.parametrize("moe", [False, True])
def test_grads_finite_with_pad_token_tails(moe):
    """Regression: zero pad-embedding rows (reference zero-inits padding_idx,
    core.py:1051) flow through the norms as exact-zero vectors. Two failure
    modes, both fixed in ops/norms.py: (1) sqrt-of-sum-of-squares backward is
    infinite at 0 (NaN'd every SSM training run on padded batches); (2) the
    1/eps-scaled subgradient at degenerate rows compounds per layer through
    MoE aux-loss cotangents and overflows fp32 within two layers."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from apertis_llm_tpu.config import ApertisConfig
    from apertis_llm_tpu.models.params import init_params
    from apertis_llm_tpu.training.step import loss_fn

    config = ApertisConfig(vocab_size=64, hidden_size=64, num_hidden_layers=2,
                           num_attention_heads=4, intermediate_size=128,
                           attention_type="selective_ssm", ssm_d_state=8,
                           use_rmsnorm=True, use_swiglu=not moe,
                           use_expert_system=moe, num_experts=4,
                           experts_per_token=2)
    params = init_params(jax.random.PRNGKey(0), config)
    ids = np.random.default_rng(0).integers(4, 64, (4, 16))
    ids[:, 6:] = config.pad_token_id            # trailing pad runs
    ids = jnp.asarray(ids, jnp.int32)
    labels = jnp.where(ids == config.pad_token_id, -100, ids)
    batch = {"input_ids": ids, "labels": labels,
             "attention_mask": (ids != config.pad_token_id).astype(jnp.int32)}
    (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params, config, batch, jax.random.PRNGKey(1))
    assert np.isfinite(float(loss))
    assert all(bool(jnp.isfinite(g).all()) for g in jax.tree.leaves(grads))


def test_pretrain_dataset_hf_tokenizer(tmp_path):
    """Extension over the reference: subword pretraining rows via an HF-style
    tokenizer — EOS-terminated, padded, out-of-range ids remapped."""
    import json
    from apertis_llm_tpu.training.datasets import ApertisPretrainDataset

    path = tmp_path / "t.jsonl"
    path.write_text(json.dumps({"text": "hello world"}) + "\n")

    class StubTok:
        def encode(self, text, add_special_tokens=False):
            assert not add_special_tokens
            return [7, 9, 999]   # 999 exceeds the model vocab

    ds = ApertisPretrainDataset(
        str(path), hf_tokenizer=StubTok(), model_config_vocab_size=100,
        max_length=8, pad_token_id=0, unk_token_id=3, eos_token_id=2)
    item = ds[0]
    assert item["input_ids"].tolist() == [7, 9, 3, 2, 0, 0, 0, 0]
    assert item["attention_mask"].tolist() == [1, 1, 1, 1, 0, 0, 0, 0]
    assert item["labels"].tolist() == [7, 9, 3, 2, -100, -100, -100, -100]


def test_epoch_perf_stats_and_mfu(tmp_path, monkeypatch):
    """The trainer's epoch summary carries throughput + MFU (vs the chip's
    known bf16 peak; APERTIS_PEAK_TFLOPS overrides so CPU runs get one)."""
    from apertis_llm_tpu.training import train_from_config
    from apertis_llm_tpu.utils.profiling import device_peak_tflops

    monkeypatch.setenv("APERTIS_PEAK_TFLOPS", "0.5")
    assert device_peak_tflops() == 0.5

    cfg_path, cfg = _write_pretrain_setup(tmp_path, n_items=16)
    cfg["training_config"]["num_epochs"] = 1
    cfg_path.write_text(json.dumps(cfg))
    history = train_from_config(str(cfg_path))

    perf = history["perf"]
    assert perf["tokens_per_sec"] > 0
    # mfu = tok/s * 6N / peak; recompute N from the saved config (the same
    # resolution the pipeline used) against the recorded throughput.
    from apertis_llm_tpu.config import ApertisConfig
    from apertis_llm_tpu.models.params import count_params, init_params
    config = ApertisConfig.from_pretrained(str(tmp_path / "out" / "final"))
    n = count_params(init_params(jax.random.PRNGKey(0), config))
    expect = perf["tokens_per_sec"] * 6.0 * n / 0.5e12 * 100.0
    assert perf["mfu_pct"] == pytest.approx(expect, rel=1e-6)
