"""Backend decisions, the compile-cache directory, the peak table, numpy
checkpoints and the on-card smoke script's refusal to run on the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from apertis_llm_tpu import backend

REPO = Path(__file__).resolve().parent.parent


def test_gpu_attention_choice(monkeypatch):
    monkeypatch.setattr(backend, "name", lambda: "gpu")
    impl = backend.fused_attention_implementation
    assert impl(jnp.bfloat16, 1024) == "cudnn"
    assert impl(jnp.float16, 128) == "cudnn"
    assert impl(jnp.bfloat16, 127) is None       # short: XLA's attention
    assert impl(jnp.float32, 1024) is None       # cuDNN takes 16-bit only
    with backend.plain_xla():
        assert impl(jnp.bfloat16, 1024) is None


def test_cpu_choices():
    assert backend.name() == "cpu"
    assert backend.fused_attention_implementation(jnp.bfloat16, 1024) is None


def test_compile_cache_dir_follows_env(monkeypatch):
    from apertis_llm_tpu.utils import jax_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert jax_cache.cache_dir() == "/some/where"
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert jax_cache.cache_dir() == str(REPO / ".jax_cache")
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_peak_table(monkeypatch):
    from apertis_llm_tpu.utils.profiling import device_peak_tflops

    monkeypatch.delenv("APERTIS_PEAK_TFLOPS", raising=False)
    assert device_peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert device_peak_tflops("some other card") is None
    assert device_peak_tflops() is None          # the CPU is not in the table
    monkeypatch.setenv("APERTIS_PEAK_TFLOPS", "12.5")
    assert device_peak_tflops("some other card") == 12.5


def test_chip_smoke_refuses_the_cpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    # Alone in a directory, without the repository, it refuses as well.
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(alone)], capture_output=True,
                         text=True, env=env, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _tiny():
    from apertis_llm_tpu.config import ApertisConfig
    from apertis_llm_tpu.models.params import init_params

    config = ApertisConfig(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                           num_attention_heads=2, intermediate_size=64,
                           attention_type="selective_ssm", ssm_d_state=4)
    return config, init_params(jax.random.PRNGKey(0), config)


def test_numpy_train_state_round_trip(tmp_path):
    """The full train state saves as numpy and restores against a template
    (no orbax); a template of another structure is refused."""
    from apertis_llm_tpu.training.step import (create_train_state,
                                               make_optimizer)
    from apertis_llm_tpu.utils.checkpoint import (
        latest_checkpoint, restore_train_state, save_checkpoint)

    config, params = _tiny()
    tx, _ = make_optimizer(1e-3, 10)
    state = create_train_state(params, tx, jax.random.PRNGKey(1))
    state = state._replace(step=jnp.asarray(7, jnp.int32))
    save_checkpoint(tmp_path / "ck", state, config, export_torch=False)
    assert latest_checkpoint(tmp_path) == (tmp_path / "ck").resolve()

    template = create_train_state(
        jax.tree.map(jnp.zeros_like, params), tx, jax.random.PRNGKey(2))
    got = restore_train_state(tmp_path / "ck", template)
    assert int(got.step) == 7
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError):
        restore_train_state(tmp_path / "ck", {"only": jnp.zeros(3)})


def test_weights_without_torch_save_npz_and_load(tmp_path, monkeypatch):
    """Where torch does not import, the weight export is model.npz in the
    reference's state-dict layout, and load_pretrained reads it back."""
    from apertis_llm_tpu.models import apertis as model_lib
    from apertis_llm_tpu.models.convert import (load_pretrained,
                                                save_pretrained_weights)

    monkeypatch.setitem(sys.modules, "torch", None)   # import torch fails
    config, params = _tiny()
    save_pretrained_weights(params, config, tmp_path)
    assert (tmp_path / "model.npz").exists()
    assert not (tmp_path / "pytorch_model.bin").exists()
    config2, params2 = load_pretrained(tmp_path)
    assert config2.hidden_size == config.hidden_size
    ids = jnp.asarray([[1, 5, 9, 3]])
    np.testing.assert_allclose(
        np.asarray(model_lib.forward(params2, config2, ids).logits),
        np.asarray(model_lib.forward(params, config, ids).logits),
        rtol=1e-6, atol=1e-6)


def test_cache_enable_sets_the_repo_dir_only_without_env(monkeypatch):
    from apertis_llm_tpu.utils import jax_cache

    seen = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.__setitem__(k, v))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jax_cache.maybe_enable_cache() == str(REPO / ".jax_cache")
    assert seen["jax_compilation_cache_dir"] == str(REPO / ".jax_cache")
    seen.clear()
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/env/dir")
    assert jax_cache.maybe_enable_cache() == "/env/dir"
    assert "jax_compilation_cache_dir" not in seen   # JAX reads the env


def test_peak_env_override_must_parse(monkeypatch):
    from apertis_llm_tpu.utils.profiling import device_peak_tflops

    monkeypatch.setenv("APERTIS_PEAK_TFLOPS", "not-a-number")
    assert device_peak_tflops("NVIDIA H100 PCIe") == 989.0


def test_executor_child_never_claims_the_accelerator(monkeypatch):
    from apertis_llm_tpu.training.azr.executor import PythonExecutor

    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    ex = PythonExecutor({"timeout": 30})
    assert ex.env["JAX_PLATFORMS"] == "cpu"
    out = ex.execute("import os; print(os.environ['JAX_PLATFORMS'])")
    assert out["success"] and out["output"].strip() == "cpu"


def test_distributed_init_without_coordinator_is_single_process(monkeypatch):
    from apertis_llm_tpu.parallel.mesh import initialize_distributed

    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert initialize_distributed() is False


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_compare_passes_and_fails(capsys):
    cs = _chip_smoke()
    ref = np.linspace(1.0, 2.0, 100)
    cs.compare("close", ref * (1 + 1e-4), ref, 1e-3, "test")
    assert "[ok] close" in capsys.readouterr().out
    with pytest.raises(cs.SmokeFailure):
        cs.compare("far", ref * 1.1, ref, 1e-3, "test")
    with pytest.raises(cs.SmokeFailure):
        cs.compare("nan", ref * np.nan, ref, 1e-3, "test")
    with pytest.raises(cs.SmokeFailure):
        cs.compare("shape", ref[:10], ref, 1e-3, "test")


@pytest.mark.parametrize("engine_err,witness_err,routed,flipped,ok", [
    (0.02, 0.02, False, 0, True),     # the engine errs as the plain path
    (0.029, 0.02, False, 0, True),    # within 1.5x of its witness
    (0.031, 0.02, False, 0, False),   # beyond: the engine's own error
    (0.06, 0.06, False, 0, False),    # the witness itself out of bounds
    (0.02, 0.02, True, 10, True),     # routed: a few flipped rows pass
    (0.02, 0.02, True, 40, False)])   # ... but not a quarter of them
def test_chip_smoke_hold(engine_err, witness_err, routed, flipped, ok):
    """``hold`` bounds the witness (plain forward, same precision) by the
    tolerance and the engine by 1.5x the witness; routed families compare
    median rows and need 90% of rows within the tolerance."""
    cs = _chip_smoke()
    r = np.random.default_rng(0)
    ref = r.normal(size=(100, 64))

    def off(err, rows_flipped=0):
        d = r.normal(size=ref.shape)
        d *= (err * np.linalg.norm(ref, axis=1)
              / np.linalg.norm(d, axis=1))[:, None]
        d[:rows_flipped] *= 30.0
        return ref + d

    got = off(engine_err, flipped if routed else 0)
    if ok:
        cs.hold("t", got, off(witness_err), ref, 0.05, routed)
    else:
        with pytest.raises(cs.SmokeFailure):
            cs.hold("t", got, off(witness_err), ref, 0.05, routed)


def test_chip_smoke_rel_errors():
    cs = _chip_smoke()
    ref = np.ones((4, 10))
    got = ref.copy()
    got[0] *= 2.0
    l2, med, mx, rows = cs.rel_errors(got, ref)
    np.testing.assert_allclose(rows, [1.0, 0.0, 0.0, 0.0])
    assert med == 0.0 and mx == 1.0
    np.testing.assert_allclose(l2, 0.5)


@pytest.mark.parametrize("arch,hidden,layers,heads", [
    ("ssm", 2432, 20, 38), ("moe", 704, 44, 11), ("mha", 2432, 20, 38)])
def test_chip_smoke_families_are_the_bench_widths(arch, hidden, layers,
                                                  heads):
    """The smoke test serves each family at the "1.5B" factory preset's
    widths, as bench.py does; depth cuts are explicit."""
    cs = _chip_smoke()
    config = cs.family_config(arch)
    assert (config.hidden_size, config.num_hidden_layers,
            config.num_attention_heads) == (hidden, layers, heads)
    assert config.vocab_size == 32000
    assert config.multimodal == (arch != "mha")
    assert config.use_expert_system == (arch == "moe")
    assert cs.family_config(arch, depth=2).num_hidden_layers == 2


def test_chip_smoke_repeated_batch():
    cs = _chip_smoke()
    ids = np.arange(12, dtype=np.int32).reshape(2, 6)
    ds = cs._RepeatedBatch(ids, 5)
    assert len(ds) == 5 and ds.max_length == 6
    np.testing.assert_array_equal(ds[3]["input_ids"], ids[1])
    np.testing.assert_array_equal(ds[3]["labels"], ids[1])
