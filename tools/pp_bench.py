#!/usr/bin/env python
"""Pipeline-parallel throughput comparison.

Runs the same global batch through (a) a single-program baseline on one
device's worth of mesh, (b) the GPipe schedule, (c) the 1F1B schedule, on
the 8-virtual-CPU-device mesh, and prints steps/s plus the analytic bubble
model:

    GPipe   utilization = M / (M + S - 1)        (fwd and bwd each)
    1F1B    utilization = M / (M + 2S - 1)       (fwd+bwd interleaved ticks)

CPU wall-clock is only a RELATIVE signal (virtual devices share host
cores), but schedule overhead and bubble scaling with M are visible.

Usage:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python tools/pp_bench.py
"""

import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax.numpy as jnp

from apertis_llm_tpu.config import ApertisConfig
from apertis_llm_tpu.models.params import init_params
from apertis_llm_tpu.parallel.mesh import create_mesh
from apertis_llm_tpu.training.pp_step import (
    make_pp_loss_and_grads_1f1b, make_pp_loss_fn, shard_params_for_pipeline)
from apertis_llm_tpu.training.step import loss_fn as single_loss_fn

S = 4            # pipeline stages
B, L = 32, 128   # global batch (divisible by data_parallel * max microbatches)


def timeit(fn, *args, n=3):
    fn(*args)  # compile
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def main():
    config = ApertisConfig(
        vocab_size=2048, hidden_size=256, num_hidden_layers=8,
        num_attention_heads=8, intermediate_size=1024,
        attention_type="selective_ssm", ssm_d_state=16,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        max_position_embeddings=512)
    params = init_params(jax.random.PRNGKey(0), config)
    mesh = create_mesh(jax.devices()[:8], (2, S, 1, 1))
    sharded = shard_params_for_pipeline(params, mesh)

    ids = np.random.default_rng(0).integers(4, 2048, size=(B, L)).astype(np.int32)
    batch = {"input_ids": jnp.asarray(ids), "labels": jnp.asarray(ids)}

    def single(p, bt):
        loss, _ = single_loss_fn(p, config, bt, None)
        return jax.grad(lambda pp: single_loss_fn(pp, config, bt, None)[0])(p)

    t_single = timeit(jax.jit(single), params, batch)
    tok = B * L
    print(f"single-program:      {t_single*1e3:8.1f} ms/step "
          f"({tok/t_single:8.0f} tok/s)")

    for M in (4, 8, 16):
        gp = make_pp_loss_fn(config, mesh, num_micro=M)

        def gpipe(p, bt):
            return jax.grad(lambda pp: gp(pp, bt, None)[0])(p)

        t_gp = timeit(jax.jit(gpipe), sharded, batch)
        fb = make_pp_loss_and_grads_1f1b(config, mesh, num_micro=M)

        def one_f1b(p, bt):
            return fb(p, bt, None)[2]

        t_fb = timeit(jax.jit(one_f1b), sharded, batch)
        u_gp = M / (M + S - 1)
        u_fb = M / (M + 2 * S - 1)
        print(f"M={M:2d}  GPipe: {t_gp*1e3:8.1f} ms ({tok/t_gp:8.0f} tok/s, "
              f"model util {u_gp:.0%})   1F1B: {t_fb*1e3:8.1f} ms "
              f"({tok/t_fb:8.0f} tok/s, model util {u_fb:.0%})")


if __name__ == "__main__":
    main()
