#!/usr/bin/env python
"""Time the choices of apertis_llm_tpu/backend.py and ops/quant.py on one
GPU, at the flagship's serving and the MHA family's training shapes.

    python tools/backend_bench.py [--out chiprun_out/backend_bench.json]

  * int8 weight-only dequant vs the dynamic int8 dot vs bf16: single ops at
    256 to 59,392 rows of the flagship's projections, and a compiled chain
    of 20 FFN layers at 64 to 8,192 rows;
  * cuDNN vs XLA fused attention at the MHA family's training shape.

Every number is a median wall time in ms of a call run to completion,
after a warm-up call; the card's name and power limit are printed first.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def timed(fn, *args, n=7):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[n // 2] * 1e3


def int8_chain(results, layers=20,
               row_counts=(64, 128, 256, 512, 1024, 2048, 4096, 8192)):
    """Weight-only vs dynamic int8 vs bf16 from decode to prefill rows,
    inside one compiled program: ``layers`` of the flagship's dense FFN pair
    (2432 -> 9728 -> 2432, residual) under ``lax.scan``, as the decode
    step runs its layers, so device time and not dispatch is measured."""
    from apertis_llm_tpu.models.quantize import quantize_weight
    from apertis_llm_tpu.ops.quant import quant_matmul_dyn_xla

    kin, mid = 2432, 9728
    w1 = jax.random.normal(jax.random.PRNGKey(2), (layers, kin, mid),
                           jnp.bfloat16) * 0.02
    w2 = jax.random.normal(jax.random.PRNGKey(3), (layers, mid, kin),
                           jnp.bfloat16) * 0.02
    q1, s1 = quantize_weight(w1)
    q2, s2 = quantize_weight(w2)

    def chain(lin):
        def run(x, ws):
            def body(h, w):
                u = jax.nn.gelu(lin(h, *w[0]))
                return h + lin(u, *w[1]), None
            return jax.lax.scan(body, x, ws)[0]
        return jax.jit(run)

    paths = {
        "weightonly": (chain(lambda x, q, s: x @ (q.astype(x.dtype)
                                                  * s.astype(x.dtype))),
                       (((q1, s1), (q2, s2)),)),
        "dyn": (chain(quant_matmul_dyn_xla), (((q1, s1), (q2, s2)),)),
        "bf16": (chain(lambda x, w: x @ w), (((w1,), (w2,)),)),
    }
    for rows in row_counts:
        x = jax.random.normal(jax.random.PRNGKey(1), (rows, kin),
                              jnp.bfloat16)
        row = {}
        for rnd in range(3):   # interleave the paths
            for name, (fn, ws) in paths.items():
                row.setdefault(name, []).append(timed(fn, x, *ws, n=9))
        results[f"int8_chain_{layers}x_rows{rows}"] = row
        print("int8_chain", rows, row, flush=True)


def int8_paths(results):
    from apertis_llm_tpu.models.quantize import quantize_weight
    from apertis_llm_tpu.ops.quant import quant_matmul_dyn_xla

    for rows in (256, 1024, 8192, 59392):
        for kin, nout in ((2432, 9728), (9728, 2432), (2432, 608),
                          (2432, 32000)):
            x = jax.random.normal(jax.random.PRNGKey(1), (rows, kin),
                                  jnp.bfloat16)
            w = jax.random.normal(jax.random.PRNGKey(2), (kin, nout)) * 0.02
            wq, ws = quantize_weight(w)
            row = {
                "weightonly": timed(jax.jit(
                    lambda x, q, s: x @ (q.astype(x.dtype) * s.astype(x.dtype))),
                    x, wq, ws),
                "dyn": timed(jax.jit(quant_matmul_dyn_xla), x, wq, ws),
                "bf16": timed(jax.jit(lambda x, w: x @ w), x,
                              w.astype(jnp.bfloat16)),
            }
            results[f"int8_rows{rows}_{kin}x{nout}"] = row
            print("int8", rows, kin, nout, row, flush=True)


def attention(results):
    for label, (b, l, h, d) in (("mha_train", (8, 1024, 38, 64)),
                                ("mha_prefill_b64", (64, 32, 38, 64))):
        q, k, v = (jax.random.normal(jax.random.PRNGKey(i), (b, l, h, d),
                                     jnp.bfloat16) for i in range(3))
        row = {}
        for impl in ("xla", "cudnn"):
            def f(q, k, v, impl=impl):
                return jax.nn.dot_product_attention(q, k, v, is_causal=True,
                                                    implementation=impl)

            def g(q, k, v, f=f):
                return jnp.sum(f(q, k, v).astype(jnp.float32))
            row[f"{impl}_fwd"] = timed(jax.jit(f), q, k, v)
            row[f"{impl}_fwdbwd"] = timed(
                jax.jit(jax.grad(g, argnums=(0, 1, 2))), q, k, v)
        results[f"attention_{label}"] = row
        print("attention", label, row, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/backend_bench.json")
    ap.add_argument("--parts", default="int8_paths,int8_chain,attention",
                    help="comma-separated subset of the parts to run")
    args = ap.parse_args()
    if jax.default_backend() != "gpu":
        sys.exit("backend_bench: needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print("card:", card, "| jax", jax.__version__, flush=True)
    results = {"card": card, "jax": jax.__version__}
    parts = {f.__name__: f for f in (int8_paths, int8_chain, attention)}
    for name in args.parts.split(","):
        parts[name](results)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
