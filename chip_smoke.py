#!/usr/bin/env python
"""Prove on NVIDIA GPUs that Apertis's main paths run and give right answers.

    python chip_smoke.py            # one card: phases 1-5
    python chip_smoke.py --multi    # four cards: data-parallel training and
                                    # tensor-parallel serving, nothing else

One card:
  1. device: JAX version, device kind and count, the card's name and power
     limit, XLA_FLAGS, the compile-cache directory;
  2. serving the flagship (multimodal selective-SSM "1.5B" factory preset,
     1.218B params, vocab 32000) through InferenceEngine at batch 256 with
     image+text prompts: float32, bf16 and int8 prefill logits against the
     float32 forward on the same weights, each served precision beside the
     plain forward at that precision, then an int8 greedy generation
     (tolerances and their reasons: ``serve_family``, ``hold``);
  3. the MoE (top-2 of 8, b256, images) and MHA (b64, text, int8 KV cache)
     families at their bench widths, the same way; the MoE's served
     precisions are gated at one layer, where a rounding that flips an
     expert touches only its own row, and reported at full depth beside
     their witness and ``routing_sensitivity``;
  4. cuDNN's fused attention (the one library kernel backend.py chooses)
     against the plain attention in float32 at the MHA family's widths,
     forward and gradient, with its time beside XLA's;
  5. training through ApertisTrainer at the flagship's widths (depth cut to
     2 layers), batch 8 x 1024, bf16 compute, with its checkpoint save.

Weights are random, from fixed seeds. Every comparison prints its error and
tolerance; any failure exits non-zero before the last line, which is
``{"ok": true, "device": {...}}``. Without a GPU, or without the
repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PROMPT_LEN = 32
SEED = 0
# (label, batch, length) of the fused-attention check: the MHA family's
# training shape and a prefill above cuDNN's 128-token floor, 38 heads x 64.
ATTN_SHAPES = (("train", 8, 1024), ("prefill", 64, 256))
ATTN_HEADS, ATTN_DIM = 38, 64
TRAIN_SHAPE = (8, 1024)   # (batch, sequence length) of the training phases


class SmokeFailure(Exception):
    pass


def log(*parts):
    print(*parts, flush=True)


def compare(name, got, ref, tol, what):
    """Max-abs and relative-L2 error of ``got`` against ``ref``; fails when
    the relative L2 error exceeds ``tol``."""
    import numpy as np

    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        raise SmokeFailure(f"{name}: shape {got.shape} != {ref.shape}")
    if not np.isfinite(got).all():
        raise SmokeFailure(f"{name}: non-finite values")
    max_abs = float(np.max(np.abs(got - ref)))
    rel_l2 = float(np.linalg.norm(got - ref) / (np.linalg.norm(ref) + 1e-30))
    ok = rel_l2 <= tol
    log(f"  [{'ok' if ok else 'FAIL'}] {name}: max_abs={max_abs:.3e} "
        f"rel_l2={rel_l2:.3e} (tol rel_l2 <= {tol:g}; {what})")
    if not ok:
        raise SmokeFailure(
            f"{name}: outside tolerance ({rel_l2:.3e} > {tol:g})")


def timed(fn, *args, n=5):
    """Median wall time (ms) of ``fn(*args)`` to completion, after one
    warm-up call."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return sorted(times)[n // 2] * 1e3


def family_config(arch, depth=None, multimodal=None, dtype="bfloat16",
                  preset="1.5B"):
    """A bench.py family at a factory preset's widths (default "1.5B"):
    "ssm" (the multimodal flagship), "moe" (top-2 of 8 experts) or
    "mha"."""
    from apertis_llm_tpu.config import ApertisConfig
    from apertis_llm_tpu.models.factory import calculate_model_dimensions

    dims = calculate_model_dimensions(preset, 32000,
                                      use_expert_system=(arch == "moe"))
    extra = {}
    if arch == "moe":
        extra = dict(use_expert_system=True, num_experts=8,
                     experts_per_token=2)
    return ApertisConfig(
        vocab_size=32000,
        hidden_size=dims["hidden_size"],
        num_hidden_layers=depth or dims["num_hidden_layers"],
        num_attention_heads=dims["num_attention_heads"],
        intermediate_size=dims["intermediate_size"],
        attention_type="standard_mha" if arch == "mha" else "selective_ssm",
        ssm_d_state=16,
        multimodal=(arch != "mha") if multimodal is None else multimodal,
        hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0,
        max_position_embeddings=4096,
        dtype=dtype,
        param_dtype=dtype,
        **extra,
    )


def init(config, seed=SEED):
    import jax

    from apertis_llm_tpu.models.params import init_params

    return jax.jit(lambda r: init_params(r, config))(jax.random.PRNGKey(seed))


def prompts(config, batch, images):
    import numpy as np

    r = np.random.default_rng(SEED + batch)
    ids = r.integers(4, config.vocab_size, (batch, PROMPT_LEN)).astype(np.int32)
    pixels = None
    if images:
        pixels = r.integers(0, 255, (batch, config.image_size,
                                     config.image_size, 3)).astype(np.uint8)
    return ids, pixels


def to_float32(params):
    import jax
    import jax.numpy as jnp

    return jax.tree.map(lambda x: x.astype(jnp.float32)
                        if jnp.issubdtype(x.dtype, jnp.floating) else x,
                        params)


def plain_last_logits(params, config, ids, pixels, float32=True):
    """Logits of each prompt's last token from the plain forward (XLA only:
    no library kernel). ``float32``: on float32 copies of the weights at
    the highest matmul precision, the reference every serving path is held
    to; otherwise on the weights as given, at default precision."""
    import contextlib

    import jax
    import jax.numpy as jnp

    from apertis_llm_tpu import backend
    from apertis_llm_tpu.models import apertis as model_lib

    if float32:
        params = to_float32(params)

    def fwd(p, i, px):
        return model_lib.forward(p, config, i, pixel_values=px).logits[:, -1]

    precision = (jax.default_matmul_precision("highest") if float32
                 else contextlib.nullcontext())
    with precision, backend.plain_xla():
        out = jax.jit(fwd)(params, jnp.asarray(ids),
                           None if pixels is None else jnp.asarray(pixels))
    return jax.block_until_ready(out)


# Bounds on the plain forward's own error against the float32 forward, at
# the serving precisions (the rounding witness of ``hold``). bf16: every
# layer rounds activations to 8 mantissa bits about ten times, and those
# errors add up over depth to a few per cent of the logits. int8: weights
# round per channel and activations per row at 7 bits, several times the
# bf16 error.
BF16_TOL, INT8_TOL = 5e-2, 0.15
# The engine may err at most this much more than the plain forward at the
# same precision: beyond it, the error is the engine's own.
WITNESS_RATIO = 1.5
# Routed (MoE) families are held row by row, at one layer. Top-2 routing
# is discontinuous: a token whose gates nearly tie takes another expert in
# one program than in the other, and from the second layer on the SSM
# carries that step to every later token of the sequence (at random init
# its state barely decays). At one layer only each row's own token can
# flip; int8 rounding flipped about 5% of them (64 rows, real widths, on
# the CPU). At least this fraction of rows must lie within the tolerance.
ROUTED_MIN_ROWS = 0.9


def rel_errors(got, ref):
    """(relative L2 error, median per-row relative L2 error, max abs)."""
    import numpy as np

    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    g, r = got.reshape(got.shape[0], -1), ref.reshape(ref.shape[0], -1)
    rows = np.linalg.norm(g - r, axis=1) / (np.linalg.norm(r, axis=1) + 1e-30)
    return (float(np.linalg.norm(got - ref) / (np.linalg.norm(ref) + 1e-30)),
            float(np.median(rows)), float(np.max(np.abs(got - ref))), rows)


def hold(name, got, witness, ref, tol, routed):
    """Hold a serving engine's logits ``got`` to the float32 forward
    ``ref`` through a witness: the plain forward on the same weights at the
    same precision. The witness's error is that precision's rounding alone
    and must lie within ``tol``; the engine's may exceed it by at most
    ``WITNESS_RATIO``. Routed families compare median row errors and need
    ``ROUTED_MIN_ROWS`` of the engine's rows within ``tol``."""
    import numpy as np

    if np.shape(got) != np.shape(ref):
        raise SmokeFailure(f"{name}: shape {np.shape(got)} != {np.shape(ref)}")
    if not np.isfinite(np.asarray(got, np.float64)).all():
        raise SmokeFailure(f"{name}: non-finite values")
    e_l2, e_med, e_max, e_rows = rel_errors(got, ref)
    w_l2, w_med, _, _ = rel_errors(witness, ref)
    d_l2 = rel_errors(got, witness)[0]
    e, w = (e_med, w_med) if routed else (e_l2, w_l2)
    stat = "median row rel_l2" if routed else "rel_l2"
    frac = float(np.mean(e_rows <= tol))
    ok = w <= tol and e <= WITNESS_RATIO * w
    rule = (f"{stat}: engine {e:.3e} <= {WITNESS_RATIO:g} x witness "
            f"{w:.3e}, witness <= {tol:g}")
    if routed:
        ok = ok and frac >= ROUTED_MIN_ROWS
        rule += (f", {frac:.3f} of rows within {tol:g} "
                 f"(need >= {ROUTED_MIN_ROWS:g})")
    log(f"  [{'ok' if ok else 'FAIL'}] {name} engine vs float32 forward: "
        f"max_abs={e_max:.3e} rel_l2={e_l2:.3e}; witness (plain forward, "
        f"same weights and precision) rel_l2={w_l2:.3e}; engine vs witness "
        f"rel_l2={d_l2:.3e} ({rule})")
    if not ok:
        raise SmokeFailure(f"{name}: outside tolerance ({rule})")


def serve_family(name, arch, batch, images, new_tokens, depth=None,
                 routed=False, gate_served=True):
    """Build one family at its bench widths (depth cut to ``depth`` if
    given) and hold the serving engine's prefill logits to the float32
    forward on the same weights: a float32 engine tightly (its own error:
    bucketing, padding, the cache, the int8 head), then the served bf16
    and int8 engines through ``hold``. Then an int8 greedy generation of
    ``new_tokens`` (none if 0). With ``gate_served`` False the served
    errors are printed beside their witness and not gated (the routed
    family at full depth, where rounding flips experts; see
    ``routing_sensitivity``)."""
    import jax
    import numpy as np

    from apertis_llm_tpu.inference.engine import InferenceEngine
    from apertis_llm_tpu.models.params import count_params
    from apertis_llm_tpu.models.quantize import quantize_params

    config = family_config(arch, depth=depth)
    t0 = time.perf_counter()
    params = init(config)
    log(f"  {name}: {count_params(params) / 1e9:.3f}B params, "
        f"{config.num_hidden_layers} layers, hidden {config.hidden_size}, "
        f"batch {batch}, images={images} (init {time.perf_counter() - t0:.1f}s)")
    ids, pixels = prompts(config, batch, images)
    ref = plain_last_logits(params, config, ids, pixels)
    # Two float32 programs of the same math differ in summation order only
    # (~1e-6); 1e-3 leaves room for the odd routing near-tie.
    with jax.default_matmul_precision("highest"):
        got = InferenceEngine(config, to_float32(params)).last_token_logits(
            ids, pixels)
    compare(f"{name} float32 engine prefill logits vs float32 forward",
            got, ref, 1e-3, "both float32: the engine's own error")
    del got
    if gate_served:
        hold(f"{name} bf16", InferenceEngine(config, params).last_token_logits(
            ids, pixels), plain_last_logits(params, config, ids, pixels,
                                            float32=False),
             ref, BF16_TOL, routed)
    qparams = jax.jit(quantize_params)(params)
    del params
    eng = InferenceEngine(config, qparams)
    logits = eng.last_token_logits(ids, pixels)
    # The witness runs the engine's own int8 tree (int8 LM head too).
    witness = plain_last_logits(eng.params, config, ids, pixels,
                                float32=False)
    if gate_served:
        hold(f"{name} int8", logits, witness, ref, INT8_TOL, routed)
    else:
        e_l2, e_med = rel_errors(logits, ref)[:2]
        w_l2, w_med = rel_errors(witness, ref)[:2]
        log(f"  {name} int8 engine vs float32 forward (reported): rel_l2="
            f"{e_l2:.3e}, median row {e_med:.3e}; witness (plain forward, "
            f"same int8 tree and precision) rel_l2={w_l2:.3e}, median row "
            f"{w_med:.3e}")
    agree = float(np.mean(np.argmax(np.asarray(logits), -1)
                          == np.argmax(np.asarray(ref), -1)))
    log(f"  {name}: greedy first-token agreement with float32: {agree:.3f}")
    if not new_tokens:
        return
    t0 = time.perf_counter()
    out = eng.generate(ids, pixel_values=pixels, max_new_tokens=new_tokens,
                       eos_token_id=(), do_sample=False,
                       rng=jax.random.PRNGKey(SEED))
    gen_s = time.perf_counter() - t0
    gen = out[:, PROMPT_LEN:]
    if gen.shape != (batch, new_tokens):
        raise SmokeFailure(f"{name}: generated shape {gen.shape}")
    if gen.min() < 0 or gen.max() >= config.vocab_size:
        raise SmokeFailure(f"{name}: token ids out of range")
    # generate's prefill is another compiled program of the same math, so
    # only near-exact ties may flip its first token (any rounding
    # difference, where routing amplifies it).
    first = float(np.mean(gen[:, 0] == np.argmax(np.asarray(logits), -1)))
    need = "reported" if routed else "need >= 0.9"
    log(f"  {name}: int8 generate {batch}x{new_tokens} tokens "
        f"(first call, compile included) {gen_s:.1f}s; first token equals "
        f"the prefill argmax on {first:.3f} of rows ({need})")
    if first < 0.9 and not routed:
        raise SmokeFailure(f"{name}: generate's first tokens disagree with "
                           f"the prefill logits")
    if routed:
        routing_sensitivity(name, config, eng.params, ids, pixels)


def routing_sensitivity(name, config, qparams, ids, pixels, eps=1e-6):
    """How far a routed model's logits move when its inputs move by
    ``eps``: the plain float32 forward on the int8 tree with dynamic int8
    activations, as is and with the token embeddings scaled by
    1 + eps * N(0, 1). A 7-bit activation rounding that flips turns such a
    move into a step of 1/127 of the row's largest value, and an expert
    whose gate nearly ties can flip on it; over many layers a few flips
    change most rows. Printed, not gated: it is what the served routed
    family's error at full depth is compared with."""
    import jax
    import jax.numpy as jnp

    q32 = to_float32(qparams)
    base = plain_last_logits(q32, config, ids, pixels)
    noise = jax.random.normal(jax.random.PRNGKey(SEED + 7),
                              q32["embed"]["tok"].shape)
    moved = dict(q32)
    moved["embed"] = dict(q32["embed"], tok=q32["embed"]["tok"]
                          * (1 + eps * noise.astype(jnp.float32)))
    l2, med = rel_errors(plain_last_logits(moved, config, ids, pixels),
                         base)[:2]
    log(f"  {name}: float32 forward on the int8 tree (dynamic int8 "
        f"activations), token embeddings moved by {eps:g} relative: logits "
        f"move rel_l2={l2:.3e}, median row {med:.3e} (reported)")


def phase_device():
    import jax

    from apertis_llm_tpu.utils.jax_cache import maybe_enable_cache

    cache = maybe_enable_cache()
    devs = jax.devices()
    log(f"jax {jax.__version__}; devices: {len(devs)} x {devs[0].device_kind} "
        f"({devs[0].platform})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"nvidia-smi name, power.limit: {smi}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {cache}")
    return devs


def phase_kernels():
    """cuDNN's fused attention, which ``backend.py`` picks on the
    ``use_flash_attention`` path for 16-bit inputs, against the plain
    softmax attention in float32 at the MHA family's widths (38 heads x
    64): forward and gradient, with its time beside XLA's bf16 attention.
    It is the one library kernel the backend chooses; the rest of the path
    is what XLA compiles."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from apertis_llm_tpu import backend

    def attention(impl):
        return lambda q, k, v: jax.nn.dot_product_attention(
            q, k, v, is_causal=True, implementation=impl)

    def grads(fn):
        return jax.jit(jax.grad(
            lambda q, k, v: jnp.sum(jnp.sin(fn(q, k, v).astype(jnp.float32))),
            argnums=(0, 1, 2)))

    for label, b, l in ATTN_SHAPES:
        impl = backend.fused_attention_implementation(jnp.bfloat16, l)
        if impl != "cudnn":
            raise SmokeFailure(f"attention {label}: backend chose {impl!r}")
        r = np.random.default_rng(b + l)
        q, k, v = (jnp.asarray(r.normal(size=(b, l, ATTN_HEADS, ATTN_DIM)),
                               jnp.bfloat16) for _ in range(3))
        f32 = [x.astype(jnp.float32) for x in (q, k, v)]
        fused, plain = jax.jit(attention(impl)), jax.jit(attention(None))
        with jax.default_matmul_precision("highest"):
            ref = jax.jit(attention(None))(*f32)
            ref_g = grads(attention(None))(*f32)
        # bf16 inputs; cuDNN keeps the scores in float32 and rounds the
        # probabilities to bf16 before the PV product (2^-9 relative per
        # element). The gradients add the softmax Jacobian's cancellation.
        compare(f"cuDNN attention {label} b{b} L{l} forward vs float32",
                fused(q, k, v), ref, 2e-2,
                f"bf16 inputs; XLA bf16 witness rel_l2="
                f"{rel_errors(plain(q, k, v), ref)[0]:.3e}")
        for nm, got, wit, want in zip("qkv", grads(attention(impl))(q, k, v),
                                      grads(attention(None))(q, k, v), ref_g):
            compare(f"cuDNN attention {label} d{nm} vs float32", got, want,
                    5e-2, f"bf16 inputs; XLA bf16 witness rel_l2="
                    f"{rel_errors(wit, want)[0]:.3e}")
        gf, gp = grads(attention(impl)), grads(attention(None))
        log(f"  attention {label} b{b} L{l} bf16: forward cuDNN "
            f"{timed(fused, q, k, v):.3f} ms vs XLA "
            f"{timed(plain, q, k, v):.3f} ms; forward+backward cuDNN "
            f"{timed(gf, q, k, v):.3f} ms vs XLA {timed(gp, q, k, v):.3f} ms")


class _RepeatedBatch:
    """A training set of ``rows`` copies of one batch (the loss must fall)."""

    def __init__(self, ids, rows):
        self.ids, self.rows = ids, rows
        self.max_length = ids.shape[1]

    def __len__(self):
        return self.rows

    def __getitem__(self, i):
        row = self.ids[i % self.ids.shape[0]]
        return {"input_ids": row, "labels": row}


def train_setup(depth, batch, length):
    import numpy as np

    config = family_config("ssm", depth=depth, multimodal=False,
                           dtype="float32")
    ids = np.random.default_rng(SEED + 1).integers(
        4, config.vocab_size, (batch, length)).astype(np.int32)
    return config, init(config), ids


def phase_train(out_dir):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from apertis_llm_tpu import backend
    from apertis_llm_tpu.models import apertis as model_lib
    from apertis_llm_tpu.training.trainer import ApertisTrainer

    batch, length, steps = TRAIN_SHAPE[0], TRAIN_SHAPE[1], 3
    config, params, ids = train_setup(2, batch, length)
    with jax.default_matmul_precision("highest"), backend.plain_xla():
        ref = jax.jit(lambda p, i: model_lib.forward(
            p, config, i, labels=i).loss)(params, jnp.asarray(ids))
    trainer = ApertisTrainer(
        config, params, _RepeatedBatch(ids, batch * steps),
        output_dir=str(out_dir), batch_size=batch, learning_rate=1e-3,
        num_epochs=1, gradient_accumulation_steps=1, bf16=True,
        eval_every_n_epochs=1 << 30, seed=SEED)
    batch_dev = trainer._put_batch({"input_ids": ids, "labels": ids})
    loss0 = trainer._eval_step(trainer.state.params, batch_dev)["loss"]
    # bf16 compute against float32 (tolerance 1e-2 on a ~10.4 loss):
    # activations round to 8 mantissa bits in every layer.
    compare("train loss at step 0 (bf16 trainer) vs float32 forward",
            loss0, ref, 1e-2, "bf16 compute")
    t0 = time.perf_counter()
    history = trainer.train()
    train_s = time.perf_counter() - t0
    loss_after = float(trainer._eval_step(trainer.state.params,
                                          batch_dev)["loss"])
    mean_loss = history["train_loss"][0]
    log(f"  trainer: {steps} steps + saves in {train_s:.1f}s (compile "
        f"included); loss {float(loss0):.4f} at step 0, mean "
        f"{mean_loss:.4f} over the steps, {loss_after:.4f} after")
    if not (np.isfinite(mean_loss) and np.isfinite(loss_after)):
        raise SmokeFailure("training loss is not finite")
    if not loss_after < float(loss0):
        raise SmokeFailure("training loss did not fall on a repeated batch")
    final = Path(out_dir) / "final"
    saved = sorted(p.name for p in final.iterdir())
    if "state" not in saved or "config.json" not in saved:
        raise SmokeFailure(f"checkpoint save incomplete: {saved}")
    log(f"  checkpoint {final.name}/: {saved}")


def phase_multi():
    """Data-parallel training on a (4,1,1,1) mesh vs one card on the same
    global batch; tensor-parallel (1,4,1) serving vs the unsharded engine."""
    import jax
    import numpy as np

    from apertis_llm_tpu.inference.engine import InferenceEngine
    from apertis_llm_tpu.parallel.mesh import create_mesh
    from apertis_llm_tpu.parallel.sharding import shard_params
    from apertis_llm_tpu.training.step import (
        create_train_state, make_optimizer, make_train_step)
    from apertis_llm_tpu.training.trainer import ApertisTrainer

    devs = jax.devices()
    if len(devs) < 4:
        raise SmokeFailure(f"--multi needs 4 devices, found {len(devs)}")

    # DP: the trainer's own compiled step over all four cards.
    batch, length, lr = TRAIN_SHAPE[0], TRAIN_SHAPE[1], 1e-3
    config, params, ids = train_setup(2, batch, length)
    init_p = jax.device_get(params)   # the trainer donates its device copy
    with tempfile.TemporaryDirectory() as tmp:
        trainer = ApertisTrainer(
            config, params, _RepeatedBatch(ids, batch), output_dir=tmp,
            batch_size=batch, learning_rate=lr, num_epochs=1,
            gradient_accumulation_steps=1, bf16=True, seed=SEED,
            mesh_shape=(4, 1, 1, 1))
        state, metrics = trainer._train_step(
            trainer.state, trainer._put_batch({"input_ids": ids,
                                               "labels": ids}))
    dp_params = jax.device_get(state.params)
    one = jax.devices()[0]
    tx, _ = make_optimizer(lr, 1, 0.01, 1.0, 1)
    p1 = jax.device_put(init_p, one)
    st1 = create_train_state(p1, tx, jax.random.PRNGKey(SEED))
    st1, m1 = jax.jit(make_train_step(config, tx, "bfloat16"))(
        st1, jax.device_put({"input_ids": ids, "labels": ids}, one))
    # Both steps compute in bf16; they differ in the order of the gradient
    # sum (all-reduce over 4 cards vs one card).
    compare("DP (4,1,1,1) loss vs one card", metrics["loss"], m1["loss"],
            1e-3, "bf16 compute")
    compare("DP (4,1,1,1) gradient norm vs one card", metrics["grad_norm"],
            m1["grad_norm"], 1e-2, "bf16 compute")
    # Adam's first step moves each weight by about the step's learning rate
    # times sign(grad), so a gradient near zero whose sign differs between
    # summation orders moves its weight the other way: the difference is
    # bounded by about twice the largest single-weight move of the step.
    one_params = jax.device_get(st1.params)
    diff = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
               for a, b in zip(jax.tree.leaves(dp_params),
                               jax.tree.leaves(one_params)))
    moved = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
                for a, b in zip(jax.tree.leaves(one_params),
                                jax.tree.leaves(init_p)))
    verdict = "ok" if diff <= 2.5 * moved else "FAIL"
    log(f"  [{verdict}] DP (4,1,1,1) updated params vs one card: max_abs="
        f"{diff:.3e} (tol max_abs <= 2.5 x the largest move of one weight, "
        f"{moved:.3e})")
    if diff > 2.5 * moved:
        raise SmokeFailure("DP updated params differ from one card's")
    del trainer, state, st1, p1, params

    # TP serving: widths of the 6.7B-class preset (36 heads divide over 4
    # cards), depth cut to 4 layers, float32 weights so that the sharded
    # reduction order cannot flip a greedy token.
    tp_config = family_config("ssm", depth=4, multimodal=False,
                              dtype="float32", preset="6.7B")
    tp_params = jax.device_get(init(tp_config))
    tp_ids, _ = prompts(tp_config, 8, images=False)
    kw = dict(max_new_tokens=16, eos_token_id=(), do_sample=False,
              rng=jax.random.PRNGKey(SEED))
    mesh = create_mesh(devs[:4], (1, 4, 1))
    with jax.default_matmul_precision("highest"):
        want = InferenceEngine(
            tp_config, jax.device_put(tp_params, one)).generate(tp_ids, **kw)
        got = InferenceEngine(tp_config, shard_params(tp_params, mesh),
                              mesh=mesh).generate(tp_ids, **kw)
    same = float(np.mean(np.asarray(got) == np.asarray(want)))
    log(f"  TP (1,4,1) serving, hidden {tp_config.hidden_size}, "
        f"{tp_config.num_attention_heads} heads, 4 layers, b8 x 16 tokens: "
        f"{same:.4f} of tokens equal the unsharded engine's")
    if same != 1.0:
        raise SmokeFailure("TP serving tokens differ from the unsharded engine")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--multi", action="store_true",
                        help="run only the four-card paths (DP training, TP "
                             "serving)")
    args = parser.parse_args()
    if not (REPO / "apertis_llm_tpu" / "__init__.py").is_file():
        print("chip_smoke: the repository is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX finds no GPU (backend "
              f"{jax.default_backend()!r})", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    try:
        log("== phase 1: device")
        devs = phase_device()
        if args.multi:
            log("== four cards: DP training and TP serving")
            phase_multi()
        else:
            log("== phase 2: serving the flagship (SSM, multimodal)")
            serve_family("ssm", "ssm", 256, images=True, new_tokens=32)
            log("== phase 3: serving the other families")
            serve_family("moe", "moe", 256, images=True, new_tokens=16,
                         routed=True, gate_served=False)
            serve_family("moe, 1 layer", "moe", 256, images=True,
                         new_tokens=0, depth=1, routed=True)
            os.environ["APERTIS_QUANT_KV"] = "1"
            try:
                serve_family("mha", "mha", 64, images=False, new_tokens=16)
            finally:
                os.environ.pop("APERTIS_QUANT_KV", None)
            log("== phase 4: cuDNN attention vs the plain reference")
            phase_kernels()
            log("== phase 5: training through ApertisTrainer")
            with tempfile.TemporaryDirectory() as tmp:
                phase_train(tmp)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    log(f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
