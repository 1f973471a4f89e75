"""Train state + compiled train/eval steps.

Optimizer semantics mirror the reference trainer (pipeline.py:469-481):
AdamW with weight decay masked off for biases and norm parameters, OneCycle
cosine LR (pct_start=0.1, div_factor=25, final_div_factor=1e4), global-norm
gradient clipping, optional gradient accumulation (optax.MultiSteps).

Differences from the reference: bf16 compute with float32 master params/optimizer
state (instead of CUDA AMP + GradScaler — bf16 needs no loss scaling),
``jax.checkpoint`` rematerialisation instead of torch checkpointing, and the
whole step is one jitted program whose gradient all-reduce is inserted by
GSPMD from the mesh shardings.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from apertis_llm_tpu.config import ApertisConfig
from apertis_llm_tpu.models import apertis as model_lib

Params = Dict[str, Any]


class TrainState(NamedTuple):
    params: Params
    opt_state: Any
    step: jnp.ndarray
    rng: jax.Array


def _decay_mask(params: Params) -> Params:
    """True where weight decay applies: 2D+ weights that are not norm scales.

    Mirrors the reference's name-based exclusion of biases and LayerNorm
    params (pipeline.py:470-472)."""

    def walk(tree, key):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        is_norm_or_bias = key in ("b", "scale", "ln_w", "ln_b", "A_log", "D",
                                  "w_noise", "cls_token", "pos_embed",
                                  "in_proj_b") or tree.ndim <= 1
        return not is_norm_or_bias

    return walk(params, "")


def make_optimizer(
    learning_rate: float,
    total_steps: int,
    weight_decay: float = 0.01,
    max_grad_norm: float = 1.0,
    gradient_accumulation_steps: int = 1,
    pct_start: float = 0.1,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> Tuple[optax.GradientTransformation, optax.Schedule]:
    # Two-phase cosine OneCycle, exactly torch's anneal_strategy='cos'
    # (cosine ramp initial->peak over pct_start, cosine decay peak->final).
    # Built by hand because optax.cosine_onecycle_schedule divides by a
    # zero-length interval when total_steps * pct_start < 1.
    total = max(total_steps, 1)
    warmup = max(int(total * pct_start), 1)
    initial = learning_rate / 25.0
    final = initial / 10000.0

    def schedule(count):
        count = jnp.asarray(count, jnp.float32)
        up = initial + (learning_rate - initial) * 0.5 * (
            1.0 - jnp.cos(jnp.pi * jnp.minimum(count, warmup) / warmup))
        down_frac = jnp.clip((count - warmup) / jnp.maximum(total - warmup, 1), 0.0, 1.0)
        down = final + (learning_rate - final) * 0.5 * (
            1.0 + jnp.cos(jnp.pi * down_frac))
        return jnp.where(count < warmup, up, down)
    tx = optax.chain(
        optax.clip_by_global_norm(max_grad_norm),
        optax.scale_by_adam(b1=b1, b2=b2, eps=eps),
        optax.add_decayed_weights(weight_decay, mask=_decay_mask),
        optax.scale_by_schedule(schedule),
        optax.scale(-1.0),
    )
    if gradient_accumulation_steps > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=gradient_accumulation_steps)
    return tx, schedule


def create_train_state(
    params: Params,
    tx: optax.GradientTransformation,
    rng: jax.Array,
) -> TrainState:
    return TrainState(params, tx.init(params), jnp.zeros((), jnp.int32), rng)


def loss_fn(
    params: Params,
    config: ApertisConfig,
    batch: Dict[str, jnp.ndarray],
    rng: Optional[jax.Array],
    compute_dtype: Optional[jnp.dtype] = None,
) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    run_params = params
    if compute_dtype is not None and compute_dtype != jnp.float32:
        run_params = jax.tree.map(
            lambda x: x.astype(compute_dtype)
            if jnp.issubdtype(x.dtype, jnp.floating) else x, params)
    out = model_lib.forward(
        run_params, config,
        batch["input_ids"],
        attention_mask=batch.get("attention_mask"),
        pixel_values=batch.get("pixel_values"),
        labels=batch["labels"],
        training=True,
        rng=rng,
    )
    metrics = {"loss": out.loss, "lb_loss": out.lb_loss, "rz_loss": out.rz_loss}
    return out.loss, metrics


def make_train_step(
    config: ApertisConfig,
    tx: optax.GradientTransformation,
    compute_dtype: Optional[str] = None,
):
    """Build the (donated-state) train step; caller jits with shardings."""
    dtype = jnp.dtype(compute_dtype) if compute_dtype else None

    def train_step(state: TrainState, batch: Dict[str, jnp.ndarray]):
        rng, step_rng = jax.random.split(state.rng)
        grad_fn = jax.value_and_grad(loss_fn, has_aux=True)
        (loss, metrics), grads = grad_fn(
            state.params, config, batch, step_rng, dtype)
        grads = jax.tree.map(lambda g: g.astype(jnp.float32), grads)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        metrics = dict(metrics)
        metrics["grad_norm"] = optax.global_norm(grads)
        return TrainState(params, opt_state, state.step + 1, rng), metrics

    return train_step


def make_eval_step(config: ApertisConfig, compute_dtype: Optional[str] = None):
    dtype = jnp.dtype(compute_dtype) if compute_dtype else None

    def eval_step(params: Params, batch: Dict[str, jnp.ndarray]):
        run_params = params
        if dtype is not None and dtype != jnp.float32:
            run_params = jax.tree.map(
                lambda x: x.astype(dtype)
                if jnp.issubdtype(x.dtype, jnp.floating) else x, params)
        out = model_lib.forward(
            run_params, config, batch["input_ids"],
            attention_mask=batch.get("attention_mask"),
            pixel_values=batch.get("pixel_values"),
            labels=batch["labels"], training=False)
        return {"loss": out.loss}

    return eval_step
