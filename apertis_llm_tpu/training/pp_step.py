"""Pipeline-parallel train step: GPipe schedule with an in-stage loss tail.

Wires ``parallel.pipeline``'s schedule into real training:
the trainer's ``pipeline_stages`` knob shards layer DEPTH over the ``model``
mesh axis; each device runs a contiguous block of layers, microbatches flow
stage-to-stage with one ``ppermute`` hop per tick, and the loss is computed
ON the last stage (a single scalar ``psum`` broadcasts it) — not by
broadcasting full activations like the library ``pipeline_apply`` does, so
cross-stage traffic per tick is exactly one microbatch of activations.

MoE aux losses ride the ring alongside the activations. Differentiating
through the schedule reverses the permutes, giving GPipe-with-full-stashing
backward (``jax.checkpoint`` on the layer body when config.remat trades the
stashing for recompute).

The reference has no pipeline parallelism (SURVEY.md §2.8); its counterpart
for multi-device training is DDP only (reference: src/training/
pipeline.py:462-466). Deviation (documented): MoE load-balance/z losses are
computed per microbatch and averaged, where single-program training computes
them over the full batch.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from apertis_llm_tpu.config import ApertisConfig
from apertis_llm_tpu.models import apertis as model_lib
from apertis_llm_tpu.training.step import TrainState

Params = Dict[str, Any]


def _param_specs_for_pp(params: Params, axis: str) -> Params:
    """The decoder layer stack (top-level ``layers``) shards depth over the
    stage axis; everything else — embeddings, lm head, and the vision tower
    (whose own ``vision.layers`` stack is depth-stacked but runs whole on
    every stage) — is replicated. TP width-sharding and PP depth-sharding
    of the same tensors are mutually exclusive by construction."""

    def walk(tree, in_layers):
        if isinstance(tree, dict):
            return {k: walk(v, in_layers) for k, v in tree.items()}
        return P(axis) if in_layers else P()

    return {k: walk(v, k == "layers") for k, v in params.items()}


def shard_params_for_pipeline(params: Params, mesh: Mesh,
                              axis: str = "model") -> Params:
    specs = _param_specs_for_pp(params, axis)
    return jax.device_put(
        params, jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                             is_leaf=lambda x: isinstance(x, P)))


def make_pp_loss_fn(
    config: ApertisConfig,
    mesh: Mesh,
    num_micro: int,
    *,
    stage_axis: str = "model",
    batch_axis: str = "data",
    compute_dtype=None,
):
    """Build loss(params, batch, rng) running the layer stack as GPipe stages.

    Requirements: ``num_hidden_layers % stages == 0`` and global batch
    divisible by ``data_parallel * num_micro``. Multimodal batches are
    supported: the ViT prefix is assembled outside the shard_map and the
    loss tail drops the image positions, matching the single-program
    forward.
    """
    n_stages = mesh.shape[stage_axis]
    if config.num_hidden_layers % n_stages:
        raise ValueError(
            f"num_hidden_layers {config.num_hidden_layers} must divide by "
            f"pipeline stages {n_stages}")
    layers_per_stage = config.num_hidden_layers // n_stages
    is_mha = config.attention_type != "selective_ssm"
    data_par = mesh.shape.get(batch_axis, 1)

    def loss_fn(params: Params, batch: Dict[str, jnp.ndarray],
                rng: Optional[jax.Array]):
        run_params = params
        if compute_dtype is not None and compute_dtype != jnp.float32:
            run_params = jax.tree.map(
                lambda x: x.astype(compute_dtype)
                if jnp.issubdtype(x.dtype, jnp.floating) else x, params)

        ids = batch["input_ids"]
        labels = batch["labels"]
        attention_mask = batch.get("attention_mask")
        pixel_values = batch.get("pixel_values")
        b, l = ids.shape
        if b % num_micro:
            raise ValueError(f"batch {b} must divide by microbatches {num_micro}")
        mb = b // num_micro

        # Multimodal batches pipeline too: the ViT prefix is assembled OUTSIDE
        # the shard_map (autodiff through loss_fn carries the vision grads),
        # stages see the full image+text sequence, and the loss tail slices
        # the image positions off before the lm_head — mirroring the
        # single-program forward (models/apertis.py:651-655; reference:
        # core.py:1399-1408).
        embeds, pos_ids, attention_mask, num_img = model_lib.assemble_inputs(
            run_params, config, ids, attention_mask, None, pixel_values)
        lt = embeds.shape[1]          # num_img + l
        rngs = (jax.random.split(rng, 2) if rng is not None else [None, None])
        h = model_lib._dropout(rngs[0], embeds, config.hidden_dropout_prob, True)

        inp = h.reshape(num_micro, mb, lt, h.shape[-1])
        pos_mb = pos_ids.reshape(num_micro, mb, lt)
        # Labels microbatched the same way so their data-sharded slices line
        # up row-for-row with the pipeline outputs inside the shard_map.
        labels_mb = labels.reshape(num_micro, mb, l)
        bias_mb = None
        if is_mha:
            bias = model_lib._build_bias(attention_mask, lt, 0, jnp.float32)
            bias_mb = bias.reshape(num_micro, mb, 1, lt, lt)
        cos_t, sin_t = model_lib._rope_tables_if_needed(config)

        layer_rng = rngs[1]

        def stage_body(local_layers, tail_params, inp, pos_mb, labels, *rest):
            bias_mb = rest[0] if is_mha else None
            s = jax.lax.axis_index(stage_axis)

            def apply_local(h, lb, rz, mb_idx):
                pos_b = jax.lax.dynamic_index_in_dim(pos_mb, mb_idx, 0, False)
                bias_b = (jax.lax.dynamic_index_in_dim(bias_mb, mb_idx, 0, False)
                          if is_mha else None)

                def scan_fn(carry, xs):
                    h, lb, rz = carry
                    lp, li = xs
                    r = None
                    if layer_rng is not None:
                        r = jax.random.fold_in(
                            jax.random.fold_in(layer_rng, mb_idx),
                            s * layers_per_stage + li)
                    h, _, lb_i, rz_i, _ = model_lib._layer_full(
                        lp, config, h, bias_b, pos_b, cos_t, sin_t,
                        training=True, rng=r, want_cache=False)
                    return (h, lb + lb_i, rz + rz_i), None

                if config.remat:
                    scan_fn = jax.checkpoint(scan_fn)
                (h, lb, rz), _ = jax.lax.scan(
                    scan_fn, (h, lb, rz),
                    (local_layers, jnp.arange(layers_per_stage)))
                return h, lb, rz

            axes = (stage_axis,) if data_par == 1 else (stage_axis, batch_axis)

            def varying(x):
                pcast = getattr(jax.lax, "pcast", None)
                if pcast is not None:
                    return pcast(x, axes, to="varying")
                return jax.lax.pvary(x, axes)

            zeroh = varying(jnp.zeros_like(inp[0]))
            zf = varying(jnp.zeros((), jnp.float32))
            outputs = varying(jnp.zeros_like(inp))
            lb_out = varying(jnp.zeros((num_micro,), jnp.float32))
            rz_out = varying(jnp.zeros((num_micro,), jnp.float32))

            ticks = num_micro + n_stages - 1
            perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]

            def tick(t, carry):
                (h_cur, lb_cur, rz_cur), outputs, lb_out, rz_out = carry
                feed = jnp.clip(t, 0, num_micro - 1)
                h_in = jnp.where(s == 0, inp[feed], h_cur)
                lb_in = jnp.where(s == 0, 0.0, lb_cur)
                rz_in = jnp.where(s == 0, 0.0, rz_cur)
                # Microbatch id this stage works on at tick t.
                mb_idx = jnp.clip(t - s, 0, num_micro - 1)
                y, lb, rz = apply_local(h_in, lb_in, rz_in, mb_idx)
                out_idx = jnp.clip(t - (n_stages - 1), 0, num_micro - 1)
                write = (s == n_stages - 1) & (t >= n_stages - 1)
                outputs = jax.lax.dynamic_update_index_in_dim(
                    outputs, jnp.where(write, y, outputs[out_idx]), out_idx, 0)
                lb_out = jax.lax.dynamic_update_index_in_dim(
                    lb_out, jnp.where(write, lb, lb_out[out_idx]), out_idx, 0)
                rz_out = jax.lax.dynamic_update_index_in_dim(
                    rz_out, jnp.where(write, rz, rz_out[out_idx]), out_idx, 0)
                nxt = jax.tree.map(lambda z: jax.lax.ppermute(z, stage_axis, perm),
                                   (y, lb, rz))
                return nxt, outputs, lb_out, rz_out

            _, outputs, lb_out, rz_out = jax.lax.fori_loop(
                0, ticks, tick, ((zeroh, zf, zf), outputs, lb_out, rz_out))

            # Loss tail ON the last stage; only scalars cross devices. The
            # image prefix (if any) is dropped before the lm_head — norm is
            # per-position so slicing first is equivalent and cheaper.
            h_all = outputs.reshape(-1, lt, outputs.shape[-1])[:, num_img:, :]
            h_all = model_lib._apply_norm(
                tail_params["final_norm"], h_all, config.layer_norm_eps)
            logits = model_lib._lm_head(tail_params, h_all)

            shift_logits = logits[:, :-1, :].astype(jnp.float32)
            shift_labels = labels.reshape(-1, l)[:, 1:]
            valid = shift_labels != -100
            safe = jnp.where(valid, shift_labels, 0)
            logp = jax.nn.log_softmax(shift_logits, axis=-1)
            nll = -jnp.take_along_axis(logp, safe[..., None], axis=-1)[..., 0]
            on_last = (s == n_stages - 1).astype(jnp.float32)
            sum_nll = jnp.sum(jnp.where(valid, nll, 0.0)) * on_last
            count = jnp.sum(valid).astype(jnp.float32) * on_last
            lb = jnp.mean(lb_out) * on_last
            rz = jnp.mean(rz_out) * on_last

            sum_nll = jax.lax.psum(sum_nll, axes)
            count = jax.lax.psum(count, axes)
            lb = jax.lax.psum(lb, axes) / data_par
            rz = jax.lax.psum(rz, axes) / data_par
            ce = sum_nll / jnp.maximum(count, 1.0)
            loss = ce + lb + rz if config.use_expert_system else ce
            return loss, lb, rz

        layer_specs = jax.tree.map(lambda _: P(stage_axis), run_params["layers"])
        tail_params = {k: v for k, v in run_params.items() if k != "layers"}
        tail_specs = jax.tree.map(lambda _: P(), tail_params)
        act_spec = P(None, batch_axis, None, None)
        in_specs = [layer_specs, tail_specs, act_spec,
                    P(None, batch_axis, None), P(None, batch_axis, None)]
        args = [run_params["layers"], tail_params, inp, pos_mb, labels_mb]
        if is_mha:
            in_specs.append(P(None, batch_axis, None, None, None))
            args.append(bias_mb)

        loss, lb, rz = jax.shard_map(
            stage_body, mesh=mesh,
            in_specs=tuple(in_specs),
            out_specs=(P(), P(), P()),
            check_vma=False,
        )(*args)
        return loss, {"loss": loss, "lb_loss": lb, "rz_loss": rz}

    return loss_fn


def make_pp_loss_and_grads_1f1b(
    config: ApertisConfig,
    mesh: Mesh,
    num_micro: int,
    *,
    stage_axis: str = "model",
    batch_axis: str = "data",
    compute_dtype=None,
):
    """1F1B pipeline schedule: loss AND grads in one interleaved pass.

    GPipe (``make_pp_loss_fn`` + autodiff) stashes one residual set per tick
    — O(num_micro) microbatch activations live until the backward sweep.
    1F1B interleaves each microbatch's backward as soon as its forward
    clears the last stage, so the live stash is a ring of at most
    ``2 * n_stages`` stage INPUTS per stage (independent of num_micro); the
    backward recomputes the stage body from the stashed input (remat-style
    ``jax.vjp``), trading one extra forward per microbatch per stage.

    Schedule (tick t, stage s, S stages, M microbatches, one fwd unit and
    one bwd unit per tick):
      * forward of microbatch f at stage s fires at  t = s + f
      * backward of microbatch b at stage s fires at t = (2S - 2 - s) + b
    so activations and cotangents each ride one ``ppermute`` hop per tick
    (down for y, up for dx), and the last stage turns a microbatch around
    in the same tick (fwd -> loss tail -> its own bwd).

    Exactness: the cross-entropy is normalised by the GLOBAL valid-token
    count (computed from labels before the loop), so gradients match the
    single-program loss exactly; MoE lb/z losses are per-microbatch means
    as in the GPipe path. Deviation (documented): embedding/hidden dropout
    masks are folded per microbatch, so with dropout > 0 the sampled masks
    differ from the GPipe path (both are valid dropout draws).

    Multimodal batches pipeline too: the ViT prefix is computed OUTSIDE the
    shard_map under an explicit ``jax.vjp``; stage 0 concatenates each
    microbatch's prefix slice ahead of the token embeddings, the loss tail
    drops the image positions, and the backward accumulates the prefix
    cotangent per microbatch, which feeds the vision-tower vjp after the
    pipeline loop (mirroring single-program training,
    models/apertis.py:637-654).

    Returns ``fn(params, batch, rng) -> (loss, metrics, grads)``.
    """
    n_stages = mesh.shape[stage_axis]
    if config.num_hidden_layers % n_stages:
        raise ValueError(
            f"num_hidden_layers {config.num_hidden_layers} must divide by "
            f"pipeline stages {n_stages}")
    layers_per_stage = config.num_hidden_layers // n_stages
    is_mha = config.attention_type != "selective_ssm"
    data_par = mesh.shape.get(batch_axis, 1)
    eps = config.layer_norm_eps
    moe = bool(config.use_expert_system)

    def fn(params: Params, batch: Dict[str, jnp.ndarray],
           rng: Optional[jax.Array]):
        run_params = params
        if compute_dtype is not None and compute_dtype != jnp.float32:
            run_params = jax.tree.map(
                lambda x: x.astype(compute_dtype)
                if jnp.issubdtype(x.dtype, jnp.floating) else x, params)

        ids = batch["input_ids"]
        labels = batch["labels"]
        attention_mask = batch.get("attention_mask")
        pixel_values = batch.get("pixel_values")
        if attention_mask is None:
            attention_mask = jnp.ones_like(ids)
        b, l = ids.shape
        if b % num_micro:
            raise ValueError(f"batch {b} must divide by microbatches {num_micro}")
        mb = b // num_micro
        M, S = num_micro, n_stages
        R = 2 * S                      # stash ring depth (in-flight bound)
        ticks = M + 2 * S - 1

        rngs = (jax.random.split(rng, 2) if rng is not None else [None, None])
        emb_rng, layer_rng = rngs[0], rngs[1]
        h_dtype = (compute_dtype if compute_dtype is not None
                   else params["embed"]["tok"].dtype)

        # Vision prefix under an explicit vjp (the hand-assembled backward
        # returns its cotangent, which drives the vision grads after the
        # pipeline loop).
        mm = config.multimodal and pixel_values is not None
        prefix = vis_vjp = None
        num_img = 0
        if mm:
            from apertis_llm_tpu.models.vit import (preprocess_images,
                                                    vit_encode)

            pv = pixel_values
            if pv.dtype == jnp.uint8 or pv.shape[-1] == 3:
                pv = preprocess_images(pv, config.image_size)

            def vis_fwd(vp):
                img = vit_encode(vp["vision"], config, pv)
                if "vision_proj" in vp:
                    img = model_lib._linear(vp["vision_proj"], img)
                return img.astype(h_dtype)

            vis_keys = [k for k in ("vision", "vision_proj")
                        if k in run_params]
            prefix, vis_vjp = jax.vjp(
                vis_fwd, {k: run_params[k] for k in vis_keys})
            num_img = prefix.shape[1]
        lt = num_img + l

        # Full-sequence positions: image prefix 0..num_img-1, text shifted
        # (matches assemble_inputs, models/apertis.py:650-652).
        pos_ids = jnp.broadcast_to(
            jnp.arange(lt, dtype=jnp.int32)[None, :], (b, lt))
        ids_mb = ids.reshape(M, mb, l)
        pos_mb = pos_ids.reshape(M, mb, lt)
        labels_mb = labels.reshape(M, mb, l)
        prefix_mb = (prefix.reshape(M, mb, num_img, prefix.shape[-1])
                     if mm else None)
        bias_mb = None
        if is_mha:
            full_mask = (jnp.concatenate(
                [jnp.ones((b, num_img), attention_mask.dtype),
                 attention_mask], axis=1) if mm else attention_mask)
            bias = model_lib._build_bias(full_mask, lt, 0, jnp.float32)
            bias_mb = bias.reshape(M, mb, 1, lt, lt)
        cos_t, sin_t = model_lib._rope_tables_if_needed(config)
        # Global CE normaliser, known before any pipeline work.
        total_count = jnp.maximum(
            jnp.sum((labels[:, 1:] != -100).astype(jnp.float32)), 1.0)

        def stage_body(local_layers, tail_params, ids_mb, pos_mb, labels_mb,
                       total_count, *rest):
            rest = list(rest)
            bias_mb = rest.pop(0) if is_mha else None
            prefix_mb = rest.pop(0) if mm else None
            s = jax.lax.axis_index(stage_axis)
            is_first = s == 0
            is_last = s == S - 1
            mb_local = ids_mb.shape[1]   # per-data-shard microbatch rows

            def pre_fn(tp, prefix_1, ids_1, pos_1, mb_idx):
                e = jnp.take(tp["embed"]["tok"], ids_1, axis=0)
                if mm:
                    e = jnp.concatenate(
                        [prefix_1, e.astype(h_dtype)], axis=1)
                if (config.position_embedding_type == "absolute"
                        and "abs_pos" in tp):
                    e = e + jnp.take(tp["abs_pos"]["emb"], pos_1, axis=0)
                r = (jax.random.fold_in(emb_rng, mb_idx)
                     if emb_rng is not None else None)
                return model_lib._dropout(
                    r, e.astype(h_dtype), config.hidden_dropout_prob, True)

            def local_fwd(Lp, h, mb_idx, pos_1, bias_1):
                def scan_fn(carry, xs):
                    h, lb, rz = carry
                    lp, li = xs
                    r = None
                    if layer_rng is not None:
                        r = jax.random.fold_in(
                            jax.random.fold_in(layer_rng, mb_idx),
                            s * layers_per_stage + li)
                    h, _, lb_i, rz_i, _ = model_lib._layer_full(
                        lp, config, h, bias_1, pos_1, cos_t, sin_t,
                        training=True, rng=r, want_cache=False)
                    return (h, lb + lb_i, rz + rz_i), None

                zf = jnp.zeros((), jnp.float32)
                (h, lb, rz), _ = jax.lax.scan(
                    scan_fn, (h, zf, zf),
                    (Lp, jnp.arange(layers_per_stage)))
                return h, lb, rz

            def tail_sum_nll(tp, y, labels_1):
                # Image positions carry no labels — slice them off before
                # the lm_head (norm is per-position, so slicing first is
                # equivalent and cheaper; mirrors the GPipe tail).
                hn = model_lib._apply_norm(tp["final_norm"],
                                           y[:, num_img:, :], eps)
                logits = model_lib._lm_head(tp, hn)
                shift_logits = logits[:, :-1, :].astype(jnp.float32)
                shift_labels = labels_1[:, 1:]
                valid = shift_labels != -100
                safe = jnp.where(valid, shift_labels, 0)
                logp = jax.nn.log_softmax(shift_logits, axis=-1)
                nll = -jnp.take_along_axis(logp, safe[..., None], -1)[..., 0]
                return jnp.sum(jnp.where(valid, nll, 0.0))

            axes = ((stage_axis,) if data_par == 1
                    else (stage_axis, batch_axis))

            def varying(x):
                pcast = getattr(jax.lax, "pcast", None)
                if pcast is not None:
                    return pcast(x, axes, to="varying")
                return jax.lax.pvary(x, axes)

            hidden = tail_params["embed"]["tok"].shape[-1]
            zero_h = jnp.zeros((mb_local, lt, hidden), h_dtype)
            zeros_f32 = jnp.zeros((), jnp.float32)
            carry0 = dict(
                h_recv=varying(zero_h),
                g_recv=varying(zero_h),
                stash=varying(jnp.zeros((R, mb_local, lt, hidden), h_dtype)),
                loss=varying(zeros_f32),
                lb=varying(zeros_f32),
                rz=varying(zeros_f32),
                dlayers=varying(jax.tree.map(
                    lambda x: jnp.zeros(x.shape, jnp.float32), local_layers)),
                dtail=varying(jax.tree.map(
                    lambda x: jnp.zeros(x.shape, jnp.float32), tail_params)),
            )
            if mm:
                # Per-microbatch vision-prefix cotangents (filled by stage
                # 0's backward, zero elsewhere).
                carry0["dprefix"] = varying(
                    jnp.zeros((M, mb_local, num_img, hidden), jnp.float32))
            perm_down = [(i, (i + 1) % S) for i in range(S)]
            perm_up = [(i, (i - 1) % S) for i in range(S)]

            def tick(t, carry):
                f = jnp.clip(t - s, 0, M - 1)
                fwd_on = (t >= s) & (t < s + M)
                b_ = jnp.clip(t - (2 * S - 2 - s), 0, M - 1)
                bwd_on = (t >= 2 * S - 2 - s) & (t < 2 * S - 2 - s + M)

                ids_f = jax.lax.dynamic_index_in_dim(ids_mb, f, 0, False)
                pos_f = jax.lax.dynamic_index_in_dim(pos_mb, f, 0, False)
                lab_f = jax.lax.dynamic_index_in_dim(labels_mb, f, 0, False)
                bias_f = (jax.lax.dynamic_index_in_dim(bias_mb, f, 0, False)
                          if is_mha else None)
                pre_f = (jax.lax.dynamic_index_in_dim(prefix_mb, f, 0, False)
                         if mm else None)

                # ---- forward unit (microbatch f) ----
                h_emb = pre_fn(tail_params, pre_f, ids_f, pos_f, f)
                h_in = jnp.where(is_first, h_emb, carry["h_recv"])
                y, lb_f, rz_f = local_fwd(local_layers, h_in, f, pos_f, bias_f)
                slot = jnp.remainder(f, R)
                stash = jax.lax.dynamic_update_index_in_dim(
                    carry["stash"],
                    jnp.where(fwd_on, h_in, carry["stash"][slot]), slot, 0)
                lb_acc = carry["lb"] + jnp.where(fwd_on, lb_f, 0.0)
                rz_acc = carry["rz"] + jnp.where(fwd_on, rz_f, 0.0)

                # Loss tail on the last stage; cotangent masked so the vjp
                # contributes exactly when (is_last & fwd_on).
                sum_nll, tail_vjp = jax.vjp(
                    lambda tp, yy: tail_sum_nll(tp, yy, lab_f),
                    tail_params, y)
                ct = jnp.where(is_last & fwd_on, 1.0 / total_count, 0.0)
                dtail_mb, dy = tail_vjp(ct)
                loss_acc = carry["loss"] + jnp.where(
                    is_last & fwd_on, sum_nll, 0.0)

                # ---- backward unit (microbatch b_) ----
                pos_b = jax.lax.dynamic_index_in_dim(pos_mb, b_, 0, False)
                bias_b = (jax.lax.dynamic_index_in_dim(bias_mb, b_, 0, False)
                          if is_mha else None)
                h_b = stash[jnp.remainder(b_, R)]
                g_in = jnp.where(is_last, dy, carry["g_recv"])
                g_eff = jnp.where(bwd_on, g_in, jnp.zeros_like(g_in))
                aux_ct = jnp.where(
                    bwd_on & jnp.asarray(moe), 1.0 / (M * data_par), 0.0)
                _, f_vjp = jax.vjp(
                    lambda Lp, hh: local_fwd(Lp, hh, b_, pos_b, bias_b),
                    local_layers, h_b)
                dlayers_mb, dh = f_vjp((g_eff, aux_ct, aux_ct))
                dlayers = jax.tree.map(
                    lambda a, g: a + g.astype(jnp.float32),
                    carry["dlayers"], dlayers_mb)

                # Stage 0 feeds its input cotangent into the embedding (and,
                # multimodal, vision-prefix) vjp.
                ids_b = jax.lax.dynamic_index_in_dim(ids_mb, b_, 0, False)
                dh_emb = jnp.where(is_first, dh, jnp.zeros_like(dh))
                out_extra = {}
                if mm:
                    pre_b = jax.lax.dynamic_index_in_dim(
                        prefix_mb, b_, 0, False)
                    _, pre_vjp = jax.vjp(
                        lambda tp, pf: pre_fn(tp, pf, ids_b, pos_b, b_),
                        tail_params, pre_b)
                    dtail_emb, dpre_b = pre_vjp(dh_emb)
                    dprefix = carry["dprefix"]
                    dpre_cur = jax.lax.dynamic_index_in_dim(
                        dprefix, b_, 0, False)
                    out_extra["dprefix"] = jax.lax.dynamic_update_index_in_dim(
                        dprefix,
                        jnp.where(bwd_on, dpre_b.astype(jnp.float32),
                                  dpre_cur), b_, 0)
                else:
                    _, pre_vjp = jax.vjp(
                        lambda tp: pre_fn(tp, None, ids_b, pos_b, b_),
                        tail_params)
                    (dtail_emb,) = pre_vjp(dh_emb)
                dtail = jax.tree.map(
                    lambda a, g1, g2: a + g1.astype(jnp.float32)
                    + g2.astype(jnp.float32),
                    carry["dtail"], dtail_mb, dtail_emb)

                h_next = jax.lax.ppermute(y, stage_axis, perm_down)
                g_next = jax.lax.ppermute(dh, stage_axis, perm_up)
                return dict(h_recv=h_next, g_recv=g_next, stash=stash,
                            loss=loss_acc, lb=lb_acc, rz=rz_acc,
                            dlayers=dlayers, dtail=dtail, **out_extra)

            out = jax.lax.fori_loop(0, ticks, tick, carry0)

            ce = jax.lax.psum(out["loss"], axes) / total_count
            lb = jax.lax.psum(out["lb"], axes) / (M * data_par)
            rz = jax.lax.psum(out["rz"], axes) / (M * data_par)
            loss = ce + lb + rz if moe else ce
            # Layer grads live sharded on the stage axis (summed over data);
            # tail/embed grads are contributed by specific stages -> psum.
            dlayers = (jax.tree.map(
                lambda g: jax.lax.psum(g, batch_axis), out["dlayers"])
                if data_par > 1 else out["dlayers"])
            dtail = jax.tree.map(lambda g: jax.lax.psum(g, axes), out["dtail"])
            if mm:
                # Only stage 0 wrote real cotangents (zeros elsewhere); rows
                # stay data-sharded, so psum over the stage axis only.
                dprefix = jax.lax.psum(out["dprefix"], stage_axis)
                return loss, lb, rz, dlayers, dtail, dprefix
            return loss, lb, rz, dlayers, dtail

        layer_specs = jax.tree.map(lambda _: P(stage_axis),
                                   run_params["layers"])
        # The vision tower never runs inside the stages (its vjp lives
        # outside) — keep it out of the shard_map so no per-tick zero-grad
        # buffers are carried for it.
        skip = {"layers"} | (set(vis_keys) if mm else set())
        tail_params = {k: v for k, v in run_params.items() if k not in skip}
        tail_specs = jax.tree.map(lambda _: P(), tail_params)
        mb_spec = P(None, batch_axis, None)
        in_specs = [layer_specs, tail_specs, mb_spec, mb_spec, mb_spec, P()]
        args = [run_params["layers"], tail_params, ids_mb, pos_mb, labels_mb,
                total_count]
        if is_mha:
            in_specs.append(P(None, batch_axis, None, None, None))
            args.append(bias_mb)
        out_specs = [P(), P(), P(),
                     jax.tree.map(lambda _: P(stage_axis),
                                  run_params["layers"]),
                     jax.tree.map(lambda _: P(), tail_params)]
        if mm:
            in_specs.append(P(None, batch_axis, None, None))
            args.append(prefix_mb)
            out_specs.append(P(None, batch_axis, None, None))

        out = jax.shard_map(
            stage_body, mesh=mesh,
            in_specs=tuple(in_specs),
            out_specs=tuple(out_specs),
            check_vma=False,
        )(*args)
        loss, lb, rz, dlayers, dtail = out[:5]
        grads = dict(dtail)
        grads["layers"] = dlayers
        if mm:
            # Feed the accumulated prefix cotangent through the vision vjp.
            dprefix = out[5].reshape(b, num_img, -1).astype(prefix.dtype)
            (dvis,) = vis_vjp(dprefix)
            grads.update(jax.tree.map(
                lambda g: g.astype(jnp.float32), dvis))
        # Match the params tree exactly.
        grads = {k: grads[k] for k in params.keys()}
        metrics = {"loss": loss, "lb_loss": lb, "rz_loss": rz}
        return loss, metrics, grads

    return fn


def make_pp_train_step(
    config: ApertisConfig,
    tx: optax.GradientTransformation,
    mesh: Mesh,
    num_micro: int,
    compute_dtype: Optional[str] = None,
    stage_axis: str = "model",
    batch_axis: str = "data",
    schedule: str = "gpipe",
):
    """Pipeline-parallel train step. ``schedule``: "gpipe" (forward schedule
    + autodiff backward, stash O(num_micro)) or "1f1b" (interleaved
    fwd/bwd, stash O(n_stages), backward recomputes stage bodies)."""
    dtype = jnp.dtype(compute_dtype) if compute_dtype else None
    if schedule == "1f1b":
        lg_fn = make_pp_loss_and_grads_1f1b(
            config, mesh, num_micro, stage_axis=stage_axis,
            batch_axis=batch_axis, compute_dtype=dtype)

        def train_step(state: TrainState, batch: Dict[str, jnp.ndarray]):
            rng, step_rng = jax.random.split(state.rng)
            loss, metrics, grads = lg_fn(state.params, batch, step_rng)
            grads = jax.tree.map(lambda g: g.astype(jnp.float32), grads)
            updates, opt_state = tx.update(grads, state.opt_state,
                                           state.params)
            params = optax.apply_updates(state.params, updates)
            metrics = dict(metrics)
            metrics["grad_norm"] = optax.global_norm(grads)
            return TrainState(params, opt_state, state.step + 1, rng), metrics

        return train_step
    if schedule != "gpipe":
        raise ValueError(f"Unknown pipeline schedule: {schedule!r}")
    loss_fn = make_pp_loss_fn(config, mesh, num_micro, stage_axis=stage_axis,
                              batch_axis=batch_axis, compute_dtype=dtype)

    def train_step(state: TrainState, batch: Dict[str, jnp.ndarray]):
        rng, step_rng = jax.random.split(state.rng)
        grad_fn = jax.value_and_grad(loss_fn, has_aux=True)
        (loss, metrics), grads = grad_fn(state.params, batch, step_rng)
        grads = jax.tree.map(lambda g: g.astype(jnp.float32), grads)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        metrics = dict(metrics)
        metrics["grad_norm"] = optax.global_norm(grads)
        return TrainState(params, opt_state, state.step + 1, rng), metrics

    return train_step


def make_pp_eval_step(
    config: ApertisConfig,
    mesh: Mesh,
    num_micro: int,
    compute_dtype: Optional[str] = None,
    stage_axis: str = "model",
    batch_axis: str = "data",
):
    dtype = jnp.dtype(compute_dtype) if compute_dtype else None
    loss_fn = make_pp_loss_fn(config, mesh, num_micro, stage_axis=stage_axis,
                              batch_axis=batch_axis, compute_dtype=dtype)

    def eval_step(params: Params, batch: Dict[str, jnp.ndarray]):
        loss, metrics = loss_fn(params, batch, None)
        return {"loss": metrics["loss"]}

    return eval_step
