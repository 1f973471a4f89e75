"""ApertisTrainer: the full training loop on a device mesh.

Mirrors the reference trainer's capability surface (reference:
src/training/pipeline.py:387-698): AdamW + OneCycle cosine, gradient
accumulation and clipping, periodic/epoch/best-val/final checkpointing,
wandb logging (optional), cooperative stop_event cancellation, eval loop.

JAX replacements:
  * DDP/DataParallel/DistributedSampler -> one (data, model, expert) mesh;
    the jitted train step's gradient all-reduce is inserted by GSPMD.
  * CUDA AMP fp16 + GradScaler -> bf16 compute, float32 master params
    (no loss scaling needed).
  * torch checkpointing -> ``jax.checkpoint`` rematerialisation
    (config.remat).
  * OOM-adaptive dynamic batch halving -> static shapes by construction;
    the flag is accepted and logged as a no-op (documented deviation).
  * Checkpoints carry full train state (numpy) plus reference-compatible
    weights.
"""

from __future__ import annotations

import logging
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from apertis_llm_tpu.config import ApertisConfig
from apertis_llm_tpu.models.params import count_params
from apertis_llm_tpu.parallel.mesh import create_mesh
from apertis_llm_tpu.parallel.sharding import check_divisibility, shard_params
from apertis_llm_tpu.training.datasets import BatchLoader
from apertis_llm_tpu.training.step import (
    create_train_state, make_eval_step, make_optimizer, make_train_step)
from apertis_llm_tpu.utils.checkpoint import save_checkpoint

logger = logging.getLogger(__name__)


class ApertisTrainer:
    def __init__(
        self,
        config: ApertisConfig,
        params: Dict[str, Any],
        train_dataset,
        val_dataset=None,
        output_dir: str = "output",
        batch_size: int = 4,
        learning_rate: float = 5e-5,
        weight_decay: float = 0.01,
        num_epochs: int = 3,
        warmup_steps: int = 0,
        gradient_accumulation_steps: int = 4,
        max_grad_norm: float = 1.0,
        use_wandb: bool = False,
        wandb_project: str = "apertis",
        wandb_run_name: Optional[str] = None,
        bf16: bool = True,
        checkpoint_steps: int = 0,
        iteration_checkpoint_steps: int = 0,
        use_gradient_checkpointing: bool = True,
        eval_every_n_epochs: int = 1,
        dynamic_batch_sizing: bool = True,
        mesh_shape=None,
        stop_event: Optional[threading.Event] = None,
        is_fine_tuning: bool = False,
        tokenizer_path_to_save: Optional[str] = None,
        seed: int = 0,
        resume_from: Optional[str] = None,
        profile_dir: Optional[str] = None,
        profile_steps: Tuple[int, int] = (10, 15),
        pipeline_stages: int = 0,
        pipeline_microbatches: int = 0,
        pipeline_schedule: str = "gpipe",
    ):
        self.config = config.replace(remat=use_gradient_checkpointing)
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.output_dir = Path(output_dir)
        self.batch_size = batch_size
        self.num_epochs = num_epochs
        self.gradient_accumulation_steps = max(1, gradient_accumulation_steps)
        self.eval_every_n_epochs = max(1, eval_every_n_epochs)
        self.checkpoint_steps = checkpoint_steps
        self.iteration_checkpoint_steps = iteration_checkpoint_steps
        self.stop_event = stop_event or threading.Event()
        self.is_fine_tuning = is_fine_tuning
        self.tokenizer_path_to_save = tokenizer_path_to_save
        self.use_wandb = use_wandb
        self.compute_dtype = "bfloat16" if bf16 else None
        self.profile_dir = profile_dir
        self.profile_steps = profile_steps

        if dynamic_batch_sizing:
            logger.info("dynamic_batch_sizing requested: static-shape XLA "
                        "programs cannot OOM mid-epoch; flag is a no-op here.")

        # Mesh: default all devices on the data axis. A 4th mesh_shape entry
        # enables sequence/context parallelism (activations shard L over the
        # `seq` axis; SSM scan + ring attention route through shard_maps).
        # pipeline_stages > 1 repurposes the `model` axis as the GPipe stage
        # axis (layer depth sharded instead of widths; training/pp_step.py).
        devices = jax.devices()
        self.pipeline_stages = max(0, int(pipeline_stages))
        self.pipeline_schedule = pipeline_schedule or "gpipe"
        if self.pipeline_stages > 1:
            if mesh_shape is None:
                if len(devices) % self.pipeline_stages:
                    raise ValueError(
                        f"{len(devices)} devices not divisible by "
                        f"pipeline_stages {self.pipeline_stages}")
                mesh_shape = (len(devices) // self.pipeline_stages,
                              self.pipeline_stages, 1, 1)
            elif tuple(mesh_shape)[1] != self.pipeline_stages:
                raise ValueError(
                    f"mesh_shape model axis {tuple(mesh_shape)[1]} must equal "
                    f"pipeline_stages {self.pipeline_stages}")
        if mesh_shape is None:
            mesh_shape = (len(devices), 1, 1, 1)
        self.mesh = create_mesh(devices, tuple(mesh_shape))
        if self.pipeline_stages > 1:
            # Depth (not width) shards over `model`; pp_step validates
            # layers-per-stage divisibility.
            if self.config.num_hidden_layers % self.pipeline_stages:
                raise ValueError(
                    f"num_hidden_layers {self.config.num_hidden_layers} must "
                    f"divide by pipeline_stages {self.pipeline_stages}")
        else:
            check_divisibility(self.config, self.mesh)
        data_par = self.mesh.shape["data"]
        if batch_size % data_par:
            raise ValueError(
                f"batch_size {batch_size} must divide by data-parallel size {data_par}")
        self.seq_par = self.mesh.shape.get("seq", 1)
        if self.seq_par > 1 and self.pipeline_stages > 1:
            raise ValueError(
                "sequence parallelism and pipeline parallelism cannot be "
                "combined yet: pick a seq axis OR pipeline_stages")
        if self.seq_par > 1:
            max_len = getattr(train_dataset, "max_length", 0)
            if max_len and max_len % self.seq_par:
                raise ValueError(
                    f"max_length {max_len} must divide by sequence-parallel "
                    f"size {self.seq_par}")

        self.train_loader = BatchLoader(
            train_dataset, batch_size, shuffle=True, drop_last=True, seed=seed)
        self.val_loader = (BatchLoader(val_dataset, batch_size, shuffle=False,
                                       drop_last=False, seed=seed)
                           if val_dataset is not None else None)

        steps_per_epoch = max(
            1, -(-len(self.train_loader) // self.gradient_accumulation_steps))
        total_steps = steps_per_epoch * num_epochs
        self.tx, self.schedule = make_optimizer(
            learning_rate, total_steps, weight_decay, max_grad_norm,
            self.gradient_accumulation_steps)

        fp_params = jax.tree.map(
            lambda x: x.astype(jnp.float32)
            if jnp.issubdtype(x.dtype, jnp.floating) else x, params)
        if self.pipeline_stages > 1:
            from apertis_llm_tpu.training.pp_step import shard_params_for_pipeline

            sharded = shard_params_for_pipeline(fp_params, self.mesh)
        else:
            sharded = shard_params(fp_params, self.mesh)
        self.state = create_train_state(sharded, self.tx, jax.random.PRNGKey(seed))
        if resume_from:
            from apertis_llm_tpu.utils.checkpoint import restore_train_state

            logger.info("Resuming full train state from %s", resume_from)
            restored = restore_train_state(resume_from, self.state)

            # Re-place restored arrays with the freshly-initialised state's
            # shardings (orbax restores to single-device arrays by default);
            # leaves without a mesh sharding (optimizer counters, rng) are
            # replicated across the mesh.
            def _place(r, t):
                s = t.sharding
                if not isinstance(s, NamedSharding):
                    s = NamedSharding(self.mesh, P())
                return jax.device_put(r, s)

            self.state = jax.tree.map(_place, restored, self.state)

        if self.pipeline_stages > 1:
            from apertis_llm_tpu.training.pp_step import (
                make_pp_eval_step, make_pp_train_step)

            num_micro = pipeline_microbatches or self.pipeline_stages
            if batch_size % (num_micro * data_par):
                raise ValueError(
                    f"batch_size {batch_size} must divide by microbatches x "
                    f"data parallel = {num_micro * data_par}")
            train_step = make_pp_train_step(
                self.config, self.tx, self.mesh, num_micro, self.compute_dtype,
                schedule=self.pipeline_schedule)
            eval_step = make_pp_eval_step(
                self.config, self.mesh, num_micro, self.compute_dtype)
        else:
            train_step = make_train_step(self.config, self.tx, self.compute_dtype)
            eval_step = make_eval_step(self.config, self.compute_dtype)

        # Expert parallelism: with an expert axis and a MoE model, batches
        # also shard over `expert` (extra data parallelism for non-MoE
        # compute) and dispatch runs the explicit all-to-all (ops/moe_ep.py).
        self.expert_par = self.mesh.shape.get("expert", 1)
        use_ep = (self.expert_par > 1 and self.config.use_expert_system
                  and self.pipeline_stages <= 1)
        if use_ep and batch_size % (data_par * self.expert_par):
            raise ValueError(
                f"batch_size {batch_size} must divide by data x expert "
                f"parallel = {data_par * self.expert_par}")
        if self.seq_par > 1 or use_ep or self.mesh.size > 1:
            # Enter the parallel context INSIDE the jitted fns so it is
            # active at trace time and the model routes through the
            # sequence-sharded scan / ring attention / EP all-to-all
            # (parallel/context.py), and single-device kernels stand down
            # under any multi-device mesh.
            from apertis_llm_tpu.parallel.context import parallel_context

            mesh = self.mesh
            ep_axis = "expert" if use_ep else None
            base_train, base_eval = train_step, eval_step

            def train_step(state, batch):
                with parallel_context(mesh, sp_axis="seq", batch_axis="data",
                                      ep_axis=ep_axis):
                    return base_train(state, batch)

            def eval_step(params, batch):
                with parallel_context(mesh, sp_axis="seq", batch_axis="data",
                                      ep_axis=ep_axis):
                    return base_eval(params, batch)

        self._train_step = jax.jit(train_step, donate_argnums=(0,))
        self._eval_step = jax.jit(eval_step)
        batch_spec = P(("data", "expert")) if use_ep else P("data")
        self._batch_sharding = NamedSharding(self.mesh, batch_spec)

        if self.use_wandb:
            try:
                import wandb

                wandb.init(project=wandb_project, name=wandb_run_name,
                           config={"batch_size": batch_size,
                                   "learning_rate": learning_rate,
                                   "model_config": self.config.to_dict()})
                self._wandb = wandb
            except ImportError:
                logger.warning("wandb not installed; disabling wandb logging.")
                self.use_wandb = False
                self._wandb = None
        else:
            self._wandb = None

    # ------------------------------------------------------------------
    def _put_batch(self, batch: Dict[str, np.ndarray]):
        if jax.process_count() > 1:
            # Multi-host: every process loads the full global batch (the
            # loader is deterministic across hosts), and each device picks
            # its shard out of it.
            return {
                k: jax.make_array_from_callback(
                    v.shape, self._batch_sharding, lambda idx, v=v: v[idx])
                for k, v in batch.items()
            }
        return jax.device_put(batch, self._batch_sharding)

    def save_checkpoint(self, name: str, full_state: bool = True) -> None:
        save_checkpoint(self.output_dir / name, self.state, self.config,
                        tokenizer_src=self.tokenizer_path_to_save,
                        full_state=full_state)

    def evaluate(self) -> Optional[float]:
        if self.val_loader is None:
            return None
        losses, counts = [], []
        for batch in self.val_loader:
            n = batch["input_ids"].shape[0]
            pad = -n % self.batch_size
            if pad:
                batch = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                         for k, v in batch.items()}
            metrics = self._eval_step(self.state.params, self._put_batch(batch))
            losses.append(float(metrics["loss"]))
            counts.append(n)
        if not losses:
            return None
        return float(np.average(losses, weights=counts))

    def train(self) -> Dict[str, Any]:
        logger.info("Starting %s on mesh %s",
                    "fine-tuning" if self.is_fine_tuning else "pre-training",
                    dict(self.mesh.shape))
        best_val = float("inf")
        global_step = 0
        history: Dict[str, Any] = {"train_loss": [], "val_loss": []}

        from apertis_llm_tpu.utils.profiling import (StepTimer,
                                                      device_peak_tflops,
                                                      trace)

        timer = StepTimer()
        profiling = False
        tokens_per_step = self.batch_size * getattr(
            self.train_dataset, "max_length", 0)
        # MFU accounting: 6N model-FLOPs/token (the standard convention —
        # remat recompute NOT counted, total params incl. tied embedding,
        # matching docs/EVAL.md's hand calculation) against the chip's
        # known bf16 peak; skipped when the peak is unknown (plain CPU).
        peak_tflops = device_peak_tflops()
        n_model_params = (count_params(self.state.params)
                          if peak_tflops else 0)

        for epoch in range(self.num_epochs):
            if self.stop_event.is_set():
                logger.info("Stop event received; halting at epoch %d.", epoch + 1)
                break
            self.train_loader.set_epoch(epoch)
            epoch_losses = []
            device_losses = []
            # Device->host fetch cadence: 1 reproduces the old per-step sync
            # (for measurement); default keeps the step chain async.
            import os as _os

            sync_every = int(_os.environ.get("APERTIS_TRAINER_SYNC_EVERY", "100"))
            t0 = time.time()
            for step, batch in enumerate(self.train_loader):
                if self.stop_event.is_set():
                    break
                if self.profile_dir and epoch == 0:
                    if step == self.profile_steps[0] and not profiling:
                        import jax

                        jax.profiler.start_trace(self.profile_dir)
                        profiling = True
                    elif step == self.profile_steps[1] and profiling:
                        import jax

                        jax.profiler.stop_trace()
                        profiling = False
                        logger.info("Profiler trace written to %s",
                                    self.profile_dir)
                self.state, metrics = self._train_step(
                    self.state, self._put_batch(batch))
                # No host sync here: losses stay on device and the donated
                # state chains step-to-step asynchronously; values are
                # fetched every `sync_every` steps (and at epoch end), which
                # both bounds in-flight buffers and forces execution on
                # backends with lazy dispatch. here blocked the device every microbatch.)
                device_losses.append(metrics["loss"])
                timer.tick()
                if len(device_losses) >= sync_every:
                    epoch_losses.extend(
                        np.asarray(jnp.stack(device_losses)).tolist())
                    device_losses = []
                if (step + 1) % self.gradient_accumulation_steps == 0:
                    global_step += 1
                    if self._wandb:
                        # wandb logging is the one per-step consumer that
                        # needs host values (documented sync; default off).
                        self._wandb.log({
                            "train/loss": float(metrics["loss"]),
                            "train/learning_rate": float(self.schedule(global_step)),
                            "train/grad_norm": float(metrics["grad_norm"]),
                            "train/epoch_progress":
                                epoch + (step + 1) / max(len(self.train_loader), 1),
                        })
                    if self.checkpoint_steps and global_step % self.checkpoint_steps == 0:
                        self.save_checkpoint(f"checkpoint-step-{global_step}")
                if (self.iteration_checkpoint_steps
                        and (step + 1) % self.iteration_checkpoint_steps == 0):
                    self.save_checkpoint(f"checkpoint-iter-{step + 1}")

            if device_losses:
                epoch_losses.extend(
                    np.asarray(jnp.stack(device_losses)).tolist())
            mean_loss = float(np.mean(epoch_losses)) if epoch_losses else float("nan")
            history["train_loss"].append(mean_loss)
            # Throughput from epoch wall time measured AFTER the loss fetch
            # above (which forces the async step chain to completion); the
            # per-tick timer only sees dispatch time under async execution.
            elapsed = time.time() - t0
            stats = timer.stats(tokens_per_step or None)
            n_steps = len(epoch_losses)
            if n_steps and elapsed > 0:
                stats["epoch_time_s"] = elapsed
                stats["step_time_wall_s"] = elapsed / n_steps
                if tokens_per_step:
                    stats["tokens_per_sec"] = tokens_per_step * n_steps / elapsed
                    if peak_tflops and n_model_params:
                        stats["mfu_pct"] = (stats["tokens_per_sec"] * 6.0
                                            * n_model_params
                                            / (peak_tflops * 1e12) * 100.0)
            mfu_txt = (f", {stats['mfu_pct']:.1f}% MFU"
                       if "mfu_pct" in stats else "")
            logger.info("Epoch %d/%d: loss=%.4f (%.1fs)%s", epoch + 1,
                        self.num_epochs, mean_loss, elapsed,
                        f"  [{stats.get('tokens_per_sec', 0):,.0f} tok/s, "
                        f"{stats.get('step_time_wall_s', 0)*1e3:.0f} ms/step"
                        f" wall{mfu_txt}]"
                        if stats else "")
            if stats:
                history["perf"] = dict(stats)
            if self._wandb and stats:
                self._wandb.log({f"perf/{k}": v for k, v in stats.items()})

            if (epoch + 1) % self.eval_every_n_epochs == 0:
                val_loss = self.evaluate()
                if val_loss is not None:
                    history["val_loss"].append(val_loss)
                    logger.info("Epoch %d validation loss: %.4f", epoch + 1, val_loss)
                    if self._wandb:
                        self._wandb.log({"val/loss": val_loss})
                    if val_loss < best_val:
                        best_val = val_loss
                        # weights-only: best_model is an inference artifact;
                        # resume state lives in the epoch/step checkpoints
                        # (the optimizer moments are 2/3 of the D2H bytes).
                        self.save_checkpoint("best_model", full_state=False)
            if not self.stop_event.is_set():
                self.save_checkpoint(f"checkpoint-epoch-{epoch + 1}")

        self.save_checkpoint("final")
        if self._wandb:
            self._wandb.finish()
        history["final_step"] = global_step
        history["best_val_loss"] = best_val if best_val != float("inf") else None
        return history
