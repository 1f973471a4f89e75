"""Checkpointing: full train state + reference-compatible weight export.

The reference saves only weights + config per checkpoint (pipeline.py:640-698)
— no optimizer/scheduler/RNG state, so no true resume. Here every checkpoint
directory contains BOTH:

  * ``state/state.npz`` — every leaf of the TrainState (params, optimizer
    state, step counter, PRNG key) in flattening order: true resume
    (capability upgrade, SURVEY.md §5), restored against a template of the
    same structure, and
  * the weights in the reference's state-dict layout plus ``config.json``
    (+ copied tokenizer/vocab files), loadable by this framework's
    inference stack and, as ``pytorch_model.bin`` when torch imports, by
    the PyTorch reference (models/convert.save_pretrained_weights).
"""

from __future__ import annotations

import logging
import shutil
from pathlib import Path
from typing import Any, Optional

import jax
import numpy as np

logger = logging.getLogger(__name__)

STATE_FILE = "state.npz"


def _host(tree: Any) -> Any:
    return jax.tree.map(
        lambda x: np.asarray(x) if isinstance(x, jax.Array) else x, tree)


def save_checkpoint(
    ckpt_dir: str | Path,
    state: Any,                    # TrainState
    config,                        # ApertisConfig
    tokenizer_src: Optional[str] = None,
    export_torch: bool = True,
    full_state: bool = True,
) -> None:
    """``full_state=False`` saves the weight export only (no ``state/``):
    the optimizer moments are 2/3 of the device-to-host bytes, and
    ``best_model`` is an inference artifact — the trainer saves it
    weights-only and keeps true-resume state in the per-epoch/step
    checkpoints. ``export_torch=False`` writes ``config.json`` only."""
    ckpt_dir = Path(ckpt_dir).resolve()
    ckpt_dir.mkdir(parents=True, exist_ok=True)

    if full_state:
        state_dir = ckpt_dir / "state"
        if state_dir.exists():
            shutil.rmtree(state_dir)
        state_dir.mkdir()
        leaves = jax.tree.leaves(_host(state))
        np.savez(state_dir / STATE_FILE,
                 **{f"leaf_{i:05d}": leaf for i, leaf in enumerate(leaves)})
    params_host = _host(state.params)

    if export_torch:
        from apertis_llm_tpu.models.convert import save_pretrained_weights

        save_pretrained_weights(params_host, config, ckpt_dir)
    else:
        config.save_pretrained(ckpt_dir)

    if tokenizer_src:
        src = Path(tokenizer_src)
        try:
            if src.is_file():
                shutil.copy2(src, ckpt_dir / src.name)
            elif src.is_dir():
                for f in src.iterdir():
                    if f.is_file() and f.suffix in (".json", ".txt", ".model"):
                        shutil.copy2(f, ckpt_dir / f.name)
        except OSError as e:
            logger.warning("Could not copy tokenizer from %s: %s", tokenizer_src, e)
    logger.info("Checkpoint saved to %s", ckpt_dir)


def restore_train_state(ckpt_dir: str | Path, abstract_state: Any):
    """Restore a TrainState saved by :func:`save_checkpoint`.

    ``abstract_state`` is a TrainState with correctly-shaped (possibly
    uninitialised) arrays used as the restore template.
    """
    path = Path(ckpt_dir).resolve() / "state" / STATE_FILE
    template, treedef = jax.tree.flatten(abstract_state)
    with np.load(path) as data:
        leaves = [data[f"leaf_{i:05d}"] for i in range(len(data.files))]
    if len(leaves) != len(template):
        raise ValueError(f"{path} holds {len(leaves)} arrays; the train "
                         f"state has {len(template)}")
    for got, want in zip(leaves, template):
        if got.shape != tuple(np.shape(want)):
            raise ValueError(f"{path}: array of shape {got.shape} where the "
                             f"train state has {np.shape(want)}")
    return jax.tree.unflatten(treedef, leaves)


def latest_checkpoint(output_dir: str | Path) -> Optional[Path]:
    """Find the most recent checkpoint dir containing a saved state."""
    output_dir = Path(output_dir)
    if not output_dir.exists():
        return None
    candidates = [d for d in output_dir.iterdir()
                  if d.is_dir() and (d / "state").exists()]
    if not candidates:
        return None
    return max(candidates, key=lambda d: d.stat().st_mtime)
