"""Device mesh construction.

One mesh, four named axes (reference had data-parallel only via DDP,
pipeline.py:462-466; TP/EP/SP are capability upgrades — SURVEY.md §2.8):

  * ``data``   — batch sharding (DP); gradients all-reduce over this axis.
  * ``model``  — tensor parallelism: attention heads / FFN columns / SSM
    inner channels. Doubles as the pipeline-stage axis when the trainer's
    ``pipeline_stages`` knob is set (layer depth sharded instead of widths).
  * ``expert`` — MoE expert sharding (dispatch all-to-all rides this axis).
  * ``seq``    — sequence/context parallelism: activations shard their L
    axis; the SSM scan passes chunk summaries between devices and the MHA
    path runs ring attention.

Devices fill the mesh in order: the cards of one host are joined all to
all, so the axes follow the algorithm, not a physical topology.

All collectives are inserted by XLA from sharding annotations (GSPMD)
except the SP scan/ring-attention bodies, which are explicit shard_maps.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
from jax.sharding import Mesh

AXES = ("data", "model", "expert", "seq")


def create_mesh(
    devices: Optional[Sequence[jax.Device]] = None,
    shape: Optional[Tuple[int, ...]] = None,
) -> Mesh:
    """Build a (data, model, expert[, seq]) mesh over the given devices.

    Default shape puts all devices on the data axis. 3-tuples get a
    trailing seq=1 (backwards compatible). ``shape`` must multiply to the
    device count.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        shape = (n, 1, 1, 1)
    shape = tuple(shape)
    if len(shape) == 3:
        shape = shape + (1,)
    if len(shape) != 4:
        raise ValueError(f"mesh shape must have 3 or 4 axes, got {shape}")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, AXES)


def single_device_mesh() -> Mesh:
    return create_mesh(jax.devices()[:1], (1, 1, 1, 1))


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None) -> bool:
    """Multi-process bring-up: ``jax.distributed.initialize`` with the
    coordinator from the arguments or ``JAX_COORDINATOR_ADDRESS`` (the
    replacement for the reference's ``dist.init_process_group``,
    pipeline.py:439-441). ``num_processes`` and ``process_id`` must be
    given with it: nothing on a GPU host tells JAX of a cluster.

    Returns True when running multi-process after the call. Safe to call on
    a single host (no-op if no coordinator is configured).
    """
    import os

    if jax.process_count() > 1:
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    try:
        if coordinator_address:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id)
    except Exception as e:  # single-host or already initialised
        import logging

        logging.getLogger(__name__).info(
            "jax.distributed not initialised (%s); running single-process.", e)
    return jax.process_count() > 1
