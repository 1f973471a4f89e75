"""Backend decisions: which implementation runs on which JAX backend.

Every dispatch that depends on the backend reads this module; no other
module of the package asks JAX which backend it runs on.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Optional

import jax
import jax.numpy as jnp

_PLAIN = contextvars.ContextVar("apertis_plain_xla", default=False)


@contextlib.contextmanager
def plain_xla() -> Iterator[None]:
    """Programs traced inside this context take the plain XLA path on every
    backend: the float32 reference that library kernels (cuDNN attention)
    are compared with."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def name() -> str:
    """JAX's default backend: ``"gpu"`` on an NVIDIA card, ``"cpu"`` in
    tests."""
    return jax.default_backend()


def fused_attention_implementation(dtype, seq_len: int) -> Optional[str]:
    """``implementation`` for ``jax.nn.dot_product_attention`` on the
    ``use_flash_attention`` path: cuDNN's fused attention on the GPU for
    16-bit inputs (the only dtypes it takes) from 128 tokens up, XLA's
    otherwise. On the H100 (PERF.md, PR 1) cuDNN ran the b8 x 1024 MHA
    training shape 4.4x faster than XLA (forward + backward) and lost at a
    32-token prefill."""
    if (name() == "gpu" and not _PLAIN.get() and seq_len >= 128
            and jnp.dtype(dtype) in (jnp.bfloat16, jnp.float16)):
        return "cudnn"
    return None
