"""Unified multimodal encoder: a ViT over image patches, fully in-graph.

Functional reimplementation of the reference UnifiedMultimodalEncoder
(reference: src/multimodal/module.py:10-119): Conv2d patch embed -> CLS token
-> learned position embeddings -> N pre-norm transformer layers (GELU, 4x FFN)
-> final LayerNorm. Transformer-layer math matches
``torch.nn.TransformerEncoderLayer(norm_first=True)`` in eval mode (LN eps
1e-5, packed qkv projection, exact GELU).

The patch embedding is expressed as a single reshape + matmul rather than a
convolution, and image resize/normalisation are also
in-graph so the whole image path compiles into one XLA program.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from apertis_llm_tpu.config import ApertisConfig
from apertis_llm_tpu.ops.activations import gelu
from apertis_llm_tpu.ops.norms import layer_norm

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_VIT_LN_EPS = 1e-5  # torch TransformerEncoderLayer default


def preprocess_images(images: jnp.ndarray, image_size: int) -> jnp.ndarray:
    """Resize + ImageNet-normalise a batch of images, in-graph.

    Accepts (B, H, W, 3) uint8/float in [0, 255] or [0, 1]; returns
    channels-first (B, 3, S, S) float32 matching torchvision's
    Resize -> ToTensor -> Normalize pipeline (module.py:27-31).
    """
    x = images.astype(jnp.float32)
    x = jnp.where(jnp.max(x) > 1.5, x / 255.0, x)
    x = jax.image.resize(
        x, (x.shape[0], image_size, image_size, x.shape[-1]), method="bilinear")
    mean = jnp.asarray(IMAGENET_MEAN, jnp.float32)
    std = jnp.asarray(IMAGENET_STD, jnp.float32)
    x = (x - mean) / std
    return jnp.transpose(x, (0, 3, 1, 2))


def _qlin(lp: dict, x: jnp.ndarray) -> jnp.ndarray:
    """Quant-aware linear: plain ``w`` or serving-quantized ``w_q``/``w_s``
    dicts (models/quantize.py, APERTIS_QUANT_VIT=1) through the same
    dispatch the decoder uses."""
    from apertis_llm_tpu.models.apertis import _linear

    return _linear(lp, x)


def _vit_attention(x: jnp.ndarray, lp: dict, num_heads: int,
                   key_bias=None) -> jnp.ndarray:
    """Self-attention over an L-FIRST (L, B, D) token stream.

    The attention-output einsum naturally emits its q (token) axis major,
    so with a (B, L, D) stream every residual add would pay an L<->B
    relayout inside the scan carry. Running the whole layer stack L-first
    makes that layout the row-major one; the einsums below differ from the
    (B, L, D) form only in the subscript order."""
    if "in_proj_w_q" in lp:
        l, b, d = x.shape
        qkv = _qlin({"w_q": lp["in_proj_w_q"], "w_s": lp["in_proj_w_s"],
                     "b": lp["in_proj_b"]}, x)            # (L, B, 3D)
    else:
        l, b, d = x.shape
        qkv = x @ lp["in_proj_w"] + lp["in_proj_b"]      # (L, B, 3D)
    head_dim = d // num_heads
    q, k, v = jnp.split(qkv, 3, axis=-1)

    # Transpose-free head split: contract via einsum over (L, B, H, Dh)
    # directly — explicit transposes pushed XLA into relayout fusions.
    def heads(t):
        return t.reshape(l, b, num_heads, head_dim)

    q, k, v = heads(q), heads(k), heads(v)
    scores = jnp.einsum("qbhd,kbhd->bhqk", q, k,
                        preferred_element_type=jnp.float32) * (head_dim ** -0.5)
    if key_bias is not None:
        scores = scores + key_bias                        # (L,) over keys
    probs = jax.nn.softmax(scores, axis=-1).astype(v.dtype)
    out = jnp.einsum("bhqk,kbhd->qbhd", probs, v,
                     preferred_element_type=jnp.float32).astype(v.dtype)
    out = out.reshape(l, b, d)
    return _qlin(lp["attn_out"], out)


def _vit_layer(x: jnp.ndarray, lp: dict, num_heads: int,
               key_bias=None) -> jnp.ndarray:
    # Pre-norm residual blocks (norm_first=True).
    h = layer_norm(x, lp["ln1"]["w"], lp["ln1"]["b"], eps=_VIT_LN_EPS)
    x = x + _vit_attention(h, lp, num_heads, key_bias)
    h = layer_norm(x, lp["ln2"]["w"], lp["ln2"]["b"], eps=_VIT_LN_EPS)
    h = gelu(_qlin(lp["linear1"], h))
    h = _qlin(lp["linear2"], h)
    return x + h


def vit_encode(params: dict, config: ApertisConfig, pixel_values: jnp.ndarray) -> jnp.ndarray:
    """Encode (B, 3, S, S) pixels into (B, num_patches + 1, vision_embed_dim)."""
    b = pixel_values.shape[0]
    p = config.vision_patch_size
    sp = config.image_size // p

    # Patch extraction as reshape: (B,3,S,S) -> (B, Np, 3*P*P) in (c, dy, dx)
    # order, matching Conv2d(kernel=P, stride=P) weight flattening.
    x = pixel_values.reshape(b, 3, sp, p, sp, p)
    x = x.transpose(0, 2, 4, 1, 3, 5).reshape(b, sp * sp, 3 * p * p)
    # Run the encoder in the weights' dtype: preprocess_images emits float32,
    # and without this cast the promotion rules would run every ViT GEMM in
    # f32. Attention scores/softmax stay f32 via preferred_element_type.
    x = x.astype(params["cls_token"].dtype)
    x = _qlin(params["patch_embed"], x)

    cls = jnp.broadcast_to(params["cls_token"], (b, 1, x.shape[-1])).astype(x.dtype)
    x = jnp.concatenate([cls, x], axis=1)
    x = x + params["pos_embed"]

    # Pad the token axis (197 = 196 patches + CLS) to a multiple of 8 with
    # attention-masked tokens, so the scan carry keeps a row-major layout.
    # Real-token outputs are exactly unchanged (pad keys get -inf scores;
    # pad rows are sliced off before returning).
    l = x.shape[1]
    pad = (-l) % 8
    key_bias = None
    if pad:
        x = jnp.pad(x, ((0, 0), (0, pad), (0, 0)))
        key_bias = jnp.where(jnp.arange(l + pad) < l, 0.0, -jnp.inf
                             ).astype(jnp.float32)

    # The layer stack runs L-FIRST (see _vit_attention): one transpose in
    # and out replaces a per-layer L<->B relayout of the residual stream.
    x = x.transpose(1, 0, 2)

    def body(h, lp):
        return _vit_layer(h, lp, config.vision_heads, key_bias), None

    # APERTIS_VIT_UNROLL=1 replaces the layer scan with statically indexed
    # layers; numerics are identical either way. Its effect on the GPU is
    # not measured.
    import os

    if os.environ.get("APERTIS_VIT_UNROLL", "0") == "1":
        n_layers = jax.tree_util.tree_leaves(params["layers"])[0].shape[0]
        for i in range(n_layers):
            lp = jax.tree.map(lambda a: a[i], params["layers"])
            x, _ = body(x, lp)
    else:
        x, _ = jax.lax.scan(body, x, params["layers"])
    x = x.transpose(1, 0, 2)[:, :l]
    return layer_norm(x, params["final_ln"]["w"], params["final_ln"]["b"],
                      eps=_VIT_LN_EPS)
