"""Compiled autoregressive generation engine.

The reference's ``generate`` is a Python loop with per-step host round-trips
(reference: src/model/core.py:1520-1644). Here the ENTIRE generation — prefill,
decode loop, sampling, stop handling — runs on device with no per-token host
sync. Two program layouts:

* **split** (default for selective-SSM): a prefill+first-token program and a
  decode-loop program whose generation length is a dynamic scalar — the
  prefill graph (the expensive compile) builds ONCE per (bucket, batch,
  sampling mode) and one decode program serves every ``max_new_tokens`` up
  to ``config.decode_max_length``; a pure-TTFT call never builds the decode
  program at all. ``APERTIS_ENGINE_SPLIT=0`` reverts to the monolith.
* **monolithic** (MHA models, or opt-out): the whole generation in one XLA
  program driven by ``lax.while_loop``, exact-sized buffers per
  ``max_new_tokens`` (an MHA decode step reads its whole KV cache, so
  capacity-sized buffers would cost real attention time).

Both are token-exact with each other (pinned in tests/test_engine_split.py).

Faithful semantics (eval mode):
  * finished rows emit ``pad_token_id`` and stop growing the attention mask,
  * decode position is the scalar "total length so far" for every row
    (the reference uses ``attention_mask.shape[1] - 1`` for all rows),
  * repetition penalty counts every filled slot of the running token buffer
    (prompt included), dividing the logit once per occurrence,
  * early exit when all rows finished and ``min_new_tokens`` satisfied,
  * multimodal prompts prepend ``num_image_tokens`` vision tokens to the
    cache/mask exactly as the reference estimates them (core.py:1562-1572).

Prompts are bucketed to a few static lengths to bound recompilation; each
(bucket, max_new_tokens, batch, sampling-mode) tuple compiles once and is
cached on the instance.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from apertis_llm_tpu.config import ApertisConfig
from apertis_llm_tpu.models import apertis as model_lib
from apertis_llm_tpu.ops import sampling as sampling_ops


class GenerationParams(NamedTuple):
    """Static sampling knobs (hashable: part of the jit cache key)."""
    max_new_tokens: int = 20
    min_new_tokens: int = 0
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 50
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    eos_token_ids: Tuple[int, ...] = ()
    pad_token_id: int = 0


def _compiler_options(decode: bool = False) -> Optional[Dict[str, Any]]:
    """Optional XLA build options for the engine's prefill programs.

    ``APERTIS_COMPILE_EFFORT=<float>`` sets XLA's
    ``exec_time_optimization_effort`` (0.0 = default; negative trades
    optimisation for compile time). Decode-loop programs (``decode=True``)
    keep the default: they compile in seconds."""
    effort = os.environ.get("APERTIS_COMPILE_EFFORT")
    if effort and not decode:
        return {"exec_time_optimization_effort": float(effort)}
    return None


def _round_up_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest static prompt length >= n.

    Within the table, the usual power-of-two buckets; beyond it, round up to
    the next multiple of half the largest bucket so arbitrarily long prompts (the
    32K context the reference advertises, docs/README.md:589) compile to a
    bounded set of shapes and are never truncated.
    """
    for b in buckets:
        if n <= b:
            return b
    step = max(buckets[-1] // 2, 1)
    return ((n + step - 1) // step) * step


def _check_position_limit(config: ApertisConfig, max_needed: int) -> None:
    """MHA-rotary and absolute-position models index fixed-size position
    tables; past them the reference crashes (SURVEY: RoPE tables capped at
    max_position_embeddings) and JAX would silently clamp — raise instead.
    The selective-SSM path has no positional table and is unlimited."""
    limited = (config.position_embedding_type == "absolute"
               or (config.position_embedding_type == "rotary"
                   and config.attention_type != "selective_ssm"))
    if limited and max_needed > config.max_position_embeddings:
        raise ValueError(
            f"prompt + max_new_tokens needs positions up to {max_needed} but "
            f"max_position_embeddings={config.max_position_embeddings}; use a "
            "selective_ssm model for long context or raise the limit")


class GenerateState(NamedTuple):
    tokens: jnp.ndarray      # (B, buf_len) running buffer (prompt + generated)
    mask: jnp.ndarray        # (B, cache_len) attention validity (img+prompt+generated)
    cache: Any
    t: jnp.ndarray           # scalar int32: filled cache slots
    filled: jnp.ndarray      # scalar int32: filled token-buffer slots
    unfinished: jnp.ndarray  # (B,) int32
    step: jnp.ndarray        # scalar int32
    rng: jax.Array


def _make_sample(config, gen: GenerationParams, lens, lp: int, buf_len: int):
    """Sampling closure shared by the monolithic and split programs.

    History = real prompt tokens + generated region; bucket pads and the
    unwritten tail of the buffer are masked out, so the same closure is
    token-exact whether the buffer is sized to ``max_new_tokens`` (monolith)
    or to the static decode capacity (split programs) — masked history
    entries contribute exact float zeros to the penalty counts."""
    def sample(rng, logits, state_tokens, filled):
        pos = jnp.arange(buf_len)[None, :]
        hist_mask = ((pos < lens[:, None]) |
                     ((pos >= lp) & (pos < filled))).astype(jnp.float32)
        return sampling_ops.sample_token(
            rng, logits,
            do_sample=gen.do_sample, temperature=gen.temperature,
            top_k=gen.top_k, top_p=gen.top_p,
            repetition_penalty=gen.repetition_penalty,
            token_history=state_tokens, history_mask=hist_mask)
    return sample


def _make_finish_update(gen: GenerationParams, tokens_dtype):
    def finish_update(unfinished, next_tokens):
        next_tokens = (next_tokens * unfinished
                       + gen.pad_token_id * (1 - unfinished)).astype(tokens_dtype)
        for eos in gen.eos_token_ids:
            unfinished = jnp.where(
                (next_tokens == eos) & (unfinished == 1), 0, unfinished)
        return next_tokens, unfinished
    return finish_update


def _prefill_state(
    params,
    input_ids: jnp.ndarray,        # (B, Lp) right-padded prompt
    attention_mask: jnp.ndarray,   # (B, Lp)
    rng: jax.Array,
    pixel_values: Optional[jnp.ndarray] = None,
    *,
    config: ApertisConfig,
    gen: GenerationParams,
    cap: int,                      # static decode capacity (buffer slots)
) -> GenerateState:
    """Prefill + FIRST sampled token; buffers sized by ``cap`` so the
    program is independent of the requested ``max_new_tokens``."""
    b, lp = input_ids.shape
    num_img = config.num_image_tokens if (config.multimodal and pixel_values is not None) else 0
    cache_len = num_img + lp + cap
    buf_len = lp + cap

    cache = model_lib.init_cache(config, b, max_length=cache_len)
    # Only each row's last real prompt token's logits are consumed below —
    # prefill skips the lm_head everywhere else.
    lens = jnp.sum(attention_mask.astype(jnp.int32), axis=1)          # (B,)
    last_idx = jnp.maximum(lens - 1, 0)
    pre = model_lib.prefill(
        params, config, cache, input_ids,
        attention_mask=attention_mask, pixel_values=pixel_values,
        logit_positions=last_idx)

    tokens = jnp.concatenate(
        [input_ids, jnp.full((b, cap), gen.pad_token_id,
                             input_ids.dtype)], axis=1)
    mask = jnp.zeros((b, cache_len), jnp.int32)
    if num_img:
        mask = mask.at[:, :num_img].set(1)
    mask = jax.lax.dynamic_update_slice(
        mask, attention_mask.astype(jnp.int32), (0, num_img))

    # Logit of the last REAL prompt token per row (prompts are right-padded).
    first_logits = pre.logits[:, 0, :]

    sample = _make_sample(config, gen, lens, lp, buf_len)
    finish_update = _make_finish_update(gen, tokens.dtype)

    rng, r0 = jax.random.split(rng)
    next_tokens = sample(r0, first_logits.astype(jnp.float32), tokens, lp)
    unfinished = jnp.ones((b,), jnp.int32)
    # Mask bit for a generated token = unfinished state WHEN it was generated
    # (the EOS token itself stays visible; later pads are masked out),
    # matching the reference's mask-growth order (core.py:1631-1640).
    mask_bit = unfinished
    next_tokens, unfinished = finish_update(unfinished, next_tokens)

    tokens = jax.lax.dynamic_update_slice(tokens, next_tokens[:, None], (0, lp))
    t0 = jnp.asarray(num_img + lp, jnp.int32)
    mask = jax.lax.dynamic_update_slice(mask, mask_bit[:, None], (0, t0))

    return GenerateState(tokens, mask, pre.cache, t0, jnp.asarray(lp + 1, jnp.int32),
                         unfinished, jnp.asarray(1, jnp.int32), rng)


def _decode_loop(
    params,
    state: GenerateState,
    lens: jnp.ndarray,             # (B,) real prompt lengths
    max_new: jnp.ndarray,          # dynamic scalars: one compiled program
    min_new: jnp.ndarray,          # serves every generation length <= cap
    *,
    config: ApertisConfig,
    gen: GenerationParams,
    lp: int,                       # static padded prompt length
    num_img: int,                  # static image-prefix length
):
    b, buf_len = state.tokens.shape
    sample = _make_sample(config, gen, lens, lp, buf_len)
    finish_update = _make_finish_update(gen, state.tokens.dtype)

    def cond(s: GenerateState):
        more_steps = s.step < max_new
        need_min = s.step < min_new
        running = jnp.any(s.unfinished == 1)
        return more_steps & (running | need_min)

    def body(s: GenerateState) -> GenerateState:
        cur = jax.lax.dynamic_slice(s.tokens, (0, s.filled - 1), (b, 1))[:, 0]
        # Logical positions skip the bucket padding: token being decoded is
        # the (step-1)-th generated one, at position num_img + len + step - 1.
        positions = num_img + lens + s.step - 1
        logits, cache = model_lib.decode_step(
            params, config, s.cache, cur, s.t,
            attn_mask_row=s.mask, positions=positions)
        rng, r = jax.random.split(s.rng)
        nxt = sample(r, logits.astype(jnp.float32), s.tokens, s.filled)
        mask_bit = s.unfinished
        nxt, unfinished = finish_update(s.unfinished, nxt)
        tokens = jax.lax.dynamic_update_slice(s.tokens, nxt[:, None], (0, s.filled))
        mask = jax.lax.dynamic_update_slice(s.mask, mask_bit[:, None], (0, s.t + 1))
        return GenerateState(tokens, mask, cache, s.t + 1, s.filled + 1,
                             unfinished, s.step + 1, rng)

    final = jax.lax.while_loop(cond, body, state)
    return final.tokens, jnp.asarray(lp, jnp.int32) + final.step


def _generate_impl(
    params,
    config: ApertisConfig,
    gen: GenerationParams,
    input_ids: jnp.ndarray,        # (B, Lp) right-padded prompt
    attention_mask: jnp.ndarray,   # (B, Lp)
    rng: jax.Array,
    pixel_values: Optional[jnp.ndarray] = None,
):
    """Monolithic whole-generation program (prefill + loop in one XLA
    program); the split path compiles :func:`_prefill_state` and
    :func:`_decode_loop` separately instead."""
    b, lp = input_ids.shape
    num_img = config.num_image_tokens if (config.multimodal and pixel_values is not None) else 0
    state = _prefill_state(params, input_ids, attention_mask, rng,
                           pixel_values, config=config, gen=gen,
                           cap=gen.max_new_tokens)
    lens = jnp.sum(attention_mask.astype(jnp.int32), axis=1)
    return _decode_loop(params, state, lens,
                        jnp.asarray(gen.max_new_tokens, jnp.int32),
                        jnp.asarray(gen.min_new_tokens, jnp.int32),
                        config=config, gen=gen, lp=lp, num_img=num_img)


class InferenceEngine:
    """Owns compiled generate/prefill programs for one (config, params) pair."""

    PROMPT_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)

    def __init__(self, config: ApertisConfig, params, dtype: Optional[str] = None,
                 mesh=None):
        self.config = config
        self.params = params
        # Serving mesh: when it carries an expert axis >1 the engine traces
        # its programs inside parallel_context so the MoE FFN routes through
        # the engineered all-to-all dispatch (ops/moe_ep.py) instead of
        # whatever comms GSPMD infers from gather/scatter.
        self.mesh = mesh
        if dtype is not None:
            target = jnp.dtype(dtype)
            self.params = jax.tree.map(
                lambda x: x.astype(target) if jnp.issubdtype(x.dtype, jnp.floating) else x,
                params)
        # Serving-side weight preparation, composed into one jitted program
        # (dispatched op by op, the attach work is tens of small programs).
        # Each step leaves the base tree in place for prefill and training;
        # both are skipped under a serving mesh, whose sharding specs
        # describe the base tree.
        attach_steps = []
        if config.use_expert_system and config.num_experts > 0 and mesh is None:
            # Combine-folded fat expert stack read by the MoE decode path
            # (models/moe_fuse.py, ops/moe.moe_dense_fat).
            from apertis_llm_tpu.models.moe_fuse import attach_fused_decode_params

            attach_steps.append(attach_fused_decode_params)
        if mesh is None and os.environ.get("APERTIS_QUANT_HEAD", "1") != "0":
            # Serving int8 copy of the tied LM head (models/quantize.py):
            # the decode step's largest projection otherwise reads the full
            # bf16 embedding table every token.
            from apertis_llm_tpu.models.quantize import (
                quantize_tied_head, tree_is_quantized)

            if tree_is_quantized(self.params):
                attach_steps.append(quantize_tied_head)
        if attach_steps:
            def attach(tree):
                for step in attach_steps:
                    tree = step(tree)
                return tree

            self.params = jax.jit(attach)(self.params)
        self._compiled: Dict[Any, Any] = {}

    def _trace_context(self):
        """Context manager active while jitted programs trace/compile.

        Any serving mesh enters the context (single-device kernels check
        ``current().mesh`` and stand down under GSPMD-sharded programs);
        the expert axis additionally routes the MoE FFN through the
        engineered all-to-all dispatch."""
        if self.mesh is not None:
            from apertis_llm_tpu.parallel.context import parallel_context

            ep = "expert" if self.mesh.shape.get("expert", 1) > 1 else None
            return parallel_context(self.mesh, sp_axis=None,
                                    batch_axis="data", ep_axis=ep)
        return contextlib.nullcontext()

    def _get_fn(self, gen: GenerationParams, lp: int, batch: int, has_image: bool):
        key = (gen, lp, batch, has_image)
        fn = self._compiled.get(key)
        if fn is None:
            fn = jax.jit(functools.partial(_generate_impl, config=self.config, gen=gen),
                         compiler_options=_compiler_options())
            self._compiled[key] = fn
        return fn

    # -- split generation programs (serving bring-up) ---------------------
    #
    # The monolithic program recompiles the ENTIRE prefill graph for every
    # distinct max_new_tokens; split mode compiles the prefill+first-token
    # program once per (bucket, batch, sampling mode) and a decode-loop
    # program whose generation length is a DYNAMIC scalar — one compile
    # serves every max_new_tokens <= the static buffer capacity
    # (config.decode_max_length). Default for selective-SSM models, whose
    # decode state is O(1) so capacity-sized buffers cost only the small
    # token/mask arrays; MHA keeps exact-sized programs (a capacity-length
    # KV cache would be read by every attention step). Token-exact with the
    # monolith: same ops, buffer pads are masked exact zeros.

    def _split_enabled(self) -> bool:
        if os.environ.get("APERTIS_ENGINE_SPLIT", "1") == "0":
            return False
        return self.config.attention_type == "selective_ssm"

    def _decode_cap(self, max_new: int) -> int:
        cap = max(self.config.decode_max_length, 64)
        if max_new > cap:
            cap = -(-max_new // 1024) * 1024
        return cap

    def _get_split_prefill(self, gen_key: GenerationParams, lp: int,
                           batch: int, has_image: bool, cap: int):
        key = ("split_prefill", gen_key, lp, batch, has_image, cap)
        fn = self._compiled.get(key)
        if fn is None:
            fn = jax.jit(
                functools.partial(_prefill_state, config=self.config,
                                  gen=gen_key, cap=cap),
                compiler_options=_compiler_options())
            self._compiled[key] = fn
        return fn

    def _get_split_decode(self, gen_key: GenerationParams, lp: int,
                          batch: int, has_image: bool, cap: int):
        key = ("split_decode", gen_key, lp, batch, has_image, cap)
        fn = self._compiled.get(key)
        if fn is None:
            num_img = self.config.num_image_tokens if (
                self.config.multimodal and has_image) else 0
            fn = jax.jit(
                functools.partial(_decode_loop, config=self.config,
                                  gen=gen_key, lp=lp, num_img=num_img),
                donate_argnums=(1,),
                compiler_options=_compiler_options(decode=True))
            self._compiled[key] = fn
        return fn

    def _prefill_shape(self, l: int, has_image: bool) -> Tuple[int, int]:
        """(image-prefix length, padded text length) of an ``l``-token
        prompt. The total prefill length (image prefix + text bucket) is
        aligned to a multiple of 8 rows; the extra columns are ordinary
        bucket padding, masked out and state-invisible like any right-pad."""
        num_img = (self.config.num_image_tokens
                   if self.config.multimodal and has_image else 0)
        bucket = _round_up_bucket(l, self.PROMPT_BUCKETS)
        return num_img, bucket + (-(num_img + bucket)) % 8

    def generate(
        self,
        input_ids: np.ndarray,                 # (B, L) int
        attention_mask: Optional[np.ndarray] = None,
        pixel_values: Optional[np.ndarray] = None,
        rng: Optional[jax.Array] = None,
        **gen_kwargs,
    ) -> np.ndarray:
        """Batch generation; returns (B, L_prompt_padded + n_generated) ids."""
        eos = gen_kwargs.pop("eos_token_id", None)
        if eos is None:
            eos = self.config.eos_token_id
        if not isinstance(eos, (tuple, list)):
            eos = (eos,) if eos is not None else ()
        pad = gen_kwargs.pop("pad_token_id", None)
        if pad is None:
            pad = self.config.pad_token_id if self.config.pad_token_id is not None else 0
        gen = GenerationParams(
            eos_token_ids=tuple(int(e) for e in eos if e is not None),
            pad_token_id=int(pad),
            **gen_kwargs)

        input_ids = np.asarray(input_ids)
        b, l = input_ids.shape
        if attention_mask is None:
            attention_mask = np.ones((b, l), np.int32)
        num_img, bucket = self._prefill_shape(l, pixel_values is not None)
        _check_position_limit(self.config,
                              num_img + bucket + gen.max_new_tokens)
        padded_ids, padded_mask = input_ids, attention_mask
        if bucket > l:
            padc = ((0, 0), (0, bucket - l))
            padded_ids = np.pad(input_ids, padc, constant_values=gen.pad_token_id)
            padded_mask = np.pad(attention_mask, padc)

        if rng is None:
            rng = jax.random.PRNGKey(np.random.randint(0, 2**31 - 1))

        has_image = pixel_values is not None
        kwargs = {}
        if has_image:
            kwargs["pixel_values"] = jnp.asarray(pixel_values)
        if self._split_enabled():
            cap = self._decode_cap(gen.max_new_tokens)
            gen_key = gen._replace(max_new_tokens=0, min_new_tokens=0)
            pf = self._get_split_prefill(gen_key, bucket, b, has_image, cap)
            with self._trace_context():
                state = pf(self.params, input_ids=jnp.asarray(padded_ids),
                           attention_mask=jnp.asarray(padded_mask),
                           rng=rng, **kwargs)
            if gen.max_new_tokens <= 1:
                # First token already sampled by the prefill program; the
                # decode-loop program is never built for pure-TTFT calls.
                dev_tokens = state.tokens
                n_generated = gen.max_new_tokens
            else:
                df = self._get_split_decode(gen_key, bucket, b, has_image, cap)
                lens = jnp.asarray(
                    padded_mask.sum(axis=1).astype(np.int32))
                with self._trace_context():
                    dev_tokens, length = df(
                        self.params, state, lens,
                        jnp.asarray(gen.max_new_tokens, jnp.int32),
                        jnp.asarray(gen.min_new_tokens, jnp.int32))
                n_generated = int(length) - bucket
            # Fetch only the generated columns of the capacity-sized buffer;
            # the device-side slice costs a trivial program per width.
            tokens = np.asarray(
                dev_tokens[:, bucket:bucket + max(n_generated, 0)])
            return np.concatenate([input_ids, tokens], axis=1)
        else:
            fn = self._get_fn(gen, bucket, b, has_image)
            with self._trace_context():
                tokens, length = fn(self.params,
                                    input_ids=jnp.asarray(padded_ids),
                                    attention_mask=jnp.asarray(padded_mask),
                                    rng=rng, **kwargs)
            tokens = np.asarray(tokens)
            n_generated = int(length) - bucket
        # Contract matches the reference: prompt columns as given, then the
        # generated columns (internal bucket padding stripped).
        return np.concatenate([input_ids, tokens[:, bucket:bucket + n_generated]],
                              axis=1)

    def last_token_logits(
        self,
        input_ids: np.ndarray,                 # (B, L) int, unpadded
        pixel_values: Optional[np.ndarray] = None,
    ) -> jax.Array:
        """(B, V) logits of each prompt's last token from the serving
        prefill program (bucketed and padded exactly as :meth:`generate`
        pads): what a correctness check compares with a reference
        forward."""
        input_ids = np.asarray(input_ids)
        b, l = input_ids.shape
        num_img, bucket = self._prefill_shape(l, pixel_values is not None)
        pad_id = self.config.pad_token_id or 0
        padded = np.pad(input_ids, ((0, 0), (0, bucket - l)),
                        constant_values=pad_id)
        attn = np.pad(np.ones((b, l), np.int32), ((0, 0), (0, bucket - l)))
        cache_len = num_img + bucket + 1
        fn = self._jit_prefill(cache_len, pixel_values is not None)
        cache = model_lib.init_cache(self.config, b, max_length=cache_len)
        kwargs = ({"pixel_values": jnp.asarray(pixel_values)}
                  if pixel_values is not None else {})
        with self._trace_context():
            pre = fn(self.params, cache, jnp.asarray(padded),
                     jnp.asarray(attn), jnp.full((b,), l - 1, jnp.int32),
                     **kwargs)
        return pre.logits[:, 0, :]

    # -- streaming ------------------------------------------------------
    def stream(
        self,
        input_ids: np.ndarray,                 # (1, L)
        pixel_values: Optional[np.ndarray] = None,
        rng: Optional[jax.Array] = None,
        **gen_kwargs,
    ):
        """Yield token ids one at a time (for interactive chat).

        Uses jitted prefill + jitted single-step decode with a host-side loop;
        slower than :meth:`generate` but emits tokens incrementally.
        """
        eos = gen_kwargs.pop("eos_token_id", None)
        if eos is None:
            eos = self.config.eos_token_id
        eos_set = set(np.atleast_1d(eos).tolist()) if eos is not None else set()
        max_new = gen_kwargs.pop("max_new_tokens", 128)
        min_new = gen_kwargs.pop("min_new_tokens", 0)
        do_sample = gen_kwargs.pop("do_sample", False)
        temperature = gen_kwargs.pop("temperature", 1.0)
        top_k = gen_kwargs.pop("top_k", 50)
        top_p = gen_kwargs.pop("top_p", 1.0)
        repetition_penalty = gen_kwargs.pop("repetition_penalty", 1.0)

        config = self.config
        input_ids = np.asarray(input_ids)
        b, l = input_ids.shape
        assert b == 1, "streaming supports batch 1"
        num_img, bucket = self._prefill_shape(l, pixel_values is not None)
        pad_id = config.pad_token_id if config.pad_token_id is not None else 0
        _check_position_limit(config, num_img + bucket + max_new)
        cache_len = num_img + bucket + max_new

        padded = np.pad(input_ids, ((0, 0), (0, bucket - l)), constant_values=pad_id)
        attn = np.pad(np.ones((1, l), np.int32), ((0, 0), (0, bucket - l)))

        prefill_fn = self._jit_prefill(cache_len, pixel_values is not None)
        step_fn = self._jit_step()

        cache = model_lib.init_cache(config, 1, max_length=cache_len)
        kwargs = {"pixel_values": jnp.asarray(pixel_values)} if pixel_values is not None else {}
        with self._trace_context():
            pre = prefill_fn(self.params, cache, jnp.asarray(padded),
                             jnp.asarray(attn), jnp.asarray([l - 1], jnp.int32),
                             **kwargs)
        if rng is None:
            rng = jax.random.PRNGKey(np.random.randint(0, 2**31 - 1))

        # Cache validity row: image prefix + real prompt + generated slots.
        mask_np = np.zeros((1, cache_len), np.int32)
        mask_np[0, :num_img] = 1
        mask_np[0, num_img:num_img + l] = 1
        mask_row = jnp.asarray(mask_np)

        # Token history lives in a device-side buffer updated incrementally —
        # per-token host traffic is O(1) (three scalars up, one down), not a
        # re-upload of the whole history.
        buf = jnp.concatenate(
            [jnp.asarray(input_ids, jnp.int32),
             jnp.full((1, max_new), pad_id, jnp.int32)], axis=1)
        sample_fn = self._jit_stream_sample(
            do_sample, temperature, top_k, top_p, repetition_penalty)

        logits = pre.logits[:, 0, :]
        cache = pre.cache
        filled = l
        t = num_img + bucket       # physical cache slot for the next token
        for step in range(max_new):
            rng, r = jax.random.split(rng)
            tok, buf = sample_fn(r, logits, buf, filled)
            tok_val = int(tok[0])
            filled += 1
            yield tok_val
            if tok_val in eos_set and step + 1 >= min_new:
                return
            with self._trace_context():
                logits, cache, mask_row = step_fn(
                    self.params, cache, tok, t, mask_row, num_img + l + step)
            t += 1

    def _jit_prefill(self, cache_len: int, has_image: bool):
        key = ("prefill", cache_len, has_image)
        fn = self._compiled.get(key)
        if fn is None:
            config = self.config

            def run(params, cache, ids, attn, last_idx, pixel_values=None):
                return model_lib.prefill(params, config, cache, ids,
                                         attention_mask=attn,
                                         pixel_values=pixel_values,
                                         logit_positions=last_idx)

            fn = jax.jit(run, compiler_options=_compiler_options())
            self._compiled[key] = fn
        return fn

    def _jit_step(self):
        """Single decode step; updates the cache-validity mask on device."""
        key = ("step",)
        fn = self._compiled.get(key)
        if fn is None:
            config = self.config

            def run(params, cache, tok, t, mask_row, position):
                t = jnp.asarray(t, jnp.int32)
                mask_row = jax.lax.dynamic_update_slice(
                    mask_row, jnp.ones((1, 1), mask_row.dtype), (0, t))
                logits, cache = model_lib.decode_step(
                    params, config, cache, tok.astype(jnp.int32), t,
                    attn_mask_row=mask_row,
                    positions=jnp.asarray(position, jnp.int32)[None])
                return logits, cache, mask_row

            fn = jax.jit(run, compiler_options=_compiler_options())
            self._compiled[key] = fn
        return fn

    def _jit_stream_sample(self, do_sample, temperature, top_k, top_p,
                           repetition_penalty):
        """Sample + append to the device-side history buffer in one program."""
        key = ("stream_sample", do_sample, temperature, top_k, top_p,
               repetition_penalty)
        fn = self._compiled.get(key)
        if fn is None:

            def run(rng, logits, buf, filled):
                hist_mask = (jnp.arange(buf.shape[1])[None, :]
                             < filled).astype(jnp.float32)
                tok = sampling_ops.sample_token(
                    rng, logits.astype(jnp.float32), do_sample=do_sample,
                    temperature=temperature, top_k=top_k, top_p=top_p,
                    repetition_penalty=repetition_penalty,
                    token_history=buf, history_mask=hist_mask)
                buf = jax.lax.dynamic_update_slice(
                    buf, tok.astype(buf.dtype)[:, None],
                    (0, jnp.asarray(filled, jnp.int32)))
                return tok, buf

            fn = jax.jit(run)
            self._compiled[key] = fn
        return fn
