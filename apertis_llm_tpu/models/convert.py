"""Checkpoint interop with the PyTorch reference.

Converts a reference ``pytorch_model.bin`` state_dict (key layout from
src/model/core.py module tree) into this framework's stacked-layer param
pytree, and back. Linear weights transpose (out, in) -> (in, out); per-layer
tensors are stacked along a leading depth axis; expert MLPs are stacked along
a leading expert axis.

torch is imported lazily — it is only needed when actually touching torch
checkpoints.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Mapping

import numpy as np
import jax.numpy as jnp

from apertis_llm_tpu.config import ApertisConfig

logger = logging.getLogger(__name__)

Params = Dict[str, Any]


def load_torch_state_dict(path: str | os.PathLike) -> Dict[str, np.ndarray]:
    """Load a torch checkpoint file into numpy arrays (CPU, float unchanged)."""
    import torch

    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


def _t(a: np.ndarray) -> jnp.ndarray:
    """Torch linear weight (out, in) -> (in, out)."""
    return jnp.asarray(a.T)


def _a(a: np.ndarray) -> jnp.ndarray:
    return jnp.asarray(a)


def _norm_params(sd: Mapping[str, np.ndarray], prefix: str) -> Params:
    if f"{prefix}.scale" in sd:  # RMSNorm
        return {"scale": _a(sd[f"{prefix}.scale"])}
    return {"w": _a(sd[f"{prefix}.weight"]), "b": _a(sd[f"{prefix}.bias"])}


def _linear_params(sd: Mapping[str, np.ndarray], prefix: str) -> Params:
    p = {"w": _t(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        p["b"] = _a(sd[f"{prefix}.bias"])
    return p


def _attn_layer(sd: Mapping[str, np.ndarray], i: int, config: ApertisConfig) -> Params:
    pre = f"model.layers.{i}.attention"
    p: Params = {"pre_norm": _norm_params(sd, f"{pre}.pre_norm")}
    if config.attention_type == "selective_ssm":
        impl = f"{pre}.attention_mechanism_impl"
        p["in_proj_x"] = _linear_params(sd, f"{impl}.in_proj_x")
        p["in_proj_z"] = _linear_params(sd, f"{impl}.in_proj_z")
        p["conv"] = {
            "w": _a(sd[f"{impl}.conv1d.weight"][:, 0, :]),  # (C,1,K) -> (C,K)
            "b": _a(sd[f"{impl}.conv1d.bias"]),
        }
        p["x_param_proj"] = _linear_params(sd, f"{impl}.x_param_proj")
        p["dt_proj"] = _linear_params(sd, f"{impl}.dt_proj_head")
        p["A_log"] = _a(sd[f"{impl}.A_log"])
        p["D"] = _a(sd[f"{impl}.D"])
        p["out_proj"] = _linear_params(sd, f"{impl}.out_proj")
    else:
        p["q"] = _linear_params(sd, f"{pre}.q_proj")
        p["k"] = _linear_params(sd, f"{pre}.k_proj")
        p["v"] = _linear_params(sd, f"{pre}.v_proj")
        p["o"] = _linear_params(sd, f"{pre}.out_proj")
    return p


def _ffn_layer(sd: Mapping[str, np.ndarray], i: int, config: ApertisConfig) -> Params:
    pre = f"model.layers.{i}.feed_forward"
    p: Params = {"pre_norm": _norm_params(sd, f"{pre}.pre_norm")}
    if config.use_swiglu:
        p["w_gate"] = _linear_params(sd, f"{pre}.ffn.w_gate")
        p["w_up"] = _linear_params(sd, f"{pre}.ffn.w_up")
        p["w_down"] = _linear_params(sd, f"{pre}.ffn.w_down")
    elif config.use_expert_system and config.num_experts > 0:
        p["router_ln"] = {
            "w": _a(sd[f"{pre}.ffn.router_norm.weight"]),
            "b": _a(sd[f"{pre}.ffn.router_norm.bias"]),
        }
        p["router"] = _linear_params(sd, f"{pre}.ffn.router")
        if f"{pre}.ffn.w_noise" in sd:
            p["w_noise"] = _a(sd[f"{pre}.ffn.w_noise"])
        e = config.num_experts
        # Expert Sequential indices: 0 LayerNorm, 1 Linear(H->I), 4 Linear(I->H).
        p["experts"] = {
            "ln_w": jnp.stack([_a(sd[f"{pre}.ffn.experts.{j}.0.weight"]) for j in range(e)]),
            "ln_b": jnp.stack([_a(sd[f"{pre}.ffn.experts.{j}.0.bias"]) for j in range(e)]),
            "w1": jnp.stack([_t(sd[f"{pre}.ffn.experts.{j}.1.weight"]) for j in range(e)]),
            "b1": jnp.stack([_a(sd[f"{pre}.ffn.experts.{j}.1.bias"]) for j in range(e)]),
            "w2": jnp.stack([_t(sd[f"{pre}.ffn.experts.{j}.4.weight"]) for j in range(e)]),
            "b2": jnp.stack([_a(sd[f"{pre}.ffn.experts.{j}.4.bias"]) for j in range(e)]),
        }
    else:
        # Dense FFN Sequential indices: 0 Linear(H->I), 3 Linear(I->H).
        p["w1"] = _linear_params(sd, f"{pre}.ffn.0")
        p["w2"] = _linear_params(sd, f"{pre}.ffn.3")
    return p


def _vision(sd: Mapping[str, np.ndarray], config: ApertisConfig) -> Params:
    pre = "model.multimodal_encoder"
    dv = config.vision_embed_dim
    layers = []
    for i in range(config.vision_layers):
        lp = f"{pre}.vision_layers.{i}"
        layers.append({
            "ln1": {"w": _a(sd[f"{lp}.norm1.weight"]), "b": _a(sd[f"{lp}.norm1.bias"])},
            "in_proj_w": _t(sd[f"{lp}.self_attn.in_proj_weight"]),
            "in_proj_b": _a(sd[f"{lp}.self_attn.in_proj_bias"]),
            "attn_out": _linear_params(sd, f"{lp}.self_attn.out_proj"),
            "ln2": {"w": _a(sd[f"{lp}.norm2.weight"]), "b": _a(sd[f"{lp}.norm2.bias"])},
            "linear1": _linear_params(sd, f"{lp}.linear1"),
            "linear2": _linear_params(sd, f"{lp}.linear2"),
        })
    import jax

    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *layers)
    pw = sd[f"{pre}.patch_embed.weight"]  # (Dv, 3, P, P)
    return {
        "patch_embed": {
            "w": jnp.asarray(pw.reshape(dv, -1).T),
            "b": _a(sd[f"{pre}.patch_embed.bias"]),
        },
        "cls_token": _a(sd[f"{pre}.cls_token"]),
        "pos_embed": _a(sd[f"{pre}.vision_pos_embed"]),
        "layers": stacked,
        "final_ln": {"w": _a(sd[f"{pre}.vision_ln.weight"]),
                     "b": _a(sd[f"{pre}.vision_ln.bias"])},
    }


def from_torch_state_dict(sd: Mapping[str, np.ndarray], config: ApertisConfig) -> Params:
    """Convert a reference state_dict into this framework's param tree."""
    import jax

    params: Params = {"embed": {"tok": _a(sd["model.token_embeddings.weight"])}}
    if config.position_embedding_type == "absolute" and "model.abs_pos_embeddings.weight" in sd:
        params["abs_pos"] = {"emb": _a(sd["model.abs_pos_embeddings.weight"])}
    if config.multimodal and "model.multimodal_encoder.patch_embed.weight" in sd:
        params["vision"] = _vision(sd, config)
        if "model.vision_projection.weight" in sd:
            params["vision_proj"] = _linear_params(sd, "model.vision_projection")

    per_layer = [
        {"attn": _attn_layer(sd, i, config), "ffn": _ffn_layer(sd, i, config)}
        for i in range(config.num_hidden_layers)
    ]
    params["layers"] = jax.tree.map(lambda *xs: jnp.stack(xs), *per_layer)
    params["final_norm"] = _norm_params(sd, "model.final_post_norm")
    if not config.tie_word_embeddings and "lm_head.weight" in sd:
        params["lm_head"] = {"w": _t(sd["lm_head.weight"])}
    return params


def infer_config_from_state_dict(sd: Mapping[str, np.ndarray]) -> ApertisConfig:
    """Shape-sniff a config from a bare state_dict (no config.json).

    Covers the reference's heuristics (interface.py:280-341) and extends them
    to detect the selective-SSM mixer, SwiGLU, RMSNorm, expert count, and true
    intermediate size from weight shapes — the reference guesses MHA/4h.
    """
    def shape(key):
        return sd[key].shape if key in sd else None

    vocab_size, hidden_size = 32000, 768
    if (s := shape("model.token_embeddings.weight")) is not None:
        vocab_size, hidden_size = int(s[0]), int(s[1])
    elif (s := shape("lm_head.weight")) is not None:
        vocab_size, hidden_size = int(s[0]), int(s[1])

    layer_ids = set()
    for k in sd:
        if k.startswith("model.layers."):
            parts = k.split(".")
            if len(parts) > 2 and parts[2].isdigit():
                layer_ids.add(int(parts[2]))
    num_layers = len(layer_ids) if layer_ids else 12

    is_ssm = any(".attention_mechanism_impl." in k for k in sd)
    use_rmsnorm = "model.final_post_norm.scale" in sd
    use_swiglu = any(".ffn.w_gate." in k for k in sd)
    use_expert_system = any(".ffn.experts." in k for k in sd)

    num_attention_heads = hidden_size // 64 if hidden_size % 64 == 0 else 12
    if hidden_size % num_attention_heads != 0:
        for i in range(num_attention_heads, 0, -1):
            if hidden_size % i == 0:
                num_attention_heads = i
                break

    cfg: Dict[str, Any] = dict(
        vocab_size=vocab_size, hidden_size=hidden_size,
        num_hidden_layers=num_layers,
        num_attention_heads=num_attention_heads,
        use_rmsnorm=use_rmsnorm, use_swiglu=use_swiglu,
        multimodal=any("multimodal_encoder" in k or "vision_projection" in k
                       for k in sd),
    )

    if is_ssm:
        cfg["attention_type"] = "selective_ssm"
        a_log = shape("model.layers.0.attention.attention_mechanism_impl.A_log")
        if a_log is not None:
            cfg["num_attention_heads"] = int(a_log[0])
            cfg["ssm_d_state"] = int(a_log[1])
        dt = shape("model.layers.0.attention.attention_mechanism_impl.dt_proj_head.weight")
        if dt is not None:
            cfg["ssm_dt_rank"] = int(dt[1])
        conv = shape("model.layers.0.attention.attention_mechanism_impl.conv1d.weight")
        if conv is not None:
            cfg["ssm_conv_kernel"] = int(conv[2])

    inter = None
    for key in ("model.layers.0.feed_forward.ffn.0.weight",
                "model.layers.0.feed_forward.ffn.experts.0.1.weight"):
        if (s := shape(key)) is not None:
            inter = int(s[0])
            break
    cfg["intermediate_size"] = inter if inter is not None else hidden_size * 4

    if use_expert_system:
        experts = set()
        for k in sd:
            if ".ffn.experts." in k:
                experts.add(int(k.split(".ffn.experts.")[1].split(".")[0]))
        cfg["use_expert_system"] = True
        cfg["num_experts"] = len(experts) or 8
        cfg["use_noisy_top_k_routing"] = any(".ffn.w_noise" in k for k in sd)

    vis = shape("model.multimodal_encoder.patch_embed.weight")
    if vis is not None:
        cfg["vision_embed_dim"] = int(vis[0])
        cfg["vision_patch_size"] = int(vis[2])
        vlayers = set()
        for k in sd:
            if ".vision_layers." in k:
                vlayers.add(int(k.split(".vision_layers.")[1].split(".")[0]))
        cfg["vision_layers"] = len(vlayers) or 12
        pos = shape("model.multimodal_encoder.vision_pos_embed")
        if pos is not None:
            patches = int(pos[1]) - 1
            cfg["image_size"] = int(round(patches ** 0.5)) * cfg["vision_patch_size"]

    logger.info("Inferred config from state_dict: %s", cfg)
    return ApertisConfig.from_dict(cfg)


NPZ_WEIGHTS = "model.npz"


def load_pretrained(model_dir: str | os.PathLike):
    """Load (config, params) from a reference-format checkpoint: a directory
    with ``config.json`` + ``pytorch_model.bin``/``model.pt``/``model.npz``,
    or a bare weights file (config is then shape-sniffed from the
    state_dict). ``model.npz`` holds the same state dict as numpy arrays and
    needs no torch."""
    from pathlib import Path

    model_dir = Path(model_dir)
    if model_dir.is_file():
        ckpt, config_dir = model_dir, model_dir.parent
    else:
        config_dir = model_dir
        for name in ("pytorch_model.bin", "model.pt", NPZ_WEIGHTS):
            if (model_dir / name).exists():
                ckpt = model_dir / name
                break
        else:
            raise FileNotFoundError(
                f"No pytorch_model.bin/model.pt/{NPZ_WEIGHTS} under {model_dir}")
    if ckpt.suffix == ".npz":
        with np.load(ckpt) as data:
            sd = {k: data[k] for k in data.files}
    else:
        sd = load_torch_state_dict(ckpt)
    if (config_dir / "config.json").exists():
        config = ApertisConfig.from_pretrained(config_dir)
    else:
        config = infer_config_from_state_dict(sd)
    return config, from_torch_state_dict(sd, config)


# ---------------------------------------------------------------------------
# export: params -> torch state_dict (for interop with reference tooling)
# ---------------------------------------------------------------------------

def to_torch_state_dict(params: Params, config: ApertisConfig) -> Dict[str, np.ndarray]:
    import jax

    sd: Dict[str, np.ndarray] = {}

    def put(key, val, transpose=False):
        arr = np.asarray(val, dtype=np.float32)
        sd[key] = arr.T.copy() if transpose else arr

    def put_norm(prefix, p):
        if "scale" in p:
            put(f"{prefix}.scale", p["scale"])
        else:
            put(f"{prefix}.weight", p["w"])
            put(f"{prefix}.bias", p["b"])

    def put_linear(prefix, p):
        put(f"{prefix}.weight", p["w"], transpose=True)
        if "b" in p:
            put(f"{prefix}.bias", p["b"])

    put("model.token_embeddings.weight", params["embed"]["tok"])
    if "abs_pos" in params:
        put("model.abs_pos_embeddings.weight", params["abs_pos"]["emb"])

    for i in range(config.num_hidden_layers):
        lp = jax.tree.map(lambda x, i=i: x[i], params["layers"])
        a, f = lp["attn"], lp["ffn"]
        pre = f"model.layers.{i}.attention"
        put_norm(f"{pre}.pre_norm", a["pre_norm"])
        if config.attention_type == "selective_ssm":
            impl = f"{pre}.attention_mechanism_impl"
            put_linear(f"{impl}.in_proj_x", a["in_proj_x"])
            put_linear(f"{impl}.in_proj_z", a["in_proj_z"])
            put(f"{impl}.conv1d.weight", np.asarray(a["conv"]["w"])[:, None, :])
            put(f"{impl}.conv1d.bias", a["conv"]["b"])
            put_linear(f"{impl}.x_param_proj", a["x_param_proj"])
            put_linear(f"{impl}.dt_proj_head", a["dt_proj"])
            put(f"{impl}.A_log", a["A_log"])
            put(f"{impl}.D", a["D"])
            put_linear(f"{impl}.out_proj", a["out_proj"])
        else:
            put_linear(f"{pre}.q_proj", a["q"])
            put_linear(f"{pre}.k_proj", a["k"])
            put_linear(f"{pre}.v_proj", a["v"])
            put_linear(f"{pre}.out_proj", a["o"])
        pre = f"model.layers.{i}.feed_forward"
        put_norm(f"{pre}.pre_norm", f["pre_norm"])
        if config.use_swiglu:
            put_linear(f"{pre}.ffn.w_gate", f["w_gate"])
            put_linear(f"{pre}.ffn.w_up", f["w_up"])
            put_linear(f"{pre}.ffn.w_down", f["w_down"])
        elif config.use_expert_system and config.num_experts > 0:
            put(f"{pre}.ffn.router_norm.weight", f["router_ln"]["w"])
            put(f"{pre}.ffn.router_norm.bias", f["router_ln"]["b"])
            put_linear(f"{pre}.ffn.router", f["router"])
            if "w_noise" in f:
                put(f"{pre}.ffn.w_noise", f["w_noise"])
            ex = f["experts"]
            for j in range(config.num_experts):
                put(f"{pre}.ffn.experts.{j}.0.weight", ex["ln_w"][j])
                put(f"{pre}.ffn.experts.{j}.0.bias", ex["ln_b"][j])
                put(f"{pre}.ffn.experts.{j}.1.weight", ex["w1"][j], transpose=True)
                put(f"{pre}.ffn.experts.{j}.1.bias", ex["b1"][j])
                put(f"{pre}.ffn.experts.{j}.4.weight", ex["w2"][j], transpose=True)
                put(f"{pre}.ffn.experts.{j}.4.bias", ex["b2"][j])
        else:
            put_linear(f"{pre}.ffn.0", f["w1"])
            put_linear(f"{pre}.ffn.3", f["w2"])

    put_norm("model.final_post_norm", params["final_norm"])
    if "lm_head" in params:
        put_linear("lm_head", params["lm_head"])
    else:
        put("lm_head.weight", params["embed"]["tok"])  # tied

    if "vision" in params:
        v = params["vision"]
        pre = "model.multimodal_encoder"
        dv = config.vision_embed_dim
        p = config.vision_patch_size
        put(f"{pre}.patch_embed.weight",
            np.asarray(v["patch_embed"]["w"]).T.reshape(dv, 3, p, p))
        put(f"{pre}.patch_embed.bias", v["patch_embed"]["b"])
        put(f"{pre}.cls_token", v["cls_token"])
        put(f"{pre}.vision_pos_embed", v["pos_embed"])
        for i in range(config.vision_layers):
            vl = jax.tree.map(lambda x, i=i: x[i], v["layers"])
            lp = f"{pre}.vision_layers.{i}"
            put(f"{lp}.norm1.weight", vl["ln1"]["w"])
            put(f"{lp}.norm1.bias", vl["ln1"]["b"])
            put(f"{lp}.self_attn.in_proj_weight", vl["in_proj_w"], transpose=True)
            put(f"{lp}.self_attn.in_proj_bias", vl["in_proj_b"])
            put_linear(f"{lp}.self_attn.out_proj", vl["attn_out"])
            put(f"{lp}.norm2.weight", vl["ln2"]["w"])
            put(f"{lp}.norm2.bias", vl["ln2"]["b"])
            put_linear(f"{lp}.linear1", vl["linear1"])
            put_linear(f"{lp}.linear2", vl["linear2"])
        put(f"{pre}.vision_ln.weight", v["final_ln"]["w"])
        put(f"{pre}.vision_ln.bias", v["final_ln"]["b"])
        if "vision_proj" in params:
            put_linear("model.vision_projection", params["vision_proj"])
    return sd


def save_torch_checkpoint(params: Params, config: ApertisConfig, save_directory,
                          filename: str = "pytorch_model.bin") -> None:
    """Write a reference-compatible checkpoint (weights + config.json)."""
    import torch
    from pathlib import Path

    save_directory = Path(save_directory)
    save_directory.mkdir(parents=True, exist_ok=True)
    sd = {k: torch.from_numpy(np.array(v, copy=True))
          for k, v in to_torch_state_dict(params, config).items()}
    torch.save(sd, save_directory / filename)
    config.save_pretrained(save_directory)


def save_pretrained_weights(params: Params, config: ApertisConfig,
                            save_directory) -> None:
    """Write the weights in the reference's state-dict layout plus
    ``config.json``: ``pytorch_model.bin`` when torch imports (loadable by
    the PyTorch reference), else ``model.npz`` (loadable by
    :func:`load_pretrained`)."""
    try:
        import torch  # noqa: F401
    except ImportError:
        from pathlib import Path

        save_directory = Path(save_directory)
        save_directory.mkdir(parents=True, exist_ok=True)
        np.savez(save_directory / NPZ_WEIGHTS,
                 **to_torch_state_dict(params, config))
        config.save_pretrained(save_directory)
        return
    save_torch_checkpoint(params, config, save_directory)
