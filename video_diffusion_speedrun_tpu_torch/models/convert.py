"""JAX parameter trees → the port's state dicts (port of `models/convert.py`).

Carries parameters of the JAX package (`init_dit` trees, checkpoints) into
`models/dit.py:DiT`. The tree arrives as nested dicts of numpy arrays; no
JAX is needed. Linear weights [in, out] transpose to torch's [out, in], the
flat patch kernel [C·pt·p·p, D] reshapes to the Conv3d weight
[D, C, pt, p, p], and the depth-stacked `blocks` leaves split per block.
The result equals the JAX package's `params_to_torch_dit` key for key.

The same for the frozen modules of the text-to-video request: a JAX T5
tree (`text/t5.py`) → transformers' `T5EncoderModel` names
(`t5_state_dict_from_jax_params`), and a JAX Cosmos decoder tree, nested
or as the flat dotted paths of a converted `.npz` → the Cosmos-Tokenizer
names of `models/cosmos_vae.py:CosmosDecoder`
(`cosmos_state_dict_from_jax_params`, through `models/cosmos_layer_map`).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from video_diffusion_speedrun_tpu_torch.core.config import DiTConfig

# JAX tree path (under a block or the root) → state-dict module name
_ROOT_LINEAR = {
    ("time_embed", "fc1"): "time_embed.0",
    ("time_embed", "fc2"): "time_embed.2",
    ("final_modulation",): "final_modulation.1",
    ("final_proj",): "final_proj",
}
_BLOCK_LINEAR = {
    ("qkv",): "qkv",
    ("attn_proj",): "attn_proj",
    ("mlp", "fc1"): "mlp.0",
    ("mlp", "fc2"): "mlp.2",
    ("adaLN_modulation",): "adaLN_modulation.1",
    ("q_cross",): "q_cross",
    ("context_kv",): "context_kv",
    ("cross_proj",): "cross_proj",
}
_NORMS = ("norm1", "norm2", "norm3")


def _get(tree: Mapping[str, Any], path):
    for key in path:
        if key not in tree:
            return None
        tree = tree[key]
    return tree


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a writable copy


def _put_linear(out: Dict[str, torch.Tensor], name: str, leaf, index=None):
    pick = (lambda a: a) if index is None else (lambda a: np.asarray(a)[index])
    out[f"{name}.weight"] = _f32(pick(leaf["weight"]).T)
    if "bias" in leaf:
        out[f"{name}.bias"] = _f32(pick(leaf["bias"]))


def state_dict_from_jax_params(params: Mapping[str, Any],
                               cfg: DiTConfig) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (the JAX tree) → fp32 state dict."""
    d = cfg.hidden_size
    out: Dict[str, torch.Tensor] = {}
    pp = params["patch_proj"]
    out["patch_embed.patch_proj.weight"] = _f32(
        np.asarray(pp["weight"]).T.reshape(d, cfg.in_channels,
                                           cfg.time_patch_size,
                                           cfg.patch_size, cfg.patch_size))
    out["patch_embed.patch_proj.bias"] = _f32(pp["bias"])
    out["register_tokens"] = _f32(params["register_tokens"])
    for path, name in _ROOT_LINEAR.items():
        _put_linear(out, name, _get(params, path))
    if "scale" in params["final_norm"]:
        out["final_norm.weight"] = _f32(params["final_norm"]["scale"])
    if "positional_embedding" in params:
        out["positional_embedding"] = _f32(params["positional_embedding"])

    blocks = params["blocks"]
    for i in range(cfg.depth):
        p = f"blocks.{i}"
        for path, name in _BLOCK_LINEAR.items():
            leaf = _get(blocks, path)
            if leaf is not None:
                _put_linear(out, f"{p}.{name}", leaf, index=i)
        for norm in _NORMS:
            scale = _get(blocks, (norm, "scale"))
            if scale is not None:
                out[f"{p}.{norm}.weight"] = _f32(np.asarray(scale)[i])
        if "lambda_param" in blocks:
            out[f"{p}.lambda_param"] = _f32(np.asarray(blocks["lambda_param"])[i])
    return out


def t5_state_dict_from_jax_params(params: Mapping[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """A JAX T5 tree (`init_t5` / `convert_torch_t5` of the JAX package:
    linears [in, out]) → the fp32 state dict of `text/t5.py:T5Encoder`
    (transformers' names, linears [out, in])."""
    emb = _f32(params["embed"])
    out: Dict[str, torch.Tensor] = {
        "shared.weight": emb, "encoder.embed_tokens.weight": emb,
        "encoder.final_layer_norm.weight": _f32(params["final_ln"])}
    for i, blk in enumerate(params["blocks"]):
        pre = f"encoder.block.{i}.layer"
        out[f"{pre}.0.layer_norm.weight"] = _f32(blk["ln1"])
        out[f"{pre}.1.layer_norm.weight"] = _f32(blk["ln2"])
        for name in ("q", "k", "v", "o"):
            out[f"{pre}.0.SelfAttention.{name}.weight"] = _f32(
                np.asarray(blk[name]).T)
        if "relative_attention_bias" in blk:
            out[f"{pre}.0.SelfAttention.relative_attention_bias.weight"] = \
                _f32(blk["relative_attention_bias"])
        for name in ("wi_0", "wi_1", "wi", "wo"):
            if name in blk:
                out[f"{pre}.1.DenseReluDense.{name}.weight"] = _f32(
                    np.asarray(blk[name]).T)
    return out


def cosmos_state_dict_from_jax_params(params: Mapping[str, Any], cfg
                                      ) -> Dict[str, torch.Tensor]:
    """A JAX Cosmos decoder tree (`init_cosmos_decoder`), nested or as the
    flat dotted paths of a converted `.npz` → the fp32 state dict of
    `CosmosDecoder(cfg)` (`cfg`: a `CosmosDecoderConfig`). Every leaf the
    config has must be present with its JAX shape."""
    from video_diffusion_speedrun_tpu_torch.models import cosmos_layer_map

    flat = dict(cosmos_layer_map.flatten(params))
    n_up = len(cfg.channels_mult)
    out: Dict[str, torch.Tensor] = {}
    for path, shape in cosmos_layer_map.jax_leaf_shapes(cfg).items():
        if path not in flat:
            raise KeyError(f"missing weight: {path}")
        arr = np.asarray(flat[path])
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{path}: shape {tuple(arr.shape)}, the config "
                             f"expects {tuple(shape)}")
        out[cosmos_layer_map.torch_name(path, n_up)] = _f32(
            cosmos_layer_map.to_torch(arr))
    return out
