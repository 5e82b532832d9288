"""Pinned layer map: the JAX decoder's leaf paths ↔ Cosmos-Tokenizer
state-dict names (the port's own copy of `models/cosmos_layer_map.py`).

The JAX package stores the decoder as a tree whose dotted leaf paths
(`mid.block_1.conv1.w`, `up.0.blocks.2.norm1.scale`, …) name the entries
of the `.npz` that `scripts/convert_cosmos.py convert` writes, with conv
kernels in the JAX layout [kt, kh, kw, cin, cout]. The port's decoder
(`models/cosmos_vae.py`) is named after the Cosmos-Tokenizer state dict
itself (`decoder.mid.block_1.conv1.conv3d.weight`, torch layout [cout,
cin, kt, kh, kw], reversed `up` indexing), pinned by
`tests/fixtures/cosmos_decoder_layer_map.json`. This module maps one to
the other, one name per parameter, without JAX.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np

# our leaf suffix → torch parameter suffix, per module kind. Convs: the
# public CausalConv3d wraps an inner nn.Conv3d named `conv3d`; norms: the
# public CausalNormalize wraps an inner nn.GroupNorm named `norm`
_CONV_SUFFIX = {"w": "conv3d.weight", "b": "conv3d.bias"}
_NORM_SUFFIX = {"scale": "norm.weight", "bias": "norm.bias"}
# the JAX attention projection names → Cosmos names
_ATTN_PROJ = {"q": "q", "k": "k", "v": "v", "proj": "proj_out"}


def _conv(prefix: str, kt: int, kh: int, kw: int, cin: int, cout: int
          ) -> Iterator[Tuple[str, Tuple[int, ...]]]:
    yield f"{prefix}.w", (kt, kh, kw, cin, cout)
    yield f"{prefix}.b", (cout,)


def _norm(prefix: str, c: int) -> Iterator[Tuple[str, Tuple[int, ...]]]:
    yield f"{prefix}.scale", (c,)
    yield f"{prefix}.bias", (c,)


def _resblock(prefix: str, cin: int, cout: int):
    yield from _norm(f"{prefix}.norm1", cin)
    yield from _conv(f"{prefix}.conv1", 3, 3, 3, cin, cout)
    yield from _norm(f"{prefix}.norm2", cout)
    yield from _conv(f"{prefix}.conv2", 3, 3, 3, cout, cout)
    if cin != cout:
        yield from _conv(f"{prefix}.nin_shortcut", 1, 1, 1, cin, cout)


def _attn(prefix: str, c: int):
    yield from _norm(f"{prefix}.norm", c)
    for proj in ("q", "k", "v", "proj"):
        yield from _conv(f"{prefix}.{proj}", 1, 1, 1, c, c)


def jax_leaf_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """{JAX leaf path: JAX shape} of `init_cosmos_decoder(cfg)`, computed
    from the config (`cfg`: a `CosmosDecoderConfig`)."""
    block_in = cfg.channels * cfg.channels_mult[-1]
    out: Dict[str, Tuple[int, ...]] = dict(
        _conv("conv_in", 3, 3, 3, cfg.z_channels, block_in))
    out.update(_resblock("mid.block_1", block_in, block_in))
    out.update(_resblock("mid.block_2", block_in, block_in))
    if cfg.attn_bottleneck:
        out.update(_attn("mid.attn_spatial", block_in))
        out.update(_attn("mid.attn_temporal", block_in))
    cin = block_in
    for level, mult in enumerate(reversed(cfg.channels_mult)):
        cout = cfg.channels * mult
        for j in range(cfg.num_res_blocks + 1):
            out.update(_resblock(f"up.{level}.blocks.{j}", cin, cout))
            cin = cout
        if has_upsample(cfg, level):
            out.update(_conv(f"up.{level}.upsample.conv", 3, 3, 3, cout, cout))
    c0 = cfg.channels * cfg.channels_mult[0]
    out.update(_norm("norm_out", c0))
    out.update(_conv("conv_out", 3, 3, 3, c0, cfg.out_channels))
    return out


def has_upsample(cfg, level: int) -> bool:
    """Whether up-level `level` (deepest first, the JAX order) upsamples."""
    return level < len(cfg.temporal_up) and (
        cfg.temporal_up[level] or cfg.spatial_up[level])


def torch_name(our: str, n_up_levels: int) -> str:
    """Deterministic torch state-dict name for one JAX leaf path."""
    parts = our.split(".")
    # up-level renumbering: JAX lists deepest-first (processing order); the
    # torch decoder indexes up[0] = shallowest and iterates reversed
    if parts[0] == "up":
        parts[1] = str(n_up_levels - 1 - int(parts[1]))
        if parts[2] == "blocks":
            parts[2] = "block"
    # bottleneck attention: nn.Sequential(spatial, temporal) = attn_1.{0,1}
    if len(parts) >= 2 and parts[0] == "mid":
        if parts[1] == "attn_spatial":
            parts[1] = "attn_1.0"
        elif parts[1] == "attn_temporal":
            parts[1] = "attn_1.1"
        if parts[1].startswith("attn_1") and parts[2] in _ATTN_PROJ:
            parts[2] = _ATTN_PROJ[parts[2]]
    leaf = parts[-1]
    mod = parts[-2] if len(parts) >= 2 else ""
    if leaf in _CONV_SUFFIX and not mod.startswith("norm"):
        parts[-1] = _CONV_SUFFIX[leaf]
    elif leaf in _NORM_SUFFIX:
        parts[-1] = _NORM_SUFFIX[leaf]
    return "decoder." + ".".join(parts)


def torch_shape(our_leaf_shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """Torch shape of a JAX leaf (conv kernels [kt, kh, kw, I, O] → [O, I,
    kt, kh, kw])."""
    if len(our_leaf_shape) == 5:
        kt, kh, kw, ci, co = our_leaf_shape
        return (co, ci, kt, kh, kw)
    return tuple(our_leaf_shape)


def from_torch(arr: np.ndarray) -> np.ndarray:
    """Torch layout → JAX layout."""
    return arr.transpose(2, 3, 4, 1, 0) if arr.ndim == 5 else arr


def to_torch(arr: np.ndarray) -> np.ndarray:
    """JAX layout → torch layout."""
    return arr.transpose(4, 3, 0, 1, 2) if arr.ndim == 5 else arr


def expected_map(cfg) -> Dict[str, Dict]:
    """{JAX leaf path: {"torch": name, "torch_shape": [...], "ours":
    [...]}} for every parameter of the decoder (the fixture's format)."""
    n_up = len(cfg.channels_mult)
    return {path: {"torch": torch_name(path, n_up),
                   "torch_shape": list(torch_shape(shape)),
                   "ours": list(shape)}
            for path, shape in sorted(jax_leaf_shapes(cfg).items())}


def flatten(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """Dotted leaf paths of a nested dict/list tree (a flat dict of dotted
    paths flattens to itself)."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from flatten(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten(v, f"{prefix}.{i}")
    else:
        yield prefix, tree
