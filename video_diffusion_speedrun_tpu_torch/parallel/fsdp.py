"""FSDP2 / HSDP / tensor-parallel placement of the DiT and of T5 (port of
`parallel/fsdp.py`).

The JAX package gives every parameter leaf a `PartitionSpec` over the
(replica, fsdp, context, tensor) mesh and lets GSPMD insert the
collectives. The port places the same leaves with the same rule and runs
the collectives itself:

- the tensor axis: a parameter sharded over `tensor` becomes a DTensor
  over the mesh's tensor sub-mesh, and the DiT block computes on its local
  shard (Megatron-style: `models/dit.py`, with the region operators of
  `parallel/collectives.py`);
- the fsdp axis: FSDP2's `fully_shard` on each `DiTBlock` and then on the
  root, over the ("replica", "fsdp") sub-mesh (HSDP: sharded over fsdp,
  replicated over replica) or ("fsdp",) alone, with the fsdp dim of each
  parameter picked by `shard_placement_fn`. Parameters stay fp32 in the
  all-gather and the reduce-scatter, as the unsharded step computes;
- leaves JAX replicates over fsdp (below 2¹⁶ elements, or with no
  divisible dim) are `ignored_params` of FSDP2: the train step reduces
  their gradients itself (`train/step.py`).

The rule (`param_placements`, the JAX `param_pspec` translated to torch's
[out, in] layout): the column-parallel kernels (`qkv`, `q_cross`,
`context_kv`, `adaLN_modulation.1`, `mlp.0`) put their out dim (torch dim
0) on `tensor` and their in dim (dim 1) on `fsdp`; the row-parallel ones
(`attn_proj`, `cross_proj`, `mlp.2`) their in dim on `tensor` and their
out dim on `fsdp`; an axis goes only where it divides the dim, and with no
tensor axis the out dim takes fsdp when the in dim cannot. Every other
leaf of at least 2¹⁶ elements goes to `fsdp` on its largest divisible dim;
smaller leaves replicate. JAX stacks the blocks (`[depth, …]`), so the
rule reads the size of the stacked leaf and skips its depth dim.

Two layouts differ from JAX's while the axes do not:

- `qkv` and `context_kv` pack their out dim as (3, heads, head_dim) and
  (2, heads, head_dim). A tensor rank holds q, k and v of the same heads:
  the `_StridedShard(0, split_factor=3)` (2) placement, so the global
  tensor keeps the canonical order, names and shapes. GSPMD, which splits
  the packed dim in contiguous blocks, moves the rows where they are
  needed instead;
- the column-parallel biases (`qkv`, `q_cross`, `context_kv`, `mlp.0`;
  replicated or fsdp-sharded by the generic rule, as in JAX) stay whole
  on every tensor rank: the block takes its local columns, and the step
  sums their gradient over `tensor`, as it does λ's (used on the local
  heads' v).

DCP cannot place a `_StridedShard` chunk (it would be rows scattered over
the tensor), so a checkpoint holds those leaves whole
(`checkpoint_state`) and a restore copies each rank's rows back
(`restore_state`); every other sharded leaf stays a DTensor, which DCP
reshards to any mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Shard

from video_diffusion_speedrun_tpu_torch.parallel import mesh as pmesh

_AXIS_FSDP, _AXIS_TENSOR = pmesh.AXIS_FSDP, pmesh.AXIS_TENSOR

# block module → (axis of the in dim, axis of the out dim), JAX's
# `_BLOCK_KERNEL_SPECS` under the port's module names
_BLOCK_KERNEL_SPECS = {
    "qkv": (_AXIS_FSDP, _AXIS_TENSOR),
    "q_cross": (_AXIS_FSDP, _AXIS_TENSOR),
    "context_kv": (_AXIS_FSDP, _AXIS_TENSOR),
    "adaLN_modulation.1": (_AXIS_FSDP, _AXIS_TENSOR),
    "attn_proj": (_AXIS_TENSOR, _AXIS_FSDP),
    "cross_proj": (_AXIS_TENSOR, _AXIS_FSDP),
    "mlp.0": (_AXIS_FSDP, _AXIS_TENSOR),
    "mlp.2": (_AXIS_TENSOR, _AXIS_FSDP),
}
# packed out dims: (parts, heads, head_dim)
_PACKED = {"qkv": 3, "context_kv": 2}
# column-parallel biases the block slices to its local columns
COLUMN_BIASES = ("qkv", "q_cross", "context_kv", "mlp.0")

# leaves below this element count (of the JAX leaf, blocks stacked)
# replicate (`_MIN_SHARD_ELEMS` of the JAX rule)
_MIN_SHARD_ELEMS = 1 << 16


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one parameter's dims go: `fsdp` and `tensor` are torch dims
    (None: replicated over that axis); `split` > 1 marks a packed out dim
    of that many parts, split per part over `tensor`."""

    fsdp: Optional[int] = None
    tensor: Optional[int] = None
    split: int = 1


def _sizes(mesh) -> Dict[str, int]:
    """{"fsdp", "tensor"} axis sizes of a DeviceMesh (or None) or a dict."""
    if isinstance(mesh, dict):
        return {a: mesh.get(a, 1) for a in (_AXIS_FSDP, _AXIS_TENSOR)}
    return {a: pmesh.axis_size(mesh, a) for a in (_AXIS_FSDP, _AXIS_TENSOR)}


def _divisible(n: int, size: int) -> bool:
    return size > 1 and n % size == 0


def _jax_leaf(name: str, shape: Tuple[int, ...]):
    """The JAX leaf of a port parameter: (its shape without the depth dim,
    JAX dim → torch dim or None). Linear weights are [in, out] in JAX; the
    patch kernel is [C·pt·p·p, D]."""
    if name == "patch_embed.patch_proj.weight":
        d, rest = shape[0], shape[1:]
        flat = 1
        for n in rest:
            flat *= n
        return (flat, d), {0: 1, 1: 0}
    if len(shape) == 2:
        return (shape[1], shape[0]), {0: 1, 1: 0}
    return tuple(shape), {i: i for i in range(len(shape))}


def param_placements(name: str, shape: Tuple[int, ...], mesh,
                     depth: int = 1) -> Placement:
    """The placement of the port parameter `name` of torch shape `shape`
    on `mesh` (a DeviceMesh or {"fsdp", "tensor"} sizes): JAX
    `param_pspec` of the leaf it maps to (blocks stacked `depth` deep).
    Pure Python."""
    sizes = _sizes(mesh)
    fsdp = sizes[_AXIS_FSDP]
    jshape, to_torch = _jax_leaf(name, tuple(shape))
    stacked = name.startswith("blocks.")
    module = name.split(".", 2)[2].rsplit(".", 1)[0] if stacked else None
    axis_dim: Dict[str, int] = {}  # axis → JAX dim (depth excluded)

    if (stacked and module in _BLOCK_KERNEL_SPECS and name.endswith(".weight")
            and len(jshape) == 2):
        a_in, a_out = _BLOCK_KERNEL_SPECS[module]
        if _divisible(jshape[0], sizes[a_in]):
            axis_dim[a_in] = 0
        if _divisible(jshape[1], sizes[a_out]):
            axis_dim[a_out] = 1
        if not axis_dim and _divisible(jshape[1], fsdp):
            axis_dim[_AXIS_FSDP] = 1
    else:
        numel = depth if stacked else 1
        for n in jshape:
            numel *= n
        if numel >= _MIN_SHARD_ELEMS:
            cands = [(jshape[d], d) for d in range(len(jshape))
                     if _divisible(jshape[d], fsdp)]
            if cands:
                axis_dim[_AXIS_FSDP] = max(cands)[1]

    def torch_dim(axis):
        d = axis_dim.get(axis)
        return None if d is None else to_torch[d]

    f, t = torch_dim(_AXIS_FSDP), torch_dim(_AXIS_TENSOR)
    if name == "patch_embed.patch_proj.weight" and f == 1 and \
            shape[1] % fsdp:
        f = None  # the flat kernel dim splits only where C does
    split = _PACKED.get(module, 1) if t == 0 else 1
    return Placement(fsdp=f, tensor=t, split=split)


# ------------------------------------------------------------ tensor shards


def tensor_slice(full: torch.Tensor, dim: int, split: int, size: int,
                 rank: int) -> torch.Tensor:
    """Rank `rank`'s part of `full` along `dim` over `size` ranks; a packed
    dim (`split` parts) gives each rank its rows of every part."""
    if split == 1:
        return full.chunk(size, dim)[rank]
    rows = full.reshape(split, size, -1, *full.shape[1:])
    return rows[:, rank].reshape(-1, *full.shape[1:])


def tensor_join(parts, dim: int, split: int) -> torch.Tensor:
    """The inverse of `tensor_slice` over all ranks' parts, in rank order."""
    if split == 1:
        return torch.cat(list(parts), dim)
    rows = [p.reshape(split, -1, *p.shape[1:]) for p in parts]
    full = torch.stack(rows, dim=1)
    return full.reshape(-1, *full.shape[3:])


@dataclasses.dataclass
class TensorRegion:
    """This rank's place on the tensor axis: the block computes on
    1/size of the heads and MLP columns."""

    group: object
    size: int
    rank: int

    def columns(self, bias: torch.Tensor, split: int = 1) -> torch.Tensor:
        """This rank's columns of a whole column-parallel bias."""
        return tensor_slice(bias, 0, split, self.size, self.rank)


def _strided(dim: int, split: int):
    if split == 1:
        return Shard(dim)
    from torch.distributed.tensor.placement_types import _StridedShard

    return _StridedShard(dim, split_factor=split)


# ---------------------------------------------------------------- sharding


@dataclasses.dataclass
class ModelSharding:
    """What `shard_model` did, for the step and the checkpoints: each
    parameter's `Placement`, which are FSDP2's (their gradients come out of
    backward reduce-scattered and averaged over the data shards), which
    need a sum over the tensor group, and the groups."""

    placements: Dict[str, Placement]
    fsdp_managed: frozenset
    tensor_partial: frozenset
    fsdp_group: object
    tensor_group: object
    region: Optional[TensorRegion]
    # HSDP: the group of this rank's replicas (None: one replica)
    replica_group: object = None

    def gathered(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of parameter `name` (or a moment of it) from
        its local shard: all-gathered over fsdp, then over tensor (every
        rank of both groups takes part)."""
        pl = self.placements[name]
        x = (t.to_local() if isinstance(t, DTensor) else t).detach()
        for group, dim, split in ((self.fsdp_group, pl.fsdp, 1),
                                  (self.tensor_group, pl.tensor, pl.split)):
            if dim is None or group is None:
                continue
            parts = [torch.empty_like(x)
                     for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, x.contiguous(), group=group)
            x = tensor_join(parts, dim, split)
        return x

    def local_of(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the whole tensor `full` of `name`."""
        pl = self.placements[name]
        x = full
        if pl.tensor is not None and self.region is not None:
            x = tensor_slice(x, pl.tensor, pl.split, self.region.size,
                             self.region.rank)
        if pl.fsdp is not None and self.fsdp_group is not None:
            x = x.chunk(dist.get_world_size(self.fsdp_group),
                        pl.fsdp)[dist.get_rank(self.fsdp_group)]
        return x

    def is_strided(self, name: str) -> bool:
        pl = self.placements.get(name)
        return (pl is not None and pl.split > 1 and pl.tensor is not None
                and self.region is not None)


def _owner(model: nn.Module, name: str):
    prefix, _, leaf = name.rpartition(".")
    return (model.get_submodule(prefix) if prefix else model), leaf


def shard_model(model: nn.Module, mesh) -> Optional[ModelSharding]:
    """Place the DiT `model` on `mesh` in place (see the module docstring):
    the tensor axis as DTensors over the tensor sub-mesh and each block's
    `TensorRegion`, then `fully_shard` per `DiTBlock` and on the root when
    fsdp > 1. Returns the `ModelSharding` (also `model.sharding`), or None
    on no mesh."""
    if mesh is None:
        return None
    cfg = model.cfg
    sizes = _sizes(mesh)
    tensor = sizes[_AXIS_TENSOR]
    if tensor > 1 and (cfg.num_heads % tensor or cfg.mlp_hidden % tensor):
        raise ValueError(
            f"tensor axis {tensor} must divide the heads ({cfg.num_heads}) "
            f"and the MLP width ({cfg.mlp_hidden})")
    named = dict(model.named_parameters())
    plan = {n: param_placements(n, tuple(p.shape), sizes, cfg.depth)
            for n, p in named.items()}

    region = None
    tp_mesh = pmesh.tensor_mesh(mesh)
    if tp_mesh is not None:
        region = TensorRegion(pmesh.tensor_group(mesh), tensor,
                              pmesh.axis_rank(mesh, _AXIS_TENSOR))
        for name, pl in plan.items():
            if pl.tensor is None:
                continue
            full = named[name].detach()
            loc = tensor_slice(full, pl.tensor, pl.split, tensor,
                               region.rank).contiguous()
            dt = DTensor.from_local(loc, tp_mesh,
                                    [_strided(pl.tensor, pl.split)],
                                    run_check=False, shape=full.shape,
                                    stride=full.stride())
            owner, leaf = _owner(model, name)
            setattr(owner, leaf, nn.Parameter(dt))
        for blk in model.blocks:
            blk.tp = region

    managed = frozenset()
    dp_mesh = pmesh.fsdp_mesh(mesh)
    if dp_mesh is not None:
        from torch.distributed.fsdp import fully_shard

        named = dict(model.named_parameters())
        by_id = {id(p): plan[n] for n, p in named.items()}
        ignored = {p for n, p in named.items() if plan[n].fsdp is None}
        managed = frozenset(n for n in named if plan[n].fsdp is not None)

        def place(p):
            return Shard(by_id[id(p)].fsdp)

        for blk in model.blocks:
            fully_shard(blk, mesh=dp_mesh, shard_placement_fn=place,
                        ignored_params=ignored)
        fully_shard(model, mesh=dp_mesh, shard_placement_fn=place,
                    ignored_params=ignored)

    partial = frozenset()
    if region is not None:
        partial = frozenset(
            n for n in plan if n.endswith(".lambda_param") or any(
                n.endswith(f".{m}.bias") for m in COLUMN_BIASES))
    sharding = ModelSharding(
        placements=plan, fsdp_managed=managed, tensor_partial=partial,
        fsdp_group=(None if dp_mesh is None
                    else mesh.get_group(_AXIS_FSDP)),
        tensor_group=None if region is None else region.group,
        region=region,
        replica_group=(mesh.get_group(pmesh.AXIS_REPLICA)
                       if dp_mesh is not None
                       and pmesh.axis_size(mesh, pmesh.AXIS_REPLICA) > 1
                       else None))
    model.sharding = sharding
    return sharding


def t5_placement(name: str, shape: Tuple[int, ...], fsdp: int) -> Placement:
    """The fsdp placement of a port T5 parameter, as JAX `param_pspec`
    places the T5 tree: its blocks are a list under "blocks", so the rule
    skips their first dim as a depth dim; a linear [in, out] there can
    only shard its out dim (torch dim 0). Other leaves (the embedding)
    take the generic rule."""
    if not name.startswith("encoder.block."):
        return param_placements(name, shape, {_AXIS_FSDP: fsdp})
    numel = 1
    for n in shape:
        numel *= n
    if len(shape) == 2 and numel >= _MIN_SHARD_ELEMS and \
            _divisible(shape[0], fsdp):
        return Placement(fsdp=0)
    return Placement()


def shard_encoder(t5: nn.Module, mesh) -> nn.Module:
    """Shard the frozen T5 encoder over fsdp in place (the JAX
    `shard_params` of its tree, `text/encoder.py`): `t5_placement` per
    leaf, `fully_shard` on each block and then the root; leaves the rule
    replicates are left alone. Call the encoder through `t5(ids, index)`
    so the root's hooks gather the embedding. A no-op when fsdp is 1."""
    dp_mesh = pmesh.fsdp_mesh(mesh) if mesh is not None else None
    if dp_mesh is None:
        return t5
    from torch.distributed.fsdp import fully_shard

    fsdp = pmesh.axis_size(mesh, _AXIS_FSDP)
    named = dict(t5.named_parameters())
    plan = {id(p): t5_placement(n, tuple(p.shape), fsdp)
            for n, p in named.items()}
    ignored = {p for p in named.values() if plan[id(p)].fsdp is None}

    def place(p):
        return Shard(plan[id(p)].fsdp)

    for blk in t5.encoder.block:
        fully_shard(blk, mesh=dp_mesh, shard_placement_fn=place,
                    ignored_params=ignored)
    fully_shard(t5, mesh=dp_mesh, shard_placement_fn=place,
                ignored_params=ignored)
    return t5


def reduce_scatter_grad(sharding: ModelSharding, name: str,
                        grad: torch.Tensor) -> torch.Tensor:
    """This rank's fsdp shard of the data-parallel mean of `grad`, the fp32
    gradient of the gathered parameter `name` (whole over fsdp; this
    rank's tensor shard): summed over the fsdp group onto each rank's
    chunk of the fsdp dim (a reduce-scatter), then over the replicas, and
    divided by the data shards — what FSDP2's post-backward gives
    `.grad`."""
    group = sharding.fsdp_group
    n = dist.get_world_size(group)
    parts = [c.contiguous() for c in grad.chunk(n, sharding.placements[
        name].fsdp)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter_tensor(out.view(-1),
                               torch.cat([c.view(-1) for c in parts]),
                               group=group)
    if sharding.replica_group is not None:
        dist.all_reduce(out, group=sharding.replica_group)
        n *= dist.get_world_size(sharding.replica_group)
    return out.div_(n)


def gathered_factor(sharding: Optional[ModelSharding], name: str,
                    t: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole of a vector `t` indexed by dim `dim` of parameter `name`
    (a factor of its second moment) from this rank's part: gathered over
    the groups that split that dim (every rank of them takes part)."""
    if sharding is None:
        return t
    pl = sharding.placements[name]
    x = t.detach()
    for group, d, split in ((sharding.fsdp_group, pl.fsdp, 1),
                            (sharding.tensor_group, pl.tensor, pl.split)):
        if d != dim or group is None:
            continue
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        x = tensor_join(parts, 0, split)
    return x


def local_factor(sharding: Optional[ModelSharding], name: str,
                 full: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's part of the whole factor `full` (`gathered_factor`)."""
    if sharding is None:
        return full
    pl = sharding.placements[name]
    x = full
    if pl.tensor == dim and sharding.region is not None:
        x = tensor_slice(x, 0, pl.split, sharding.region.size,
                         sharding.region.rank)
    if pl.fsdp == dim and sharding.fsdp_group is not None:
        x = x.chunk(dist.get_world_size(sharding.fsdp_group))[
            dist.get_rank(sharding.fsdp_group)]
    return x


# ------------------------------------------------------------- checkpoints


def load_full_state(model: nn.Module, state_dict: Dict[str, torch.Tensor]
                    ) -> None:
    """Load whole tensors (an unsharded state dict) into `model`, sharded
    or not: each rank copies its shard of every parameter."""
    sharding = getattr(model, "sharding", None)
    if sharding is None:
        model.load_state_dict(state_dict, strict=True)
        return
    named = dict(model.named_parameters())
    missing = sorted(named.keys() - state_dict.keys())
    if missing:
        raise KeyError(f"missing from the state dict: {missing[:5]}")
    with torch.no_grad():
        for name, p in named.items():
            dst = p.to_local() if isinstance(p, DTensor) else p
            dst.copy_(sharding.local_of(name, state_dict[name].to(dst.device)))


def checkpoint_state(tensors: Dict[str, torch.Tensor],
                     sharding: Optional[ModelSharding]) -> Dict:
    """`tensors` (parameter name → tensor: the state dict, or a moment
    dict) as DCP saves it: the strided leaves whole, everything else as it
    is. Every rank calls it in the same order (it gathers)."""
    if sharding is None:
        return tensors
    return {n: (sharding.gathered(n, t) if sharding.is_strided(n) else t)
            for n, t in tensors.items()}


def restore_state(live: Dict[str, torch.Tensor], loaded: Dict,
                  sharding: Optional[ModelSharding]) -> None:
    """After DCP loaded into `loaded` (a `checkpoint_state` of `live`),
    copy the whole strided leaves' rows back into the live shards."""
    if sharding is None:
        return
    with torch.no_grad():
        for n, t in live.items():
            if sharding.is_strided(n):
                dst = t.to_local() if isinstance(t, DTensor) else t
                dst.copy_(sharding.local_of(n, loaded[n]))


def strided_templates(tensors: Dict[str, torch.Tensor],
                      sharding: Optional[ModelSharding]) -> Dict:
    """`tensors` as DCP loads them: the strided leaves as empty whole
    tensors (to be copied back by `restore_state`), the rest themselves
    (loaded in place)."""
    if sharding is None:
        return tensors
    return {n: (torch.empty(t.shape, dtype=t.dtype,
                            device=(t.to_local() if isinstance(t, DTensor)
                                    else t).device)
                if sharding.is_strided(n) else t)
            for n, t in tensors.items()}

