"""Checkpoints: full train state over torch DCP, and the reference's
weights (port of `train/checkpoint.py`).

The JAX package saves its whole TrainState with orbax; the port saves the
same with `torch.distributed.checkpoint` (DCP) in the same run layout,
`checkpoint_dir/run_name/<step>/`: the model's parameters, the muP-AdamW
moments and update count, the Trainer's step, and the state of each data
shard's training generator (`rng.<data rank>`). Sharded parameters and
moments (FSDP2, the tensor axis) go in as DTensors, which DCP writes once
per shard and reshards on load to any mesh, one process included; the
packed qkv / context_kv leaves of a tensor-parallel model go in whole
(`parallel/fsdp.py:checkpoint_state`). The port
draws every timestep, noise and dropout of training from that one
generator stream, where JAX folds the step into its key, so without its
state a resumed run would draw other numbers. Under `torchrun` every rank
takes part in the save and the load; DCP writes each replicated tensor
once.

`load_reference_checkpoint` reads a checkpoint of the torch reference (a
DCP directory or a consolidated `.pt`, `module.`/`_orig_mod.` prefixes
stripped): its names are already the port's (`models/dit.py`).
`restore_params_for_inference` loads the model of a port checkpoint alone
for sampling, never the moments, checked against a `DiTConfig`.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

# a key only the port's checkpoints hold (what tells them from the
# reference's DCP directories)
STEP_KEY = "trainer.step"
_DCP_METADATA = ".metadata"


def _dcp():
    import torch.distributed.checkpoint as dcp

    return dcp


def _metadata_keys(path: str):
    from torch.distributed.checkpoint import FileSystemReader

    return FileSystemReader(path).read_metadata().state_dict_metadata.keys()


class CheckpointManager:
    """The step directories of one run root: `save(step, state)` and
    `restore(step, state)` over DCP, `state` a nested dict of tensors
    (restored in place)."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def save(self, step: int, state: Dict) -> str:
        """Write `state` as step `step` (an existing one is replaced)."""
        dcp = _dcp()
        path = self.step_dir(step)
        dcp.save(state, storage_writer=dcp.FileSystemWriter(path,
                                                            overwrite=True))
        return path

    def restore(self, step: Optional[int], state: Dict) -> int:
        """Load `step` (None: the latest) into `state`'s tensors; returns
        the step."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        _dcp().load(state, checkpoint_id=self.step_dir(step))
        return step

    def holds(self, step: Optional[int], key: str) -> bool:
        """Whether step `step` saved the entry `key` (a step not saved
        yet: True, so the restore raises)."""
        path = None if step is None else self.step_dir(step)
        if path is None or not os.path.exists(os.path.join(path,
                                                           _DCP_METADATA)):
            return True
        return key in _metadata_keys(path)

    def latest_step(self) -> Optional[int]:
        """The highest step whose save finished (its DCP metadata is
        written last)."""
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return None
        steps = [int(e) for e in entries if e.isdigit() and os.path.exists(
            os.path.join(self.directory, e, _DCP_METADATA))]
        return max(steps, default=None)


def _is_port_step_dir(path: str) -> bool:
    if not os.path.exists(os.path.join(path, _DCP_METADATA)):
        return False
    return STEP_KEY in _metadata_keys(path)


def is_port_checkpoint(path: str) -> bool:
    """True for what `CheckpointManager` wrote: a run root (digit step
    subdirectories) or one step directory of it — as opposed to the
    reference's DCP directories and `.pt` files."""
    if not os.path.isdir(path):
        return False
    if _is_port_step_dir(path):
        return True
    return any(e.isdigit() and _is_port_step_dir(os.path.join(path, e))
               for e in os.listdir(path))


def is_torch_reference_checkpoint(path: str) -> bool:
    """True for checkpoints of the torch reference: a DCP directory
    (`.distcp` shards) that is not the port's, a directory holding its
    converted `temp.pt`, or a bare `.pt` file."""
    if path.endswith(".pt"):
        return True
    if not os.path.isdir(path) or is_port_checkpoint(path):
        return False
    entries = os.listdir(path)
    return "temp.pt" in entries or any(e.endswith(".distcp") for e in entries)


def split_checkpoint_path(path: str) -> Tuple[str, Optional[int]]:
    """A user-supplied checkpoint path → (run root, step or None).

    A path that CONTAINS digit subdirectories is a run root even if its own
    basename is all digits (e.g. --run_name 20260819): otherwise an
    all-digit run name would read as a step dir and restore some other
    run's step from the parent directory. An EXISTING digit-basename dir
    is a step dir only when it holds DCP metadata: an all-digit run root
    with no checkpoints yet is a run root, so the restore fails with "no
    checkpoints" instead of looking for a step in the parent. A
    NONEXISTENT digit path keeps the step-dir reading (nothing to
    inspect)."""
    path = os.path.normpath(path)
    exists = os.path.isdir(path)
    try:
        entries = os.listdir(path)
    except OSError:
        entries = []
    has_step_subdirs = any(
        e.isdigit() and os.path.isdir(os.path.join(path, e)) for e in entries)
    has_step_metadata = _DCP_METADATA in entries
    base = os.path.basename(path)
    if base.isdigit() and not has_step_subdirs and (
            has_step_metadata or not exists):
        return os.path.dirname(path), int(base)
    return path, None


def _model_template(cfg) -> Dict[str, torch.Tensor]:
    """{name: shape-only tensor} of `DiT(cfg)`."""
    from video_diffusion_speedrun_tpu_torch.models.dit import DiT

    return DiT(cfg, device="meta").state_dict()


def _check_against_config(shapes: Dict[str, Tuple[int, ...]], cfg,
                          allow_extra: bool = False) -> None:
    """Raise, with the JAX package's messages, when checkpoint names or
    shapes differ from those of `DiT(cfg)` (`allow_extra`: names the
    model lacks are not an error)."""
    expected = {k: tuple(v.shape) for k, v in _model_template(cfg).items()}
    missing = sorted(expected.keys() - shapes.keys())[:5]
    extra = [] if allow_extra else sorted(shapes.keys() - expected.keys())[:5]
    if missing or extra:
        raise ValueError(
            f"checkpoint param tree does not match the model config "
            f"(missing: {missing}, unexpected: {extra}) — check "
            f"--model_width/--model_depth/--model_head_dim")
    bad = {k: (shapes[k], expected[k]) for k in expected
           if expected[k] != shapes[k]}
    if bad:
        k, (got, exp) = next(iter(bad.items()))
        raise ValueError(
            f"checkpoint param shapes do not match the model config "
            f"({len(bad)} leaves differ; e.g. {k}: checkpoint {got} vs "
            f"model {exp}) — check --model_width/--model_depth/"
            f"--model_head_dim")


def restore_params_for_inference(path: str, model_cfg=None
                                 ) -> Dict[str, torch.Tensor]:
    """The model state dict (on the CPU, in the saved dtype) of a port
    checkpoint — a run root (the latest step) or a step directory — read
    without the optimizer moments. With `model_cfg` (a `DiTConfig`, or anything with
    a `.model` one) the names and shapes are checked against it first, so
    a mismatched --model_width fails here and not inside the forward."""
    from torch.distributed.checkpoint import FileSystemReader

    root, step = split_checkpoint_path(path)
    mgr = CheckpointManager(root)
    step = mgr.latest_step() if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {root}")
    meta = FileSystemReader(mgr.step_dir(step)).read_metadata()
    shapes = {k[len("model."):]: tuple(m.size)
              for k, m in meta.state_dict_metadata.items()
              if k.startswith("model.")}
    if model_cfg is not None:
        _check_against_config(shapes, getattr(model_cfg, "model", model_cfg))
    dtypes = {k[len("model."):]: m.properties.dtype
              for k, m in meta.state_dict_metadata.items()
              if k.startswith("model.")}
    state = {"model": {k: torch.empty(s, dtype=dtypes[k])
                       for k, s in shapes.items()}}
    _dcp().load(state, checkpoint_id=mgr.step_dir(step))
    return state["model"]


def load_reference_checkpoint(path: str, cfg) -> Dict[str, torch.Tensor]:
    """The state dict of `DiT(cfg)` (`cfg`: a `DiTConfig`) from a torch
    reference checkpoint (a DCP directory — converted once to its
    `temp.pt`, as the reference does — or a `.pt`), `module.`/`_orig_mod.`
    prefixes stripped, every name of the model present with its shape; a
    name the model lacks is dropped, as the JAX converter picks only what
    it needs."""
    if os.path.isdir(path):
        pt = os.path.join(path, "temp.pt")
        if not os.path.exists(pt):
            from torch.distributed.checkpoint.format_utils import (
                dcp_to_torch_save,
            )

            dcp_to_torch_save(path, pt)
    else:
        pt = path
    state_dict = torch.load(pt, map_location="cpu", weights_only=True)
    state_dict = {k.replace("module.", "").replace("_orig_mod.", ""): v
                  for k, v in state_dict.items()}
    _check_against_config({k: tuple(v.shape) for k, v in state_dict.items()},
                          cfg, allow_extra=True)
    keep = _model_template(cfg).keys()
    return {k: v for k, v in state_dict.items() if k in keep}
