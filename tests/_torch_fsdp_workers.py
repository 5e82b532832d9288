"""Torch-only helpers of tests/test_torch_fsdp.py and
tests/test_torch_tensor_parallel.py, and their multi-process workers.

    python tests/_torch_fsdp_workers.py WORLD PORT PORT2 IN.npz OUT.npz DIR

spawns WORLD processes that join a gloo process group on localhost:PORT
through the port's own start-up (`init_distributed`, from the environment
`torchrun` would set) and, on the CPU, for every mesh of `MESHES[WORLD]`:
build a `Trainer` on that mesh (FSDP2, HSDP, tensor and context axes as
the mesh has them), load the whole parameters of IN.npz (`sd.<name>`,
the JAX `init_dit` tree through the converter) and run `STEPS` train
steps on the injected global batches, each data shard on its rows. It
keeps the losses, the grad norms, the step-1 gradients as the optimizer
receives them (gathered whole), every rank's step-1 gradient of λ and of
the row-parallel bias `mlp.2.bias`, and every rank's timesteps of a step
that draws them from the Trainer's generator.

At WORLD 4 it also checks the tensor-region operators against finite
differences, and saves a checkpoint at (fsdp 2, tensor 2) after 2 steps
(under DIR), resumes it on the same mesh (2 more steps, against 2 more
steps of the saving Trainer; the optimizer's leaf table read after the
load) and restores it at fsdp 4. At WORLD 2 it encodes ids with a T5
sharded over fsdp 2, and runs the train CLI (`main`) with `--mesh_fsdp 2`
and then (on PORT2) `--mesh_tensor 2` to step 3.

    python tests/_torch_fsdp_workers.py inloop PORT IN.npz OUT.npz DIR

spawns 2 processes that run the optimizer-in-backward step
(`train/inloop.py`) at fsdp 2 and at tensor 2, with exact and with
factored ν (`nu_factored_min_size` 1): `STEPS` steps each, keeping the
losses, the step-1 gradients as the optimizer receives them (gathered
whole), the parameters and the factors after the last step (whole); and
at fsdp 2 with factored ν a checkpoint after 1 step (under DIR), resumed
by a fresh Trainer for the remaining steps (`inloop_resume`).
`inloop_reference` runs the same in one process.

Rank 0 writes the results to OUT.npz. This module imports no JAX: a
spawned child runs none of the test suite's JAX set-up, and the test
processes import it for the helpers that build both sides alike.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Optional

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from video_diffusion_speedrun_tpu_torch.core.config import (  # noqa: E402
    DataConfig,
    DiTConfig,
    MeshConfig,
    OptimizerConfig,
    TrainConfig,
)

STEPS = 3
LR = 2.0 ** -4
TINY = dict(in_channels=4, patch_size=2, time_patch_size=2, hidden_size=128,
            depth=2, num_heads=4, mlp_ratio=4.0, cross_attn_input_size=32,
            residual_v=True, train_bias_and_rms=True, remat=True)
# latent [B, C, T, H, W] → 2·4·4 + 16 = 48 tokens
LATENT = (4, 4, 4, 8, 8)
CTX = (4, 5, 32)
ROPE_OFFSETS = (1, 2, 3)
# world → mesh name → (replica, fsdp, context, tensor)
MESHES = {
    2: {"fsdp": (1, 2, 1, 1)},
    4: {"hsdp": (2, 2, 1, 1), "fsdp_tensor": (1, 2, 1, 2),
        "context_tensor": (1, 1, 2, 2)},
}
# world → run name → (the mesh of MESHES it runs on, model flags): the
# remat policies composed with FSDP2, the tensor region's collectives and
# (under "fused") the ring over the context group — under the default
# policy and under "attn" — held against the JAX reference of that mesh
REMAT_MESHES = {
    2: {"fsdp.dots": ("fsdp", dict(remat_policy="dots"))},
    4: {"fsdp_tensor.dots_attn": ("fsdp_tensor",
                                  dict(remat_policy="dots_attn")),
        "context_tensor.ring": ("context_tensor",
                                dict(attention_impl="fused")),
        "context_tensor.ring_attn": ("context_tensor",
                                     dict(attention_impl="fused",
                                          remat_policy="attn"))},
}
T5_IDS = (2, 12)


def model_config(**kw) -> DiTConfig:
    """The tiny DiT in fp32 with the plain attention and AdaLN (the JAX
    "xla"/"off" pairing), `kw` over those."""
    return DiTConfig(**{**TINY, "compute_dtype": torch.float32,
                        "attention_impl": "plain", "fused_adaln": "off",
                        **kw})


def train_config(mesh=(1, 1, 1, 1), model: Optional[DiTConfig] = None,
                 **kw) -> TrainConfig:
    """muP AdamW without warm-up, no caption dropout, grad norms logged;
    the model `model_config()` unless given."""
    r, f, c, t = mesh
    return TrainConfig(
        model=model or model_config(), batch_size=LATENT[0],
        max_steps=STEPS + 1,
        caption_dropout=0.0, log_grad_norm=True,
        data=DataConfig(synthetic_rows=8, test_rows=8, caption_tokens=CTX[1],
                        context_dim=CTX[2]),
        optimizer=OptimizerConfig(learning_rate=LR, warmup_steps=0),
        mesh=MeshConfig(replica=r, fsdp=f, context=c, tensor=t), **kw)


def make_batches(seed: int = 0, steps: int = STEPS + 1):
    """`steps` injected global batches as numpy: latent, noise, context,
    timesteps."""
    r = np.random.default_rng(seed)
    out = {}
    for i in range(steps):
        out[f"latent{i}"] = r.normal(size=LATENT).astype(np.float32)
        out[f"noise{i}"] = r.normal(size=LATENT).astype(np.float32)
        out[f"context{i}"] = r.normal(size=CTX).astype(np.float32)
        out[f"timesteps{i}"] = r.uniform(0.05, 0.95, LATENT[0]).astype(
            np.float32)
    return out


def local_batch(data, i: int, rank: int, local: int):
    """Data shard `rank`'s rows of global batch i, as torch tensors."""
    lo = rank * local
    batch = {k: torch.from_numpy(data[f"{k}{i}"][lo:lo + local])
             for k in ("latent", "noise", "context", "timesteps")}
    batch["rope_offsets"] = torch.tensor(ROPE_OFFSETS)
    return batch


def state_dict_of(data):
    return {k[3:]: torch.from_numpy(v) for k, v in data.items()
            if k.startswith("sd.")}


def whole_params(trainer):
    """{name: whole parameter} (every rank takes part)."""
    sh = trainer.sharding
    return {n: (p.detach() if sh is None else sh.gathered(n, p)).clone()
            for n, p in trainer.model.named_parameters()}


def run_steps(trainer, data, steps, first: int = 0):
    """Train steps `first`..`first + steps - 1` on the injected batches:
    (losses, grad norms, step-1 gradients whole in `opt.names` order, this
    rank's step-1 gradients by name)."""
    from video_diffusion_speedrun_tpu_torch.parallel.collectives import local
    from video_diffusion_speedrun_tpu_torch.parallel.mesh import (
        local_batch_slice,
    )
    from video_diffusion_speedrun_tpu_torch.train.step import train_step

    opt, sh = trainer.opt, trainer.sharding
    seen = {}
    step = opt.step

    def keep_first(grads):
        if not seen:
            whole, mine = [], {}
            for n, p, g in zip(opt.names, opt.params, grads):
                if g is None:
                    whole.append(torch.zeros(p.shape).flatten())
                    continue
                mine[n] = local(g).detach().clone()
                w = g if sh is None else sh.gathered(n, g)
                whole.append(w.detach().flatten().clone())
            seen["whole"], seen["mine"] = torch.cat(whole), mine
        step(grads)

    opt.step = keep_first
    local_rows = local_batch_slice(trainer.mesh, LATENT[0])
    losses, norms = [], []
    for i in range(first, first + steps):
        batch = local_batch(data, i, trainer.data_rank, local_rows)
        m = train_step(trainer.model, opt, batch, None, trainer.cfg,
                       trainer.context_parallel, trainer.data_group)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    opt.step = step
    return (np.asarray(losses), np.asarray(norms),
            seen.get("whole"), seen.get("mine", {}))


def _every_rank(x: torch.Tensor) -> np.ndarray:
    """x from every rank of the world, stacked in rank order."""
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.stack(parts).numpy()


def _train_mesh(name, mesh, data, res, **kw):
    from video_diffusion_speedrun_tpu_torch.parallel.fsdp import (
        load_full_state,
    )
    from video_diffusion_speedrun_tpu_torch.train.loop import Trainer

    trainer = Trainer(train_config(mesh, **kw), device="cpu")
    load_full_state(trainer.model, state_dict_of(data))
    losses, norms, whole, mine = run_steps(trainer, data, STEPS)
    res[f"{name}.losses"], res[f"{name}.grad_norm"] = losses, norms
    res[f"{name}.grads"] = whole.numpy()
    res[f"{name}.lambda"] = _every_rank(mine["blocks.1.lambda_param"])
    res[f"{name}.mlp2_bias"] = _every_rank(mine["blocks.0.mlp.2.bias"])
    res[f"{name}.data_rank"] = _every_rank(torch.tensor([trainer.data_rank]))
    # C8: block 0's λ never mixes v0; the optimizer receives None for it
    res[f"{name}.lambda0_none"] = _every_rank(torch.tensor(
        ["blocks.0.lambda_param" not in mine]))
    res[f"{name}.managed"] = np.asarray(sorted(
        trainer.sharding.fsdp_managed))
    res[f"{name}.draws"] = draws(trainer, data)
    return trainer


def draws(trainer, data) -> np.ndarray:
    """Every rank's timesteps of one more step that draws them (and the
    noise) from the Trainer's generator."""
    from video_diffusion_speedrun_tpu_torch.parallel.mesh import (
        local_batch_slice,
    )
    from video_diffusion_speedrun_tpu_torch.train.step import train_step

    batch = local_batch(data, 0, trainer.data_rank,
                        local_batch_slice(trainer.mesh, LATENT[0]))
    del batch["timesteps"], batch["noise"]
    m = train_step(trainer.model, trainer.opt, batch, trainer.generator,
                   trainer.cfg, trainer.context_parallel, trainer.data_group)
    return _every_rank(m["timesteps"])


def region_ops(res) -> None:
    """The three tensor-region operators over a tensor group of 2 against
    central finite differences (fp64) of the loss they are made for:
    `copy_to_region` takes one replicated input into ranks whose losses
    differ and add up; `reduce_from_region` and `gather_from_region` take
    each rank's own input to one replicated output, whose loss every rank
    computes alike."""
    import torch.distributed as dist

    from video_diffusion_speedrun_tpu_torch.parallel import collectives as c
    from video_diffusion_speedrun_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.build_mesh(MeshConfig(fsdp=2, tensor=2), "cpu")
    group = pmesh.tensor_group(mesh)
    me = dist.get_rank(group)
    gen = torch.Generator().manual_seed(11)
    x0 = torch.randn(3, 4, generator=gen, dtype=torch.float64)
    w = torch.randn(3, 8, generator=gen, dtype=torch.float64)
    cases = (("copy", c.copy_to_region, True),
             ("reduce", c.reduce_from_region, False),
             ("gather", c.gather_from_region, False))
    errs = []
    for name, op, shared in cases:
        x_in = x0 if shared else x0 + me

        def total(x):
            y = op(x, group)
            wy = w[:, :y.shape[1]] + (me * 0.5 if shared else 0.0)
            loss = (y * wy).sum()
            if shared:  # the ranks' losses add up
                loss = c.reduce_from_region(loss[None], group)[0]
            return loss

        x = x_in.clone().requires_grad_()
        total(x).backward()
        want = torch.zeros_like(x_in)
        eps = 1e-6
        for idx in np.ndindex(*x_in.shape):
            for r in range(2):  # rank r's input moves (all, if shared)
                vals = []
                for sign in (1, -1):
                    xp = x_in.clone()
                    if shared or r == me:
                        xp[idx] += sign * eps
                    with torch.no_grad():
                        vals.append(total(xp))
                if shared or r == me:
                    want[idx] = (vals[0] - vals[1]) / (2 * eps)
        errs.append(float((x.grad - want).abs().max()))
    res["region_err"] = _every_rank(torch.tensor(errs))


class _RecordingKernel:
    """Stands in for the CUDA AdamW wrapper on the CPU: keeps the leaf
    pointers it was built with and runs the plain twin."""

    built = []

    def __init__(self, params, ms, vs, lrs, wds, b1, b2, eps):
        self.pointers = [t.data_ptr() for trio in zip(params, ms, vs)
                         for t in trio]
        self.leaves = (params, ms, vs)
        self.hyper = (lrs, wds, b1, b2, eps)
        _RecordingKernel.built.append(self)

    def __call__(self, grads, lr_t, bc1, bc2):
        from video_diffusion_speedrun_tpu_torch.ops.fused_adamw import (
            adamw_leaf_update_plain,
        )

        lrs, wds, b1, b2, eps = self.hyper
        for p, m, v, g, lr, wd in zip(*self.leaves, grads, lrs, wds):
            adamw_leaf_update_plain(p, m, v, g, lr, wd, lr_t, bc1, bc2, b1,
                                    b2, eps)


def moments(trainer, which=("m", "v")) -> np.ndarray:
    """The Adam moments `which` of every leaf, whole, flattened in
    order."""
    sh = trainer.sharding
    return np.concatenate([
        (t if sh is None else sh.gathered(n, t)).flatten().numpy()
        for ms in (getattr(trainer.opt, k) for k in which)
        for n, t in zip(trainer.opt.names, ms)])


def checkpoints(data, res, directory) -> None:
    """Save at (fsdp 2, tensor 2) after 2 steps; resume on the same mesh;
    restore at fsdp 4."""
    from video_diffusion_speedrun_tpu_torch.parallel.fsdp import (
        load_full_state,
    )
    from video_diffusion_speedrun_tpu_torch.train import optim
    from video_diffusion_speedrun_tpu_torch.train.loop import Trainer

    mesh = MESHES[4]["fsdp_tensor"]
    base = dict(checkpoint_dir=directory, run_name="tp")
    saver = Trainer(train_config(mesh, **base), device="cpu")
    load_full_state(saver.model, state_dict_of(data))
    run_steps(saver, data, 2)
    saver.step = 2
    path = saver.save_checkpoint()
    res["ckpt.params2"] = np.concatenate(
        [t.flatten().numpy() for t in whole_params(saver).values()])
    res["ckpt.path"] = np.asarray(path)
    res["ckpt.moments2"] = moments(saver)
    want, _, _, _ = run_steps(saver, data, 2, first=2)
    res["ckpt.continuous"] = want
    res["ckpt.continuous_params"] = np.concatenate(
        [t.flatten().numpy() for t in whole_params(saver).values()])

    kernel_for = optim.MupAdamW.kernel_for
    optim.MupAdamW.kernel_for = staticmethod(lambda params: _RecordingKernel)
    try:
        resumed = Trainer(train_config(mesh, load_checkpoint=path, **base),
                          device="cpu")
        assert resumed.step == 2 and resumed.opt.count == 2
        got, _, _, _ = run_steps(resumed, data, 2, first=2)
        params, ms, vs = resumed.opt.leaves()
        live = [t.data_ptr() for trio in zip(params, ms, vs) for t in trio]
        res["ckpt.pointers_match"] = _every_rank(torch.tensor(
            [_RecordingKernel.built[-1].pointers == live,
             len(_RecordingKernel.built)]))
    finally:
        optim.MupAdamW.kernel_for = kernel_for
    res["ckpt.resumed"] = got
    res["ckpt.resumed_params"] = np.concatenate(
        [t.flatten().numpy() for t in whole_params(resumed).values()])

    wide = Trainer(train_config((1, 4, 1, 1), load_checkpoint=path, **base),
                   device="cpu")
    res["ckpt.fsdp4_params"] = np.concatenate(
        [t.flatten().numpy() for t in whole_params(wide).values()])
    res["ckpt.fsdp4_moments"] = moments(wide)


# name → (mesh, factored ν) of the optimizer-in-backward runs
INLOOP_RUNS = {"fsdp": ((1, 2, 1, 1), False),
               "tensor": ((1, 1, 1, 2), False),
               "fsdp_fac": ((1, 2, 1, 1), True),
               "tensor_fac": ((1, 1, 1, 2), True)}


def inloop_config(mesh=(1, 1, 1, 1), factored=False, **kw) -> TrainConfig:
    """`train_config` with the optimizer in the backward (no grad norm:
    the step refuses it)."""
    cfg = train_config(mesh, **kw)
    return dataclasses.replace(
        cfg, log_grad_norm=False, optimizer=dataclasses.replace(
            cfg.optimizer, in_backward=True, nu_factored=factored,
            nu_factored_min_size=1))


def inloop_steps(trainer, data, steps, first: int = 0):
    """In-backward steps `first`.. on the injected batches: (losses, the
    first step's gradients whole, in `opt.names` order)."""
    from video_diffusion_speedrun_tpu_torch.parallel.mesh import (
        local_batch_slice,
    )
    from video_diffusion_speedrun_tpu_torch.train.inloop import inloop_step

    opt, sh = trainer.opt, trainer.sharding
    seen = {}
    update = opt.update_group

    def keep_first(group, grads):
        if opt.count == first:
            for i, g in zip(opt.groups[group], grads):
                n, p = opt.names[i], opt.params[i]
                w = (torch.zeros(p.shape) if g is None else g.detach()
                     if sh is None else sh.gathered(n, g))
                seen[n] = w.flatten().clone()
        update(group, grads)

    opt.update_group = keep_first
    local_rows = local_batch_slice(trainer.mesh, LATENT[0])
    losses = []
    for i in range(first, first + steps):
        batch = local_batch(data, i, trainer.data_rank, local_rows)
        m = inloop_step(trainer.model, opt, batch, None, trainer.cfg,
                        trainer.context_parallel, trainer.data_group)
        losses.append(float(m["loss"]))
    opt.update_group = update
    grads = (torch.cat([seen[n] for n in opt.names]).numpy() if seen
             else np.zeros(0))
    return np.asarray(losses), grads


def inloop_factors(trainer) -> np.ndarray:
    """Every factored ν's factors, whole, flattened in order."""
    from video_diffusion_speedrun_tpu_torch.parallel.fsdp import (
        gathered_factor,
    )
    from video_diffusion_speedrun_tpu_torch.train.optim import FNu

    opt, out = trainer.opt, [np.zeros(0)]
    for n, v in zip(opt.names, opt.v):
        if isinstance(v, FNu):
            out += [gathered_factor(trainer.sharding, n, v.vr, 1).numpy(),
                    gathered_factor(trainer.sharding, n, v.vc, 0).numpy()]
    return np.concatenate(out)


def inloop_run(name, data, res, directory=None) -> None:
    """One `INLOOP_RUNS` entry (or, for "one"/"one_fac", one process)."""
    from video_diffusion_speedrun_tpu_torch.parallel.fsdp import (
        load_full_state,
    )
    from video_diffusion_speedrun_tpu_torch.train.loop import Trainer

    mesh, factored = INLOOP_RUNS.get(name, ((1, 1, 1, 1),
                                            name.endswith("_fac")))
    kw = {} if directory is None else dict(checkpoint_dir=directory,
                                           run_name=name)
    trainer = Trainer(inloop_config(mesh, factored, **kw), device="cpu")
    load_full_state(trainer.model, state_dict_of(data))
    losses, grads = inloop_steps(trainer, data, STEPS)
    res[f"inloop.{name}.losses"], res[f"inloop.{name}.grads"] = losses, grads
    res[f"inloop.{name}.params"] = np.concatenate(
        [t.flatten().numpy() for t in whole_params(trainer).values()])
    res[f"inloop.{name}.factors"] = inloop_factors(trainer)


def inloop_resume(data, res, directory, mesh=(1, 2, 1, 1)) -> None:
    """Factored ν on `mesh`: 1 step, a save, `STEPS - 1` more; a fresh
    Trainer resumes the save and takes the same steps: parameters, μ and
    the factors after them, from both."""
    from video_diffusion_speedrun_tpu_torch.parallel.fsdp import (
        load_full_state,
    )
    from video_diffusion_speedrun_tpu_torch.train.loop import Trainer

    def make(**kw):
        return Trainer(inloop_config(mesh, True, checkpoint_dir=directory,
                                     run_name="inloop", **kw), device="cpu")

    saver = make()
    load_full_state(saver.model, state_dict_of(data))
    inloop_steps(saver, data, 1)
    saver.step = 1
    path = saver.save_checkpoint()
    resumed = make(load_checkpoint=path)
    assert resumed.step == 1 and resumed.opt.count == 1
    for tag, t in (("continuous", saver), ("resumed", resumed)):
        losses, _ = inloop_steps(t, data, STEPS - 1, first=1)
        res[f"resume.{tag}.losses"] = losses
        res[f"resume.{tag}.state"] = np.concatenate(
            [t_.flatten().numpy() for t_ in whole_params(t).values()]
            + [moments(t, ("m",)), inloop_factors(t)])


def inloop_reference(data, directory) -> dict:
    """The one-process runs the sharded ones are held against."""
    res = {}
    for name in ("one", "one_fac"):
        inloop_run(name, data, res)
    inloop_resume(data, res, directory, mesh=(1, 1, 1, 1))
    return res


def t5_sharded(res) -> None:
    """A T5 sharded over fsdp 2 encodes as the unsharded one."""
    from video_diffusion_speedrun_tpu_torch.parallel import mesh as pmesh
    from video_diffusion_speedrun_tpu_torch.text.encoder import PromptEncoder
    from video_diffusion_speedrun_tpu_torch.text.t5 import T5Config, init_t5

    cfg = T5Config(d_model=256, d_kv=64, d_ff=512, num_layers=2, num_heads=4,
                   compute_dtype=torch.float32)
    ids = np.random.default_rng(5).integers(0, 32128, T5_IDS)

    def encoder(mesh=None):
        gen = torch.Generator().manual_seed(3)
        return PromptEncoder(init_t5(cfg, device="cpu", generator=gen),
                             mesh=mesh)

    want = encoder().encode_ids(ids, return_index=-2)
    mesh = pmesh.build_mesh(MeshConfig(fsdp=2), "cpu")
    sharded = encoder(mesh)
    got = sharded.encode_ids(ids, return_index=-2)
    res["t5.err"] = np.asarray(float((got - want).abs().max()))
    res["t5.scale"] = np.asarray(float(want.abs().max()))
    res["t5.sharded"] = np.asarray(sum(
        type(p).__name__ == "DTensor" for p in sharded.model.parameters()))


def cli(res, port2: int, directory: str) -> None:
    """The train CLI on the CPU with --mesh_fsdp 2, then --mesh_tensor 2
    (each `main` ends the process group it started)."""
    from video_diffusion_speedrun_tpu_torch.train import __main__ as train

    common = ["--device", "cpu", "--max_steps", "3", "--batch_size", "4",
              "--model_width", "64", "--model_depth", "2",
              "--model_head_dim", "32", "--context_dim", "32",
              "--synthetic_rows", "8", "--log_every", "1",
              "--evaluate_every", "100", "--checkpoint_dir", directory]
    steps = []
    for i, mesh in enumerate((["--mesh_fsdp", "2"],
                              ["--mesh_fsdp", "1", "--mesh_tensor", "2"])):
        if i:
            os.environ["MASTER_PORT"] = str(port2)
        out = train.main(common + mesh + ["--run_name", f"cli{i}"])
        steps.append(out["train/step"])
        assert np.isfinite(out["train/total_loss"])
    res["cli.steps"] = np.asarray(steps)


def _worker(rank: int, world: int, port: int, port2: int, inp: str, out: str,
            directory: str) -> None:
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    from video_diffusion_speedrun_tpu_torch.parallel import mesh as pmesh

    torch.set_num_threads(1)
    data = dict(np.load(inp))
    pmesh.init_distributed(torch.device("cpu"))
    res = {}
    for name, mesh in MESHES[world].items():
        _train_mesh(name, mesh, data, res)
    for name, (base, flags) in REMAT_MESHES[world].items():
        _train_mesh(name, MESHES[world][base], data, res,
                    model=model_config(**flags))
    if world == 4:
        region_ops(res)
        checkpoints(data, res, directory)
    else:
        t5_sharded(res)
    if rank == 0:
        np.savez(out, **res)
    if world == 2:
        cli(res, port2, directory)
        if rank == 0:
            np.savez(out, **res)
    pmesh.shutdown()


def _inloop_worker(rank: int, port: int, inp: str, out: str,
                   directory: str) -> None:
    os.environ.update(WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    from video_diffusion_speedrun_tpu_torch.parallel import mesh as pmesh

    torch.set_num_threads(1)
    data = dict(np.load(inp))
    pmesh.init_distributed(torch.device("cpu"))
    res = {}
    for name in INLOOP_RUNS:
        inloop_run(name, data, res)
    inloop_resume(data, res, directory)
    if rank == 0:
        np.savez(out, **res)
    pmesh.shutdown()


def main(argv) -> None:
    import torch.multiprocessing as mp

    if argv[0] == "inloop":
        mp.start_processes(_inloop_worker, args=tuple(
            [int(argv[1])] + argv[2:5]), nprocs=2, start_method="spawn")
        return
    world, port, port2 = int(argv[0]), int(argv[1]), int(argv[2])
    inp, out, directory = argv[3], argv[4], argv[5]
    mp.start_processes(_worker,
                       args=(world, port, port2, inp, out, directory),
                       nprocs=world, start_method="spawn")


if __name__ == "__main__":
    main(sys.argv[1:])
