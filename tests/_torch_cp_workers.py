"""Torch-only helpers of tests/test_torch_context_parallel.py, and its
multi-process workers.

    python tests/_torch_cp_workers.py WORLD PORT IN.npz OUT.npz

spawns WORLD processes that join a gloo process group on
localhost:PORT through the port's own start-up (`init_distributed`, from
the environment `torchrun` would set) and, on the CPU:

1. run `cp_rope_flash_attention` over a `DistRing` of all WORLD ranks on
   the inputs in IN.npz, forward and backward, and sum the q/k/v
   gradients over the ranks (each rank's backward holds its own rows);
2. run `STEPS` train steps of the tiny DiT through the `Trainer` built on
   the mesh `MESHES[WORLD]` (replica × context), each replica taking its
   rows of the injected global batches, and keep the losses and the
   step-1 gradients as the optimizer receives them; then the same under
   the remat policy "dots_attn";
3. average their ranks with `avg_scalar_across_hosts` and meet at a
   `barrier`.

    python tests/_torch_cp_workers.py gathered PORT IN.npz OUT.npz

spawns 2 processes that run each model of `GATHERED` (the gathered
attention of context parallelism: a no-RoPE model, and head_dim 16 with
the plain attention) over a `DistRing` of both, on the inputs and the
state dicts (`sd.<model>.<name>`) in IN.npz: the output and the
parameter gradients of `gathered_loss`, summed over the ranks.

    python tests/_torch_cp_workers.py eval PORT OUT.npz

spawns EVAL_REPLICAS processes, each a replica of the tiny DiT at global
batch EVAL_BATCH, which train one step through `Trainer.train` and so reach
its first evaluation, where the 40-row test split does not fill the batch:
rank 0 keeps the Trainer's log lines and the evaluated batch's global
rows, summed over the replicas.

Rank 0 writes the results to OUT.npz. This module imports no JAX: a
spawned child runs none of the test suite's JAX set-up, and the test
process imports it for the helpers that build both sides alike.
"""

from __future__ import annotations

import os
import sys

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
HEADS = 2
# world size → (replica, context) of the training run
MESHES = {2: (1, 2), 4: (2, 2)}
# latents [B, C, T, H, W] → (4/2)·(10/2)·(10/2) + 16 = 66 tokens: ragged
# at every cp, and at cp = 4 (chunk 32, 128 padded rows) one chunk is all
# padding
LATENT = (4, 4, 4, 10, 10)
CTX = (4, 5, 32)


def train_config(replica: int = 1, context: int = 1,
                 remat_policy: str = "nothing") -> TrainConfig:
    """The tiny DiT (width 64, depth 2, remat) in fp32 with the fused ops'
    twins, muP AdamW without warm-up, no caption dropout."""
    model = DiTConfig(
        in_channels=4, hidden_size=64, depth=2, num_heads=HEADS,
        cross_attn_input_size=32, residual_v=True, train_bias_and_rms=True,
        compute_dtype=torch.float32, attention_impl="fused",
        fused_adaln="fused", remat=True, remat_policy=remat_policy)
    return TrainConfig(
        model=model, batch_size=LATENT[0], max_steps=STEPS,
        caption_dropout=0.0,
        data=DataConfig(synthetic_rows=8, test_rows=8, caption_tokens=CTX[1],
                        context_dim=CTX[2]),
        optimizer=OptimizerConfig(learning_rate=2 ** -4, warmup_steps=0),
        mesh=MeshConfig(replica=replica, fsdp=1, context=context))


def make_inputs(seed: int = 0):
    """Attention inputs (q, k, v, do [2, 52, H·32], tables [52, 16]) and
    STEPS injected global batches, as numpy, in one dict."""
    r = np.random.default_rng(seed)
    out = {n: r.normal(size=(2, 52, HEADS * 32)).astype(np.float32)
           for n in ("q", "k", "v", "do")}
    ang = r.uniform(0, 6, size=(52, 16)).astype(np.float32)
    out["cos"], out["sin"] = np.cos(ang), np.sin(ang)
    for i in range(STEPS):
        out[f"latent{i}"] = r.normal(size=LATENT).astype(np.float32)
        out[f"noise{i}"] = r.normal(size=LATENT).astype(np.float32)
        out[f"context{i}"] = r.normal(size=CTX).astype(np.float32)
        out[f"timesteps{i}"] = r.uniform(0.05, 0.95, LATENT[0]).astype(
            np.float32)
        out[f"rope_offsets{i}"] = r.integers(0, 20, 3)
    return out


def perturb(model) -> None:
    """Give the zero-initialised AdaLN and output layers seeded values (at
    the zero init the output is exactly 0), the same in every process."""
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        lins = [blk.adaLN_modulation[1] for blk in model.blocks]
        for lin in lins + [model.final_modulation[1], model.final_proj]:
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=gen)
                             * 0.05)
            lin.bias.copy_(torch.randn(lin.bias.shape, generator=gen) * 0.2)


def attention(data, ring):
    """cp_rope_flash_attention over `ring`: (out, dq, dk, dv) as numpy;
    across processes the gradients are summed over the ranks."""
    import torch.distributed as dist

    from video_diffusion_speedrun_tpu_torch.ops.fused_attention import (
        cp_rope_flash_attention,
    )

    q, k, v = (torch.from_numpy(data[n]).requires_grad_() for n in "qkv")
    cos, sin = torch.from_numpy(data["cos"]), torch.from_numpy(data["sin"])
    out = cp_rope_flash_attention(q, k, v, cos, sin, HEADS, ring)
    out.backward(torch.from_numpy(data["do"]))
    grads = [t.grad for t in (q, k, v)]
    if ring.group is not None:
        for g in grads:
            dist.all_reduce(g, group=ring.group)
    return [t.detach().numpy() for t in [out] + grads]


def train(data, trainer):
    """STEPS train steps of `trainer` on the injected global batches, each
    replica on its rows: (losses [STEPS], step-1 gradients flattened)."""
    from video_diffusion_speedrun_tpu_torch.data.loader import replica_rows
    from video_diffusion_speedrun_tpu_torch.parallel.mesh import (
        local_batch_slice,
    )
    from video_diffusion_speedrun_tpu_torch.train.step import train_step

    perturb(trainer.model)
    seen = []
    step = trainer.opt.step

    def keep_first(grads):
        if not seen:
            seen.append(torch.cat([
                (torch.zeros_like(p) if g is None else g).flatten()
                for p, g in zip(trainer.opt.params, grads)]))
        step(grads)

    trainer.opt.step = keep_first
    keys = ("latent", "noise", "context", "timesteps", "rope_offsets")
    glob = [{k: data[f"{k}{i}"] for k in keys} for i in range(STEPS)]
    local = local_batch_slice(trainer.mesh, LATENT[0])
    rows = replica_rows(({k: v for k, v in b.items() if k != "rope_offsets"}
                         for b in glob), trainer.data_rank, local)
    losses = []
    for batch, full in zip(rows, glob):
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        batch["rope_offsets"] = torch.from_numpy(full["rope_offsets"])
        m = train_step(trainer.model, trainer.opt, batch, None, trainer.cfg,
                       trainer.context_parallel, trainer.data_group)
        losses.append(float(m["loss"]))
    return np.asarray(losses), seen[0].numpy()


# the gathered attention's models (architecture fields, shared with the
# JAX side) and the port's flags for each: a no-RoPE model, whose
# self-attention under context parallelism is JAX's XLA attention on any
# dispatch (here under remat "dots_attn"), and head_dim 16 under "plain"
GATHERED = {
    "norope": (dict(hidden_size=64, num_heads=2, use_rope=False),
               dict(attention_impl="fused", fused_adaln="fused",
                    remat_policy="dots_attn")),
    "plain16": (dict(hidden_size=32, num_heads=2),
                dict(attention_impl="plain", fused_adaln="off")),
}
GATHERED_ARCH = dict(in_channels=4, depth=2, cross_attn_input_size=32,
                     residual_v=True, train_bias_and_rms=True)
# [B, C, T, H, W] → 2·5·5 + 16 = 66 tokens: 30 padded rows at cp = 2
GATHERED_LATENT = (2, 4, 4, 10, 10)


def gathered_config(name: str) -> DiTConfig:
    arch, flags = GATHERED[name]
    return DiTConfig(**GATHERED_ARCH, **arch, **flags,
                     compute_dtype=torch.float32)


def gathered_inputs(seed: int = 5):
    """The gathered models' inputs (x, context, timesteps, RoPE offsets)
    and the loss weights w of the output's shape."""
    r = np.random.default_rng(seed)
    b = GATHERED_LATENT[0]
    return dict(x=r.normal(size=GATHERED_LATENT).astype(np.float32),
                context=r.normal(size=(b, 5, 32)).astype(np.float32),
                timesteps=np.asarray([0.3, 0.7], np.float32),
                rope_offsets=np.asarray([1, 2, 3], np.int32),
                w=r.normal(size=GATHERED_LATENT).astype(np.float32))


def gathered_loss(model, data, ring):
    """Σ w·DiT(x) over `ring`, and the output."""
    t = {k: torch.from_numpy(v) for k, v in data.items()
         if not k.startswith("sd.")}
    out = model(t["x"], t["context"], t["timesteps"],
                rope_offsets=t["rope_offsets"], context_parallel=ring)
    return (out * t["w"]).sum(), out


def gathered(data, name: str, ring):
    """The output and the parameter gradients (name → numpy, summed over
    the ring's ranks across processes) of `gathered_loss` of model
    `name` on the state dict `sd.<name>.*` in `data`."""
    import torch.distributed as dist

    from video_diffusion_speedrun_tpu_torch.models.dit import DiT

    model = DiT(gathered_config(name), device="cpu")
    prefix = f"sd.{name}."
    model.load_state_dict({k[len(prefix):]: torch.from_numpy(v)
                           for k, v in data.items() if k.startswith(prefix)},
                          strict=True)
    loss, out = gathered_loss(model, data, ring)
    loss.backward()
    grads = {}
    for n, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        if ring.group is not None:
            dist.all_reduce(g, group=ring.group)
        grads[n] = g.numpy()
    return out.detach().numpy(), grads


def _gathered_worker(rank: int, port: int, inp: str, out: str) -> None:
    os.environ.update(WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    import torch.distributed as dist

    from video_diffusion_speedrun_tpu_torch.parallel import mesh as pmesh
    from video_diffusion_speedrun_tpu_torch.parallel.ring import DistRing

    torch.set_num_threads(1)
    data = dict(np.load(inp))
    pmesh.init_distributed(torch.device("cpu"))
    res = {}
    for name in GATHERED:
        res[f"{name}.out"], grads = gathered(data, name,
                                             DistRing(dist.group.WORLD))
        res.update({f"{name}.grad.{n}": g for n, g in grads.items()})
    if rank == 0:
        np.savez(out, **res)
    pmesh.shutdown()


def _worker(rank: int, world: int, port: int, inp: str, out: str) -> None:
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    import torch.distributed as dist

    from video_diffusion_speedrun_tpu_torch.parallel import mesh as pmesh
    from video_diffusion_speedrun_tpu_torch.parallel.collectives import (
        avg_scalar_across_hosts,
        barrier,
    )
    from video_diffusion_speedrun_tpu_torch.parallel.ring import DistRing
    from video_diffusion_speedrun_tpu_torch.train.loop import Trainer
    from video_diffusion_speedrun_tpu_torch.utils.flops import (
        PEAK_FLOPS,
        mfu,
    )

    torch.set_num_threads(1)
    data = dict(np.load(inp))
    pmesh.init_distributed(torch.device("cpu"))
    res = dict(zip(("out", "dq", "dk", "dv"),
                   attention(data, DistRing(dist.group.WORLD))))
    trainer = Trainer(train_config(*MESHES[world]), device="cpu")
    res["losses"], res["grads"] = train(data, trainer)
    trainer = Trainer(train_config(*MESHES[world], remat_policy="dots_attn"),
                      device="cpu")
    res["dots_attn.losses"], res["dots_attn.grads"] = train(data, trainer)
    res["avg_rank"] = np.asarray(avg_scalar_across_hosts(rank))
    # one card's peak of work in one second, over the group's cards
    card = "NVIDIA H100 80GB HBM3"
    res["mfu_one_card"] = np.asarray(mfu(PEAK_FLOPS[card], 1.0, card))
    barrier()
    if rank == 0:
        np.savez(out, **res)
    pmesh.shutdown()


EVAL_REPLICAS = 3
EVAL_BATCH = 48


def _eval_worker(rank: int, port: int, out: str) -> None:
    import dataclasses
    import logging

    import torch.distributed as dist

    os.environ.update(WORLD_SIZE=str(EVAL_REPLICAS), RANK=str(rank),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    from video_diffusion_speedrun_tpu_torch.parallel import mesh as pmesh
    from video_diffusion_speedrun_tpu_torch.train.loop import Trainer, logger

    torch.set_num_threads(1)
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    logger.addHandler(Keep())
    logger.setLevel(logging.INFO)
    base = train_config(replica=EVAL_REPLICAS)
    cfg = dataclasses.replace(
        base, batch_size=EVAL_BATCH, max_steps=1,
        eval_batches=1, log_every=1,
        data=dataclasses.replace(base.data, synthetic_rows=EVAL_BATCH,
                                 test_rows=40, synthetic_shape=LATENT[1:]))
    trainer = Trainer(cfg, device="cpu")
    rows = []
    batches = trainer.batches

    def counted(split):
        for batch in batches(split):
            if split == "test":
                rows.append(batch["latent"].shape[0])
            yield batch

    trainer.batches = counted
    last = trainer.train()
    seen = torch.tensor(rows[:1], dtype=torch.float64)
    dist.all_reduce(seen)
    if rank == 0:
        np.savez(out, eval_rows=seen.numpy(), lines=np.asarray(lines),
                 loss=np.asarray(last["test/total_loss"]))
    pmesh.shutdown()


def main(argv) -> None:
    import torch.multiprocessing as mp

    if argv[0] == "eval":
        mp.start_processes(_eval_worker, args=(int(argv[1]), argv[2]),
                           nprocs=EVAL_REPLICAS, start_method="spawn")
        return
    if argv[0] == "gathered":
        mp.start_processes(_gathered_worker,
                           args=(int(argv[1]), argv[2], argv[3]), nprocs=2,
                           start_method="spawn")
        return
    world, port, inp, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    mp.start_processes(_worker, args=(world, port, inp, out), nprocs=world,
                       start_method="spawn")


if __name__ == "__main__":
    main(sys.argv[1:])
