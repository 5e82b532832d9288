"""Multi-process workers of the checkpoint and text-to-video tests (no
tests of its own; imports no JAX, as a spawned child must not).

    python tests/test_torch_t2v_workers.py ckpt PORT OUT.npz

spawns CKPT_WORLD processes over gloo on the mesh replica 2 × context 2
(through the port's `init_distributed`, from the environment `torchrun`
would set): each trains the tiny DiT of `_torch_cp_workers.train_config`
CKPT_STEPS steps through `Trainer.train` (continuous), then in fresh
Trainers half of them, saves (every rank takes part in the DCP save),
resumes from the run root and trains the rest. Rank 0 writes both runs'
losses to OUT.npz, and whether every rank's parameters, moments and
generator state came out the same bit for bit.

    python tests/test_torch_t2v_workers.py sample PORT OUT.npz

spawns 2 processes that run the sampler CLI's `main` with `--mesh_context
2` (the tokens of one video over a `DistRing`; a tiny demo DiT, the tiny
smoke T5): rank 0 alone decodes and writes. Rank r writes its latents and
the path it wrote (empty if none) to OUT.npz.rank<r>.npz.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TESTS)

from _torch_cp_workers import LATENT, perturb, train_config  # noqa: E402

CKPT_WORLD, CKPT_STEPS = 4, 4
SAMPLE_ARGS = ["--height", "32", "--width", "32", "--num_latent_frames",
               "4", "--inference_steps", "2", "--model_width", "64",
               "--model_depth", "2", "--model_head_dim", "32",
               "--context_dim", "32", "--device", "cpu", "--prompt",
               "a dog on a beach", "--smoke_encoder"]


def _join(rank: int, world: int, port: int) -> None:
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)


def _ckpt_worker(rank: int, port: int, out: str) -> None:
    import dataclasses

    import torch.distributed as dist

    _join(rank, CKPT_WORLD, port)
    from video_diffusion_speedrun_tpu_torch.parallel import mesh as pmesh
    from video_diffusion_speedrun_tpu_torch.train.loop import Trainer

    root = os.path.dirname(out)
    base = train_config(replica=2, context=2)
    base = dataclasses.replace(
        base, max_steps=CKPT_STEPS, log_every=1, evaluate_every=100,
        eval_batches=1,
        data=dataclasses.replace(base.data, synthetic_shape=LATENT[1:]))

    def trainer(name, **kw):
        cfg = dataclasses.replace(
            base, checkpoint_dir=os.path.join(root, name), **kw)
        t = Trainer(cfg, device="cpu")
        if "load_checkpoint" not in kw:
            perturb(t.model)
        return t

    whole = trainer("whole")
    whole.train()
    first = trainer("resumed")
    first.train(until=CKPT_STEPS // 2)
    first.save_checkpoint()
    resumed = trainer("again", load_checkpoint=os.path.join(
        root, "resumed", base.run_name))
    resumed.train()

    def tensors(t):
        return [p.detach() for p in t.model.parameters()] + t.opt.m + t.opt.v

    same = (resumed.step == CKPT_STEPS
            and whole.opt.count == resumed.opt.count == CKPT_STEPS
            and all(torch.equal(a, b)
                    for a, b in zip(tensors(whole), tensors(resumed)))
            and torch.equal(whole.generator.get_state(),
                            resumed.generator.get_state()))
    flag = torch.tensor([float(same)])
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    if rank == 0:
        def losses(t):
            return np.asarray([r["train/total_loss"] for r in t.history])

        np.savez(out, same=flag.numpy(), whole=losses(whole),
                 first=losses(first), resumed=losses(resumed))
    pmesh.shutdown()


def _sample_worker(rank: int, port: int, out: str) -> None:
    _join(rank, 2, port)
    from video_diffusion_speedrun_tpu_torch import sample

    report = {}
    video_dir = os.path.join(os.path.dirname(out), f"rank{rank}")
    latents = sample.main(SAMPLE_ARGS + ["--mesh_context", "2", "--output",
                                         video_dir], report)
    np.savez(f"{out}.rank{rank}.npz", latents=latents.numpy(),
             path=np.asarray(report.get("path", "")))


def main(argv) -> None:
    import torch.multiprocessing as mp

    worker, nprocs = {"ckpt": (_ckpt_worker, CKPT_WORLD),
                      "sample": (_sample_worker, 2)}[argv[0]]
    mp.start_processes(worker, args=(int(argv[1]), argv[2]), nprocs=nprocs,
                       start_method="spawn")


if __name__ == "__main__":
    main(sys.argv[1:])
