"""FSDP2, HSDP, tensor and context parallelism of the port's training
path over 4 gloo processes on the CPU, against JAX `build_train_step` on
the same mesh shapes of the conftest's CPU devices, with the same
parameters (`state_dict_from_jax_params`) and the same injected
timesteps, noise and RoPE offsets; and the sharded checkpoints.

Meshes (replica, fsdp, context, tensor): (2, 2, 1, 1) HSDP, (1, 2, 1, 2)
fsdp × tensor, (1, 1, 2, 2) context × tensor (the plain attention: the
gathered attention of context parallelism); and the remat policies on
them (`workers.REMAT_MESHES`): "dots_attn" at fsdp × tensor, the ring
under the default policy and under "attn" at context × tensor.
Tolerances, fp32 on both sides (those of
`test_mesh_training_matches_one_process`): the losses of
3 steps and the grad norms to rtol 1e-5, the step-1 gradients to 1e-5
relative L2 (the summation orders of the collectives and of XLA differ;
measured ≤ 3e-7). Every rank's λ and row-parallel bias gradient equals
JAX's to 1e-5 of its scale.

The spawned ranks run `tests/_torch_fsdp_workers.py` (torch only); the
JAX references run in this process first.
"""

import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_fsdp_workers as workers
import _torch_jax_mesh as ref
from video_diffusion_speedrun_tpu_torch.core.config import MeshConfig
from video_diffusion_speedrun_tpu_torch.models.dit import DiT
from video_diffusion_speedrun_tpu_torch.train.checkpoint import (
    restore_params_for_inference,
)
from video_diffusion_speedrun_tpu_torch.train.loop import Trainer

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-5


def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The JAX references, then the 4-process run (every mesh of
    `workers.MESHES[4]`, the region operators, the checkpoints). One after
    the other: XLA's CPU collectives abort when 4 busy processes starve
    their threads."""
    tmp = tmp_path_factory.mktemp("tp")
    params, data = ref.worker_inputs()
    np.savez(tmp / "in.npz", **data)
    want = {name: ref.reference(params, data, mesh)
            for name, mesh in workers.MESHES[4].items()}
    run = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_fsdp_workers.py"), "4",
         str(_port()), str(_port()), str(tmp / "in.npz"),
         str(tmp / "out.npz"), str(tmp / "ckpt")],
        capture_output=True, text=True, timeout=400, cwd=tmp)
    assert run.returncode == 0, run.stderr[-4000:]
    return params, data, dict(np.load(tmp / "out.npz")), want


@pytest.mark.parametrize("mesh", sorted(workers.MESHES[4]))
def test_mesh_training_matches_jax(world4, mesh):
    """3 steps: losses, grad norms, the step-1 gradients whole."""
    _, _, res, want = world4
    losses, norms, grads = want[mesh]
    names = [n for n, _ in DiT(workers.model_config(),
                               device="meta").named_parameters()]
    np.testing.assert_allclose(res[f"{mesh}.losses"], losses, rtol=RTOL)
    np.testing.assert_allclose(res[f"{mesh}.grad_norm"], norms, rtol=RTOL)
    rel = ref.rel_l2(res[f"{mesh}.grads"], ref.flat_grads(grads, names))
    assert rel < RTOL, rel
    assert np.isfinite(losses).all() and losses[0] != losses[-1]


@pytest.mark.parametrize("name", sorted(workers.REMAT_MESHES[4]))
def test_mesh_training_under_remat_policies_matches_jax(world4, name):
    """The remat policies on the sharded block: "dots_attn" at fsdp ×
    tensor (selective checkpointing beside FSDP2's re-gathers and the
    tensor region's collectives), and the ring (`attention_impl="fused"`,
    its twins at the local heads) at context × tensor under the default
    policy (its forward recomputed) and under "attn" (replayed), held
    against JAX's reference of that mesh at its limits."""
    _, _, res, want = world4
    losses, norms, grads = want[workers.REMAT_MESHES[4][name][0]]
    names = [n for n, _ in DiT(workers.model_config(),
                               device="meta").named_parameters()]
    np.testing.assert_allclose(res[f"{name}.losses"], losses, rtol=RTOL)
    np.testing.assert_allclose(res[f"{name}.grad_norm"], norms, rtol=RTOL)
    rel = ref.rel_l2(res[f"{name}.grads"], ref.flat_grads(grads, names))
    assert rel < RTOL, rel
    assert res[f"{name}.lambda0_none"].all()


@pytest.mark.parametrize("mesh", sorted(workers.MESHES[4]))
def test_every_rank_holds_jax_lambda_and_row_bias_gradients(world4, mesh):
    """λ is replicated but used on each tensor rank's heads, `mlp.2.bias`
    is added once after the row-parallel sum: after the step's reductions
    every rank holds JAX's gradient of both (block 1's λ; block 0's stays
    None, C8)."""
    _, _, res, want = world4
    grads = want[mesh][2]["blocks"]
    # C8: block 0's λ gets JAX's zero gradient from a .grad that stays None
    # on every rank, through FSDP2 and the tensor-axis sum
    assert grads["lambda_param"][0] == 0
    assert res[f"{mesh}.lambda0_none"].all()
    lam = grads["lambda_param"][1]
    bias = grads["mlp"]["fc2"]["bias"][0]
    for r in range(4):
        np.testing.assert_allclose(res[f"{mesh}.lambda"][r], lam,
                                   rtol=RTOL, atol=RTOL * abs(lam).max())
        np.testing.assert_allclose(res[f"{mesh}.mlp2_bias"][r], bias,
                                   rtol=RTOL, atol=RTOL * abs(bias).max())


def test_data_ranks_and_fsdp_leaves(world4):
    """The data rank is the (replica, fsdp) index: tensor and context ranks
    of one data shard share it; FSDP2 holds every leaf the rule shards
    over fsdp (here the block kernels and the 2¹⁶-element time MLP)."""
    _, _, res, _ = world4
    assert res["hsdp.data_rank"].ravel().tolist() == [0, 1, 2, 3]
    assert res["fsdp_tensor.data_rank"].ravel().tolist() == [0, 0, 1, 1]
    assert res["context_tensor.data_rank"].ravel().tolist() == [0, 0, 0, 0]
    managed = set(res["fsdp_tensor.managed"].tolist())
    assert {"time_embed.0.weight", "time_embed.2.weight",
            "blocks.1.qkv.weight", "blocks.0.mlp.2.weight"} <= managed
    assert not any("bias" in n or "norm" in n or "lambda" in n
                   for n in managed)


def test_tensor_ranks_draw_the_same_numbers(world4):
    """Each rank's first timesteps of the Trainer's generator: equal within
    a data shard (tensor and context ranks), different across shards."""
    _, _, res, _ = world4
    for mesh in ("fsdp_tensor", "context_tensor", "hsdp"):
        draws = res[f"{mesh}.draws"]
        ranks = res[f"{mesh}.data_rank"].ravel()
        for a in range(4):
            for b in range(4):
                same = np.array_equal(draws[a], draws[b])
                assert same == (ranks[a] == ranks[b]), (mesh, a, b)


def test_region_operators_match_finite_differences(world4):
    """copy / reduce / gather over a tensor group of 2, fp64: the autograd
    backward against central differences (step 1e-6) of the loss each is
    made for (`region_ops`); measured ~4e-10."""
    _, _, res, _ = world4
    assert res["region_err"].max() < 1e-7, res["region_err"]


def test_checkpoint_resumes_bit_for_bit_on_the_same_mesh(world4):
    """2 steps + save + a fresh Trainer resuming at (fsdp 2, tensor 2) + 2
    steps equals the saving Trainer's 2 more steps exactly; the resumed
    optimizer's kernel table holds the live shards' pointers."""
    _, _, res, _ = world4
    np.testing.assert_array_equal(res["ckpt.resumed"], res["ckpt.continuous"])
    np.testing.assert_array_equal(res["ckpt.resumed_params"],
                                  res["ckpt.continuous_params"])
    assert res["ckpt.pointers_match"][:, 0].all()


def test_checkpoint_restores_at_fsdp_4(world4):
    """The (fsdp 2, tensor 2) checkpoint restored at fsdp 4: the same
    parameters and moments."""
    _, _, res, _ = world4
    np.testing.assert_array_equal(res["ckpt.fsdp4_params"],
                                  res["ckpt.params2"])
    np.testing.assert_array_equal(res["ckpt.fsdp4_moments"],
                                  res["ckpt.moments2"])


def test_checkpoint_restores_in_one_process_and_for_the_sampler(world4,
                                                                tmp_path):
    """The same checkpoint in a world of one: a Trainer resumes it (the
    whole parameters and moments it was saved with, the step and count),
    and `restore_params_for_inference` reads its model."""
    _, _, res, _ = world4
    path = str(res["ckpt.path"])
    cfg = workers.train_config(load_checkpoint=path,
                               checkpoint_dir=str(tmp_path))
    trainer = Trainer(cfg, device="cpu")
    assert trainer.step == 2 and trainer.opt.count == 2
    got = np.concatenate([t.flatten().numpy() for t in
                          workers.whole_params(trainer).values()])
    np.testing.assert_array_equal(got, res["ckpt.params2"])
    np.testing.assert_array_equal(workers.moments(trainer),
                                  res["ckpt.moments2"])
    sd = restore_params_for_inference(path, workers.model_config())
    model = DiT(workers.model_config(), device="cpu")
    model.load_state_dict(sd, strict=True)
    for name, p in model.named_parameters():
        torch.testing.assert_close(p, dict(trainer.model.named_parameters())[
            name], rtol=0, atol=0)


def test_mesh_config_takes_every_axis():
    """fsdp and tensor resolve like the others (no axis refuses)."""
    assert MeshConfig(fsdp=2, tensor=2).resolve(4) == MeshConfig(
        replica=1, fsdp=2, context=1, tensor=2)
    assert MeshConfig(replica=2).resolve(4).fsdp == 2
