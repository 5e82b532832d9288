"""The port's checkpoints on the CPU: a resumed run against the continuous
run (bit for bit), the checkpoint-path rules of the JAX package, the
reference's checkpoints, the sampler's params-only restore, and a JAX
orbax checkpoint carried over to the port.

Resumes must give exactly the continuous run's losses, parameters,
moments and generator state (CPU ops are deterministic). The JAX
checkpoint's latents are compared in fp32 within atol 2e-4, rtol 1e-3,
the sampler tests' tolerance (the same forward summed in another order
through 3 Euler steps at CFG 6).
"""

import dataclasses
import logging
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_diffusion_speedrun_tpu.core.config import DiTConfig as JCfg
from video_diffusion_speedrun_tpu.core.config import MeshConfig as JMesh
from video_diffusion_speedrun_tpu.core.config import (
    OptimizerConfig as JOpt,
)
from video_diffusion_speedrun_tpu.core.config import TrainConfig as JTrain
from video_diffusion_speedrun_tpu.parallel.mesh import build_mesh
from video_diffusion_speedrun_tpu.sampling import euler as jeuler
from video_diffusion_speedrun_tpu.train import checkpoint as jckpt
from video_diffusion_speedrun_tpu.train.step import build_train_step
from video_diffusion_speedrun_tpu_torch.core.config import (
    DataConfig,
    DiTConfig,
    OptimizerConfig,
    TrainConfig,
)
from video_diffusion_speedrun_tpu_torch.models.convert import (
    state_dict_from_jax_params,
)
from video_diffusion_speedrun_tpu_torch.models.dit import DiT
from video_diffusion_speedrun_tpu_torch.sampling import euler as teuler
from video_diffusion_speedrun_tpu_torch.train import checkpoint as tckpt
from video_diffusion_speedrun_tpu_torch.train import loop as tloop
from video_diffusion_speedrun_tpu_torch.train.__main__ import main as cli

ROOT = Path(__file__).resolve().parent.parent
MODEL = DiTConfig(in_channels=4, hidden_size=64, depth=2, num_heads=2,
                  cross_attn_input_size=32, residual_v=True,
                  train_bias_and_rms=True, compute_dtype=torch.float32,
                  attention_impl="plain", fused_adaln="off")


def _cfg(tmp_path, name="run", t_choices=(), **kw) -> TrainConfig:
    data = DataConfig(synthetic_rows=12, synthetic_shape=(4, 4, 8, 8),
                      synthetic_t_choices=t_choices,
                      bucket_by_shape=bool(t_choices), test_rows=4,
                      caption_tokens=6, context_dim=32)
    return TrainConfig(model=MODEL, data=data, batch_size=2, max_steps=6,
                       evaluate_every=3, eval_batches=1, log_every=1,
                       optimizer=OptimizerConfig(learning_rate=0.01,
                                                 warmup_steps=2),
                       checkpoint_dir=str(tmp_path / name), **kw)


def _perturb(model) -> None:
    """Seeded values for the zero-initialised AdaLN and output layers (at
    the zero init the DiT outputs exactly 0)."""
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        lins = [blk.adaLN_modulation[1] for blk in model.blocks]
        for lin in lins + [model.final_modulation[1], model.final_proj]:
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=gen)
                             * 0.05)


def _trainer(cfg) -> tloop.Trainer:
    t = tloop.Trainer(cfg, device="cpu")
    if cfg.load_checkpoint is None:
        _perturb(t.model)
    return t


def _state(t: tloop.Trainer):
    return ([p.detach().clone() for p in t.model.parameters()]
            + [m.clone() for m in t.opt.m + t.opt.v])


def _losses(t: tloop.Trainer):
    return [r["train/total_loss"] for r in t.history]


@pytest.mark.parametrize("t_choices,stop,where", [
    ((), 2, "root"), ((), 4, "step"), ((4, 8), 3, "root")])
def test_resumed_run_equals_the_continuous_run(tmp_path, t_choices, stop,
                                               where):
    """6 steps at once, or `stop` steps, a save, and a fresh Trainer that
    resumes (from the run root's latest step or the step dir) and trains
    the rest: the same losses, parameters, moments, update count and
    generator state, bit for bit; with mixed lengths the shape-bucketing
    collate's stream carries on too."""
    whole = _trainer(_cfg(tmp_path, "whole", t_choices))
    whole.train()
    first = _trainer(_cfg(tmp_path, "first", t_choices))
    first.train(until=stop)
    step_dir = first.save_checkpoint()
    assert step_dir == str(tmp_path / "first" / "diffusion_repa" / str(stop))
    load = step_dir if where == "step" else str(Path(step_dir).parent)
    resumed = _trainer(_cfg(tmp_path, "again", t_choices,
                            load_checkpoint=load))
    assert resumed.step == stop and resumed.opt.count == stop
    resumed.train()
    assert _losses(whole) == _losses(first) + _losses(resumed)
    for a, b in zip(_state(whole), _state(resumed)):
        assert torch.equal(a, b)
    assert torch.equal(whole.generator.get_state(),
                       resumed.generator.get_state())
    assert resumed.opt.count == resumed.step == 6
    # the evaluation at step 1 (and 4) saved the state as it went
    assert whole.ckpt.latest_step() == 4
    assert tckpt.is_port_checkpoint(str(tmp_path / "whole" / "diffusion_repa"))


def test_resumed_inloop_run_equals_the_continuous_run(tmp_path):
    """The optimizer-in-backward step with factored ν (every block weight,
    `nu_factored_min_size` 1) on bf16 parameters and bf16 moments: 6
    steps at once against 2, a save (the factors under "vr"/"vc"), and a
    fresh Trainer that resumes: the same losses, parameters, moments and
    factors, bit for bit."""
    def cfg(name, **kw):
        c = _cfg(tmp_path, name, **kw)
        return dataclasses.replace(
            c, model=MODEL.replace(param_dtype=torch.bfloat16),
            optimizer=dataclasses.replace(
                c.optimizer, in_backward=True, nu_factored=True,
                nu_factored_min_size=1, moments_dtype=torch.bfloat16))

    def state(t):
        out = [p.detach().clone() for p in t.model.parameters()]
        for m, v in zip(t.opt.m, t.opt.v):
            out += [m.clone()] + [x.clone() for x in (
                v if isinstance(v, tuple) else (v,))]
        return out

    whole = _trainer(cfg("whole"))
    whole.train()
    assert any(whole.opt.factored)
    assert all(p.dtype == torch.bfloat16 for p in whole.model.parameters())
    first = _trainer(cfg("first"))
    first.train(until=2)
    resumed = _trainer(cfg("again", load_checkpoint=first.save_checkpoint()))
    assert resumed.step == 2 and resumed.opt.count == 2
    resumed.train()
    assert _losses(whole) == _losses(first) + _losses(resumed)
    for a, b in zip(state(whole), state(resumed)):
        assert torch.equal(a, b)


def test_cli_saves_and_resumes(tmp_path):
    """The train CLI: `--checkpoint_dir/--run_name` get the evaluation's
    checkpoint; `--load_checkpoint` resumes it and trains the rest."""
    flags = ["--device", "cpu", "--max_steps", "3", "--batch_size", "2",
             "--model_width", "64", "--model_depth", "2", "--model_head_dim",
             "32", "--context_dim", "32", "--synthetic_rows", "8",
             "--log_every", "1", "--evaluate_every", "100",
             "--checkpoint_dir", str(tmp_path), "--run_name", "r1"]
    cli(flags)
    run = tmp_path / "r1"
    assert tckpt.CheckpointManager(str(run)).latest_step() == 1
    out = cli(flags + ["--load_checkpoint", str(run), "--run_name", "r2"])
    assert np.isfinite(out["train/total_loss"])
    assert out["train/step"] == 2  # steps 1 and 2 ran after the resume


def test_replicas_and_a_ring_save_and_resume_over_gloo(tmp_path):
    """4 processes (replica 2 × context 2) over gloo: every rank takes part
    in the DCP save and load; each replica's generator comes back; the
    resumed run equals the continuous one on every rank."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = tmp_path / "ckpt.npz"
    run = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "test_torch_t2v_workers.py"),
         "ckpt", str(port), str(out)],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-4000:]
    res = dict(np.load(out))
    assert float(res["same"][0]) == 1.0
    assert len(res["whole"]) == 4
    np.testing.assert_array_equal(
        res["whole"], np.concatenate([res["first"], res["resumed"]]))


def test_split_checkpoint_path_rules(tmp_path):
    """The JAX package's cases: an all-digit run name with checkpoints is
    a run root, its digit subdirectory a step; an existing all-digit root
    with no checkpoints yet (or only an unfinished one) is a root; a
    nonexistent digit path reads as a step dir."""
    t = _trainer(_cfg(tmp_path, "x"))
    t.ckpt = tckpt.CheckpointManager(str(tmp_path / "20260819"))
    t.step = 1
    t.save_checkpoint()
    run = tmp_path / "20260819"
    assert tckpt.split_checkpoint_path(str(run)) == (str(run), None)
    assert tckpt.split_checkpoint_path(str(run / "1")) == (str(run), 1)
    sd = tckpt.restore_params_for_inference(str(run), MODEL)
    torch.testing.assert_close(sd["final_proj.weight"],
                               t.model.final_proj.weight, rtol=0, atol=0)

    empty = tmp_path / "20260820"
    empty.mkdir()
    assert tckpt.split_checkpoint_path(str(empty)) == (str(empty), None)
    (empty / "1").mkdir()  # a save that has not written its metadata yet
    assert tckpt.split_checkpoint_path(str(empty)) == (str(empty), None)
    assert tckpt.CheckpointManager(str(empty)).latest_step() is None
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        tckpt.restore_params_for_inference(str(empty))
    gone = tmp_path / "run" / "120"
    assert tckpt.split_checkpoint_path(str(gone)) == (str(gone.parent), 120)


def test_reference_checkpoints_load_with_prefixes(tmp_path, caplog):
    """A reference `.pt` with `module.` and a reference DCP directory with
    `_orig_mod.` give the model's state dict (a name the model lacks is
    dropped); the DCP one is converted once to its `temp.pt`; the Trainer
    loads weights only and warns about the RoPE order."""
    import torch.distributed.checkpoint as dcp

    model = DiT(MODEL, device="cpu", seed=3)
    want = model.state_dict()
    pt = tmp_path / "ref.pt"
    torch.save({f"module.{k}": v for k, v in want.items()}, pt)
    ddir = tmp_path / "ref_dcp"
    extra = {"_orig_mod.rope_cache": torch.zeros(3)}
    dcp.save({**{f"_orig_mod.{k}": v.clone() for k, v in want.items()},
              **extra}, checkpoint_id=str(ddir))
    for path in (str(pt), str(ddir)):
        assert tckpt.is_torch_reference_checkpoint(path)
        assert not tckpt.is_port_checkpoint(path)
        got = tckpt.load_reference_checkpoint(path, MODEL)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert (ddir / "temp.pt").exists()

    with caplog.at_level(logging.WARNING, logger=tloop.logger.name):
        t = tloop.Trainer(_cfg(tmp_path, "r", load_checkpoint=str(pt)),
                          device="cpu")
    assert "rope_order='matched'" in caplog.text
    assert t.step == 0 and t.opt.count == 0
    for k, v in t.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_restore_params_for_inference_checks_the_config(tmp_path):
    t = _trainer(_cfg(tmp_path, "c"))
    t.train(until=1)
    path = t.save_checkpoint()
    assert tckpt.is_port_checkpoint(path)
    assert not tckpt.is_torch_reference_checkpoint(path)
    sd = tckpt.restore_params_for_inference(path, _cfg(tmp_path, "c"))
    assert sd.keys() == t.model.state_dict().keys()
    with pytest.raises(ValueError, match="param shapes do not match the "
                                        "model config"):
        tckpt.restore_params_for_inference(
            path, MODEL.replace(hidden_size=128, num_heads=4))
    with pytest.raises(ValueError, match="param tree does not match the "
                                        "model config"):
        tckpt.restore_params_for_inference(path, MODEL.replace(depth=3))


def test_jax_orbax_checkpoint_samples_the_same_latents(tmp_path):
    """A JAX train state saved with orbax, restored by the JAX package's
    `restore_params_for_inference` and carried over by
    `state_dict_from_jax_params`: both packages sample the same latents
    from the same noise and context."""
    sizes = dict(in_channels=4, patch_size=2, time_patch_size=2,
                 hidden_size=64, depth=2, num_heads=2,
                 cross_attn_input_size=32, residual_v=True,
                 train_bias_and_rms=True)
    jcfg = JCfg(**sizes, attention_impl="xla", fused_adaln="off",
                compute_dtype=jnp.float32)
    train = JTrain(model=jcfg, mesh=JMesh(replica=1, fsdp=8),
                   optimizer=JOpt(learning_rate=0.01, scheduler="constant",
                                  warmup_steps=0),
                   batch_size=8, max_steps=10)
    init_fn, step_fn, _, _ = build_train_step(train, build_mesh(train.mesh))
    state = init_fn(jax.random.PRNGKey(0))
    batch = {"latent": jax.random.normal(jax.random.PRNGKey(1),
                                         (8, 4, 4, 8, 8)),
             "context": jax.random.normal(jax.random.PRNGKey(2), (8, 6, 32))}
    for i in range(2):  # the zero-initialised layers move
        state, _ = step_fn(state, batch, jax.random.PRNGKey(3 + i))
    mgr = jckpt.CheckpointManager(str(tmp_path / "jrun"))
    mgr.save(int(state.step), state)
    mgr.wait()
    mgr.close()
    params = jax.tree.map(np.asarray, jckpt.restore_params_for_inference(
        str(tmp_path / "jrun"), jcfg))
    tcfg = DiTConfig(**sizes, attention_impl="plain", fused_adaln="off",
                     compute_dtype=torch.float32)
    model = DiT(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, tcfg),
                          strict=True)
    r = np.random.default_rng(4)
    lat = r.normal(size=(1, 4, 4, 8, 8)).astype(np.float32)
    ctx = r.normal(size=(1, 6, 32)).astype(np.float32)
    want = np.asarray(jeuler.euler_cfg_sample(
        params, jcfg, jnp.asarray(lat), jnp.asarray(ctx), num_steps=3,
        cfg_scale=6.0))
    got = teuler.euler_cfg_sample(model, torch.from_numpy(lat),
                                  torch.from_numpy(ctx), num_steps=3,
                                  cfg_scale=6.0).numpy()
    assert np.abs(want - lat).max() > 1e-2  # the trained model moved them
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_trainer_checkpoint_dir_layout(tmp_path):
    """`checkpoint_dir/run_name/<step>/` as the JAX Trainer's, holding the
    step, the update count and the generator state beside the weights."""
    t = _trainer(dataclasses.replace(_cfg(tmp_path, "l"), run_name="exp"))
    t.train(until=2)
    path = Path(t.save_checkpoint())
    assert path == tmp_path / "l" / "exp" / "2"
    keys = set(tckpt._metadata_keys(str(path)))
    assert {tckpt.STEP_KEY, "optim.count", "rng.0",
            "model.final_proj.weight", "optim.m.final_proj.weight",
            "optim.v.final_proj.weight"} <= keys
