"""Context parallelism of the PyTorch port on the CPU: the DiT over a ring
against the JAX `dit_forward(token_sharding=…)`, `DistRing` over gloo in
spawned processes against `LocalRing` and the one-process run, CP and
replica training against the one-process trajectory, and how the mesh
configuration resolves and what it refuses.

Tolerances, fp32 on every side:
- the DiT forward over `LocalRing(4)` against JAX's ring on the 8-device
  CPU mesh: atol 2e-4, rtol 1e-3, as tests/test_torch_dit.py;
- `DistRing` against `LocalRing` of the same size: 1e-6 absolute (the same
  chunk ops and merges in the same order; measured exactly equal);
  against the one-process attention (no ring): 1e-5 of max |want| (the
  merge sums the softmax in another order);
- training over the meshes against one process: the losses of 3 steps to
  1e-5 relative and the step-1 gradients to 1e-5 relative L2 (the ring's
  merge order and the all-reduce's summation order; measured ≤ 3e-7);
  the same meshes under the remat policy "dots_attn" against the default
  policy: 1e-6 relative (the same operations, the ring's forward kept
  instead of run again; measured equal);
- the gathered attention (JAX's XLA attention over the token-sharded axis:
  a no-RoPE model, and head_dim 16 under "plain"), over `LocalRing(2)`
  and over `DistRing(2)` in 2 spawned processes, against JAX
  `dit_forward(token_sharding=…)` on a 2-device context mesh: the output
  to 1e-5 of its largest magnitude, the parameter gradients (summed over
  the ranks) to 1e-5 relative L2.

The workers live in `tests/_torch_cp_workers.py`, which imports no JAX;
they run in one subprocess per world size that spawns its ranks.
"""

import dataclasses
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cp_workers as workers
from video_diffusion_speedrun_tpu.core.config import DiTConfig as JCfg
from video_diffusion_speedrun_tpu.models.dit import dit_forward, init_dit
from video_diffusion_speedrun_tpu_torch.core.config import (
    DiTConfig as TCfg,
    MeshConfig,
)
from video_diffusion_speedrun_tpu_torch.models.convert import (
    state_dict_from_jax_params,
)
from video_diffusion_speedrun_tpu_torch.data.synthetic import (
    SyntheticLatentDataset,
)
from video_diffusion_speedrun_tpu_torch.models.dit import DiT
from video_diffusion_speedrun_tpu_torch.ops import fused_attention as tfa
from video_diffusion_speedrun_tpu_torch.parallel import mesh as pmesh
from video_diffusion_speedrun_tpu_torch.parallel.ring import LocalRing
from video_diffusion_speedrun_tpu_torch.train.loop import Trainer

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(in_channels=4, patch_size=2, time_patch_size=2, hidden_size=64,
            depth=2, num_heads=2, mlp_ratio=4.0, cross_attn_input_size=32,
            residual_v=True, train_bias_and_rms=True)


def _jax_params(jcfg):
    """init_dit with the zero-initialised AdaLN and output layers given
    small random values (else the output is exactly 0)."""
    params = init_dit(jax.random.PRNGKey(1), jcfg, init_std_factor=0.5)
    r = np.random.default_rng(2)
    for path in (("blocks", "adaLN_modulation"), ("final_modulation",),
                 ("final_proj",)):
        leaf = params
        for key in path:
            leaf = leaf[key]
        for name in ("weight", "bias"):
            leaf[name] = jnp.asarray(
                r.normal(size=leaf[name].shape).astype(np.float32) * 0.05)
    return params


# x [B, C, T, H, W]: 80 tokens (chunk 32 at cp = 4, the last 48 rows
# padding) and 29 (chunk 16: chunks 2 and 3 are all padding)
@pytest.mark.parametrize("shape", [(2, 4, 4, 16, 8), (2, 4, 2, 2, 26)])
def test_dit_forward_over_local_ring_matches_jax(shape):
    from jax.sharding import NamedSharding

    from video_diffusion_speedrun_tpu.core.config import MeshConfig as JMesh
    from video_diffusion_speedrun_tpu.parallel.mesh import (
        build_mesh,
        token_pspec,
    )

    jcfg = JCfg(**TINY, attention_impl="pallas", fused_adaln="off",
                compute_dtype=jnp.float32, remat=False)
    tcfg = TCfg(**TINY, attention_impl="fused", fused_adaln="off",
                compute_dtype=torch.float32)
    params = _jax_params(jcfg)
    mesh = build_mesh(JMesh(replica=1, fsdp=2, context=4, tensor=1))
    tok = NamedSharding(mesh, token_pspec())
    r = np.random.default_rng(4)
    x = r.normal(size=shape).astype(np.float32)
    ctx = r.normal(size=(2, 5, 32)).astype(np.float32)
    ts = np.asarray([0.5, 0.8], np.float32)
    off = np.asarray([1, 2, 3], np.int32)
    want = jax.jit(lambda p, x, c, t: dit_forward(
        p, jcfg, x, c, t, rope_offsets=jnp.asarray(off),
        token_sharding=tok))(params, x, ctx, ts)
    model = DiT(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(
        jax.tree.map(np.asarray, params), tcfg), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(ctx),
                    torch.from_numpy(ts), rope_offsets=torch.from_numpy(off),
                    context_parallel=LocalRing(4))
    assert float(np.abs(np.asarray(want)).max()) > 1e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-3)


def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gathered_refs(tmp_path_factory):
    """For each model of `workers.GATHERED`: JAX's output and gradients of
    Σ w·dit_forward with token_sharding on a 2-device context mesh (XLA
    attention; the zero-initialised layers and the positional table made
    random), and the port's state dict of the same weights, written with
    the inputs to IN.npz for the spawned ranks."""
    from jax.sharding import NamedSharding

    from video_diffusion_speedrun_tpu.core.config import MeshConfig as JMesh
    from video_diffusion_speedrun_tpu.parallel.mesh import (
        build_mesh,
        token_pspec,
    )

    mesh = build_mesh(JMesh(replica=1, fsdp=1, context=2, tensor=1),
                      devices=jax.devices()[:2])
    tok = NamedSharding(mesh, token_pspec())
    data = workers.gathered_inputs()
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    want = {}
    for name, (arch, _) in workers.GATHERED.items():
        jcfg = JCfg(**workers.GATHERED_ARCH, **arch, attention_impl="xla",
                    fused_adaln="off", compute_dtype=jnp.float32,
                    remat=False)
        params = _jax_params(jcfg)
        if not jcfg.use_rope:
            params["positional_embedding"] = jnp.asarray(
                np.random.default_rng(3).normal(
                    size=params["positional_embedding"].shape).astype(
                        np.float32))

        def loss(p, jcfg=jcfg):
            out = dit_forward(p, jcfg, jd["x"], jd["context"],
                              jd["timesteps"], rope_offsets=jd["rope_offsets"],
                              token_sharding=tok)
            return jnp.sum(out * jd["w"]), out

        (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            params)
        tcfg = workers.gathered_config(name)
        sd = state_dict_from_jax_params(jax.tree.map(np.asarray, params),
                                        tcfg)
        data.update({f"sd.{name}.{k}": v.numpy() for k, v in sd.items()})
        want[name] = (np.asarray(out), {
            k: v.numpy() for k, v in state_dict_from_jax_params(
                jax.tree.map(np.asarray, grads), tcfg).items()})
    path = tmp_path_factory.mktemp("gathered") / "in.npz"
    np.savez(path, **data)
    return path, data, want


def _hold_gathered(out, grads, want):
    want_out, want_grads = want
    assert float(np.abs(want_out).max()) > 1e-2
    assert np.abs(out - want_out).max() <= 1e-5 * np.abs(want_out).max()
    names = sorted(want_grads)
    assert sorted(grads) == names
    got = np.concatenate([grads[n].ravel() for n in names])
    ref = np.concatenate([want_grads[n].ravel() for n in names])
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel <= 1e-5, rel


@pytest.mark.parametrize("name", sorted(workers.GATHERED))
def test_gathered_attention_over_local_ring_matches_jax(gathered_refs, name,
                                                        monkeypatch):
    """Over `LocalRing(2)` the model takes the gathered attention (never
    the ring) and matches JAX's token-sharded XLA attention."""
    from video_diffusion_speedrun_tpu_torch.models import dit as tdit

    _, data, want = gathered_refs
    calls = []
    monkeypatch.setattr(tdit, "ring_flash_attention",
                        lambda *a, **k: calls.append("ring"))
    gather = tdit._gathered_attention

    def counted(*a, **k):
        calls.append("gathered")
        return gather(*a, **k)

    monkeypatch.setattr(tdit, "_gathered_attention", counted)
    out, grads = workers.gathered(data, name, LocalRing(2))
    # each block's forward and its remat recompute
    assert calls == ["gathered"] * 2 * workers.GATHERED_ARCH["depth"]
    _hold_gathered(out, grads, want[name])


@pytest.fixture(scope="module")
def gathered_dist(gathered_refs):
    path, _, _ = gathered_refs
    out = path.parent / "out.npz"
    run = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_cp_workers.py"),
         "gathered", str(_port()), str(path), str(out)],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-4000:]
    return dict(np.load(out))


@pytest.mark.parametrize("name", sorted(workers.GATHERED))
def test_gathered_attention_over_dist_ring_matches_jax(gathered_refs,
                                                       gathered_dist, name):
    """Over `DistRing(2)` (gloo, 2 processes) each rank attends its q rows
    to the k and v gathered from both; their gradients are summed back
    over the ranks (without that sum the k/v projections' gradients would
    miss the other rank's queries)."""
    _, _, want = gathered_refs
    res = gathered_dist
    prefix = f"{name}.grad."
    grads = {k[len(prefix):]: v for k, v in res.items()
             if k.startswith(prefix)}
    _hold_gathered(res[f"{name}.out"], grads, want[name])


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    path = tmp_path_factory.mktemp("cp") / "inputs.npz"
    data = workers.make_inputs()
    np.savez(path, **data)
    return path, data


@pytest.fixture(scope="module", params=sorted(workers.MESHES))
def spawned(request, inputs):
    """One subprocess per world size; it spawns the ranks over gloo."""
    world = request.param
    path, data = inputs
    out = path.parent / f"out{world}.npz"
    run = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_cp_workers.py"),
         str(world), str(_port()), str(path), str(out)],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-4000:]
    return world, data, dict(np.load(out))


def test_dist_ring_matches_local_ring_and_one_process(spawned):
    world, data, res = spawned
    local = workers.attention(data, LocalRing(world))
    for name, got, want in zip(("out", "dq", "dk", "dv"),
                               [res[n] for n in ("out", "dq", "dk", "dv")],
                               local):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                   err_msg=name)
    ts = [torch.from_numpy(data[n]).requires_grad_() for n in "qkv"]
    one = tfa.rope_flash_attention(*ts, torch.from_numpy(data["cos"]),
                                   torch.from_numpy(data["sin"]),
                                   workers.HEADS)
    one.backward(torch.from_numpy(data["do"]))
    for name, want in zip(("out", "dq", "dk", "dv"),
                          [one.detach()] + [t.grad for t in ts]):
        want = want.numpy()
        assert np.abs(res[name] - want).max() <= 1e-5 * np.abs(want).max(), \
            name


def test_mesh_training_matches_one_process(spawned):
    """3 steps at `--mesh_context 2` (2 processes) and at `--mesh_replica 2
    --mesh_context 2` (4 processes) against the one-process trajectory on
    the same injected global batches."""
    world, data, res = spawned
    assert float(res["avg_rank"]) == (world - 1) / 2  # the host collectives
    losses, grads = workers.train(data, Trainer(workers.train_config(),
                                                device="cpu"))
    np.testing.assert_allclose(res["losses"], losses, rtol=1e-5)
    rel = np.linalg.norm(res["grads"] - grads) / np.linalg.norm(grads)
    assert rel < 1e-5, rel
    assert np.isfinite(losses).all() and losses[0] != losses[-1]


def test_mesh_training_under_dots_attn_matches_the_default_policy(spawned):
    """The same 3 steps under the remat policy "dots_attn": the ring's
    forward is kept for the backward (no chunk forward, merge or shift in
    the recompute) and the linear layers' outputs reused, over `DistRing`
    and the replica group."""
    _, _, res = spawned
    np.testing.assert_allclose(res["dots_attn.losses"], res["losses"],
                               rtol=1e-6)
    rel = np.linalg.norm(res["dots_attn.grads"] - res["grads"]) / \
        np.linalg.norm(res["grads"])
    assert rel <= 1e-6, rel


def test_mfu_holds_a_step_against_every_card_of_the_group(spawned):
    """MFU reads the world size: one card's peak of work in one second is
    1 in a world of one and 1/world across `world` processes."""
    from video_diffusion_speedrun_tpu_torch.utils.flops import PEAK_FLOPS, mfu

    world, _, res = spawned
    card = "NVIDIA H100 80GB HBM3"
    assert mfu(PEAK_FLOPS[card], 1.0, card) == 1.0
    assert float(res["mfu_one_card"]) == pytest.approx(1 / world)


def test_mesh_config_resolve_and_refusals():
    assert MeshConfig(replica=2, context=2).resolve(4) == MeshConfig(
        replica=2, fsdp=1, context=2, tensor=1)
    assert MeshConfig(fsdp=1, context=-1).resolve(4).context == 4
    with pytest.raises(ValueError, match="devices"):
        MeshConfig(fsdp=1, context=4).resolve(2)
    with pytest.raises(ValueError, match="at most one"):
        MeshConfig(replica=-1, context=-1).resolve(4)
    with pytest.raises(ValueError, match="divisible"):
        MeshConfig(context=3).resolve(4)
    with pytest.raises(ValueError):
        MeshConfig(context=0)
    # FSDP and tensor axes resolve like the others
    assert MeshConfig(fsdp=2).resolve(2) == MeshConfig(
        replica=1, fsdp=2, context=1, tensor=1)
    assert MeshConfig(fsdp=1, tensor=2).resolve(2).tensor == 2
    assert MeshConfig(fsdp=2, tensor=2).resolve(4) == MeshConfig(
        replica=1, fsdp=2, context=1, tensor=2)
    # fsdp's −1 takes the rest of the world
    assert MeshConfig(context=2).resolve(4) == MeshConfig(
        replica=1, fsdp=2, context=2, tensor=1)


def test_one_process_mesh_takes_no_ring_and_refuses_a_context_axis():
    """A world of one has no process group and no mesh; the Trainer then
    takes no ring unless one is passed (a `LocalRing` is never chosen for
    the caller), and a context axis > 1 without a launcher raises, in the
    library and in both CLIs."""
    from video_diffusion_speedrun_tpu_torch import sample
    from video_diffusion_speedrun_tpu_torch.train import __main__ as cli

    from video_diffusion_speedrun_tpu_torch.parallel import collectives

    assert pmesh.build_mesh(MeshConfig(), "cpu") is None
    assert collectives.avg_scalar_across_hosts(3) == 3.0
    collectives.barrier()  # a no-op in a world of one
    assert pmesh.local_batch_slice(None, 4) == 4
    trainer = Trainer(workers.train_config(), device="cpu")
    assert trainer.context_parallel is None and trainer.data_group is None
    ring = LocalRing(2)
    assert Trainer(workers.train_config(), device="cpu",
                   context_parallel=ring).context_parallel is ring
    with pytest.raises(ValueError, match="devices"):
        pmesh.build_mesh(MeshConfig(fsdp=1, context=2), "cpu")
    with pytest.raises(ValueError):
        cli.main(["--device", "cpu", "--mesh_context", "2", "--model_width",
                  "64", "--model_depth", "1", "--model_head_dim", "32"])
    with pytest.raises(ValueError):
        sample.main(["--device", "cpu", "--mesh_context", "2"])


def test_eval_batch_clamps_to_the_replicas(tmp_path):
    """At `--mesh_replica 3` and batch 48 the first evaluation (after step
    1) clamps the global batch to 39, the largest multiple of the 3 data
    shards that the 40-row test split fills, and logs it, as JAX's
    `_loader` (`train/loop.py:132-157`)."""
    out = tmp_path / "eval.npz"
    port = _port()
    # run in tmp_path: the evaluation saves a checkpoint under the working
    # directory's checkpoints/
    run = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_cp_workers.py"),
         "eval", str(port), str(out)],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert run.returncode == 0, run.stderr[-4000:]
    res = dict(np.load(out))
    assert float(res["eval_rows"][0]) == 39
    assert "eval batch clamped 48 -> 39 (test split has 40 rows)" in list(
        res["lines"])
    assert np.isfinite(res["loss"])
    assert (tmp_path / "checkpoints" / "diffusion_repa" / "1" /
            ".metadata").exists()


def test_eval_batch_raises_when_the_split_cannot_fill_the_shards(
        monkeypatch):
    trainer = Trainer(dataclasses.replace(workers.train_config(),
                                          batch_size=4), device="cpu")
    trainer.datasets["test"] = SyntheticLatentDataset(
        num_rows=2, latent_shape=workers.LATENT[1:], seed=1)
    monkeypatch.setattr(pmesh, "data_shards", lambda mesh: 3)
    with pytest.raises(ValueError, match="cannot fill one batch slice"):
        next(trainer.batches("test"))
