"""The JAX side of tests/test_torch_fsdp.py and
tests/test_torch_tensor_parallel.py: the tiny DiT of
`_torch_fsdp_workers.py` trained by JAX `build_train_step` on a mesh of the
conftest's 8 CPU devices, with the same parameters and injected batches.

`build_train_step` draws its timesteps and noise from its key; to inject
them, the batch's `latent` entry carries {latent, timesteps, noise} (its
data sharding applies to the subtree) and the step's loss is wrapped to
pass them, with the workers' RoPE offsets, to `rectified_flow_loss`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax._src import compilation_cache
from jax.sharding import NamedSharding

import _torch_fsdp_workers as workers
from video_diffusion_speedrun_tpu.core.config import DataConfig as JData
from video_diffusion_speedrun_tpu.core.config import DiTConfig as JCfg
from video_diffusion_speedrun_tpu.core.config import MeshConfig as JMesh
from video_diffusion_speedrun_tpu.core.config import (
    OptimizerConfig as JOpt,
)
from video_diffusion_speedrun_tpu.core.config import TrainConfig as JTrain
from video_diffusion_speedrun_tpu.models.dit import init_dit
from video_diffusion_speedrun_tpu.parallel.fsdp import param_shardings
from video_diffusion_speedrun_tpu.parallel.mesh import build_mesh, token_pspec
from video_diffusion_speedrun_tpu.train import step as jstep
from video_diffusion_speedrun_tpu_torch.models.convert import (
    state_dict_from_jax_params,
)

_TINY = {k: v for k, v in workers.TINY.items() if k != "remat"}


def jax_config() -> JCfg:
    return JCfg(**_TINY, attention_impl="xla", fused_adaln="off",
                compute_dtype=jnp.float32, remat=True)


def jax_params():
    """`init_dit` with the zero-initialised AdaLN and output layers, the
    norms and λ moved off their init (else the output is exactly 0)."""
    params = init_dit(jax.random.PRNGKey(1), jax_config(),
                      init_std_factor=0.5)
    params = jax.tree.map(np.array, params)
    r = np.random.default_rng(2)
    for path in (("blocks", "adaLN_modulation"), ("final_modulation",),
                 ("final_proj",)):
        leaf = params
        for key in path:
            leaf = leaf[key]
        for name in ("weight", "bias"):
            leaf[name] = (r.normal(size=leaf[name].shape) * 0.05).astype(
                np.float32)
    blocks = params["blocks"]
    blocks["lambda_param"] = blocks["lambda_param"] + r.normal(
        size=blocks["lambda_param"].shape).astype(np.float32) * 0.1
    for norm in ("norm1", "norm2", "norm3"):
        blocks[norm]["scale"] = blocks[norm]["scale"] + r.normal(
            size=blocks[norm]["scale"].shape).astype(np.float32) * 0.1
    return params


def worker_inputs():
    """The workers' IN.npz: the injected batches and the port state dict
    of `jax_params` (`sd.<name>`)."""
    params = jax_params()
    data = workers.make_batches()
    sd = state_dict_from_jax_params(params, workers.model_config())
    data.update({f"sd.{k}": v.numpy() for k, v in sd.items()})
    return params, data


def _batch(data, i):
    return {"latent": {"latent": data[f"latent{i}"],
                       "timesteps": data[f"timesteps{i}"],
                       "noise": data[f"noise{i}"]},
            "context": data[f"context{i}"]}


def reference(params, data, mesh_shape, steps: int = workers.STEPS):
    """JAX on the mesh (replica, fsdp, context, tensor): the losses and
    grad norms of `steps` `build_train_step` steps, and the step-1
    gradient tree of `value_and_grad` of the same loss, on the same
    mesh."""
    r, f, c, t = mesh_shape
    jcfg = jax_config()
    cfg = JTrain(model=jcfg, mesh=JMesh(replica=r, fsdp=f, context=c,
                                        tensor=t),
                 data=JData(), batch_size=workers.LATENT[0],
                 max_steps=workers.STEPS + 1, caption_dropout=0.0,
                 log_grad_norm=True,
                 optimizer=JOpt(learning_rate=workers.LR, warmup_steps=0))
    mesh = build_mesh(cfg.mesh, devices=jax.devices()[:r * f * c * t])
    orig = jstep.rectified_flow_loss
    offsets = jnp.asarray(workers.ROPE_OFFSETS)

    def injected(p, mcfg, latent, context, rng, **kw):
        return orig(p, mcfg, latent["latent"], context, rng,
                    timesteps=latent["timesteps"], noise=latent["noise"],
                    rope_offsets=offsets, **kw)

    jstep.rectified_flow_loss = injected
    # compiled afresh: the context × tensor step loaded from the suite's
    # persistent compilation cache deadlocks in its collectives on XLA's
    # CPU devices (each device waits in another collective permute until
    # the rendezvous aborts the process). JAX decides once per process
    # whether to use the cache, so the decision is reset around the
    # references.
    cache = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    try:
        # one multi-device program in flight at a time
        init_fn, train_step, _, _ = jstep.build_train_step(cfg, mesh)
        state = jax.block_until_ready(init_fn(jax.random.PRNGKey(0)))
        shd = param_shardings(params, mesh)
        placed = jax.block_until_ready(
            jax.device_put(jax.tree.map(jnp.asarray, params), shd))
        tok = NamedSharding(mesh, token_pspec()) if c > 1 else None

        def loss(p, batch):
            return injected(p, jcfg, batch["latent"], batch["context"],
                            jax.random.PRNGKey(0), alpha=8.0,
                            caption_dropout=0.0, token_sharding=tok)[0]

        grads = jax.block_until_ready(
            jax.jit(jax.grad(loss))(placed, _batch(data, 0)))
        state = state._replace(params=placed)
        losses, norms = [], []
        for i in range(steps):
            state, m = jax.block_until_ready(train_step(
                state, _batch(data, i), jax.random.PRNGKey(0)))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    finally:
        jstep.rectified_flow_loss = orig
        jax.config.update("jax_enable_compilation_cache", cache)
        compilation_cache.reset_cache()
    return (np.asarray(losses), np.asarray(norms),
            jax.tree.map(np.asarray, grads))


def flat_grads(grads, names):
    """A JAX gradient tree flattened in the port's parameter order."""
    sd = state_dict_from_jax_params(grads, workers.model_config())
    return np.concatenate([sd[n].numpy().ravel() for n in names])


def rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))
