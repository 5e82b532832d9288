"""Train and eval steps (port of `train/step.py`).

`train_step` runs the loss forward, its backward (remat recomputes each
block) and one muP-AdamW update, and returns the step's metrics as device
tensors, so the caller decides when to read them back. With
`grad_accum > 1` the batch splits into equal microbatches whose gradients
and losses are averaged and whose bins are summed (`accumulate_grads`,
`step.py:42-74`). A batch may inject `timesteps`, `noise` (split with the
batch) and `rope_offsets` (shared); a batch with no `context` gets
0.05·N(0, 1) [b, caption_tokens, context_dim] drawn on the device in the
compute dtype (`step.py:132-141`). Under a profiler the step is a
`vds/step` span holding each microbatch's `vds/step/forward` and
`vds/step/backward` (`utils/profiling.py:span`); the reductions after them
are the step's own time.

Across processes (`parallel/mesh.py`) the step reduces what GSPMD reduces
in JAX. FSDP2 (`parallel/fsdp.py`) reduce-scatters the sharded parameters'
gradients inside `backward`, averaged over the data shards (replica ×
fsdp). Then, on each rank's local shards: every gradient is summed over
the context ring's group (each rank's backward holds its own tokens'
share); the gradients of replicated leaves used inside the tensor region
(λ, the column-parallel biases) are summed over the tensor group; the
leaves FSDP2 does not hold are averaged over the data group. grad_norm is
the norm of the global gradient: each shard counted once, a replicated
leaf once. The loss is averaged and the decile bins summed over the data
group. `LocalRing` (all ranks in one process) needs no reduction.

On one card (`graph_engages`: a CUDA batch, an unsharded model, no
context ring, no data group, no accumulation) the step's forward and
backward are CUDA graphs, replayed on every call of the same `graph_key`
(`StepGraph`): the first call of a key runs eagerly on the graphs' side
stream (the warm-up), the second captures and replays, and later calls
replay. The update stays eager. `train_step.captures`, `.replays` and
`.eager_steps` count the steps on a card by kind (a capture's step also
replays); every other step runs `eager_train_step`.

`step_for(cfg)` picks the step of the config, as JAX's `build_train_step`
branches on `optimizer.in_backward` (`step.py:218-317`): `train_step`,
or the optimizer-in-backward step of `train/inloop.py`, which refuses the
context axis and `log_grad_norm` as JAX's branch does.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch

from video_diffusion_speedrun_tpu_torch.core.config import TrainConfig
from video_diffusion_speedrun_tpu_torch.models.dit import DiT
from video_diffusion_speedrun_tpu_torch.parallel.collectives import (
    all_reduce_,
    local,
)
from video_diffusion_speedrun_tpu_torch.train.loss import rectified_flow_loss
from video_diffusion_speedrun_tpu_torch.train.optim import MupAdamW
from video_diffusion_speedrun_tpu_torch.utils.profiling import span

_SPLIT = ("latent", "context", "timesteps", "noise")


def _loss(model: DiT, batch: Dict, generator: Optional[torch.Generator],
          cfg: TrainConfig, context_parallel):
    mcfg = model.cfg
    latent = batch["latent"]
    context = batch.get("context")
    if context is None and mcfg.cross_attn_input_size is not None:
        context = 0.05 * torch.randn(
            latent.shape[0], cfg.data.caption_tokens, cfg.data.context_dim,
            generator=generator, device=latent.device,
            dtype=mcfg.compute_dtype)
    return rectified_flow_loss(
        model, latent, context, generator, alpha=cfg.time_shift_alpha,
        caption_dropout=cfg.caption_dropout,
        timesteps=batch.get("timesteps"), noise=batch.get("noise"),
        rope_offsets=batch.get("rope_offsets"),
        context_parallel=context_parallel)


def _microbatches(batch: Dict, n: int):
    if n <= 1:
        return [batch]
    b = batch["latent"].shape[0]
    micro = b // n
    return [{k: (v[i * micro:(i + 1) * micro] if k in _SPLIT else v)
             for k, v in batch.items()} for i in range(n)]


def train_step(model: DiT, opt: MupAdamW, batch: Dict,
               generator: Optional[torch.Generator], cfg: TrainConfig,
               context_parallel=None, data_group=None
               ) -> Dict[str, torch.Tensor]:
    """One optimizer step on this replica's `batch`. Returns {loss,
    lr_scale, bin_sums, bin_counts, timesteps [, grad_norm]}, the tensors
    each in storage of its own; lr_scale is λ of this update (the count
    before it), timesteps this replica's draws [b]. `context_parallel`: the ring
    that splits the tokens; `data_group`: the process group of the
    replicas (None: one). On a card the step replays its CUDA graphs
    where `graph_engages` and `graph_key` allow (`StepGraphs`)."""
    dev = batch["latent"].device
    if dev.type != "cuda":
        return eager_train_step(model, opt, batch, generator, cfg,
                                context_parallel, data_group)
    key = (graph_key(model, batch, generator, cfg)
           if graph_engages(dev, model, cfg, context_parallel, data_group)
           else None)
    if key is None:
        train_step.eager_steps += 1
        return eager_train_step(model, opt, batch, generator, cfg,
                                context_parallel, data_group)
    if opt.step_graphs is None:
        opt.step_graphs = StepGraphs(dev)
    return opt.step_graphs.step(key, model, opt, batch, generator, cfg)


train_step.captures = 0  # StepGraph captures
train_step.replays = 0  # steps that replayed a StepGraph, a capture's too
train_step.eager_steps = 0  # steps on a card that ran eager_train_step


def eager_train_step(model: DiT, opt: MupAdamW, batch: Dict,
                     generator: Optional[torch.Generator], cfg: TrainConfig,
                     context_parallel=None, data_group=None
                     ) -> Dict[str, torch.Tensor]:
    """`train_step` as every op's own launch, never captured: the path of
    each step that replays no graph."""
    dev = batch["latent"].device
    with span("step", dev):
        accum = cfg.grad_accum
        loss_sum = 0.0
        bin_sums = bin_counts = 0.0
        timesteps = []
        for mb in _microbatches(batch, accum):
            with span("step/forward", dev):
                loss, aux = _loss(model, mb, generator, cfg,
                                  context_parallel)
            with span("step/backward", dev):
                loss.backward()
            loss_sum = loss_sum + loss.detach()
            bin_sums = bin_sums + aux["bin_sums"]
            bin_counts = bin_counts + aux["bin_counts"]
            timesteps.append(aux["timesteps"])
        grads = [p.grad for p in opt.params]
        if accum > 1:
            for g in grads:
                if g is not None:
                    local(g).mul_(1.0 / accum)
        sharding = getattr(model, "sharding", None)
        all_reduce_(grads, getattr(context_parallel, "group", None))
        if sharding is None:
            all_reduce_(grads, data_group, mean=True)
        else:
            all_reduce_([g for n, g in zip(opt.names, grads)
                         if n in sharding.tensor_partial],
                        sharding.tensor_group)
            all_reduce_([g for n, g in zip(opt.names, grads)
                         if n not in sharding.fsdp_managed], data_group,
                        mean=True)
        loss = loss_sum / accum if accum > 1 else loss_sum
        all_reduce_([loss], data_group, mean=True)
        all_reduce_([bin_sums, bin_counts], data_group)
        metrics = {"loss": loss, "lr_scale": opt.lr_scale(),
                   "bin_sums": bin_sums, "bin_counts": bin_counts,
                   "timesteps": torch.cat(timesteps)}
        if cfg.log_grad_norm:
            metrics["grad_norm"] = grad_norm(opt.names, grads, sharding)
        opt.step(grads)
        for p in opt.params:
            p.grad = None
        return metrics


def graph_engages(device: torch.device, model: DiT, cfg: TrainConfig,
                  context_parallel=None, data_group=None) -> bool:
    """Whether a step on `device` may replay CUDA graphs: a card, a model
    that no process shares (no FSDP2 or tensor sharding), no context ring,
    no data group and one microbatch. Each of the others launches its
    collectives or splits the batch on the host."""
    return (device.type == "cuda" and getattr(model, "sharding", None) is None
            and context_parallel is None and data_group is None
            and cfg.grad_accum == 1)


def graph_key(model: DiT, batch: Dict, generator: Optional[torch.Generator],
              cfg: TrainConfig) -> Optional[Tuple]:
    """What a captured step depends on beyond the batch's values: the
    model and the generator (by identity), each batch tensor's name,
    shape, dtype and device, and the fields of `cfg` that `_loss` reads.
    None where a batch entry is no tensor on the latent's device."""
    dev = batch["latent"].device
    shapes = []
    for k in sorted(batch):
        v = batch[k]
        if not isinstance(v, torch.Tensor) or v.device != dev:
            return None
        shapes.append((k, tuple(v.shape), v.dtype))
    return (model, generator, dev, tuple(shapes), cfg.caption_dropout,
            cfg.time_shift_alpha, cfg.data.caption_tokens,
            cfg.data.context_dim)


@contextlib.contextmanager
def _parameters_as(model: DiT, names: Sequence[str],
                   tensors: Sequence[torch.Tensor]) -> Iterator[None]:
    """The model's parameters `names` replaced by `tensors` inside the
    block."""
    slots = []
    for name, t in zip(names, tensors):
        owner, _, attr = name.rpartition(".")
        mod = model.get_submodule(owner)
        slots.append((mod, attr, mod._parameters[attr]))
        mod._parameters[attr] = t
    try:
        yield
    finally:
        for mod, attr, p in slots:
            mod._parameters[attr] = p


def loss_and_grads(model: DiT, opt: MupAdamW, batch: Dict,
                   generator: Optional[torch.Generator], cfg: TrainConfig,
                   forward=contextlib.nullcontext,
                   backward=contextlib.nullcontext):
    """(loss, aux, grads): `_loss` and the gradient of each of `opt`'s
    parameters (None where it takes none), the values and layout that
    `loss.backward()` leaves in `.grad`, but taken through fresh leaves
    that alias the parameters: no `.grad` is written, and no autograd node
    of a parameter is used, so a capture never meets a node that an
    outside backward left alive on another stream. `forward()` and
    `backward()` give the contexts the two halves run in (the step's two
    graph captures)."""
    leaves = [p.detach().requires_grad_() for p in opt.params]
    with _parameters_as(model, opt.names, leaves):
        with forward():
            loss, aux = _loss(model, batch, generator, cfg, None)
        with backward():
            grads = [g if g is None else g.contiguous() for g in
                     torch.autograd.grad(loss, leaves, allow_unused=True)]
    return loss.detach(), aux, grads


_OPS = "video_diffusion_speedrun_tpu_torch.ops."


def launch_counters() -> Dict[Tuple[object, str], int]:
    """Every launch counter of the fused ops loaded now: (owner, name) →
    count, the owner a function or class of an `ops` module and the name
    `launches` or one ending in `_launches`."""
    out = {}
    for name, mod in list(sys.modules.items()):
        if not name.startswith(_OPS) or mod is None:
            continue
        for owner in vars(mod).values():
            if getattr(owner, "__module__", None) != name:
                continue
            for attr, n in vars(owner).items():
                if (attr == "launches" or attr.endswith("_launches")) \
                        and type(n) is int:
                    out[(owner, attr)] = n
    return out


def credit_launches(launches: Dict[Tuple[object, str], int]) -> None:
    """Add `launches` to the launch counters they name."""
    for (owner, attr), n in launches.items():
        setattr(owner, attr, getattr(owner, attr) + n)


class StepGraph:
    """The forward and the backward of one `graph_key`'s step, captured as
    two CUDA graphs over one private memory pool (as
    `torch.cuda.make_graphed_callables` pairs them) on `stream`: `_loss`
    with its draws from `generator` (registered, so that each replay
    advances it as an eager step does), then its gradients
    (`loss_and_grads`), into tensors the graph keeps. A replay copies the
    batch into the static inputs, replays both graphs inside the step's
    phase spans, and updates eagerly from the kept gradients. The capture
    launches nothing; each replay adds to the ops' launch counters what
    the capture's calls added."""

    def __init__(self, key: Tuple, stream: torch.cuda.Stream, model: DiT,
                 opt: MupAdamW, batch: Dict,
                 generator: Optional[torch.Generator], cfg: TrainConfig):
        dev = batch["latent"].device
        self.key = key
        self.inputs = {k: v.clone() for k, v in batch.items()}
        self.fwd, self.bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        if generator is not None \
                and generator is not torch.cuda.default_generators[dev.index]:
            self.fwd.register_generator_state(generator)
        before = launch_counters()
        loss, aux, self.grads = loss_and_grads(
            model, opt, self.inputs, generator, cfg,
            lambda: torch.cuda.graph(self.fwd, stream=stream),
            lambda: torch.cuda.graph(self.bwd, pool=self.fwd.pool(),
                                     stream=stream))
        self.outputs = (loss, aux["bin_sums"], aux["bin_counts"],
                        aux["timesteps"])
        after = launch_counters()
        self.launches = {k: n - before.get(k, 0) for k, n in after.items()
                         if n != before.get(k, 0)}
        credit_launches({k: -n for k, n in self.launches.items()})

    def replay(self, opt: MupAdamW, batch: Dict,
               cfg: TrainConfig) -> Dict[str, torch.Tensor]:
        """`train_step` on `batch` (of this graph's key) by the graphs."""
        dev = batch["latent"].device
        with span("step", dev):
            for k, v in batch.items():
                self.inputs[k].copy_(v)
            with span("step/forward", dev):
                self.fwd.replay()
            with span("step/backward", dev):
                self.bwd.replay()
            credit_launches(self.launches)
            loss, bin_sums, bin_counts, timesteps = (
                t.clone() for t in self.outputs)
            metrics = {"loss": loss, "lr_scale": opt.lr_scale(),
                       "bin_sums": bin_sums, "bin_counts": bin_counts,
                       "timesteps": timesteps}
            if cfg.log_grad_norm:
                metrics["grad_norm"] = grad_norm(opt.names, self.grads)
            opt.step(self.grads)
            return metrics


class StepGraphs:
    """The train step's CUDA graphs on one card, kept on its optimizer
    (`MupAdamW.step_graphs`, dropped by `refresh`): a side stream, the key
    of the latest eager step and one `StepGraph`. A key's first step runs
    eagerly on the side stream, as PyTorch's whole-network capture warms
    up (the kernels' per-stream buffers, libraries, Triton's compiles); its
    second captures there (a graph of another key goes first) and
    replays; later ones replay."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.seen: Optional[Tuple] = None
        self.graph: Optional[StepGraph] = None

    def step(self, key: Tuple, model: DiT, opt: MupAdamW, batch: Dict,
             generator: Optional[torch.Generator],
             cfg: TrainConfig) -> Dict[str, torch.Tensor]:
        if self.graph is None or self.graph.key != key:
            if self.seen != key:
                self.seen = key
                train_step.eager_steps += 1
                return self._warm_up(model, opt, batch, generator, cfg)
            self.graph = None  # its pool goes before the next one fills
            self.graph = StepGraph(key, self.stream, model, opt, batch,
                                   generator, cfg)
            train_step.captures += 1
        train_step.replays += 1
        return self.graph.replay(opt, batch, cfg)

    def _warm_up(self, model, opt, batch, generator, cfg):
        cur = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = eager_train_step(model, opt, batch, generator, cfg)
        cur.wait_stream(self.stream)
        return out


def step_for(cfg: TrainConfig):
    """The train step of `cfg`: `train_step`, or with
    `optimizer.in_backward` `inloop_step` (same arguments and metrics),
    after JAX's refusals: the context axis (no token-sharded path in the
    hand-rolled forward) and `log_grad_norm` (the whole gradient never
    exists)."""
    if not cfg.optimizer.in_backward:
        return train_step
    if cfg.mesh.context > 1:
        raise NotImplementedError(
            "optimizer_in_backward does not support the context "
            "(sequence-parallel) mesh axis: its hand-rolled forward has no "
            "token-sharded path — use the standard step for CP runs")
    if cfg.log_grad_norm:
        raise ValueError(
            "log_grad_norm is unavailable with optimizer_in_backward: the "
            "full gradient never materializes (that is the point)")
    from video_diffusion_speedrun_tpu_torch.train.inloop import inloop_step

    return inloop_step


def grad_norm(names, grads, sharding=None) -> torch.Tensor:
    """The L2 norm of the global gradient from each rank's reduced local
    shards: the squares summed per kind of placement, each sum then over
    the axes that kind is sharded on (fsdp, tensor), so every element
    counts once. None gradients count 0."""
    sums = {}
    for name, g in zip(names, grads):
        if g is None:
            continue
        key = (False, False)
        if sharding is not None:
            key = (name in sharding.fsdp_managed,
                   sharding.placements[name].tensor is not None
                   and sharding.region is not None)
        sq = local(g).float().square().sum()
        sums[key] = sq if key not in sums else sums[key] + sq
    total = 0.0
    for (fsdp, tensor), sq in sums.items():
        all_reduce_([sq], sharding.fsdp_group if fsdp else None)
        all_reduce_([sq], sharding.tensor_group if tensor else None)
        total = total + sq
    return torch.sqrt(total)


@torch.no_grad()
def eval_step(model: DiT, batch: Dict, generator: torch.Generator,
              cfg: TrainConfig, context_parallel=None
              ) -> Dict[str, torch.Tensor]:
    """The loss on one batch without gradients: {loss, bin_sums,
    bin_counts}."""
    loss, aux = _loss(model, batch, generator, cfg, context_parallel)
    return {"loss": loss, "bin_sums": aux["bin_sums"],
            "bin_counts": aux["bin_counts"]}
