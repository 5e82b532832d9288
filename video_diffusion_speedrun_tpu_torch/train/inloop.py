"""Optimizer-in-backward training step (port of `train/inloop.py`).

A standard step holds the whole gradient before the optimizer runs; here
each block's gradients exist only while that block's update consumes
them, so the peak is parameters + moments + one block's gradients + the
stack of block inputs. The step, as JAX's (`inloop.py:114-496`):

1. the prefix (patchify, registers, time embedding) with grad; the blocks
   under `torch.no_grad()`, keeping each block's input and block 0's v;
2. the suffix (final modulation, norm, projection, unpatchify) and the
   loss with grad, and their gradients: d(tokens), d(t_emb) and the
   suffix's leaves;
3. for block i = depth−1 … 0: the block recomputed with grad from its
   detached input, `torch.autograd.grad` of (x_out[, v]) against (dx[,
   dv0]) for its leaves and inputs; d(t_emb) and (for i > 0) d(v0) added
   into fp32 accumulators; its gradients reduced over the ranks and its
   leaves updated at once (`MupAdamW.update_group`: one launch of the
   AdamW kernel for its exact leaves, two of the factored-ν kernel for
   its factored weights);
4. the prefix's gradients from (dx₀, d(t_emb)), and the update of the
   prefix's and suffix's leaves. The count advances once.

Under a profiler (`utils/profiling.py:span`) the step is a `vds/step`
span: one `vds/step/forward` over steps 1–2's forward, a
`vds/step/backward` over each gradient computation (the suffix's, each
block's recompute and gradients, the prefix's: depth + 2) and a
`vds/optim/update` in each group's update (depth + 1); the casts and
reductions between them are the step's own time.

With `grad_accum > 1` each block's backward runs over batch chunks whose
gradients are summed in fp32 and cast once: the exact full-batch gradient
(`inloop.py:359-404`), with the backward's residuals of one chunk at a
time. Block 0's λ never mixes v0 and gets JAX's zero gradient (C8).
JAX's software pipelining (block i+1's update under block i's backward,
`inloop.py:406-411`) is XLA scheduling and is not reproduced. The
recompute of step 3 is the step's own, with no remat policy: JAX's
calls the raw `block_forward` there (`inloop.py:301,356`), so
`DiTConfig.remat_policy` (`models/dit.py:remat_context_fn`) acts only in
the standard step.

Across processes the step gathers and reduces by hand instead of through
FSDP2's hooks, which would become the root in a block called outside
`DiT.forward` and reshard the root's parameters after every block's
backward: the root's lazy set-up runs first; each FSDP2 module is
unsharded (`unshard()`) for its forward or recompute and resharded
after, its gradients taken against the gathered parameters; before a
group's update, λ's and the column biases' gradients are summed over the
tensor group, the fsdp-held leaves' reduce-scattered to this rank's
shard (`parallel/fsdp.py:reduce_scatter_grad`, over the replicas too),
the rest averaged over the data group — in fp32, then cast to the
parameter dtype once. The context axis is refused, as JAX's
`_build_inloop_branch` does.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

from video_diffusion_speedrun_tpu_torch.core.config import TrainConfig
from video_diffusion_speedrun_tpu_torch.models.dit import DiT
from video_diffusion_speedrun_tpu_torch.parallel.collectives import (
    all_reduce_,
    local,
)
from video_diffusion_speedrun_tpu_torch.parallel.fsdp import (
    reduce_scatter_grad,
)
from video_diffusion_speedrun_tpu_torch.train.loss import (
    flow_inputs,
    flow_loss,
)
from video_diffusion_speedrun_tpu_torch.train.optim import MupAdamW
from video_diffusion_speedrun_tpu_torch.utils.profiling import span


def _fsdp_module(module) -> bool:
    from torch.distributed.fsdp import FSDPModule

    return isinstance(module, FSDPModule)


@contextlib.contextmanager
def _gathered(module):
    """`module`'s own parameters whole (FSDP2's unshard) inside the block,
    sharded again after; a module FSDP2 does not hold passes through."""
    if not _fsdp_module(module):
        yield
        return
    module.unshard()
    try:
        yield
    finally:
        module.reshard()


def _init_fsdp_root(model: DiT) -> None:
    """FSDP2 sets its root up in the root's first forward; a block called
    before that would become the root. Set the model up as the root."""
    if _fsdp_module(model):
        model._get_fsdp_state()._lazy_init()


def _leaves(module, names: List[str], prefix: str) -> List[torch.Tensor]:
    """The parameters of `names` as `module` holds them now (gathered ones
    while unsharded)."""
    return [module.get_parameter(n[len(prefix):]) for n in names]


def _reduce(model: DiT, opt: MupAdamW, idx: List[int],
            grads: List[Optional[torch.Tensor]], data_group
            ) -> List[Optional[torch.Tensor]]:
    """The optimizer's local gradients of leaves `idx` from this rank's
    gradients (against the gathered parameters, fp32 or the parameter
    dtype): what `train_step` reduces, applied to one group; cast to the
    parameters' dtype."""
    sharding = getattr(model, "sharding", None)
    names = [opt.names[i] for i in idx]
    if sharding is None and data_group is None:
        return [None if g is None else g.to(opt.params[i].dtype)
                for i, g in zip(idx, grads)]
    grads = [None if g is None else g.float() for g in grads]
    if sharding is None:
        all_reduce_(grads, data_group, mean=True)
    else:
        all_reduce_([g for n, g in zip(names, grads)
                     if n in sharding.tensor_partial], sharding.tensor_group)
        for k, n in enumerate(names):
            if n in sharding.fsdp_managed and grads[k] is not None:
                grads[k] = reduce_scatter_grad(sharding, n, grads[k])
        all_reduce_([g for n, g in zip(names, grads)
                     if n not in sharding.fsdp_managed], data_group,
                    mean=True)
    return [None if g is None else g.to(opt.params[i].dtype)
            for i, g in zip(idx, grads)]


def _block_grads(blk, params, x_in, v0_in, te, context, cos, sin, dx,
                 dv_out, accum: int):
    """One block's gradients from its recompute: (leaf gradients — local
    shards; fp32 sums over the chunks when accum > 1 — , d(x_in), d(v0),
    d(t_emb)). dv_out is None where the block's v is unused."""
    b = x_in.shape[0]
    n = b // accum
    acc = None
    dxs, dv0s, dtes = [], [], []
    for c in range(accum):
        rows = slice(c * n, (c + 1) * n)
        x_c = x_in[rows].detach().requires_grad_()
        te_c = te[rows].detach().requires_grad_()
        v0_c = (None if v0_in is None
                else v0_in[rows].detach().requires_grad_())
        ctx_c = None if context is None else context[rows]
        with torch.enable_grad():
            x_out, v = blk.forward(x_c, ctx_c, te_c, cos, sin, v0_c)
        outs, couts = [x_out], [dx[rows]]
        if dv_out is not None:
            outs.append(v)
            couts.append(dv_out[rows])
        wrt = list(params) + [x_c, te_c] + ([] if v0_c is None else [v0_c])
        got = torch.autograd.grad(outs, wrt, couts, allow_unused=True)
        gp = [None if g is None else local(g) for g in got[:len(params)]]
        if accum == 1:
            acc = gp
        elif acc is None:
            acc = [None if g is None else g.float() for g in gp]
        else:
            acc = [a if g is None else a + g.float()
                   for a, g in zip(acc, gp)]
        rest = got[len(params):]
        dxs.append(rest[0])
        dtes.append(rest[1])
        dv0s.append(rest[2] if v0_c is not None else None)
    cat = (lambda ts: ts[0]) if accum == 1 else (lambda ts: torch.cat(ts))
    return (acc, cat(dxs), None if v0_in is None else cat(dv0s), cat(dtes))


def inloop_step(model: DiT, opt: MupAdamW, batch: Dict,
                generator: Optional[torch.Generator], cfg: TrainConfig,
                context_parallel=None, data_group=None
                ) -> Dict[str, torch.Tensor]:
    """One optimizer-in-backward step on this replica's `batch`; the
    arguments and the draws (device context, timesteps, noise, caption
    dropout, rope offsets) are `train_step`'s. Returns {loss, lr_scale,
    bin_sums, bin_counts, timesteps, loss_per_sample}."""
    if context_parallel is not None:
        raise NotImplementedError(
            "optimizer_in_backward does not support the context axis (JAX "
            "`_build_inloop_branch` refuses it too); use the standard step")
    mcfg = model.cfg
    latent = batch["latent"]
    dev = latent.device
    accum = cfg.grad_accum
    if latent.shape[0] % accum:
        raise ValueError(f"batch {latent.shape[0]} is not a multiple of "
                         f"grad_accum {accum}")
    with span("step", dev):
        context = batch.get("context")
        if context is None and mcfg.cross_attn_input_size is not None:
            context = 0.05 * torch.randn(
                latent.shape[0], cfg.data.caption_tokens,
                cfg.data.context_dim, generator=generator,
                device=latent.device, dtype=mcfg.compute_dtype)
        # later blocks mix block 0's v only in a residual-v model
        use_v0 = mcfg.residual_v
        lr_scale = opt.lr_scale()
        _init_fsdp_root(model)

        rest = opt.groups["rest"]
        rest_names = [opt.names[i] for i in rest]
        with _gathered(model):
            # ---- forward: the prefix with grad, the blocks without; the
            # suffix and the loss ----
            with span("step/forward", dev):
                inp = flow_inputs(mcfg, latent, context, generator,
                                  alpha=cfg.time_shift_alpha,
                                  caption_dropout=cfg.caption_dropout,
                                  timesteps=batch.get("timesteps"),
                                  noise=batch.get("noise"),
                                  rope_offsets=batch.get("rope_offsets"))
                ctx = inp.context
                grid = model.grid(inp.z_t)
                tokens0, t_emb, cos, sin = model.prefix(
                    inp.z_t, inp.timesteps, inp.rope_offsets)
                te = t_emb.detach()
                x, v0, xs = tokens0.detach(), None, []
                with torch.no_grad():
                    for i, blk in enumerate(model.blocks):
                        xs.append(x)
                        with _gathered(blk):
                            x, v = blk.forward(x, ctx, te, cos, sin, v0)
                        if i == 0:
                            v0 = v
                x_last = x.requires_grad_()
                te_s = te.clone().requires_grad_()
                out = model.suffix(x_last, te_s, grid)
                loss, aux = flow_loss(out, inp.v_objective, inp.timesteps)

            # ---- the suffix's gradients: d(tokens), d(t_emb), its leaves
            rest_leaves = _leaves(model, rest_names, "")
            with span("step/backward", dev):
                got = torch.autograd.grad(
                    loss, [x_last, te_s] + rest_leaves, allow_unused=True)
            dx = got[0]
            dte = got[1].float()
            suffix_grads = [None if g is None else local(g)
                            for g in got[2:]]
            del out, got
            dv0 = (torch.zeros(v0.shape, dtype=torch.float32,
                               device=v0.device) if use_v0 else None)

            # ---- reverse walk: each block's gradients, then its update --
            for i in reversed(range(len(model.blocks))):
                blk = model.blocks[i]
                group = f"blocks.{i}"
                idx = opt.groups[group]
                with _gathered(blk):
                    params = _leaves(blk, [opt.names[k] for k in idx],
                                     group + ".")
                    dv_out = (dv0.to(v0.dtype) if i == 0 and use_v0
                              else None)
                    with span("step/backward", dev):
                        grads, dx, dv0_in, dte_i = _block_grads(
                            blk, params, xs[i], v0 if i and use_v0 else None,
                            te, ctx, cos, sin, dx, dv_out, accum)
                xs[i] = None
                dte += dte_i.float()
                if dv0_in is not None:
                    dv0 += dv0_in.float()
                opt.update_group(group, _reduce(model, opt, idx, grads,
                                                data_group))
                del grads

            # ---- the prefix's gradients; the prefix and suffix update ----
            with span("step/backward", dev):
                got = torch.autograd.grad((tokens0, t_emb), rest_leaves,
                                          (dx, dte.to(t_emb.dtype)),
                                          allow_unused=True)
            grads = [s if g is None else local(g) if s is None
                     else local(g) + s for g, s in zip(got, suffix_grads)]
            del got, tokens0, t_emb
            opt.update_group("rest", _reduce(model, opt, rest, grads,
                                             data_group))
        opt.advance()

        loss = loss.detach()
        all_reduce_([loss], data_group, mean=True)
        all_reduce_([aux["bin_sums"], aux["bin_counts"]], data_group)
        return {"loss": loss, "lr_scale": lr_scale,
                "bin_sums": aux["bin_sums"], "bin_counts": aux["bin_counts"],
                "timesteps": aux["timesteps"],
                "loss_per_sample": aux["loss_per_sample"]}
