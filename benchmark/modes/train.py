"""The training mode: the program's train step (`train.step.step_for`) on
batches the benchmark makes, dispatched back to back.

Set-up builds the configuration through the train CLI's own parser from
the traffic's flags, the DiT holding the seed's weights, the muP-AdamW
optimizer and a pool of batches, and drives that one train state through
its first `check_steps` steps on batches that all differ: they warm up
every shape and are the steps the plain reference follows. Their losses,
the first gradient (m after one step over 1 − β₁) and the parameters'
change after them are read per leaf and kept. The window then runs steps
on the pool, with no sync between them, until `--seconds` have passed on
the host, and ends with a sync: tokens/s is every patch token of every
batch over the whole window.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict, List, Optional

import torch

from benchmark import counts, inputs, program
from benchmark.harness import (
    SetupParts,
    barrier,
    mean_over_ranks,
    sync,
    whole,
)
from benchmark.reference import dit as ref
from benchmark.reference import optim as ref_optim
from benchmark.trace import Profiled


def median(x: torch.Tensor) -> float:
    return float(x.float().quantile(0.5))


def leaf_gap(prog: torch.Tensor, want: torch.Tensor,
             keep: torch.Tensor) -> float:
    """The worst leaf's gap between the two norms, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    prog, want = prog[keep], want[keep]
    if want.numel() == 0:
        return 0.0
    scale = torch.maximum(want, torch.tensor(median(want)))
    return float(((prog - want).abs() / scale.clamp(min=1e-30)).max())


class Runner:
    def __init__(self, config: Dict, traffic: Dict, seed: int,
                 device: torch.device, model_overrides=None, fault=None):
        self.c, self.t, self.seed, self.device = config, traffic, seed, device
        self.model_overrides = model_overrides or {}
        # a planted fault (the CPU tests' and the calibration's): "frozen"
        # leaves the state unchanged, "half_batch" steps on half the batch
        self.fault = fault
        self.checked = None
        self.world, self.rank = 1, 0

    # ---- the program ----

    def argv(self) -> List[str]:
        c, t = self.c, self.t
        return ["--model_width", str(c["hidden_size"]),
                "--model_depth", str(c["depth"]),
                "--model_head_dim", str(c["hidden_size"] // c["num_heads"]),
                "--context_dim", str(c["cross_attn_input_size"]),
                "--batch_size", str(t["batch"]),
                "--device", self.device.type, *t["train_argv"]]

    def build_config(self):
        cli = program.module("train.__main__")
        cfg = cli.build_config(cli.parse_args(self.argv()))
        if self.model_overrides:
            cfg = dataclasses.replace(
                cfg, model=cfg.model.replace(**self.model_overrides))
        return cfg

    def step_fn(self):
        step = program.module("train.step").step_for(self.cfg)
        if self.fault == "half_batch":
            def half(model, opt, batch, gen, cfg, *a):
                b = batch["latent"].shape[0] // 2
                return step(model, opt, {k: (v[:b] if v.dim() and k !=
                                             "rope_offsets" else v)
                                         for k, v in batch.items()},
                            gen, cfg, *a)
            return half
        if self.fault == "frozen":
            def frozen(model, opt, batch, gen, cfg, *a):
                state = [p.detach().clone() for p in model.parameters()]
                ms = [m.clone() for m in opt.m]
                out = step(model, opt, batch, gen, cfg, *a)
                with torch.no_grad():
                    for p, s in zip(model.parameters(), state):
                        p.copy_(s)
                    for m, s in zip(opt.m, ms):
                        m.copy_(s)
                return out
            return frozen
        return step

    def shard_streams(self, shard: int):
        """The names of data shard `shard`'s batch and dropout streams (one
        shard: the run's own)."""
        if self.world == 1:
            return "batches", "dropout"
        return f"batches/{shard}", f"dropout/{shard}"

    def local_traffic(self) -> Dict:
        return dict(self.t, batch=self.t["batch"] // self.world)

    def setup(self) -> None:
        t = self.t
        self.cfg = self.build_config()
        mesh_mod = program.module("parallel.mesh")
        # under the launcher of run.py: one process a card, NCCL
        dev = self.device = mesh_mod.init_distributed(self.device)
        self.world, self.rank = mesh_mod.world_size(), mesh_mod.global_rank()
        self.setup_parts = SetupParts(dev)
        if self.rank == 0:
            program.build_kernels(dev)
        barrier(self.world)
        self.setup_parts.mark("kernel builds")
        optim = program.module("train.optim")
        w = inputs.weights(self.c, self.seed, dev,
                           self.cfg.model.param_dtype)
        self.model = program.dit(self.cfg.model, dev, w)
        del w
        self.mesh = mesh_mod.build_mesh(self.cfg.mesh, dev.type)
        sharding = program.module("parallel.fsdp").shard_model(self.model,
                                                               self.mesh)
        if self.fault == "no_exchange":
            from torch.distributed.fsdp import FSDPModule

            for m in self.model.modules():
                if isinstance(m, FSDPModule):
                    m.set_requires_gradient_sync(False)
        self.data_group = mesh_mod.data_group(self.mesh)
        self.stop_group = (None if self.world == 1
                           else torch.distributed.new_group(backend="gloo"))
        self.opt = optim.MupAdamW(self.model.named_parameters(),
                                  self.cfg.optimizer.learning_rate,
                                  self.cfg.max_steps, self.cfg.optimizer,
                                  sharding=sharding)
        self.step = self.step_fn()
        self.setup_parts.mark("weights, model, optimizer")
        batches, dropout = self.shard_streams(self.rank)
        self.gen = inputs.generator(self.seed, dropout, dev)
        self.pool = inputs.train_batches(self.c, self.local_traffic(),
                                         self.seed, dev, t["pool"], batches)
        self.setup_parts.mark("batches")
        # the checked steps: the first of the window's own kind
        n = t["check_steps"]
        names = list(ref.param_shapes(self.c))
        named = dict(self.model.named_parameters())
        params = [named[k] for k in names]
        start = [p.detach().clone() for p in params]
        losses = []
        b1 = self.cfg.optimizer.beta1
        for i in range(n):
            m = self.call(self.pool[i % t["pool"]])
            losses.append(m["loss"].detach().float())
            if i == 0:
                ms = dict(zip(self.opt.names, self.opt.m))
                grad = torch.stack([whole(ms[k]).float().norm()
                                    for k in names]) / (1 - b1)
        change = torch.stack([whole(p.detach() - s).float().norm()
                              for p, s in zip(params, start)])
        del start
        self.checked = {"loss": torch.stack(losses).cpu(),
                        "grad": grad.cpu(), "change": change.cpu()}
        self.done = n
        self.setup_parts.mark("checked steps")

    def call(self, batch):
        """One step of the program on this data shard's `batch`."""
        return self.step(self.model, self.opt, batch, self.gen, self.cfg,
                         None, self.data_group)

    def stop(self, flag: bool) -> bool:
        """Whether every rank stops: rank 0's clock decides, over a
        host-side (gloo) group, so no rank steps alone."""
        if self.world == 1:
            return flag
        f = torch.tensor([float(flag)])
        torch.distributed.broadcast(f, 0, group=self.stop_group)
        return bool(f.item())

    def window(self, seconds: float) -> Dict:
        dev, pool = self.device, self.pool
        losses = []
        sync(dev)
        t0 = time.perf_counter()
        stamps = [t0]
        n = 0
        while True:
            m = self.call(pool[(self.done + n) % len(pool)])
            losses.append(m["loss"].detach())
            n += 1
            stamps.append(time.perf_counter())
            if self.stop(stamps[-1] - t0 >= seconds):
                break
        sync(dev)
        secs = time.perf_counter() - t0
        _host_ms(stamps)
        self.done += n
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        return {"attempted": n, "failed": failed, "seconds": secs,
                "steps": n}

    def tokens_per_step(self) -> int:
        """Of the global batch, every card's."""
        return self.t["batch"] * counts.tokens(self.c, self.t["latent"])

    def step_flops(self) -> float:
        return counts.dit_train_flops(self.c, self.t["batch"],
                                      self.t["latent"],
                                      self.t["context_tokens"])

    def end_to_end(self, w: Dict) -> Dict:
        """Patch tokens trained a second, under the traffic's name for it:
        host-bound and device-bound steps spread too differently to share
        one bound."""
        return {self.t["metric"]:
                self.tokens_per_step() * w["steps"] / w["seconds"]}

    def shapes(self) -> Dict:
        c, t = self.c, self.local_traffic()
        return {"batch": t["batch"], "heads": c["num_heads"],
                "head_dim": c["hidden_size"] // c["num_heads"],
                "width": c["hidden_size"],
                "mlp": int(c["hidden_size"] * c["mlp_ratio"]),
                "tokens": counts.tokens(self.c, t["latent"]),
                "registers": c["num_registers"],
                "context": t["context_tokens"],
                "step_flops": self.step_flops()}

    def traced(self) -> Dict:
        """The traced segment: one warm-up step under the profiler, then
        `trace_steps` steps between syncs, the optimizer's calls inside a
        `bench/optimizer` span and each step inside `bench/step`."""
        from torch.profiler import record_function

        dev, pool, opt = self.device, self.pool, self.opt
        spanned = ("step", "update_group")
        for name in spanned:
            def span(*a, _fn=getattr(opt, name), **k):
                with record_function("bench/optimizer"):
                    return _fn(*a, **k)
            setattr(opt, name, span)
        steps = self.t["trace_steps"]

        def one():
            with record_function("bench/step"):
                self.call(pool[self.done % len(pool)])
            self.done += 1

        with Profiled(steps) as prof:
            one()
            sync(dev)
            prof.step()
            before = program.read_counters()
            t0 = time.perf_counter()
            for i in range(steps):
                one()
                if i < steps - 1:
                    prof.step()
            sync(dev)
            window_s = time.perf_counter() - t0
            after = program.read_counters()
            prof.step()
        for name in spanned:
            delattr(opt, name)
        tr = prof.read(window_s, dev.index or 0)
        return {"trace": tr, "steps": steps,
                "busy_s": mean_over_ranks(tr.busy_s, self.world),
                "launches": program.launches_between(before, after)}

    def free(self) -> None:
        for name in ("model", "opt", "pool", "step", "gen"):
            if hasattr(self, name):
                delattr(self, name)

    # ---- the plain reference ----

    def reference(self, ops: ref.Ops) -> Dict[str, torch.Tensor]:
        """The reference's readings of the checked steps: each loss, the
        first gradient's norm per leaf and the change of each leaf."""
        dev, t, c = self.device, self.t, self.c
        ref.fp32_matmuls()
        cfg = self.build_config()
        o = cfg.optimizer
        pd = cfg.model.param_dtype
        names = list(ref.param_shapes(c))
        start = inputs.weights(c, self.seed, dev, pd)
        params = {n: p.float().clone().requires_grad_()
                  for n, p in start.items()}
        opt = ref_optim.AdamW(params, {
            "learning_rate": o.learning_rate, "weight_decay": o.weight_decay,
            "beta1": o.beta1, "beta2": o.beta2, "eps": o.eps,
            "warmup_steps": o.warmup_steps, "max_steps": cfg.max_steps,
            "param_dtype": pd, "moments_dtype": o.moments_dtype or pd,
            "factored": o.in_backward and o.nu_factored,
            "factored_min": o.nu_factored_min_size}, c["depth"])
        # every data shard's batches and caption-dropout draws
        streams = [self.shard_streams(r) for r in range(self.world)]
        gens = [inputs.generator(self.seed, d, dev) for _, d in streams]
        pools = [inputs.train_batches(c, self.local_traffic(), self.seed,
                                      dev, t["pool"], b) for b, _ in streams]
        b, micro = t["batch"] // self.world, t["reference_micro_batch"]
        losses = []
        for i in range(t["check_steps"]):
            total = 0.0
            for gen, pool in zip(gens, pools):
                batch = pool[i % t["pool"]]
                dropped = torch.rand(b, generator=gen, device=dev) \
                    < cfg.caption_dropout
                for s in range(0, b, micro):
                    loss = ref.flow_loss(ops, params, c, batch, dropped,
                                         slice(s, s + micro)) / t["batch"]
                    loss.backward()
                    total += float(loss.detach())
            losses.append(total)
            grads = {n: p.grad for n, p in params.items()}
            if i == 0:
                grad = ref_optim.leaf_norms(grads, names)
            opt.step({n: p.data for n, p in params.items()}, grads)
            for p in params.values():
                p.grad = None
        change = ref_optim.leaf_norms(
            {n: params[n].detach() - start[n].float() for n in params},
            names)
        return {"loss": torch.tensor(losses), "grad": grad, "change": change}

    def numbers(self, got: Dict, want: Dict) -> Dict[str, float]:
        """The comparison: the worst step's relative loss gap, and the
        worst leaf's gap of the first gradient's norm and of the change's
        norm. Leaves whose reference gradient is under a thousandth of the
        median leaf's (nought to rounding) are left out of the change."""
        loss = float(((got["loss"] - want["loss"]).abs()
                      / want["loss"].abs()).max())
        every = torch.ones_like(want["grad"], dtype=torch.bool)
        moved = want["grad"] >= 1e-3 * median(want["grad"])
        return {"loss_gap": loss,
                "grad_gap": leaf_gap(got["grad"], want["grad"], every),
                "update_gap": leaf_gap(got["change"], want["change"], moved)}

    def check(self, control: bool = False) -> Optional[Dict[str, float]]:
        """The numbers, on rank 0 (the reference runs there alone, at the
        global batch; the other ranks wait)."""
        out = None
        if self.rank == 0:
            want = self.reference(ref.Ops())
            got = (self.reference(ref.Ops(fp8=True)) if control
                   else self.checked)
            out = self.numbers(got, want)
        barrier(self.world)
        return out

    def close(self) -> None:
        program.module("parallel.mesh").shutdown()


def _host_ms(stamps) -> None:
    """The host's ms between consecutive step calls, to standard error."""
    d = sorted(1e3 * (b - a) for a, b in zip(stamps, stamps[1:]))
    if d:
        print(f"[bench] host ms a step: min {d[0]:.1f}, median "
              f"{d[len(d) // 2]:.1f}, p90 {d[int(0.9 * (len(d) - 1))]:.1f},"
              f" max {d[-1]:.1f}", file=sys.stderr)
