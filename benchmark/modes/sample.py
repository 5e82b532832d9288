"""The sampling mode: one client sending requests back to back to the
program's Euler sampler (`sampling.euler.euler_cfg_sample`): each request
its own initial noise and text context, `steps` CFG Euler steps.

Set-up builds the DiT of the sampler CLI's configuration (`sample.
demo_config`) in the traffic's parameter dtype holding the seed's weights,
makes a pool of requests and warms the shapes up with a two-step request.
The window runs whole requests and closes at the first request boundary
after `--seconds`, then syncs: ms per Euler step is the window's time over
every Euler step of its requests. A forward hook on the DiT copies, for
the first `capture` requests, every step's prediction [cond; uncond] and
the model's input at the steps the check will recompute into pinned host
memory, asynchronously on the compute stream.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from benchmark import counts, inputs, program
from benchmark.harness import SetupParts, sync
from benchmark.reference import dit as ref
from benchmark.reference import sampler as ref_sampler
from benchmark.trace import Profiled


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp(min=1e-30))


class Runner:
    def __init__(self, config: Dict, traffic: Dict, seed: int,
                 device: torch.device, model_overrides=None, fault=None):
        self.c, self.t, self.seed, self.device = config, traffic, seed, device
        self.model_overrides = model_overrides or {}
        # a planted fault (the CPU tests'): "altered_answer" changes each
        # request's returned latents where the sampler produces them
        self.fault = fault
        self.capturing = False

    def model_config(self):
        c = self.c
        cfg = program.module("sample").demo_config(
            c["hidden_size"], c["depth"], c["hidden_size"] // c["num_heads"],
            c["cross_attn_input_size"],
            param_dtype=inputs.DTYPES[self.t["param_dtype"]])
        return cfg.replace(**self.model_overrides) if self.model_overrides \
            else cfg

    def sample(self, noise, context, steps: int):
        euler = program.module("sampling.euler")
        acc = euler.euler_cfg_sample(self.model, noise, context,
                                     num_steps=steps,
                                     cfg_scale=self.t["cfg_scale"],
                                     alpha=self.t["alpha"])
        if self.fault == "altered_answer":
            acc = acc + 1e-2 * acc.abs().amax()
        return acc

    def setup(self) -> None:
        dev, t = self.device, self.t
        self.setup_parts = SetupParts(dev)
        program.build_kernels(dev)
        self.setup_parts.mark("kernel builds")
        w = inputs.weights(self.c, self.seed, dev,
                           inputs.DTYPES[t["param_dtype"]])
        self.model = program.dit(self.model_config(), dev, w)
        del w
        self.setup_parts.mark("weights, model")
        self.noise, self.context = inputs.requests(self.c, t, self.seed, dev,
                                                   t["pool"])
        # which captured request, and which of its steps, the check
        # recomputes: drawn from the seed
        g = torch.Generator().manual_seed(inputs.derive(self.seed, "check"))
        self.check_steps = sorted(torch.randperm(
            t["steps"], generator=g)[:t["check_steps"]].tolist())
        self.pick = torch.Generator().manual_seed(
            inputs.derive(self.seed, "pick"))
        pin = dev.type == "cuda"
        shape = tuple(self.noise[0].shape[1:])
        n = t["capture"]
        self.outs = torch.empty((n, t["steps"], 2, *shape),
                                dtype=self.model.cfg.compute_dtype,
                                pin_memory=pin)
        self.ins = torch.empty((n, len(self.check_steps), 1, *shape),
                               dtype=torch.bfloat16, pin_memory=pin)
        self.req = self.step = 0
        self.setup_parts.mark("requests, capture buffers")
        self.on_step = None
        self.model.register_forward_hook(self._hook)
        self.sample(self.noise[0], self.context[0], 2)
        sync(dev)
        self.setup_parts.mark("warm-up request")

    def _hook(self, module, args, out) -> None:
        if self.capturing and self.req < self.t["capture"]:
            r, s = self.req, self.step
            self.outs[r, s].copy_(out, non_blocking=True)
            if s in self.check_steps:
                self.ins[r, self.check_steps.index(s)].copy_(
                    args[0][:1], non_blocking=True)
        self.step += 1
        if self.on_step is not None:
            self.on_step(self.step)

    def window(self, seconds: float) -> Dict:
        dev, t = self.device, self.t
        self.accs, finite = [], []
        sync(dev)
        self.capturing = True
        t0 = time.perf_counter()
        r = 0
        while True:
            self.req, self.step = r, 0
            i = r % t["pool"]
            acc = self.sample(self.noise[i], self.context[i], t["steps"])
            if r < t["capture"]:
                self.accs.append(acc)
            finite.append(torch.isfinite(acc).all())
            r += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync(dev)
        secs = time.perf_counter() - t0
        self.capturing = False
        failed = int((~torch.stack(finite)).sum())
        return {"attempted": r, "failed": failed, "seconds": secs,
                "requests": r, "steps": r * t["steps"]}

    def end_to_end(self, w: Dict) -> Dict:
        return {"euler_step_ms": 1e3 * w["seconds"] / w["steps"]}

    def shapes(self) -> Dict:
        c, t = self.c, self.t
        lat = (c["in_channels"], t["frames"], 2 * (t["height"] // 16),
               2 * (t["width"] // 16))
        step = counts.dit_forward_flops(c, 2, lat, t["context_tokens"],
                                        with_context_kv=False)
        once = counts.context_kv_flops(c, 2, t["context_tokens"])
        return {"batch": 2, "heads": c["num_heads"],
                "head_dim": c["hidden_size"] // c["num_heads"],
                "width": c["hidden_size"],
                "mlp": int(c["hidden_size"] * c["mlp_ratio"]),
                "tokens": counts.tokens(c, lat),
                "registers": c["num_registers"],
                "context": t["context_tokens"],
                "step_flops": step, "request_flops": t["steps"] * step + once,
                "request_steps": t["steps"]}

    def traced(self) -> Dict:
        """The traced segment: one more request, `trace_steps` of its Euler
        steps after `trace_skip` under the profiler (one warm-up step
        before them), between syncs."""
        dev, t = self.device, self.t
        skip, steps = t["trace_skip"], t["trace_steps"]
        prof, state = Profiled(steps), {}

        def on_step(done: int) -> None:
            if done == skip:  # the next forward is the profiler's warm-up
                prof.start()
            elif done == skip + 1:
                sync(dev)
                prof.step()
                state["before"] = program.read_counters()
                state["t0"] = time.perf_counter()
            elif skip + 1 < done < skip + 1 + steps:
                prof.step()
            elif done == skip + 1 + steps:
                sync(dev)
                state["window_s"] = time.perf_counter() - state["t0"]
                state["after"] = program.read_counters()
                prof.step()
                prof.stop()

        self.on_step = on_step
        self.req, self.step = t["capture"], 0
        self.sample(self.noise[0], self.context[0], t["steps"])
        self.on_step = None
        return {"trace": prof.read(state["window_s"]), "steps": steps,
                "launches": program.launches_between(state["before"],
                                                     state["after"])}

    def free(self) -> None:
        if hasattr(self, "model"):
            del self.model

    # ---- the plain reference ----

    def _request(self):
        """The captured request the check reads, drawn from the seed among
        those the window finished: its index in the pool, its predictions
        [steps, 2, ...] and the inputs of the checked steps, on the
        device."""
        if not hasattr(self, "_k"):
            done = min(len(self.accs), self.t["capture"])
            self._k = int(torch.randint(done, (), generator=self.pick))
        k = self._k
        return (k, k % self.t["pool"], self.outs[k].to(self.device),
                self.ins[k].to(self.device))

    def trajectory(self, acc_dtype: torch.dtype) -> torch.Tensor:
        """The request's latents integrated over the program's predictions
        on the reference's grid and guidance, in `acc_dtype`."""
        t = self.t
        _, i, outs, _ = self._request()
        noise, _ = inputs.requests(self.c, t, self.seed, self.device,
                                   t["pool"])
        return ref_sampler.integrate(noise[i], list(outs), t["steps"],
                                     t["alpha"], t["cfg_scale"], acc_dtype)

    @torch.no_grad()
    def velocities(self, ops: ref.Ops):
        """The guided velocity of `ops`'s forward at each checked step, from
        the program's own input of that step."""
        dev, t, c = self.device, self.t, self.c
        ref.fp32_matmuls()
        _, i, _, ins = self._request()
        w = inputs.weights(c, self.seed, dev,
                           inputs.DTYPES[t["param_dtype"]])
        _, context = inputs.requests(c, t, self.seed, dev, t["pool"])
        ctx = torch.cat([context[i], torch.zeros_like(context[i])])
        ckvs = [ref.context_kv(ops, w, c, j, ctx) for j in range(c["depth"])]
        ts, _ = ref_sampler.grid(t["steps"], t["alpha"])
        out = []
        for j, s in enumerate(self.check_steps):
            x = ins[j]
            tv = torch.full((2,), ts[s], device=dev)
            pred = ref.forward(ops, w, c, torch.cat([x, x]), tv, ckvs=ckvs)
            out.append(ref_sampler.guided(pred, t["cfg_scale"]))
        return out

    def check(self, control: bool = False) -> Dict[str, float]:
        """The prediction gap (the worst checked step's guided velocity
        against the reference's, relative L2) and the trajectory gap (the
        request's latents against the reference's integration of the
        program's predictions). The control puts the reference in the
        program's place: float8 products, a bf16 accumulator."""
        k, _, outs, _ = self._request()
        want = self.velocities(ref.Ops())
        end = self.trajectory(torch.float32)
        if control:
            got = self.velocities(ref.Ops(fp8=True))
            latents = self.trajectory(torch.bfloat16)
        else:
            got = [ref_sampler.guided(outs[s], self.t["cfg_scale"])
                   for s in self.check_steps]
            latents = self.accs[k]
        return {"velocity_gap": max(rel_l2(g, w) for g, w in zip(got, want)),
                "trajectory_gap": rel_l2(latents, end)}
