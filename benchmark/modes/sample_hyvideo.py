"""The sampling mode of HunyuanVideo: one client sending requests back to
back to the program's guidance-distilled Euler sampler
(`sampling.euler.euler_guidance_sample`), batch 1, each request its own
initial noise, text states with their padding mask and CLIP-pooled vector.
Each request's valid text length is drawn from the seed, uniform over the
traffic's `text_valid` range (`text_lengths`).

Set-up resolves the program's model class first (a program without it
fails here, before any kernel build), builds `models.hunyuan_video.
HunyuanVideo` on the meta device and fills it one parameter group at a
time with the seed's weights (`weights`: every layer random, none zero),
makes a pool of requests and warms every shape of the window up with one
step of each pooled request. The window serves every pooled request once,
then runs whole requests on and closes at the first request boundary after
`--seconds`, then syncs: ms per Euler step is the window's time over every
Euler step of its requests, so each run reads the pool's whole mix of text
lengths. A forward hook copies, for each pooled request of the window,
every step's velocity and the model's input at the steps the check
recomputes into pinned host memory, asynchronously on the compute stream;
in the traced segment the same hook drives the profiler.

The check: `velocity_gap`, the worse of two steps drawn from the seed, the
program's velocity against the plain reference's forward
(`reference/hunyuan_video.py`, float32, the full text with its mask) on
the program's own input, both steps in one walk over the blocks, each
block's weights made again from the seed when the walk reaches it;
`text_gap`, the same for the token refiner's output over the valid text
rows (a hook on `txt_in` copies it at the checked steps); and
`trajectory_gap`, the request's latents against the reference's
integration of the program's velocities from the seed's noise. The text
reaches the video only through attention, where with random weights it
moves the velocity by less than bf16 rounding does, so two numbers hold
the text path: `text_gap`, and `padding_gap`, the program's own velocity
at the first checked step with the request's padded text slots drawn
again (×100) against it with them as they were, which the published masks
make equal (the program drops those rows: it reads 0). The control puts
the reference in the program's place with float8 products and a bf16
accumulator. Planted faults (`fault`):
"padded_keys" samples with every text slot valid, so the refiner and the
video attend to the padded keys; "altered_answer" changes each request's
latents.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import torch

from benchmark import counts_hyvideo, inputs, program
from benchmark.harness import SetupParts, sync
from benchmark.reference import dit as ref_ops
from benchmark.reference import hunyuan_video as ref
from benchmark.trace import Profiled

# the VAE's strides (t, h, w): 33 frames of 544×960 → [16, 9, 68, 120]
VAE_STRIDE = (4, 8, 8)
# the launch counters of the model's own ops: name → (module, function)
OWN_COUNTERS = {"qknorm_rope": ("ops.fused_mmdit", "qk_norm_rope"),
                "ln_modulate": ("ops.fused_mmdit", "ln_modulate"),
                "gelu_tanh": ("ops.fused_mmdit", "gelu_tanh")}


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp(min=1e-30))


def latent_shape(c: Dict, t: Dict):
    st, sh, sw = VAE_STRIDE
    return (c["in_channels"], (t["frames"] - 1) // st + 1, t["height"] // sh,
            t["width"] // sw)


@torch.no_grad()
def weights(c: Dict, seed: int, group: str, device,
            dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The parameters of one group (`reference.hunyuan_video.groups`),
    drawn in one call from the seed's stream of that group: weights and
    biases U(±1/√fan_in), norm weights 1 ± 0.1 and norm biases ±0.1. The
    modulation, gate and final layers, which a trainer starts at zero, are
    random too, so that every layer moves the output."""
    shapes = {n: s for n, s in ref.param_shapes(c).items()
              if ref.group_of(n) == group}
    total = sum(math.prod(s) for s in shapes.values())
    u = torch.rand(total, generator=inputs.generator(seed, f"weights/{group}",
                                                      device),
                   device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        x = u[at:at + n].view(shape) * 2 - 1
        at += n
        if "norm" in name.split(".")[-2]:
            x = x * 0.1 + (1.0 if name.endswith("weight") else 0.0)
        else:
            x = x / math.sqrt(inputs.fan_in(name, shapes))
        out[name] = x.to(dtype)
    return out


@torch.no_grad()
def requests(c: Dict, t: Dict, seed: int, device, count: int) -> List[Dict]:
    """`count` requests: noise N(0, 1) [1, C, T, H, W] (drawn in float32,
    served in bf16), text states N(0, 1) [1, slots, td] (bf16) whose first
    n slots are valid (n from `text_lengths`), and a CLIP-pooled vector
    N(0, 1) [1, td2] (bf16)."""
    gen = inputs.generator(seed, "requests", device)
    lat = latent_shape(c, t)
    slots = t["text_slots"]
    lengths = text_lengths(t, seed, count)
    noise = torch.randn((count, 1, *lat), generator=gen,
                        device=device).to(torch.bfloat16)
    text = torch.randn((count, 1, slots, c["text_states_dim"]),
                       generator=gen, device=device, dtype=torch.bfloat16)
    vec2 = torch.randn((count, 1, c["text_states_dim_2"]), generator=gen,
                       device=device, dtype=torch.bfloat16)
    out = []
    for i in range(count):
        n = lengths[i]
        out.append({"noise": noise[i], "text": text[i], "vec2": vec2[i],
                    "mask": (torch.arange(slots, device=device) < n)[None],
                    "n_txt": n})
    return out


def text_lengths(t: Dict, seed: int, count: int) -> List[int]:
    """The valid text length of each of `count` requests, drawn from the
    seed: each uniform over the integers of the traffic's `text_valid`
    [lo, hi], the pool's draws stratified, one from each of `count` equal
    parts of the range in an order drawn from the seed. A window serves the
    whole pool, so its mean length, which moves a step's work (L² in
    attention), stays near the range's middle on every seed."""
    lo, hi = t["text_valid"]
    g = torch.Generator().manual_seed(inputs.derive(seed, "text_valid"))
    u = (torch.randperm(count, generator=g).double()
         + torch.rand(count, generator=g, dtype=torch.float64)) / count
    return [lo + int(x) for x in (u * (hi - lo + 1)).floor().tolist()]


class _Done(Exception):
    """Ends the traced request after its traced steps."""


class Runner:
    def __init__(self, config: Dict, traffic: Dict, seed: int,
                 device: torch.device, fault=None):
        self.c, self.t, self.seed, self.device = config, traffic, seed, device
        self.fault = fault
        self.capturing = False
        self.on_step = None
        # the program's model, before anything is built
        self.model_cls = program.module("models.hunyuan_video").HunyuanVideo
        self.cfg_cls = program.module("core.config").HunyuanVideoConfig

    def model_config(self):
        fields = self.cfg_cls.__dataclass_fields__
        kw = {k: tuple(v) if isinstance(v, list) else v
              for k, v in self.c.items() if k in fields}
        dt = inputs.DTYPES[self.t["param_dtype"]]
        return self.cfg_cls(**kw, param_dtype=dt, compute_dtype=dt)

    def mask(self, q: Dict):
        return None if self.fault == "padded_keys" else q["mask"]

    def sample(self, i: int, steps: int):
        q = self.reqs[i]
        euler = program.module("sampling.euler")
        acc = euler.euler_guidance_sample(
            self.model, q["noise"], q["text"], q["vec2"],
            text_mask=self.mask(q),
            num_steps=steps, guidance=self.t["guidance"],
            shift=self.t["flow_shift"])
        if self.fault == "altered_answer":
            acc = acc + 1e-2 * acc.abs().amax()
        return acc

    def setup(self) -> None:
        dev, t, c = self.device, self.t, self.c
        self.setup_parts = SetupParts(dev)
        program.build_kernels(dev)
        self.setup_parts.mark("kernel builds")
        cfg = self.model_config()
        model = self.model_cls(cfg, device="meta")
        model.to_empty(device=dev)
        params = dict(model.named_parameters())
        if set(params) != set(ref.param_shapes(c)):
            raise ValueError("the program's parameters are not the "
                             "configuration's")
        with torch.no_grad():
            for g in ref.groups(c):
                for name, w in weights(c, self.seed, g, dev,
                                       cfg.param_dtype).items():
                    params[name].copy_(w)
        self.model = model
        self.setup_parts.mark("weights, model")
        self.reqs = requests(c, t, self.seed, dev, t["pool"])
        g = torch.Generator().manual_seed(inputs.derive(self.seed, "check"))
        self.check_steps = sorted(torch.randperm(
            t["steps"], generator=g)[:t["check_steps"]].tolist())
        self.pick = torch.Generator().manual_seed(
            inputs.derive(self.seed, "pick"))
        pin = dev.type == "cuda"
        shape = tuple(self.reqs[0]["noise"].shape[1:])
        n = t["pool"]
        self.outs = torch.empty((n, t["steps"], *shape),
                                dtype=cfg.compute_dtype, pin_memory=pin)
        self.ins = torch.empty((n, len(self.check_steps), *shape),
                               dtype=torch.bfloat16, pin_memory=pin)
        self.txts = torch.empty((n, len(self.check_steps), t["text_slots"],
                                 c["hidden_size"]), dtype=cfg.compute_dtype,
                                pin_memory=pin)
        self.req = self.step = 0
        self.setup_parts.mark("requests, capture buffers")
        self.model.register_forward_hook(self._hook)
        self.model.txt_in.register_forward_hook(self._txt_hook)
        for i in range(t["pool"]):  # every request's shapes
            self.sample(i, 1)
        sync(dev)
        self.setup_parts.mark("warm-up steps")

    def _hook(self, module, args, out) -> None:
        if self.capturing and self.req < self.t["pool"]:
            r, s = self.req, self.step
            self.outs[r, s].copy_(out[0], non_blocking=True)
            if s in self.check_steps:
                self.ins[r, self.check_steps.index(s)].copy_(
                    args[0][0], non_blocking=True)
        self.step += 1
        if self.on_step is not None:
            self.on_step(self.step)

    def _txt_hook(self, module, args, out) -> None:
        """The refiner's output [1, n, D] at a checked step (before the
        model's hook counts the step)."""
        if self.capturing and self.req < self.t["pool"] \
                and self.step in self.check_steps:
            j = self.check_steps.index(self.step)
            self.txts[self.req, j, :out.shape[1]].copy_(out[0],
                                                        non_blocking=True)

    def _flops(self, i: int) -> float:
        c, t = self.c, self.t
        n_img = math.prod(self.grid())
        n_txt = self.reqs[i]["n_txt"]
        return (t["steps"] * counts_hyvideo.step_flops(c, n_img, n_txt)
                + counts_hyvideo.request_flops(c, n_txt))

    def grid(self):
        _, lt, lh, lw = latent_shape(self.c, self.t)
        pt, ph, pw = self.c["patch_size"]
        return lt // pt, lh // ph, lw // pw

    def window(self, seconds: float, least: Optional[int] = None) -> Dict:
        """Serves the first `least` pooled requests (by default the whole
        pool), then whole requests on to the first boundary after
        `seconds`."""
        dev, t = self.device, self.t
        least = t["pool"] if least is None else least
        self.accs, finite = [], []
        sync(dev)
        self.capturing = True
        t0 = time.perf_counter()
        r, flops = 0, 0.0
        while True:
            self.req, self.step = r, 0
            i = r % t["pool"]
            acc = self.sample(i, t["steps"])
            if r < t["pool"]:
                self.accs.append(acc)
            finite.append(torch.isfinite(acc).all())
            flops += self._flops(i)
            r += 1
            if r >= least and time.perf_counter() - t0 >= seconds:
                break
        sync(dev)
        secs = time.perf_counter() - t0
        self.capturing = False
        failed = int((~torch.stack(finite)).sum())
        return {"attempted": r, "failed": failed, "seconds": secs,
                "requests": r, "steps": r * t["steps"], "flops": flops}

    def end_to_end(self, w: Dict) -> Dict:
        return {"euler_step_ms": 1e3 * w["seconds"] / w["steps"]}

    def shapes(self) -> Dict:
        """The traced request's (pool 0's) token counts."""
        return {"n_img": math.prod(self.grid()),
                "n_txt": self.reqs[0]["n_txt"]}

    @staticmethod
    def counters() -> Dict[str, int]:
        out = program.read_counters()
        for key, (mod, fn) in OWN_COUNTERS.items():
            out[key] = int(getattr(getattr(program.module(mod), fn),
                                   "launches", 0))
        return out

    def traced(self) -> Dict:
        """The traced segment: one more request of pool 0, `trace_steps` of
        its Euler steps after `trace_skip` under the profiler (one warm-up
        step before them), between syncs, stepped by the forward hook; the
        request stops there."""
        dev, t = self.device, self.t
        skip, steps = t["trace_skip"], t["trace_steps"]
        prof, state = Profiled(steps), {}

        def on_step(done: int) -> None:
            if done == skip:  # the next forward is the profiler's warm-up
                prof.start()
            elif done == skip + 1:
                sync(dev)
                prof.step()
                state["before"] = self.counters()
                state["t0"] = time.perf_counter()
            elif skip + 1 < done < skip + 1 + steps:
                prof.step()
            elif done == skip + 1 + steps:
                sync(dev)
                state["window_s"] = time.perf_counter() - state["t0"]
                state["after"] = self.counters()
                prof.step()
                prof.stop()
                raise _Done

        self.on_step = on_step
        self.req, self.step = t["pool"], 0
        try:
            self.sample(0, t["steps"])
        except _Done:
            pass
        finally:
            self.on_step = None
        return {"trace": prof.read(state["window_s"]), "steps": steps,
                "launches": program.launches_between(state["before"],
                                                     state["after"])}

    def free(self) -> None:
        """Reads `padding_gap` and frees the model. Where no window ran
        (`calibrate.py` reads the check after set-up alone), it runs the
        pool's first request, as a window of 0 s, for the check to read."""
        if hasattr(self, "model"):
            if not hasattr(self, "accs"):
                self.window(0.0, least=1)
            self.padding_gap = self._padding_probe()
            del self.model

    @torch.no_grad()
    def _padding_probe(self) -> float:
        """The program's velocity at the checked request's first checked
        step, its padded text slots drawn again ×100, against it with the
        slots as they were (relative L2)."""
        dev, t = self.device, self.t
        _, i, _, ins = self._request()
        q = self.reqs[i]
        g = inputs.generator(self.seed, "padding", dev)
        text = q["text"].clone()
        pad = ~q["mask"][0]
        text[:, pad] = 100 * torch.randn(
            (1, int(pad.sum()), text.shape[-1]), generator=g, device=dev,
            dtype=text.dtype)
        sig, _ = ref.grid(t["steps"], t["flow_shift"])
        ts = torch.full((1,), 1000.0 * sig[self.check_steps[0]], device=dev)
        gs = torch.full((1,), 1000.0 * t["guidance"], device=dev)
        x = ins[:1]
        v = [self.model(x, ts, self.model.condition(tx, q["vec2"], gs,
                                                    self.mask(q)))
             for tx in (q["text"], text)]
        return rel_l2(v[1], v[0])

    # ---- the plain reference ----

    def _request(self):
        """The captured request the check reads, drawn from the seed among
        those the window finished: its index in the pool, its velocities
        [steps, ...] and the inputs of the checked steps, on the device."""
        if not hasattr(self, "_k"):
            done = min(len(self.accs), self.t["pool"])
            self._k = int(torch.randint(done, (), generator=self.pick))
        k = self._k
        return (k, k % self.t["pool"], self.outs[k].to(self.device),
                self.ins[k].to(self.device))

    def trajectory(self, acc_dtype: torch.dtype) -> torch.Tensor:
        """The request's latents integrated over the program's velocities
        on the reference's grid, in `acc_dtype`."""
        t = self.t
        _, i, outs, _ = self._request()
        start = requests(self.c, t, self.seed, self.device,
                         t["pool"])[i]["noise"]
        return ref.integrate(start, list(outs), t["steps"], t["flow_shift"],
                             acc_dtype)

    @torch.no_grad()
    def velocities(self, ops):
        """`ops`'s velocities at the checked steps [n, C, T, H, W] and its
        refiner's output [n, slots, D], from the program's own inputs, in
        one walk over the blocks."""
        dev, t, c = self.device, self.t, self.c
        ref_ops.fp32_matmuls()
        _, i, _, ins = self._request()
        q = requests(c, t, self.seed, dev, t["pool"])[i]
        sig, _ = ref.grid(t["steps"], t["flow_shift"])
        n = len(self.check_steps)
        ts = torch.tensor([1000.0 * sig[s] for s in self.check_steps],
                          device=dev)
        dt = inputs.DTYPES[t["param_dtype"]]

        def params(group: str) -> Dict[str, torch.Tensor]:
            return {k: v.float() for k, v in
                    weights(c, self.seed, group, dev, dt).items()}

        taps = {}
        v = ref.forward(ops, params, c, ins.float(), ts,
                        q["text"].expand(n, -1, -1), q["mask"].expand(n, -1),
                        q["vec2"].expand(n, -1),
                        torch.full((n,), 1000.0 * t["guidance"], device=dev),
                        taps)
        return v, taps["txt_in"]

    def check(self, control: bool = False) -> Dict[str, float]:
        """The velocity gap (the worse checked step's velocity against the
        reference's, relative L2) and the trajectory gap (the request's
        latents against the reference's integration of the program's
        velocities). The control puts the reference in the program's
        place: float8 products, a bf16 accumulator."""
        k, i, outs, _ = self._request()
        want, want_txt = self.velocities(ref_ops.Ops())
        end = self.trajectory(torch.float32)
        if control:
            got, got_txt = self.velocities(ref_ops.Ops(fp8=True))
            latents = self.trajectory(torch.bfloat16)
        else:
            got, got_txt = outs[self.check_steps], self.txts[k]
            latents = self.accs[k]
        n = self.reqs[i]["n_txt"] if hasattr(self, "reqs") else requests(
            self.c, self.t, self.seed, self.device, self.t["pool"])[i]["n_txt"]
        return {"velocity_gap": max(rel_l2(g, w) for g, w in zip(got, want)),
                "padding_gap": self.padding_gap,
                "text_gap": max(rel_l2(g[:n].to(w.device), w[:n])
                                for g, w in zip(got_txt, want_txt)),
                "trajectory_gap": rel_l2(latents, end)}
