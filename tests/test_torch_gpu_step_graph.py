"""The train step's CUDA graphs against the eager step, on the card.

Every test here carries the `gpu` marker and skips when no CUDA card is
present. The model is the canonical DiT (width 512, 4 heads of 128,
context width 4096, remat on) at depth 2, its zero-initialised layers made
random, trained at batch 4 of [16, 5, 32, 32] latents (L = 528) with the
caption dropout raised to 0.5, every draw (timesteps, noise, dropout, RoPE
offsets) taken from one CUDA generator. `train_step` (graphs) and
`eager_train_step` start from the same weights and generator seed; the
kernels and their order are the same, so the two must agree bit for bit.
The file imports torch only:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_step_graph.py
"""

import copy
import dataclasses

import pytest
import torch

from video_diffusion_speedrun_tpu_torch.models.dit import DiT
from video_diffusion_speedrun_tpu_torch.train import __main__ as cli
from video_diffusion_speedrun_tpu_torch.train.loss import rectified_flow_loss
from video_diffusion_speedrun_tpu_torch.train.optim import MupAdamW
from video_diffusion_speedrun_tpu_torch.train.step import (
    eager_train_step,
    launch_counters,
    train_step,
)

pytestmark = pytest.mark.gpu

ARGV = ["--model_width", "512", "--model_depth", "2", "--model_head_dim",
        "128", "--context_dim", "4096", "--batch_size", "4",
        "--learning_rate", "0.015625", "--lr_scheduler_type", "linear",
        "--max_steps", "5004", "--device", "cuda"]
L528, L1040 = (16, 5, 32, 32), (16, 9, 32, 32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def build(dev):
    """(cfg, model): the depth-2 canonical DiT, no layer left at zero."""
    cfg = cli.build_config(cli.parse_args(ARGV))
    cfg = dataclasses.replace(cfg, caption_dropout=0.5)
    model = DiT(cfg.model, device=dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            if not p.any():
                p.normal_(0.0, 0.02, generator=gen)
    return cfg, model


def make_batches(dev, n, latent, seed=3):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [{"latent": torch.randn((4, *latent), generator=gen, device=dev),
             "context": 0.05 * torch.randn((4, 512, 4096), generator=gen,
                                           device=dev, dtype=torch.bfloat16)}
            for _ in range(n)]


class Run:
    """One train state: a model, its optimizer and its generator, stepped
    by `step`; keeps each step's metrics and launch-counter moves."""

    def __init__(self, step, cfg, model, dev):
        self.step, self.cfg, self.model = step, cfg, model
        self.opt = MupAdamW(model.named_parameters(),
                            cfg.optimizer.learning_rate, cfg.max_steps,
                            cfg.optimizer)
        self.gen = torch.Generator(device=dev).manual_seed(7)
        self.metrics, self.launches = [], []

    def take(self, batches):
        for b in batches:
            before = launch_counters()
            self.metrics.append(self.step(self.model, self.opt, b, self.gen,
                                          self.cfg))
            after = launch_counters()
            self.launches.append({k: n - before.get(k, 0)
                                  for k, n in after.items()
                                  if n != before.get(k, 0)})
        torch.cuda.synchronize()


def graph_counts():
    return (train_step.captures, train_step.replays, train_step.eager_steps)


def assert_same_state(a: Run, b: Run):
    for ma, mb in zip(a.metrics, b.metrics, strict=True):
        for k in ("loss", "bin_sums", "bin_counts", "timesteps"):
            assert torch.equal(ma[k], mb[k]), k
        assert ma["lr_scale"] == mb["lr_scale"]
    for (name, p), q in zip(a.model.named_parameters(),
                            b.model.parameters()):
        assert torch.equal(p, q), name
    for x, y in zip(a.opt.m + a.opt.v, b.opt.m + b.opt.v, strict=True):
        assert torch.equal(x, y)
    assert torch.equal(a.gen.get_state(), b.gen.get_state())


def pair(dev):
    cfg, model = build(dev)
    return (Run(train_step, cfg, model, dev),
            Run(eager_train_step, cfg, copy.deepcopy(model), dev))


def test_replayed_steps_equal_eager_steps(dev):
    """4 steps: the first eager (the warm-up), the second captures and
    replays, the last two replay. Losses, bins, timesteps, parameters, both
    moments and the generator's state equal the eager run's; each replay
    moves every launch counter as an eager step does; the returned metrics
    are tensors of their own, not the graph's outputs."""
    graph, eager = pair(dev)
    batches = make_batches(dev, 4, L528)
    before = graph_counts()
    graph.take(batches)
    after = graph_counts()
    eager.take(batches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 3, 1)
    assert_same_state(graph, eager)
    want = eager.launches[0]
    assert want and all(n > 0 for n in want.values())
    assert all(moved == want for moved in graph.launches + eager.launches)
    kept = graph.opt.step_graphs.graph.outputs[0].untyped_storage()
    ptrs = [m["loss"].untyped_storage().data_ptr() for m in graph.metrics]
    assert len(set(ptrs)) == 4 and kept.data_ptr() not in ptrs
    losses = torch.stack([m["loss"] for m in graph.metrics])
    assert len(set(losses.tolist())) == 4  # four steps' own readings


def test_another_shape_runs_eagerly_then_captures_anew(dev):
    """After two steps at L = 528, a batch at L = 1040 runs eagerly, the
    next one captures its own graph, and a return to L = 528 warms up and
    captures again; every step equals the eager run's."""
    graph, eager = pair(dev)
    plan = [L528, L528, L1040, L1040, L1040, L528, L528, L528]
    seen = []
    for i, latent in enumerate(plan):
        (batch,) = make_batches(dev, 1, latent, seed=10 + i)
        before = graph_counts()
        graph.take([batch])
        seen.append(tuple(a - b for a, b in zip(graph_counts(), before)))
        eager.take([batch])
    assert seen == [(0, 0, 1), (1, 1, 0), (0, 0, 1), (1, 1, 0), (0, 1, 0),
                    (0, 0, 1), (1, 1, 0), (0, 1, 0)]
    assert_same_state(graph, eager)


def test_captures_beside_an_outside_graph(dev):
    """A backward run outside the step on the default stream whose graph
    is kept alive (as a parity check before training keeps its loss)
    leaves the parameters' autograd nodes on that stream; the step still
    captures, and equals the eager run."""
    graph, eager = pair(dev)
    batches = make_batches(dev, 4, L528)
    kept = []
    for run in (graph, eager):
        gen = torch.Generator(device=dev).manual_seed(5)
        loss, _ = rectified_flow_loss(run.model, batches[0]["latent"],
                                      batches[0]["context"], gen)
        loss.backward()
        kept.append(loss)
        run.model.zero_grad(set_to_none=True)
    before = graph_counts()
    graph.take(batches)
    eager.take(batches)
    assert tuple(a - b for a, b in zip(graph_counts(), before)) == (1, 3, 1)
    assert_same_state(graph, eager)


def test_refresh_drops_the_graphs(dev):
    """`MupAdamW.refresh` (a checkpoint load) drops the graphs: the next
    step warms up again."""
    graph, _ = pair(dev)
    graph.take(make_batches(dev, 2, L528))
    assert graph.opt.step_graphs.graph is not None
    graph.opt.refresh()
    assert graph.opt.step_graphs is None
    before = graph_counts()
    graph.take(make_batches(dev, 1, L528))
    assert tuple(a - b for a, b in zip(graph_counts(), before)) == (0, 0, 1)
