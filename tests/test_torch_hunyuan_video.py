"""HunyuanVideo's MM-DiT (`models/hunyuan_video.py`) and its Euler sampler
against the plain reference (`benchmark/reference/hunyuan_video.py`) on the
CPU, at a tiny width with the published head dim (2 heads of 128), 2
double and 2 single blocks, latents [16, 3, 8, 8] and 16 text slots.

In float32 the port and the reference compute the same arithmetic, so the
velocity meets the reference's within 1e-5 relative L2: the port drops the
padded text rows, the reference keeps all 16 slots with the published
masks, and for the video output of a batch of 1 the two agree. The kernels
run their CPU twins here; `tests/test_torch_gpu_kernels.py` holds the
kernels to the twins on the card.
"""

import json
import math
import os
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from video_diffusion_speedrun_tpu_torch.core.config import HunyuanVideoConfig
from video_diffusion_speedrun_tpu_torch.models.hunyuan_video import (
    HunyuanVideo,
)
from video_diffusion_speedrun_tpu_torch.models.rope import (
    apply_rotary_pairs,
    nd_rope_cos_sin,
)
from video_diffusion_speedrun_tpu_torch.ops import fused_mmdit as fm
from video_diffusion_speedrun_tpu_torch.sampling.euler import (
    euler_guidance_sample,
)
from video_diffusion_speedrun_tpu_torch.utils.profiling import recorded_spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from benchmark.reference import hunyuan_video as ref  # noqa: E402
from benchmark.reference.dit import Ops  # noqa: E402

TINY = dict(hidden_size=256, heads_num=2, mm_double_blocks_depth=2,
            mm_single_blocks_depth=2, text_states_dim=64,
            text_states_dim_2=32, text_len=16)
SLOTS, VALID = 16, 11
LATENT = (16, 3, 8, 8)
FP32 = dict(param_dtype=torch.float32, compute_dtype=torch.float32)


def as_dict(cfg: HunyuanVideoConfig) -> dict:
    """The configuration under the benchmark's keys."""
    out = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__
           if f not in ("param_dtype", "compute_dtype")}
    out["rope_dim_list"] = list(cfg.rope_dim_list)
    out["patch_size"] = list(cfg.patch_size)
    return out


def tiny_model(seed: int):
    cfg = HunyuanVideoConfig(**TINY, **FP32)
    torch.manual_seed(seed)
    model = HunyuanVideo(cfg, device="cpu", seed=seed)
    with torch.no_grad():  # every layer random, norm weights off 1
        for name, p in model.named_parameters():
            if name.endswith("norm.weight") or ".norm" in name:
                p.add_(0.1 * torch.randn_like(p))
    return model, as_dict(cfg)


def inputs(seed: int, batch: int = 1):
    g = torch.Generator().manual_seed(1000 + seed)
    x = torch.randn(batch, *LATENT, generator=g)
    text = torch.randn(1, SLOTS, TINY["text_states_dim"], generator=g)
    vec2 = torch.randn(1, TINY["text_states_dim_2"], generator=g)
    mask = torch.arange(SLOTS)[None] < VALID
    return x, text, mask, vec2


def reference_params(model):
    sd = {k: v.float() for k, v in model.state_dict().items()}
    return lambda group: {k: v for k, v in sd.items()
                          if ref.group_of(k) == group}


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_and_sampler_match_the_reference(seed):
    """The forward at 11 of 16 valid text slots (the port drops the 5
    padded rows) and 3 Euler steps of `euler_guidance_sample` against the
    reference's forward with the masks and its Euler integration."""
    torch.manual_seed(seed)
    model, c = tiny_model(seed)
    x, text, mask, vec2 = inputs(seed)
    params = reference_params(model)
    ops = Ops()
    t = torch.tensor([870.0])
    g = torch.tensor([6000.0])
    with torch.no_grad():
        cond = model.condition(text, vec2, g, mask)
        got = model(x, t, cond)
        want = ref.forward(ops, params, c, x, t, text, mask, vec2, g)
    assert got.shape == x.shape
    assert rel_l2(got, want) < 1e-5

    steps, shift = 3, 7.0
    acc = euler_guidance_sample(model, x, text, vec2, text_mask=mask,
                                num_steps=steps, guidance=6.0, shift=shift)
    sig, _ = ref.grid(steps, shift)
    outs, cur = [], x.float()
    with torch.no_grad():
        for s in sig:
            v = ref.forward(ops, params, c, cur, torch.tensor([1000.0 * s]),
                            text, mask, vec2, g)
            outs.append(v[0])
            cur = ref.integrate(x, outs, steps, shift)
    assert rel_l2(acc, cur) < 1e-5


def test_padded_rows_change_nothing_the_masks_keep_out():
    """The reference with the published masks over 16 slots equals the
    reference over the 11 valid slots alone (what the port runs), and
    differs from the reference that lets the padding in."""
    model, c = tiny_model(3)
    x, text, mask, vec2 = inputs(3)
    params, ops = reference_params(model), Ops()
    t, g = torch.tensor([500.0]), torch.tensor([6000.0])
    with torch.no_grad():
        masked = ref.forward(ops, params, c, x, t, text, mask, vec2, g)
        dropped = ref.forward(ops, params, c, x, t, text[:, :VALID],
                              mask[:, :VALID], vec2, g)
        attended = ref.forward(ops, params, c, x, t, text,
                               torch.ones_like(mask), vec2, g)
    assert rel_l2(dropped, masked) < 1e-5
    assert rel_l2(attended, masked) > 1e-3


@pytest.mark.parametrize("grid", [(3, 4, 4), (9, 34, 60)])
def test_rope_tables_and_rotation_are_the_published(grid):
    """The port's per-pair tables, repeated per pair, are the reference's
    (`get_nd_rotary_pos_embed`), and the interleaved rotation by +θ is
    `apply_rotary_emb`'s; the kernel's twin rotates the video rows alone."""
    c = {"rope_dim_list": [16, 56, 56], "rope_theta": 256.0}
    cos, sin = nd_rope_cos_sin(grid, c["rope_dim_list"], c["rope_theta"])
    rc, rs = ref.rope_tables(c, grid, "cpu")
    assert cos.shape == (math.prod(grid), 64)
    torch.testing.assert_close(cos.repeat_interleave(2, 1), rc)
    torch.testing.assert_close(sin.repeat_interleave(2, 1), rs)
    x = torch.randn(1, math.prod(grid), 2, 128)
    torch.testing.assert_close(apply_rotary_pairs(x.transpose(1, 2), cos,
                                                  sin).transpose(1, 2),
                               ref.rotate(x, rc, rs))
    n_img, n_txt = math.prod(grid), 5
    buf = torch.randn(n_img + n_txt, 3 * 256)
    w = [1 + 0.1 * torch.randn(128) for _ in range(4)]
    got = fm.qk_norm_rope(buf.clone(), n_img, 2, *w, cos, sin)
    q = ref.rms(buf[:, :256].reshape(-1, 2, 128), w[0])
    q_txt = ref.rms(buf[n_img:, :256].reshape(-1, 2, 128), w[2])
    torch.testing.assert_close(
        got[:n_img, :256].reshape(1, -1, 2, 128),
        ref.rotate(q[None, :n_img], rc, rs), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got[n_img:, :256].reshape(-1, 2, 128), q_txt)
    torch.testing.assert_close(got[:, 512:], buf[:, 512:])


def test_parameter_names_and_count_are_the_published():
    path = os.path.join(ROOT, "benchmark", "configs",
                        "hunyuanvideo-t2v-13b.json")
    with open(path) as f:
        c = json.load(f)
    model = HunyuanVideo(HunyuanVideoConfig(), device="meta")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert shapes == ref.param_shapes(c)
    assert sum(p.numel() for p in model.parameters()) == c["parameters"]
    assert "txt_in.individual_token_refiner.blocks.1.norm2.bias" in shapes
    assert "double_blocks.19.txt_attn_k_norm.weight" in shapes
    assert "single_blocks.39.linear1.weight" in shapes


def test_a_step_records_the_spans_of_its_blocks():
    """Under the profiler one Euler step records one `vds/sample/step`
    holding one `vds/mm/text` and each block's span; the model's fused ops
    launch nothing on the CPU (their twins run), so their counters stay."""
    model, _ = tiny_model(4)
    x, text, mask, vec2 = inputs(4)
    recorded_spans()
    before = (fm.qk_norm_rope.launches, fm.ln_modulate.launches,
              fm.gelu_tanh.launches)
    with profile(activities=[ProfilerActivity.CPU]):
        euler_guidance_sample(model, x, text, vec2, text_mask=mask,
                              num_steps=1)
    spans = recorded_spans()
    names = [s.name for s in spans]
    assert names.count("vds/sample/step") == 1
    assert names.count("vds/mm/text") == 1
    assert names.count("vds/mm/double") == 2
    assert names.count("vds/mm/single") == 2
    assert all(s.parent == "vds/sample/step" for s in spans
               if s.name.startswith("vds/mm/"))
    assert (fm.qk_norm_rope.launches, fm.ln_modulate.launches,
            fm.gelu_tanh.launches) == before


def test_the_cli_samples_hunyuanvideo(tmp_path, monkeypatch):
    """`sample.py --model hunyuanvideo` on the CPU (the configuration cut
    to the tiny one): text states from a file, latents written."""
    from video_diffusion_speedrun_tpu_torch import sample
    from video_diffusion_speedrun_tpu_torch.core import config

    monkeypatch.setattr(config, "HunyuanVideoConfig",
                        lambda: HunyuanVideoConfig(**TINY, **FP32))
    _, text, mask, vec2 = inputs(5)
    path = tmp_path / "text.pt"
    torch.save({"text_states": text[0], "text_mask": mask[0],
                "text_states_2": vec2[0]}, path)
    report = {}
    latents = sample.main(["--model", "hunyuanvideo", "--device", "cpu",
                           "--height", "64", "--width", "64",
                           "--num_latent_frames", "3", "--inference_steps",
                           "2", "--text_states", str(path), "--output",
                           str(tmp_path), "--name", "hv"], report=report)
    assert latents.shape == (1, 16, 3, 8, 8)
    assert torch.isfinite(latents).all()
    assert torch.equal(torch.load(report["path"]), latents)
