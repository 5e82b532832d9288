"""Leaf ops of the PyTorch port against the JAX package, on the CPU.

Same inputs (numpy, seeded) through both; fp32, atol 1e-6. Also checks that
no file of the port imports JAX or the JAX package.
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_diffusion_speedrun_tpu.models import rope as jrope
from video_diffusion_speedrun_tpu.ops import embeddings as jemb
from video_diffusion_speedrun_tpu.ops import fused_gelu as jgelu
from video_diffusion_speedrun_tpu.ops import normalization as jnorm
from video_diffusion_speedrun_tpu.ops import patchify as jpatch
from video_diffusion_speedrun_tpu.ops.attention import (
    dot_product_attention as j_dpa,
)
from video_diffusion_speedrun_tpu.train.loss import time_shift as j_time_shift
from video_diffusion_speedrun_tpu_torch.models import rope as trope
from video_diffusion_speedrun_tpu_torch.ops import embeddings as temb
from video_diffusion_speedrun_tpu_torch.ops import fused_gelu as tgelu
from video_diffusion_speedrun_tpu_torch.ops import normalization as tnorm
from video_diffusion_speedrun_tpu_torch.ops import patchify as tpatch
from video_diffusion_speedrun_tpu_torch.ops.attention import (
    dot_product_attention as t_dpa,
)
from video_diffusion_speedrun_tpu_torch.train.loss import (
    time_shift as t_time_shift,
)

ATOL = 1e-6
REPO = pathlib.Path(__file__).resolve().parent.parent


def _close(got, want, atol=ATOL, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol)


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_timestep_embedding():
    t = _rng().uniform(0, 1, 5).astype(np.float32)
    _close(temb.timestep_embedding(torch.from_numpy(t), 64),
           jemb.timestep_embedding(jnp.asarray(t), 64))


@pytest.mark.parametrize("with_scale", [False, True])
def test_rms_norm(with_scale):
    x = _rng(1).normal(size=(2, 7, 48)).astype(np.float32)
    s = _rng(2).normal(size=(48,)).astype(np.float32) if with_scale else None
    got = tnorm.rms_norm(torch.from_numpy(x),
                         None if s is None else torch.from_numpy(s))
    want = jnorm.rms_norm(jnp.asarray(x), None if s is None else jnp.asarray(s))
    _close(got, want)


@pytest.mark.parametrize("shape", [(2, 3, 4, 8, 6), (1, 4, 5, 7, 9)])
def test_patchify_roundtrip(shape):
    """Odd T and odd H/W floor-crop; patchify and unpatchify match JAX."""
    x = _rng(3).normal(size=shape).astype(np.float32)
    c = shape[1]
    pt, p, dim = 2, 2, 24
    kern = _rng(4).normal(size=(c * pt * p * p, dim)).astype(np.float32)
    bias = _rng(5).normal(size=(dim,)).astype(np.float32)
    got = tpatch.patchify(torch.from_numpy(x), torch.from_numpy(kern),
                          torch.from_numpy(bias), pt, p, torch.float32)
    want = jpatch.patchify(jnp.asarray(x), jnp.asarray(kern),
                           jnp.asarray(bias), pt, p, jnp.float32)
    _close(got, want, atol=1e-5, rtol=1e-5)

    gt, gh, gw = shape[2] // pt, shape[3] // p, shape[4] // p
    tok = _rng(6).normal(size=(shape[0], gt * gh * gw, p * p * pt * c))
    tok = tok.astype(np.float32)
    _close(tpatch.unpatchify(torch.from_numpy(tok), gt, gh, gw, pt, p, c),
           jpatch.unpatchify(jnp.asarray(tok), gt, gh, gw, pt, p, c))


@pytest.mark.parametrize("order", ["matched", "reference"])
@pytest.mark.parametrize("offsets,regs", [((0, 0, 0), 0), ((3, 1, 7), 16)])
def test_rope_cos_sin(order, offsets, regs):
    off = np.asarray(offsets, np.int32)
    tc, ts = trope.rope_cos_sin(32, 3, 4, 5, torch.from_numpy(off),
                                num_registers=regs, order=order)
    jc, js = jrope.rope_cos_sin(32, 3, 4, 5, jnp.asarray(off),
                                num_registers=regs, order=order)
    _close(tc, jc)
    _close(ts, js)


def test_random_rope_offsets_inclusive_range():
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([trope.random_rope_offsets(gen, 4, 6, 6, 6, 8, 7)
                         for _ in range(400)])
    assert draws.min(0).values.tolist() == [0, 0, 0]
    assert draws.max(0).values.tolist() == [2, 2, 1]


def test_apply_rotary():
    x = _rng(7).normal(size=(2, 3, 11, 32)).astype(np.float32)
    cos, sin = jrope.rope_cos_sin(32, 1, 1, 11, jnp.asarray([0, 2, 1]))
    got = trope.apply_rotary(torch.from_numpy(x),
                             torch.from_numpy(np.array(cos)),
                             torch.from_numpy(np.array(sin)))
    _close(got, jrope.apply_rotary(jnp.asarray(x), cos, sin))


def test_dot_product_attention():
    r = _rng(8)
    q, k, v = (r.normal(size=(2, 2, n, 16)).astype(np.float32)
               for n in (9, 13, 13))
    got = t_dpa(*(torch.from_numpy(a) for a in (q, k, v)))
    _close(got, j_dpa(*(jnp.asarray(a) for a in (q, k, v))), atol=2e-6)


def test_phi_poly_and_time_shift():
    x = np.concatenate([np.linspace(-9, 9, 301),
                        [-4.2, 4.2, -1e4, 1e4]]).astype(np.float32)
    _close(tgelu._phi_poly(torch.from_numpy(x)), jgelu._phi_poly(jnp.asarray(x)))
    t = np.linspace(0, 1, 11).astype(np.float32)
    _close(t_time_shift(torch.from_numpy(t), 8.0),
           j_time_shift(jnp.asarray(t), 8.0))


def _forbidden(name: str) -> bool:
    return any(name == top or name.startswith(top + ".")
               for top in ("jax", "video_diffusion_speedrun_tpu"))


def test_port_imports_no_jax():
    files = sorted((REPO / "video_diffusion_speedrun_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    scanned = {p.relative_to(REPO).as_posix() for p in files}
    pkg = "video_diffusion_speedrun_tpu_torch/"
    for module in ("core/config", "ops/fused_attention", "ops/fused_adaln",
                   "ops/fused_adamw", "ops/fused_gelu", "models/dit",
                   "data/synthetic", "data/loader", "train/loss",
                   "train/schedules",
                   "train/mup", "train/optim", "train/step", "train/loop",
                   "train/__main__", "utils/flops", "sampling/euler",
                   "sample", "train/checkpoint", "text/t5", "text/encoder",
                   "models/cosmos_vae", "models/cosmos_layer_map",
                   "sampling/decode", "sampling/app"):
        assert pkg + module + ".py" in scanned, module
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names if _forbidden(n)]
    assert not bad, bad


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without a CUDA toolkit the build raises a clear error (it never
    runs at import); a library is named by the hash of its source."""
    from video_diffusion_speedrun_tpu_torch.ops import _build

    name = "short_attention_fwd"
    assert _build._lib_path(name).name.startswith(f"lib{name}-")
    monkeypatch.setattr(_build, "_lib_path", lambda n: tmp_path / f"lib{n}.so")
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build([name])
