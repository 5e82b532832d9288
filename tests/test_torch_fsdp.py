"""The FSDP/TP placement rule of the port (`parallel/fsdp.py`) against
JAX's, the data shards, the kernel modules at tensor-parallel local
shapes, and FSDP over 2 gloo processes on the CPU against JAX
`build_train_step` on the same mesh.

- Placement: for every parameter of the canonical DiT (width 512, depth
  24, 4 heads, 4096-wide context; with and without the trainable biases
  and norms) at (fsdp 4, tensor 2) and (replica 2, fsdp 2), the axes of
  `param_placements` are those of JAX `param_pspec` on the stacked leaf
  the parameter maps to (names through `models/convert.py`); the same for
  T5-XXL's leaves and `t5_placement`. No parameter deviates: the packed
  qkv / context_kv rows differ from GSPMD's in layout (each tensor rank
  holds q, k and v of its heads), not in which axis takes which dim.
- `ShardedSampler(shard, num_shards)`: JAX's indices bit for bit.
- Kernel twins at H/t heads and F/t columns (t = 2, 4 of 4 heads and
  F = 512): each rank's slice through the port against JAX's function on
  the same slice, and against JAX's whole output's columns: atol 2e-5,
  rtol 1e-4 as tests/test_torch_fused_attention.py (gradients 5e-5 /
  1e-4); bias+GELU in fp32 to 1e-6 absolute, its gradients to four fp32
  ulps of their largest term as tests/test_torch_fused_gelu.py.
- fsdp 2 training: losses and grad norms of 3 steps to rtol 1e-5, the
  step-1 gradients to 1e-5 relative L2 (as
  tests/test_torch_tensor_parallel.py); T5 sharded over fsdp 2 encodes as
  the unsharded one (to 1e-6 of its scale); the train CLI reaches step 3
  at `--mesh_fsdp 2` and at `--mesh_tensor 2`.
"""

import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_fsdp_workers as workers
import _torch_jax_mesh as ref
from video_diffusion_speedrun_tpu.core.config import DiTConfig as JCfg
from video_diffusion_speedrun_tpu.core.config import MeshConfig as JMesh
from video_diffusion_speedrun_tpu.data.loader import (
    ShardedSampler as JSampler,
)
from video_diffusion_speedrun_tpu.models.dit import init_dit
from video_diffusion_speedrun_tpu.models.rope import rope_cos_sin
from video_diffusion_speedrun_tpu.ops import fused_attention as jfa
from video_diffusion_speedrun_tpu.ops.fused_gelu import _phi_poly
from video_diffusion_speedrun_tpu.parallel.fsdp import param_pspec
from video_diffusion_speedrun_tpu.parallel.mesh import build_mesh
from video_diffusion_speedrun_tpu.text import t5 as jt5
from video_diffusion_speedrun_tpu_torch.core.config import DiTConfig as TCfg
from video_diffusion_speedrun_tpu_torch.data.loader import (
    ShardedSampler,
    replica_rows,
)
from video_diffusion_speedrun_tpu_torch.models import convert
from video_diffusion_speedrun_tpu_torch.models.dit import DiT
from video_diffusion_speedrun_tpu_torch.ops import fused_attention as tfa
from video_diffusion_speedrun_tpu_torch.ops import fused_gelu as tg
from video_diffusion_speedrun_tpu_torch.parallel.fsdp import (
    param_placements,
    t5_placement,
)
from video_diffusion_speedrun_tpu_torch.text.t5 import T5Config, T5Encoder

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-5
# port parameter → why its placement differs from JAX's (none does)
DEVIATIONS = {}


def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ------------------------------------------------------------- placement


def _axes(spec, ndim):
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return [a if a in ("fsdp", "tensor") else None for a in spec]


def _jax_keys(name):
    """The JAX tree path of a port DiT parameter: (keys, stacked)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        rest = ".".join(parts[2:])
        if "." not in rest:
            return ("blocks", rest), True
        mod, leaf = rest.rsplit(".", 1)
        for path, port in convert._BLOCK_LINEAR.items():
            if port == mod:
                return ("blocks",) + path + (leaf,), True
        assert mod in convert._NORMS, name
        return ("blocks", mod, "scale"), True
    mod, _, leaf = name.rpartition(".")
    for path, port in convert._ROOT_LINEAR.items():
        if port == mod:
            return path + (leaf,), False
    if mod == "patch_embed.patch_proj":
        return ("patch_proj", leaf), False
    if mod == "final_norm":
        return ("final_norm", "scale"), False
    return (name,), False


def _jax_specs(tree, mesh):
    out = {}

    def visit(path, leaf):
        keys = tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
        out[keys] = (_axes(param_pspec(path, leaf, mesh), leaf.ndim),
                     leaf.shape)

    jax.tree_util.tree_map_with_path(visit, tree)
    return out


def _want(name, shape, axes):
    """JAX's axes of a leaf → the port Placement's (fsdp, tensor) dims."""
    if name == "patch_embed.patch_proj.weight" or len(shape) == 2:
        to_torch = {0: 1, 1: 0}
    else:
        to_torch = {i: i for i in range(len(shape))}
    dims = {a: to_torch[i] for i, a in enumerate(axes) if a is not None}
    return dims.get("fsdp"), dims.get("tensor")


CANONICAL = dict(in_channels=16, patch_size=2, time_patch_size=2,
                 hidden_size=512, depth=24, num_heads=4, mlp_ratio=4.0,
                 cross_attn_input_size=4096, residual_v=True, use_rope=True)


@pytest.mark.parametrize("trainable", [False, True])
@pytest.mark.parametrize("mesh_shape", [(1, 4, 1, 2), (2, 2, 1, 1)])
def test_placements_equal_jax_param_pspec(mesh_shape, trainable):
    r, f, c, t = mesh_shape
    jcfg = JCfg(**CANONICAL, train_bias_and_rms=trainable)
    shapes = jax.eval_shape(lambda k: init_dit(k, jcfg),
                            jax.random.PRNGKey(0))
    mesh = build_mesh(JMesh(replica=r, fsdp=f, context=c, tensor=t),
                      devices=jax.devices()[:r * f * c * t])
    specs = _jax_specs(shapes, mesh)
    model = DiT(TCfg(**CANONICAL, train_bias_and_rms=trainable),
                device="meta")
    sizes = {"fsdp": f, "tensor": t}
    seen = set()
    for name, p in model.named_parameters():
        keys, stacked = _jax_keys(name)
        axes, jshape = specs[keys]
        seen.add(keys)
        if stacked:
            axes = axes[1:]
        got = param_placements(name, tuple(p.shape), sizes, depth=24)
        if name in DEVIATIONS:
            continue
        assert (got.fsdp, got.tensor) == _want(name, p.shape, axes), (
            name, got, axes)
        if name.endswith(("qkv.weight", "context_kv.weight")) and t > 1:
            assert got.split == (3 if "qkv" in name else 2)
    assert seen == set(specs), set(specs) - seen
    # the rule shards something on each axis at this size
    placed = [param_placements(n, tuple(p.shape), sizes, depth=24)
              for n, p in model.named_parameters()]
    assert any(pl.fsdp is not None for pl in placed)
    assert (t > 1) == any(pl.tensor is not None for pl in placed)


def test_t5_placements_equal_jax_param_pspec():
    """T5-XXL's leaves sharded over fsdp 4 (the JAX encoder's
    `shard_params`)."""
    shapes = jax.eval_shape(lambda k: jt5.init_t5(k, jt5.T5Config()),
                            jax.random.PRNGKey(0))
    mesh = build_mesh(JMesh(fsdp=4), devices=jax.devices()[:4])
    specs = _jax_specs(shapes, mesh)
    names = {("embed",): "shared.weight",
             ("final_ln",): "encoder.final_layer_norm.weight"}
    block = {"ln1": "layer.0.layer_norm.weight",
             "ln2": "layer.1.layer_norm.weight",
             "relative_attention_bias":
                 "layer.0.SelfAttention.relative_attention_bias.weight"}
    for n in "qkvo":
        block[n] = f"layer.0.SelfAttention.{n}.weight"
    for n in ("wi_0", "wi_1", "wi", "wo"):
        block[n] = f"layer.1.DenseReluDense.{n}.weight"
    model = T5Encoder(T5Config.xxl(), device="meta")
    params = dict(model.named_parameters())
    for keys, (axes, jshape) in specs.items():
        if keys[0] == "blocks":
            name = f"encoder.block.{keys[1]}.{block[keys[2]]}"
        else:
            name = names[keys]
        shape = tuple(params[name].shape)
        # the linears are [in, out] in JAX; the embeddings are not linears
        transposed = keys[-1] in ("q", "k", "v", "o", "wi_0", "wi_1", "wi",
                                  "wo")
        dims = {({0: 1, 1: 0}[i] if transposed else i): a
                for i, a in enumerate(axes) if a is not None}
        want = {a: d for d, a in dims.items()}.get("fsdp")
        assert t5_placement(name, shape, 4).fsdp == want, (name, axes)


# ------------------------------------------------------------------ data


@pytest.mark.parametrize("rows,batch,shards,seed,shuffle", [
    (40, 4, 1, 0, True), (40, 4, 4, 3, True), (100, 6, 3, 7, True),
    (37, 2, 4, 1, False)])
def test_sharded_sampler_equals_jax(rows, batch, shards, seed, shuffle):
    for shard in range(shards):
        got = ShardedSampler(rows, batch, seed, shuffle=shuffle, shard=shard,
                             num_shards=shards)
        want = JSampler(rows, batch, shard, shards, seed=seed,
                        shuffle=shuffle)
        for e in range(3):
            np.testing.assert_array_equal(got.epoch(e), want.epoch(e))


def test_shards_read_the_rows_replica_rows_keeps():
    """The default collate's path (each data shard reads its rows) and the
    bucketing collates' path (every process reads the global batch and
    keeps its shard's rows) see the same rows."""
    glob = ShardedSampler(64, 16, 5).epoch(0)
    for shard in range(4):
        mine = ShardedSampler(64, 4, 5, shard=shard, num_shards=4).epoch(0)
        kept = list(replica_rows(({"i": b} for b in glob), shard, 4))
        np.testing.assert_array_equal(mine, np.stack([k["i"] for k in kept]))
    with pytest.raises(ValueError, match="out of range"):
        ShardedSampler(64, 4, shard=4, num_shards=4)


# ------------------------------------------------- kernels at local shapes

H, D, B, L = 4, 32, 2, 48


def _local_cols(x, parts, t, r):
    """Rank r's columns of a packed (parts, H, D) last dim."""
    return np.ascontiguousarray(
        x.reshape(*x.shape[:-1], parts, t, -1)[..., r, :].reshape(
            *x.shape[:-1], -1))


def _close(got, want, atol=2e-5, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("t", [2, 4])
def test_attention_twins_on_local_heads_match_jax(t):
    r_ = np.random.default_rng(t)
    qkv = r_.normal(size=(B, L, 3 * H * D)).astype(np.float32)
    v = r_.normal(size=(B, L, H * D)).astype(np.float32)
    q = r_.normal(size=(B, L, H * D)).astype(np.float32)
    ckv = r_.normal(size=(B, 20, 2 * H * D)).astype(np.float32)
    do = r_.normal(size=(B, L, H * D // t)).astype(np.float32)
    cos, sin = (np.array(a) for a in rope_cos_sin(
        D, 1, 1, L - 16, jnp.asarray([2, 0, 5]), num_registers=16))
    jc, js = jnp.asarray(cos), jnp.asarray(sin)
    whole = np.asarray(jfa.qkv_rope_flash_attention(
        jnp.asarray(qkv), jnp.asarray(v), jc, js, H))
    whole_x = np.asarray(jfa.cross_flash_attention(
        jnp.asarray(q), jnp.asarray(ckv[..., :H * D]),
        jnp.asarray(ckv[..., H * D:]), H))
    h, w = H // t, H * D // t
    for r in range(t):
        lqkv, lv = _local_cols(qkv, 3, t, r), _local_cols(v, 1, t, r)
        lq, lckv = _local_cols(q, 1, t, r), _local_cols(ckv, 2, t, r)
        # self-attention (rows 1 and 4) on the local heads
        ta = torch.from_numpy(lqkv).requires_grad_()
        tb = torch.from_numpy(lv).requires_grad_()
        out = tfa.qkv_rope_flash_attention(ta, tb, torch.from_numpy(cos),
                                           torch.from_numpy(sin), h)
        out.backward(torch.from_numpy(do))
        want, vjp = jax.vjp(lambda a, b: jfa.qkv_rope_flash_attention(
            a, b, jc, js, h), jnp.asarray(lqkv), jnp.asarray(lv))
        _close(out.detach(), want)
        _close(out.detach(), whole[..., r * w:(r + 1) * w])
        ja, jb = vjp(jnp.asarray(do))
        _close(ta.grad, ja, 5e-5)
        _close(tb.grad, jb, 5e-5)
        # cross-attention (rows 2 and 5) on the local heads
        tq = torch.from_numpy(lq).requires_grad_()
        tk = torch.from_numpy(lckv).requires_grad_()
        out = tfa.cross_flash_attention(tq, tk[..., :w], tk[..., w:], h)
        out.backward(torch.from_numpy(do))
        want, vjp = jax.vjp(lambda a, b, c: jfa.cross_flash_attention(
            a, b, c, h), jnp.asarray(lq), jnp.asarray(lckv[..., :w]),
            jnp.asarray(lckv[..., w:]))
        _close(out.detach(), want)
        _close(out.detach(), whole_x[..., r * w:(r + 1) * w])
        jq, jk, jv = vjp(jnp.asarray(do))
        _close(tq.grad, jq, 5e-5)
        _close(tk.grad, np.concatenate([jk, jv], -1), 5e-5)


@pytest.mark.parametrize("t", [2, 4])
def test_bias_gelu_twin_on_local_columns_matches_jax(t):
    """Rows 15–16 on F/t columns: the port's MLP epilogue against the JAX
    block's expression (h + b)·Φ_poly(h + b) and its vjp, fp32."""
    f = 512
    r_ = np.random.default_rng(10 + t)
    hx = r_.normal(size=(B, L, f)).astype(np.float32) * 2
    bias = r_.normal(size=(f,)).astype(np.float32)
    g = r_.normal(size=(B, L, f // t)).astype(np.float32)

    def block(a, b):
        hf = a + b
        return hf * _phi_poly(hf)

    cols = f // t
    for r in range(t):
        lh = np.ascontiguousarray(hx[..., r * cols:(r + 1) * cols])
        lb = np.ascontiguousarray(bias[r * cols:(r + 1) * cols])
        th = torch.from_numpy(lh).requires_grad_()
        tb = torch.from_numpy(lb).requires_grad_()
        out = tg.mlp_bias_gelu(th, tb)
        out.backward(torch.from_numpy(g))
        want, vjp = jax.vjp(block, jnp.asarray(lh), jnp.asarray(lb))
        _close(out.detach(), want, 1e-6, 0)
        _close(out.detach(), np.asarray(block(
            jnp.asarray(hx), jnp.asarray(bias)))[..., r * cols:(r + 1) * cols],
            1e-6, 0)
        dh, db = vjp(jnp.asarray(g))
        # the port's exact Φ_poly' against JAX's autodiff of Φ_poly: four
        # fp32 ulps of the largest term of g·(Φ + h·Φ'(h)), as
        # tests/test_torch_fused_gelu.py bounds it
        hf = np.abs(lh + lb)
        t2 = np.minimum(hf / tg._POLY_R, 1.0) ** 2
        terms = sum(abs(c) * t2 ** i for i, c in enumerate(tg._DPHI_C))
        bound = 2.0 ** -22 * np.abs(g) * (1 + hf * terms / tg._POLY_R)
        assert (np.abs(th.grad.numpy() - np.asarray(dh)) <= bound).all()
        db_bound = bound.reshape(-1, cols).sum(0) + 1e-5 * np.abs(db)
        assert (np.abs(tb.grad.numpy() - np.asarray(db)) <= db_bound).all()


# ------------------------------------------------------------ fsdp 2 world


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The JAX reference at fsdp 2, then the 2-process run (fsdp 2, the
    sharded T5, the CLI): one after the other, as
    tests/test_torch_tensor_parallel.py does."""
    tmp = tmp_path_factory.mktemp("fsdp")
    params, data = ref.worker_inputs()
    np.savez(tmp / "in.npz", **data)
    want = ref.reference(params, data, workers.MESHES[2]["fsdp"])
    run = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_fsdp_workers.py"), "2",
         str(_port()), str(_port()), str(tmp / "in.npz"),
         str(tmp / "out.npz"), str(tmp / "ckpt")],
        capture_output=True, text=True, timeout=400, cwd=tmp)
    assert run.returncode == 0, run.stderr[-4000:]
    return dict(np.load(tmp / "out.npz")), want


def test_fsdp_training_matches_jax(world2):
    res, (losses, norms, grads) = world2
    names = [n for n, _ in DiT(workers.model_config(),
                               device="meta").named_parameters()]
    np.testing.assert_allclose(res["fsdp.losses"], losses, rtol=RTOL)
    np.testing.assert_allclose(res["fsdp.grad_norm"], norms, rtol=RTOL)
    rel = ref.rel_l2(res["fsdp.grads"], ref.flat_grads(grads, names))
    assert rel < RTOL, rel
    # C8: block 0's λ never mixes v0; JAX's gradient is 0, the port's None
    assert grads["blocks"]["lambda_param"][0] == 0
    assert res["fsdp.lambda0_none"].all()
    lam = float(grads["blocks"]["lambda_param"][1, 0])
    np.testing.assert_allclose(res["fsdp.lambda"].ravel(), [lam, lam],
                               rtol=RTOL)
    assert res["fsdp.data_rank"].ravel().tolist() == [0, 1]
    assert not np.array_equal(*res["fsdp.draws"])


def test_fsdp_training_under_dots_matches_jax(world2):
    """The remat policy "dots" at fsdp 2: selective checkpointing keeps the
    products' outputs while FSDP2 gathers each block again for its
    recompute."""
    res, (losses, norms, grads) = world2
    names = [n for n, _ in DiT(workers.model_config(),
                               device="meta").named_parameters()]
    np.testing.assert_allclose(res["fsdp.dots.losses"], losses, rtol=RTOL)
    np.testing.assert_allclose(res["fsdp.dots.grad_norm"], norms, rtol=RTOL)
    rel = ref.rel_l2(res["fsdp.dots.grads"], ref.flat_grads(grads, names))
    assert rel < RTOL, rel


def test_t5_sharded_over_fsdp_encodes_as_unsharded(world2):
    res, _ = world2
    assert int(res["t5.sharded"]) > 0  # FSDP2 holds some of its leaves
    assert float(res["t5.err"]) <= 1e-6 * float(res["t5.scale"])


def test_train_cli_trains_on_fsdp_and_tensor_meshes(world2):
    """`torchrun`-style environment, `main` with `--mesh_fsdp 2` and with
    `--mesh_tensor 2` on `--device cpu`: both log their third step
    (index 2) with a finite loss."""
    res, _ = world2
    assert res["cli.steps"].tolist() == [2, 2]
