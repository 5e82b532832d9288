"""The remat policies of the port (`DiTConfig.remat_policy`: "nothing",
"dots", "attn", "dots_attn"; `models/dit.py:remat_context_fn`) on the CPU.

- Each policy's loss and gradients against the port without remat
  (≤ 1e-6 relative: the recompute reruns or reuses the same operations on
  the same inputs; measured equal bit for bit) and against JAX
  `value_and_grad(rectified_flow_loss)` at the same policy on the same
  weights and injected draws (the loss at rtol 1e-5; the whole gradient
  at 1e-5 relative L2), on the short self-attention path, the long one
  (L = 2064: above SHORT_MAX_KV, with JAX's 16-column prefix), the
  `fused_residual` joins and the ring over `LocalRing(2)` (JAX's ring on
  a 2-device context mesh). The port runs its fused ops' twins
  (`attention_impl="fused"`); JAX runs its Pallas kernels in interpret
  mode under "attn" and "dots_attn", whose names it saves, and XLA
  attention under "nothing" and "dots", where no name is saved.
- Under "attn" and "dots_attn" each attention forward runs once per block
  and step (the recompute replays the kept o and lse; for the ring: no
  chunk forward, merge or shift), twice under "nothing" and "dots".
- "dots" replays every product with no batch dims (`aten.mm` /
  `aten.addmm`) and recomputes the batched ones, counted by a dispatch
  mode over the backward.
- A replay whose record is missing or out of order raises; each
  checkpoint call keeps its own record (two graphs backwarded in reverse
  order); the train CLI's `--remat_policy` reaches the config.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from video_diffusion_speedrun_tpu.core.config import DiTConfig as JCfg
from video_diffusion_speedrun_tpu.models.dit import init_dit
from video_diffusion_speedrun_tpu.train.loss import (
    rectified_flow_loss as j_loss,
)
from video_diffusion_speedrun_tpu_torch.core.config import DiTConfig as TCfg
from video_diffusion_speedrun_tpu_torch.models.convert import (
    state_dict_from_jax_params,
)
from video_diffusion_speedrun_tpu_torch.models.dit import DiT
from video_diffusion_speedrun_tpu_torch.ops import fused_attention as tfa
from video_diffusion_speedrun_tpu_torch.parallel.ring import LocalRing
from video_diffusion_speedrun_tpu_torch.train import __main__ as cli
from video_diffusion_speedrun_tpu_torch.train.loss import rectified_flow_loss

POLICIES = ("nothing", "dots", "attn", "dots_attn")
TINY = dict(in_channels=4, patch_size=2, time_patch_size=2, hidden_size=64,
            depth=2, num_heads=2, mlp_ratio=4.0, cross_attn_input_size=32,
            residual_v=True, train_bias_and_rms=True)
# [B, C, T, H, W]: short L = 2·4·4 + 16 = 48; long L = 8·16·16 + 16 = 2064
# (above SHORT_MAX_KV; JAX splits off the 16 registers' columns)
LATENTS = {"short": (2, 4, 4, 8, 8), "long": (1, 4, 16, 32, 32)}
# path → (latent, config flags, ring size)
PATHS = {"short": ("short", {}, 0), "long": ("long", {}, 0),
         "fused_residual": ("short", dict(fused_residual=True), 0),
         "ring": ("short", {}, 2)}
CASES = ([(p, pol) for p in ("short", "long") for pol in POLICIES]
         + [("fused_residual", "dots_attn"), ("ring", "attn"),
            ("ring", "dots_attn")])


def _params(jcfg):
    """`init_dit` with the zero-initialised AdaLN and output layers given
    small random values (else the output is exactly 0)."""
    params = init_dit(jax.random.PRNGKey(0), jcfg, init_std_factor=0.5)
    r = np.random.default_rng(1)
    for path in (("blocks", "adaLN_modulation"), ("final_modulation",),
                 ("final_proj",)):
        leaf = params
        for key in path:
            leaf = leaf[key]
        for name in ("weight", "bias"):
            leaf[name] = jnp.asarray(
                r.normal(size=leaf[name].shape).astype(np.float32) * 0.05)
    return params


def _data(latent):
    r = np.random.default_rng(2)
    b = latent[0]
    return dict(latent=r.normal(size=latent).astype(np.float32),
                context=(r.normal(size=(b, 7, 32)) * 0.5).astype(np.float32),
                timesteps=r.uniform(0.1, 0.9, b).astype(np.float32),
                noise=r.normal(size=latent).astype(np.float32),
                rope_offsets=np.asarray([1, 2, 3], np.int32))


def _model(params, **flags):
    """The port's DiT on the JAX weights: the fused ops' twins in fp32,
    with `flags` over those."""
    cfg = TCfg(**{**TINY, "attention_impl": "fused", "fused_adaln": "fused",
                  "compute_dtype": torch.float32, **flags})
    model = DiT(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(
        jax.tree.map(np.asarray, params), cfg), strict=True)
    return model


def _port(model, data, ring=None):
    """The port's loss and gradients (name → numpy; None where the
    parameter got none)."""
    td = {k: torch.from_numpy(v) for k, v in data.items()}
    loss, _ = rectified_flow_loss(
        model, td["latent"], td["context"], None, caption_dropout=0.0,
        timesteps=td["timesteps"], noise=td["noise"],
        rope_offsets=td["rope_offsets"], context_parallel=ring)
    loss.backward()
    return loss.item(), {n: None if p.grad is None else p.grad.numpy()
                         for n, p in model.named_parameters()}


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("path,policy", CASES)
def test_policy_matches_no_remat_and_jax(path, policy):
    from jax.sharding import NamedSharding

    from video_diffusion_speedrun_tpu.core.config import MeshConfig as JMesh
    from video_diffusion_speedrun_tpu.parallel.mesh import (
        build_mesh,
        token_pspec,
    )

    latent, flags, cp = PATHS[path]
    jflags = dict(fused_adaln="pallas", fused_residual=True) if flags \
        else dict(fused_adaln="off")
    # the Pallas kernels where the policy saves their named outputs; XLA
    # attention (the cheaper program) where it saves none of them
    impl = "pallas" if "attn" in policy else "xla"
    jcfg = JCfg(**TINY, attention_impl=impl, compute_dtype=jnp.float32,
                remat=True, remat_policy=policy, **jflags)
    params = _params(jcfg)
    data = _data(LATENTS[latent])
    tok = None
    if cp:
        mesh = build_mesh(JMesh(replica=1, fsdp=1, context=cp, tensor=1),
                          devices=jax.devices()[:cp])
        tok = NamedSharding(mesh, token_pspec())
    jd = {k: jnp.asarray(v) for k, v in data.items()}

    def loss_fn(p):
        loss, _ = j_loss(p, jcfg, jd["latent"], jd["context"],
                         jax.random.PRNGKey(0), timesteps=jd["timesteps"],
                         noise=jd["noise"], caption_dropout=0.0,
                         rope_offsets=jd["rope_offsets"], token_sharding=tok)
        return loss

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(params)
    ring = LocalRing(cp) if cp else None
    loss, grads = _port(_model(params, remat_policy=policy, **flags), data,
                        ring)
    ref_loss, ref = _port(_model(params, remat=False, **flags), data, ring)

    # C8: block 0's λ never mixes v0, under every policy
    assert grads["blocks.0.lambda_param"] is None
    names = [n for n, g in ref.items() if g is not None]
    assert names == [n for n, g in grads.items() if g is not None]
    flat = np.concatenate([grads[n].ravel() for n in names])
    flat_ref = np.concatenate([ref[n].ravel() for n in names])
    assert abs(loss - ref_loss) <= 1e-6 * abs(ref_loss)
    assert _rel(flat, flat_ref) <= 1e-6
    for n in names:
        assert np.abs(grads[n] - ref[n]).max() <= 1e-6 * max(
            np.abs(ref[n]).max(), 1e-12), n

    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    jgrads = state_dict_from_jax_params(jax.tree.map(np.asarray, want),
                                        _model(params).cfg)
    flat_jax = np.concatenate([jgrads[n].numpy().ravel() for n in names])
    assert _rel(flat, flat_jax) <= 1e-5, _rel(flat, flat_jax)


class _Counts:
    """Calls of the attention forwards (the kernels' wrappers, which run
    their twins here), the ring's merges and shifts."""

    NAMES = ("qkv_rope_flash_forward", "cross_flash_forward",
             "long_attention_forward", "ring_chunk_forward", "online_merge")

    def __init__(self, monkeypatch):
        self.n = dict.fromkeys(self.NAMES + ("shift",), 0)
        for name in self.NAMES:
            monkeypatch.setattr(tfa, name, self._wrap(name,
                                                      getattr(tfa, name)))
        monkeypatch.setattr(LocalRing, "shift", self._wrap(
            "shift", LocalRing.shift))

    def _wrap(self, name, fn):
        def counted(*a, **k):
            self.n[name] += 1
            return fn(*a, **k)
        return counted


# the long path (its twins at L = 2064 are the costly ones) under the two
# mechanisms: the recompute's kernel run again, or replayed
COUNT_CASES = ([(p, pol) for p in ("short", "ring") for pol in POLICIES]
               + [("long", "nothing"), ("long", "attn")])


@pytest.mark.parametrize("path,policy", COUNT_CASES)
def test_attention_forwards_run_once_under_attn_policies(path, policy,
                                                         monkeypatch):
    """One train step's forward + backward: each attention's forward runs
    once per block under "attn"/"dots_attn" (the recompute replays it) and
    twice under "nothing"/"dots"; each backward once either way."""
    latent, _, cp = PATHS[path]
    jcfg = JCfg(**TINY, compute_dtype=jnp.float32)
    params = _params(jcfg)
    model = _model(params, remat_policy=policy)
    counts = _Counts(monkeypatch)
    bwd = {"qkv": 0, "long": 0, "ring": 0}
    for name, key in (("qkv_rope_flash_backward", "qkv"),
                      ("long_attention_backward", "long"),
                      ("ring_chunk_backward", "ring")):
        def counted(*a, _fn=getattr(tfa, name), _key=key, **k):
            bwd[_key] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(tfa, name, counted)
    _port(model, _data(LATENTS[latent]), LocalRing(cp) if cp else None)

    depth = TINY["depth"]
    runs = 1 if policy in ("attn", "dots_attn") else 2  # forward + recompute
    want = dict.fromkeys(_Counts.NAMES + ("shift",), 0)
    want["cross_flash_forward"] = runs * depth
    if path == "short":
        want["qkv_rope_flash_forward"] = runs * depth
        assert bwd == {"qkv": depth, "long": 0, "ring": 0}
    elif path == "long":
        want["long_attention_forward"] = runs * depth
        assert bwd == {"qkv": 0, "long": depth, "ring": 0}
    else:
        # cp² chunk forwards, cp·(cp − 1) merges and cp − 1 shifts a ring
        # forward; the backward ring: cp² chunks and cp shifts
        want["ring_chunk_forward"] = runs * depth * cp * cp
        want["online_merge"] = runs * depth * cp * (cp - 1)
        want["shift"] = (runs * (cp - 1) + cp) * depth
        assert bwd == {"qkv": 0, "long": 0, "ring": depth * cp * cp}
    assert counts.n == want


class _OpCounts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = {"dots": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n["dots"] += 1
        elif func is torch.ops.aten.bmm.default:
            self.n["bmm"] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("impl", ["plain", "fused"])
def test_dots_replays_the_products_with_no_batch_dims(impl):
    """The products run during the backward (its own and the recompute's),
    counted under a dispatch mode entered before it: "dots" and
    "dots_attn" run exactly the mm/addmm of the backward without remat
    (every forward product with no batch dims is replayed from what the
    forward kept), "nothing" those plus the block's forward ones; the
    batched products of the attention (the plain composition, or the
    twins) are recomputed under "dots" as under "nothing"."""
    jcfg = JCfg(**TINY, compute_dtype=jnp.float32)
    params = _params(jcfg)
    data = _data(LATENTS["short"])

    def backward_ops(**flags):
        model = _model(params, attention_impl=impl, **flags)
        td = {k: torch.from_numpy(v) for k, v in data.items()}
        loss, _ = rectified_flow_loss(
            model, td["latent"], td["context"], None, caption_dropout=0.0,
            timesteps=td["timesteps"], noise=td["noise"],
            rope_offsets=td["rope_offsets"])
        with _OpCounts() as ops:
            loss.backward()
        return ops.n

    none = backward_ops(remat=False)
    nothing = backward_ops(remat_policy="nothing")
    dots = backward_ops(remat_policy="dots")
    dots_attn = backward_ops(remat_policy="dots_attn")
    # 8 products a block (modulation, qkv, attn_proj, q_cross, context_kv,
    # cross_proj, fc1, fc2) are recomputed under "nothing" alone
    assert nothing["dots"] - none["dots"] == 8 * TINY["depth"]
    assert dots["dots"] == dots_attn["dots"] == none["dots"]
    assert nothing["bmm"] > none["bmm"] and dots["bmm"] == nothing["bmm"]
    if impl == "fused":  # the kept attention runs no batched product again
        assert dots_attn["bmm"] == none["bmm"]


def _attention_inputs():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 48, 64, generator=g) for _ in range(3))
    return q, k, v


def test_replay_without_a_record_raises():
    _, replay = tfa.keep_attention_contexts()
    q, k, v = _attention_inputs()
    with replay, pytest.raises(RuntimeError, match="no kept output"):
        tfa.cross_flash_attention(q, k, v, 2)


def test_replay_out_of_order_raises():
    keep, replay = tfa.keep_attention_contexts()
    q, k, v = _attention_inputs()
    with keep:
        tfa.cross_flash_attention(q, k, v, 2)
    cos = sin = torch.ones(48, 16)
    with replay, pytest.raises(RuntimeError, match="out of order"):
        tfa.qkv_rope_flash_attention(torch.cat([q, k, v], -1), v, cos, sin, 2)
    with replay, pytest.raises(RuntimeError, match="out of order"):
        tfa.cross_flash_attention(q, k[:, :32], v[:, :32], 2)
    with replay:  # the same call replays, and launches nothing
        o = tfa.cross_flash_attention(q, k, v, 2)
    with keep:
        want = tfa.cross_flash_attention(q, k, v, 2)
    assert torch.equal(o, want)


def test_each_checkpoint_call_replays_its_own_record():
    """Two forwards under "attn" (as grad_accum's microbatches, or a
    re-entered block) backwarded in reverse order: each recompute replays
    the outputs of its own forward."""
    jcfg = JCfg(**TINY, compute_dtype=jnp.float32)
    params = _params(jcfg)
    first, second = _data(LATENTS["short"]), _data(LATENTS["short"])
    second = {k: v[::-1].copy() if k in ("latent", "noise") else v
              for k, v in second.items()}

    def grads(policy, **flags):
        model = _model(params, remat_policy=policy, **flags)
        losses = []
        for data in (first, second):
            td = {k: torch.from_numpy(v) for k, v in data.items()}
            losses.append(rectified_flow_loss(
                model, td["latent"], td["context"], None,
                caption_dropout=0.0, timesteps=td["timesteps"],
                noise=td["noise"], rope_offsets=td["rope_offsets"])[0])
        for loss in reversed(losses):
            loss.backward()
        return [p.grad.clone() for p in model.parameters()
                if p.grad is not None]

    for got, want in zip(grads("attn"), grads("nothing", remat=False)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("policy", POLICIES)
def test_cli_remat_policy_reaches_the_config(policy):
    args = cli.parse_args(["--remat_policy", policy])
    assert cli.build_config(args).model.remat_policy == policy
    assert cli.build_config(cli.parse_args([])).model.remat_policy == \
        "nothing"


def test_config_refuses_an_unknown_policy():
    with pytest.raises(ValueError, match="unknown remat_policy"):
        TCfg(remat_policy="everything")
    with pytest.raises(SystemExit):
        cli.parse_args(["--remat_policy", "everything"])
