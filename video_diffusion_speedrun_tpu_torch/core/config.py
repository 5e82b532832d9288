"""Configuration dataclasses (port of `video_diffusion_speedrun_tpu/core/config.py`).

The model, sampler, data, optimizer, mesh and training configs. Dtypes
are torch dtypes.

Kernel dispatch (`attention_impl`, `fused_adaln`):
  "fused" — the port's fused op: on a CUDA tensor it launches the hand-written
            kernel, on a CPU tensor it runs the op's plain twin;
  "auto"  — "fused" for CUDA tensors (attention: only those the kernels
            take, bf16 with head_dim 64 or 128), the unfused composition
            elsewhere;
  "plain" (attention) / "off" (AdaLN) — the unfused composition.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch


@dataclass(frozen=True)
class DiTConfig:
    """Video DiT architecture config (fields as in the JAX `DiTConfig`)."""

    in_channels: int = 16
    patch_size: int = 2
    time_patch_size: int = 2
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    # None disables cross attention entirely
    cross_attn_input_size: Optional[int] = 4096
    residual_v: bool = False
    # gates trainable RMSNorm scales AND q/kv biases (one flag for both)
    train_bias_and_rms: bool = True
    use_rope: bool = True
    num_registers: int = 16

    rope_base: float = 100.0
    rope_max_t: int = 128
    rope_max_h: int = 128
    rope_max_w: int = 128
    # "matched": RoPE positions flattened (h, w, t), the patchify token order;
    # "reference": flattened (t, h, w), the original model's quirk
    rope_order: str = "matched"
    max_tokens_no_rope: int = 2048

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    attention_impl: str = "auto"  # auto | fused | plain
    fused_adaln: str = "auto"  # auto | fused | off
    # fuse each residual join with the next sub-layer's norm prologue
    # (`gated_residual_adaln`); acts only where the fused AdaLN does. Off by
    # default, as in JAX, where it is net-slower on the canonical config
    fused_residual: bool = False
    # recompute each block in the backward (torch.utils.checkpoint), the
    # JAX `jax.checkpoint`; sampling (no grad) skips it. What the recompute
    # may reuse (`models/dit.py:remat_context_fn`): "nothing"; "dots" the
    # outputs of the products with no batch dims (the linear layers); "attn"
    # the attention kernels' o and lse, so no attention forward runs again
    # (the long-context policy); "dots_attn" both
    remat: bool = True
    remat_policy: str = "nothing"  # nothing | dots | attn | dots_attn

    def __post_init__(self):
        if self.hidden_size % self.num_heads != 0:
            raise ValueError("hidden_size must be divisible by num_heads")
        if self.head_dim % 4 != 0:
            raise ValueError("head_dim must be divisible by 4 for 3D RoPE")
        if self.rope_order not in ("matched", "reference"):
            raise ValueError(f"unknown rope_order: {self.rope_order}")
        if self.attention_impl not in ("auto", "fused", "plain"):
            raise ValueError(f"unknown attention_impl: {self.attention_impl}")
        if self.fused_adaln not in ("auto", "fused", "off"):
            raise ValueError(f"unknown fused_adaln: {self.fused_adaln}")
        if self.remat_policy not in ("nothing", "dots", "attn", "dots_attn"):
            raise ValueError(f"unknown remat_policy: {self.remat_policy}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def out_channels(self) -> int:
        return self.in_channels

    @property
    def mlp_hidden(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    @property
    def patch_dim(self) -> int:
        """Flattened input-patch feature size, (c, pt, p, p) order."""
        return (self.in_channels * self.time_patch_size * self.patch_size
                * self.patch_size)

    @property
    def out_patch_dim(self) -> int:
        """Flattened output-patch feature size, (p1, p2, p3, c) order."""
        return (self.patch_size * self.patch_size * self.time_patch_size
                * self.out_channels)

    def replace(self, **kw) -> "DiTConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class HunyuanVideoConfig:
    """HunyuanVideo's MM-DiT (`HYVideo-T/2-cfgdistill` of Tencent's
    `hyvideo/modules/models.py`, `HUNYUAN_VIDEO_CONFIG`): dual-stream
    blocks (video and text each with their own weights, one joint
    attention) followed by single-stream parallel blocks over [video; text],
    a token refiner over the LLM text states, and a conditioning vector of
    the timestep, the CLIP-pooled text and the embedded guidance scale.
    Field names as in the published constructor."""

    hidden_size: int = 3072
    heads_num: int = 24
    mlp_width_ratio: float = 4.0
    mm_double_blocks_depth: int = 20
    mm_single_blocks_depth: int = 40
    # RoPE dims of the (t, h, w) axes; they sum to the head dim
    rope_dim_list: tuple = (16, 56, 56)
    rope_theta: float = 256.0
    patch_size: tuple = (1, 2, 2)
    in_channels: int = 16
    out_channels: int = 16
    qkv_bias: bool = True
    # per-head RMSNorm of q and k (affine), eps 1e-6
    qk_norm: bool = True
    qk_norm_type: str = "rms"
    mlp_act_type: str = "gelu_tanh"
    # the LLM text states and the CLIP-pooled vector
    text_states_dim: int = 4096
    text_states_dim_2: int = 768
    text_len: int = 256
    # the token refiner: SiLU MLP, LayerNorm with affine, no qk-norm
    refiner_depth: int = 2
    guidance_embed: bool = True
    # sinusoidal width of the timestep and guidance embedders
    frequency_embedding_size: int = 256

    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.hidden_size % self.heads_num != 0:
            raise ValueError("hidden_size must be divisible by heads_num")
        if sum(self.rope_dim_list) != self.head_dim:
            raise ValueError(f"rope_dim_list {self.rope_dim_list} must sum "
                             f"to the head dim {self.head_dim}")
        if (self.qkv_bias, self.qk_norm, self.qk_norm_type,
                self.mlp_act_type) != (True, True, "rms", "gelu_tanh"):
            raise ValueError("the port runs the published qkv_bias, "
                             "qk_norm 'rms' and mlp_act_type 'gelu_tanh'")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.heads_num

    @property
    def mlp_hidden(self) -> int:
        return int(self.hidden_size * self.mlp_width_ratio)

    @property
    def patch_dim(self) -> int:
        pt, ph, pw = self.patch_size
        return self.in_channels * pt * ph * pw

    @property
    def out_patch_dim(self) -> int:
        pt, ph, pw = self.patch_size
        return self.out_channels * pt * ph * pw

    def replace(self, **kw) -> "HunyuanVideoConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class SamplingConfig:
    """Euler+CFG sampler config."""

    inference_steps: int = 50
    cfg_scale: float = 6.0
    height: int = 512
    width: int = 512
    num_latent_frames: int = 16
    seed: int = 42
    time_shift_alpha: float = 8.0


@dataclass(frozen=True)
class DataConfig:
    """Dataset and loader config (the JAX `DataConfig`)."""

    dataset: str = "synthetic"  # synthetic | cosmos_openvid
    # a hub dataset, or a local parquet of its columns (data/fixture.py)
    hf_name: str = "fal/cosmos-openvid-1m"
    cache_dir: str = "./cache"
    # the hub dataset's pinned row count (data/dataset.py splits it)
    total_rows: int = 1_979_810
    test_rows: int = 40
    # threads reading rows, and batches read ahead of the step
    num_workers: int = 8
    prefetch: int = 2
    shuffle_seed: int = 0
    synthetic_rows: int = 4096
    # [C, T, H, W]: Cosmos CV4x8x8 latents of 17-frame 256px clips
    synthetic_shape: tuple = (16, 5, 32, 32)
    # variable-length clips: the T values mixed into the synthetic train
    # split (e.g. (5, 9, 17) ≈ 17/33/65-frame clips); needs bucket_by_shape
    synthetic_t_choices: tuple = ()
    # group rows by latent shape so mixed-length clips form uniform batches
    bucket_by_shape: bool = False
    caption_tokens: int = 512
    context_dim: int = 4096
    # a real dataset with no precomputed embeddings and no prompt encoder
    # trains on random stand-in context only when this is set (smoke runs)
    allow_random_context: bool = False
    # shard_*.npy + manifest.json from data/precompute.py, one subdir per
    # split (or flat): rows arrive with their `context`, no T5 runs
    embeddings_dir: Optional[str] = None


@dataclass(frozen=True)
class OptimizerConfig:
    """muP AdamW config (fields as in the JAX `OptimizerConfig`)."""

    learning_rate: float = 1e-4
    weight_decay: float = 1e-1
    beta1: float = 0.95
    beta2: float = 0.99
    eps: float = 1e-8
    no_decay_lr_mult: float = 0.01
    # Adam moment storage: None = the parameter dtype (fp32), or
    # torch.bfloat16; the moment math is fp32 either way
    moments_dtype: Optional[torch.dtype] = None
    # optimizer-in-backward (`train/inloop.py`): each block's update runs
    # in the reverse walk over the blocks, right after its gradients
    in_backward: bool = False
    # with in_backward: block weights of at least nu_factored_min_size
    # elements (counted over all blocks, as JAX's stacked leaf) keep a
    # rank-1 second moment (Adafactor's factored ν, momentum exact); the
    # standard step ignores it, as JAX's does
    nu_factored: bool = False
    nu_factored_min_size: int = 1 << 20
    constant_param_classes: tuple = ("patch_proj", "context_kv",
                                     "positional_embedding")
    time_modulation_lr_mult: float = 0.1
    mup_base_width: int = 32
    mup_wd_width: int = 1024
    scheduler: str = "cosine"  # cosine | linear | constant
    warmup_steps: int = 20

    def __post_init__(self):
        if self.moments_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"moments_dtype must be None, fp32 or bf16, got "
                             f"{self.moments_dtype}")


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh axes (the JAX `MeshConfig`, `core/config.py:123-165`):
    replica — pure data-parallel replicas; fsdp — parameter sharding;
    context — the token axis split over a ring (context parallelism);
    tensor — heads / MLP hidden. Their product must equal the number of
    processes; -1 for at most one axis takes the rest."""

    replica: int = 1
    fsdp: int = -1
    context: int = 1
    tensor: int = 1

    def __post_init__(self):
        for axis in ("replica", "fsdp", "context", "tensor"):
            size = getattr(self, axis)
            if size == 0 or size < -1:
                raise ValueError(f"mesh axis {axis} has size {size}")

    def resolve(self, n_devices: int) -> "MeshConfig":
        """Sizes with the -1 axis filled in; raises when they do not
        multiply to `n_devices`."""
        sizes = {"replica": self.replica, "fsdp": self.fsdp,
                 "context": self.context, "tensor": self.tensor}
        unknown = [k for k, v in sizes.items() if v == -1]
        if len(unknown) > 1:
            raise ValueError("at most one mesh axis may be -1")
        if unknown:
            known = 1
            for v in sizes.values():
                if v != -1:
                    known *= v
            if n_devices % known != 0:
                raise ValueError(
                    f"cannot infer {unknown[0]}: {n_devices} devices not "
                    f"divisible by {known}")
            sizes[unknown[0]] = n_devices // known
        total = (sizes["replica"] * sizes["fsdp"] * sizes["context"]
                 * sizes["tensor"])
        if total != n_devices:
            raise ValueError(
                f"mesh {sizes} = {total} devices != available {n_devices}")
        return MeshConfig(**sizes)


@dataclass(frozen=True)
class TrainConfig:
    """Training config: the fields of the JAX `TrainConfig` that the port
    has (all but `distributed`: `torchrun`'s environment starts the process
    group)."""

    model: DiTConfig = field(default_factory=DiTConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    num_epochs: int = 2
    batch_size: int = 64
    grad_accum: int = 1
    max_steps: int = 10_000
    evaluate_every: int = 20
    eval_batches: int = 9
    run_name: str = "diffusion_repa"
    project_name: str = "test_diffusion_test"
    seed: int = 0
    init_std_factor: float = 0.1
    time_shift_alpha: float = 8.0
    caption_dropout: float = 0.01
    # T5 hidden-state index of the captions' context (sampling uses -1)
    t5_return_index: int = -8
    # a port checkpoint (run root or step dir) to resume, or a reference
    # checkpoint (.pt or DCP dir) whose weights to start from
    load_checkpoint: Optional[str] = None
    # checkpoints go to checkpoint_dir/run_name/<step>/
    checkpoint_dir: str = "checkpoints"
    log_every: int = 10
    # metrics go to checkpoint_dir/run_name/metrics.jsonl, and to wandb
    wandb: bool = False
    # write step 0's latent, context and timesteps to test_data/
    capture_fixtures: bool = False
    log_grad_norm: bool = False

    def __post_init__(self):
        if self.batch_size % self.grad_accum:
            raise ValueError(f"batch_size {self.batch_size} is not a multiple "
                             f"of grad_accum {self.grad_accum}")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. A CUDA device with no card present
    raises here instead of failing later inside an allocation."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return device
