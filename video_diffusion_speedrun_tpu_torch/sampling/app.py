"""Streamlit demo of the text-to-video request (port of `sampling/app.py`).

    streamlit run video_diffusion_speedrun_tpu_torch/sampling/app.py

`streamlit` is optional and imported only inside the functions that use
it; `python -m video_diffusion_speedrun_tpu_torch.sample` is the headless
equivalent. The demo DiT (width 2048, depth 24) runs on the card.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from video_diffusion_speedrun_tpu_torch.core.config import (  # noqa: E402
    DiTConfig,
    SamplingConfig,
)
from video_diffusion_speedrun_tpu_torch.models.cosmos_vae import (  # noqa: E402
    CosmosDecoder,
    CosmosDecoderConfig,
    load_decoder_params,
)
from video_diffusion_speedrun_tpu_torch.sample import (  # noqa: E402
    demo_config,
    load_dit,
)
from video_diffusion_speedrun_tpu_torch.sampling.decode import (  # noqa: E402
    save_latents_to_video,
)
from video_diffusion_speedrun_tpu_torch.sampling.euler import (  # noqa: E402
    generate_latents,
)
from video_diffusion_speedrun_tpu_torch.train.checkpoint import (  # noqa: E402
    is_torch_reference_checkpoint,
)


def init_models(ckpt: str, dec_npz: str, device="cuda",
                model_cfg: Optional[DiTConfig] = None,
                decoder_cfg: Optional[CosmosDecoderConfig] = None):
    """(model, encoder, decoder) of the demo: the DiT with the checkpoint's
    weights (a port or reference checkpoint; random without one), the
    local T5 when a checkpoint is given, and the Cosmos decoder with the
    `.npz` weights (random, with a warning in the page, without).
    `model_cfg` defaults to the demo DiT with the checkpoint's RoPE
    order."""
    import streamlit as st

    if model_cfg is None:
        reference = bool(ckpt) and is_torch_reference_checkpoint(ckpt)
        model_cfg = demo_config(2048, 24, 128, 4096,
                                "reference" if reference else "matched")
    model = load_dit(ckpt or None, model_cfg, device)
    encoder = None
    if ckpt:
        from video_diffusion_speedrun_tpu_torch.text.encoder import (
            load_encoder,
        )

        encoder = load_encoder(device=device)
    decoder_cfg = decoder_cfg or CosmosDecoderConfig()
    decoder = CosmosDecoder(decoder_cfg, device=device, seed=2)
    if dec_npz:
        decoder.load_state_dict(load_decoder_params(dec_npz, decoder_cfg))
    else:
        st.warning("No Cosmos decoder weights given — decoding with RANDOM "
                   "weights; the output video will be noise.")
    return model, encoder, decoder


def generate(models, prompt: str, sampling: SamplingConfig,
             output: str = "./output", name: str = "test") -> str:
    """One request with `init_models`' models; returns the written path."""
    model, encoder, decoder = models
    device = next(model.parameters()).device
    if encoder is not None:
        context = encoder([prompt], return_index=-1)
    else:
        gen = torch.Generator(device=device).manual_seed(1)
        context = torch.randn(1, 512, model.cfg.cross_attn_input_size,
                              generator=gen, device=device
                              ).to(torch.bfloat16) * 0.05
    latents = generate_latents(model, context, sampling)
    return save_latents_to_video(latents[0].to(torch.bfloat16), decoder,
                                 output, name)


def main():
    import streamlit as st

    st.title("Video DiT Generation (H100)")
    st.sidebar.header("Generation Settings")
    inference_steps = st.sidebar.slider("Inference Steps", 10, 100, 50)
    cfg_scale = st.sidebar.slider("CFG Scale", 1.0, 20.0, 6.0)
    seed = st.sidebar.number_input("Seed", 0, 1000000, 42)
    height = st.sidebar.number_input("Height", 128, 1024, 512)
    width = st.sidebar.number_input("Width", 128, 1024, 512)
    checkpoint = st.sidebar.text_input("Checkpoint path", "")
    decoder_weights = st.sidebar.text_input(
        "Cosmos decoder weights (.npz)", "",
        help="converted with scripts/convert_cosmos.py; empty = random "
             "weights (output is noise)")
    prompt = st.text_area("Enter your prompt:", height=100)
    if st.button("Generate"):
        if not prompt:
            st.warning("Please enter a prompt.")
            return
        with st.spinner("Generating..."):
            models = st.cache_resource(init_models)(checkpoint,
                                                    decoder_weights)
            sampling = SamplingConfig(
                inference_steps=inference_steps, cfg_scale=cfg_scale,
                height=int(height), width=int(width), seed=int(seed))
            out = generate(models, prompt, sampling)
        if out.endswith(".mp4"):
            st.video(out)
        else:
            st.write(f"wrote frames to {out}")


if __name__ == "__main__":
    main()
