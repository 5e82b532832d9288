"""The benchmark of the PyTorch and CUDA port
(`video_diffusion_speedrun_tpu_torch`)."""
