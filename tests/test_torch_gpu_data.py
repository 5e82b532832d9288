"""The loader's device staging, on the card.

Every test here carries the `gpu` marker and skips when no CUDA card is
present. The file imports torch only; on a machine without JAX run it
without the JAX-importing conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_data.py
"""

import time

import numpy as np
import pytest
import torch

from video_diffusion_speedrun_tpu_torch.data import loader as tloader

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _host_batches(n, seed=0):
    gen = torch.Generator().manual_seed(seed)
    for i in range(n):
        yield {"latent": torch.randn(8, 16, 5, 32, 32,
                                     generator=gen).bfloat16(),
               "context": torch.randn(8, 512, 256, generator=gen),
               "noise": np.full((3, 4), i, np.float32),
               "caption": [f"clip {i}"] * 8}


def test_staged_batches_equal_a_synchronous_copy(dev):
    """Pinned, non-blocking copies on the staging stream give the bits of
    a plain `.to(device)`; numpy arrays become tensors; lists pass."""
    got = list(tloader.device_batches(_host_batches(5), dev, depth=2))
    want = list(_host_batches(5))
    assert len(got) == 5
    for a, b in zip(got, want):
        for key in ("latent", "context", "noise"):
            ref = torch.as_tensor(b[key]).to(dev)
            assert a[key].device.type == "cuda"
            assert a[key].dtype == ref.dtype
            assert torch.equal(a[key], ref)
        assert a["caption"] == b["caption"]


def test_staging_overlaps_a_running_kernel(monkeypatch, dev):
    """While a long kernel runs on the consumer's stream, the next batch's
    copy completes on the staging stream (it does not queue behind the
    kernel), and the consumer's stream still orders its reads after it."""
    streams = []
    make = torch.cuda.Stream

    def spy(*args, **kw):
        stream = make(*args, **kw)
        if not kw:  # a new stream; torch wraps existing ones by stream_id
            streams.append(stream)
        return stream

    monkeypatch.setattr(tloader.torch.cuda, "Stream", spy)
    current = torch.cuda.current_stream(dev)
    torch.cuda.synchronize(dev)
    # ~1 s of device time on the consumer's stream
    torch.cuda._sleep(int(2e9))
    stream = tloader.device_batches(_host_batches(2, seed=1), dev, depth=2)
    batch = next(stream)
    (staging,) = streams
    deadline = time.monotonic() + 0.5
    while not staging.query() and time.monotonic() < deadline:
        time.sleep(0.005)
    copied_first = staging.query() and not current.query()
    total = batch["context"].double().sum()  # ordered after the copy
    torch.cuda.synchronize(dev)
    stream.close()
    assert copied_first, "the staged copy waited for the running kernel"
    want = next(_host_batches(1, seed=1))["context"].double().sum()
    assert torch.allclose(total.cpu(), want)
