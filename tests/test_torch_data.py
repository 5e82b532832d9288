"""The port's synthetic data and one-process batch order against the JAX
package: the same latents row for row (exactly), the same index batches
epoch for epoch, and the collated batch on the device unchanged."""

import numpy as np
import pytest
import torch

from video_diffusion_speedrun_tpu.data.loader import (
    ShardedSampler as JSampler,
)
from video_diffusion_speedrun_tpu.data.loader import (
    default_collate as j_collate,
)
from video_diffusion_speedrun_tpu.data.synthetic import (
    SyntheticLatentDataset as JDataset,
)
from video_diffusion_speedrun_tpu.data.synthetic import (
    synthetic_context as j_context,
)
from video_diffusion_speedrun_tpu_torch.data.loader import (
    DataLoader,
    ShardedSampler,
    default_collate,
    device_batches,
)
from video_diffusion_speedrun_tpu_torch.data.synthetic import (
    SyntheticLatentDataset,
    synthetic_context,
)


@pytest.mark.parametrize("seed", [0, 1])
def test_synthetic_rows_match_jax(seed):
    shape = (16, 5, 8, 8)
    ours, theirs = (cls(num_rows=12, latent_shape=shape, seed=seed)
                    for cls in (SyntheticLatentDataset, JDataset))
    for idx in (0, 5, 11):
        a, b = ours[idx], theirs[idx]
        np.testing.assert_array_equal(a["latent"], b["latent"])
        assert a["caption"] == b["caption"]
    with pytest.raises(IndexError):
        ours[12]
    np.testing.assert_array_equal(
        synthetic_context(np.random.default_rng(3), 2, 4, 8),
        j_context(np.random.default_rng(3), 2, 4, 8))


@pytest.mark.parametrize("shuffle", [True, False])
def test_batch_order_matches_jax(shuffle):
    ours = ShardedSampler(37, 8, seed=4, shuffle=shuffle)
    theirs = JSampler(37, 8, 0, 1, seed=4, shuffle=shuffle)
    for e in range(3):
        np.testing.assert_array_equal(ours.epoch(e), theirs.epoch(e))


def test_collated_batches_reach_the_device_unchanged():
    ds = SyntheticLatentDataset(num_rows=6, latent_shape=(2, 3, 4, 4))
    sampler = ShardedSampler(len(ds), 2, seed=1)
    batches = list(device_batches(iter(DataLoader(ds, sampler,
                                                  num_epochs=2)), "cpu"))
    assert len(batches) == 6  # 3 per epoch, 2 epochs
    want = j_collate([ds[int(i)] for i in sampler.epoch(1)[0]])
    got = batches[3]
    assert isinstance(got["latent"], torch.Tensor)
    np.testing.assert_array_equal(got["latent"].numpy(), want["latent"])
    assert got["caption"] == want["caption"]
    np.testing.assert_array_equal(
        default_collate([ds[0], ds[1]])["latent"],
        np.stack([ds[0]["latent"], ds[1]["latent"]]))
