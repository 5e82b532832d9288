"""The port's dataset rows against the JAX package, on the CPU.

- `load_tensor` on torch.save blobs of fp32, bf16 and fp16 tensors (a
  non-contiguous one among them) gives JAX's values bit for bit; a blob of
  anything but one tensor raises JAX's ValueError.
- The port's `data/fixture.py` and the JAX `scripts/make_data_fixture.py`
  write the same rows for one seed; `LatentDataset` on one parquet fixture
  has JAX's split sizes and JAX's rows (latents bit for bit, captions).
- The refusals (unknown split, empty split, a hub dataset whose row count
  is not the pinned one) raise JAX's exception types.
"""

import importlib.util
import io
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from video_diffusion_speedrun_tpu.data import dataset as jdataset
from video_diffusion_speedrun_tpu.data.serialization import (
    load_tensor as j_load_tensor,
)
from video_diffusion_speedrun_tpu_torch.data import dataset as tdataset
from video_diffusion_speedrun_tpu_torch.data import fixture as tfixture
from video_diffusion_speedrun_tpu_torch.data.serialization import (
    load_object,
    load_tensor,
)

ROOT = Path(__file__).resolve().parent.parent


def _blob(obj) -> bytes:
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _bits(x) -> np.ndarray:
    """A tensor's or array's raw bits (numpy has no bf16; ml_dtypes does)."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy()
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_load_tensor_matches_jax(dtype):
    gen = torch.Generator().manual_seed(0)
    for t in (torch.randn(16, 5, 8, 8, generator=gen).to(dtype),
              torch.randn(6, 8, generator=gen).to(dtype).t()):
        blob = _blob(t)
        got, want = load_tensor(blob), j_load_tensor(blob)
        assert got.dtype == dtype and got.is_contiguous()
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_load_tensor_refuses_what_jax_refuses():
    blob = _blob({"a": torch.ones(2)})
    with pytest.raises(ValueError, match="single tensor"):
        j_load_tensor(blob)
    with pytest.raises(ValueError, match="single tensor"):
        load_tensor(blob)
    assert torch.equal(load_object(blob)["a"], torch.ones(2))


def _jax_fixture(out, *args):
    spec = importlib.util.spec_from_file_location(
        "make_data_fixture", ROOT / "scripts" / "make_data_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    res = CliRunner().invoke(mod.main, ["--out", str(out), *args],
                             catch_exceptions=False)
    assert res.exit_code == 0, res.output


def test_fixture_and_rows_match_jax(tmp_path):
    """The two fixture writers' rows for one seed (mixed frame counts),
    then `LatentDataset` of both packages on one of them."""
    args = ["--rows", "96", "--frames", "2,3", "--height", "8", "--width",
            "8", "--seed", "3"]
    ours, theirs = tmp_path / "port.parquet", tmp_path / "jax.parquet"
    tfixture.main(["--out", str(ours), *args])
    _jax_fixture(theirs, *args)
    cache = str(tmp_path / "cache")
    sizes = {"train": 8, "test": 40}  # half of 96 = 48, the last 40 test
    for split, n in sizes.items():
        port = tdataset.LatentDataset(split, cache, str(ours))
        jax_own = jdataset.LatentDataset(split, cache, str(theirs))
        jax_ours = jdataset.LatentDataset(split, cache, str(ours))
        assert len(port) == len(jax_own) == len(jax_ours) == n
        for idx in range(n):
            row = port[idx]
            assert row["latent"].dtype == torch.bfloat16
            for want in (jax_own[idx], jax_ours[idx]):
                assert row["caption"] == want["caption"]
                np.testing.assert_array_equal(_bits(row["latent"]),
                                              _bits(want["latent"]))
    assert port[0]["caption"] == "fixture clip 8 (2 latent frames)"
    assert tuple(port[1]["latent"].shape) == (16, 3, 8, 8)


def _fake_hub(monkeypatch, module, rows):
    import datasets

    blobs = [_blob(torch.full((2, 1, 2, 2), float(i), dtype=torch.bfloat16))
             for i in range(rows)]
    table = datasets.Dataset.from_dict(
        {"serialized_latent": blobs,
         "caption": [f"caption {i}" for i in range(rows)]})
    monkeypatch.setattr("datasets.load_dataset",
                        lambda *a, **kw: table)
    monkeypatch.setattr(module.LatentDataset, "TOTAL_ROWS", rows)
    monkeypatch.setattr(module.LatentDataset, "TEST_ROWS", 4)


@pytest.mark.parametrize("case,rows,match", [
    ("hub rows", 198, "198 rows but .* pins 200"),
    ("unknown split", 200, "unknown split"),
    ("empty split", 1, "is empty"), ("hub split", 200, None)])
def test_refusals_match_jax(monkeypatch, tmp_path, case, rows, match):
    """A hub dataset (no local path) keeps the pinned split or refuses;
    an unknown or empty split refuses, each with JAX's exception."""
    for module in (jdataset, tdataset):
        _fake_hub(monkeypatch, module, rows)
        if case == "hub rows":  # 198 rows where 200 are pinned
            monkeypatch.setattr(module.LatentDataset, "TOTAL_ROWS", 200)
    split = "validation" if case == "unknown split" else "train"
    name = "org/not-a-local-path"
    if match is None:
        port = tdataset.LatentDataset(split, str(tmp_path), name)
        jax_ds = jdataset.LatentDataset(split, str(tmp_path), name)
        # the first half of the pinned 200 rows, the last 4 of it test
        assert len(port) == len(jax_ds) == 96
        assert float(port[3]["latent"][0, 0, 0, 0]) == 3.0
        assert port[3]["caption"] == jax_ds[3]["caption"] == "caption 3"
        return
    for module in (jdataset, tdataset):
        with pytest.raises(ValueError, match=match):
            module.LatentDataset(split, str(tmp_path), name)
