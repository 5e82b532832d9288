"""The port's precomputed-embedding join and its producer against the JAX
package, on the CPU.

- `PrecomputedEmbeddingJoin` gives JAX's rows and contexts bit for bit on
  the same shards, across shard boundaries: the port keeps the shards'
  fp16 (the Trainer widens it on the device), JAX widens to fp32 on the
  host; widened, the port's rows are JAX's.
- Shards written by the JAX `scripts/precompute_embeddings.py` join in the
  port, and shards of the port's `data/precompute.py` join in JAX: each
  package's join equals the other's on both; the manifests agree.
- Every refusal raises JAX's exception type: split mismatch, the legacy
  `.npz` hint, no manifest, an empty manifest, an uncovered row, a shard's
  row count, the format, a manifest merge of other settings.
- The open-map LRU stays bounded; `latent_shapes` passes through.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from video_diffusion_speedrun_tpu.data import embeddings as jemb
from video_diffusion_speedrun_tpu.data.dataset import (
    LatentDataset as JLatentDataset,
)
from video_diffusion_speedrun_tpu.data.synthetic import (
    SyntheticLatentDataset as JSynthetic,
)
from video_diffusion_speedrun_tpu_torch.data import embeddings as temb
from video_diffusion_speedrun_tpu_torch.data import fixture as tfixture
from video_diffusion_speedrun_tpu_torch.data import precompute as tprecompute
from video_diffusion_speedrun_tpu_torch.data.dataset import LatentDataset
from video_diffusion_speedrun_tpu_torch.data.synthetic import (
    SyntheticLatentDataset,
)

ROOT = Path(__file__).resolve().parent.parent


def _write_shards(path, num_rows, rows_per_shard, tokens=6, dim=8,
                  split="train", seed=0):
    path.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    shards = {}
    for lo in range(0, num_rows, rows_per_shard):
        n = min(rows_per_shard, num_rows - lo)
        np.save(path / f"shard_{lo:09d}.npy",
                rng.standard_normal((n, tokens, dim)).astype(np.float16))
        shards[lo] = n
    temb.write_manifest(str(path), split, -8, shards)


def _check_joins_equal(port, jax_join, rows):
    for idx in rows:
        a, b = port[idx], jax_join[idx]
        assert a["context"].dtype == torch.float16
        assert b["context"].dtype == np.float32
        np.testing.assert_array_equal(a["context"].float().numpy(),
                                      b["context"])
        np.testing.assert_array_equal(np.asarray(a["latent"]),
                                      np.asarray(b["latent"]))
        assert a["caption"] == b["caption"]


def test_join_matches_jax(tmp_path):
    _write_shards(tmp_path, 10, 4)
    port = temb.PrecomputedEmbeddingJoin(
        SyntheticLatentDataset(num_rows=10, latent_shape=(2, 2, 4, 4)),
        str(tmp_path), expected_split="train")
    theirs = jemb.PrecomputedEmbeddingJoin(
        JSynthetic(num_rows=10, latent_shape=(2, 2, 4, 4)), str(tmp_path),
        expected_split="train")
    assert len(port) == len(theirs) == 10
    _check_joins_equal(port, theirs, range(10))
    raw = np.load(tmp_path / "shard_000000008.npy")
    np.testing.assert_array_equal(port[9]["context"].numpy(), raw[1])


def _jax_precompute(argv):
    spec = importlib.util.spec_from_file_location(
        "precompute_embeddings", ROOT / "scripts" / "precompute_embeddings.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    res = CliRunner().invoke(mod.main, argv, catch_exceptions=False)
    assert res.exit_code == 0, res.output


def test_shards_of_either_package_join_in_the_other(tmp_path):
    """Both producers on one parquet fixture (tiny random T5s, hidden
    state −1), then both joins on both producers' shards."""
    fx = str(tmp_path / "fixture.parquet")
    tfixture.write_fixture(fx, rows=96, frames=(2,), height=8, width=8)
    cache = str(tmp_path / "cache")
    common = ["--split", "test", "--hf_name", fx, "--smoke_encoder",
              "--return_index", "-1", "--rows_per_shard", "16",
              "--batch_size", "8", "--cache_dir", cache]
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    paths = tprecompute.main(common + ["--out", str(port_dir), "--device",
                                       "cpu"])
    assert [Path(p).name for p in paths] == [
        "shard_000000000.npy", "shard_000000016.npy", "shard_000000032.npy"]
    _jax_precompute(common + ["--out", str(jax_dir)])
    manifests = [json.loads((d / "manifest.json").read_text())
                 for d in (port_dir, jax_dir)]
    assert manifests[0] == manifests[1] == {
        "format": 1, "split": "test", "return_index": -1,
        "shards": {"0": 16, "16": 16, "32": 8}}
    emb = np.load(port_dir / "shard_000000000.npy")
    assert emb.dtype == np.float16 and emb.shape == (16, 512, 64)
    port_rows = LatentDataset("test", cache, fx)
    jax_rows = JLatentDataset("test", cache, fx)
    for d in (port_dir, jax_dir):
        port = temb.PrecomputedEmbeddingJoin(port_rows, str(d), "test")
        theirs = jemb.PrecomputedEmbeddingJoin(jax_rows, str(d), "test")
        for idx in (0, 15, 16, 39):
            a, b = port[idx], theirs[idx]
            np.testing.assert_array_equal(a["context"].float().numpy(),
                                          b["context"])
            assert a["caption"] == b["caption"]


def _legacy(path):
    path.mkdir()
    np.savez(path / "shard_000000000.npz", emb=np.zeros(1))


def _bad_format(path):
    _write_shards(path, 4, 4)
    m = json.loads((path / "manifest.json").read_text())
    m["format"] = 2
    (path / "manifest.json").write_text(json.dumps(m))


def _no_shards(path):
    path.mkdir()
    temb.write_manifest(str(path), "train", -8, {})


def _short_shard(path):
    _write_shards(path, 4, 4)
    np.save(path / "shard_000000000.npy", np.zeros((3, 6, 8), np.float16))


@pytest.mark.parametrize("case,setup,split,row,error", [
    ("split mismatch", lambda p: _write_shards(p, 4, 4, split="test"),
     "train", None, ValueError),
    ("legacy npz", _legacy, "train", None, FileNotFoundError),
    ("no manifest", lambda p: p.mkdir(), "train", None, FileNotFoundError),
    ("format", _bad_format, "train", None, ValueError),
    ("no shards", _no_shards, "train", None, FileNotFoundError),
    ("uncovered row", lambda p: _write_shards(p, 4, 4), "train", 5,
     KeyError),
    ("row count", _short_shard, "train", 0, ValueError),
])
def test_refusals_match_jax(tmp_path, case, setup, split, row, error):
    path = tmp_path / "emb"
    setup(path)
    for module, base in ((jemb, JSynthetic(num_rows=8,
                                           latent_shape=(2, 2, 4, 4))),
                         (temb, SyntheticLatentDataset(
                             num_rows=8, latent_shape=(2, 2, 4, 4)))):
        with pytest.raises(error) as info:
            join = module.PrecomputedEmbeddingJoin(base, str(path), split)
            join[row]
        if case == "legacy npz":
            assert "legacy" in str(info.value)


def test_manifest_merge_refuses_other_settings(tmp_path):
    for module in (jemb, temb):
        path = tmp_path / module.__name__
        path.mkdir()
        module.write_manifest(str(path), "train", -8, {0: 4})
        merged = module.write_manifest(str(path), "train", -8, {4: 4})
        assert merged["shards"] == {"0": 4, "4": 4}
        with pytest.raises(ValueError, match="return_index"):
            module.write_manifest(str(path), "train", -1, {8: 4})


def test_lru_and_latent_shapes(tmp_path):
    _write_shards(tmp_path, 12, 2)
    base = SyntheticLatentDataset(num_rows=12, latent_shape=(2, 2, 4, 4),
                                  t_choices=(2, 3))
    join = temb.PrecomputedEmbeddingJoin(base, str(tmp_path),
                                         cache_shards=2)
    for idx in range(12):
        join[idx]
    assert len(join._cache) == 2
    assert join.latent_shapes() == base.latent_shapes()
    assert temb.PrecomputedEmbeddingJoin(
        {0: {}}, str(tmp_path)).latent_shapes() is None
