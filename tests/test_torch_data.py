"""The port's host data code against the JAX package's, bitwise.

``data/res_buckets.py``, ``data/augmentors.py``, ``data/webdataset.py``,
``data/native_loader.py`` and ``utils/checkpoint_db.py`` are copies of
JAX's (numpy, PIL, tarfile, ctypes): on the same inputs (tar shards and
JPEGs written under ``tmp_path``, seeded arrays) every output must be
bitwise JAX's, and every sample order (shuffled shards, the shuffle buffer,
the distributors) the same. The bound is exact equality throughout.
"""

import dataclasses
import io
import json
import os
import tarfile

import numpy as np
import pytest

from chronoedit_tpu.data import augmentors as aug_j
from chronoedit_tpu.data import native_loader as nl_j
from chronoedit_tpu.data import res_buckets as rb_j
from chronoedit_tpu.data import webdataset as wds_j
from chronoedit_tpu.utils import checkpoint_db as db_j
from chronoedit_tpu_torch.data import augmentors as aug_t
from chronoedit_tpu_torch.data import native_loader as nl_t
from chronoedit_tpu_torch.data import res_buckets as rb_t
from chronoedit_tpu_torch.data import webdataset as wds_t
from chronoedit_tpu_torch.utils import checkpoint_db as db_t


def equal(a, b) -> None:
    """Bitwise equality of two (nested) samples: arrays by value and dtype,
    the rest by ==."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            equal(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _add(tf, name: str, data: bytes) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def _jpeg(arr: np.ndarray, quality: int = 90) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Three tar shards of 4 samples each: a JPEG, a PNG, json, txt and a
    ``.frames.npz`` clip of 7 frames, from a seeded generator."""
    from PIL import Image

    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("torch_shards")
    paths = []
    for s in range(3):
        path = str(root / f"shard-{s:04d}.tar")
        with tarfile.open(path, "w") as tf:
            for i in range(4):
                key = f"s{s}_{i:03d}"
                png = io.BytesIO()
                Image.fromarray(rng.integers(0, 256, (12, 20, 3), dtype=np.uint8)).save(
                    png, format="PNG")
                clip = io.BytesIO()
                np.savez(clip, frames=rng.integers(0, 256, (7, 8, 8, 3), dtype=np.uint8))
                _add(tf, f"{key}.jpg", _jpeg(rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)))
                _add(tf, f"{key}.png", png.getvalue())
                _add(tf, f"{key}.json", json.dumps({"s": s, "i": i}).encode())
                _add(tf, f"{key}.txt", f"caption {s} {i}".encode())
                _add(tf, f"{key}.frames.npz", clip.getvalue())
        paths.append(path)
    return paths


def _take(it, n):
    return [x for x, _ in zip(it, range(n))]


@pytest.mark.parametrize("world,rank,shuffle", [(1, 0, True), (1, 0, False), (2, 1, True),
                                                (4, 3, True)])
def test_shard_distributor_order(shards, world, rank, shuffle):
    """The infinite shard stream (two epochs and more), rank split and
    per-epoch reshuffle, JAX's order exactly (world 4 > 3 shards: the
    lockstep fallback)."""
    for seed in (0, 7):
        want = _take(iter(wds_j.ShardDistributor(shards, world, rank, shuffle, seed)), 9)
        got = _take(iter(wds_t.ShardDistributor(shards, world, rank, shuffle, seed)), 9)
        assert got == want


@pytest.mark.parametrize("shuffle_size", [1, 5])
def test_webdataset_matches_jax(shards, shuffle_size):
    """Grouping by key, the default decoders (images, json, txt, the
    ``.frames.npz`` clip rounded to 4k+1 frames) and the shuffle buffer:
    20 samples (past one epoch of 12) bitwise JAX's, in JAX's order."""
    want = _take(iter(wds_j.WebDataset(shards, shuffle_size=shuffle_size, seed=3)), 20)
    got = _take(iter(wds_t.WebDataset(shards, shuffle_size=shuffle_size, seed=3)), 20)
    equal(got, want)
    assert got[0]["frames.npz"].shape == (3, 5, 8, 8)


def test_batched_and_shuffle_buffer(shards):
    for size, seed in ((1, 0), (10, 1), (64, 2)):
        assert (list(wds_t.shuffle_buffer(range(50), size, seed))
                == list(wds_j.shuffle_buffer(range(50), size, seed)))
    want = _take(wds_j.batched(iter(wds_j.WebDataset(shards, shuffle_size=1)), 3,
                               stack_keys=("jpg", "png")), 3)
    got = _take(wds_t.batched(iter(wds_t.WebDataset(shards, shuffle_size=1)), 3,
                              stack_keys=("jpg", "png")), 3)
    equal(got, want)
    assert got[0]["png"].shape == (3, 3, 12, 20)


def test_tar_samples_grouping(shards):
    want = list(wds_j.tar_samples(iter(shards)))
    got = list(wds_t.tar_samples(iter(shards)))
    equal(got, want)
    assert len(got) == 12 and set(got[0]) == {"__key__", "jpg", "png", "json", "txt",
                                              "frames.npz"}


def test_multi_aspect_distributor_lockstep(tmp_path):
    """Mixed-aspect shards over 4 and 5 ranks: allocation, each rank's
    aspect and shard stream (its slot of its aspect's shards), and each
    rank's first uniform-aspect batch, all JAX's."""
    rng = np.random.default_rng(1)
    shards = {}
    for name, n, (h, w), label in (("wide", 4, (16, 32), "16:9"), ("tall", 2, (32, 16), "9:16"),
                                   ("square", 1, (24, 24), "1:1")):
        for i in range(n):
            p = tmp_path / f"{name}_{i}.tar"
            with tarfile.open(p, "w") as tf:
                for j in range(2):
                    _add(tf, f"{name}{i}_{j}.jpg",
                         _jpeg(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)))
            shards[str(p)] = label
    for world in (4, 5):
        for rank in range(world):
            dj = wds_j.MultiAspectDistributor(shards, world, rank, seed=2)
            dt = wds_t.MultiAspectDistributor(shards, world, rank, seed=2)
            assert (dt.aspect, dt.allocation) == (dj.aspect, dj.allocation)
            assert _take(iter(dt), 7) == _take(iter(dj), 7)
            want = next(wds_j.batched(iter(wds_j.WebDataset(shards, world, rank, shuffle_size=1)),
                                      2, stack_keys=("jpg",)))
            got = next(wds_t.batched(iter(wds_t.WebDataset(shards, world, rank, shuffle_size=1)),
                                     2, stack_keys=("jpg",)))
            equal(got, want)
    with pytest.raises(ValueError):
        wds_t.MultiAspectDistributor(shards, world_size=2, rank=0)


def test_webdataset_streams_remote_shards():
    """Tar shards addressed by URI stream through the port's easy_io (a fake
    S3 client), as through JAX's in ``tests/test_aux_utils.py``."""
    from chronoedit_tpu.utils import easy_io as io_j
    from chronoedit_tpu_torch.utils import easy_io as io_t
    from tests.test_easy_io_callbacks import _FakeS3Client

    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for i in range(3):
            _add(tf, f"s{i:04d}.json", json.dumps({"idx": i}).encode())
            _add(tf, f"s{i:04d}.txt", f"remote {i}".encode())
    uri = "s3://bkt/shards/000000.tar"
    io_j.set_s3_client(_FakeS3Client())
    io_t.set_s3_client(_FakeS3Client())
    try:
        io_j.put(uri, buf.getvalue())
        io_t.put(uri, buf.getvalue())
        want = _take(iter(wds_j.WebDataset([uri], shuffle_size=1)), 5)
        got = _take(iter(wds_t.WebDataset([uri], shuffle_size=1)), 5)
    finally:
        io_j.set_s3_client(None)
        io_t.set_s3_client(None)
    equal(got, want)
    assert [s["json"]["idx"] for s in got] == [0, 1, 2, 0, 1]


def test_video_decoders():
    """``round_to_4k_plus_1`` and ``decode_video`` on a gif and on raw
    frames, including the grayscale clip and the single frame."""
    import imageio.v3 as iio

    rng = np.random.default_rng(2)
    for n in (0, 1, 4, 5, 8, 9, 81):
        assert wds_t.round_to_4k_plus_1(n) == wds_j.round_to_4k_plus_1(n)
    gif = io.BytesIO()
    iio.imwrite(gif, rng.integers(0, 256, (6, 16, 16, 3), dtype=np.uint8), extension=".gif")
    equal(wds_t.decode_video(gif.getvalue(), "gif"), wds_j.decode_video(gif.getvalue(), "gif"))
    for frames in (rng.integers(0, 256, (9, 8, 8), dtype=np.uint8),  # grayscale clip
                   rng.integers(0, 256, (8, 8, 3), dtype=np.uint8),  # one RGB frame
                   rng.integers(0, 256, (7, 8, 8, 1), dtype=np.uint8)):
        buf = io.BytesIO()
        np.savez(buf, frames=frames)
        for num in (None, 3):
            equal(wds_t.decode_video(buf.getvalue(), "frames.npz", num),
                  wds_j.decode_video(buf.getvalue(), "frames.npz", num))


def _pipeline(mod, video: bool):
    """Every augmentor in one chain, on both keys."""
    keys = ("jpg", "png")
    ops = [mod.ResizeSmallestSide(40, keys), mod.RandomCrop(36, 44, keys),
           mod.HorizontalFlip(0.5, keys), mod.PadToMultiple(16, keys),
           mod.Normalize((0.1, 0.2, 0.3), (0.5, 0.6, 0.7), keys)]
    if not video:
        ops = [mod.ResizeToBucket("480p", keys), mod.CenterCrop(300, 400, keys)] + ops
    return mod.Compose(ops)


@pytest.mark.parametrize("video", [False, True])
def test_augmentors_match_jax(video):
    """The augmentor chain on 12 keys (the crc32-of-``__key__`` seeding
    picks crops and flips): bitwise JAX's, images (3, H, W) and clips
    (3, T, H, W)."""
    rng = np.random.default_rng(3)
    shape = (3, 5, 50, 70) if video else (3, 333, 500)
    for i in range(12):
        img = rng.random(shape, dtype=np.float32)
        sample = {"__key__": f"key{i}", "jpg": img, "png": img[::-1].copy()}
        want = _pipeline(aug_j, video)({k: v.copy() if isinstance(v, np.ndarray) else v
                                        for k, v in sample.items()})
        got = _pipeline(aug_t, video)(dict(sample))
        equal(got, want)


def test_res_buckets_and_checkpoint_db(tmp_path):
    assert rb_t.VIDEO_RES_SIZE_INFO == rb_j.VIDEO_RES_SIZE_INFO
    for h, w in ((1080, 1920), (1920, 1080), (500, 500), (333, 500), (720, 960), (17, 4000)):
        for res in ("480p", "720p", "1080p"):
            assert rb_t.nearest_bucket(h, w, res) == rb_j.nearest_bucket(h, w, res)
        for area in (720 * 1280, 480 * 832, 1000):
            assert rb_t.area_matched_size(h, w, area) == rb_j.area_matched_size(h, w, area)
    assert ({k: dataclasses.astuple(v) for k, v in db_t.REGISTRY.items()}
            == {k: dataclasses.astuple(v) for k, v in db_j.REGISTRY.items()})
    entry = db_t.REGISTRY["wan2.1_vae"]
    (tmp_path / entry.relpath).parent.mkdir(parents=True)
    (tmp_path / entry.relpath).write_bytes(b"")
    assert db_t.resolve("wan2.1_vae", str(tmp_path)) == db_j.resolve("wan2.1_vae", str(tmp_path))
    with pytest.raises(KeyError):
        db_t.resolve("nope")
    with pytest.raises(FileNotFoundError, match="hf://"):
        db_t.resolve("umt5_xxl_enc", root=str(tmp_path))


# ------------------------------------------------------------- native loader

@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """Four seeded JPEGs (smooth gradients plus noise), one PNG."""
    from PIL import Image

    rng = np.random.default_rng(4)
    root = tmp_path_factory.mktemp("torch_jpegs")
    g = np.linspace(0, 255, 320)
    paths = []
    for i in range(4):
        arr = np.stack([np.roll(np.tile(g, (241, 1)), i * 30, axis=1)] * 3, -1)
        arr = np.clip(arr + rng.normal(0, 8, arr.shape), 0, 255).astype(np.uint8)
        p = root / f"img{i}.jpg"
        Image.fromarray(arr).save(p, quality=95)
        paths.append(str(p))
    png = root / "img.png"
    Image.fromarray(np.zeros((20, 30, 3), np.uint8) + 77).save(png)
    return paths, str(png)


@pytest.fixture(scope="module")
def native(monkeypatch_module):
    """The port's build of the library (``build/native``), also given to
    JAX's bindings, so that both bind the same file (JAX's own build goes
    into ``native/``, which the port never writes)."""
    if not nl_t.build_native():
        pytest.skip("no C++ toolchain with libjpeg to build native/image_loader.cpp")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert nl_t._BUILD_PATH == os.path.join(repo, "build", "native", "libce_loader.so")
    assert os.path.exists(nl_t._BUILD_PATH) and nl_t._load_lib() is not None
    monkeypatch_module.setattr(nl_j, "_LIB_PATH", nl_t._BUILD_PATH)
    nl_j._load_lib.cache_clear()
    yield
    nl_j._load_lib.cache_clear()


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.mark.parametrize("backend", ["native", "pil"])
def test_decode_batch_matches_jax(native, jpegs, backend):
    """File batches through the C++ decoder (resize-to-cover, centre crop)
    and through PIL, a missing file zero-filled: bitwise JAX's bindings."""
    paths, _ = jpegs
    batch = paths + ["/nonexistent/x.jpg"]
    for h, w in ((128, 160), (96, 96), (241, 320)):
        want = nl_j.decode_image_batch(batch, h, w, force_backend=backend)
        got = nl_t.decode_image_batch(batch, h, w, force_backend=backend)
        equal(got, want)
        assert float(np.abs(got[-1]).max()) == 0.0
    a = nl_t.decode_image_batch(paths, 128, 160, force_backend="native")
    b = nl_t.decode_image_batch(paths, 128, 160, force_backend="pil")
    assert float(np.abs(a - b).mean()) < 0.02  # JAX's resize-kernel tolerance


@pytest.mark.parametrize("backend", ["native", "pil"])
def test_decode_buffers_matches_jax(native, jpegs, backend):
    """In-memory buffers (the webdataset slot), bad bytes zero-filled, and
    ``native_jpeg_decoder`` through a tar shard: bitwise JAX's."""
    paths, _ = jpegs
    buffers = [open(p, "rb").read() for p in paths] + [b"not a jpeg"]
    equal(nl_t.decode_jpeg_buffers(buffers, 64, 80, force_backend=backend),
          nl_j.decode_jpeg_buffers(buffers, 64, 80, force_backend=backend))
    dec_j, dec_t = wds_j.native_jpeg_decoder(48, 64), wds_t.native_jpeg_decoder(48, 64)
    equal(dec_t(buffers[1]), dec_j(buffers[1]))


def test_auto_backend(native, jpegs):
    """JPEG batches go native, a PNG through PIL, as JAX's choose."""
    paths, png = jpegs
    equal(nl_t.decode_image_batch(paths, 32, 32), nl_j.decode_image_batch(paths, 32, 32))
    equal(nl_t.decode_image_batch([png], 16, 16), nl_j.decode_image_batch([png], 16, 16))


def test_failed_build(tmp_path, monkeypatch):
    """A failing compiler leaves no partial file, reports the library
    unavailable, and the native backend then raises."""
    target = tmp_path / "build" / "libce_loader.so"
    monkeypatch.setattr(nl_t, "_BUILD_PATH", str(target))
    monkeypatch.setattr(nl_t, "_LIB_PATHS", (str(target),))
    monkeypatch.setenv("CXX", "false")
    nl_t._load_lib.cache_clear()
    try:
        assert nl_t.build_native() is False
        assert list(target.parent.iterdir()) == []
        assert not nl_t.native_available()
        with pytest.raises(RuntimeError, match="build_native"):
            nl_t.decode_image_batch(["x.jpg"], 8, 8, force_backend="native")
    finally:
        monkeypatch.undo()
        nl_t._load_lib.cache_clear()
