"""Tar-shard streaming dataset ("webdataset"-style).

Compact equivalent of the reference's webdataset stack
(``chronoedit/_ext/imaginaire/datasets/webdataset/``, SURVEY §2.6): infinite
shard streams with per-host/per-worker distribution, grouped-by-key sample
assembly from tar members, pluggable decoders/augmentors, and a shuffle
buffer.

Pipeline: shards -> :class:`ShardDistributor` (host/worker split, infinite
shuffle) -> :func:`tar_samples` (group ``key.ext`` members) -> decoders ->
shuffle buffer -> batches.

A copy of ``chronoedit_tpu/data/webdataset.py`` with its imports pointed at
the port (``utils/easy_io.py``, ``data/native_loader.py``): the same seeds
give the same shard and sample order, bit for bit.
"""

from __future__ import annotations

import io
import json
import random
import tarfile
from typing import Any, Callable, Iterable, Iterator

import numpy as np


class ShardDistributor:
    """Infinite, shuffled shard stream, partitioned across hosts/workers."""

    def __init__(self, shards: list[str], world_size: int = 1, rank: int = 0,
                 shuffle: bool = True, seed: int = 0):
        if not shards:
            raise ValueError("no shards")
        self.shards = list(shards)
        self.world_size = world_size
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed

    def __iter__(self) -> Iterator[str]:
        epoch = 0
        while True:
            order = list(self.shards)
            if self.shuffle:
                random.Random(self.seed + epoch).shuffle(order)
            mine = order[self.rank:: self.world_size]
            # keep ranks in lockstep even with uneven splits
            if not mine:
                mine = [order[self.rank % len(order)]]
            yield from mine
            epoch += 1


class MultiAspectDistributor:
    """Aspect-ratio-aware shard distributor
    (distributors/multi_aspect_ratio_v2.py:30-250 equivalent).

    ``shards`` maps each tar path to its aspect label (datasets are
    homogeneous per shard, as upstream assumes per dataset_id). Ranks are
    allocated to aspects proportionally to shard counts with at least one
    rank per aspect (the reference's argmin-discrepancy loop), and each rank
    then streams only its aspect — so every batch a rank assembles is
    uniform-aspect and ranks stay in lockstep across epochs.
    """

    def __init__(self, shards: dict[str, str], world_size: int = 1,
                 rank: int = 0, shuffle: bool = True, seed: int = 0):
        if not shards:
            raise ValueError("no shards")
        by_aspect: dict[str, list[str]] = {}
        for path in sorted(shards):
            by_aspect.setdefault(shards[path], []).append(path)
        aspects = sorted(by_aspect)
        if world_size < len(aspects):
            raise ValueError(
                f"{world_size} ranks < {len(aspects)} aspect ratios — each "
                "rank loads exactly one aspect (collation would fail "
                "otherwise)")

        # proportional allocation, >=1 rank per aspect
        target = np.array([len(by_aspect[a]) for a in aspects], np.float64)
        target /= target.sum()
        alloc = np.ones(len(aspects), np.int64)
        for _ in range(world_size - len(aspects)):
            alloc[np.argmin(alloc / alloc.sum() - target)] += 1

        # this rank's aspect + its slot among that aspect's ranks
        cum = np.cumsum(alloc)
        aidx = int(np.searchsorted(cum, rank, side="right"))
        slot = rank - (int(cum[aidx - 1]) if aidx else 0)
        self.aspect = aspects[aidx]
        mine = by_aspect[self.aspect]
        self._inner = ShardDistributor(
            mine[slot % len(mine)::int(alloc[aidx])] or
            [mine[slot % len(mine)]],
            shuffle=shuffle, seed=seed + rank)
        self.allocation = dict(zip(aspects, alloc.tolist()))

    def __iter__(self) -> Iterator[str]:
        return iter(self._inner)


def _open_shard(shard: str):
    """Local paths stream straight off disk; URI shards (s3://, http://)
    stream through easy_io.open_stream — sequential bytes feed the tar
    reader as it consumes them, so a multi-GB remote shard never has to sit
    in host RAM at once (the reference's remote-tar path)."""
    if "://" in shard:
        from chronoedit_tpu_torch.utils import easy_io

        return easy_io.open_stream(shard)
    return open(shard, "rb")


def tar_samples(shard_stream: Iterable[str]) -> Iterator[dict[str, bytes]]:
    """Group tar members into samples by basename key: ``abc.jpg`` +
    ``abc.json`` + ``abc.txt`` -> {"__key__": "abc", "jpg": ..., ...}."""
    for shard in shard_stream:
        with tarfile.open(fileobj=_open_shard(shard), mode="r|*") as tf:
            current_key = None
            sample: dict[str, Any] = {}
            for member in tf:
                if not member.isfile():
                    continue
                name = member.name
                key, _, ext = name.partition(".")
                if key != current_key:
                    if sample:
                        yield sample
                    current_key = key
                    sample = {"__key__": key}
                sample[ext.lower()] = tf.extractfile(member).read()
            if sample:
                yield sample


# ------------------------------------------------------------- decoders

def decode_image(data: bytes) -> np.ndarray:
    """JPEG/PNG bytes -> (3, H, W) float32 in [-1, 1]."""
    from PIL import Image

    img = Image.open(io.BytesIO(data)).convert("RGB")
    return np.asarray(img, np.float32).transpose(2, 0, 1) / 127.5 - 1.0


def native_jpeg_decoder(target_h: int, target_w: int,
                        num_threads: int = 0) -> Callable[[bytes], np.ndarray]:
    """Decoder for ``jpg`` members that decodes + resizes-to-cover +
    center-crops straight to the training bucket size on the C++ thread pool
    (``native/image_loader.cpp`` ``ce_decode_jpeg_buffers`` — GIL-free, with
    DCT-domain downscale). Use when samples go directly to a fixed
    resolution::

        h, w = VIDEO_RES_SIZE_INFO["720"]["16,9"]
        ds = WebDataset(shards, decoders={"jpg": native_jpeg_decoder(h, w)})

    Falls back to PIL when the shared library isn't built.
    """
    from chronoedit_tpu_torch.data.native_loader import decode_jpeg_buffers

    def decode(data: bytes) -> np.ndarray:
        return decode_jpeg_buffers([data], target_h, target_w,
                                   num_threads=num_threads)[0]

    return decode


def decode_json(data: bytes) -> Any:
    return json.loads(data.decode("utf-8"))


def decode_text(data: bytes) -> str:
    return data.decode("utf-8")


def round_to_4k_plus_1(n: int) -> int:
    """Largest frame count <= n of the form 4k+1 (the VAE's temporal factor;
    unified_dataset.py LoadVideo rounding)."""
    return max(1, (max(n, 1) - 1) // 4 * 4 + 1)


def decode_video(data: bytes, ext: str = "mp4",
                 num_frames: int | None = None) -> np.ndarray:
    """Video bytes -> (3, T, H, W) float32 in [-1, 1], T rounded to 4k+1.

    Decoder registry equivalent of the reference's decord-based
    video_decoder (_ext/common/datasets/decoders/video_decoder.py):
    imageio handles the container (gif works via Pillow everywhere; mp4/
    webm/mov need an ffmpeg/pyav imageio plugin at runtime — the hot
    path stays identical, only the codec backend differs). ``.frames.npz``
    members ({"frames": (T,H,W,3) uint8}) bypass codecs entirely.
    """
    if ext == "frames.npz":
        frames = np.load(io.BytesIO(data))["frames"]
    else:
        import imageio.v3 as iio

        try:
            frames = iio.imread(data, extension=f".{ext}")
        except Exception as e:  # pragma: no cover - codec-less images
            raise RuntimeError(
                f"no codec available for .{ext} video members (install an "
                "imageio ffmpeg/pyav plugin, or repack shards with "
                ".frames.npz raw-frame members)") from e
    # normalize to (T, H, W, C): distinguish a single (H, W, C) frame from a
    # grayscale (T, H, W) clip by whether the trailing dim is channel-sized —
    # ndim alone is ambiguous (round-2 review: a gray clip was being
    # reinterpreted as one RGB frame and silently garbled)
    if frames.ndim == 2:  # single grayscale frame
        frames = frames[None, ..., None]
    elif frames.ndim == 3:
        frames = frames[None] if frames.shape[-1] in (1, 3, 4) else frames[..., None]
    if frames.shape[-1] == 1:
        frames = np.repeat(frames, 3, axis=-1)
    t = round_to_4k_plus_1(num_frames or frames.shape[0])
    frames = frames[:t, ..., :3]
    return frames.transpose(3, 0, 1, 2).astype(np.float32) / 127.5 - 1.0


DEFAULT_DECODERS: dict[str, Callable[[bytes], Any]] = {
    "jpg": decode_image, "jpeg": decode_image, "png": decode_image,
    "webp": decode_image,
    "json": decode_json, "txt": decode_text,
    "npy": lambda b: np.load(io.BytesIO(b)),
    "mp4": lambda b: decode_video(b, "mp4"),
    "webm": lambda b: decode_video(b, "webm"),
    "mov": lambda b: decode_video(b, "mov"),
    "gif": lambda b: decode_video(b, "gif"),
    "frames.npz": lambda b: decode_video(b, "frames.npz"),
}


def decode_samples(samples: Iterable[dict], decoders=None) -> Iterator[dict]:
    decoders = {**DEFAULT_DECODERS, **(decoders or {})}
    for s in samples:
        out = {}
        for k, v in s.items():
            fn = decoders.get(k)
            out[k] = fn(v) if fn else v
        yield out


def shuffle_buffer(samples: Iterable, size: int = 100, seed: int = 0) -> Iterator:
    """Bounded reservoir shuffle (webdataset detshuffle equivalent)."""
    rng = random.Random(seed)
    buf: list = []
    for s in samples:
        buf.append(s)
        if len(buf) >= size:
            yield buf.pop(rng.randrange(len(buf)))
    while buf:
        yield buf.pop(rng.randrange(len(buf)))


class WebDataset:
    """End-to-end tar-shard loader::

        from chronoedit_tpu_torch.parallel import distributed

        ds = WebDataset(glob("shards/*.tar"),
                        world_size=distributed.process_count(),
                        rank=distributed.process_index())
        for sample in ds:  # {"__key__", "jpg": (3,H,W) float32, "txt": str}
    """

    def __init__(self, shards: list[str] | dict[str, str], world_size: int = 1,
                 rank: int = 0, decoders=None, shuffle_size: int = 100,
                 augment: Callable[[dict], dict] | None = None, seed: int = 0):
        # dict shards = {tar_path: aspect_label} -> aspect-aware distribution
        if isinstance(shards, dict):
            self.distributor = MultiAspectDistributor(
                shards, world_size, rank, seed=seed)
        else:
            self.distributor = ShardDistributor(shards, world_size, rank, seed=seed)
        self.decoders = decoders
        self.shuffle_size = shuffle_size
        self.augment = augment
        self.seed = seed

    def __iter__(self) -> Iterator[dict]:
        stream = decode_samples(tar_samples(iter(self.distributor)), self.decoders)
        if self.shuffle_size > 1:
            stream = shuffle_buffer(stream, self.shuffle_size, self.seed)
        for s in stream:
            yield self.augment(s) if self.augment else s


def batched(samples: Iterable[dict], batch_size: int,
            stack_keys: tuple[str, ...] = ()) -> Iterator[dict]:
    """Group samples into batches; ``stack_keys`` are np.stack'ed, the rest
    are listed."""
    batch: list[dict] = []
    for s in samples:
        batch.append(s)
        if len(batch) == batch_size:
            out: dict[str, Any] = {}
            for k in batch[0]:
                vals = [b[k] for b in batch]
                out[k] = np.stack(vals) if k in stack_keys else vals
            yield out
            batch = []
