"""Batching inference server around :class:`ChronoEditPipeline`, PyTorch.

The port of ``chronoedit_tpu/pipeline/server.py``: requests are grouped by
their static configuration and run as one batch, padded up to the nearest
bucket size, so that a few batch shapes cover every load level.

- :meth:`EditServer.submit` enqueues a request and returns a
  ``concurrent.futures.Future``; callers (HTTP handlers, tests) block on
  ``future.result()``.
- A single batcher thread groups pending requests by ``_GroupKey``
  (geometry and sampling parameters: anything that changes the batch's
  shapes or its path), waits up to ``max_wait_ms`` for the batch to fill
  after its first request arrived, pads it to the nearest bucket with the
  last request, and runs the pipeline once per batch. The card is driven
  from that one thread only.
- Per-request reproducibility: each request carries a ``seed``, and its
  initial latents are drawn from ``torch.Generator(device).manual_seed(
  seed)`` on the pipeline's device, one request at a time, so batching
  changes no one's noise.
- Text guardrails run per request at submit time (a blocked prompt fails
  only its own future, before it can join a batch); the video guardrail
  runs on the batched output inside the pipeline.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    max_batch: int = 4
    max_wait_ms: float = 50.0
    # batch-size buckets (ascending); () derives powers of two up to
    # max_batch: (1, 2, 4, ...)
    buckets: tuple[int, ...] = ()
    max_queue: int = 64  # submit fails the request when this many are pending

    def resolved_buckets(self) -> tuple[int, ...]:
        if self.buckets:
            return tuple(sorted(self.buckets))
        b, out = 1, []
        while b < self.max_batch:
            out.append(b)
            b *= 2
        return tuple(out) + (self.max_batch,)


@dataclasses.dataclass(frozen=True)
class _GroupKey:
    """Everything that selects a distinct batch shape or path."""
    height: int
    width: int
    num_steps: int | None
    guidance: float | None
    flow_shift: float | None
    reasoning: bool
    k_reason: int
    # lengths, not booleans: two requests whose optional embeddings differ
    # in token count must not share a batch (the concatenation would fail
    # the innocent request too); -1 = absent
    neg_len: int
    image_tokens: int
    prompt_len: int
    frame_only: bool


@dataclasses.dataclass
class _Request:
    image: torch.Tensor        # (1, 3, H, W) fp32, CPU
    prompt_emb: torch.Tensor   # (1, L, D)
    neg_prompt_emb: torch.Tensor | None
    image_emb: torch.Tensor | None
    seed: int
    key: _GroupKey
    future: Future
    enqueued: float


def _host(x, dims: int) -> torch.Tensor | None:
    """A client array (numpy or tensor) as an fp32 CPU tensor of ``dims``
    dimensions, the leading batch axis of 1 added if it is missing."""
    if x is None:
        return None
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x, np.float32))
    t = t.detach().to("cpu", torch.float32)
    return t[None] if t.dim() == dims - 1 else t


class EditServer:
    def __init__(self, pipeline, cfg: ServerConfig = ServerConfig()):
        if cfg.buckets and max(cfg.buckets) < cfg.max_batch:
            raise ValueError(
                f"buckets {cfg.buckets} do not cover max_batch {cfg.max_batch}: an "
                "over-sized batch would run a shape no bucket warmed up")
        self.pipeline = pipeline
        self.cfg = cfg
        self._groups: dict[_GroupKey, collections.deque] = {}
        self._lock = threading.Lock()
        self._have_work = threading.Condition(self._lock)
        self._pending = 0
        self._stop = False
        self._thread: threading.Thread | None = None
        self.stats = {"requests": 0, "batches": 0, "batched_requests": 0,
                      "padded_slots": 0, "rejected": 0, "errors": 0}

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "EditServer":
        self._thread = threading.Thread(target=self._loop, daemon=True, name="edit-batcher")
        self._thread.start()
        return self

    def stop(self) -> None:
        with self._lock:
            self._stop = True
            self._have_work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
        # fail anything still queued: a caller blocked on future.result()
        # must not hang on shutdown
        with self._lock:
            for dq in self._groups.values():
                while dq:
                    req = dq.popleft()
                    self._pending -= 1
                    if not req.future.done():
                        req.future.set_exception(
                            RuntimeError("server shut down before this request was served"))
            self._groups.clear()

    def warmup(self, height: int, width: int, prompt_len: int = 512,
               with_image_emb: bool = True, buckets=None, **kw) -> None:
        """One throwaway edit per batch bucket at the given geometry before
        opening the door (allocator pools, cuDNN algorithm choice, the
        kernels' first launches)."""
        cfg = self.pipeline.config
        dev = self.pipeline.device
        for b in buckets or self.cfg.resolved_buckets():
            ie = (torch.zeros((b, cfg.dit.image_tokens, cfg.dit.image_dim), device=dev)
                  if with_image_emb else None)
            self.pipeline.edit_image(torch.zeros((b, 3, height, width), device=dev),
                                     torch.zeros((b, prompt_len, cfg.dit.text_dim), device=dev),
                                     image_emb=ie, **kw)

    # --------------------------------------------------------------- submit

    def submit(self, image, prompt_emb, *, neg_prompt_emb=None, image_emb=None,
               seed: int = 0, prompt: str = "", num_steps: int | None = None,
               guidance_scale: float | None = None, flow_shift: float | None = None,
               enable_temporal_reasoning: bool = False,
               num_temporal_reasoning_steps: int = 0, frame_only: bool = True) -> Future:
        """Enqueue one edit (arrays or tensors; a leading batch axis of 1 is
        optional); returns a Future of the edited frame (3, H, W) as an fp32
        CPU tensor (the clip (3, T, H, W) with ``frame_only=False``)."""
        fut: Future = Future()
        image, prompt_emb = _host(image, 4), _host(prompt_emb, 3)
        if image.shape[0] != 1 or prompt_emb.shape[0] != 1:
            raise ValueError("submit() takes a single request; the server does the batching")

        # reject unsafe prompts before they can join (and fail) a batch
        if self.pipeline.guardrails is not None:
            try:
                self.pipeline.guardrails.check_text_or_raise(prompt)
            except Exception as e:  # noqa: BLE001 - the request's own failure
                with self._lock:  # submit runs on many client threads
                    self.stats["rejected"] += 1
                fut.set_exception(e)
                return fut

        neg, img_emb = _host(neg_prompt_emb, 3), _host(image_emb, 3)
        key = _GroupKey(
            height=image.shape[-2], width=image.shape[-1], num_steps=num_steps,
            guidance=guidance_scale, flow_shift=flow_shift,
            reasoning=enable_temporal_reasoning, k_reason=num_temporal_reasoning_steps,
            neg_len=-1 if neg is None else neg.shape[-2],
            image_tokens=-1 if img_emb is None else img_emb.shape[-2],
            prompt_len=prompt_emb.shape[1], frame_only=frame_only)
        req = _Request(image=image, prompt_emb=prompt_emb, neg_prompt_emb=neg,
                       image_emb=img_emb, seed=seed, key=key, future=fut,
                       enqueued=time.monotonic())
        with self._lock:
            if self._pending >= self.cfg.max_queue:
                self.stats["rejected"] += 1
                fut.set_exception(RuntimeError(f"queue full ({self.cfg.max_queue})"))
                return fut
            self._groups.setdefault(key, collections.deque()).append(req)
            self._pending += 1
            self.stats["requests"] += 1
            self._have_work.notify()
        return fut

    def health(self) -> dict:
        with self._lock:
            return {"pending": self._pending, "device": str(self.pipeline.device),
                    **self.stats}

    # -------------------------------------------------------------- batcher

    def _take_batch(self) -> list[_Request] | None:
        """Block until a batch is ready: the oldest group either fills to
        max_batch or its head request has waited max_wait_ms."""
        wait_s = self.cfg.max_wait_ms / 1000.0
        with self._lock:
            while True:
                if self._stop:
                    return None
                oldest = None
                for k in [k for k, dq in self._groups.items() if not dq]:
                    del self._groups[k]  # unbounded key space (client parameters)
                for dq in self._groups.values():
                    if dq[0].enqueued < (oldest[0].enqueued if oldest else float("inf")):
                        oldest = dq
                if oldest is None:
                    self._have_work.wait()
                    continue
                deadline = oldest[0].enqueued + wait_s
                now = time.monotonic()
                if len(oldest) >= self.cfg.max_batch or now >= deadline:
                    n = min(len(oldest), self.cfg.max_batch)
                    batch = [oldest.popleft() for _ in range(n)]
                    self._pending -= n
                    return batch
                self._have_work.wait(timeout=deadline - now)

    def _latents_for(self, req: _Request) -> torch.Tensor:
        """The request's initial noise (1, C, Tl, H/8, W/8) fp32 on the
        pipeline's device, from its own seeded generator."""
        cfg = self.pipeline.config
        dev = self.pipeline.device
        # the pipeline's own frame rule
        num_frames = cfg.resolve_num_frames(enable_temporal_reasoning=req.key.reasoning)
        tl = cfg.vae.latent_frames(num_frames)
        hl = req.key.height // cfg.vae.spatial_factor
        wl = req.key.width // cfg.vae.spatial_factor
        gen = torch.Generator(device=dev).manual_seed(req.seed)
        return torch.randn((1, cfg.latent_channels, tl, hl, wl), generator=gen,
                           dtype=torch.float32, device=dev)

    def _run_batch(self, batch: list[_Request]) -> None:
        k = batch[0].key
        buckets = self.cfg.resolved_buckets()
        bucket = next((b for b in buckets if b >= len(batch)), buckets[-1])
        pad = bucket - len(batch)
        reqs = batch + [batch[-1]] * pad
        dev = self.pipeline.device

        def stack(get):
            parts = [get(r) for r in reqs]
            return None if parts[0] is None else torch.cat(parts).to(dev)

        out = self.pipeline(
            stack(lambda r: r.image), stack(lambda r: r.prompt_emb),
            neg_prompt_emb=stack(lambda r: r.neg_prompt_emb),
            image_emb=stack(lambda r: r.image_emb),
            num_steps=k.num_steps, guidance_scale=k.guidance, flow_shift=k.flow_shift,
            enable_temporal_reasoning=k.reasoning, num_temporal_reasoning_steps=k.k_reason,
            # every prompt in the batch was vetted at submit time
            skip_text_guardrail=True,
            latents=stack(self._latents_for))
        out = (out[..., -1, :, :] if k.frame_only else out).float().cpu()
        self.stats["batches"] += 1
        self.stats["batched_requests"] += len(batch)
        self.stats["padded_slots"] += pad
        for i, r in enumerate(batch):
            r.future.set_result(out[i])

    def _loop(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            try:
                self._run_batch(batch)
            except Exception as e:  # noqa: BLE001 - fail the batch, not the server
                self.stats["errors"] += 1
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)
