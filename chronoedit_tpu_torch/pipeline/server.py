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
  runs on the batched output inside the pipeline. ``submit`` also checks
  each request's shapes against the model, so that no batch fails on one
  client's malformed input.

Under a mesh (a pipeline whose ``mesh`` spans a world of several
processes), rank 0 runs this server: the batcher and the HTTP front. For
each batch it broadcasts over the whole world a header (the group key,
the per-request seeds, which optional tensors are present and their
shapes), then the stacked tensors; every other rank runs :func:`follow`,
which receives them, draws each request's noise from its seed by the rule
rank 0 uses (:func:`request_latents`, on its own device), runs the same
pipeline call and discards the output. After each batch every rank joins
one small all-gather, so rank 0 answers a batch only once every rank has
finished it. :meth:`EditServer.stop` broadcasts a stop header, on which
:func:`follow` returns. Guardrails run on rank 0 only, as JAX's single
controller checks once: the text check at submit, the video check inside
rank 0's pipeline call, after the last collective (a blocked video fails
only its batch); followers serve without guardrails.

An idle world stays up: the followers wait for the next header inside a
collective, which fails once the process group's timeout
(``parallel/distributed.TIMEOUT``) passes with nothing sent, so rank 0's
batcher broadcasts a keep-alive header whenever the world has been idle
for ``KEEPALIVE_S`` seconds (a quarter of that timeout), which the
followers skip.

A failure on any other rank, or one inside rank 0's pipeline call, ends
the served world rather than hang it: the failing follower closes its
process group and raises, so that the collectives of the ranks waiting on
it fail (at once over gloo; over NCCL when the collective times out);
rank 0 then fails that batch's futures with its own collective's error,
fails every queued request, closes its own process group (so that the
other followers' collectives fail too), and refuses further requests;
``health()`` reports it under ``"world"``. A served world is not
restarted in place: under torchrun the failed follower's exit ends the
job, and the follower's own error is in its log.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch
import torch.distributed as dist

from chronoedit_tpu_torch.parallel.distributed import TIMEOUT


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


# the pipeline's tensor inputs, in the order a batch broadcasts them
_TENSORS = ("image", "prompt_emb", "neg_prompt_emb", "image_emb")
# the header of an idle world's keep-alive, which followers skip
_KEEPALIVE = {"keepalive": True}
# under a mesh: the longest the world goes without a broadcast before rank
# 0 sends a keep-alive header; well below the process group's timeout,
# which the followers' wait for a header is held to
KEEPALIVE_S = TIMEOUT.total_seconds() / 4


def request_latents(pipeline, key: _GroupKey, seed: int) -> torch.Tensor:
    """A request's initial noise (1, C, Tl, H/8, W/8) fp32 on the
    pipeline's device, from its own seeded generator: the rule by which
    rank 0 and every follower draw it."""
    cfg = pipeline.config
    dev = pipeline.device
    # the pipeline's own frame rule
    num_frames = cfg.resolve_num_frames(enable_temporal_reasoning=key.reasoning)
    tl = cfg.vae.latent_frames(num_frames)
    hl = key.height // cfg.vae.spatial_factor
    wl = key.width // cfg.vae.spatial_factor
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((1, cfg.latent_channels, tl, hl, wl), generator=gen,
                       dtype=torch.float32, device=dev)


def _served_world(pipeline) -> bool:
    """Whether ``pipeline`` runs under a mesh of several processes."""
    mesh = getattr(pipeline, "mesh", None)
    return (mesh is not None and dist.is_initialized() and dist.get_world_size() > 1)


def _run(pipeline, key: _GroupKey, tensors: dict, latents: torch.Tensor) -> torch.Tensor:
    """The pipeline call of one batch, on every rank alike."""
    return pipeline(
        tensors["image"], tensors["prompt_emb"], neg_prompt_emb=tensors["neg_prompt_emb"],
        image_emb=tensors["image_emb"], num_steps=key.num_steps, guidance_scale=key.guidance,
        flow_shift=key.flow_shift, enable_temporal_reasoning=key.reasoning,
        num_temporal_reasoning_steps=key.k_reason,
        # every prompt in the batch was vetted at submit time
        skip_text_guardrail=True, latents=latents)


def _broadcast_batch(header: dict | None, tensors: dict | None, device) -> tuple:
    """Rank 0's header and tensors (on ``device``) on every rank of the
    world: (header, tensors); a header of None is the stop, and the
    keep-alive header comes with no tensors."""
    from chronoedit_tpu_torch.parallel.collectives import broadcast

    if device.type == "cuda":  # this thread's device, for NCCL's objects
        torch.cuda.set_device(device)
    box = [header]
    dist.broadcast_object_list(box, src=0)
    header = box[0]
    if header is None or header == _KEEPALIVE:
        return header, None
    out = {}
    for name in _TENSORS:
        shape = header["shapes"][name]
        if shape is None:
            out[name] = None
            continue
        t = (tensors[name] if tensors is not None
             else torch.empty(shape, dtype=torch.float32, device=device))
        out[name] = broadcast(t.contiguous(), dist.group.WORLD, 0)
    return header, out


def _batch_done() -> None:
    """Every rank has finished the batch (one small all-gather over the
    world); raises when a rank has left it."""
    flags = [None] * dist.get_world_size()
    dist.all_gather_object(flags, True)


def follow(pipeline, mesh) -> int:
    """A follower rank's side of :class:`EditServer` under ``mesh``: run
    every batch rank 0 broadcasts, with each request's noise drawn from its
    seed (:func:`request_latents`), and discard the output, until rank 0's
    stop header; keep-alive headers are skipped. Returns the number of
    batches run. On any failure it closes this rank's process group (so
    that no rank waits on it) and raises."""
    if mesh.rank == 0:
        raise ValueError("follow() runs on the ranks other than 0; rank 0 runs EditServer")
    device = pipeline.device
    batches = 0
    try:
        while True:
            header, tensors = _broadcast_batch(None, None, device)
            if header is None:
                return batches
            if header == _KEEPALIVE:
                continue
            key = header["key"]
            latents = torch.cat([request_latents(pipeline, key, s) for s in header["seeds"]])
            _run(pipeline, key, tensors, latents)
            _batch_done()
            batches += 1
    except BaseException:
        if dist.is_initialized():
            dist.destroy_process_group()
        raise


def _host(x, dims: int) -> torch.Tensor | None:
    """A client array (numpy or tensor) as an fp32 CPU tensor of ``dims``
    dimensions, the leading batch axis of 1 added if it is missing."""
    if x is None:
        return None
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x, np.float32))
    t = t.detach().to("cpu", torch.float32)
    return t[None] if t.dim() == dims - 1 else t


def _check_request(cfg, image, prompt_emb, neg, image_emb, num_steps, k_reason) -> None:
    """Raise ValueError for a request the pipeline of ``cfg`` cannot run."""
    sf = cfg.vae.spatial_factor
    _, ph, pw = cfg.dit.patch_size
    if image.dim() != 4 or image.shape[1] != 3:
        raise ValueError(f"image must be (3, H, W), got {tuple(image.shape[1:])}")
    h, w = image.shape[-2:]
    if h % (sf * ph) or w % (sf * pw) or h == 0 or w == 0:
        raise ValueError(f"image {h}x{w}: H and W must be multiples of "
                         f"{sf * ph} and {sf * pw}")
    for name, emb in (("prompt_emb", prompt_emb), ("neg_prompt_emb", neg)):
        if emb is not None and (emb.dim() != 3 or emb.shape[0] != 1 or emb.shape[1] == 0
                                or emb.shape[2] != cfg.dit.text_dim):
            raise ValueError(f"{name} must be (L, {cfg.dit.text_dim}), got "
                             f"{tuple(emb.shape[1:])}")
    if image_emb is not None and (not cfg.dit.image_dim or image_emb.dim() != 3
                                  or image_emb.shape[0] != 1
                                  or image_emb.shape[2] != cfg.dit.image_dim):
        raise ValueError(f"image_emb must be (tokens, {cfg.dit.image_dim}), got "
                         f"{tuple(image_emb.shape[1:])}")
    if (num_steps is not None and num_steps < 1) or k_reason < 0:
        raise ValueError(f"steps {num_steps} and reasoning steps {k_reason}: need >= 1 / >= 0")


class EditServer:
    def __init__(self, pipeline, cfg: ServerConfig = ServerConfig()):
        if cfg.buckets and max(cfg.buckets) < cfg.max_batch:
            raise ValueError(
                f"buckets {cfg.buckets} do not cover max_batch {cfg.max_batch}: an "
                "over-sized batch would run a shape no bucket warmed up")
        self.pipeline = pipeline
        self.cfg = cfg
        # under a mesh of several processes: this is rank 0, which
        # broadcasts every batch to the followers
        self._world = _served_world(pipeline)
        if self._world and pipeline.mesh.rank != 0:
            raise ValueError("EditServer runs on rank 0; the other ranks call follow()")
        self._ended: str | None = None  # why the served world ended
        self._run_lock = threading.Lock()  # one batch at a time on the world
        self._last_sent = time.monotonic()  # the world's last broadcast ended
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
        """Stop the batcher, fail whatever is still queued and, under a
        mesh, broadcast the stop header on which the followers return."""
        with self._lock:
            self._stop = True
            self._have_work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
        if self._world:
            with self._run_lock:
                if self._ended is None:
                    self._ended = "stopped"
                    _broadcast_batch(None, None, self.pipeline.device)
        self._fail_queued("server shut down before this request was served")

    def _fail_queued(self, why: str) -> None:
        # a caller blocked on future.result() must not hang
        with self._lock:
            for dq in self._groups.values():
                while dq:
                    req = dq.popleft()
                    self._pending -= 1
                    if not req.future.done():
                        req.future.set_exception(RuntimeError(why))
            self._groups.clear()

    def warmup(self, height: int, width: int, prompt_len: int = 512,
               with_image_emb: bool = True, buckets=None, num_steps: int | None = None,
               guidance_scale: float | None = None, flow_shift: float | None = None,
               enable_temporal_reasoning: bool = False,
               num_temporal_reasoning_steps: int = 0) -> None:
        """One throwaway edit per batch bucket at the given geometry before
        opening the door (allocator pools, cuDNN algorithm choice, the
        kernels' first launches), seeded 0; under a mesh through the
        broadcast, so that every rank warms up."""
        cfg = self.pipeline.config
        key = _GroupKey(
            height=height, width=width, num_steps=num_steps, guidance=guidance_scale,
            flow_shift=flow_shift, reasoning=enable_temporal_reasoning,
            k_reason=num_temporal_reasoning_steps, neg_len=-1,
            image_tokens=cfg.dit.image_tokens if with_image_emb else -1,
            prompt_len=prompt_len, frame_only=True)
        for b in buckets or self.cfg.resolved_buckets():
            tensors = {"image": torch.zeros((b, 3, height, width)),
                       "prompt_emb": torch.zeros((b, prompt_len, cfg.dit.text_dim)),
                       "neg_prompt_emb": None,
                       "image_emb": (torch.zeros((b, cfg.dit.image_tokens, cfg.dit.image_dim))
                                     if with_image_emb else None)}
            self._execute(key, [0] * b, tensors,
                          torch.cat([request_latents(self.pipeline, key, 0)] * b))

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
        _check_request(self.pipeline.config, image, prompt_emb, neg, img_emb, num_steps,
                       num_temporal_reasoning_steps)
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
            if self._ended is not None:
                self.stats["rejected"] += 1
                fut.set_exception(RuntimeError(f"the served world has ended: {self._ended}"))
                return fut
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
            out = {"pending": self._pending, "device": str(self.pipeline.device),
                   **self.stats}
            mesh = getattr(self.pipeline, "mesh", None)
            if mesh is not None:
                out["mesh"] = dict(mesh.shape)
            if self._world:
                out["world"] = {"ranks": dist.get_world_size() if self._ended is None
                                else None, "ended": self._ended}
            return out

    # -------------------------------------------------------------- batcher

    def _take_batch(self) -> list[_Request] | None:
        """Block until a batch is ready: the oldest group either fills to
        max_batch or its head request has waited max_wait_ms. Under a mesh,
        an empty batch when the world's keep-alive is due first."""
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
                now = time.monotonic()
                if oldest is not None and (len(oldest) >= self.cfg.max_batch
                                           or now >= oldest[0].enqueued + wait_s):
                    n = min(len(oldest), self.cfg.max_batch)
                    batch = [oldest.popleft() for _ in range(n)]
                    self._pending -= n
                    return batch
                due = (self._last_sent + KEEPALIVE_S
                       if self._world and self._ended is None else float("inf"))
                if now >= due:
                    return []
                until = min(due, float("inf") if oldest is None
                            else oldest[0].enqueued + wait_s)
                self._have_work.wait(timeout=None if until == float("inf") else until - now)

    def _latents_for(self, req: _Request) -> torch.Tensor:
        """The request's initial noise (:func:`request_latents`)."""
        return request_latents(self.pipeline, req.key, req.seed)

    def _execute(self, key: _GroupKey, seeds: list[int], tensors: dict,
                 latents: torch.Tensor) -> torch.Tensor:
        """One batch through the pipeline (CPU ``tensors`` by name, each
        request's seed and this rank's noise from it), under a mesh
        broadcast to the followers first and finished on every rank before
        it returns. Raises the pipeline's error; one that ends the served
        world also fails every queued request."""
        from chronoedit_tpu_torch.aux.guardrails import GuardrailBlocked

        dev = self.pipeline.device
        tensors = {n: None if t is None else t.to(dev) for n, t in tensors.items()}
        with self._run_lock:
            if self._ended is not None:
                raise RuntimeError(f"the served world has ended: {self._ended}")
            if not self._world:
                return _run(self.pipeline, key, tensors, latents)
            try:
                header = {"key": key, "seeds": list(seeds),
                          "shapes": {n: None if t is None else tuple(t.shape)
                                     for n, t in tensors.items()}}
                _, tensors = _broadcast_batch(header, tensors, dev)
                try:
                    out, blocked = _run(self.pipeline, key, tensors, latents), None
                except GuardrailBlocked as e:  # rank 0's video check, after every collective
                    out, blocked = None, e
                _batch_done()
                self._last_sent = time.monotonic()
            except BaseException as e:
                self._end_world(e)
                raise RuntimeError(f"the served world ended in this batch: "
                                   f"{self._ended}") from e
            if blocked is not None:
                raise blocked
            return out

    def _keep_alive(self) -> None:
        """Broadcast the keep-alive header if the world is still idle; a
        failure ends the world."""
        with self._run_lock:
            if (self._ended is not None
                    or time.monotonic() < self._last_sent + KEEPALIVE_S):
                return
            try:
                _broadcast_batch(_KEEPALIVE, None, self.pipeline.device)
                self._last_sent = time.monotonic()
            except Exception as e:  # noqa: BLE001 - recorded, the world ends
                self._end_world(e)

    def _end_world(self, error: BaseException) -> None:
        """Record why the world ended (rank 0's own error: a follower's
        failure shows as the collective that failed with it), close this
        rank's process group so that no follower waits on it, and fail
        every queued request."""
        self._ended = f"rank 0: {type(error).__name__}: {error}"
        if dist.is_initialized():
            dist.destroy_process_group()
        self._fail_queued(f"the served world has ended: {self._ended}")

    def _run_batch(self, batch: list[_Request]) -> None:
        k = batch[0].key
        buckets = self.cfg.resolved_buckets()
        bucket = next((b for b in buckets if b >= len(batch)), buckets[-1])
        pad = bucket - len(batch)
        reqs = batch + [batch[-1]] * pad

        def stack(get):
            parts = [get(r) for r in reqs]
            return None if parts[0] is None else torch.cat(parts)

        tensors = {"image": stack(lambda r: r.image),
                   "prompt_emb": stack(lambda r: r.prompt_emb),
                   "neg_prompt_emb": stack(lambda r: r.neg_prompt_emb),
                   "image_emb": stack(lambda r: r.image_emb)}
        out = self._execute(k, [r.seed for r in reqs], tensors,
                            torch.cat([self._latents_for(r) for r in reqs]))
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
            if not batch:
                self._keep_alive()
                continue
            try:
                self._run_batch(batch)
            except Exception as e:  # noqa: BLE001 - fail the batch, not the server
                self.stats["errors"] += 1
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)
