"""Training checkpoints: the Orbax manager's contract on safetensors.

The port of ``chronoedit_tpu/train/checkpoint.py``. JAX's manager wraps
Orbax; the port writes one directory per step under
``CheckpointConfig.directory``:

- ``<step>/state.safetensors``: the trained parameters (``params/<name>``),
  the EMA (``ema_params/<name>``), AdamW's moments
  (``opt_state/exp_avg/<name>``, ``opt_state/exp_avg_sq/<name>``) and the
  gradient accumulator (``opt_state/acc/<name>``), each in its own dtype;
- ``<step>/counters.json``: ``step`` (micro-steps), ``gradient_step``
  (applied updates, which is also AdamW's step) and ``mini_step``.

A save is written under a temporary name and renamed into place, so
:meth:`CheckpointManager.latest_step` never sees half a checkpoint; an
async save copies every tensor to host memory before :meth:`save` returns
and writes on a thread (one at a time), as Orbax's async checkpointer does.

In a world of several processes (a sharded state: ``parallel/sharding``,
or a pipeline stage's blocks) the save is collective, as Orbax's, and
sharded: each rank writes the tensors it holds to
``<step>/state-<rank>.safetensors`` (5 digits), each block of a leaf once
(the lowest rank that holds it writes it: a leaf whole on every rank is
rank 0's, a context line's replicas are written once), with every
tensor's whole shape and the start of its block in the file's metadata
(``layout``); rank 0 writes the counters. Tensors are named as the whole
model names them: a stage-local model's block ``j`` is written as
``blocks.{layers.start + j}`` (``DiT.global_name``), so every block is
held once under its global name, by its stage's lowest rank, and the
leaves outside the blocks once, by rank 0; under pipe x fsdp each fsdp
piece of a stage's block by that stage's rank of the piece's fsdp index,
and each piece of a non-block leaf by stage 0's. After a barrier rank 0 renames
the step into place, and after a second barrier it deletes the steps
beyond ``max_to_keep``. A restore, in
any world and under any mesh (one process included), reads for each of the
live tensors only the slices it needs from the files that hold them
(``safetensors``' ``get_slice``), from the one-process file as from the
ranks'. The barriers run on a gloo group of the world's ranks that the
manager opens for itself, so an async save's thread never shares a group
with the training's collectives.
The file is written here in the safetensors layout (:func:`_save_file`)
with plain ``write`` calls, which release the interpreter lock: the
``safetensors`` package's writer holds it for the whole write, which
stalled the training thread for as long (9 s of a 13 s save of 10.5 GB,
H100 80GB HBM3 host, 700 W).
:meth:`CheckpointManager.restore` copies into the live state, in place:
the parameters, moments, accumulator and counters, so a restored state
continues bitwise where the saved one would have gone, in the middle of an
accumulation too. ``keys_not_to_resume`` keeps the live values of whole
top-level fields (``step``, ``params``, ``opt_state``, ``ema_params``, JAX's
``TrainState`` field names); ``load_ema_to_reg`` restores the EMA into the
parameters as well. :func:`save_params` / :func:`load_params` are the
one-shot form for a model's parameters alone.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import json
import math
import os
import shutil
import struct
import threading
from typing import Any

import torch
import torch.distributed as dist
from torch import nn

STATE_FILE = "state.safetensors"
RANK_FILE = "state-{:05d}.safetensors"  # a rank's file of a sharded step
LAYOUT_KEY = "layout"  # its metadata: {name: [whole shape, block start]}
COUNTERS_FILE = "counters.json"
PARAMS_FILE = "params.safetensors"
_TMP = ".tmp"


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    directory: str = "checkpoints"
    max_to_keep: int = 3
    save_interval: int = 1000
    async_save: bool = True
    keys_not_to_resume: tuple[str, ...] = ()
    # restore the EMA weights INTO the regular params (the reference's
    # ``load_ema_to_reg`` regexp swap, ModelWrapper dcp.py:454-503)
    load_ema_to_reg: bool = False


def _owner(state: Any):
    return state.model if hasattr(state, "model") else state.lora


def _global(owner, name: str) -> str:
    """``name`` as the whole model names it (``DiT.global_name``: a
    pipeline stage's blocks by their global index)."""
    rename = getattr(owner, "global_name", None)
    return name if rename is None else rename(name)


def _param_names(state: Any) -> list[str]:
    """The names of ``state.params`` in order, as the whole model names
    them: the model's parameters for a full-parameter state (a pipeline
    stage's blocks by their global index), the adapters' for a LoRA
    state."""
    owner = _owner(state)
    names = [_global(owner, n) for n, _ in owner.named_parameters()]
    if len(names) != len(state.params):
        raise ValueError("the state's parameters are not its module's")
    return names


def state_tensors(state: Any) -> dict[str, torch.Tensor]:
    """Every tensor of a train state under its checkpoint name."""
    names = _param_names(state)
    opt = state.optimizer
    out = {f"params/{n}": p for n, p in zip(names, state.params)}
    if state.ema_params is not None:
        out.update({f"ema_params/{n}": e for n, e in zip(names, state.ema_params)})
    for n, p in zip(names, state.params):
        st = opt.adamw.state.get(p, {})
        for key in ("exp_avg", "exp_avg_sq"):
            out[f"opt_state/{key}/{n}"] = st[key] if key in st else torch.zeros_like(p)
    if opt.acc is not None:
        out.update({f"opt_state/acc/{n}": a for n, a in zip(names, opt.acc)})
    return out


def state_boxes(state: Any) -> dict[str, tuple[tuple[int, ...], tuple[int, ...]]]:
    """{checkpoint name: (the leaf's whole shape, where this rank's tensor
    starts in it)} for every tensor of :func:`state_tensors` (a state over
    a model sharded by ``parallel/sharding``, or over whole adapters); a
    stage's block under its global name with its fsdp box."""
    from chronoedit_tpu_torch.parallel.sharding import local_box

    owner = _owner(state)
    per_leaf = {_global(owner, n): local_box(owner, n, tuple(p.shape))
                for n, p in owner.named_parameters()}
    return {k: per_leaf[k.rsplit("/", 1)[1]] for k in state_tensors(state)}


def state_counters(state: Any) -> dict[str, int]:
    opt = state.optimizer
    return {"step": state.step, "gradient_step": opt.gradient_step,
            "mini_step": opt.mini_step}


_DTYPES = {torch.float64: "F64", torch.float32: "F32", torch.bfloat16: "BF16",
           torch.float16: "F16", torch.int64: "I64", torch.int32: "I32", torch.int16: "I16",
           torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}


def _save_file(tensors: dict[str, torch.Tensor], path: str,
               metadata: dict[str, str] | None = None) -> None:
    """Contiguous host tensors as one safetensors file (an 8-byte header
    length, the JSON header padded with spaces to 8 bytes, then every
    tensor's bytes in order, no holes), written tensor by tensor;
    ``metadata`` is the header's string map."""
    header, offset = ({"__metadata__": metadata} if metadata else {}), 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            f.write(t.reshape(-1).view(torch.uint8).numpy())


def _write(path: str, tensors: dict[str, torch.Tensor], counters: dict | None) -> None:
    """Write host tensors (and counters) as the directory ``path``, through a
    temporary name and a rename."""
    tmp = path + _TMP
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    if counters is None:
        _save_file(tensors, os.path.join(tmp, PARAMS_FILE))
    else:
        _save_file(tensors, os.path.join(tmp, STATE_FILE))
        with open(os.path.join(tmp, COUNTERS_FILE), "w") as f:
            json.dump(counters, f)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def _to_host(tensors: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Contiguous host copies, none sharing memory with the live state."""
    return {k: t.detach().to("cpu", copy=True).contiguous() for k, t in tensors.items()}


class _Pieces:
    """The tensors of a step directory, one-process (``state.safetensors``:
    each tensor whole) or sharded (the ranks' files, each tensor's block
    placed by the file's ``layout``), or of the given ``files``, open until
    :meth:`close`. :meth:`read` assembles any block of a tensor from the
    pieces that hold it, reading only their overlapping slices."""

    def __init__(self, path: str, files: list[str] | None = None):
        from safetensors import safe_open

        self.path = path
        self._stack = contextlib.ExitStack()
        # name -> [(open file, whole shape, start, shape)]
        self.index: dict[str, list] = {}
        if files is None:
            whole = os.path.join(path, STATE_FILE)
            files = [whole] if os.path.exists(whole) else sorted(
                glob.glob(os.path.join(path, RANK_FILE.replace("{:05d}", "*"))))
        if not files:
            raise FileNotFoundError(f"no checkpoint files in {path}")
        for file in files:
            f = self._stack.enter_context(safe_open(file, framework="pt"))
            layout = json.loads((f.metadata() or {}).get(LAYOUT_KEY, "{}"))
            for name in f.keys():
                shape = tuple(f.get_slice(name).get_shape())
                whole_shape, start = layout.get(name, (shape, (0,) * len(shape)))
                self.index.setdefault(name, []).append(
                    (f, tuple(whole_shape), tuple(start), shape))

    def _pieces(self, name: str) -> list:
        if name not in self.index:
            raise KeyError(f"checkpoint {self.path} has no {name}")
        return self.index[name]

    def whole_shape(self, name: str) -> tuple[int, ...]:
        return self._pieces(name)[0][1]

    def read(self, name: str, whole: tuple[int, ...], start: tuple[int, ...],
             shape: tuple[int, ...]) -> torch.Tensor:
        """The block of tensor ``name`` (of the ``whole`` shape) at ``start``
        of ``shape``, on the host; raises when the shapes disagree or the
        pieces do not cover it."""
        pieces = self._pieces(name)
        if math.prod(shape) == 0:
            return torch.empty(shape, dtype=pieces[0][0].get_tensor(name).dtype)
        out, covered = None, 0
        for f, p_whole, p_start, p_shape in pieces:
            if p_whole != tuple(whole):
                raise ValueError(f"checkpoint {self.path}: {name} is {p_whole}, the state "
                                 f"holds a block of {tuple(whole)}")
            lo = [max(a, b) for a, b in zip(start, p_start)]
            hi = [min(a + n, b + m) for a, n, b, m in zip(start, shape, p_start, p_shape)]
            if any(a >= b for a, b in zip(lo, hi)):
                continue  # no overlap
            if [b - a for a, b in zip(lo, hi)] == list(p_shape):
                part = f.get_tensor(name)  # the whole piece
            else:
                part = f.get_slice(name)[tuple(slice(a - b, c - b)
                                               for a, c, b in zip(lo, hi, p_start))]
            if part.shape == shape:
                return part
            if out is None:
                out = torch.empty(shape, dtype=part.dtype)
            out[tuple(slice(a - b, c - b) for a, c, b in zip(lo, hi, start))] = part
            covered += part.numel()
        if covered != math.prod(shape):
            raise KeyError(f"checkpoint {self.path}: the pieces of {name} do not cover the "
                           f"block at {tuple(start)} of {tuple(shape)}")
        return out

    def close(self) -> None:
        self._stack.close()

    def __enter__(self) -> "_Pieces":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class CheckpointManager:
    """Step directories under ``cfg.directory``: save, find the latest,
    restore into a live train state, keep the newest ``max_to_keep``. In a
    world of several processes every rank makes its manager (it opens a
    process group), and saves are collective."""

    def __init__(self, cfg: CheckpointConfig):
        from chronoedit_tpu_torch.utils.platform import multi_device_world

        self.cfg = cfg
        self.directory = os.path.abspath(cfg.directory)
        os.makedirs(self.directory, exist_ok=True)
        # saved steps, in-flight async saves included (Orbax counts those too)
        self._steps = sorted(int(d) for d in os.listdir(self.directory) if d.isdigit())
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        # a sharded save's barriers, on a group of their own (gloo: host-side)
        self._group = dist.new_group(backend="gloo") if multi_device_world() else None
        self._owned: tuple | None = None  # (the boxes it was computed for, the names)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Save ``state`` as ``step``; False (nothing written) when that
        step is already saved and ``force`` is not set. An async save
        returns once the tensors are on the host."""
        if step in self._steps and not force:
            return False
        self.wait_until_finished()
        tensors = state_tensors(state)
        boxes = state_boxes(state)
        if self._group is not None:
            mine = self._written(boxes)
            tensors = {k: t for k, t in tensors.items() if k in mine}
        host = _to_host(tensors)
        counters = state_counters(state)
        if step not in self._steps:
            self._steps.append(step)
            self._steps.sort()
        stale = self._steps[:-self.cfg.max_to_keep] if self.cfg.max_to_keep else []
        self._steps = [s for s in self._steps if s not in stale]
        if self._group is not None:
            tmp = self._path(step) + _TMP
            if dist.get_rank() == 0:
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp)
            dist.barrier(group=self._group)  # the directory is there for every rank

        def write():
            try:
                if self._group is None:
                    _write(self._path(step), host, counters)
                else:
                    self._write_sharded(step, host, {k: boxes[k] for k in host}, counters)
                if self._group is None or dist.get_rank() == 0:  # one rank removes them
                    for s in stale:
                        shutil.rmtree(self._path(s), ignore_errors=True)
            except BaseException as e:  # raised by wait_until_finished
                self._error = e

        if self.cfg.async_save:
            self._thread = threading.Thread(target=write, name=f"checkpoint-{step}")
            self._thread.start()
        else:
            write()
            self._raise()
        return True

    def _written(self, boxes: dict) -> set[str]:
        """The names this rank writes: those whose block no lower rank
        holds (one all-gather of every rank's blocks, kept while they stay
        the same)."""
        if self._owned is None or self._owned[0] != boxes:
            everyone: list = [None] * dist.get_world_size(self._group)
            dist.all_gather_object(everyone, {k: start for k, (_, start) in boxes.items()},
                                   group=self._group)
            lower = {(k, tuple(s)) for theirs in everyone[:dist.get_rank()]
                     for k, s in theirs.items()}
            self._owned = (boxes, {k for k, (_, s) in boxes.items()
                                   if (k, tuple(s)) not in lower})
        return self._owned[1]

    def _write_sharded(self, step: int, host: dict, boxes: dict, counters: dict) -> None:
        """This rank's part of a collective save: its file into the step's
        temporary directory, a barrier, rank 0's rename, a barrier."""
        path, rank = self._path(step), dist.get_rank()
        tmp = path + _TMP
        if host:
            _save_file(host, os.path.join(tmp, RANK_FILE.format(rank)),
                       {LAYOUT_KEY: json.dumps(boxes, separators=(",", ":"))})
        if rank == 0:
            with open(os.path.join(tmp, COUNTERS_FILE), "w") as f:
                json.dump(counters, f)
        dist.barrier(group=self._group)  # every rank's file is written
        if rank == 0:
            shutil.rmtree(path, ignore_errors=True)
            os.replace(tmp, path)
        dist.barrier(group=self._group)  # the step is in place for every rank

    def latest_step(self) -> int | None:
        return self._steps[-1] if self._steps else None

    def restore(self, template: Any, step: int | None = None) -> Any:
        """Copy the checkpoint of ``step`` (default the latest) into the live
        state ``template`` and return it; None when there is none. Each
        live tensor (this rank's block under a mesh) is read from the
        slices that hold it, whatever world or mesh wrote them."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        self.wait_until_finished()
        path = self._path(step)
        skip = set(self.cfg.keys_not_to_resume)
        live, boxes = state_tensors(template), state_boxes(template)
        with _Pieces(path) as pieces:
            for name, t in live.items():
                if name.split("/", 1)[0] in skip:
                    continue
                whole, start = boxes[name]
                with torch.no_grad():
                    t.copy_(pieces.read(name, whole, start, tuple(t.shape)))
        with open(os.path.join(path, COUNTERS_FILE)) as fc:
            counters = json.load(fc)
        if "step" not in skip:
            template.step = counters["step"]
        if "opt_state" not in skip:
            _restore_optimizer(template, live, counters)
        if self.cfg.load_ema_to_reg and template.ema_params is not None:
            with torch.no_grad():
                for p, e in zip(template.params, template.ema_params):
                    p.copy_(e)
        return template

    def _raise(self) -> None:
        err, self._error = self._error, None
        if err is not None:
            raise err

    def wait_until_finished(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise()

    def close(self) -> None:
        self.wait_until_finished()


def _restore_optimizer(state: Any, live: dict[str, torch.Tensor], counters: dict) -> None:
    """AdamW's per-parameter state from the restored moments (copied into
    the live tensors above, or made here when AdamW has not stepped yet)
    and the counters."""
    opt = state.optimizer
    opt.gradient_step = counters["gradient_step"]
    opt.mini_step = counters["mini_step"]
    for n, p in zip(_param_names(state), state.params):
        st = opt.adamw.state[p]
        for key in ("exp_avg", "exp_avg_sq"):
            if key not in st:
                st[key] = live[f"opt_state/{key}/{n}"]
        st["step"] = torch.tensor(float(opt.gradient_step))


def save_params(path: str, params: nn.Module | dict[str, torch.Tensor]) -> None:
    """One-shot save of a model's parameters (or a {name: tensor} dict) as
    ``<path>/params.safetensors``, e.g. exported or EMA weights."""
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    _write(os.path.abspath(path), _to_host(params), None)


def load_params(path: str, template: nn.Module | None = None, field: str = "params"):
    """The parameters :func:`save_params` wrote, or a step directory's
    ``field`` (``"params"`` or ``"ema_params"``; one-process or sharded),
    read tensor by tensor, whole: a {name: CPU tensor} dict, or copied into
    ``template``'s parameters of the same names and ``template``
    returned."""
    file = os.path.join(path, PARAMS_FILE)
    if os.path.exists(file):
        if field != "params":
            raise KeyError(f"{path} holds parameters alone, no {field}")
        prefix = ""
    else:
        prefix = f"{field}/"
    with _Pieces(path, None if prefix else [file]) as pieces:
        names = [k[len(prefix):] for k in pieces.index if k.startswith(prefix)]

        def whole(name):
            shape = pieces.whole_shape(prefix + name)
            return pieces.read(prefix + name, shape, (0,) * len(shape), shape)

        if template is None:
            return {n: whole(n) for n in names}
        named = dict(template.named_parameters())
        if set(named) != set(names):
            raise KeyError(f"{path}: other parameters than the template's")
        with torch.no_grad():
            for name, p in named.items():
                p.copy_(whole(name))
    return template
