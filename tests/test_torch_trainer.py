"""The port's Trainer, its checkpoints, callbacks and sanitizers against the
JAX package, on CPU, fp32, tiny preset.

- The ``Trainer`` against JAX's on the same numpy weights and batches, its
  step and validation functions wrapped to replay JAX's draws (JAX splits
  one key per micro-step and per validation, ``trainer.py:159``): per-step
  losses within 1e-4 relative, validation losses within 1e-4, the saves and
  the final parameters and EMA within the whole-step bounds of
  ``test_torch_train.py``; resume, resume under ``grad_accum``, the NaN
  rewind and abort, ``load_ema_to_reg``, ``data_time_s`` and the host-sync
  guard's wiring (``tests/test_trainer_loop.py``, ``tests/test_sanitize.py``).
- Checkpoints: a resumed run continues the uninterrupted one bitwise, also
  from the middle of an accumulation; ``keys_not_to_resume``; async saves
  and ``max_to_keep``; one-shot params.
- ``easy_io`` (a copy: same results as JAX's), the callbacks, ``sanitize``,
  and the single-process ``parallel`` helpers.

Two JAX ``Trainer`` scenarios run once per module (fixtures): a few
seconds of compiling each.
"""

import contextlib
import dataclasses
import gc
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chronoedit_tpu.configs import chronoedit_tiny as tiny_j
from chronoedit_tpu.core import rectified_flow as rf_j
from chronoedit_tpu.models import dit as dit_j
from chronoedit_tpu.train import TrainConfig as TrainConfigJ
from chronoedit_tpu.train.callbacks import Callback as CallbackJ
from chronoedit_tpu.train.checkpoint import CheckpointConfig as CheckpointConfigJ
from chronoedit_tpu.train.trainer import Trainer as TrainerJ
from chronoedit_tpu.train.trainer import TrainerConfig as TrainerConfigJ
from chronoedit_tpu.utils import easy_io as easy_io_j
from chronoedit_tpu_torch.configs import chronoedit_tiny as tiny_t
from chronoedit_tpu_torch.models import dit as dit_t
from chronoedit_tpu_torch.models.from_jax import load_dit
from chronoedit_tpu_torch.parallel import consistency, distributed
from chronoedit_tpu_torch.train import callbacks as cb_t
from chronoedit_tpu_torch.train import checkpoint as ck_t
from chronoedit_tpu_torch.train import lora_train as lt_t
from chronoedit_tpu_torch.train import train_step as ts_t
from chronoedit_tpu_torch.train.trainer import Trainer, TrainerConfig
from chronoedit_tpu_torch.utils import easy_io as easy_io_t
from chronoedit_tpu_torch.utils import sanitize
from test_torch_dit import randomize
from test_torch_train import _flat_by_name, _jax_draws

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LR = 1e-3
TCFG = dict(lr=LR, warmup_steps=1, grad_clip=1.0)


def _params():
    cfg_j = tiny_j().dit
    return randomize(lambda: dit_j.init_dit_params(jax.random.PRNGKey(0), cfg_j), 1)


def _data_np(seed=0, nan_from=None):
    """Endless numpy batches (``test_trainer_loop.py``'s ``_data``), NaN
    latents from batch ``nan_from`` on."""
    cfg = tiny_j().dit
    rng = np.random.default_rng(seed)
    i = 0
    while True:
        b = {"latents": rng.standard_normal((1, 4, 2, 4, 4)).astype(np.float32),
             "condition": rng.standard_normal((1, 6, 2, 4, 4)).astype(np.float32),
             "text_emb": rng.standard_normal((1, 6, cfg.text_dim)).astype(np.float32),
             "image_emb": rng.standard_normal((1, cfg.image_tokens, cfg.image_dim)
                                              ).astype(np.float32)}
        if nan_from is not None and i >= nan_from:
            b["latents"] = np.full_like(b["latents"], np.nan)
        i += 1
        yield b


def _data_t(seed=0, nan_from=None):
    for b in _data_np(seed, nan_from):
        yield {k: torch.from_numpy(v) for k, v in b.items()}


class Recorder(CallbackJ, cb_t.Callback):
    """Steps, losses, validation losses, saves and rewinds, on either side."""

    def __init__(self):
        self.steps, self.losses, self.val_losses, self.saves, self.rewinds = [], [], [], [], []

    def on_step_end(self, trainer, step, metrics):
        self.steps.append(step)
        self.losses.append(float(metrics["loss"]))
        if "val_loss" in metrics:
            self.val_losses.append(metrics["val_loss"])

    def on_checkpoint_save(self, trainer, step):
        self.saves.append(step)

    def on_unstable_rewind(self, trainer, step, restored_step):
        self.rewinds.append((step, restored_step))


def _run_j(tmp, tcfg, trainer_cfgs, nan_from=None):
    """JAX's Trainer over ``trainer_cfgs`` in turn (a resume each after the
    first), the same checkpoint directory; returns (recorders, the final
    params and EMA as numpy trees)."""
    cfg = tiny_j().dit
    params = _params()
    recs, state = [], None
    for tc in trainer_cfgs:
        rec = Recorder()
        trainer = TrainerJ(cfg, TrainConfigJ(**tcfg), TrainerConfigJ(**tc),
                           CheckpointConfigJ(directory=str(tmp / "ck"), async_save=False),
                           callbacks=[rec])
        state = trainer.init_state(jax.tree.map(jnp.asarray, params))
        val = _data_np(1) if tc.get("validate_every") else None
        state = trainer.train(state, _data_np(0, nan_from), val_data=val)
        recs.append(rec)
    return recs, jax.tree.map(np.asarray, state.params), jax.tree.map(np.asarray, state.ema_params)


class JaxDraws:
    """Replays JAX's Trainer draws into the port: one key split per micro-step
    (``key, sub = split(key)``) and per validation, whose batches split it
    again; each sub key gives ``velocity_loss``'s u and noise."""

    def __init__(self, trainer, validate_batches=0):
        self.key = jax.random.PRNGKey(0)
        self.val_key, self.val_left = None, 0
        self.validate_batches = validate_batches
        step = ts_t.make_train_step(trainer.dit_cfg, trainer.train_cfg)
        rf = trainer.train_cfg.rectified_flow
        rf_jax = rf_j.RectifiedFlowConfig()

        def step_fn(state, batch, generator):
            self.key, sub = jax.random.split(self.key)
            u, noise = _jax_draws(sub, batch["latents"].numpy(), rf_jax)
            return step(state, batch, u=u, noise=noise)

        def val_fn(state, batch, generator):
            if self.val_left == 0:
                self.key, self.val_key = jax.random.split(self.key)
                self.val_left = self.validate_batches
            self.val_key, sub = jax.random.split(self.val_key)
            self.val_left -= 1
            u, noise = _jax_draws(sub, batch["latents"].numpy(), rf_jax)
            return ts_t.velocity_loss(state.model, trainer.dit_cfg, rf, batch["latents"],
                                      batch["condition"], batch["text_emb"],
                                      batch["image_emb"], u, noise)

        trainer._step_fn, trainer._val_fn = step_fn, val_fn


def _run_t(tmp, tcfg, trainer_cfgs, nan_from=None, ck_kw=None):
    """The port's Trainer over the same scenario as ``_run_j``; returns
    (recorders, the final state)."""
    cfg = tiny_t().dit
    recs, state = [], None
    for tc in trainer_cfgs:
        rec = Recorder()
        trainer = Trainer(cfg, ts_t.TrainConfig(**tcfg), TrainerConfig(**tc),
                          ck_t.CheckpointConfig(directory=str(tmp / "ck"), **(ck_kw or {})),
                          callbacks=[rec])
        JaxDraws(trainer, tc.get("validate_batches", 4))
        state = trainer.init_state(load_dit(dit_t.DiT(cfg), _params()))
        val = _data_t(1) if tc.get("validate_every") else None
        state = trainer.train(state, _data_t(0, nan_from), val_data=val)
        recs.append(rec)
    return recs, state


def _assert_close(state, params_j, ema_j, applied_with_lr):
    """Parameters and EMA within ``test_torch_train.py``'s whole-step
    bounds: Adam's first updates are about lr * sign(g), so an entry whose
    gradient is near 0 may differ by 2 lr per update at a non-zero lr; all
    but a sliver agree to fp32 rounding (1e-6)."""
    want, want_ema = _flat_by_name(state.model, params_j), _flat_by_name(state.model, ema_j)
    bound = 2 * LR * applied_with_lr + 1e-6
    for (name, p), e in zip(state.model.named_parameters(), state.ema_params):
        for got, w in ((p.detach().numpy(), want[name]), (e.numpy(), want_ema[name])):
            diff = np.abs(got - w)
            assert diff.max() <= bound, (name, diff.max())
            assert np.mean(diff > 1e-6) <= 1e-3, (name, np.mean(diff > 1e-6))


# ----------------------------------------------------------- against JAX's Trainer

VAL_RESUME = [dict(max_iter=4, save_every=2, validate_every=2, validate_batches=2),
              dict(max_iter=6, save_every=10)]
ACCUM_RESUME = [dict(max_iter=3, save_every=3), dict(max_iter=5, save_every=10)]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return {
        "val_resume": _run_j(tmp_path_factory.mktemp("j1"), TCFG, VAL_RESUME),
        "accum_resume": _run_j(tmp_path_factory.mktemp("j2"), dict(TCFG, grad_accum=2),
                               ACCUM_RESUME),
    }


def test_trainer_with_validation_and_resume_matches_jax(jax_runs, tmp_path):
    """4 iterations with validation every 2 (2 batches) and saves at 2 and
    4, then a fresh trainer resumes at step 4 and runs to 6: the same
    steps, saves and resume point as JAX's, each step's loss and each
    validation loss within 1e-4 relative, the final parameters and EMA
    within the whole-step bounds (5 updates at a non-zero lr)."""
    (rec_j, rec2_j), params_j, ema_j = jax_runs["val_resume"]
    (rec, rec2), state = _run_t(tmp_path, TCFG, VAL_RESUME, ck_kw=dict(async_save=False))
    assert rec.steps == rec_j.steps == [0, 1, 2, 3] and rec.saves == rec_j.saves == [2, 4]
    assert rec2.steps == rec2_j.steps == [4, 5] and state.step == 6
    np.testing.assert_allclose(rec.losses + rec2.losses, rec_j.losses + rec2_j.losses,
                               rtol=1e-4)
    assert len(rec.val_losses) == 2
    np.testing.assert_allclose(rec.val_losses, rec_j.val_losses, rtol=1e-4)
    assert os.path.exists(tmp_path / "ck" / "config.json")
    _assert_close(state, params_j, ema_j, applied_with_lr=5)


def test_resume_with_grad_accum_matches_jax(jax_runs, tmp_path):
    """``grad_accum = 2``: 3 iterations are 6 micro-steps; the resumed trainer
    starts at iteration 3 (``step // grad_accum``), runs iterations 3 and 4
    and ends at micro-step 10, as JAX's; the iteration-averaged losses
    within 1e-4, the final parameters within the bounds (4 updates at a
    non-zero lr); the async saves (the default) land where the sync ones
    do."""
    (rec_j, rec2_j), params_j, ema_j = jax_runs["accum_resume"]
    (rec, rec2), state = _run_t(tmp_path, dict(TCFG, grad_accum=2), ACCUM_RESUME)
    assert rec2.steps == rec2_j.steps == [3, 4] and state.step == 10
    assert state.optimizer.gradient_step == 5 and state.optimizer.mini_step == 0
    np.testing.assert_allclose(rec.losses + rec2.losses, rec_j.losses + rec2_j.losses,
                               rtol=1e-4)
    assert sorted(os.listdir(tmp_path / "ck")) == ["3", "5", "config.json"]
    _assert_close(state, params_j, ema_j, applied_with_lr=4)


def test_nan_loss_rewinds_to_checkpoint(tmp_path):
    """After 2 consecutive non-finite losses the trainer restores the latest
    checkpoint (step 2, saved before the NaNs) instead of training on; the
    poisoned iterations are never saved. The same rewinds as JAX's."""
    scenario = [dict(max_iter=8, save_every=2, nan_abort_after=2)]
    (rec_j,), _, _ = _run_j(tmp_path / "j", TCFG, scenario, nan_from=3)
    (rec,), state = _run_t(tmp_path / "t", TCFG, scenario, nan_from=3,
                           ck_kw=dict(async_save=False))
    assert rec.rewinds and rec.rewinds == rec_j.rewinds
    assert rec.rewinds[0][1] == 2
    assert all(np.isfinite(p.detach().numpy()).all() for p in state.params)


def test_nan_loss_aborts_without_checkpoints():
    trainer = Trainer(tiny_t().dit, ts_t.TrainConfig(**TCFG),
                      TrainerConfig(max_iter=8, nan_abort_after=2))
    state = trainer.init_state(load_dit(dit_t.DiT(tiny_t().dit), _params()))
    with pytest.raises(RuntimeError, match="non-finite"):
        trainer.train(state, _data_t(0, nan_from=0))


def test_load_ema_to_reg(tmp_path):
    """``load_ema_to_reg`` restores the EMA weights into the parameters,
    bitwise, as copies (no aliasing)."""
    tcfg = dict(TCFG, lr=1e-2)
    trainer = Trainer(tiny_t().dit, ts_t.TrainConfig(**tcfg),
                      TrainerConfig(max_iter=3, save_every=3),
                      ck_t.CheckpointConfig(directory=str(tmp_path / "ck"), async_save=False))
    state = trainer.train(trainer.init_state(load_dit(dit_t.DiT(tiny_t().dit), _params())),
                          _data_t())
    saved_ema = [e.clone() for e in state.ema_params]
    assert not torch.equal(saved_ema[0], state.params[0])
    trainer2 = Trainer(tiny_t().dit, ts_t.TrainConfig(**tcfg), TrainerConfig(max_iter=3),
                       ck_t.CheckpointConfig(directory=str(tmp_path / "ck"),
                                             load_ema_to_reg=True))
    state2 = trainer2.init_state(load_dit(dit_t.DiT(tiny_t().dit), _params()))
    for p, e, saved in zip(state2.params, state2.ema_params, saved_ema):
        assert torch.equal(p, saved) and p.data_ptr() != e.data_ptr()


def test_data_speed_metric():
    """The trainer reports host data-fetch time and DataSpeedMonitor logs it."""
    seen, lines = [], []

    class Grab(cb_t.Callback):
        def on_step_end(self, trainer, step, metrics):
            seen.append(metrics.get("data_time_s"))

    trainer = Trainer(tiny_t().dit, ts_t.TrainConfig(**TCFG), TrainerConfig(max_iter=3),
                      callbacks=[Grab(), cb_t.DataSpeedMonitor(log_every=2,
                                                               log_fn=lines.append)])
    trainer.train(trainer.init_state(load_dit(dit_t.DiT(tiny_t().dit), _params())), _data_t())
    assert len(seen) == 3 and all(s is not None and s >= 0 for s in seen)
    assert lines and "data fetch" in lines[0]


def test_profiler_window_writes_a_trace(tmp_path):
    """``profile_start`` / ``profile_steps`` trace iterations [1, 2] with
    ``torch.profiler`` (JAX's window: start before iteration 1, stop after
    iteration 1 + 1) and write one Chrome trace to ``profile_dir``."""
    trainer = Trainer(tiny_t().dit, ts_t.TrainConfig(**TCFG),
                      TrainerConfig(max_iter=3, profile_start=1, profile_steps=1,
                                    profile_dir=str(tmp_path / "prof")))
    trainer.train(trainer.init_state(load_dit(dit_t.DiT(tiny_t().dit), _params())), _data_t())
    assert os.listdir(tmp_path / "prof") == ["trace_iter1.json"]
    events = json.loads((tmp_path / "prof" / "trace_iter1.json").read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    assert trainer._profiler is None


def test_trainer_guard_host_sync_wiring(monkeypatch):
    """``guard_host_sync`` wraps exactly the micro-step calls: the guard is
    entered once per micro-batch and not held around the deferred loss
    flush (``tests/test_sanitize.py``'s wiring test)."""
    entered, in_guard = [], []

    @contextlib.contextmanager
    def recording_guard():
        entered.append(True)
        yield
        entered.pop()

    monkeypatch.setattr(sanitize, "no_host_sync", recording_guard)
    flushed = []
    monkeypatch.setattr(torch, "isfinite", lambda t: flushed.append(bool(entered))
                        or torch.ones((), dtype=torch.bool))
    trainer = Trainer(tiny_t().dit, ts_t.TrainConfig(**TCFG, grad_accum=2),
                      TrainerConfig(max_iter=2, save_every=100, nan_abort_after=1,
                                    guard_host_sync=True))

    @dataclasses.dataclass
    class _State:
        model: torch.nn.Module
        step: int = 0

    def fake_step(state, batch, generator):
        in_guard.append(bool(entered))
        state.step += 1
        return {"loss": torch.tensor(0.5)}

    trainer._step_fn = fake_step
    state = trainer.train(_State(torch.nn.Linear(1, 1)), iter(dict, None))
    assert state.step == 4 and in_guard == [True] * 4
    assert flushed == [False, False] and not entered


def test_trainer_guard_off_by_default():
    assert TrainerConfig().guard_host_sync is False


# ----------------------------------------------------------- checkpoints

def _state_bits(state):
    """Every tensor of a train state (parameters, EMA, moments, accumulator)
    and its counters."""
    return ({k: v.clone() for k, v in ck_t.state_tensors(state).items()},
            ck_t.state_counters(state))


def _assert_bitwise(a, b):
    assert a[1] == b[1]
    assert a[0].keys() == b[0].keys()
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k


@pytest.mark.parametrize("async_save", [False, True])
def test_resume_continues_the_uninterrupted_run_bitwise(tmp_path, async_save):
    """4 iterations (``grad_accum = 2``) straight, against 2, then a fresh
    trainer restoring the checkpoint and running 2 more: every parameter,
    EMA, moment and accumulator entry and every counter bitwise equal (the
    port seeds each micro-step's draws from the micro-step count)."""
    tcfg, cfg = ts_t.TrainConfig(**TCFG, grad_accum=2), tiny_t().dit

    def run(directory, max_iter):
        trainer = Trainer(cfg, tcfg, TrainerConfig(max_iter=max_iter, save_every=2),
                          ck_t.CheckpointConfig(directory=str(directory),
                                                async_save=async_save))
        state = trainer.init_state(load_dit(dit_t.DiT(cfg), _params()))
        data = _data_t()
        for _ in range(state.step):  # the batches the restored steps consumed
            next(data)
        return trainer.train(state, data)

    straight = _state_bits(run(tmp_path / "a", 4))
    run(tmp_path / "b", 2)
    _assert_bitwise(_state_bits(run(tmp_path / "b", 4)), straight)


def _lora_state(accum):
    from chronoedit_tpu_torch.models import lora as lora_t

    cfg = tiny_t().dit
    base = load_dit(dit_t.DiT(cfg), _params())
    lora = lora_t.init_lora_params(torch.Generator().manual_seed(2), base,
                                   lora_t.LoRAConfig(rank=2))
    tcfg = ts_t.TrainConfig(**TCFG, grad_accum=accum)
    return base, lt_t.make_lora_train_state(lora, tcfg), lt_t.make_lora_train_step(cfg, tcfg)


def test_restore_mid_accumulation_is_bitwise(tmp_path):
    """A LoRA state saved after 3 micro-steps of ``grad_accum = 2`` (one in
    its accumulator) and restored into a fresh state continues bitwise
    where the saved one goes: 3 more micro-steps on both."""
    base, state, step = _lora_state(2)
    batches = list(zip(range(6), _data_t()))
    for i, b in batches[:3]:
        step(state, base, b, torch.Generator().manual_seed(i))
    assert state.optimizer.mini_step == 1
    mgr = ck_t.CheckpointManager(ck_t.CheckpointConfig(directory=str(tmp_path),
                                                       async_save=False))
    mgr.save(3, state)
    _, fresh, _ = _lora_state(2)
    assert mgr.restore(fresh) is fresh and fresh.step == 3
    _assert_bitwise(_state_bits(fresh), _state_bits(state))
    for s in (state, fresh):
        for i, b in batches[3:]:
            step(s, base, b, torch.Generator().manual_seed(i))
    _assert_bitwise(_state_bits(fresh), _state_bits(state))


def test_keys_not_to_resume_and_max_to_keep(tmp_path):
    """``keys_not_to_resume`` keeps the live values of whole fields (here the
    EMA and the micro-step count) and restores the rest bitwise;
    ``max_to_keep`` keeps the newest steps; ``latest_step`` reads the
    directory anew; a half-written save (its temporary name) is not a
    step."""
    base, state, step = _lora_state(1)
    for i, b in zip(range(2), _data_t()):
        step(state, base, b, torch.Generator().manual_seed(i))
    cfg = ck_t.CheckpointConfig(directory=str(tmp_path), max_to_keep=2,
                                keys_not_to_resume=("ema_params", "step"))
    mgr = ck_t.CheckpointManager(cfg)
    for s in (1, 2, 3):
        assert mgr.save(s, state)
    assert not mgr.save(3, state)
    mgr.wait_until_finished()
    os.makedirs(tmp_path / ("7" + ck_t._TMP))
    assert sorted(os.listdir(tmp_path)) == ["2", "3", "7.tmp"]
    assert ck_t.CheckpointManager(cfg).latest_step() == 3
    _, fresh, _ = _lora_state(1)
    ema_before = [e.clone() for e in fresh.ema_params]
    ck_t.CheckpointManager(cfg).restore(fresh)
    assert fresh.step == 0 and fresh.optimizer.gradient_step == 2
    for p, q in zip(fresh.params, state.params):
        assert torch.equal(p, q)
    for e, before in zip(fresh.ema_params, ema_before):
        assert torch.equal(e, before)


def test_checkpoint_files_are_safetensors(tmp_path):
    """The checkpoint's own writer (plain ``write`` calls) makes files that
    ``safetensors`` reads back bitwise, for every dtype a state holds, a 0-d
    and an empty tensor among them, and whose bytes equal the
    ``safetensors`` package's own file of the same tensors, header
    aside."""
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(0)
    tensors = {"a/bf16": torch.randn((3, 5), generator=g).bfloat16(),
               "b/f32": torch.randn((7,), generator=g), "c/i8": torch.arange(-4, 4).to(torch.int8),
               "d/scalar": torch.tensor(2.5), "e/empty": torch.zeros((0, 3)),
               "f/i64": torch.arange(3)}
    ck_t._save_file(tensors, str(tmp_path / "mine.safetensors"))
    back = load_file(str(tmp_path / "mine.safetensors"))
    assert back.keys() == tensors.keys()
    for k, t in tensors.items():
        assert back[k].dtype == t.dtype and torch.equal(back[k], t), k
    save_file(tensors, str(tmp_path / "theirs.safetensors"))
    theirs = load_file(str(tmp_path / "theirs.safetensors"))
    for k in tensors:
        assert torch.equal(theirs[k], back[k]), k


def test_save_and_load_params(tmp_path):
    """One-shot params: bitwise into a dict or a template; a step
    directory's ``params`` / ``ema_params`` read the same way."""
    model = load_dit(dit_t.DiT(tiny_t().dit), _params())
    ck_t.save_params(str(tmp_path / "p"), model)
    got = ck_t.load_params(str(tmp_path / "p"))
    for name, p in model.named_parameters():
        assert torch.equal(got[name], p.detach())
    other = dit_t.init_dit_params(tiny_t().dit, torch.Generator().manual_seed(9))
    ck_t.load_params(str(tmp_path / "p"), other)
    for p, q in zip(other.parameters(), model.parameters()):
        assert torch.equal(p, q)
    with pytest.raises(KeyError):
        ck_t.load_params(str(tmp_path / "p"), field="ema_params")


# ----------------------------------------------------------- easy_io, callbacks

class _FakeS3Client:
    """The boto3 client subset ``S3Backend`` uses, in memory."""

    def __init__(self):
        self.store = {}

    def put_object(self, Bucket, Key, Body):
        self.store[(Bucket, Key)] = bytes(Body)

    def get_object(self, Bucket, Key):
        import io

        if (Bucket, Key) not in self.store:
            raise KeyError(Key)
        return {"Body": io.BytesIO(self.store[(Bucket, Key)])}

    def head_object(self, Bucket, Key):
        if (Bucket, Key) not in self.store:
            raise KeyError(Key)
        return {}

    def list_objects_v2(self, Bucket, Prefix, ContinuationToken=None):
        keys = sorted(k for (b, k) in self.store if b == Bucket and k.startswith(Prefix))
        return {"Contents": [{"Key": k} for k in keys]}


@pytest.mark.parametrize("fmt", ["json", "jsonl", "npy", "npz", "pkl", "txt"])
def test_easy_io_round_trips_as_jax(tmp_path, fmt):
    """The port's copy writes the bytes JAX's writes and reads them back as
    JAX's does, locally and through an S3 client."""
    obj = {"json": {"a": 1, "b": [2, 3]}, "jsonl": None, "npy": np.arange(4),
           "npz": {"w": np.ones(2)}, "pkl": [1, 2, 3], "txt": "hello"}[fmt]
    if fmt == "jsonl":
        (tmp_path / "x.jsonl").write_text('{"a": 1}\n\n{"b": 2}\n')
        assert easy_io_t.load(str(tmp_path / "x.jsonl")) == [{"a": 1}, {"b": 2}]
        return
    for mod, name in ((easy_io_t, "t"), (easy_io_j, "j")):
        mod.dump(obj, str(tmp_path / f"{name}.{fmt}"))
    assert (tmp_path / f"t.{fmt}").read_bytes() == (tmp_path / f"j.{fmt}").read_bytes()
    got = easy_io_t.load(str(tmp_path / f"t.{fmt}"))
    if fmt == "npz":
        np.testing.assert_array_equal(got["w"], obj["w"])
    elif fmt == "npy":
        np.testing.assert_array_equal(got, obj)
    else:
        assert got == obj
    easy_io_t.set_s3_client(_FakeS3Client())
    try:
        easy_io_t.dump(obj, f"s3://bkt/job/x.{fmt}")
        assert easy_io_t.exists(f"s3://bkt/job/x.{fmt}")
        assert easy_io_t.list_dir_or_file("s3://bkt/job") == [f"job/x.{fmt}"]
    finally:
        easy_io_t.set_s3_client(None)


def test_easy_io_backends_and_errors():
    store = {}
    easy_io_t.register_backend("mem", store.__getitem__, lambda p, d: store.__setitem__(p, d))
    easy_io_t.dump({"k": "v"}, "mem://box.json")
    assert easy_io_t.load("mem://box.json") == {"k": "v"}
    assert not easy_io_t.exists("mem://nope.json")
    with pytest.raises(ValueError):
        easy_io_t.get("s3missing://x")
    with pytest.raises(ValueError):
        easy_io_t.dump(1, "/tmp/x.unknown")


class _T:
    pass


def test_device_monitor_callback_without_a_card():
    """Without a CUDA device it logs that memory is not measured, and no
    number."""
    lines = []
    cb_t.DeviceMonitorCallback(every_n=1, log_fn=lines.append).on_step_end(_T(), 0, {})
    assert lines == ["[device cpu] no CUDA device: memory not measured"]


def test_simple_callbacks(tmp_path):
    """Manual GC, the wandb no-op, the heartbeat through an easy_io URI, the
    loss logger's JSONL and unstable count, the iteration speed line, the
    step watchdog."""
    cb = cb_t.ManualGarbageCollection(every_n=1)
    cb.on_train_start(_T())
    assert not gc.isenabled()
    cb.on_step_end(_T(), 1, {})
    cb.on_train_end(_T())
    assert gc.isenabled()

    wandb = cb_t.WandbCallback()
    wandb.on_train_start(_T())
    wandb.on_step_end(_T(), 0, {"loss": 1.0})
    wandb.on_train_end(_T())

    easy_io_t.set_s3_client(_FakeS3Client())
    try:
        cb_t.HeartbeatCallback(path="s3://bkt/job/heartbeat.txt", every_s=0.0).on_step_end(
            None, 7, {})
        assert "step=7" in easy_io_t.get("s3://bkt/job/heartbeat.txt").decode()
    finally:
        easy_io_t.set_s3_client(None)

    log = cb_t.LossLoggerCallback(str(tmp_path / "m" / "loss.jsonl"), log_every=1)
    log.on_train_start(_T())
    log.on_step_end(_T(), 0, {"loss": torch.tensor(0.25), "grad_norm": torch.tensor(2.0)})
    log.on_step_end(_T(), 1, {"loss": torch.tensor(float("nan"))})
    log.on_train_end(_T())
    first = json.loads((tmp_path / "m" / "loss.jsonl").read_text().splitlines()[0])
    assert first == {"step": 0, "loss": 0.25, "grad_norm": 2.0} and log.unstable_count == 1

    lines = []
    speed = cb_t.IterSpeedCallback(log_every=2, log_fn=lines.append)
    speed.on_train_start(_T())
    speed.on_step_end(_T(), 2, {"loss": torch.tensor(0.5)})
    assert "it/s" in lines[0] and "loss=0.5000" in lines[0]

    dog = cb_t.StepTimeoutWatchdog(timeout_s=0.0)
    dog.on_step_start(_T(), 0)
    with pytest.raises(TimeoutError):
        dog.on_step_end(_T(), 0, {})


def test_straggler_replica_param_stats_and_samples(tmp_path):
    """One process: the straggler detector's own gather is this process
    alone and never fires; an injected fleet makes it raise after
    ``max_consecutive`` reports. Replica consistency finds no divergence.
    Parameter stats log the global and per-module norms; the sampler writes
    its image through the port's ``visualize``."""
    lone = cb_t.StragglerDetector(every_n=1)
    for s in range(3):
        lone.on_step_start(_T(), s)
        lone.on_step_end(_T(), s, {})
    lines = []
    slow = cb_t.StragglerDetector(every_n=1, max_consecutive=2, log_fn=lines.append,
                                  gather_fn=lambda v: np.asarray([v, 1e-9, 1e-9]))
    with pytest.raises(RuntimeError, match="straggler"):
        for s in range(1, 4):
            slow.on_step_start(_T(), s)
            slow.on_step_end(_T(), s, {})
    assert len(lines) == 2

    model = load_dit(dit_t.DiT(tiny_t().dit), _params())
    state = ts_t.make_train_state(model, ts_t.TrainConfig())
    trainer = _T()
    trainer._last_state = state
    cb_t.ReplicaConsistencyCallback(every_n=1).on_step_end(trainer, 0, {})
    stats = []
    cb_t.ParamStatsCallback(every_n=1, log_fn=stats.append).on_step_end(trainer, 1, {})
    total = float(torch.sqrt(sum(p.detach().square().sum() for p in model.parameters())))
    assert stats[0].startswith(f"[params @ 1] |θ|={total:.3e}") and "blocks=" in stats[0]

    cb_t.EveryNDrawSample(1, lambda params, g: np.zeros((3, 1, 8, 8), np.float32),
                          out_dir=str(tmp_path / "s"), guidance_sweep=(2.0,)).on_step_end(
        trainer, 1, {})
    assert os.listdir(tmp_path / "s") == ["iter0000001_g2.png"]


# ----------------------------------------------------------- sanitize, parallel

def test_no_host_sync_is_vacuous_on_the_cpu_and_restores():
    """No CUDA device: reads pass (as JAX's guard on its CPU backend), the
    wrapped call's result comes back, and an error inside leaves nothing
    set."""
    x = torch.ones(4)
    with sanitize.no_host_sync():
        assert float(x.sum()) == 4.0
    assert torch.equal(sanitize.assert_no_host_sync(torch.mul, x, 2.0), 2 * x)
    with pytest.raises(ValueError):
        with sanitize.no_host_sync():
            raise ValueError("inner failure")
    assert float(x.sum()) == 4.0


def test_no_host_sync_sets_and_restores_the_debug_mode(monkeypatch):
    """With a CUDA device the guard is CUDA's sync debug mode "error" for
    the block, the previous mode restored after it (read through a
    stand-in for the card)."""
    modes = [0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    with sanitize.no_host_sync():
        assert modes[-1] == "error"
    assert modes == [0, "error", 0]


def test_debug_numerics_raises_at_the_first_nonfinite_op():
    """The forward's first NaN raises at its operator (``div``), before any
    later op; so does the backward's first (a finite forward whose gradient
    overflows); finite work passes, and the mode is off after the block."""
    zero = torch.zeros(())
    with pytest.raises(FloatingPointError, match="div"):
        with sanitize.debug_numerics():
            (zero / zero).exp()
    x = torch.tensor([0.0], requires_grad=True)
    y = torch.sqrt(x)  # finite forward, infinite gradient at 0
    with pytest.raises(FloatingPointError):
        with sanitize.debug_numerics():
            y.backward()
    with sanitize.debug_numerics():
        assert float((torch.ones(2) * 3).sum()) == 6.0
    assert bool(torch.isnan(zero / zero))


def test_single_process_helpers(monkeypatch):
    """``init_distributed`` is a no-op without a launcher's world (and at
    WORLD_SIZE=1), raises for more without a launcher's rendezvous (the
    multi-process world itself is ``test_torch_consistency.py``'s); one
    process is primary, its metrics come back as floats; no replica
    disagrees; ``tree_digest`` is deterministic and sees a changed bit."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert distributed.init_distributed() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert distributed.init_distributed() is False
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        distributed.init_distributed()
    assert distributed.is_primary() and distributed.local_batch_size(4) == 4
    assert distributed.collate_metrics({"val_loss": torch.tensor(0.5)}) == {"val_loss": 0.5}
    model = load_dit(dit_t.DiT(tiny_t().dit), _params())
    state = ts_t.make_train_state(model, ts_t.TrainConfig())
    assert consistency.check_replica_consistency(state) == []
    digest = consistency.tree_digest(state)
    assert digest == consistency.tree_digest(state)
    with torch.no_grad():
        state.ema_params[0].view(-1)[0] += 1.0
    assert consistency.tree_digest(state) != digest
