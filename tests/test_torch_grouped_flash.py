"""The grouped flash kernels' wrappers and experiment tools against the JAX
package's experiments, on CPU.

X1 (the grouped forward) against JAX ``tools/exp_flash_paired.py``
``paired_flash`` and X2 (the grouped backward) against JAX
``tools/exp_flash_bwd_grouped.py`` ``grouped_backward``, both running their
Pallas kernels in interpret mode. On CPU tensors the port's wrappers run
the plain twins at every group, so these hold the function the kernels
compute; which kernel a CUDA tensor would launch is held with a recording
stand-in for the kernel library on meta tensors. Inputs are numpy, fixed
seeds, fp32.
"""

import importlib.util
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from chronoedit_tpu.ops import flash_attention as fa_j
from chronoedit_tpu_torch.kernels import build
from chronoedit_tpu_torch.ops import flash_attention as fa_t
from chronoedit_tpu_torch.tools import exp_flash_bwd_grouped as xb_t
from chronoedit_tpu_torch.tools import exp_flash_paired as xp_t
from test_torch_dit import warm_cpu_math

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SCALE = 128 ** -0.5
CPU = torch.device("cpu")


CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
CACHE_BEFORE = {key: getattr(jax.config, key) for key in CACHE_KEYS}


def _load_jax_tool(name: str):
    """``tools/<name>.py`` (not a package) as a module. Importing it sets
    JAX's persistent compilation cache for the whole process and creates
    its directory; both are undone here: the directory is never made and
    the two settings are restored."""
    before = {key: getattr(jax.config, key) for key in CACHE_KEYS}
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    with mock.patch("os.makedirs"):
        spec.loader.exec_module(module)
    for key, value in before.items():
        jax.config.update(key, value)
    return module


xp_j = _load_jax_tool("exp_flash_paired")
xb_j = _load_jax_tool("exp_flash_bwd_grouped")


@pytest.fixture(scope="module", autouse=True)
def _warm():
    warm_cpu_math()


def _arrays(s, seed, count=3, heads=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, s, heads, 128)).astype(np.float32) for _ in range(count)]


def test_loading_the_jax_tools_leaves_the_jax_cache_settings():
    """The tools' import-time cache settings were rolled back to what the
    process had before this module loaded them."""
    assert {key: getattr(jax.config, key) for key in CACHE_KEYS} == CACHE_BEFORE


@pytest.mark.parametrize("s,n", [(300, 2), (300, 3), (384, 2), (384, 3)])
def test_grouped_forward_matches_jax_paired_flash(s, n):
    """``flash_attention_with_lse(..., group=n)`` (X1's function) against
    JAX ``paired_flash`` with n 128-row KV blocks a step, 2e-5 (the bound
    of JAX's own grouped-kernel test, ``tests/test_parallel.py``): 300
    tokens are ragged for both groups; 384 pads to 512 at n = 2 (a masked
    group) and is an exact multiple at n = 3, as in that test."""
    q, k, v = _arrays(s, seed=s + n)
    want = xp_j.paired_flash(q, k, v, SCALE, block_q=128, block_kv=128, n=n)
    out, lse = fa_t.flash_attention_with_lse(*map(torch.from_numpy, (q, k, v)), SCALE, group=n)
    assert out.shape == want.shape and lse.shape == (1, s, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5)


def _jax_run_shape_buffers(s, seed, block=128, max_mult=4):
    """JAX's ``run_shape`` inputs at S = s: the forward's padded residuals,
    then every buffer padded to ``max_mult`` blocks and lse = +inf on the
    padded q rows. Returns (numpy q, k, v, dO, the JAX buffers, out, lse)."""
    q, k, v, g = _arrays(s, seed, count=4)
    out, (qb, kb, vb, ob, lse) = fa_j._flash_fwd_res(q, k, v, SCALE, block, block)
    dob = fa_j._pad_to(fa_j._to_bh(g), 1, block)
    qb, dob, ob = (fa_j._pad_to(x, 1, max_mult * block) for x in (qb, dob, ob))
    kb, vb = (fa_j._pad_to(x, 1, max_mult * block) for x in (kb, vb))
    lse = fa_j._pad_to(lse, 2, max_mult * block)
    lse = np.where(np.arange(lse.shape[2])[None, None, :] < s, np.asarray(lse), np.inf)
    return (q, k, v, g), (qb, kb, vb, ob, dob, lse), np.array(out), lse


@pytest.mark.parametrize("n_dq,n_dkv", [(2, 1), (1, 2), (2, 2), (4, 1), (4, 4), (2, 4)])
def test_grouped_backward_matches_jax_grouped_backward(n_dq, n_dkv):
    """``flash_attention_bwd(..., group_dq, group_dkv)`` (X2's function)
    against JAX ``grouped_backward`` on the buffers its ``run_shape``
    builds (300 tokens padded to 4 blocks of 128: masked KV columns and
    +inf-lse q rows), from the same O and LSE: 2e-4 on O(1) gradients, the
    bound of ``tests/test_parallel.py``'s flash backward check."""
    s = 300
    (q, k, v, g), bufs, out, lse = _jax_run_shape_buffers(s, seed=7)
    want = xb_j.grouped_backward(*bufs, SCALE, 128, 128, s, n_dq=n_dq, n_dkv=n_dkv)
    lse_bsh = lse[:, 0, :s].reshape(1, 2, s).transpose(0, 2, 1)
    got = fa_t.flash_attention_bwd(*map(torch.from_numpy, (q, k, v, out, g, lse_bsh)), SCALE,
                                   group_dq=n_dq, group_dkv=n_dkv)
    for grad, w in zip(got, want):
        w = np.asarray(fa_j._from_bh(w, 1, 2, s))
        assert grad.shape == w.shape
        np.testing.assert_allclose(grad.numpy(), w, atol=2e-4)


@pytest.mark.parametrize("call", ["fwd 0", "fwd 5", "bwd dq 3", "bwd dkv 0", "bwd dkv 8"])
def test_invalid_group_raises(call):
    """Groups outside (1, 2, 3, 4) (forward) and (1, 2, 4) (each backward
    side) raise on the CPU too, before any work."""
    q, k, v = (torch.zeros(1, 8, 1, 128) for _ in range(3))
    what, *rest, value = call.split()
    with pytest.raises(ValueError, match="group"):
        if what == "fwd":
            fa_t.flash_attention_with_lse(q, k, v, SCALE, group=int(value))
        else:
            fa_t.flash_attention_bwd(q, k, v, q, q, torch.zeros(1, 8, 1), SCALE,
                                     **{f"group_{rest[0]}": int(value)})


class _RecordingLib:
    """Stands in for the kernel library: records each entry point's name
    and its argument before the stream (a grouped entry point's group) and
    reports success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args[-2])) or 0


@pytest.fixture
def recording(monkeypatch):
    lib = _RecordingLib()
    monkeypatch.setattr(build, "lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(build, "LAUNCHES", dict.fromkeys(build.LAUNCHES, 0))
    monkeypatch.setattr(build, "SHAPE_LAUNCHES", {k: {} for k in build.SHAPE_LAUNCHES})
    return lib


def _meta(s):
    return torch.empty((1, s, 2, 128), device="meta", dtype=torch.bfloat16)


def test_device_tensors_launch_x1_only_when_grouped(recording):
    """Off the CPU, group 1 launches K1/K5 (``flash_fwd_bf16``) and 2-4
    launch X1 (``flash_fwd_grouped_bf16``, the group passed on), counted
    apart by name and KV length."""
    q, kv = _meta(40), _meta(257)
    for group in (1, 2, 3, 4):
        fa_t.flash_attention_with_lse(q, kv, kv, SCALE, group=group)
    assert [c[0] for c in recording.calls] == ["flash_fwd_bf16"] + ["flash_fwd_grouped_bf16"] * 3
    assert [c[1] for c in recording.calls[1:]] == [2, 3, 4]
    assert build.LAUNCHES["flash_fwd"] == 1 and build.LAUNCHES["flash_fwd_grouped"] == 3
    assert build.SHAPE_LAUNCHES["flash_fwd_grouped"] == {257: 3}


@pytest.mark.parametrize("groups,need,want", [
    ((1, 1), (True, True), [("flash_bwd_dq_bf16", None), ("flash_bwd_dkv_bf16", None)]),
    ((2, 1), (True, True), [("flash_bwd_dq_grouped_bf16", 2), ("flash_bwd_dkv_bf16", None)]),
    ((1, 2), (True, True), [("flash_bwd_dq_bf16", None), ("flash_bwd_dkv_grouped_bf16", 2)]),
    ((4, 4), (True, True), [("flash_bwd_dq_grouped_bf16", 4), ("flash_bwd_dkv_grouped_bf16", 4)]),
    ((1, 4), (True, False), [("flash_bwd_dq_bf16", None)]),
    ((4, 2), (False, True), [("flash_bwd_dkv_grouped_bf16", 2)]),
])
def test_device_tensors_launch_x2_for_each_grouped_side(recording, groups, need, want):
    """Off the CPU, each backward side runs on its own group: group 1 is K6
    (dQ) or K7 (dK, dV), 2 or 4 that side's X2 kernel with the group passed
    on, each only when its gradients are asked for."""
    q, kv = _meta(40), _meta(512)
    lse = torch.empty((1, 40, 2), device="meta")
    fa_t.flash_attention_bwd(q, kv, kv, q, q, lse, SCALE, need_dq=need[0], need_dkv=need[1],
                             group_dq=groups[0], group_dkv=groups[1])
    assert [(name, group if "grouped" in name else None)
            for name, group in recording.calls] == want
    for name, _ in want:
        launch = name[:-len("_bf16")]
        assert build.LAUNCHES[launch] == 1 and build.SHAPE_LAUNCHES[launch] == {512: 1}


def test_paired_tool_main_on_cpu(capsys):
    """The port's ``exp_flash_paired.main`` with ``device=cpu`` at a tiny
    shape: every group checked (the twin at each: no error) and no time
    measured."""
    results = xp_t.main(B=1, S=100, H=2, device=CPU)
    assert sorted(results) == [1, 2, 3, 4]
    for r in results.values():
        assert r["ms"] is None and r["err_vs_plain"] == 0.0 and r["err_vs_group1"] == 0.0
    assert "not measured" in capsys.readouterr().out


def test_bwd_grouped_tool_main_on_cpu(capsys):
    """The port's ``exp_flash_bwd_grouped.main`` with ``device=cpu``:
    ``--shapes`` picks the shapes, every JAX variant runs and agrees with
    production, and no time is measured."""
    results = xb_t.main(["--shapes", "edit"], device=CPU, B=1, H=2,
                        tokens={"edit": 60, "reasoning": 90})
    assert list(results) == ["edit"]
    assert list(results["edit"]) == list(xb_t.VARIANTS)
    for r in results["edit"].values():
        assert r["ms"] is None and r["dq"] == r["dk"] == r["dv"] == 0.0
        assert 0.0 <= r["twin"] < 1e-2
    out = capsys.readouterr().out
    assert "S=60" in out and "S=90" not in out and "not measured" in out


@pytest.mark.parametrize("s,want", [
    (7200, [(0, 128), (3584, 3712), (7168, 7200)]),
    (28800, [(0, 128), (14336, 14464), (28672, 28800)]),
    (200, [(0, 128), (128, 200)]),
])
def test_bwd_tool_samples_the_first_middle_and_last_tile(s, want):
    """The backward tool's twin check reads the first, the middle and the
    last 128-row tile, the last one ragged at 7,200 tokens."""
    rows = xb_t.sample_rows(s)
    assert rows.tolist() == [r for a, b in want for r in range(a, b)]


@pytest.mark.parametrize("s", [300, 384])
def test_bwd_tool_sampled_twin_is_the_whole_twin_on_its_rows(s):
    """``sampled_twin`` (dQ from the sampled q rows, dK and dV from the
    sampled KV rows) equals the whole fp32 twin's rows, at B = 2 so that
    the second batch's rows are read too; 1e-5 on O(1) fp32 gradients (the
    products are summed in other blocks)."""
    rng = np.random.default_rng(s)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal((2, s, 2, 128)).astype(np.float32))
                     for _ in range(4))
    out, lse = fa_t.flash_attention_with_lse(q, k, v, SCALE)
    rows = xb_t.sample_rows(s)
    whole = fa_t.flash_attention_bwd_plain(q, k, v, out, dout, lse, SCALE)
    for got, want in zip(xb_t.sampled_twin(q, k, v, out, dout, lse, SCALE, rows), whole):
        torch.testing.assert_close(got, want[:, rows], rtol=0, atol=1e-5)
