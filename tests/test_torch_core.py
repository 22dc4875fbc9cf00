"""The port's core math (schedule, RoPE, UniPC) against the JAX package.

Inputs are made with numpy from fixed seeds and fed to both packages in
fp32; each comparison states its tolerance and why.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chronoedit_tpu.core import rope as rope_j
from chronoedit_tpu.core import schedule as sched_j
from chronoedit_tpu.core import unipc as unipc_j
from chronoedit_tpu_torch.core import rope as rope_t
from chronoedit_tpu_torch.core import schedule as sched_t
from chronoedit_tpu_torch.core import unipc as unipc_t

torch.set_num_threads(2)


@pytest.mark.parametrize("num_steps", [3, 8, 20])
@pytest.mark.parametrize("shift", [2.0, 5.0])
def test_schedule_matches_jax(num_steps, shift):
    """Both are float64 numpy on the same formulas: bitwise equal, floored
    model timesteps included."""
    a = sched_j.make_flow_schedule(num_steps, shift=shift)
    b = sched_t.make_flow_schedule(num_steps, shift=shift)
    np.testing.assert_array_equal(a.sigmas, b.sigmas)
    np.testing.assert_array_equal(a.timesteps, b.timesteps)
    np.testing.assert_array_equal(a.model_timesteps(), b.model_timesteps())


@pytest.mark.parametrize("skip", [False, True])
def test_rope_tables_match_jax(skip):
    """Both cast the same float64 host tables to fp32: bitwise equal."""
    spec_j = rope_j.Rope3DSpec(head_dim=128, temporal_skip_len=8)
    spec_t = rope_t.Rope3DSpec(head_dim=128, temporal_skip_len=8)
    fj = rope_j.temporal_skip_rope_tables if skip else rope_j.rope_3d_tables
    ft = rope_t.temporal_skip_rope_tables if skip else rope_t.rope_3d_tables
    for got, want in zip(ft(spec_t, 2, 3, 5), fj(spec_j, 2, 3, 5)):
        assert got.dtype == torch.float32 and tuple(got.shape) == (30, 64)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_temporal_skip_positions():
    """A 2-frame grid sits at temporal positions (0, 7): its second frame's
    temporal band equals frame 7 of a plain 8-frame grid."""
    spec = rope_t.Rope3DSpec(head_dim=128, temporal_skip_len=8)
    cos_s, _ = rope_t.temporal_skip_rope_tables(spec, 2, 2, 2)
    cos_p, _ = rope_t.rope_3d_tables(spec, 8, 2, 2)
    np.testing.assert_array_equal(cos_s[4:].numpy(), cos_p[7 * 4:].numpy())


def test_apply_rope_matches_jax():
    """Same fp32 rotation of interleaved pairs; only op order can differ,
    so 1e-6 on O(1) values."""
    rng = np.random.default_rng(0)
    spec = rope_t.Rope3DSpec(head_dim=128)
    cos, sin = rope_t.temporal_skip_rope_tables(spec, 2, 3, 4)
    x = rng.standard_normal((1, 24, 2, 128)).astype(np.float32)
    want = rope_j.apply_rope(jnp.asarray(x), jnp.asarray(cos.numpy())[:, None],
                             jnp.asarray(sin.numpy())[:, None])
    got = rope_t.apply_rope(torch.from_numpy(x), cos[:, None], sin[:, None])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("num_steps", [3, 8, 20])
def test_unipc_coeffs_match_jax(num_steps):
    """Host float64 arithmetic in the same order: bitwise equal."""
    sched = sched_t.make_flow_schedule(num_steps, shift=2.0)
    a = unipc_j.make_unipc_coeffs(sched_j.make_flow_schedule(num_steps, shift=2.0))
    b = unipc_t.make_unipc_coeffs(sched)
    for name in a.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name), err_msg=name)


def test_unipc_steps_match_jax_and_recover_data():
    """8 UniPC steps on the analytic field v = noise - data. Both run fp32
    state with float32-rounded coefficients, so they agree to 1e-6; a
    correct sampler recovers data from pure noise (max error < 1e-2)."""
    rng = np.random.default_rng(1)
    noise = rng.standard_normal((1, 4, 2, 6, 6)).astype(np.float32)
    data = rng.standard_normal((1, 4, 2, 6, 6)).astype(np.float32)
    sched = sched_t.make_flow_schedule(8, shift=2.0)
    coeffs = unipc_t.make_unipc_coeffs(sched)
    rows = unipc_j.make_unipc_coeffs(sched_j.make_flow_schedule(8, shift=2.0)).stacked()

    st_j = unipc_j.UniPCState.init(jnp.asarray(noise))
    for i in range(8):
        st_j = unipc_j.unipc_step(st_j, rows[i], jnp.asarray(noise - data))
    st_t = unipc_t.UniPCState.init(torch.from_numpy(noise))
    v = torch.from_numpy(noise - data)
    for row in coeffs.rows():
        st_t = unipc_t.unipc_step(st_t, row, v)
    for got, want in zip(st_t, st_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert np.abs(st_t.x.numpy() - data).max() < 1e-2

    x = unipc_t.run_unipc(lambda x, t: v, coeffs, unipc_t.UniPCState.init(
        torch.from_numpy(noise))).x
    np.testing.assert_array_equal(x.numpy(), st_t.x.numpy())


def test_unipc_state_truncate():
    st = unipc_t.UniPCState.init(torch.randn(1, 4, 8, 2, 2))
    out = st.truncate(lambda t: t[:, :, [0, 7]])
    assert all(tuple(t.shape) == (1, 4, 2, 2, 2) for t in out)
