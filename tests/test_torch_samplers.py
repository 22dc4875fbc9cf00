"""The port's samplers against the JAX package's: ``core/euler.py``'s
``euler_sample``, ``core/unipc.py``'s ``unipc_sample`` and every option of
``make_unipc_coeffs``.

The coefficient tables are host float64 arithmetic in JAX's order: bitwise
equal. The samplers run fp32 state on the same numpy inputs and schedule,
and differ only by fp32 rounding in the model function and the updates:
within 1e-5 (absolute and relative) on O(1) values after up to 20 steps.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chronoedit_tpu.core import euler as euler_j
from chronoedit_tpu.core import schedule as sched_j
from chronoedit_tpu.core import unipc as unipc_j
from chronoedit_tpu_torch.core import euler as euler_t
from chronoedit_tpu_torch.core import schedule as sched_t
from chronoedit_tpu_torch.core import unipc as unipc_t

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
DISABLED = ((), (0,), (1, 3), (2, 5, 6))


@pytest.mark.parametrize("solver_order,solver_type,lower_order_final",
                         list(itertools.product((1, 2), ("bh1", "bh2"), (True, False))))
def test_unipc_coeff_options_match_jax(solver_order, solver_type, lower_order_final):
    """Every option JAX's ``make_unipc_coeffs`` takes, at 3, 8 and 20 steps,
    each ``disable_corrector`` set and both timestep forms: bitwise."""
    for n, shift, disabled, int_ts in itertools.product((3, 8, 20), (2.0, 5.0), DISABLED,
                                                        (True, False)):
        kw = dict(solver_order=solver_order, solver_type=solver_type,
                  lower_order_final=lower_order_final, disable_corrector=disabled,
                  int_timesteps=int_ts)
        a = unipc_j.make_unipc_coeffs(sched_j.make_flow_schedule(n, shift=shift), **kw)
        b = unipc_t.make_unipc_coeffs(sched_t.make_flow_schedule(n, shift=shift), **kw)
        for name in a.__dataclass_fields__:
            np.testing.assert_array_equal(getattr(b, name), getattr(a, name),
                                          err_msg=f"{name} {n} {kw}")


def test_unipc_defaults_unchanged_and_refusals():
    """The defaults are the main path's (order 2, bh2, lower order final,
    every corrector, floored timesteps); order 3 and an unknown variant
    raise, as JAX's do."""
    sched = sched_t.make_flow_schedule(8, shift=2.0)
    a = unipc_t.make_unipc_coeffs(sched)
    b = unipc_t.make_unipc_coeffs(sched, 2, "bh2", True, (), True)
    for name in a.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    with pytest.raises(NotImplementedError):
        unipc_t.make_unipc_coeffs(sched, solver_order=3)
    with pytest.raises(ValueError):
        unipc_t.make_unipc_coeffs(sched, solver_type="bh3")


def _fields(seed: int):
    """A nonlinear velocity field as a pair of (JAX, torch) model
    functions with the same fp32 constants."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((1, 4, 2, 6, 6)).astype(np.float32)
    b = rng.standard_normal((1, 4, 2, 6, 6)).astype(np.float32)
    a_t, b_t = torch.from_numpy(a), torch.from_numpy(b)

    def fj(x, t):
        return jnp.tanh(x) * a - (t / 1000.0) * b

    def ft(x, t):
        return torch.tanh(x) * a_t - (t / 1000.0) * b_t

    return fj, ft, rng.standard_normal(a.shape).astype(np.float32)


@pytest.mark.parametrize("num_steps,int_timesteps", [(4, True), (8, True), (20, False)])
def test_euler_matches_jax(num_steps, int_timesteps):
    fj, ft, x0 = _fields(0)
    sched_a = sched_j.make_flow_schedule(num_steps, shift=2.0)
    sched_b = sched_t.make_flow_schedule(num_steps, shift=2.0)
    want = np.asarray(euler_j.euler_sample(fj, jnp.asarray(x0), sched_a, int_timesteps))
    got = euler_t.euler_sample(ft, torch.from_numpy(x0), sched_b, int_timesteps)
    assert got.dtype == torch.float32 and got.device == torch.device("cpu")
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("solver_order,solver_type,lower_order_final,disabled",
                         [(2, "bh2", True, ()), (1, "bh2", True, ()), (2, "bh1", False, (1, 3)),
                          (2, "bh2", False, (0,)), (1, "bh1", True, (2,))])
def test_unipc_sample_matches_jax(solver_order, solver_type, lower_order_final, disabled):
    fj, ft, x0 = _fields(1)
    kw = dict(solver_type=solver_type, lower_order_final=lower_order_final,
              disable_corrector=disabled)
    for n in (6, 12):
        want = np.asarray(unipc_j.unipc_sample(
            fj, jnp.asarray(x0), sched_j.make_flow_schedule(n, shift=3.0), solver_order, **kw))
        got = unipc_t.unipc_sample(ft, torch.from_numpy(x0),
                                   sched_t.make_flow_schedule(n, shift=3.0), solver_order, **kw)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_euler_recovers_analytic_flow_and_meets_unipc():
    """JAX's own checks of its Euler sampler, on the port's: the exact
    rectified-flow field v = noise - data recovers data at 50 steps (within
    1e-2: sigma_max = 0.999 leaves a ~1e-3 floor), and on a smooth field
    Euler and UniPC land close (JAX's tolerance)."""
    rng = np.random.default_rng(0)
    data = torch.from_numpy(rng.standard_normal((1, 4, 2, 4, 4)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal(data.shape).astype(np.float32))
    out = euler_t.euler_sample(lambda x, t: noise - data, noise,
                               sched_t.make_flow_schedule(50, shift=1.0))
    assert float((out - data).abs().max()) < 1e-2
    sched = sched_t.make_flow_schedule(40, shift=2.0)
    x0 = torch.ones((1, 3, 3))
    a = euler_t.euler_sample(lambda x, t: 0.2 * x, x0, sched)
    b = unipc_t.unipc_sample(lambda x, t: 0.2 * x, x0, sched)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0.05, atol=0.02)
