"""UniPC multistep predictor-corrector for flow matching.

The coefficient table is the JAX package's (``chronoedit_tpu/core/unipc.py``),
computed on the host in float64: every scalar depends only on the sigma
grid and the step index. The device step is a handful of fp32
multiply-adds on the solver state:

    x0_i   = x_i - sigma_i * v_i
    x_i   <- cx*x_prev + cm0*m0 + cD*(r0*(m1-m0)/rk + r1*(x0_i - m0))   [UniC]
    m1,m0 <- m0, x0_i ; x_prev <- x_i
    x_{i+1} = px*x_i + pm0*m0 + pD*(q0*(m1-m0)/qk)                      [UniP]

``run_unipc`` is a Python loop over the steps.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from chronoedit_tpu_torch.core.schedule import FlowMatchSchedule


class UniPCState(NamedTuple):
    """Solver state; every entry has the latent shape and is fp32."""

    x: torch.Tensor  # current sample
    m0: torch.Tensor  # last x0 prediction
    m1: torch.Tensor  # second-to-last x0 prediction
    last_sample: torch.Tensor  # sample before the last predictor step

    @classmethod
    def init(cls, x: torch.Tensor) -> "UniPCState":
        x = x.float()
        z = torch.zeros_like(x)
        return cls(x=x, m0=z, m1=z, last_sample=z)

    def truncate(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "UniPCState":
        """Apply a shape-changing slice to every tensor (the temporal-
        reasoning frame drop)."""
        return UniPCState(*(fn(t) for t in self))


@dataclasses.dataclass(frozen=True)
class UniPCCoeffs:
    """Per-step scalar coefficients, (n,) float64 arrays in field order."""

    timesteps: np.ndarray
    sigma: np.ndarray
    use_c: np.ndarray
    cx: np.ndarray
    cm0: np.ndarray
    cD: np.ndarray
    c_r0: np.ndarray
    c_r1: np.ndarray
    c_rk: np.ndarray
    px: np.ndarray
    pm0: np.ndarray
    pD: np.ndarray
    p_q0: np.ndarray
    p_qk: np.ndarray

    @property
    def num_steps(self) -> int:
        return len(self.sigma)

    def slice(self, lo: int, hi: int) -> "UniPCCoeffs":
        return UniPCCoeffs(**{
            f.name: getattr(self, f.name)[lo:hi] for f in dataclasses.fields(self)
        })

    def rows(self) -> list[tuple[float, ...]]:
        """One tuple of 14 scalars per step, rounded to float32 as the
        device step consumes them."""
        cols = np.stack([getattr(self, f.name) for f in dataclasses.fields(self)],
                        axis=1).astype(np.float32)
        return [tuple(float(v) for v in row) for row in cols]


def _lmbda(sigma: float) -> float:
    """lambda(sigma) = log(alpha) - log(sigma) with alpha = 1 - sigma."""
    if sigma <= 0.0:
        return math.inf
    return math.log(1.0 - sigma) - math.log(sigma)


def _bh_terms(h: float, solver_type: str) -> tuple[float, float, float]:
    """(hh, h_phi_1, B_h) of the bh1 / bh2 variants; fm_solvers_unipc.py:448-468."""
    hh = -h
    h_phi_1 = math.expm1(hh)
    if solver_type == "bh1":
        return hh, h_phi_1, hh
    if solver_type == "bh2":
        return hh, h_phi_1, h_phi_1
    raise ValueError(f"unknown solver_type {solver_type!r}")


def make_unipc_coeffs(
    schedule: FlowMatchSchedule,
    solver_order: int = 2,
    solver_type: str = "bh2",
    lower_order_final: bool = True,
    disable_corrector: tuple[int, ...] = (),
    int_timesteps: bool = True,
) -> UniPCCoeffs:
    """Precompute all per-step UniPC scalars on the host (float64). The
    defaults are how every ChronoEdit config runs the solver: order 2, bh2,
    lower order on the final steps, the corrector on every step after the
    first. JAX's options: ``solver_order`` 1 or 2 (higher raises
    ``NotImplementedError``, as JAX's), ``solver_type`` "bh1" / "bh2",
    ``lower_order_final``, ``disable_corrector`` (steps whose corrector is
    skipped; step i's corrector follows predictor step i - 1) and
    ``int_timesteps`` (floored model timesteps)."""
    if solver_order not in (1, 2):
        raise NotImplementedError("solver_order must be 1 or 2")
    sig = schedule.sigmas
    n = schedule.num_steps
    lam = np.array([_lmbda(float(s)) for s in sig])
    # p_order[i] = min(solver_order, i + 1, n - i if lower_order_final);
    # the corrector at step i has order p_order[i - 1]
    p_order = [min(solver_order, i + 1, (n - i) if lower_order_final else solver_order)
               for i in range(n)]
    cols: dict[str, list[float]] = {k: [] for k in (
        "use_c", "cx", "cm0", "cD", "c_r0", "c_r1", "c_rk",
        "px", "pm0", "pD", "p_q0", "p_qk")}

    for i in range(n):
        # corrector (UniC) at step i, sigma[i-1] -> sigma[i]
        use_c = i > 0 and (i - 1) not in disable_corrector
        c_order = p_order[i - 1] if i > 0 else 1
        if use_c:
            s_t, s_s0 = float(sig[i]), float(sig[i - 1])
            a_t = 1.0 - s_t
            h = lam[i] - lam[i - 1]
            hh, h_phi_1, b_h = _bh_terms(h, solver_type)
            cx = s_t / s_s0
            cm0 = -a_t * h_phi_1
            cd = -a_t * b_h
            if c_order >= 2:
                rk = (lam[i - 2] - lam[i - 1]) / h
                hpk1 = h_phi_1 / hh - 1.0
                b1 = hpk1 / b_h
                hpk2 = hpk1 / hh - 0.5
                b2 = hpk2 * 2.0 / b_h
                r0 = (b1 - b2) / (1.0 - rk)
                r1 = b1 - r0
            else:
                rk, r0, r1 = 1.0, 0.0, 0.5
        else:
            cx = cm0 = cd = r0 = r1 = 0.0
            rk = 1.0
        cols["use_c"].append(1.0 if use_c else 0.0)
        cols["cx"].append(cx)
        cols["cm0"].append(cm0)
        cols["cD"].append(cd)
        cols["c_r0"].append(r0)
        cols["c_r1"].append(r1)
        cols["c_rk"].append(rk)

        # predictor (UniP) at step i, sigma[i] -> sigma[i+1]
        order = p_order[i]
        s_t, s_s0 = float(sig[i + 1]), float(sig[i])
        a_t = 1.0 - s_t
        h = lam[i + 1] - lam[i]
        if math.isinf(h):  # final sigma == 0: x_n = m0 exactly
            px, pm0, pd, q0, qk = 0.0, 1.0, 0.0, 0.0, 1.0
        else:
            hh, h_phi_1, b_h = _bh_terms(h, solver_type)
            px = s_t / s_s0
            pm0 = -a_t * h_phi_1
            if order >= 2:
                qk = (lam[i - 1] - lam[i]) / h
                pd = -a_t * b_h
                q0 = 0.5
            else:
                pd, q0, qk = 0.0, 0.0, 1.0
        cols["px"].append(px)
        cols["pm0"].append(pm0)
        cols["pD"].append(pd)
        cols["p_q0"].append(q0)
        cols["p_qk"].append(qk)

    return UniPCCoeffs(
        timesteps=schedule.model_timesteps(int_timesteps),
        sigma=sig[:n].copy(),
        **{k: np.asarray(v) for k, v in cols.items()},
    )


def unipc_step(state: UniPCState, row: tuple[float, ...],
               model_output: torch.Tensor) -> UniPCState:
    """One fused UniC+UniP update; ``row`` is one entry of
    :meth:`UniPCCoeffs.rows`, ``model_output`` the raw velocity."""
    (_, sigma, use_c, cx, cm0, cd, c_r0, c_r1, c_rk,
     px, pm0, pd, p_q0, p_qk) = row
    x, m0, m1, last_sample = state
    v = model_output.float()
    x0 = x - sigma * v
    if use_c > 0.5:
        d1s = (m1 - m0) / c_rk
        x = cx * last_sample + cm0 * m0 + cd * (c_r0 * d1s + c_r1 * (x0 - m0))
    m1, m0, last_sample = m0, x0, x
    x_next = px * x + pm0 * m0 + pd * (p_q0 * (m1 - m0) / p_qk)
    return UniPCState(x=x_next, m0=m0, m1=m1, last_sample=last_sample)


def run_unipc(model_fn: Callable[..., torch.Tensor], coeffs: UniPCCoeffs,
              state: UniPCState, start: int = 0, end: int | None = None, aux=None):
    """Steps [start, end): ``model_fn(x, timestep) -> velocity`` each step.

    With ``aux`` (any object), the model carries loop state, e.g. the
    Δ-DiT block-delta cache: ``model_fn(x, timestep, step_index, aux) ->
    (velocity, aux)``, and ``(state, aux)`` is returned."""
    end = coeffs.num_steps if end is None else end
    rows = coeffs.slice(start, end).rows()
    if aux is None:
        for row in rows:
            state = unipc_step(state, row, model_fn(state.x, row[0]))
        return state
    for idx, row in zip(range(start, end), rows):
        v, aux = model_fn(state.x, row[0], idx, aux)
        state = unipc_step(state, row, v)
    return state, aux


def unipc_sample(model_fn: Callable[[torch.Tensor, float], torch.Tensor],
                 x_init: torch.Tensor, schedule: FlowMatchSchedule, solver_order: int = 2,
                 **kwargs) -> torch.Tensor:
    """One-shot sampler: noise in, denoised x0 out (fp32, on the device of
    ``x_init``); ``kwargs`` are :func:`make_unipc_coeffs`' options."""
    coeffs = make_unipc_coeffs(schedule, solver_order=solver_order, **kwargs)
    return run_unipc(model_fn, coeffs, UniPCState.init(x_init)).x
