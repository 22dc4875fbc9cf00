"""The DiT's fused norm/modulation chain: K2, K3 and K4.

- :func:`layer_norm_modulate` (K2) — fp32 LayerNorm (no affine) + AdaLN
  ``(1+scale)*x_hat + shift`` with per-frame scale/shift.
- :func:`gated_residual` (K3) — ``x + delta * gate`` in fp32 with a
  per-frame gate, output in x's dtype.
- :func:`rms_norm_fused` (K4) — the qk "rms_norm_across_heads": fp32
  statistics, cast, then the weight; :func:`rms_norm_tensor` — its
  tensor-parallel form, on a rank's columns of each row: each row's sum of
  squares over the local columns (pass (a), ``rms_sumsq``), summed over the
  tensor ranks, then the local columns normalised by the whole row's
  statistics (pass (b), ``rms_norm_ss``), the rank's slice of the weight
  applied (JAX's shard_map branch of ``rms_norm_fused``).

Each wrapper is a ``torch.autograd.Function``. Its forward launches the
CUDA kernel (``csrc/``) for CUDA tensors and raises on what the kernel does
not take; it runs the plain twin beside it (``*_plain``, the JAX package's
jnp formulation) only for CPU tensors. Its backward is the VJP of the plain
twin, recomputed from the saved inputs, on either device: what the JAX
package does (``fused_norms.py`` custom VJPs), so no backward kernel exists.
"""

from __future__ import annotations

import torch

from chronoedit_tpu_torch.ops import layers as L

# K2 and K4 stage whole rows (K2 also two frames' fp32 scale and shift) in
# one block's shared memory, which holds K2's at most at D = 8192
_MAX_D = 8192
# K2's rows of one frame in one block, counted as arrivals on a barrier
_MAX_HW = 2 ** 20 - 2


# ----------------------------------------------------------- plain twins

def ln_modulate_plain(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                      hw: int, eps: float = 1e-6) -> torch.Tensor:
    b, s, d = x.shape
    xt = L.layer_norm(None, x, eps).reshape(b, s // hw, hw, d)
    out = xt * (1.0 + scale[:, :, None].float()) + shift[:, :, None].float()
    return out.reshape(b, s, d).to(x.dtype)


def gated_residual_plain(x: torch.Tensor, delta: torch.Tensor, gate: torch.Tensor,
                         hw: int) -> torch.Tensor:
    b, s, d = x.shape
    xt = x.float().reshape(b, s // hw, hw, d)
    dt = delta.float().reshape(b, s // hw, hw, d)
    out = xt + dt * gate[:, :, None].float()
    return out.reshape(b, s, d).to(x.dtype)


def rms_norm_plain(weight: torch.Tensor, x: torch.Tensor, eps: float = 1e-6,
                   ss: torch.Tensor | None = None, d: int | None = None) -> torch.Tensor:
    """K4's twin; with ``ss`` the rows' sums of squares over a width of
    ``d`` columns (the whole row's, of which ``x`` holds a rank's share),
    taken as the statistics in place of ``x``'s own."""
    xf = x.float()
    if ss is None:
        var = xf.square().mean(dim=-1, keepdim=True)
    else:
        var = ss.unsqueeze(-1) / d
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight.to(x.dtype)


def rms_sumsq_plain(x: torch.Tensor) -> torch.Tensor:
    """Pass (a)'s twin: each row's fp32 sum of squares, (B, S)."""
    return x.float().square().sum(dim=-1)


def rms_norm_ss_plain(weight: torch.Tensor, x: torch.Tensor, ss: torch.Tensor, d: int,
                      eps: float) -> torch.Tensor:
    """Pass (b)'s twin: :func:`rms_norm_plain` with external statistics."""
    return rms_norm_plain(weight, x, eps, ss, d)


# ----------------------------------------------------------- checks

def _check_stream(name: str, x: torch.Tensor) -> None:
    if (x.dtype != torch.bfloat16 or x.dim() != 3 or not x.is_contiguous()
            or x.data_ptr() % 16):
        raise ValueError(f"{name}: expects a contiguous, 16-byte aligned (B, S, D) "
                         f"bf16 CUDA tensor, got {x.dtype} {tuple(x.shape)}")
    d = x.shape[-1]
    if d % 8 or d > _MAX_D:
        raise ValueError(f"{name}: D={d} must be a multiple of 8 and <= {_MAX_D}")


def _check_like(name: str, ref: torch.Tensor, t: torch.Tensor,
                shape: tuple[int, ...], dtype: torch.dtype) -> None:
    if (t.device != ref.device or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(f"{name}: expects a contiguous, 16-byte aligned {dtype} tensor of shape "
                         f"{shape} on {ref.device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _frames(name: str, x: torch.Tensor, hw: int) -> int:
    b, s, _ = x.shape
    if hw <= 0 or s % hw:
        raise ValueError(f"{name}: S={s} is not a multiple of hw={hw}")
    return s // hw


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ----------------------------------------------------------- kernels

def _ln_modulate_kernel(x, scale, shift, hw: int, eps: float) -> torch.Tensor:
    from chronoedit_tpu_torch.kernels import build

    _check_stream("ln_modulate", x)
    b, s, d = x.shape
    t = _frames("ln_modulate", x, hw)
    if hw > _MAX_HW:
        raise ValueError(f"ln_modulate: hw={hw} must be <= {_MAX_HW}")
    _check_like("ln_modulate", x, scale, (b, t, d), torch.float32)
    _check_like("ln_modulate", x, shift, (b, t, d), torch.float32)
    out = torch.empty_like(x)
    build.check(build.lib().ln_modulate_bf16(
        x.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
        b * s, t, hw, d, eps, _stream()), "ln_modulate")
    return out


def _gated_residual_kernel(x, delta, gate, hw: int) -> torch.Tensor:
    from chronoedit_tpu_torch.kernels import build

    _check_stream("gated_residual", x)
    b, s, d = x.shape
    t = _frames("gated_residual", x, hw)
    _check_like("gated_residual", x, delta, (b, s, d), torch.bfloat16)
    _check_like("gated_residual", x, gate, (b, t, d), torch.float32)
    out = torch.empty_like(x)
    build.check(build.lib().gated_residual_bf16(
        x.data_ptr(), delta.data_ptr(), gate.data_ptr(), out.data_ptr(),
        b * s, t, hw, d, _stream()), "gated_residual")
    return out


def _rms_norm_kernel(w, x, eps: float) -> torch.Tensor:
    from chronoedit_tpu_torch.kernels import build

    _check_stream("rms_norm", x)
    b, s, d = x.shape
    _check_like("rms_norm", x, w, (d,), torch.bfloat16)
    out = torch.empty_like(x)
    build.check(build.lib().rms_norm_bf16(
        x.data_ptr(), w.data_ptr(), None, out.data_ptr(), b * s, d, d, eps, _stream()),
        "rms_norm")
    return out


def _rms_sumsq_kernel(x) -> torch.Tensor:
    from chronoedit_tpu_torch.kernels import build

    _check_stream("rms_sumsq", x)
    b, s, d = x.shape
    ss = torch.empty((b, s), device=x.device, dtype=torch.float32)
    build.check(build.lib().rms_sumsq_bf16(x.data_ptr(), ss.data_ptr(), b * s, d, _stream()),
                "rms_sumsq")
    return ss


def _rms_norm_ss_kernel(w, x, ss, d_stat: int, eps: float) -> torch.Tensor:
    from chronoedit_tpu_torch.kernels import build

    _check_stream("rms_norm_ss", x)
    b, s, d = x.shape
    _check_like("rms_norm_ss", x, w, (d,), torch.bfloat16)
    _check_like("rms_norm_ss", x, ss, (b, s), torch.float32)
    out = torch.empty_like(x)
    build.check(build.lib().rms_norm_bf16(
        x.data_ptr(), w.data_ptr(), ss.data_ptr(), out.data_ptr(), b * s, d, d_stat, eps,
        _stream()), "rms_norm_ss")
    return out


# ----------------------------------------------------------- autograd

class _Fused(torch.autograd.Function):
    """Forward: the kernel for CUDA tensors, the twin for CPU tensors.
    Backward: the twin's VJP, recomputed from the saved tensor inputs; the
    trailing non-tensor arguments (hw, eps) get no gradient."""

    @staticmethod
    def forward(ctx, plain, kernel, n_tensors: int, *args):
        tensors = args[:n_tensors]
        ctx.plain, ctx.rest = plain, args[n_tensors:]
        ctx.save_for_backward(*tensors)
        fn = plain if tensors[0].device.type == "cpu" else kernel
        return fn(*args)

    @staticmethod
    def backward(ctx, grad):
        tensors = ctx.saved_tensors
        need = ctx.needs_input_grad[3:3 + len(tensors)]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(tensors, need)]
            out = ctx.plain(*inputs, *ctx.rest)
            wrt = [t for t, n in zip(inputs, need) if n]
            grads = iter(torch.autograd.grad(out, wrt, grad) if wrt else ())
        return (None, None, None, *(next(grads) if n else None for n in need),
                *(None for _ in ctx.rest))


# ----------------------------------------------------------- wrappers

def layer_norm_modulate(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                        hw: int, eps: float = 1e-6) -> torch.Tensor:
    """K2. x (B, S, D); scale/shift (B, T, D) fp32 with S = T*hw.
    Returns (B, S, D) in x's dtype."""
    return _Fused.apply(ln_modulate_plain, _ln_modulate_kernel, 3, x, scale, shift,
                        hw, eps)


def gated_residual(x: torch.Tensor, delta: torch.Tensor, gate: torch.Tensor,
                   hw: int) -> torch.Tensor:
    """K3. x + delta*gate in fp32; gate (B, T, D) per frame; output in
    x's dtype, in a new tensor."""
    return _Fused.apply(gated_residual_plain, _gated_residual_kernel, 3, x, delta,
                        gate, hw)


def rms_norm_fused(p: L.RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """K4 on (B, S, D): fp32 statistics, cast to x's dtype, then the weight
    (cast to x's dtype first; its gradient flows back through the cast)."""
    return _Fused.apply(rms_norm_plain, _rms_norm_kernel, 2, p.scale.to(x.dtype), x,
                        eps)


def rms_norm_tensor(p: L.RMSNorm, x: torch.Tensor, group, index: int, size: int,
                    eps: float = 1e-6) -> torch.Tensor:
    """K4 under tensor parallelism: ``x`` (B, S, D / size) holds this rank's
    ``index``-th block of each row's columns; ``p.scale`` is the whole
    (D,) weight, replicated. Pass (a) sums each row's squares over the
    local columns; one (B, S) fp32 all-reduce over ``group`` completes
    them; pass (b) normalises the local columns by ``sum / D`` and applies
    this rank's slice of the weight. Backward: each pass's twin's VJP, the
    statistic's cotangent summed over the group (every rank used the sum
    on its own columns), and the weight's gradient summed too (each rank
    used its own slice of the replicated weight)."""
    from chronoedit_tpu_torch.parallel import collectives as C

    d_local = x.shape[-1]
    w = C.sum_grad_autograd(p.scale, group).narrow(0, index * d_local, d_local).to(x.dtype)
    ss = C.psum_autograd(_Fused.apply(rms_sumsq_plain, _rms_sumsq_kernel, 1, x), group)
    return _Fused.apply(rms_norm_ss_plain, _rms_norm_ss_kernel, 3, w, x, ss,
                        d_local * size, eps)


# ----------------------------------------------------- context shards

def local_frame_slice(mods, hw: int, s_local: int, index: int):
    """Slice per-frame modulation tensors to a context shard's frames.

    A (B, T*hw, D) stream split into contiguous blocks of ``s_local``
    tokens, this rank's block the ``index``-th, maps a (B, T, ...)
    modulation tensor onto its tokens in one of two regimes:

    - whole frames per shard (``s_local % hw == 0``): the shard holds
      ``s_local // hw`` consecutive frames;
    - shard within a frame (``hw % s_local == 0``): every token of the
      shard belongs to the one frame ``index * s_local // hw``.

    Returns ``(mods_local, hw_local)`` with each mod (B, T_local, ...) and
    ``hw_local`` the tokens per local frame, the ``hw`` that K2 and K3 take
    on the shard. Callers check first that one regime holds
    (:func:`frames_map_locally`).
    """
    if s_local % hw == 0:
        t_local, hw_local = s_local // hw, hw
        start = index * t_local
    else:
        t_local, hw_local = 1, s_local
        start = index * s_local // hw
    return tuple(m.narrow(1, start, t_local) for m in mods), hw_local


def frames_map_locally(s: int, hw: int, cp: int) -> bool:
    """Can a (B, T*hw, D) stream split into ``cp`` contiguous token blocks be
    frame-modulated shard-locally?"""
    if s % cp:
        return False
    s_local = s // cp
    return s_local % hw == 0 or hw % s_local == 0
