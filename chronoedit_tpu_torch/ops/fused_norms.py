"""The DiT's fused norm/modulation chain: K2, K3 and K4.

- :func:`layer_norm_modulate` (K2) — fp32 LayerNorm (no affine) + AdaLN
  ``(1+scale)*x_hat + shift`` with per-frame scale/shift.
- :func:`gated_residual` (K3) — ``x + delta * gate`` in fp32 with a
  per-frame gate, output in x's dtype.
- :func:`rms_norm_fused` (K4) — the qk "rms_norm_across_heads": fp32
  statistics, cast, then the weight.

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


def rms_norm_plain(weight: torch.Tensor, x: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight.to(x.dtype)


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
        x.data_ptr(), w.data_ptr(), out.data_ptr(), b * s, d, eps, _stream()),
        "rms_norm")
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
