"""Flash attention: the forward (K1 and K5) and the backward (K6 and K7),
hand-written Hopper kernels and their plain twins.

The CUDA kernel (``csrc/flash_fwd.cu``, ``flash_fwd_wgmma_kernel``) takes
(B, S, H, 128) bf16 q/k/v in place — no transpose to a (B*H, S, D) layout
and no padding — and returns O in bf16 and the per-row log-sum-exp in
fp32. A producer warpgroup loads 128-row tiles straight from BSHD with TMA
(4-D tensor maps over (D, H, S, B), encoded on the host for every call, so
rows past a sequence's end are zero-filled, never read from the next
batch) into a two-stage mbarrier ring; two consumer warpgroups compute
both products with ``wgmma`` and mask the ragged KV tail. The TPU kernel's
VMEM planning (resident vs streamed KV, block planners, k-major) has no
counterpart: the CUDA kernel always streams KV tiles through shared
memory, so the one kernel serves both TPU kernels, the resident K1 (the
edit's 7,200 tokens and the cross-attention) and the streamed K5
(reasoning self-attention at 28,800 tokens). Launches are counted by name
and by KV length (``kernels/build.py``), which tells the two roles apart.

``group`` on :func:`flash_attention_with_lse` (as JAX
``flash_attention(..., group=)``) picks the kernel: 1 is K1/K5 (128-row
KV tiles); 2, 3 or 4 is the grouped kernel X1, which takes that many
64-row KV tiles a step behind one barrier pair
(``flash_fwd_grouped_wgmma_kernel`` in the same file, K1's TMA and
``wgmma`` machinery: all the step's score products first, then one
combined softmax update). JAX honours a group
only on its streamed path; the port has no resident/streamed split, so it
honours an explicit group at every KV length. Only the experiment tools
(``chronoedit_tpu_torch/tools``) pass one; the differentiable
:func:`flash_attention` is always K1/K5. :func:`flash_attention_bwd`'s
``group_dq`` / ``group_dkv`` pick the grouped backward X2 for either side.
On the CPU every group runs the twin: the same function.

The backward (``csrc/flash_bwd.cu``): K6 computes dQ, K7 dK and dV, both
recomputing P from the forward's LSE as JAX's ``_backward`` does;
``dsum = rowsum(dO * O)`` is one torch reduction in the wrapper. Both have
the forward's shape (``flash_bwd_dq_wgmma_kernel``,
``flash_bwd_dkv_wgmma_kernel``): a producer warpgroup streams TMA tiles
from 4-D maps over BSHD into a two-stage mbarrier ring (K and V tiles for
K6, whose block keeps 128 q rows and their dO; q and dO tiles with their
lse and dsum for K7, whose block keeps 128 KV rows) and two consumer
warpgroups run every product with ``wgmma``. Each output row is summed by
one block in a fixed order, with no atomics, so two calls give bitwise the
same gradients. The
autograd Function :class:`FlashAttention` ties the two together: its
forward is the kernel (twin on the CPU), it saves q, k, v, O and the raw
(B, H, Sq) LSE, and its backward launches only what ``needs_input_grad``
asks for (no K7 when neither k nor v needs a gradient, no K6 when q does
not).

The int8-score forward (K9, ``csrc/flash_fwd_qk8.cu``) serves
``DiTConfig.attn_qk_int8``: :func:`flash_attention_qk_int8` quantizes q per
token and the mean-centred k per token in plain torch, as JAX does in XLA,
then runs K9 (its twin on the CPU): the forward's warp-specialised shape
(``flash_fwd_qk8_wgmma_kernel``) with the scores from ``wgmma`` s8 x s8 ->
s32 on TMA-loaded int8 tiles, dequantized in JAX's order. It keeps JAX's
rule for where int8 scores apply: only where JAX would stream the KV, past
6 MiB of K and V (:func:`uses_int8_scores`); shorter KV takes the bf16
kernel, as in JAX. Forward only, as JAX's.
"""

from __future__ import annotations

import torch

HEAD_DIM = 128  # the only head dim K1 is built for
FWD_GROUPS = (1, 2, 3, 4)  # 1 is K1/K5; 2-4 is X1, that many 64-row KV tiles a step
BWD_GROUPS = (1, 2, 4)  # tiles a step of each backward side: 1 is K6/K7, the rest X2


def _check_group(name: str, group: int, allowed: tuple[int, ...]) -> None:
    if group not in allowed:
        raise ValueError(f"{name} must be one of {allowed}, got {group!r}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, q_chunk: int | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 softmax attention; returns (out in q's dtype, lse (B, S, H) fp32).
    ``q_chunk`` rows of q at a time bound the (B, H, rows, Skv) fp32 score
    matrix (rows are independent: the same math)."""
    if q_chunk is not None and q_chunk < q.shape[1]:
        outs, lses = zip(*(flash_attention_plain(qc, k, v, scale)
                           for qc in q.split(q_chunk, dim=1)))
        return torch.cat(outs, dim=1), torch.cat(lses, dim=1)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
    return out, lse.transpose(1, 2)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.device != q.device or t.dtype != torch.bfloat16 or t.dim() != 4
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"flash_fwd: {name} must be a contiguous (B, S, H, D) "
                             f"bf16 tensor on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    b, sq, h, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"flash_fwd: head dim {d} != {HEAD_DIM}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"flash_fwd: k {tuple(k.shape)} / v {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if sq == 0 or k.shape[1] == 0:
        raise ValueError("flash_fwd: empty sequence")


def _check_like_q(name: str, q: torch.Tensor, t: torch.Tensor, shape) -> None:
    if (t.device != q.device or t.dtype != q.dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(f"flash_bwd: {name} must be a contiguous {q.dtype} tensor of "
                         f"shape {tuple(shape)} on {q.device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             scale: float, group: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """(out (B, Sq, H, D), lse (B, H, Sq) fp32): K1/K5 (``group`` 1) or X1
    (2-4) for CUDA tensors, the twin for CPU tensors."""
    _check_group("flash_fwd: group", group, FWD_GROUPS)
    if q.device.type == "cpu":
        out, lse = flash_attention_plain(q, k, v, scale)
        return out, lse.transpose(1, 2)
    from chronoedit_tpu_torch.kernels import build

    _check(q, k, v)
    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), device=q.device, dtype=torch.float32)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b, sq, k.shape[1], h, d, scale)
    stream = torch.cuda.current_stream().cuda_stream
    if group == 1:
        build.check(build.lib().flash_fwd_bf16(*args, stream), "flash_fwd", k.shape[1])
    else:
        build.check(build.lib().flash_fwd_grouped_bf16(*args, group, stream),
                    "flash_fwd_grouped", k.shape[1])
    return out, lse


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             scale: float, group: int = 1
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Non-causal attention, BSHD, not differentiable. Returns
    ``(out, lse)`` with out (B, Sq, H, D) in q's dtype and lse (B, Sq, H)
    fp32 (a view of the kernel's (B, H, Sq) buffer). ``group`` KV tiles a
    step on the card (1: K1/K5; 2, 3, 4: X1); raises on any other value."""
    out, lse = _forward(q, k, v, scale, group)
    return out, lse.transpose(1, 2)


def flash_attention_bwd_plain(q, k, v, out, dout, lse, scale: float,
                              q_chunk: int | None = None, need_dq: bool = True,
                              need_dkv: bool = True):
    """fp32 twin of K6 + K7: ``(dq, dk, dv)`` in the inputs' dtypes from
    lse (B, Sq, H), recomputing P = exp(scale q k^T - lse); None where not
    asked for (``need_dq`` is K6's work, ``need_dkv`` K7's). With
    ``q_chunk``, q rows go ``q_chunk`` at a time: dQ rows are independent,
    dK and dV are summed over the chunks (each fp32 (B, H, rows, Skv)
    score-sized matrix then stays bounded)."""
    if q_chunk is not None and q_chunk < q.shape[1]:
        dk = dv = None
        if need_dkv:
            dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
            dv = torch.zeros_like(dk)
        dqs = []
        for r0 in range(0, q.shape[1], q_chunk):
            rows = slice(r0, r0 + q_chunk)
            dq_c, dk_c, dv_c = _bwd_plain_f32(q[:, rows], k, v, out[:, rows], dout[:, rows],
                                              lse[:, rows], scale, need_dq, need_dkv)
            if need_dq:
                dqs.append(dq_c.to(q.dtype))
            if need_dkv:
                dk += dk_c
                dv += dv_c
        dq = torch.cat(dqs, dim=1) if need_dq else None
    else:
        dq, dk, dv = _bwd_plain_f32(q, k, v, out, dout, lse, scale, need_dq, need_dkv)
        dq = dq.to(q.dtype) if need_dq else None
    if need_dkv:
        dk, dv = dk.to(k.dtype), dv.to(v.dtype)
    return dq, dk, dv


def _bwd_plain_f32(q, k, v, out, dout, lse, scale, need_dq, need_dkv):
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse.float().transpose(1, 2)[..., None])
    del s
    dsum = (dof * out.float()).sum(-1).transpose(1, 2)[..., None]  # (B, H, Sq, 1)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof) if need_dkv else None
    ds = p * (dp - dsum) * scale
    del p, dp
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) if need_dq else None
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) if need_dkv else None
    return dq, dk, dv


def flash_attention_bwd(q, k, v, out, dout, lse, scale: float,
                        need_dq: bool = True, need_dkv: bool = True,
                        group_dq: int = 1, group_dkv: int = 1):
    """Flash backward given an explicit lse (B, Sq, H) fp32, the public
    shape of JAX ``flash_attention_bwd``; a (B, Sq, H) view of a
    contiguous (B, H, Sq) buffer (what the forward returns) is read without
    a copy. Returns ``(dq, dk, dv)``, None where not asked for. CUDA
    tensors launch K6 for dQ (``need_dq``) and K7 for dK, dV
    (``need_dkv``), each side on its own group: at 2 or 4 that side runs
    X2's kernel instead, dQ with ``group_dq`` 64-row KV tiles a step, dK
    and dV with ``group_dkv`` 32-row q tiles a step (each 1, 2 or 4;
    anything else raises); group 1 is K6/K7. X2 is K6/K7's kernel with a
    ring stage of that many tiles (at 2 their own step, at 4 two of their
    steps behind one barrier pair), so it chains the same 16-deep chunks
    of each sum in the same order and its gradients are K6/K7's bit for
    bit (``chip_smoke.py`` compares them); the experiment tool holds them
    to the K67 bounds (``chronoedit_tpu_torch/tools``). CPU tensors run
    the twin (the same function at every group)."""
    _check_group("flash_bwd: group_dq", group_dq, BWD_GROUPS)
    _check_group("flash_bwd: group_dkv", group_dkv, BWD_GROUPS)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, dout, lse, scale,
                                         need_dq=need_dq, need_dkv=need_dkv)
    from chronoedit_tpu_torch.kernels import build

    _check(q, k, v)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    dout = dout.contiguous()  # gradients from _merge_heads may be strided
    _check_like_q("out", q, out, q.shape)
    _check_like_q("dout", q, dout, q.shape)
    lse = lse.transpose(1, 2).contiguous()
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, sq):
        raise ValueError(f"flash_bwd: lse must be (B, Sq, H) fp32, got {lse.dtype} "
                         f"{tuple(lse.transpose(1, 2).shape)}")
    dsum = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    stream = torch.cuda.current_stream().cuda_stream
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
           dsum.data_ptr())
    dq = dk = dv = None
    if need_dq:
        dq = torch.empty_like(q)
        args = (*ins, dq.data_ptr(), b, sq, skv, h, d, scale)
        if group_dq > 1:
            build.check(build.lib().flash_bwd_dq_grouped_bf16(*args, group_dq, stream),
                        "flash_bwd_dq_grouped", skv)
        else:
            build.check(build.lib().flash_bwd_dq_bf16(*args, stream), "flash_bwd_dq", skv)
    if need_dkv:
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        args = (*ins, dk.data_ptr(), dv.data_ptr(), b, sq, skv, h, d, scale)
        if group_dkv > 1:
            build.check(build.lib().flash_bwd_dkv_grouped_bf16(*args, group_dkv, stream),
                        "flash_bwd_dkv_grouped", skv)
        else:
            build.check(build.lib().flash_bwd_dkv_bf16(*args, stream), "flash_bwd_dkv", skv)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: K1/K5 forward, K6/K7 backward (the
    twins on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        out, lse = _forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        need_dq = ctx.needs_input_grad[0]
        need_dkv = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse.transpose(1, 2),
                                         ctx.scale, need_dq, need_dkv)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Non-causal attention output, (B, Sq, H, D); differentiable."""
    return FlashAttention.apply(q, k, v, scale)


# ------------------------------------------------------------ int8 scores

# JAX keeps the KV "resident" in VMEM, and the scores in bf16, while
# 2 * ceil(Skv / 256) * 256 * D * itemsize <= 6 MiB
# (chronoedit_tpu/ops/flash_attention.py:833-836); only longer KV reaches
# its int8-score kernel. The rule decides which arithmetic runs, so the port
# keeps it: at D = 128 in bf16, int8 scores for KV > 12,288 tokens (the
# reasoning self-attention's 28,800), bf16 for the edit's 7,200 and the
# cross-attention's 512 and 257.
QK8_RESIDENT_KV_BYTES = 6 * 1024 * 1024


def uses_int8_scores(kv_len: int, head_dim: int, itemsize: int) -> bool:
    """Whether :func:`flash_attention_qk_int8` runs int8 scores at this KV
    length, head dim and element size (JAX's resident rule)."""
    return 2 * (-(-kv_len // 256) * 256) * head_dim * itemsize > QK8_RESIDENT_KV_BYTES


def quantize_qk(q: torch.Tensor, k: torch.Tensor):
    """JAX's prologue to its int8-score kernel: k centred on its fp32 mean
    over the tokens (softmax ignores the per-row shift this gives every
    score), then q and k quantized per token, ``s = max(amax, 1e-20) /
    127``, ``round(x / s)`` to int8. Returns (q8, qs, k8, ks) with the
    scales (B, S, H) fp32."""
    kc = k.to(torch.float32, copy=True)
    kc -= kc.mean(dim=1, keepdim=True)
    ks = kc.abs().amax(dim=-1, keepdim=True).clamp_min_(1e-20).div_(127.0)
    k8 = kc.div_(ks).round_().to(torch.int8)
    qf = q.to(torch.float32, copy=True)
    qs = qf.abs().amax(dim=-1, keepdim=True).clamp_min_(1e-20).div_(127.0)
    q8 = qf.div_(qs).round_().to(torch.int8)
    return q8, qs[..., 0], k8, ks[..., 0]


def flash_attention_qk_int8_plain(q8, k8, v, qs, ks, scale: float,
                                  q_chunk: int | None = None) -> torch.Tensor:
    """K9's twin: the int8 score products exactly (as integers in fp32:
    |q8 . k8| <= 127**2 * 128 < 2**24), dequantized as ``(acc * (qs *
    scale)) * ks``, fp32 softmax, P.V in fp32; out in v's dtype.
    ``q_chunk`` rows of q at a time bound the fp32 score matrix."""
    if q_chunk is not None and q_chunk < q8.shape[1]:
        return torch.cat([flash_attention_qk_int8_plain(
            q8[:, r:r + q_chunk], k8, v, qs[:, r:r + q_chunk], ks, scale)
            for r in range(0, q8.shape[1], q_chunk)], dim=1)
    s = torch.einsum("bqhd,bkhd->bhqk", q8.float(), k8.float())
    s = s * (qs * scale).transpose(1, 2)[..., None] * ks.transpose(1, 2)[:, :, None, :]
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(v.dtype)


def _check_qk8(q8, k8, v, qs, ks) -> None:
    b, sq, h, d = q8.shape
    skv = k8.shape[1]
    for name, t, dtype, shape in (
            ("q8", q8, torch.int8, (b, sq, h, HEAD_DIM)),
            ("k8", k8, torch.int8, (b, skv, h, HEAD_DIM)),
            ("v", v, torch.bfloat16, (b, skv, h, HEAD_DIM)),
            ("qs", qs, torch.float32, (b, sq, h)), ("ks", ks, torch.float32, (b, skv, h))):
        if (t.device != q8.device or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"flash_fwd_qk8: {name} must be a contiguous {dtype} tensor of "
                             f"shape {shape} on {q8.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if sq == 0 or skv == 0:
        raise ValueError("flash_fwd_qk8: empty sequence")


def _forward_qk8(q8, k8, v, qs, ks, scale: float) -> torch.Tensor:
    """K9 for CUDA tensors, its twin for CPU tensors; out like v."""
    if q8.device.type == "cpu":
        return flash_attention_qk_int8_plain(q8, k8, v, qs, ks, scale)
    from chronoedit_tpu_torch.kernels import build

    _check_qk8(q8, k8, v, qs, ks)
    b, sq, h, d = q8.shape
    out = torch.empty(q8.shape, device=v.device, dtype=v.dtype)
    build.check(build.lib().flash_fwd_qk8_bf16(
        q8.data_ptr(), k8.data_ptr(), v.data_ptr(), qs.data_ptr(), ks.data_ptr(),
        out.data_ptr(), b, sq, k8.shape[1], h, d, scale,
        torch.cuda.current_stream().cuda_stream), "flash_fwd_qk8", k8.shape[1])
    return out


def flash_attention_qk_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            scale: float) -> torch.Tensor:
    """Attention with int8 q.k scores where JAX's rule sends the KV length
    to its int8-score kernel (:func:`uses_int8_scores`), else the bf16
    flash forward. Forward only: raises when autograd would need a
    gradient of the int8 path."""
    if not uses_int8_scores(k.shape[1], q.shape[-1], q.element_size()):
        return flash_attention(q, k, v, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention_qk_int8 is forward only, as JAX's")
    q8, qs, k8, ks = quantize_qk(q, k)
    return _forward_qk8(q8, k8, v, qs, ks, scale)
