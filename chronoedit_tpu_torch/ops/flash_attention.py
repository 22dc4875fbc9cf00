"""Flash-attention forward (K1 and K5): a hand-written Hopper kernel and its twin.

The CUDA kernel (``csrc/flash_fwd.cu``) takes (B, S, H, 128) bf16 q/k/v in
place — no transpose to a (B*H, S, D) layout and no padding: it masks the
ragged q and KV tails itself — and returns O in bf16 and the per-row
log-sum-exp in fp32. The TPU kernel's VMEM planning (resident vs streamed
KV, block planners, k-major and grouped variants) has no counterpart: the
CUDA kernel always streams KV tiles through shared memory, so the one
kernel serves both TPU kernels, the resident K1 (the edit's 7,200 tokens
and the cross-attention) and the streamed K5 (reasoning self-attention at
28,800 tokens). Launches are counted by name and by KV length
(``kernels/build.py``), which tells the two roles apart.
"""

from __future__ import annotations

import torch

HEAD_DIM = 128  # the only head dim K1 is built for


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


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Non-causal attention, BSHD. Returns ``(out, lse)`` with out
    (B, Sq, H, D) in q's dtype and lse (B, Sq, H) fp32 (a view of the
    kernel's (B, H, Sq) buffer)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    from chronoedit_tpu_torch.kernels import build

    _check(q, k, v)
    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), device=q.device, dtype=torch.float32)
    build.check(build.lib().flash_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, sq, k.shape[1], h, d, scale, torch.cuda.current_stream().cuda_stream),
        "flash_fwd", kv_len=k.shape[1])
    return out, lse.transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Non-causal attention output only, (B, Sq, H, D)."""
    return flash_attention_with_lse(q, k, v, scale)[0]
