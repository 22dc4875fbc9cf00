"""Context (sequence) parallelism: ring and Ulysses attention over the
``context`` axis of a mesh.

The port of ``chronoedit_tpu/parallel/context.py``. Each rank holds one
contiguous block of the token sequence, (B, S/P, H, D), for P ranks in its
context group.

- :func:`ring_attention_inner`: the K/V blocks travel around the ring
  (``collectives.ring_shift_start``, the counterpart of ``ppermute``), and
  each hop attends the local queries to the block it holds. At head dims
  that are a multiple of 128 every hop is ``flash_attention_with_lse``
  (K1/K5 on the card, its twin on the CPU), its output rounded to q's dtype
  as JAX's is, and the hops merge by log-sum-exp in fp32. The backward is
  exact: an autograd Function re-rotates K/V and gives each hop's
  ``flash_attention_bwd`` (K6/K7) the merged output and the *global* LSE,
  so that ``exp(q k_hop - lse)`` is the globally normalised probability
  block. dq sums locally; dk/dv accumulate in fp32 buffers that rotate with
  their block, and one more rotation after the last hop brings each home.
  Other head dims take an exact dense per-hop merge in plain torch
  (:func:`ring_attention_dense_inner`), differentiable through autograd.
  The hop's transfer of the next block starts before the hop's kernel.
- :func:`ulysses_attention_inner`: two all-to-alls swap the sequence split
  for a head split, so each rank attends over the whole sequence with H/P
  heads through the normal attention dispatch (``ops/attention.py``: K1/K5,
  or K9 with int8 scores), and swap back.

The ring has no int8-score form: K9 writes no LSE, which the merge needs.
JAX ignores ``attn_qk_int8`` on both context-parallel branches; the port
honours it under Ulysses and refuses it on the ring
(:func:`check_ring_qk_int8`).

The "inner" functions take the context group; the wrappers take a mesh.
Without a mesh there is no ``shard_map`` to open: the tensors a rank holds
are already its shards, so :func:`split_sequence` takes this rank's block
of a replicated tensor and :func:`gather_sequence` puts the blocks back
together on every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from chronoedit_tpu_torch.parallel import collectives as C
from chronoedit_tpu_torch.parallel.mesh import AXIS_CONTEXT


def check_ring_qk_int8(qk_int8: bool) -> None:
    """The ring merges hops by their LSE, which the int8-score kernel does
    not write: refuse the combination."""
    if qk_int8:
        raise ValueError(
            "attn_qk_int8 with context_parallel='ring': the ring merges its hops by "
            "their log-sum-exp, and the int8-score kernel (K9) writes none; use "
            "context_parallel='ulysses' (or 'auto' with heads divisible by the "
            "context size) for int8 scores under context parallelism")


# ------------------------------------------------------------ dense ring

def ring_attention_dense_inner(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               group, scale: float | None = None) -> torch.Tensor:
    """Ring attention on sequence-sharded q/k/v (B, S_loc, H, D) with an
    exact fp32 online-softmax merge per hop; differentiable (the shifts'
    gradients travel back around the ring). One (B, H, S_loc, S_blk) fp32
    score block per hop: small sizes and head dims that are not a multiple
    of 128 only."""
    n = dist.get_world_size(group)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf = q.float() * scale
    b, s, h, d = q.shape
    acc = torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, s, h, 1), -torch.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, s, h, 1), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for step in range(n):
        s_blk = torch.einsum("bqhd,bkhd->bqhk", qf, k_cur.float())
        m_new = torch.maximum(m, s_blk.amax(dim=-1, keepdim=True))
        p = torch.exp(s_blk - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bqhk,bkhd->bqhd", p, v_cur.float())
        m = m_new
        if step != n - 1:
            k_cur = C.RingShift.apply(k_cur, group, 1)
            v_cur = C.RingShift.apply(v_cur, group, 1)
    return (acc / l).to(q.dtype)


# ------------------------------------------------------------ flash ring

def _ring_flash_forward(q, k, v, group, scale: float):
    """n flash hops merged by log-sum-exp: with hop i's normalised output
    o_i (rounded to q's dtype) and its lse_i (B, S_loc, H), the total is
    sum_i exp(lse_i - lse) o_i with lse the log-sum-exp of the lse_i.
    Returns (out in q's dtype, lse fp32)."""
    from chronoedit_tpu_torch.ops.flash_attention import flash_attention_with_lse

    n = dist.get_world_size(group)
    kv = [k, v]
    out_f = lse_acc = None
    for step in range(n):
        pending = C.ring_shift_start(kv, group) if step != n - 1 else None
        o_i, lse_i = flash_attention_with_lse(q, *kv, scale)
        if step == 0:
            out_f, lse_acc = o_i.float(), lse_i
        else:
            lse_new = torch.logaddexp(lse_acc, lse_i)
            out_f = (out_f * torch.exp(lse_acc - lse_new)[..., None]
                     + o_i.float() * torch.exp(lse_i - lse_new)[..., None])
            lse_acc = lse_new
        if pending is not None:
            kv = pending.wait()
    return out_f.to(q.dtype), lse_acc.contiguous()


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, scale: float):
        out, lse = _ring_flash_forward(q, k, v, group, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.scale = group, scale
        return out

    @staticmethod
    def backward(ctx, g):
        from chronoedit_tpu_torch.ops.flash_attention import flash_attention_bwd

        q, k, v, out, lse = ctx.saved_tensors
        group, scale = ctx.group, ctx.scale
        n = dist.get_world_size(group)
        g = g.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        # at hop t rank i holds block (i - t) mod n and adds its part of that
        # block's gradient to the buffers travelling with it
        dk_rot = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_rot = torch.zeros_like(dk_rot)
        k_cur, v_cur = k, v
        for step in range(n):
            pending = (C.ring_shift_start([k_cur, v_cur], group) if step != n - 1
                       else None)
            dq_h, dk_h, dv_h = flash_attention_bwd(q, k_cur, v_cur, out, g, lse, scale)
            dq += dq_h.float()
            dk_rot += dk_h.float()
            dv_rot += dv_h.float()
            # the buffers move on with their block; after the last hop one
            # more shift brings each home
            dk_rot, dv_rot = C.ring_shift([dk_rot, dv_rot], group, tag=2)
            if pending is not None:
                k_cur, v_cur = pending.wait()
        return dq.to(q.dtype), dk_rot.to(k.dtype), dv_rot.to(v.dtype), None, None


def ring_flash_attention_inner(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               group, scale: float | None = None) -> torch.Tensor:
    """Flash-kernel ring attention (K1/K5 hops, K6/K7 backward with the
    global LSE)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _RingFlash.apply(q, k, v, group, float(scale))


def ring_attention_inner(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                         scale: float | None = None) -> torch.Tensor:
    """Ring attention on sequence-sharded q/k/v (B, S_loc, H, D): the flash
    ring when the head dim is a multiple of 128, else the dense merge."""
    if q.shape[-1] % 128 == 0:
        return ring_flash_attention_inner(q, k, v, group, scale)
    return ring_attention_dense_inner(q, k, v, group, scale)


# ------------------------------------------------------------ ulysses

def ulysses_attention_inner(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                            scale: float | None = None,
                            qk_int8: bool = False) -> torch.Tensor:
    """Ulysses attention on sequence-sharded q/k/v (B, S_loc, H, D): an
    all-to-all to (B, S, H/P, D), attention over the whole sequence
    (``ops.attention.dot_product_attention`` with ``qk_int8``), and the
    all-to-all back. Raises ValueError when the heads
    do not divide by the group's size."""
    from chronoedit_tpu_torch.ops.attention import dot_product_attention

    n = dist.get_world_size(group)
    if q.shape[2] % n:
        raise ValueError(f"heads {q.shape[2]} not divisible by axis size {n}")

    def to_heads(x):  # (B, S_loc, H, D) -> (B, S, H_loc, D)
        return C.all_to_all_autograd(x, group, 2, 1)

    out = dot_product_attention(to_heads(q), to_heads(k), to_heads(v), scale=scale,
                                qk_int8=qk_int8)
    return C.all_to_all_autograd(out, group, 1, 2)


# ------------------------------------------------------------------ wrappers

def ring_attention(q, k, v, mesh, scale=None, axis: str = AXIS_CONTEXT):
    """Ring attention over ``mesh``'s ``axis``; q/k/v are this rank's
    sequence blocks (B, S/P, H, D)."""
    return ring_attention_inner(q, k, v, mesh.group(axis), scale)


def ulysses_attention(q, k, v, mesh, scale=None, axis: str = AXIS_CONTEXT):
    """Ulysses attention over ``mesh``'s ``axis``; q/k/v are this rank's
    sequence blocks (B, S/P, H, D)."""
    return ulysses_attention_inner(q, k, v, mesh.group(axis), scale)


# ------------------------------------------------------------------ seq split

def split_sequence(x: torch.Tensor, mesh, seq_dim: int = 2,
                   axis: str = AXIS_CONTEXT) -> torch.Tensor:
    """This rank's contiguous block of a tensor every rank holds whole,
    along ``seq_dim`` (the reference's ``broadcast_split_tensor``)."""
    n = mesh.shape.get(axis, 1)
    if x.shape[seq_dim] % n:
        raise ValueError(f"dim {seq_dim} of {tuple(x.shape)} not divisible by {axis} "
                         f"size {n}")
    return x.chunk(n, dim=seq_dim)[mesh.index(axis)]


def gather_sequence(x: torch.Tensor, mesh, seq_dim: int = 2,
                    axis: str = AXIS_CONTEXT) -> torch.Tensor:
    """The blocks of :func:`split_sequence` put back together on every rank
    (the reference's ``cat_outputs_cp``); differentiable."""
    if mesh.shape.get(axis, 1) == 1:
        return x
    return C.gather_sequence_autograd(x, mesh.group(axis), seq_dim)
