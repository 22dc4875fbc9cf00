"""The grouped flash kernels' tile order (X1 in ``csrc/flash_fwd.cu``, X2 in
``csrc/flash_bwd.cu``) against the port's plain twins and the JAX
package's grouped experiments, on CPU.

X1 (``flash_fwd_grouped_wgmma_kernel<N>``) takes KV N x 64 rows a step:
fp32 scores times scale * log2 e, columns past Skv set to -inf (TMA
zero-fills the rows past the end), one combined row max over the step's N
tiles with the base = 0 guard, one alpha and one rescale of the
accumulator, then each tile's exp2 and its P rounded to bf16 before P.V
with fp32 accumulation; one divide by the sum and one bf16 rounding, LSE
through log2. ``x1_steps`` repeats that arithmetic in plain torch.

X2 is K6/K7 with a ring stage of N tiles: dK and dV take q N x 32 rows a
step, dQ takes KV N x 64 rows a step, and a step too large for the
consumers' registers (N = 4 on both sides) goes in parts of K7's 64 q rows
and K6's 128 KV rows. ``dkv_steps`` and ``dq_steps`` repeat that
arithmetic: P^T / P = exp2(scores * scale log2 e - lse log2 e), lse = +inf
on q rows past Sq, P = 0 on KV columns past Skv (dQ), dS = P (dP - dsum)
scale, P and dS rounded to bf16 per part before the products that use
them, fp32 accumulation, one bf16 rounding of each output.

All are held against ``flash_attention_plain`` / ``flash_attention_bwd_plain``
and against JAX ``tools/exp_flash_paired.py`` ``paired_flash`` (its
``_grouped_kernel``) and ``tools/exp_flash_bwd_grouped.py``
``grouped_backward`` (``_dq_kernel_grouped``, ``_dkv_kernel_grouped``),
both in interpret mode at the port's tile sizes, on bf16-representable
inputs made with numpy, B = 2, 2 heads, within the bounds ``chip_smoke.py``
applies to the kernels (K1's for X1, the K67 bounds for X2). The backward
cases take O and the LSE of a forward over the case's KV and 64 more keys,
as a ring hop's backward gets them.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chronoedit_tpu.ops import flash_attention as fa_j
from chronoedit_tpu_torch.ops import flash_attention as fa_t
from chronoedit_tpu_torch.tools import (K1_LSE_TOL, K1_OUT_MAX_TOL, K1_OUT_STEPS, K67_MAX_STEPS,
                                        K67_NORM_REL, ULP_BF16, k67_check)
from test_torch_grouped_flash import _load_jax_tool

torch.set_num_threads(2)

xp_j = _load_jax_tool("exp_flash_paired")
xb_j = _load_jax_tool("exp_flash_bwd_grouped")

B, H, D = 2, 2, 128
SCALE = D ** -0.5
LOG2E = np.float32(1.4426950408889634)
SCALE_LOG2 = float(np.float32(SCALE) * LOG2E)  # the host multiplies in fp32
X1_TILE = 64  # KV rows of one of X1's N tiles
DKV_TILE, DKV_PART = 32, 64  # q rows of an X2 dK/dV tile; of one of K7's steps
DQ_TILE, DQ_PART = 64, 128  # KV rows of an X2 dQ tile; of one of K6's steps
Q_BLOCK6 = 128  # q rows a dQ block
KV_BLOCK7 = 128  # KV rows a dK/dV block
EXTRA_KEYS = 64
# (Sq, Skv): one row; a q tail and a KV tail (257: at N = 4 the second step
# holds one live column, its three other tiles wholly masked); one row past
# a tile; a short q; 300 ragged against every step size
CASES = [(1, 1), (127, 257), (129, 129), (200, 512), (300, 257)]


def _bh(t):
    """(B, S, H, D) -> (B, H, S, D) fp32."""
    return t.permute(0, 2, 1, 3).float()


def _pad_rows(t, rows: int, value: float = 0.0):
    """Pad dim 2 of a (B, H, S, ...) tensor to ``rows`` with ``value``."""
    pad = rows - t.shape[2]
    return torch.nn.functional.pad(t, (0, 0) * (t.dim() - 3) + (0, pad), value=value)


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16().float()


# ------------------------------------------------------------------ X1

def x1_steps(q, k, v, n: int, extra_steps: int = 0, kv_len: int | None = None):
    """X1's arithmetic with ``n`` 64-row KV tiles a step on (B, S, H, D)
    fp32 tensors holding bf16 values: (out as bf16 values in fp32, lse (B,
    Sq, H)). ``extra_steps`` appends steps wholly past Skv; ``kv_len``
    (default: all of k) is Skv, the rows of k and v past it stand where
    TMA's zero fill would."""
    skv = k.shape[1] if kv_len is None else kv_len
    step = n * X1_TILE
    n_steps = -(-skv // step) + extra_steps
    qh = _bh(q)
    kh, vh = (_pad_rows(_bh(t)[:, :, :n_steps * step], n_steps * step) for t in (k, v))
    m = torch.full(qh.shape[:-1], -math.inf)
    l = torch.zeros(qh.shape[:-1])
    acc = torch.zeros(qh.shape)
    for it in range(n_steps):
        tiles = []
        for i in range(n):
            c0 = it * step + i * X1_TILE
            s = (qh @ kh[:, :, c0:c0 + X1_TILE].transpose(-1, -2)) * SCALE_LOG2
            s[..., torch.arange(c0, c0 + X1_TILE) >= skv] = -math.inf
            tiles.append(s)
        m_new = torch.maximum(m, torch.stack([s.amax(-1) for s in tiles]).amax(0))
        base = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)
        alpha = torch.exp2(m - base)
        m = m_new
        l = l * alpha
        acc = acc * alpha[..., None]
        for i, s in enumerate(tiles):
            c0 = it * step + i * X1_TILE
            p = torch.exp2(s - base[..., None])
            l = l + p.sum(-1)
            acc = acc + p.bfloat16().float() @ vh[:, :, c0:c0 + X1_TILE]
    out = (acc * (1.0 / l)[..., None]).bfloat16().float()
    lse = (m + torch.log2(l)) * math.log(2.0)
    return out.permute(0, 2, 1, 3), lse.transpose(1, 2)


def _fwd_inputs(seed: int, sq: int, skv: int):
    rng = np.random.default_rng(seed)
    return _bf16(rng, B, sq, H, D), _bf16(rng, B, skv, H, D), _bf16(rng, B, skv, H, D)


def _assert_within_k1_bounds(out, ref_out, lse=None, ref_lse=None):
    ref_max = float(ref_out.abs().max())
    tol = min(K1_OUT_MAX_TOL, K1_OUT_STEPS * ULP_BF16 * ref_max)
    assert bool(torch.isfinite(out).all())
    err = float((out - ref_out).abs().max())
    assert err <= tol, f"output off by {err:.3e} (bound {tol:.3e}, max|ref| {ref_max:.3f})"
    if lse is not None:
        err_lse = float((lse - ref_lse).abs().max())
        assert err_lse <= K1_LSE_TOL, f"LSE off by {err_lse:.3e} (bound {K1_LSE_TOL})"


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("sq,skv", CASES)
def test_x1_steps_within_k1_bounds(sq, skv, n):
    """X1's step order at every group against the plain twin (output and
    LSE) and JAX ``paired_flash`` with n 64-row KV blocks a step (its
    ``_grouped_kernel`` in interpret mode, 128-row q blocks), within K1's
    bounds; the ragged lengths leave partial tiles and, at 257 and n = 4,
    a step with three wholly masked tiles."""
    q, k, v = _fwd_inputs(sq * 1000 + skv + n, sq, skv)
    out, lse = x1_steps(q, k, v, n)
    assert out.shape == (B, sq, H, D) and lse.shape == (B, sq, H)
    ref_out, ref_lse = fa_t.flash_attention_plain(q, k, v, SCALE)
    _assert_within_k1_bounds(out, ref_out, lse, ref_lse)
    want = xp_j.paired_flash(*(jnp.asarray(t.numpy()) for t in (q, k, v)), SCALE,
                             block_q=128, block_kv=X1_TILE, n=n)
    _assert_within_k1_bounds(out, torch.from_numpy(np.array(want)))


@pytest.mark.parametrize("n", [2, 3, 4])
def test_x1_step_wholly_past_the_end_changes_nothing(n):
    """A step wholly past Skv (every score -inf: its max is -inf, the
    running max keeps the earlier steps', alpha is 1, P is 0) changes no
    bit of the output or the LSE, at Skv = 129 (one live column past the
    first 128)."""
    q, k, v = _fwd_inputs(70 + n, 129, 129)
    base = x1_steps(q, k, v, n)
    extra = x1_steps(q, k, v, n, extra_steps=1)
    assert all(torch.equal(a, b) for a, b in zip(base, extra))


@pytest.mark.parametrize("n", [2, 3, 4])
def test_x1_masks_every_column_past_the_end(n):
    """What the mask leaves out is exactly the columns past Skv: K and V
    rows past Skv = 257 filled with random values instead of TMA's zeros
    change no bit, at every group (at n = 4 the second step's last three
    tiles are wholly masked, its first holds one live column)."""
    q, k, v = _fwd_inputs(80 + n, 64, 257)
    rng = np.random.default_rng(81)
    k_x, v_x = (torch.cat([t, _bf16(rng, B, 255, H, D)], 1) for t in (k, v))
    base = x1_steps(q, k, v, n)
    filled = x1_steps(q, k_x, v_x, n, kv_len=257)
    assert all(torch.equal(a, b) for a, b in zip(base, filled))


# ------------------------------------------------------------------ X2

def _rows(out, dout, lse, padded: int):
    """lse * log2 e (+inf on rows past Sq) and dsum (0 there), (B, H, rows)."""
    lse2 = _pad_rows(lse.transpose(1, 2).float() * float(LOG2E), padded, math.inf)
    dsum = (dout.float() * out.float()).sum(-1).transpose(1, 2)  # the wrapper's fp32 reduction
    return lse2, _pad_rows(dsum, padded)


def dkv_steps(q, k, v, out, dout, lse, n: int, part: int = DKV_PART, extra_steps: int = 0):
    """X2 dK/dV's arithmetic: (dk, dv) (B, Skv, H, D) as bf16 values in fp32,
    q taken n x 32 rows a step, each step in parts of ``part`` q rows (at
    most the step; the kernel's is 64). ``extra_steps`` appends steps wholly
    past Sq."""
    sq, skv = q.shape[1], k.shape[1]
    step = n * DKV_TILE
    part = min(part, step)
    rows = (-(-sq // step) + extra_steps) * step
    kv_rows = -(-skv // KV_BLOCK7) * KV_BLOCK7
    qh, doh = (_pad_rows(_bh(t), rows) for t in (q, dout))
    kh, vh = (_pad_rows(_bh(t), kv_rows) for t in (k, v))
    lse2, dsum = _rows(out, dout, lse, rows)
    dk = torch.zeros(kh.shape)
    dv = torch.zeros(vh.shape)
    for r0 in range(0, rows, part):
        cols = slice(r0, r0 + part)
        st = kh @ qh[:, :, cols].transpose(-1, -2)
        dpt = vh @ doh[:, :, cols].transpose(-1, -2)
        pt = torch.exp2(st * SCALE_LOG2 - lse2[:, :, None, cols])
        dst = pt * (dpt - dsum[:, :, None, cols]) * SCALE
        dv += pt.bfloat16().float() @ doh[:, :, cols]
        dk += dst.bfloat16().float() @ qh[:, :, cols]
    return tuple(x[:, :, :skv].bfloat16().float().permute(0, 2, 1, 3) for x in (dk, dv))


def dq_steps(q, k, v, out, dout, lse, n: int, part: int = DQ_PART, extra_steps: int = 0):
    """X2 dQ's arithmetic: dq (B, Sq, H, D) as bf16 values in fp32, KV taken
    n x 64 rows a step, each step in parts of ``part`` KV rows (at most the
    step; the kernel's is 128). ``extra_steps`` appends steps wholly past
    Skv."""
    sq, skv = q.shape[1], k.shape[1]
    step = n * DQ_TILE
    part = min(part, step)
    rows = -(-sq // Q_BLOCK6) * Q_BLOCK6
    kv_rows = (-(-skv // step) + extra_steps) * step
    qh, doh = (_pad_rows(_bh(t), rows) for t in (q, dout))
    kh, vh = (_pad_rows(_bh(t), kv_rows) for t in (k, v))  # TMA's zero fill
    lse2, dsum = _rows(out, dout, lse, rows)
    dq = torch.zeros(qh.shape)
    for c0 in range(0, kv_rows, part):
        cols = slice(c0, c0 + part)
        s = qh @ kh[:, :, cols].transpose(-1, -2)
        p = torch.exp2(s * SCALE_LOG2 - lse2[..., None])
        p[..., torch.arange(c0, c0 + part) >= skv] = 0.0
        dp = doh @ vh[:, :, cols].transpose(-1, -2)
        ds = p * (dp - dsum[..., None]) * SCALE
        dq += ds.bfloat16().float() @ kh[:, :, cols]
    return dq.bfloat16().float()[:, :, :sq].permute(0, 2, 1, 3)


def _bwd_case(seed: int, sq: int, skv: int):
    """bf16-representable q, k, v, dO, and O (rounded to bf16) and the LSE
    of a forward over k, v and EXTRA_KEYS more keys the backward does not
    see."""
    rng = np.random.default_rng(seed)
    q, dout = _bf16(rng, B, sq, H, D), _bf16(rng, B, sq, H, D)
    kg, vg = _bf16(rng, B, skv + EXTRA_KEYS, H, D), _bf16(rng, B, skv + EXTRA_KEYS, H, D)
    out, lse = fa_t.flash_attention_plain(q, kg, vg, SCALE)
    return q, kg[:, :skv], vg[:, :skv], out.bfloat16().float(), dout, lse


def _jax_grouped_backward(case, n_dq: int, n_dkv: int):
    """JAX ``grouped_backward`` at the port's tiles (32-row q blocks for dK
    and dV, 64-row KV blocks for dQ) on ``case``'s buffers: padded to 128 q
    and 256 KV rows (every group's multiple), lse = +inf on the padded q
    rows. Returns (dq, dk, dv) (B, S, H, D) numpy."""
    q, k, v, out, dout, lse = (jnp.asarray(t.numpy()) for t in case)
    sq, skv = q.shape[1], k.shape[1]
    qb, ob, dob = (fa_j._pad_to(fa_j._to_bh(t), 1, 128) for t in (q, out, dout))
    kb, vb = (fa_j._pad_to(fa_j._to_bh(t), 1, 256) for t in (k, v))
    lse_bh = fa_j._pad_to(lse.transpose(0, 2, 1).reshape(B * H, sq), 1, 128)
    lse_bh = jnp.where(jnp.arange(lse_bh.shape[1])[None] < sq, lse_bh, jnp.inf)
    lse_bh = jnp.broadcast_to(lse_bh[:, None, :], (B * H, 8, lse_bh.shape[1]))
    dq, dk, dv = xb_j.grouped_backward(qb, kb, vb, ob, dob, lse_bh, SCALE, DKV_TILE, DQ_TILE,
                                       skv, n_dq=n_dq, n_dkv=n_dkv)
    return (np.array(fa_j._from_bh(dq, B, H, sq)), np.array(fa_j._from_bh(dk, B, H, skv)),
            np.array(fa_j._from_bh(dv, B, H, skv)))


def _assert_within_k67(got, want):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = torch.as_tensor(np.array(w))
        assert g.shape == w.shape, name
        c = k67_check(g, w)
        assert c["ok"], (f"{name}: max {c['max']:.3e} (bound {c['tol']:.3e}, {K67_MAX_STEPS} "
                         f"steps), normwise {c['rel']:.3e} (bound {K67_NORM_REL})")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("sq,skv", CASES)
def test_x2_steps_within_k67_bounds(sq, skv, n):
    """X2's step order (dQ and dK/dV both at group n) against the plain
    twin and JAX ``grouped_backward`` (n_dq = n_dkv = n, interpret mode),
    on the same O and global LSE, within the K67 bounds; the ragged
    lengths leave partial steps on both sides."""
    case = _bwd_case(sq * 1000 + skv + n, sq, skv)
    got = (dq_steps(*case, n), *dkv_steps(*case, n))
    assert bool(torch.isfinite(torch.cat([g.flatten() for g in got])).all())
    _assert_within_k67(got, fa_t.flash_attention_bwd_plain(*case, SCALE))
    _assert_within_k67(got, _jax_grouped_backward(case, n, n))


@pytest.mark.parametrize("n_dq,n_dkv", [(2, 4), (4, 2)])
def test_x2_mixed_groups_within_k67_bounds(n_dq, n_dkv):
    """The tools' mixed variants: each side on its own group, against JAX
    ``grouped_backward`` with the same pair, at (300, 257)."""
    case = _bwd_case(90 + n_dq, 300, 257)
    got = (dq_steps(*case, n_dq), *dkv_steps(*case, n_dkv))
    _assert_within_k67(got, _jax_grouped_backward(case, n_dq, n_dkv))


@pytest.mark.parametrize("sq,skv", [(129, 129), (300, 257)])
def test_x2_group4_parts_are_k6_k7_steps_bitwise(sq, skv):
    """The N = 4 split the design uses: a 128-row q step in two 64-row parts
    is K7's own 64-row order (group 2), and a 256-row KV step in two 128-row
    parts is K6's 128-row order (group 2), bit for bit; issued whole instead
    (one part of the step), both stay within the K67 bounds of the split."""
    case = _bwd_case(sq + skv, sq, skv)
    split = (dq_steps(*case, 4), *dkv_steps(*case, 4))
    k67 = (dq_steps(*case, 2), *dkv_steps(*case, 2))
    assert all(torch.equal(a, b) for a, b in zip(split, k67))
    whole = (dq_steps(*case, 4, part=256), *dkv_steps(*case, 4, part=128))
    _assert_within_k67(whole, split)


@pytest.mark.parametrize("n", [2, 4])
def test_x2_step_wholly_past_the_end_changes_nothing(n):
    """A q step wholly past Sq (q and dO zero-filled, lse +inf: P^T = dS^T =
    0) changes no bit of dK or dV, and a KV step wholly past Skv (K and V
    zero-filled, P set to 0) no bit of dQ."""
    case = _bwd_case(60 + n, 128, 129)
    assert all(torch.equal(a, b) for a, b in zip(dkv_steps(*case, n),
                                                 dkv_steps(*case, n, extra_steps=1)))
    assert torch.equal(dq_steps(*case, n), dq_steps(*case, n, extra_steps=1))
