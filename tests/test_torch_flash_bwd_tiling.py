"""The flash backward's tile order (K6 and K7 in ``csrc/flash_bwd.cu``)
against the port's plain twin and the JAX package, on CPU.

The card's K7 owns 128 KV rows a block and takes q in 64-row tiles: fp32
S^T and dP^T, P^T = exp2(S^T * scale log2 e - lse log2 e) with lse = +inf on
q rows past Sq (TMA zero-fills those rows of q and dO), dS^T = P^T (dP^T -
dsum) scale, both rounded to bf16 each tile before dV += P^T dO and dK +=
dS^T q with fp32 accumulation, one bf16 rounding of each output. K6 owns
128 q rows a block (lse = +inf past Sq) and takes KV in 128-row tiles: P
set to 0 on KV columns past Skv, dS rounded to bf16 each tile before dQ +=
dS k. ``k7_tiles`` and ``k6_tiles`` below repeat exactly that arithmetic in
plain torch (they live here, not in the package: the package's twin is the
plain fp32 backward). Held against ``flash_attention_bwd_plain`` and JAX
``flash_attention_bwd`` (its Pallas ``_backward`` in interpret mode) on
bf16-representable inputs made with numpy, B = 2, 2 heads, within the
bounds ``chip_smoke.py`` applies to the kernels (``K67_MAX_STEPS`` bf16
steps of max|ref|, ``K67_NORM_REL`` normwise), so those bounds cover the
tiles' rounding of P and dS. O and the LSE come from a forward over the
case's KV and 64 more keys, as a ring hop's backward gets them (the
external, global LSE the kernels keep taking): over its own single key the
case (1, 1) would give dQ = dK = 0 up to rounding.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chronoedit_tpu.ops import flash_attention as fa_j
from chronoedit_tpu_torch.ops import flash_attention as fa_t
from chronoedit_tpu_torch.tools import K67_MAX_STEPS, K67_NORM_REL, k67_check

torch.set_num_threads(2)

B, H, D = 2, 2, 128
SCALE = D ** -0.5
Q_TILE7, KV_BLOCK7 = 64, 128  # K7: q rows a ring stage, KV rows a block
Q_BLOCK6, KV_TILE6 = 128, 128  # K6: q rows a block, KV rows a ring stage
EXTRA_KEYS = 64  # keys of the global context beyond the case's KV
# the kernels' fp32 constants: scale * log2 e on the host, lse * log2 e on the card
LOG2E = np.float32(1.4426950408889634)
SCALE_LOG2 = float(np.float32(SCALE) * LOG2E)


def _bh(t):
    """(B, S, H, D) -> (B, H, S, D) fp32."""
    return t.permute(0, 2, 1, 3).float()


def _pad_rows(t, rows: int, value: float = 0.0):
    """Pad dim 2 of a (B, H, S, ...) tensor to ``rows`` with ``value``."""
    pad = rows - t.shape[2]
    return torch.nn.functional.pad(t, (0, 0) * (t.dim() - 3) + (0, pad), value=value)


def _rows(out, dout, lse, padded: int):
    """lse * log2 e (+inf on rows past Sq) and dsum (0 there), (B, H, rows)."""
    lse2 = _pad_rows(lse.transpose(1, 2).float() * float(LOG2E), padded, math.inf)
    dsum = (dout.float() * out.float()).sum(-1).transpose(1, 2)  # the wrapper's fp32 reduction
    return lse2, _pad_rows(dsum, padded)


def k7_tiles(q, k, v, out, dout, lse, scale: float, extra_tiles: int = 0):
    """K7's arithmetic: (dk, dv) (B, Skv, H, D) as bf16 values in fp32.
    ``extra_tiles`` appends q tiles that lie wholly past Sq."""
    sq, skv = q.shape[1], k.shape[1]
    n_tiles = -(-sq // Q_TILE7) + extra_tiles
    rows = n_tiles * Q_TILE7
    kv_rows = -(-skv // KV_BLOCK7) * KV_BLOCK7  # the block's rows past Skv: computed, not stored
    qh, doh = (_pad_rows(_bh(t), rows) for t in (q, dout))
    kh, vh = (_pad_rows(_bh(t), kv_rows) for t in (k, v))
    lse2, dsum = _rows(out, dout, lse, rows)
    dk = torch.zeros(kh.shape)
    dv = torch.zeros(vh.shape)
    for t in range(n_tiles):
        cols = slice(t * Q_TILE7, (t + 1) * Q_TILE7)
        st = kh @ qh[:, :, cols].transpose(-1, -2)  # (B, H, KV rows, q tile)
        dpt = vh @ doh[:, :, cols].transpose(-1, -2)
        pt = torch.exp2(st * SCALE_LOG2 - lse2[:, :, None, cols])
        dst = pt * (dpt - dsum[:, :, None, cols]) * scale
        dv += pt.bfloat16().float() @ doh[:, :, cols]
        dk += dst.bfloat16().float() @ qh[:, :, cols]
    return tuple(x[:, :, :skv].bfloat16().float().permute(0, 2, 1, 3) for x in (dk, dv))


def k6_tiles(q, k, v, out, dout, lse, scale: float, extra_tiles: int = 0):
    """K6's arithmetic: (dq (B, Sq, H, D) as bf16 values in fp32, the
    block rows past Sq before they are dropped). ``extra_tiles`` appends
    KV tiles that lie wholly past Skv."""
    sq, skv = q.shape[1], k.shape[1]
    rows = -(-sq // Q_BLOCK6) * Q_BLOCK6
    n_tiles = -(-skv // KV_TILE6) + extra_tiles
    qh, doh = (_pad_rows(_bh(t), rows) for t in (q, dout))
    kh, vh = (_pad_rows(_bh(t), n_tiles * KV_TILE6) for t in (k, v))  # TMA's zero fill
    lse2, dsum = _rows(out, dout, lse, rows)
    dq = torch.zeros(qh.shape)
    for t in range(n_tiles):
        cols = slice(t * KV_TILE6, (t + 1) * KV_TILE6)
        s = qh @ kh[:, :, cols].transpose(-1, -2)  # (B, H, q rows, KV tile)
        p = torch.exp2(s * SCALE_LOG2 - lse2[..., None])
        p[..., torch.arange(t * KV_TILE6, (t + 1) * KV_TILE6) >= skv] = 0.0
        dp = doh @ vh[:, :, cols].transpose(-1, -2)
        ds = p * (dp - dsum[..., None]) * scale
        dq += ds.bfloat16().float() @ kh[:, :, cols]
    dq = dq.bfloat16().float()
    return dq[:, :, :sq].permute(0, 2, 1, 3), dq[:, :, sq:]


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16().float()


def _case(seed: int, sq: int, skv: int, extra_keys: int = EXTRA_KEYS):
    """bf16-representable q, k, v, dO, and O (rounded to bf16, as the card
    gets it) and the LSE of the forward over k, v and ``extra_keys`` more
    keys, which the backward does not see."""
    rng = np.random.default_rng(seed)
    q, dout = _bf16(rng, B, sq, H, D), _bf16(rng, B, sq, H, D)
    kg, vg = _bf16(rng, B, skv + extra_keys, H, D), _bf16(rng, B, skv + extra_keys, H, D)
    out, lse = fa_t.flash_attention_plain(q, kg, vg, SCALE)
    return q, kg[:, :skv], vg[:, :skv], out.bfloat16().float(), dout, lse


def _assert_within_k67(got, want):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = torch.as_tensor(np.array(w))
        assert g.shape == w.shape, name
        c = k67_check(g, w)
        assert c["ok"], (f"{name}: max {c['max']:.3e} (bound {c['tol']:.3e}, {K67_MAX_STEPS} "
                         f"steps), normwise {c['rel']:.3e} (bound {K67_NORM_REL})")


def _tiled(case):
    dq, pad_rows = k6_tiles(*case, SCALE)
    dk, dv = k7_tiles(*case, SCALE)
    return (dq, dk, dv), pad_rows


@pytest.mark.parametrize("sq,skv", [(1, 1), (127, 257), (129, 129), (200, 512), (300, 257)])
def test_tiled_backward_within_k67_bounds(sq, skv):
    """K7's 128 x 64 tile order and K6's 128 x 128 against the plain twin
    and against JAX's Pallas backward, on the same O and global LSE, within
    the K67 bounds; the ragged lengths leave partial tiles on both sides,
    and K6's block rows past Sq (lse = +inf) stay exactly 0."""
    case = _case(sq * 1000 + skv, sq, skv)
    got, pad_rows = _tiled(case)
    assert bool(torch.isfinite(torch.cat([g.flatten() for g in got])).all())
    assert not bool(pad_rows.any())
    _assert_within_k67(got, fa_t.flash_attention_bwd_plain(*case, SCALE))
    want = fa_j.flash_attention_bwd(*(jnp.asarray(t.numpy()) for t in case), SCALE)
    _assert_within_k67(got, want)


def test_tiled_backward_with_the_forwards_own_lse():
    """The training path's call: O and LSE of the forward over the same KV
    (no other keys), at (200, 512), against the twin and JAX."""
    case = _case(11, 200, 512, extra_keys=0)
    got, _ = _tiled(case)
    _assert_within_k67(got, fa_t.flash_attention_bwd_plain(*case, SCALE))
    _assert_within_k67(got, fa_j.flash_attention_bwd(*(jnp.asarray(t.numpy()) for t in case),
                                                     SCALE))


def test_q_tile_wholly_past_the_end_changes_nothing():
    """Sq = 128 fills two q tiles of K7 exactly; a third, wholly past Sq
    (q and dO zero, lse +inf), gives P^T = dS^T = 0 and must change no bit
    of dK or dV."""
    case = _case(7, 128, 129)
    base = k7_tiles(*case, SCALE)
    extra = k7_tiles(*case, SCALE, extra_tiles=1)
    assert all(torch.equal(a, b) for a, b in zip(base, extra))


def test_kv_tile_wholly_past_the_end_changes_nothing():
    """Skv = 129 leaves one live column in K6's second tile; a third tile,
    wholly past Skv (K and V zero-filled, P set to 0 there, where exp(-lse)
    would not vanish), must change no bit of dQ."""
    case = _case(8, 129, 129)
    base, _ = k6_tiles(*case, SCALE)
    extra, _ = k6_tiles(*case, SCALE, extra_tiles=1)
    assert torch.equal(base, extra)
    _assert_within_k67((extra,), fa_t.flash_attention_bwd_plain(*case, SCALE)[:1])


def test_kv_columns_past_the_end_masked_where_exp_overflows():
    """Zero-filled K rows score 0, so an unmasked column past Skv has P =
    exp(-lse), whose dS meets only zero K rows: harmless while it is
    finite. With every score near -100 (q near 3, k near -3) exp(-lse)
    overflows fp32, and inf times a zero K row is NaN: K6 must set P = 0
    there. Sq = 64, Skv = 129 (127 masked columns), with the global LSE of
    64 more keys of the same kind."""
    rng = np.random.default_rng(9)
    q = (3.0 + 0.1 * _bf16(rng, B, 64, H, D)).bfloat16().float()
    kg = (-3.0 + 0.1 * _bf16(rng, B, 129 + EXTRA_KEYS, H, D)).bfloat16().float()
    vg, dout = _bf16(rng, B, 129 + EXTRA_KEYS, H, D), _bf16(rng, B, 64, H, D)
    out, lse = fa_t.flash_attention_plain(q, kg, vg, SCALE)
    assert float(lse.max()) < -90.0
    case = (q, kg[:, :129], vg[:, :129], out.bfloat16().float(), dout, lse)
    got, _ = _tiled(case)
    _assert_within_k67(got, fa_t.flash_attention_bwd_plain(*case, SCALE))
    _assert_within_k67(got, fa_j.flash_attention_bwd(*(jnp.asarray(t.numpy()) for t in case),
                                                     SCALE))
