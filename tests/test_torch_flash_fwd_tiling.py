"""The flash forward's tile order (K1/K5 in ``csrc/flash_fwd.cu``) against
the port's plain twin and the JAX package, on CPU.

The card's kernel takes KV in 128-row tiles: fp32 scores times scale *
log2 e, columns past Skv set to -inf (TMA zero-fills the rows past the
end), a running max and sum in fp32 with the base = 0 guard, exp2, P
rounded to bf16 each tile before P.V with fp32 accumulation, one divide by
the sum and one bf16 rounding, LSE through log2. ``tiled_forward`` below
repeats exactly that arithmetic in plain torch (it lives here, not in the
package: the package's twin is plain softmax attention). Held against
``flash_attention_plain`` and against JAX ``flash_attention`` /
``flash_attention_with_lse`` (its Pallas kernel in interpret mode) on
bf16-representable inputs made with numpy, within the bounds that
``chip_smoke.py`` applies to the kernel: ``K1_OUT_STEPS`` bf16 steps of
max|ref| (at most ``K1_OUT_MAX_TOL``) for the output, ``K1_LSE_TOL`` for
the LSE. So those bounds cover the 128-wide tiles' rounding of P.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chronoedit_tpu.ops import flash_attention as fa_j
from chronoedit_tpu_torch.ops import flash_attention as fa_t
from chronoedit_tpu_torch.tools import K1_LSE_TOL, K1_OUT_MAX_TOL, K1_OUT_STEPS, ULP_BF16

torch.set_num_threads(2)

B, H, D = 2, 2, 128
SCALE = D ** -0.5
TILE = 128  # KV rows a ring stage of the card's kernel


def tiled_forward(q, k, v, scale: float, tile: int = TILE, extra_tiles: int = 0):
    """The card kernel's arithmetic on (B, S, H, D) fp32 tensors holding
    bf16 values: returns (out as bf16 values in fp32, lse (B, Sq, H) fp32).
    ``extra_tiles`` appends tiles that lie wholly past Skv (all masked)."""
    skv = k.shape[1]
    qh, kh, vh = (t.permute(0, 2, 1, 3).float() for t in (q, k, v))  # (B, H, S, D)
    # the host multiplies in fp32: scale * log2 e
    scale_log2 = float(np.float32(scale) * np.float32(1.4426950408889634))
    n_tiles = -(-skv // tile) + extra_tiles
    pad = n_tiles * tile - skv  # rows TMA fills with zeros
    kh = torch.nn.functional.pad(kh, (0, 0, 0, pad))
    vh = torch.nn.functional.pad(vh, (0, 0, 0, pad))
    m = torch.full(qh.shape[:-1], -math.inf)
    l = torch.zeros(qh.shape[:-1])
    acc = torch.zeros(qh.shape)
    for t in range(n_tiles):
        cols = slice(t * tile, (t + 1) * tile)
        s = (qh @ kh[:, :, cols].transpose(-1, -2)) * scale_log2
        s[..., torch.arange(t * tile, (t + 1) * tile) >= skv] = -math.inf
        m_new = torch.maximum(m, s.amax(-1))
        base = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)
        alpha = torch.exp2(m - base)
        m = m_new
        p = torch.exp2(s - base[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.bfloat16().float() @ vh[:, :, cols]
    out = (acc * (1.0 / l)[..., None]).bfloat16().float()
    lse = (m + torch.log2(l)) * math.log(2.0)
    return out.permute(0, 2, 1, 3), lse.transpose(1, 2)


def _inputs(seed: int, sq: int, skv: int):
    """bf16-representable (B, S, H, D) q, k, v as fp32 tensors."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, s, H, D)).astype(np.float32))
            .bfloat16().float() for s in (sq, skv, skv)]


def _assert_within_k1_bounds(out, lse, ref_out, ref_lse):
    ref_max = float(ref_out.abs().max())
    tol = min(K1_OUT_MAX_TOL, K1_OUT_STEPS * ULP_BF16 * ref_max)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(lse).all())
    err = float((out - ref_out).abs().max())
    assert err <= tol, f"output off by {err:.3e} (bound {tol:.3e}, max|ref| {ref_max:.3f})"
    err_lse = float((lse - ref_lse).abs().max())
    assert err_lse <= K1_LSE_TOL, f"LSE off by {err_lse:.3e} (bound {K1_LSE_TOL})"


@pytest.mark.parametrize("sq,skv", [(1, 1), (127, 257), (129, 129), (200, 512), (300, 257)])
def test_tiled_forward_within_k1_bounds(sq, skv):
    """The 128-wide tile order against the plain twin and against JAX
    (output and LSE from ``flash_attention_with_lse``, the output again
    from the differentiable ``flash_attention``), within K1's bounds; the
    ragged q and KV lengths leave partial tiles on both sides."""
    q, k, v = _inputs(sq * 1000 + skv, sq, skv)
    out, lse = tiled_forward(q, k, v, SCALE)
    assert out.shape == (B, sq, H, D) and lse.shape == (B, sq, H)

    ref_out, ref_lse = fa_t.flash_attention_plain(q, k, v, SCALE)
    _assert_within_k1_bounds(out, lse, ref_out, ref_lse)

    qj, kj, vj = (jnp.asarray(t.numpy()) for t in (q, k, v))
    out_j, lse_j = fa_j.flash_attention_with_lse(qj, kj, vj, SCALE)
    _assert_within_k1_bounds(out, lse, torch.from_numpy(np.array(out_j)),
                             torch.from_numpy(np.array(lse_j)))
    want = torch.from_numpy(np.array(fa_j.flash_attention(qj, kj, vj, SCALE)))
    _assert_within_k1_bounds(out, lse, want, ref_lse)


def test_all_masked_tail_tile_stays_finite():
    """Skv = 129 leaves one live column in the second tile; a third tile
    wholly past Skv (every score -inf) must change nothing: its max is
    -inf, the running max keeps the earlier tiles', its P is 0. The result
    is finite, bitwise the two-tile result, and within K1's bounds."""
    q, k, v = _inputs(7, 129, 129)
    out, lse = tiled_forward(q, k, v, SCALE)
    out_x, lse_x = tiled_forward(q, k, v, SCALE, extra_tiles=1)
    assert torch.equal(out, out_x) and torch.equal(lse, lse_x)
    ref_out, ref_lse = fa_t.flash_attention_plain(q, k, v, SCALE)
    _assert_within_k1_bounds(out_x, lse_x, ref_out, ref_lse)
