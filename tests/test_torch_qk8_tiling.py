"""K9's tile order (``csrc/flash_fwd_qk8.cu``) in plain torch, against the
port's twin and the JAX package, on CPU.

The card's kernel takes KV in 128-row tiles: the s32 scores q8 . k8 exactly
(wgmma s8 x s8 -> s32), dequantized in JAX's order ``y = float(acc) * (qs
* scale) * ks``; columns past Skv set to -inf (TMA zero-fills k8's rows
and the producer stages ks = 0 there, permuted so that each thread reads
its 32 columns as eight 16-byte loads); a running max in the log2 domain (the
tile's max y times log2 e, rounded once) and sum in fp32 with the base = 0
guard, P = exp2(y log2 e - base) with the product and the subtraction in
one FFMA, P rounded to bf16 each tile before P.V with fp32 accumulation,
one divide by the sum, one bf16 rounding. ``tiled_qk8``
repeats that arithmetic (it lives here, not in the package: the package's
twin is plain softmax attention over the dequantized scores).

Bounds, each with its reason: with P kept in fp32 the tile order is held
to 2e-5 against ``flash_attention_qk_int8_plain`` and JAX's int8-score
Pallas kernel in interpret mode (the integer scores are exact on every
side; only the softmax's summation order differs), as
``test_torch_qk8.py`` holds the twin; with P rounded to bf16, to K1's
bounds (``K1_OUT_STEPS`` bf16 steps of max|ref|, at most
``K1_OUT_MAX_TOL``), which ``chip_smoke.py`` applies to the kernel.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chronoedit_tpu.ops import flash_attention as fa_j
from chronoedit_tpu_torch.ops import flash_attention as fa_t
from chronoedit_tpu_torch.tools import K1_OUT_MAX_TOL, K1_OUT_STEPS, ULP_BF16
from test_torch_qk8 import _jax_prologue

torch.set_num_threads(2)

B, H, D = 2, 2, 128
SCALE = D ** -0.5
TILE = 128  # KV rows a ring stage of the card's kernel
LOG2E = 1.4426950408889634
KS_LD = TILE // 4 + 4  # floats a row of a stage's permuted k scales (one row per t4)
REL = 2e-5
CASES = [(130, 200), (129, 257), (64, 129)]


def tiled_qk8(q8, k8, v, qs, ks, scale: float, p_bf16: bool = True, extra_tiles: int = 0):
    """K9's arithmetic on q8 (B, Sq, H, D) int8, k8 (B, Skv, H, D) int8, v
    (B, Skv, H, D) fp32, qs (B, Sq, H), ks (B, Skv, H) fp32: returns O in
    fp32 (holding bf16 values when ``p_bf16``). ``extra_tiles`` appends
    tiles that lie wholly past Skv (all masked)."""
    skv = k8.shape[1]
    qh = q8.permute(0, 2, 1, 3).double()                      # (B, H, Sq, D)
    kh, vh = k8.permute(0, 2, 1, 3).double(), v.permute(0, 2, 1, 3).float()
    row_mult = (qs * np.float32(scale)).transpose(1, 2)[..., None]  # (B, H, Sq, 1) fp32
    ksh = ks.transpose(1, 2)                                   # (B, H, Skv)
    log2e = torch.tensor(LOG2E, dtype=torch.float32)
    n_tiles = -(-skv // TILE) + extra_tiles
    pad = n_tiles * TILE - skv  # rows TMA fills with zeros; ks staged as 0
    kh = torch.nn.functional.pad(kh, (0, 0, 0, pad))
    vh = torch.nn.functional.pad(vh, (0, 0, 0, pad))
    ksh = torch.nn.functional.pad(ksh, (0, pad))
    m = torch.full(qh.shape[:-1], -math.inf)
    l = torch.zeros(qh.shape[:-1])
    acc = torch.zeros(qh.shape[:-1] + (D,))
    for t in range(n_tiles):
        cols = slice(t * TILE, (t + 1) * TILE)
        s32 = (qh @ kh[:, :, cols].transpose(-1, -2)).to(torch.int32)  # exact: < 2^21
        y = s32.float() * row_mult * ksh[:, :, None, cols]  # JAX's order, fp32
        y[..., torch.arange(t * TILE, (t + 1) * TILE) >= skv] = -math.inf
        m_new = torch.maximum(m, y.amax(-1) * log2e)
        base = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)
        alpha = torch.exp2(m - base)
        m = m_new
        # y log2 e - base in one FFMA: the product is exact in fp64, one rounding
        p = torch.exp2((y.double() * float(log2e) - base.double()[..., None]).float())
        l = l * alpha + p.sum(-1)
        pv = p.bfloat16().float() if p_bf16 else p
        acc = acc * alpha[..., None] + pv @ vh[:, :, cols]
    out = acc * (1.0 / l)[..., None]
    if p_bf16:
        out = out.bfloat16().float()
    return out.permute(0, 2, 1, 3)


def _case(seed: int, sq: int, skv: int, monkeypatch):
    """fp32 q, k (offset mean), bf16-valued v from numpy; JAX's int8-score
    output (interpret mode, ``_RESIDENT_KV_BYTES`` patched to 1 as its own
    tests run it) and the int8 inputs of JAX's own prologue, as torch
    tensors: the scores are then the same integers on every side."""
    monkeypatch.setattr(fa_j, "_RESIDENT_KV_BYTES", 1)
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, sq, H, D)).astype(np.float32)
    k = (rng.standard_normal((B, skv, H, D)) + 0.7).astype(np.float32)
    v = torch.from_numpy(rng.standard_normal((B, skv, H, D)).astype(np.float32)).bfloat16().float()
    want = np.asarray(fa_j.flash_attention_qk_int8(jnp.asarray(q), jnp.asarray(k),
                                                   jnp.asarray(v.numpy()), SCALE))
    q8, qs, k8, ks = (torch.from_numpy(np.array(a))
                      for a in _jax_prologue(jnp.asarray(q), jnp.asarray(k)))
    return [q8, k8, v, qs, ks], torch.from_numpy(np.array(want))


def _within_k1_bounds(got, want):
    ref_max = float(want.abs().max())
    tol = min(K1_OUT_MAX_TOL, K1_OUT_STEPS * ULP_BF16 * ref_max)
    err = float((got - want).abs().max())
    assert bool(torch.isfinite(got).all())
    assert err <= tol, f"off by {err:.3e} (bound {tol:.3e}, max|ref| {ref_max:.3f})"


def test_permuted_k_scales_reach_their_columns():
    """The producer lane's store of column i (``((i >> 1) & 3) * KS_LD + 2 *
    (i >> 3) + (i & 1)``) and the consumer's reads (row t4, float k of the
    16-byte load j2) meet: thread t4 gets column 8 j + 2 t4 + e of its
    fragment, j = 2 j2 + (k >> 1), e = k & 1; no two columns share a slot,
    and the four rows start 16-byte aligned in distinct bank groups."""
    stage = torch.full((4 * KS_LD,), -1)
    for i in range(TILE):
        pos = ((i >> 1) & 3) * KS_LD + 2 * (i >> 3) + (i & 1)
        assert stage[pos] == -1
        stage[pos] = i
    for t4 in range(4):
        for j2 in range(TILE // 16):
            for k in range(4):
                j, e = 2 * j2 + (k >> 1), k & 1
                assert stage[t4 * KS_LD + 4 * j2 + k] == 8 * j + 2 * t4 + e
    assert KS_LD % 4 == 0 and len({(t4 * KS_LD // 4) % 8 for t4 in range(4)}) == 4


@pytest.mark.parametrize("sq,skv", CASES)
def test_tiled_fp32_matches_twin_and_jax(sq, skv, monkeypatch):
    """P in fp32: the 128-column tile order against the twin and JAX's
    int8-score Pallas kernel on the same int8 inputs, within 2e-5; ragged
    q and KV lengths leave partial tiles on both sides."""
    ins, want = _case(sq * 1000 + skv, sq, skv, monkeypatch)
    got = tiled_qk8(*ins, SCALE, p_bf16=False)
    twin = fa_t.flash_attention_qk_int8_plain(*ins, SCALE)
    assert got.shape == twin.shape == want.shape == (B, sq, H, D)
    torch.testing.assert_close(got, twin, atol=REL, rtol=0)
    torch.testing.assert_close(got, want, atol=REL, rtol=0)


@pytest.mark.parametrize("sq,skv", CASES)
def test_tiled_bf16_p_within_k1_bounds(sq, skv, monkeypatch):
    """P rounded to bf16 and O to bf16, as on the card: within K1's bounds
    of the twin and of JAX."""
    ins, want = _case(sq * 1000 + skv + 1, sq, skv, monkeypatch)
    got = tiled_qk8(*ins, SCALE)
    _within_k1_bounds(got, fa_t.flash_attention_qk_int8_plain(*ins, SCALE))
    _within_k1_bounds(got, want)


def test_all_masked_tail_tile_stays_finite(monkeypatch):
    """Skv = 129 leaves one live column in the second tile; a third tile
    wholly past Skv (zero k8 rows, ks = 0, every score -inf) changes
    nothing: the result is finite, bitwise the two-tile result, and within
    K1's bounds of the twin."""
    ins, _ = _case(7, 129, 129, monkeypatch)
    out = tiled_qk8(*ins, SCALE)
    out_x = tiled_qk8(*ins, SCALE, extra_tiles=1)
    assert torch.equal(out, out_x)
    _within_k1_bounds(out_x, fa_t.flash_attention_qk_int8_plain(*ins, SCALE))
