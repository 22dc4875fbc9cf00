"""K8's arithmetic (``csrc/int4_matmul.cu``) in plain torch, against the
port's twin and the JAX package, on CPU.

The card's kernel swaps the operands: a block computes a 128 x 256 tile of
y^T = dequant(W)^T x^T, 128 output columns n against 256 rows m of x. A
stage holds 64 packed bytes of K/2 (64 K values of each half), and each
16-wide k-step adds the lo-half product, then the hi-half one, in fp32.
Each consumer thread reads its A fragment's bytes from the packed tile as
TMA leaves it (64-byte swizzle), picks them out with a byte permute and
decodes every nibble as ``lut[nibble ^ 8] * scale`` in fp32, rounded once
to bf16 (``lut[0] = 0``, ``lut[i] = table[i - 1]``). Rows past M and N
are zero-filled and never stored.

``thread_fragments`` repeats one k-step's per-thread reads and decode, and
``tiled_int4_matmul`` the tile, stage and sum order; both live here, not
in the package (the package's twin is the plain dequantize-and-multiply).
Bounds, each with its reason:
- the decoded weight: bitwise ``dequantize(...).to(bf16)`` on both grids
  (the same fp32 product, one rounding);
- the fp32 product: 2e-5 of max|y| against the twin, JAX's Pallas kernel
  in interpret mode (uniform grid; it takes N a multiple of 128) and JAX's
  XLA path (both grids), as ``test_torch_quant.py`` holds the twin: only
  the fp32 summation order differs;
- the bf16 product: ``chip_smoke.K8_OUT_STEPS`` bf16 steps of max|ref|
  against the bf16 twin, the bound the card's kernel is held to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chronoedit_tpu.ops import quant as quant_j
from chronoedit_tpu.ops.int4_matmul import int4_matmul as int4_matmul_j
from chronoedit_tpu_torch.ops import int4_matmul as i4_t
from chronoedit_tpu_torch.ops import layers as L
from chronoedit_tpu_torch.ops import quant as quant_t
from chronoedit_tpu_torch.tools import ULP_BF16

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

TILE_N, TILE_M = 128, 256  # output columns n and rows m of x a block
STAGE = 64                 # packed bytes of K/2 a ring stage
K_STEP = 16                # K values a wgmma k-step
GROUP = 128
K8_OUT_STEPS = 1.0         # chip_smoke.K8_OUT_STEPS
REL = 2e-5


def _leaf(seed: int, din: int, dout: int, grid: str):
    """A random (din, dout) linear quantized w4a16 on ``grid``."""
    rng = np.random.default_rng(seed)
    lin = L.Linear(din, dout)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(rng.standard_normal((dout, din)).astype(np.float32)))
    return quant_t.quantize_linear_params_int4(lin, grid=grid), rng


def _lut(table: torch.Tensor) -> torch.Tensor:
    """The kernel's shared-memory table: lut[q + 8] = table[q + 7], lut[0] = 0."""
    return torch.cat([torch.zeros(1), table.float()])


def _padded(leaf, n0: int):
    """The block's packed rows (TILE_N, K/2) uint8 and scale columns (g,
    TILE_N) from column n0, zero past N: what TMA lands."""
    n, half = leaf.packed.shape
    rows = min(TILE_N, n - n0)
    pk = torch.zeros(TILE_N, half, dtype=torch.uint8)
    pk[:rows] = leaf.packed[n0:n0 + rows].view(torch.uint8)
    sc = torch.zeros(leaf.scales.shape[0], TILE_N)
    sc[:, :rows] = leaf.scales[:, n0:n0 + rows]
    return pk, sc


def swizzle64(tile: torch.Tensor) -> torch.Tensor:
    """A (rows, 64) byte tile as TMA writes it with the 64-byte swizzle:
    16-byte chunk c of row r lands at chunk c ^ ((r >> 1) & 3)."""
    r = torch.arange(tile.shape[0])[:, None]
    p = torch.arange(STAGE)[None, :]
    src = 16 * ((p // 16) ^ ((r >> 1) & 3)) + p % 16
    return torch.gather(tile, 1, src)


def _byte_perm(a: torch.Tensor, b: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """CUDA's __byte_perm on int64 tensors holding u32 values: byte i of the
    result is byte (sel >> 4 i) & 7 of the pair (a, b)."""
    pair = a | (b << 32)
    out = torch.zeros_like(a)
    for i in range(4):
        idx = (sel >> (4 * i)) & 7
        out |= ((pair >> (8 * idx)) & 0xFF) << (8 * i)
    return out


def thread_fragments(stage_tile: torch.Tensor, s_lo: torch.Tensor, s_hi: torch.Tensor,
                     lut: torch.Tensor, kk: int):
    """k-step kk of one stage as the 256 consumer threads decode it: each
    reads two 32-bit words of its rows r0 and r0 + 8 from the swizzled
    packed tile, permutes out the bytes at K offsets 2 t4, 2 t4 + 1, 8 + 2
    t4, 9 + 2 t4 and decodes their low (lo half) and high (hi half)
    nibbles. Returns the (TILE_N, 16) lo and hi weight tiles, as bf16, that
    the m16n8k16 A fragments stand for."""
    phys = swizzle64(stage_tile).long()
    tid = torch.arange(256)
    c, warp, lane = tid // 128, (tid // 32) % 4, tid % 32
    g, t4 = lane >> 2, lane & 3
    r0 = c * 64 + warp * 16 + g
    swz = (r0 >> 1) & 3
    sel = torch.where((t4 & 1) == 1, 0x7632, 0x5410)
    word = 4 * (t4 >> 1)
    tiles = [torch.full((TILE_N, K_STEP), float("nan")) for _ in range(2)]
    for r in range(2):
        row = r0 + 8 * r
        off = 16 * (kk ^ swz) + word

        def u32(o):
            return sum(phys[row, o + i] << (8 * i) for i in range(4))

        v = _byte_perm(u32(off), u32(off + 8), sel) ^ 0x88888888
        for tile, shift, s in zip(tiles, (0, 4), (s_lo, s_hi)):
            w = [(lut[(v >> (shift + 8 * i)) & 15] * s[row]).bfloat16().float()
                 for i in range(4)]
            # fragment register r: K 2 t4, 2 t4 + 1; register 2 + r: K 8 + 2 t4, +1
            for i, k in enumerate((2 * t4, 2 * t4 + 1, 8 + 2 * t4, 9 + 2 * t4)):
                tile[row, k] = w[i]
    return tiles


def decode_stage(pk: torch.Tensor, s_lo: torch.Tensor, s_hi: torch.Tensor,
                 lut: torch.Tensor, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The same decode for a whole (rows, bytes) stage at once: (lo, hi)
    weights in fp32 holding ``dtype`` values."""
    p = pk.long()
    lo = lut[(p & 15) ^ 8] * s_lo[:, None]
    hi = lut[((p >> 4) & 15) ^ 8] * s_hi[:, None]
    return lo.to(dtype).float(), hi.to(dtype).float()


def tiled_int4_matmul(x: torch.Tensor, leaf, dtype=torch.bfloat16) -> torch.Tensor:
    """K8's arithmetic on x (M, K): per block a (TILE_N, TILE_M) fp32 y^T
    tile over zero-filled edges; per stage the decode, per k-step the lo
    then the hi product; y in ``dtype``."""
    m, k = x.shape
    n, half = leaf.packed.shape
    g = leaf.scales.shape[0]
    lut = _lut(leaf.table)
    y = torch.empty(m, n)
    for n0 in range(0, n, TILE_N):
        pk, sc = _padded(leaf, n0)
        for m0 in range(0, m, TILE_M):
            xt = torch.zeros(TILE_M, k)
            xt[:min(TILE_M, m - m0)] = x[m0:m0 + TILE_M].to(dtype).float()
            acc = torch.zeros(TILE_N, TILE_M)
            for j0 in range(0, half, STAGE):
                grp = j0 // GROUP
                w_lo, w_hi = decode_stage(pk[:, j0:j0 + STAGE], sc[grp], sc[g // 2 + grp],
                                          lut, dtype)
                for kk in range(0, STAGE, K_STEP):
                    cols = slice(j0 + kk, j0 + kk + K_STEP)
                    acc += w_lo[:, kk:kk + K_STEP] @ xt[:, cols].T
                    acc += w_hi[:, kk:kk + K_STEP] @ xt[:, half:][:, cols].T
            y[m0:m0 + TILE_M, n0:n0 + TILE_N] = acc.T[:min(TILE_M, m - m0), :min(TILE_N, n - n0)]
    return y.to(dtype)


@pytest.mark.parametrize("din", [256, 512])
@pytest.mark.parametrize("grid", ["uniform", "lloyd"])
def test_thread_fragments_are_the_twins_weight(grid, din):
    """Every k-step of every stage and block, as the threads decode it from
    the swizzled tile, is bitwise the twin's weight rounded to bf16 (zero
    on the rows past N = 136); the whole-stage decode is too."""
    leaf, _ = _leaf(din, din, 136, grid)
    n, half = leaf.packed.shape
    g = leaf.scales.shape[0]
    want = i4_t.dequantize(leaf.packed, leaf.scales, leaf.table).bfloat16().float()
    want = torch.cat([want, torch.zeros(2 * TILE_N - n, 2 * half)])  # rows past N
    lut = _lut(leaf.table)
    for n0 in range(0, n, TILE_N):
        pk, sc = _padded(leaf, n0)
        for j0 in range(0, half, STAGE):
            grp = j0 // GROUP
            s_lo, s_hi = sc[grp], sc[g // 2 + grp]
            rows = want[n0:n0 + TILE_N]
            stage_lo, stage_hi = decode_stage(pk[:, j0:j0 + STAGE], s_lo, s_hi, lut,
                                              torch.bfloat16)
            assert torch.equal(stage_lo, rows[:, j0:j0 + STAGE])
            assert torch.equal(stage_hi, rows[:, half + j0:half + j0 + STAGE])
            for kk in range(STAGE // K_STEP):
                lo, hi = thread_fragments(pk[:, j0:j0 + STAGE], s_lo, s_hi, lut, kk)
                cols = slice(j0 + K_STEP * kk, j0 + K_STEP * (kk + 1))
                assert torch.equal(lo, rows[:, cols])
                assert torch.equal(hi, rows[:, half:][:, cols])


def _jax_params(leaf) -> dict:
    """The port's leaf as JAX's int4 params (bitwise JAX's own quantizer's,
    ``test_torch_quant.test_quantizer_bits_match_jax``)."""
    p = {"kernel_q4": jnp.asarray(leaf.packed.numpy().T),
         "kernel_scale4": jnp.asarray(leaf.scales.numpy())}
    if not torch.equal(leaf.table, torch.arange(-7., 8.)):
        p["kernel_lut4"] = jnp.asarray(leaf.table.numpy())
    return p


@pytest.mark.parametrize("m", [1, 130, 257])
@pytest.mark.parametrize("grid", ["uniform", "lloyd"])
def test_tiled_product_matches_twin_and_jax_xla(grid, m):
    """fp32: ragged M (one row, a partial tile, one row past a tile), N =
    136 (a partial 128-column tile), K = 256 (one group a half, two stages
    a group) against the twin and JAX's XLA int4 apply, 2e-5 of max|y|."""
    leaf, rng = _leaf(1000 + m, 256, 136, grid)
    x = torch.from_numpy(rng.standard_normal((m, 256)).astype(np.float32))
    got = tiled_int4_matmul(x, leaf, torch.float32)
    twin = i4_t.int4_matmul_plain(x, leaf.packed, leaf.scales, leaf.table)
    want = np.asarray(quant_j.quantized_linear_int4(_jax_params(leaf), jnp.asarray(x.numpy())))
    assert got.shape == twin.shape == want.shape == (m, 136)
    np.testing.assert_allclose(got.numpy(), twin.numpy(), atol=REL * float(twin.abs().max()),
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=REL * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("m", [1, 130, 257])
def test_tiled_product_matches_pallas_interpret(m):
    """fp32, uniform grid: against JAX's Pallas kernel in interpret mode (N
    = 256: two column tiles; K/2 = 128, its one k tile), 2e-5 of max|y|."""
    leaf, rng = _leaf(2000 + m, 256, 256, "uniform")
    x = rng.standard_normal((m, 256)).astype(np.float32)
    p = _jax_params(leaf)
    want = np.asarray(int4_matmul_j(jnp.asarray(x), p["kernel_q4"], p["kernel_scale4"],
                                    interpret=True))
    got = tiled_int4_matmul(torch.from_numpy(x), leaf, torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=REL * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("grid", ["uniform", "lloyd"])
def test_bf16_tiles_within_k8_bound(grid):
    """bf16, as on the card: the tiled product (bf16 x and weights, fp32
    sums, one rounding) against the bf16 twin at M = 257, N = 136, K = 512
    (two groups a half), within K8_OUT_STEPS bf16 steps of max|ref|."""
    leaf, rng = _leaf(3000, 512, 136, grid)
    x = torch.from_numpy(rng.standard_normal((257, 512)).astype(np.float32)).bfloat16()
    got = tiled_int4_matmul(x, leaf)
    ref = i4_t.int4_matmul_plain(x, leaf.packed, leaf.scales, leaf.table)
    assert got.dtype == ref.dtype == torch.bfloat16
    tol = K8_OUT_STEPS * ULP_BF16 * float(ref.float().abs().max())
    assert float((got.float() - ref.float()).abs().max()) <= tol
