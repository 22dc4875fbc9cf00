"""K4's and K2's arithmetic and row schedule on the card (``csrc/rms_norm.cu``,
``csrc/ln_modulate.cu``, their shell ``csrc/row_ring.cuh``) in plain torch,
against the port's twins and the JAX package, on CPU.

The kernels split the rows into G contiguous ranges: block b of G takes
[rows * b / G, rows * (b + 1) / G), G = min(rows, SMs). In a block, one
producer thread fills a ring of S row stages with bulk copies; local row j
goes to consumer warp j % W (W = min(8, S), S cut to a multiple of W) and
to stage j % S, so warp j % W always reads the same stages and never waits
on a stage two phases ahead. Lane l of the warp
reads the row's 16-byte vectors v = l, l + 32, ... (8 elements each) and
keeps one fp32 partial, in that order (K4: ``fmaf(x, x, sq)``; K2: the sum,
then ``fmaf(c, c, sq)`` of the centred values); a butterfly (xor 16, 8, 4,
2, 1) adds the 32 partials. K4 then rounds x * rsqrt(sq / D + eps) to bf16
and multiplies by the bf16 weight; K2 computes ``fmaf((x - mean) * rstd,
1 + scale, shift)`` 4 columns a lane and rounds once. K2 stages frame k of
its range's scale and shift in slot k % 2, reloading a slot once every
row of frame k - 2 has been read.

``row_schedule`` replays that protocol (the full/empty barriers of the
ring, the modulation slots' barriers with their counted arrivals, the bulk
copies landing late) with the kernel's index arithmetic, in a random order
of the producer, the copies and the consumer warps, and records what each
row read; ``rms_rows`` and ``lnmod_rows`` repeat the arithmetic (``fmaf``
as a float64 product and sum rounded to fp32, which can differ from it in
the last bit only at a double-rounding tie; ``rsqrtf`` as ``torch.rsqrt``).
The results are held against ``rms_norm_plain`` / ``ln_modulate_plain``
and JAX ``rms_norm_fused`` / ``layer_norm_modulate`` (their jnp
formulations, ``L.rms_norm`` and ``_lnmod_jnp``, on the CPU) in fp32,
within the bound ``chip_smoke.py`` applies to K2 and K4: one bf16 step
(``ULP_BF16``) of max|ref|.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chronoedit_tpu.ops import fused_norms as fn_j
from chronoedit_tpu_torch.ops import fused_norms as fn_t
from chronoedit_tpu_torch.tools import ULP_BF16

torch.set_num_threads(2)

SMS = 132  # the H100's SMs: G = min(rows, SMS)
WARPS = 8  # consumer warps a block (row_ring.cuh kConsumerWarps)
MAX_STAGES = 16  # row_ring.cuh kMaxStages
SMEM_BYTES = 200 * 1024  # row_ring.cuh kSmemBytes
MOD_ARRIVALS = 2 ** 20 - 1  # ln_modulate.cu kModArrivals
EPS = 1e-6


def block_ranges(rows: int, g: int) -> list[tuple[int, int]]:
    """row_ring.cuh ``block_rows``: block b's [begin, end) of G blocks."""
    return [(rows * b // g, rows * (b + 1) // g) for b in range(g)]


def ring_shape(d: int, mod: bool) -> tuple[int, int]:
    """row_ring.cuh ``ring_shape`` at width d: (consumer warps W, stages S).
    K4 holds its weight row beside the ring, K2 two slots of fp32 scale and
    shift."""
    fixed = 4 * d * 4 if mod else d * 2
    s = min(MAX_STAGES, (SMEM_BYTES - fixed) // (d * 2))
    w = min(WARPS, s)
    return w, s // w * w


def stage_index(j: int, stages: int) -> int:
    """``Ring::stage``: row j's stage."""
    return j % stages


# ----------------------------------------------------------- the schedule

class Barrier:
    """An mbarrier: a phase completes when its expected arrivals have all
    arrived and the bytes it was told to expect have landed."""

    def __init__(self, count: int):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def arrive(self, n: int = 1) -> None:
        assert 1 <= n <= self.pending, "more arrivals than the phase expects"
        self.pending -= n
        self._complete()

    def arrive_expect_tx(self, nbytes: int) -> None:
        self.tx += nbytes
        self.arrive()

    def complete_tx(self, nbytes: int) -> None:
        self.tx -= nbytes
        assert self.tx >= 0, "bytes landed that no phase expected"
        self._complete()

    def _complete(self) -> None:
        if self.pending == 0 and self.tx == 0:
            self.phase += 1
            self.pending = self.count

    def passed(self, parity: int) -> bool:
        """``mbarrier.try_wait.parity``: the phase of that parity is over."""
        return (self.phase & 1) != parity


def row_schedule(rows: int, hw: int | None, d: int, g: int, warps: int, stages: int,
                 seed: int = 0) -> dict[int, int | None]:
    """Replays every block's producer, bulk copies and consumer warps in a
    random order that respects the barriers, as K2 (``hw`` given) or K4
    (``hw`` None) schedules them, and checks that each row's stage holds
    that row, and K2's slot that row's frame, for as long as the warp reads
    them. Returns {row: the frame whose scale and shift it read} (None for
    K4). A schedule that stops short of its rows is a deadlock."""
    rng = random.Random(seed)
    read: dict[int, int | None] = {}
    for begin, end in block_ranges(rows, g):
        n = end - begin
        full = [Barrier(1) for _ in range(stages)]
        empty = [Barrier(1) for _ in range(stages)]
        mod_full = [Barrier(1) for _ in range(2)]
        mod_empty = [Barrier(MOD_ARRIVALS) for _ in range(2)]
        ring = [None] * stages
        slots = [[None, None] for _ in range(2)]  # [scale frame, shift frame]
        f0 = begin // hw if hw else 0
        actors = []

        def copy(store, index, value, bar, nbytes):
            yield None  # lands at some later point
            store[index] = value
            bar.complete_tx(nbytes)

        def copy_into(slot, half, frame, bar, nbytes):
            yield None
            slots[slot][half] = frame
            bar.complete_tx(nbytes)

        def producer():
            k = -1
            for j in range(n):
                row = begin + j
                if hw and row // hw != f0 + k:  # the range's next frame
                    k += 1
                    f, slot = f0 + k, k & 1
                    if k >= 2:
                        yield mod_empty[slot], ((k >> 1) - 1) & 1
                    lo, hi = f * hw, f * hw + hw
                    n_k = min(hi, end) - max(lo, begin)
                    mod_empty[slot].arrive(MOD_ARRIVALS - n_k)
                    mod_full[slot].arrive_expect_tx(2 * d * 4)
                    actors.append([copy_into(slot, 0, f, mod_full[slot], d * 4), None])
                    actors.append([copy_into(slot, 1, f, mod_full[slot], d * 4), None])
                s = stage_index(j, stages)
                if j >= stages:
                    yield empty[s], ((j // stages) - 1) & 1
                full[s].arrive_expect_tx(d * 2)
                actors.append([copy(ring, s, row, full[s], d * 2), None])

        def consumer(w):
            for j in range(w, n, warps):
                row, s = begin + j, stage_index(j, stages)
                yield full[s], (j // stages) & 1
                assert ring[s] == row, f"row {row} read stage {s} holding {ring[s]}"
                yield None  # the statistics passes
                frame = None
                if hw:
                    k = row // hw - f0
                    slot = k & 1
                    yield mod_full[slot], (k >> 1) & 1
                    frame = slots[slot][0]
                    assert slots[slot] == [frame, frame], "scale and shift of two frames"
                    yield None  # the output pass
                    assert slots[slot] == [frame, frame], "a slot reloaded while read"
                assert ring[s] == row, f"stage {s} reloaded while row {row} was read"
                read[row] = frame
                empty[s].arrive()
                if hw:
                    mod_empty[slot].arrive()

        actors += [[producer(), None]] + [[consumer(w), None] for w in range(warps)]
        while actors:
            ready = [a for a in actors if a[1] is None or a[1][0].passed(a[1][1])]
            assert ready, f"deadlock in block [{begin}, {end})"
            actor = rng.choice(ready)
            try:
                actor[1] = next(actor[0])
            except StopIteration:
                actors.remove(actor)
    return read


# ----------------------------------------------------------- the arithmetic

def fmaf(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return (a.double() * b.double() + c.double()).float()


def lane_partials(x: torch.Tensor, step) -> torch.Tensor:
    """(R, D) fp32 -> (R, 32): lane l's partial over the vectors l, l + 32,
    ... of each row, element by element, ``acc = step(value, acc)``. The
    padding past the row's last vector is 0, which neither step changes."""
    r, d = x.shape
    nvec = d // 8
    n_i = -(-nvec // 32)
    v = torch.zeros(r, n_i * 32, 8)
    v[:, :nvec] = x.reshape(r, nvec, 8)
    v = v.reshape(r, n_i, 32, 8)
    acc = torch.zeros(r, 32)
    for i in range(n_i):
        for e in range(8):
            acc = step(v[:, i, :, e], acc)
    return acc


def butterfly(partials: torch.Tensor) -> torch.Tensor:
    """``ce::warp_sum`` over (R, 32) lane partials: every lane's result."""
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        partials = partials + partials[:, idx ^ o]
    return partials


def rms_rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K4 on (R, D) bf16 rows and a (D,) bf16 weight."""
    xf = x.float()
    sums = butterfly(lane_partials(xf, lambda v, acc: fmaf(v, v, acc)))
    assert bool((sums == sums[:, :1]).all()), "lanes disagree after the butterfly"
    r = torch.rsqrt(sums[:, :1] / x.shape[1] + EPS)
    return ((xf * r).bfloat16().float() * w.float()).bfloat16()


def lnmod_rows(x: torch.Tensor, sc: torch.Tensor, sh: torch.Tensor) -> torch.Tensor:
    """K2 on (R, D) bf16 rows with each row's (R, D) fp32 scale and shift."""
    xf, d = x.float(), x.shape[1]
    mean = butterfly(lane_partials(xf, lambda v, acc: acc + v))[:, :1] / d
    cen = xf - mean
    sq = butterfly(lane_partials(cen, lambda v, acc: fmaf(v, v, acc)))[:, :1]
    rstd = torch.rsqrt(sq / d + EPS)
    return fmaf(cen * rstd, 1.0 + sc, sh).bfloat16()


def _bf16(rng, shape, mean=0.0, std=1.0) -> torch.Tensor:
    return torch.from_numpy((rng.standard_normal(shape) * std + mean)
                            .astype(np.float32)).bfloat16()


def _within_one_step(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    ref_max = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= ULP_BF16 * ref_max, f"{what}: off by {err:.3e} (max|ref| {ref_max:.3f})"


# ----------------------------------------------------------- tests

@pytest.mark.parametrize("rows", [1, 257, 512, 7200, 28800])
@pytest.mark.parametrize("g", [None, 3])
def test_block_ranges_are_contiguous_and_balanced(rows, g):
    """G = min(rows, SMs) (or a forced small G): the ranges tile the rows in
    order, none is empty, and their sizes differ by at most one row."""
    g = min(rows, SMS) if g is None else min(rows, g)
    ranges = block_ranges(rows, g)
    assert ranges[0][0] == 0 and ranges[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [e - b for b, e in ranges]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("d", [5120, 256, 8192])
def test_ring_fits_shared_memory(d):
    """Both kernels get at least one warp and one stage a warp at every
    width the wrappers take (D <= 8192), within the block's shared memory;
    each stage is read by one warp only."""
    for mod in (False, True):
        w, s = ring_shape(d, mod)
        assert 1 <= w <= WARPS and s % w == 0 and 1 <= s <= MAX_STAGES
        assert (4 * d * 4 if mod else d * 2) + s * d * 2 <= SMEM_BYTES
        owners = {}
        for j in range(4 * s):
            owners.setdefault(stage_index(j, s), set()).add(j % w)
        assert sorted(owners) == list(range(s)) and all(len(o) == 1 for o in owners.values())


@pytest.mark.parametrize("b,t,hw,g,warps,stages", [
    (2, 3, 5, 2, 3, 3),        # one range over four frames and the batch boundary
    (2, 3, 5, 3, 2, 2),        # a short ring: more rows a frame than warps
    (2, 3, 37, SMS, 8, 16),    # the ragged case of chip_smoke.py, K4's ring
    (2, 20, 1, 4, 4, 8),       # a frame a row: a slot reloaded every other row
    (1, 2, 3600, SMS, 8, 8),   # the edit's stream, K2's ring at D = 5120
])
@pytest.mark.parametrize("seed", [0, 1])
def test_schedule_reads_each_rows_own_stage_and_frame(b, t, hw, g, warps, stages, seed):
    """Every row is read exactly once, from a stage holding it, and (K2)
    with its own frame's scale and shift, however the producer, the copies
    and the warps interleave; no block deadlocks (K4's schedule too)."""
    rows = b * t * hw
    g = min(rows, g)
    read = row_schedule(rows, hw, 8, g, warps, stages, seed)
    assert read == {row: row // hw for row in range(rows)}
    assert set(row_schedule(rows, None, 8, g, warps, stages, seed)) == set(range(rows))


def test_stages_shared_by_warps_break_the_parity_wait():
    """Why the stages are a multiple of the warps: with more warps than
    stages (W = 8, S = 3), warp j % W does not always read the same stages,
    so it waits on a stage whose previous row has not landed, and the
    parity wait, which cannot tell the phase it wants from the one before
    the current, lets it read the stage too early."""
    with pytest.raises(AssertionError, match="read stage"):
        for seed in range(20):
            row_schedule(30, None, 8, 1, 8, 3, seed)


@pytest.mark.parametrize("d", [5120, 256])
@pytest.mark.parametrize("rows", [1, 257, 512, 7200])
def test_rms_rows_within_one_step(d, rows):
    """K4's lane partials and butterfly against the twin (bf16, the same
    roundings) and JAX's fp32 ``rms_norm_fused`` on the same values."""
    rng = np.random.default_rng(rows + d)
    x = _bf16(rng, (1, rows, d), mean=0.5, std=2.0)
    w = _bf16(rng, (d,), mean=1.0, std=0.1)
    got = rms_rows(x[0], w)[None]
    _within_one_step(got, fn_t.rms_norm_plain(w, x, EPS), "against the twin")
    want = fn_j.rms_norm_fused({"scale": jnp.asarray(w.float().numpy())},
                               jnp.asarray(x.float().numpy()), EPS)
    _within_one_step(got, torch.from_numpy(np.array(want)), "against JAX")


@pytest.mark.parametrize("d", [5120, 256])
@pytest.mark.parametrize("b,t,hw,g", [
    (1, 1, 1, None), (1, 1, 257, None), (1, 2, 256, None), (1, 2, 3600, None),
    (2, 3, 5, 2), (2, 3, 37, None)])
def test_lnmod_rows_within_one_step(d, b, t, hw, g):
    """K2 with each row's scale and shift taken from the slot the schedule
    gave it, against the twin and JAX's fp32 ``layer_norm_modulate``."""
    rng = np.random.default_rng(b * t * hw + d)
    rows = b * t * hw
    x = _bf16(rng, (b, t * hw, d), mean=0.5, std=2.0)
    scale = torch.from_numpy((0.1 * rng.standard_normal((b, t, d))).astype(np.float32))
    shift = torch.from_numpy((0.1 * rng.standard_normal((b, t, d))).astype(np.float32))
    g = min(rows, SMS) if g is None else g
    frames = row_schedule(rows, hw, d, g, *ring_shape(d, True))
    f = torch.tensor([frames[r] for r in range(rows)])
    assert bool((f == torch.arange(rows) // hw).all())
    got = lnmod_rows(x.reshape(rows, d), scale.reshape(b * t, d)[f],
                     shift.reshape(b * t, d)[f]).reshape(b, t * hw, d)
    _within_one_step(got, fn_t.ln_modulate_plain(x, scale, shift, hw, EPS), "against the twin")
    want = fn_j.layer_norm_modulate(jnp.asarray(x.float().numpy()), jnp.asarray(scale.numpy()),
                                    jnp.asarray(shift.numpy()), hw, EPS)
    _within_one_step(got, torch.from_numpy(np.array(want)), "against JAX")
