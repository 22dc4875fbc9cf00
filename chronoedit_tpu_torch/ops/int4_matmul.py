"""K8: ``y = x @ dequant(W)`` for the w4a16 linear, a hand-written Hopper
kernel and its plain twin.

The weight is the split-half packed int4 of ``ops/quant.py``: ``packed``
(N, K/2) int8, whose byte (n, j) holds row j of the (K, N) weight in its
low nibble and row j + K/2 in its high nibble (JAX's ``kernel_q4``
transposed); ``scales`` (K/128, N) fp32, one per 128-row group and output
column, the first half's groups first; ``table`` (15,) fp32, indexed by
the nibble + 7. The dequantized weight is ``table[q + 7] * scale`` in
fp32, cast to x's dtype, and the product sums in fp32: the function JAX's
int4 apply computes on both of its grids (the uniform grid's table holds
the integers -7..7).

The CUDA kernel (``csrc/int4_matmul.cu``, ``int4_matmul_wgmma_kernel``)
takes bf16 x; for CUDA tensors the wrapper launches it or raises. It swaps
the operands (y^T = W^T x^T): a TMA ring feeds x tiles and the packed
bytes, and each consumer thread decodes its weight bytes straight into the
register-A fragments of a bf16 ``wgmma`` with the twin's dequantization, bit
for bit. JAX launches its Pallas kernel only on one TPU, for the uniform
grid and behind an environment switch; the port launches K8 for both
grids, for every int4 linear on the card.
"""

from __future__ import annotations

import torch

GROUP = 128  # rows of the (K, N) weight per scale


def unpack_int4(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, K/2) packed int8 -> (lo, hi), each (N, K/2) int8 in [-8, 7]:
    lo holds rows [0, K/2) of the weight, hi the rest. The low nibble
    sign-extends as ``((p & 15) ^ 8) - 8``, the high one by the arithmetic
    shift."""
    return ((packed & 15) ^ 8) - 8, packed >> 4


def dequantize(packed: torch.Tensor, scales: torch.Tensor,
               table: torch.Tensor) -> torch.Tensor:
    """The fp32 (N, K) weight ``table[q + 7] * scale``."""
    n, half = packed.shape
    g = scales.shape[0]
    lo, hi = unpack_int4(packed)
    q = torch.cat([lo, hi], dim=1).long() + 7                   # (N, K)
    w = table.float()[q].reshape(n, g, half * 2 // g)
    return (w * scales.float().T[:, :, None]).reshape(n, 2 * half)


def int4_matmul_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                      table: torch.Tensor) -> torch.Tensor:
    """K8's twin: dequantize in fp32, cast to x's dtype, multiply in fp32;
    (..., N) in x's dtype."""
    w = dequantize(packed, scales, table).to(x.dtype)
    return (x.float() @ w.float().T).to(x.dtype)


def _check(x2: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
           table: torch.Tensor) -> None:
    n, half = packed.shape
    g = scales.shape[0]
    for name, t, dtype in (("x", x2, torch.bfloat16), ("packed", packed, torch.int8),
                           ("scales", scales, torch.float32), ("table", table, torch.float32)):
        if (t.device != x2.device or t.dtype != dtype or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"int4_matmul: {name} must be a contiguous {dtype} tensor on "
                             f"{x2.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if (x2.shape[1] != 2 * half or g % 2 or half != g // 2 * GROUP
            or tuple(scales.shape) != (g, n) or tuple(table.shape) != (15,) or n % 8):
        raise ValueError(f"int4_matmul: x {tuple(x2.shape)}, packed {tuple(packed.shape)}, "
                         f"scales {tuple(scales.shape)}, table {tuple(table.shape)}: K must be "
                         f"2 * K/2 = an even number of {GROUP}-row groups and N a multiple of 8")
    if x2.shape[0] == 0:
        raise ValueError("int4_matmul: no rows")


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                table: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(packed, scales, table)``: x (..., K), returns (..., N)
    in x's dtype. K8 for CUDA tensors (bf16 x), the twin for CPU tensors.
    Launches are counted by name and by the flattened row count M."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, packed, scales, table)
    from chronoedit_tpu_torch.kernels import build

    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    _check(x2, packed, scales, table)
    m, n = x2.shape[0], packed.shape[0]
    out = torch.empty((m, n), device=x.device, dtype=x.dtype)
    build.check(build.lib().int4_matmul_bf16(
        x2.data_ptr(), packed.data_ptr(), scales.data_ptr(), table.data_ptr(), out.data_ptr(),
        m, n, x2.shape[1], torch.cuda.current_stream().cuda_stream), "int4_matmul", m)
    return out.reshape(*lead, n)
