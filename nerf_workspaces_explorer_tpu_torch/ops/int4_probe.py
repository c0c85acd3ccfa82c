"""int4 operands on the tensor cores: the two legs of the int4 probe.

Counterpart of `scripts/probe_int4_tpu.py`'s Pallas legs: an int4 matrix
[M, K] widened to bf16, times a bf16 matrix [K, N], fp32 accumulation.
`int4_matmul` launches `csrc/int4_probe.cu` for CUDA tensors and runs
`int4_matmul_plain` for CPU tensors. An int4 matrix is int8 storage holding
[-8, 7] (PyTorch has no arithmetic int4 type), or with `packed` a uint8
[M / 2, K] of nibble pairs (`pack_int4_rows`): the low nibble row 2i, the
high nibble row 2i + 1. The kernel (wgmma on a swizzled shared-memory tile
of the widened stripe) takes M a multiple of 64, N a multiple of 128 and
K = 128, the probe's 128 x 128 x 128 among them; other
shapes on the card raise. The plain version takes any shape.
"""

from __future__ import annotations

import torch

from nerf_workspaces_explorer_tpu_torch.ops import _build

# Kernel launches made by `int4_matmul`, by leg.
LAUNCHES = {"int4_operand": 0, "int4x2_packed": 0}


def pack_int4_rows(w4: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] in [-8, 7] (M even) -> uint8 [M / 2, K]: row 2i in the low
    nibble, row 2i + 1 in the high one (probe_int4_tpu.py:55)."""
    return ((w4[0::2] & 0xF) | ((w4[1::2] & 0xF) << 4)).to(torch.uint8)


def unpack_int4_rows(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [M / 2, K] -> int8 [M, K]: each nibble moved to the top of a
    byte and shifted back arithmetically (sign extension by shifts)."""
    lo = (packed << 4).to(torch.int8) >> 4
    hi = packed.to(torch.int8) >> 4
    return torch.stack([lo, hi], 1).reshape(-1, packed.shape[1])


def int4_matmul_plain(a: torch.Tensor, b: torch.Tensor, packed: bool = False) -> torch.Tensor:
    """Plain PyTorch version: the int4 values widened to bf16 (exact), the
    product in fp32 (products of bf16 values are exact in fp32)."""
    w = unpack_int4_rows(a) if packed else a
    return w.to(torch.bfloat16).float() @ b.float()


def int4_matmul(a: torch.Tensor, b: torch.Tensor, packed: bool = False) -> torch.Tensor:
    """int4 [M, K] (int8 storage, or packed uint8 [M / 2, K]) widened to bf16
    @ bf16 [K, N] -> fp32 [M, N]. On the card M is a multiple of 64, N of
    128, and K is 128."""
    rows = a.shape[0] * (2 if packed else 1)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int4 [{rows}, K] @ [K, N]: got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != (torch.uint8 if packed else torch.int8) or b.dtype != torch.bfloat16:
        raise ValueError("a: int8 values in [-8, 7] (uint8 nibble pairs when packed); b: bfloat16")
    if b.device.type == "cpu":
        return int4_matmul_plain(a, b, packed)
    if b.device.type != "cuda" or a.device != b.device:
        raise ValueError(f"no int4 kernel for devices {a.device} and {b.device}")
    m, (k, n) = rows, b.shape
    if m < 1 or n < 1 or m % 64 or n % 128 or k != 128:
        raise ValueError(f"the int4 kernel takes M a multiple of 64, N a multiple of 128 and K = 128, got "
                         f"M, N, K = {m, n, k}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the int4 kernel takes contiguous operands")
    out = torch.empty((m, n), dtype=torch.float32, device=b.device)
    _build.launch("int4_probe", "int4_probe_launch", a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, int(packed),
                  _build.stream_handle(b.device))
    LAUNCHES["int4x2_packed" if packed else "int4_operand"] += 1
    return out
