#!/usr/bin/env python3
"""Write `nerf_workspaces_explorer_tpu_torch/csrc/wgmma.cuh`: one inline-PTX
wrapper per Hopper `wgmma` shape the render and training field kernels
issue.

Each wrapper is a specialisation `wgmma_bf16<N>` (m64nNk16, bf16 operands,
fp32 accumulators) or `wgmma_s8<N>` (m64nNk32, s8 operands, s32
accumulators) taking the thread's N/2 accumulator registers and the two
shared-memory descriptors (A and B both K-major), `wgmma_bf16_mn<N>`,
the bf16 form with both operands MN-major (wgmma's transpose bits: the
training field's weight-gradient products, whose operands are point-major),
or `wgmma_bf16_bt<N>`, with A K-major and B MN-major (the int4 probe's
row-major [K, N] right-hand matrix). PTX lists every
accumulator register as its own operand, so the wrappers are generated
rather than written out by hand:

    python3 scripts/gen_wgmma_header.py
"""

import os

WIDTHS = (16, 32, 64, 96, 128, 144, 192, 208, 256)  # every N the K-major products issue
MN_WIDTHS = (64, 128, 192, 256)  # every N the MN-major products issue (the dW widths)
BT_WIDTHS = (128,)  # every N the B-transposed products issue
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "nerf_workspaces_explorer_tpu_torch", "csrc", "wgmma.cuh")

KINDS = (
    # name, C type, asm constraint, PTX shape suffix, k, trailing operands, widths
    ("bf16", "float", "f", "f32.bf16.bf16", 16, ", p, 1, 1, 0, 0", WIDTHS),
    ("s8", "int", "r", "s32.s8.s8", 32, ", p", WIDTHS),
    ("bf16_mn", "float", "f", "f32.bf16.bf16", 16, ", p, 1, 1, 1, 1", MN_WIDTHS),
    ("bf16_bt", "float", "f", "f32.bf16.bf16", 16, ", p, 1, 1, 0, 1", BT_WIDTHS),
)


def wrapper(name, ctype, cons, types, k, tail, n):
    regs = n // 2
    outs = ", ".join(f"%{i}" for i in range(regs))
    lines = [
        "template <>",
        f"__device__ __forceinline__ void wgmma_{name}<{n}>({ctype} (&d)[{regs}], uint64_t a, uint64_t b, int acc) {{",
        "  asm volatile(",
        '      "{\\n.reg .pred p;\\n"',
        f'      "setp.ne.b32 p, %{regs + 2}, 0;\\n"',
        f'      "wgmma.mma_async.sync.aligned.m64n{n}k{k}.{types} "',
        f'      "{{{outs}}}, "',
        f'      "%{regs}, %{regs + 1}{tail};\\n}}\\n"',
        "      : " + ", ".join(f'"+{cons}"(d[{i}])' for i in range(regs)),
        '      : "l"(a), "l"(b), "r"(acc));',
        "}",
        "",
    ]
    return "\n".join(lines)


def main():
    parts = [
        "// Generated by scripts/gen_wgmma_header.py; edit that script, not this file.",
        "//",
        "// wgmma_bf16<N>: D[64 x N] (+)= A[64 x 16] . B[N x 16]^T, bf16, fp32 accumulators;",
        "// wgmma_s8<N>:   D[64 x N] (+)= A[64 x 32] . B[N x 32]^T, s8, s32 accumulators.",
        "// wgmma_bf16_mn<N>: the bf16 form with A and B MN-major (transpose bits set).",
        "// wgmma_bf16_bt<N>: the bf16 form with A K-major and B MN-major.",
        "// A and B are shared-memory descriptors (K-major unless _mn or _bt); acc = 0 overwrites D.",
        "// Thread t of the warpgroup holds d[4j + i] = D[16 (t / 32) + (t % 32) / 4 + 8 (i / 2),",
        "// 8 j + 2 (t % 4) + i % 2] for the f32 and the s32 forms alike.",
        "",
        "#pragma once",
        "",
        "#include <stdint.h>",
        "",
        "template <int N> __device__ void wgmma_bf16(float (&d)[N / 2], uint64_t a, uint64_t b, int acc);",
        "template <int N> __device__ void wgmma_s8(int (&d)[N / 2], uint64_t a, uint64_t b, int acc);",
        "template <int N> __device__ void wgmma_bf16_mn(float (&d)[N / 2], uint64_t a, uint64_t b, int acc);",
        "template <int N> __device__ void wgmma_bf16_bt(float (&d)[N / 2], uint64_t a, uint64_t b, int acc);",
        "",
    ]
    for *kind, widths in KINDS:
        for n in widths:
            parts.append(wrapper(*kind, n))
    with open(OUT, "w") as f:
        f.write("\n".join(parts))


if __name__ == "__main__":
    main()
