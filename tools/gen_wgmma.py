#!/usr/bin/env python3
"""Write ``flashinfer_tpu_torch/csrc/wgmma.cuh``: the Hopper ``wgmma``
wrappers the flash, grouped-GEMM and paged kernels use, one per instruction shape
(PTX lists every accumulator register, so each N needs its own operand
list).

    python3 tools/gen_wgmma.py

- ``wgmma_ss<N>``: D[64 x N] (+)= A[64 x 16] . B[N x 16]^T, bf16 in, f32
  accumulators, A and B from shared memory through descriptors, both
  K-major; ``scale_d`` 0 overwrites D.
- ``wgmma_ss_ta<N>``: the same with A MN-major (``tnspA`` = 1).
- ``wgmma_ss_tb<N>``: the same with B MN-major (``tnspB`` = 1): D[64 x N]
  (+)= A[64 x 16] . B[16 x N], B's N columns contiguous in shared memory.
- ``wgmma_rs<N>``: D[64 x N] += A[64 x 16] . B[16 x N], A from registers
  (the m16n8k16 A fragment of each warp's 16 rows), B from shared memory
  MN-major (``tnspB`` = 1); ``scale_d`` 0 overwrites D.
- ``wgmma_rs_kb<N>``: the same with B K-major (``tnspB`` = 0).
"""

from pathlib import Path

# the grouped GEMM's m-tiles and the paged kernel's decode tiles (their
# wgmma N; the flash kernel's key tiles are two of them) and the flash
# kernel's value widths
TM_N = (8, 16, 32, 64, 128)
RS_N = (64, 128, 192, 256)
# the MLA prefill kernel's P.V: half of d_ckv (512) a consumer warpgroup
TB_N = (256,)
OUT = (Path(__file__).resolve().parent.parent / "flashinfer_tpu_torch" /
       "csrc" / "wgmma.cuh")


def _regs(first, count):
    return ", ".join(f"%{first + i}" for i in range(count))


def _outs(count):
    return ", ".join(f'"+f"(d[{i}])' for i in range(count))


def ss(n, name="wgmma_ss", trans_a=0, trans_b=0):
    r = n // 2
    return f"""template <>
__device__ __forceinline__ void {name}<{n}>(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{_regs(0, r)}}}, "
      "%{r}, %{r + 1}, p, 1, 1, {trans_a}, {trans_b};\\n}}\\n"
      : {_outs(r)}
      : "l"(da), "l"(db), "r"(scale_d));
}}
"""


def rs(n, name="wgmma_rs", trans_b=1):
    r = n // 2
    return f"""template <>
__device__ __forceinline__ void {name}<{n}>(float* d, const uint32_t* a,
                                             uint64_t db, int scale_d) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{_regs(0, r)}}}, "
      "{{{_regs(r, 4)}}}, %{r + 4}, p, 1, 1, {trans_b};\\n}}\\n"
      : {_outs(r)}
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}}
"""


def main():
    parts = [
        "// Generated by tools/gen_wgmma.py; do not edit by hand.\n"
        "// Hopper wgmma wrappers (sm_90a): see that script's docstring.\n",
        "#pragma once\n#include <stdint.h>\n",
        "template <int N>\n__device__ void wgmma_ss(float* d, uint64_t da, "
        "uint64_t db, int scale_d);\n",
        "template <int N>\n__device__ void wgmma_ss_ta(float* d, uint64_t da, "
        "uint64_t db, int scale_d);\n",
        "template <int N>\n__device__ void wgmma_ss_tb(float* d, uint64_t da, "
        "uint64_t db, int scale_d);\n",
        "template <int N>\n__device__ void wgmma_rs(float* d, "
        "const uint32_t* a, uint64_t db,\n"
        "                         int scale_d);\n",
        "template <int N>\n__device__ void wgmma_rs_kb(float* d, "
        "const uint32_t* a, uint64_t db,\n"
        "                            int scale_d);\n",
    ]
    parts += [ss(n) for n in TM_N]
    parts += [ss(n, "wgmma_ss_ta", 1) for n in TM_N]
    parts += [ss(n, "wgmma_ss_tb", 0, 1) for n in TB_N]
    parts += [rs(n) for n in RS_N]
    parts += [rs(n, "wgmma_rs_kb", 0) for n in TM_N]
    OUT.write_text("\n".join(parts))


if __name__ == "__main__":
    main()
