// The paged kernel's gather build, for pages whose size is not a multiple of
// 8 tokens: csrc/paged_attention.cu compiled with FI_PAGED_GATHER, whose
// tensor-core producers copy each page row by cp.async instead of a TMA
// box (that source's note says why and how). A library of its own, so
// the TMA build's instructions stay as they were; the wrapper
// (ops/attention/kernels/paged.py) picks the build by page size.

#define FI_PAGED_GATHER 1
#include "paged_attention.cu"
