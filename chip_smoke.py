#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``flashinfer_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out PATH]

Run from the root of a checkout. Phases, in order:

1. card: the card's name and power limit from nvidia-smi;
2. build: every CUDA kernel built with nvcc from ``flashinfer_tpu_torch/csrc``
   (one process per source, all at once); ``cuobjdump -sass`` counts the
   wgmma (HGMMA), TMA load (UTMALDG) and mma.sync (HMMA) instructions of
   the flash, grouped-GEMM, MLA and paged-attention libraries, and the
   phase fails if one lacks wgmma or TMA, or the grouped GEMM holds an
   mma.sync, or the paged kernel's gather build lacks wgmma or holds a TMA
   load;
3. native host runtime: the C++ planner and page pool (``csrc/host``,
   built with the system C++ compiler) load with ABI 4; the engine's
   decode, prefill and verify plans and every MLA plan of the DeepSeek
   loop at V2-Lite widths are equal native and NumPy, field by field; both
   planners' host us a call on the engine's decode and prefill batches;
4. kernel checks: each kernel against its plain PyTorch version on the card
   with its time (CUDA events), its bound, the plain version's time and,
   where one PyTorch call computes the same function, that call's time:
   paged attention, the sampler and RMSNorm at the shapes the Llama-3-8B
   engine gives them (paged attention also at the speculative verify plan,
   at head_dim 256 and on POD's combined plan; the sampler also in renorm
   mode at the verify step's 32 rows and its draw, and at the DeepSeek and
   Mixtral paths' vocabularies); MLA attention at
   DeepSeek-V2-Lite shapes (decode and causal prefill, bf16/e4m3/int8
   caches); the grouped GEMM (both MoE GEMMs, bf16 and e4m3 weights) at
   the V2-Lite decode and prefill routings, a Mixtral-8x7B layer and
   Mixtral's decode routing (8 tokens, top-2 of 8), and as ``w8_matmul``
   (one group, per-column scales) at Llama-3-8B's five weight shapes, 8 /
   32 / 4096 rows, e4m3 and int8 weights, beside the
   cast + ``torch.matmul`` route and bf16 ``torch.matmul``; the flash kernel at Llama-3-8B prefill (8192 tokens
   causal), chunked prefill (2048 at the tail of 8192) and decode (32K
   keys), DeepSeek-V2-Lite's MHA prefill (d 192, dv 128), each variant at
   Llama widths on 2048 tokens, and a small f32 case. Beside the sampler
   check, four ``LogitsPipe``s on [8, 128256] logits (the pipe path): each
   pipe's tokens bit-equal to the direct sampler calls with the same seed,
   its sampler launches and ms. After the grouped-GEMM checks, fused_moe's
   four API entry points (the moe_api path) at published layers:
   ``cutlass_fused_moe`` and ``trtllm_fp8_per_tensor_scale_moe`` at a
   Mixtral-8x7B layer, ``trtllm_fp8_block_scale_moe`` at a DeepSeek-V3
   layer (256 experts, e4m3 with 128 x 128 block scales),
   ``trtllm_fp4_block_scale_moe`` at a gpt-oss-120b layer (mxfp4), each at
   8 and 1024 tokens against the plain ragged_dot route, with the
   block-scale dequantization timed on its own;
5. single request: Llama-3-8B widths over 32 layers, an 8192-token prompt
   through ``single_prefill_with_kv_cache`` and 32
   ``single_decode_with_kv_cache`` steps (the single path: its flash
   launches are read here), then a tiny f32 case card vs CPU;
6. POD: 32 decodes of 512-4096 keys beside a 2048-token chunk of an
   8192-token prompt, Llama-3-8B widths, page 16, HND, 32 layers, both modes
   (the pod path: its launches are read here); the modes must agree with
   their plain versions and each other; the two-launch mode is then traced
   (device time by kernel family, busy share);
7. cascade: ``MultiLevelCascadeAttentionWrapper`` with 32 requests sharing
   a 4096-token prefix (level 0) and their own suffixes of 64-512 tokens
   (level 1, causal), Llama-3-8B attention widths, page 16, decode (1 query
   token a request; NHD and HND) and append (16; NHD): against flat
   ``BatchAttention`` over the concatenated page tables and the f32
   oracle, each plan's paged-kernel launch against its plain version,
   cascade and flat timed (the cascade path: its launches are read here);
8. paged surface: the paged-attention surface at full width, each case
   through the wrapper a user calls (the surface path: its launches are
   read here): an EAGLE-style tree verify step (8 requests, contexts of
   512-4096 and a 64-token draft tree each, packed custom mask),
   multi-item scoring (2 requests: a 1024-token prefix and 64 items of 16),
   GPT-OSS-120B attention with sinks and a 128-token window (decode batch
   8 over 4096 keys, a 2048-token prefill), MPT-7B's ALiBi (8 prompts of
   1024, then their decode), ragged prefill (8 contiguous prompts of
   512-4096), decode on pages of 1 and 4 tokens, BSR (8192 x 8192 in 64 x
   64 blocks, ~10%) and variable block-sparse (4096 tokens, blocks of
   32-256, ~20%), and ``kv_chunk_size=None`` on the engine's decode and
   prefill batches: each against the f32 oracle and its kernel launch
   against the plain version, timed beside its bound, the plain version,
   SDPA and, where the wrapper gathers its keys, the gather;
9. variants: callers' attention variants written as plain torch hooks
   through the variant JIT (``flashinfer_tpu_torch/jit/variant.py``):
   their flash and paged libraries built at once (nvcc with the generated
   header) into ``flashinfer_tpu_torch/_build/``; then the variants path
   (its launches are read here): (a) ALiBi from its slopes at MPT-7B's
   heads, (b) a document mask (8 documents of 1024), (c) a q scale and an
   output affine, (d) the sigmoid, each through
   ``single_prefill_with_kv_cache`` (8192 tokens, causal), and (a)-(c)
   through the batch prefill (the engine's 8 prompts) and decode (8
   requests) wrappers on bf16 and e4m3 caches; second calls build
   nothing; each launch against its plain version, (a) and (d) against
   the built-in variant too, timed beside the built-in variant (or the
   default), the bound, the plain version and SDPA where one call
   computes it;
10. tiny references: the f32 tiny Llama engine, and the f32 tiny DeepSeek
   and Mixtral decode loops, on the card (every kernel on) emit the greedy
   tokens of the same model on the CPU (every plain version); the tiny
   engine with
   speculative decoding (3 drafts) on repetitive prompts emits them on the
   card, on the CPU and without drafts, with drafts accepted; the tiny
   engine with e4m3 and int8 weights (decode, window 4, 3 drafts) emits
   the CPU's tokens;
11. engine: ``LlamaServingEngine`` at Llama-3-8B widths and depth in bf16,
   random weights from a seeded CUDA generator, 12 requests of 64-512
   prompt tokens and 32 new tokens on 8 slots, sampled and greedy, in three
   modes: the decode step eager (``cuda_graphs=False``), replayed from CUDA
   graphs (the engine's default; its sampled run is the Llama path, whose
   kernel launch counts are read from it), and replayed four steps a
   window (``decode_window=4``), then with speculative decoding
   (``spec_tokens=3``: the spec path, its verify step eager and graphed);
   each mode's tokens/s, step wall ms (a verify step's for spec), device ms
   and ops, busy share, planner ms and graphs captured, and for spec the
   tokens a verify step emits and the drafts' acceptance. Greedy tokens
   must be identical in the three decode modes, sampled tokens in the
   first two, and the spec modes' tokens eager and graphed, sampled too;
   the share of greedy spec tokens equal to the decode's is reported.
   Then greedy again with the HND layout and the e4m3 and int8 KV caches;
   then 8-bit weights quantized from the same bf16 weights: e4m3 graphed
   sampled (the 8-bit weight path, whose launch counts are read; the
   grouped GEMM runs every matmul), graphed greedy and eager greedy
   (tokens identical), and int8 graphed greedy, each with its agreement
   with the bf16 greedy tokens. Every mode runs on the C++ pool and
   planner; the graphed greedy run is served again with
   ``FLASHINFER_TPU_PLANNER=numpy`` (the same tokens, its own planner ms),
   and one graphed sampled decode step is traced with
   ``profiler.profile_trace``, whose ``summarize_trace`` must name the
   paged, RMSNorm and sampler kernels;
11b. pages: pages of 12 and 20 tokens, which the paged kernel's gather
   build reads in place (``csrc/paged_attention_gather.cu``): its launches
   at the engine's Llama-3-8B decode and prefill plans on those pages (NHD
   and HND; bf16, e4m3 and int8; decode also at head_dim 256) against the
   plain version, timed, each launch counted as the gather build's; the
   repack route it replaces at page 12 (the gather into 128-token pages
   and the launch there, timed apart); then the engine phase's weights
   through ``LlamaServingEngine`` at page 12, greedy, eager and graphed
   (tokens identical; the graphed run is the pages path, whose launch
   counts are read from it), and at page 16 graphed on the same traffic;
12. distributed: ``torch.distributed`` at world size 1 through NCCL (a
   FileStore; the group is destroyed at the phase's end): the mesh views
   of ``parallel.make_mesh``, every collective and ``MoeAlltoAll`` against
   their local math, ring (causal and not) and Ulysses attention at cp 1
   on the single-request phase's shapes (the same o and lse as one direct
   flash call; their flash launches are the parallel_attention path),
   ``fused_moe_ep`` / ``fused_moe_tp`` at size 1 on a Mixtral-8x7B layer
   (8 tokens, bf16 and e4m3) against ``fused_moe`` (the parallel_moe
   path), ``llama_forward_pipelined`` at pp 1 over two Llama-3-8B layers
   against the dense forward (the pipeline path), the tiny f32
   ``DistributedServingEngine`` against ``LlamaServingEngine`` (model,
   e4m3, int8 KV: tokens equal) and ``make_tp_decode_step`` at tp 1
   against the dense logits (the tp_step path); then the engine phase's
   Llama-3-8B weights through ``DistributedServingEngine`` (dp = tp = 1,
   8 requests, 16 new tokens, 512 rows a step, eager): greedy (profiled)
   and sampled (the distributed path, whose launch counts are read from
   it), beside ``LlamaServingEngine``'s graphed greedy run on the same
   traffic, with the greedy token agreement reported; then both engines
   again with the weights in f32, whose agreement must reach
   ``DIST_MIN_AGREEMENT``. A probe of NCCL send/recv to the own rank runs
   beside it in a process of its own (recorded, not required);
13. DeepSeek: ``deepseek_decode_step`` at DeepSeek-V2-Lite widths and full
   depth (27 layers) in bf16, random weights from a seeded CUDA generator,
   8 requests of 32-128 prompt tokens prefilled token by token and 32 new
   tokens each, one MLA plan per step: sampled (top-k 40, top-p 0.9: the
   DeepSeek path, whose launch counts are read from this run), greedy,
   then a short greedy run on e4m3 caches and the e4m3 witness (one step
   on bf16, e4m3 and bf16-fed-e4m3-values caches: the last two must
   agree);
14. Mixtral: ``mixtral_decode_step`` at Mixtral-8x7B's widths and 16 of its
   32 layers (32 are ~93 GB in bf16) in bf16, random weights from a seeded
   CUDA generator, the DeepSeek phase's traffic (8 requests of 32-128
   prompt tokens fed token by token, 32 new tokens each, page 16), a fresh
   decode plan a step: sampled (the Mixtral path, whose launch counts are
   read from this run) and greedy;
15. tooling: ``aot.warmup()``, ``python -m flashinfer_tpu_torch
   show-config``, and the autotuner (``tune --quick`` in ``autotune()``,
   its winners persisted to a temporary config path);
16. one ``{"kernels": [...]}`` line, then the result line.

The script exits non-zero, and prints no result line, when the machine has
no CUDA device, when it is not run from a checkout, or when any phase fails.
``--out`` also writes every measurement to a JSON file.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import time
import traceback

DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# dense, no sparsity (NVIDIA data sheet, SXM part)
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12, "fp8": 1979e12,
                  "int8": 1979e12}
SOURCE_DIR = "flashinfer_tpu_torch"

# o: two bf16 steps of |ref| (each side rounds its output once), plus one
# bf16 unit roundoff of a unit-size P.V sum (P is rounded to bf16 against a
# running max in the kernel and against the global max in the plain version)
ATTN_RTOL_O, ATTN_ATOL_O = 2.0 ** -6, 2.0 ** -8
ATTN_TOL_LSE = 1e-3  # f32 sums in other orders
NORM_TOL = 2.0 ** -7  # one bf16 rounding step, relative to the output
SAMPLER_RENORM_TOL = 1e-6
# grouped GEMM, against the plain f32 loop: one bf16 rounding step of the
# output (2^-7 relative), or 1e-3 relative for an f32 output; both plus
# 1e-3 of the output's rms, since the f32 sums run in other orders and
# their error scales with the sum of |products|, not with the result
GG_RTOL = {"bf16": 2.0 ** -7, "f32": 1e-3}
GG_ATOL_RMS = 1e-3

# DeepSeek-V2-Lite's published config (huggingface.co/deepseek-ai/
# DeepSeek-V2-Lite, config.json) as DeepSeekConfig fields: vocab_size,
# hidden_size, num_hidden_layers, num_attention_heads, kv_lora_rank,
# qk_rope_head_dim, qk_nope_head_dim (= v_head_dim), n_routed_experts,
# num_experts_per_tok, n_shared_experts, moe_intermediate_size, n_group,
# topk_group, rope_theta, rms_norm_eps
V2_LITE = dict(vocab_size=102400, hidden_size=2048, num_layers=27,
               num_heads=16, head_dim_ckv=512, head_dim_kpe=64,
               head_dim_qk_nope=128, num_experts=64, top_k=6,
               num_shared_experts=2, moe_inter_size=1408, n_group=1,
               topk_group=1, rope_theta=1e4, rms_eps=1e-6)
MLA_PAGE = 16
# grouped-GEMM check routings: (name, tokens, experts, top_k, hidden, inter)
GG_CASES = (
    ("v2lite_decode", 8, 64, 6, 2048, 1408),
    ("v2lite_prefill", 2048, 64, 6, 2048, 1408),
    # the JAX bench's Mixtral-8x7B layer (benchmarks/
    # flashinfer_tpu_benchmark.py:559-566)
    ("mixtral_layer", 4096, 8, 2, 4096, 14336),
    # the decode routing the Mixtral phase serves: 8 tokens, top-2 of 8
    ("mixtral_decode", 8, 8, 2, 4096, 14336),
)


def log(*args):
    print(*args, flush=True)


class Phases:
    """Runs named phases; a phase that raises is reported and marks the run
    failed, and the later phases that do not depend on it still run."""

    def __init__(self):
        self.failed = []

    def run(self, name, fn, *args):
        log(f"== {name}")
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception:  # reported, and fails the run at the end
            traceback.print_exc(file=sys.stdout)
            log(f"== {name}: FAILED")
            self.failed.append(name)
            return None
        log(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)")
        return out


def cuda_ms(torch, fn, iters, warmup=2, graph=False):
    """Mean milliseconds per call of ``fn`` on the card, from CUDA events.
    With ``graph``, the ``iters`` calls are captured in one CUDA graph and
    replayed, so the time is the device's alone, without the host's launch
    gaps; without it, the time is that of back-to-back eager calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()
        torch.cuda.synchronize()
        reps = 5
        start.record()
        for _ in range(reps):
            g.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (reps * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, ops, kind="bf16"):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------- card

def phase_card():
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(line)
    return line


# -------------------------------------------------------------------- build

# the libraries built on wgmma and TMA
TENSOR_CORE_LIBS = ("flash_attention", "grouped_gemm", "paged_attention",
                    "mla_attention")
# the paged kernel's gather build: wgmma, pages copied by cp.async (no TMA)
GATHER_LIB = "paged_attention_gather"


def phase_build():
    from flashinfer_tpu_torch import jit

    secs = jit.build_all()
    for name in jit.KERNEL_SOURCES:
        log(f"built {name}.cu" + (f" in {secs[name]:.1f} s" if name in secs
                                  else " (cached)"))
        for ln in jit.build_log(name).splitlines():
            # register and spill reports; C75xx (wgmma serialised, for
            # one) but C7519, an informational fence the compiler adds
            if ("Used" in ln and "registers" in ln or "spill" in ln
                    or (name in TENSOR_CORE_LIBS + (GATHER_LIB,)
                        and "C75" in ln and "C7519" not in ln)):
                log("  ptxas:", ln.strip())
    for name in TENSOR_CORE_LIBS:
        sass = sass_counts(name)
        log(f"{name} SASS: {sass}")
        if not (sass["HGMMA"] and sass["UTMALDG"]):
            raise AssertionError(f"{name} lacks wgmma or TMA: {sass}")
        if name == "grouped_gemm" and sass["HMMA"]:
            raise AssertionError(f"{name} still holds mma.sync: {sass}")
    sass = sass_counts(GATHER_LIB)
    log(f"{GATHER_LIB} SASS: {sass}")
    if not sass["HGMMA"] or sass["UTMALDG"]:
        raise AssertionError(f"{GATHER_LIB} lacks wgmma or loads by TMA: "
                             f"{sass}")
    return secs


def sass_counts(name):
    """How many wgmma (HGMMA), TMA load (UTMALDG) and mma.sync (HMMA)
    instructions ``cuobjdump -sass`` finds in the library of
    ``csrc/<name>.cu``."""
    from flashinfer_tpu_torch import jit

    cuobjdump = os.path.join(os.path.dirname(jit._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(jit._lib_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    ops = []
    for ln in sass.splitlines():  # "/*0090*/ @P0 HGMMA.64x128x16... ;"
        words = [w for w in ln.split("*/", 1)[-1].split()
                 if not w.startswith("@")]
        if words:
            ops.append(words[0].split(".")[0])
    return {op: sum(o == op for o in ops)
            for op in ("HGMMA", "UTMALDG", "HMMA")}


# ----------------------------------------------------------- kernel checks

LAYERS_ROTATED = 8  # distinct caches per timing loop: 8 layers exceed L2


def _page_table(np, lens, ps):
    """(indptr, page ids) of requests of ``lens`` tokens on ``ps``-token
    pages, the ids a seeded permutation."""
    npages = -(-np.asarray(lens) // ps)
    indptr = np.concatenate([[0], np.cumsum(npages)]).astype(np.int32)
    indices = np.random.default_rng(1).permutation(
        int(indptr[-1])).astype(np.int32)
    return indptr, indices


def _engine_like_plans(np, lens_decode, lens_prefill, d=128, ps=16):
    """Plans built as the engine builds them (engine.py _decode and
    _prefill) at Llama-3-8B heads (head_dim ``d``), pages of ``ps``
    tokens, chunk 512 (rounded up to whole pages by the planner)."""
    from flashinfer_tpu_torch.ops.attention.batch import (
        BatchDecodeWithPagedKVCacheWrapper,
        BatchPrefillWithPagedKVCacheWrapper,
    )
    from flashinfer_tpu_torch.utils import next_power_of_2

    hq, hkv, chunk, page_bucket = 32, 8, 512, 1024

    def table(lens):
        indptr, indices = _page_table(np, lens, ps)
        padded = np.zeros(page_bucket, np.int32)
        padded[: len(indices)] = indices
        last = (((np.asarray(lens) - 1) % ps) + 1).astype(np.int32)
        return indptr, padded, last, int(indptr[-1])

    plans = {}
    indptr, idx, last, pages = table(lens_decode)
    kv = np.asarray(lens_decode, np.int64)
    needed = int(sum(-(-int(n) // chunk) for n in kv))
    cap = min(next_power_of_2(max(8, len(kv) * 4)),
              next_power_of_2(max(8, needed)))
    w = BatchDecodeWithPagedKVCacheWrapper(kv_layout="NHD", device=DEVICE)
    w.plan(indptr, idx, last, hq, hkv, d, ps, kv_len_arr=kv,
           kv_chunk_size=chunk, work_capacity=cap)
    plans["decode"] = (w.device_plan, pages, kv, np.ones_like(kv))

    indptr, idx, last, pages = table(lens_prefill)
    lens = np.asarray(lens_prefill, np.int64)
    nnz = int(lens.sum())
    bucket = next_power_of_2(max(nnz, 8))
    qo_indptr = np.concatenate([[0], np.cumsum(lens), [bucket]])
    w = BatchPrefillWithPagedKVCacheWrapper(kv_layout="NHD", tile_q=256,
                                            device=DEVICE)
    w.plan(qo_indptr, np.concatenate([indptr, [indptr[-1]]]), idx,
           np.concatenate([last, [0]]), hq, hkv, d, ps, causal=True,
           kv_chunk_size=chunk)
    plans["prefill"] = (w.device_plan, pages, lens, lens)

    # the spec verify step (engine.py _spec_decode): the decode batch's
    # sequences with SPEC_TOKENS drafts reserved, G + 1 causal rows each,
    # a dummy request for the pad rows, the engine's work capacity (8
    # slots x 4 chunks of 512 at max_seq_len 2048)
    rows = SPEC_TOKENS + 1
    kv = np.asarray(lens_decode, np.int64) + SPEC_TOKENS
    indptr, idx, last, pages = table(kv)
    b = len(kv)
    bucket = next_power_of_2(max(b * rows, 8))
    w = BatchPrefillWithPagedKVCacheWrapper(kv_layout="NHD", device=DEVICE)
    w.plan(np.concatenate([np.arange(b + 1) * rows, [bucket]]),
           np.concatenate([indptr, [indptr[-1]]]), idx,
           np.concatenate([last, [0]]), hq, hkv, d, ps, causal=True,
           kv_chunk_size=chunk, kv_len_arr=np.concatenate([kv, [0]]),
           work_capacity=32)
    plans["verify"] = (w.device_plan, pages, kv, np.full(b, rows))
    return plans


def _attention_work(kv_lens, qo_lens, heads):
    """(query head, key) pairs a batch needs under its causal mask: query i
    of a request of qo tokens and kv keys sees kv - qo + i + 1 keys (all kv
    keys for a decode token)."""
    pairs = sum(int(qo) * (int(kv) - int(qo)) + int(qo) * (int(qo) + 1) // 2
                for kv, qo in zip(kv_lens, qo_lens))
    return pairs * heads


def _attention_bytes(plan, pages, kv_lens, tile_q, hkv, d, kv_itemsize):
    """Bytes the work list must move: the K and V of every token, the q
    tiles and the partial outputs of the items that have keys (padding
    items and rows past the last tile are read by no item), the plan, and
    the page-table entries in use."""
    p = plan.reshape(12, -1).cpu().numpy()
    real = (p[0] >= 0) & (p[6] > p[5])  # REQ >= 0 and KV_END > KV_START
    q_tiles = len(set(p[3][real].tolist()))  # distinct QO_START
    kv = 2 * int(kv_lens.sum()) * hkv * d * kv_itemsize
    q = q_tiles * tile_q * hkv * d * 2
    out = int(real.sum()) * hkv * tile_q * (d * 2 + 4)
    return kv + q + out + p.size * 4 + pages * 4


def _attn_check(torch, got, want, mag=None):
    """err_o (largest |o| error), o_ratio (the largest error over its ATTN
    limit: <= 1 passes), ref_at_worst (|ref o| where that ratio is
    reached), err_lse, same_inf (-inf lse at the same places) and ok.
    ``mag``, the f32 oracle's sum of P |v| at each element, widens the
    absolute limit to 2^-8 of it where it exceeds 1: P's bf16 rounding errs
    by up to 2^-9 of each term of o, and the terms need not cancel as o's
    do (a causal row over a few keys)."""
    (o, lse), (ref_o, ref_lse) = got, want
    diff = (o.float() - ref_o.float()).abs()
    atol = (ATTN_ATOL_O if mag is None
            else ATTN_ATOL_O * mag.float().clamp(min=1.0))
    ratios = diff / (ATTN_RTOL_O * ref_o.float().abs() + atol)
    worst = int(ratios.argmax())
    finite = torch.isfinite(ref_lse)
    same_inf = bool(torch.equal(finite, torch.isfinite(lse)))
    err_lse = (float((lse[finite] - ref_lse[finite]).abs().max())
               if bool(finite.any()) else 0.0)
    ratio = float(ratios.reshape(-1)[worst])
    return dict(err_o=float(diff.max()), o_ratio=ratio,
                ref_at_worst=float(ref_o.float().abs().reshape(-1)[worst]),
                err_lse=err_lse, same_inf=same_inf,
                ok=ratio <= 1.0 and err_lse <= ATTN_TOL_LSE and same_inf)


def _pod_combined_case(np):
    """The POD phase's combined plan (its decodes, its chunk at the tail of
    its prompt, page 16, KV chunk 512): (plan, pages, kv_lens, qo_lens)."""
    from flashinfer_tpu_torch.ops.attention.pod import (
        PODWithPagedKVCacheWrapper,
    )

    hq, hkv, d = LLAMA_HEADS
    ps = POD_PAGE
    rng = np.random.default_rng(16)  # phase_pod's lengths and pages
    kv_lens = rng.integers(POD_KV_RANGE[0], POD_KV_RANGE[1] + 1, POD_DECODES)
    npages = -(-kv_lens // ps)
    indptr = np.concatenate([[0], np.cumsum(npages)])
    num_pages = int(indptr[-1]) + -(-POD_PROMPT // ps)
    perm = rng.permutation(num_pages)
    w = PODWithPagedKVCacheWrapper(device=DEVICE).plan(
        indptr, perm[:indptr[-1]], kv_lens - (npages - 1) * ps, hq, hkv, d,
        ps, kv_len_arr=kv_lens, kv_chunk_size=POD_KV_CHUNK,
        prefill_qo_len=POD_CHUNK, prefill_kv_len=POD_PROMPT,
        prefill_page_indices=perm[indptr[-1]:])
    return (w._attn.device_plan, num_pages,
            np.concatenate([[POD_PROMPT], kv_lens]),
            np.concatenate([[POD_CHUNK], np.ones_like(kv_lens)]))


def _paged_plain(torch, q, kc, vc, kv_idx, plan, items=256, work_mask=None,
                 **kw):
    """``paged_attention_plain`` over the work list ``items`` items at a
    time (POD's combined plan holds ~1000 items of 256 rows x 512 keys),
    with their rows of ``work_mask``."""
    from flashinfer_tpu_torch.ops.attention.kernels.paged import (
        paged_attention_plain,
    )

    rows = plan.reshape(12, -1)
    outs = [paged_attention_plain(
                q, kc, vc, kv_idx,
                rows[:, a:a + items].contiguous().reshape(-1),
                work_mask=None if work_mask is None
                else work_mask[a:a + items], **kw)
            for a in range(0, rows.shape[1], items)]
    return tuple(torch.cat(x) for x in zip(*outs))


def check_paged_attention(torch, np, lens_decode, lens_prefill):
    """The paged kernel against its plain version on every row (padding
    rows: the identity in both), timed, at the engine's Llama-3-8B decode
    and prefill plans (NHD and HND; bf16, e4m3 and int8 caches), the same
    decode at head_dim 256, and POD's combined plan (HND, Llama-3-8B widths:
    32 decodes in 256-row tiles beside a 2048-token chunk)."""
    cases = [(mode, 128, plan,
              ("NHD",) if mode == "verify" else ("NHD", "HND"))
             for mode, plan in
             _engine_like_plans(np, lens_decode, lens_prefill).items()]
    cases.append(("decode", 256, _engine_like_plans(
        np, lens_decode, lens_prefill, d=256)["decode"], ("NHD", "HND")))
    cases.append(("pod_combined", 128, _pod_combined_case(np), ("HND",)))
    return _paged_rows(torch, cases, 16, "paged_attention")


def _paged_rows(torch, cases, ps, label):
    """Each case's plan (mode, head_dim, (plan, pages, kv lens, qo lens),
    layouts) on bf16, e4m3 and int8 caches of ``ps``-token pages: the
    kernel against its plain version on every row, timed (in a CUDA graph
    and as a call) beside its bound and the plain version. Raises if a
    case disagrees."""
    from flashinfer_tpu_torch.ops.attention.batch import pack_queries
    from flashinfer_tpu_torch.ops.attention.kernels.paged import (
        batch_paged_attention_run,
    )
    from flashinfer_tpu_torch.utils import TensorLayout

    hq, hkv = 32, 8
    group = hq // hkv
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for mode, d, (dp, pages, kv_lens, qo_lens), layouts in cases:
        m = dp.meta
        if mode == "pod_combined":  # the real packing: padding rows are 0
            q = pack_queries(dp, torch.randn(
                m.nnz, hq, d, device=dev, generator=gen, dtype=torch.bfloat16))
        else:
            q = torch.randn(hkv, m.bucket_rows, d, device=dev, generator=gen,
                            dtype=torch.bfloat16)
        plan, kv_idx = dp.segment("plan"), dp.segment("kv_indices")
        for layout in layouts:
            shape = ((LAYERS_ROTATED * pages, hkv, ps, d) if layout == "HND"
                     else (LAYERS_ROTATED * pages, ps, hkv, d))
            for kv_dtype in ("bf16", "e4m3", "int8"):
                caches = []
                for _ in range(2):
                    x = torch.randn(shape, device=dev, generator=gen,
                                    dtype=torch.bfloat16)
                    if kv_dtype == "int8":
                        x = (x * 25).round().clamp(-127, 127).to(torch.int8)
                    elif kv_dtype == "e4m3":
                        x = (x * 4).to(torch.float8_e4m3fn)
                    caches.append(x)
                kc, vc = caches
                scales = {"bf16": (1.0, 1.0), "int8": (0.04, 0.04),
                          "e4m3": (0.25, 0.25)}[kv_dtype]
                kw = dict(tile_q=m.tile_q, group=group, causal=m.causal,
                          sm_scale=m.sm_scale, k_scale=scales[0],
                          v_scale=scales[1], kv_layout=TensorLayout[layout],
                          row_valid=dp.segment("row_valid"))
                layer = [0]

                def call(fn, rotate=True):
                    off = (layer[0] % LAYERS_ROTATED) * pages
                    if rotate:
                        layer[0] += 1
                    return fn(q, kc, vc, kv_idx, plan, kv_indices_offset=off,
                              **kw)

                def plain(*args, **kw_):
                    return _paged_plain(torch, *args, **kw_)

                got = call(batch_paged_attention_run, rotate=False)
                want = call(plain, rotate=False)
                torch.cuda.synchronize()
                chk = _attn_check(torch, got, want)
                del got, want
                ms = cuda_ms(torch, lambda: call(batch_paged_attention_run),
                             20, graph=True)
                call_ms = cuda_ms(
                    torch, lambda: call(batch_paged_attention_run), 20)
                plain_ms = cuda_ms(torch, lambda: call(plain), 3, warmup=1)
                nbytes = _attention_bytes(plan, pages, kv_lens, m.tile_q, hkv,
                                          d, kc.element_size())
                ops = 4 * d * _attention_work(kv_lens, qo_lens, hq)
                b_ms, b_by = bound_ms(nbytes, ops)
                row = dict(mode=mode, d=d, layout=layout, kv=kv_dtype,
                           page_size=ps, q_shape=list(q.shape),
                           kv_tokens=int(kv_lens.sum()),
                           T=m.num_work_items, tile_q=m.tile_q,
                           splits=m.max_splits, err_o=chk["err_o"],
                           o_ratio=chk["o_ratio"], err_lse=chk["err_lse"],
                           same_inf=chk["same_inf"], ms=ms, call_ms=call_ms,
                           plain_ms=plain_ms, bound_bytes=nbytes,
                           bound_ops=ops, bound_ms=b_ms, bound_by=b_by,
                           ok=chk["ok"])
                rows.append(row)
                log(f"{label} {mode:12s} d={d} {layout} {kv_dtype:4s} "
                    f"q={list(q.shape)} kv_tokens={int(kv_lens.sum())} "
                    f"T={m.num_work_items} tile_q={m.tile_q} "
                    f"splits={m.max_splits} err_o={chk['err_o']:.2e} "
                    f"(limit ratio {chk['o_ratio']:.3f}) "
                    f"err_lse={chk['err_lse']:.2e} "
                    f"ms={ms:.4f} call_ms={call_ms:.4f} "
                    f"plain_ms={plain_ms:.3f} bound_ms={b_ms:.5f} ({b_by}) "
                    f"{'ok' if chk['ok'] else 'MISMATCH'}")
                del kc, vc, caches
        torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"{label} disagrees with its plain version: "
                             f"{bad}")
    return rows


# (name, batch, vocab, filter, out mode): the seq draw at both paths'
# shapes (the DeepSeek path draws for one row when one request emits), and
# the row-writing modes at the Llama shape
SAMPLER_CASES = (
    ("llama", 8, 128256, "top_k_top_p_seq", "sample"),
    ("deepseek", 8, 102400, "top_k_top_p_seq", "sample"),
    ("deepseek_one", 1, 102400, "top_k_top_p_seq", "sample"),
    ("mixtral", 8, 32000, "top_k_top_p_seq", "sample"),
    ("llama_renorm", 8, 128256, "top_k_top_p_seq", "renorm"),
    ("llama_mask", 8, 128256, "top_k", "mask_logits"),
    # the spec verify step (batch 8, 3 drafts): top-k renorm of its 32
    # target rows, top-p renorm of what that leaves, the chain's draw on the
    # rows the chain builds from those (``spec_draw_rows``)
    ("spec_renorm_k", 32, 128256, "top_k", "renorm"),
    ("spec_renorm_p", 32, 128256, "top_p", "renorm"),
    ("spec_draw", 8, 128256, "none", "sample"),
)


def spec_draw_rows(torch, target, num_spec):
    """The rows ``chain_speculative_sampling`` draws from in the verify
    step, for one-hot drafts on ``target`` [B, G + 1, V] (the renormed
    target rows): row b is rejected first at draft b % (G + 1), and G means
    every draft was accepted. A rejected draft is its row's most likely
    token, so the residual max(target - one-hot, 0) is the row with that
    entry at 0, unnormalised (the target row where that leaves nothing);
    an accepted row draws the bonus token from its last target row."""
    batch = target.shape[0]
    b = torch.arange(batch, device=target.device)
    first_rej = b % (num_spec + 1)
    rows = target[b, first_rej.clamp(max=num_spec - 1)]
    resid = rows.scatter(1, rows.argmax(-1, keepdim=True), 0.0)
    resid = torch.where(resid.sum(-1, keepdim=True) > 0, resid, rows)
    return torch.where((first_rej < num_spec)[:, None], resid,
                       target[:, num_spec])


def sampler_cases(torch):
    """The sampler check's inputs, one dict a case of ``SAMPLER_CASES``:
    probabilities (a softmax of 4 x randn logits) or, for mask_logits, the
    logits; top-k 40, top-p 0.9; the spec cases chained as the verify step
    runs them; with the case's byte bound (rows read and written once, k, p
    and tokens)."""
    from flashinfer_tpu_torch.ops.sampling import family_plain, softmax

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(3)
    prev = None
    for name, batch, vocab, filt, mode in SAMPLER_CASES:
        logits = torch.randn(batch, vocab, device=dev, generator=gen) * 4
        x = logits if mode == "mask_logits" else softmax(logits)
        k = torch.full((batch, 1), 40, dtype=torch.int32, device=dev)
        p = torch.full((batch, 1), 0.9, device=dev)
        if name == "spec_renorm_p":  # the top-k renorm's rows, as served
            x = family_plain(prev, 0, k, torch.ones_like(p), filt="top_k",
                             out_mode="renorm")
        if name == "spec_draw":  # the chain's rows on the top-p renorm's
            rk = torch.ones(prev.shape[0], 1, dtype=torch.int32, device=dev)
            target = family_plain(prev, 0, rk, torch.full_like(rk, 0.9,
                                                               dtype=p.dtype),
                                  filt="top_p", out_mode="renorm")
            x = spec_draw_rows(torch, target.view(batch, -1, vocab),
                               SPEC_TOKENS)
        prev = x
        nbytes = x.numel() * 4 * (1 if mode == "sample" else 2) + batch * 12
        b_ms, b_by = bound_ms(nbytes, 0)
        yield dict(name=name, batch=batch, vocab=vocab, filt=filt, mode=mode,
                   x=x, k=k, p=p, bound_ms=b_ms, bound_by=b_by)


def check_sampler(torch):
    """The sampler at the main paths' shapes (``SAMPLER_CASES``): draws at
    five seeds (the seed's 32 bits: -1 and 2**32 - 1 among them) held to
    the plain version's tokens, renorm to ``SAMPLER_RENORM_TOL``, masks
    exactly; each case's route, cluster size and bisection steps a pass
    (``sampler_route``) and what a launch did (``sampler_stats``: its
    cluster reductions, the bisection steps one warp took alone on the list
    the top-k search gathered, and that list's length, each the largest
    over the rows); the kernel's time in a CUDA graph and eager."""
    from flashinfer_tpu_torch.ops.sampling import (
        family_call,
        family_plain,
        sampler_route,
        sampler_stats,
    )

    out = []
    for case in sampler_cases(torch):
        x, k, p, filt, mode = (case[n] for n in ("x", "k", "p", "filt",
                                                 "mode"))
        batch, vocab = x.shape
        mismatches, err = 0, 0.0
        seeds = ((12345, 2**31 - 2, 7, -1, 2**32 - 1) if mode == "sample"
                 else (0,))
        for seed in seeds:
            got = family_call(x, seed, k, p, filt=filt, out_mode=mode)
            want = family_plain(x, seed, k, p, filt=filt, out_mode=mode)
            if mode == "renorm":
                err = max(err, float((got - want).abs().max()))
            else:
                mismatches += int((got != want).sum())
            if mode == "sample":
                log(f"sampler {case['name']} seed={seed} kernel="
                    f"{got.tolist()} plain={want.tolist()}")

        def run(fn):
            return lambda: fn(x, 12345, k, p, filt=filt, out_mode=mode)

        ms = cuda_ms(torch, run(family_call), 20, graph=True)
        call_ms = cuda_ms(torch, run(family_call), 20)
        plain_ms = cuda_ms(torch, run(family_plain), 3, warmup=1)
        route = sampler_route(vocab)
        st = sampler_stats(x, k, p, filt=filt, out_mode=mode)
        route.update(cluster_passes=int(st[:, 0].max()),
                     warp_steps=int(st[:, 1].max()),
                     gathered=int(st[:, 2].max()))
        ok = mismatches == 0 and err <= SAMPLER_RENORM_TOL
        log(f"sampler_family {case['name']} batch={batch} vocab={vocab} "
            f"{filt} {mode} route={route['route']} C={route['cluster']} "
            f"s={route['levels']} threads={route['threads']} "
            f"gathered={route['gathered']} max_active_clusters="
            f"{route['max_active_clusters']} token_mismatches={mismatches} "
            f"renorm_err={err:.2e} ms={ms:.4f} call_ms={call_ms:.4f} "
            f"plain_ms={plain_ms:.3f} bound_ms={case['bound_ms']:.5f} "
            f"({case['bound_by']}); held by {route['cluster_passes']} cluster "
            f"reductions and {route['warp_steps']} single-warp steps "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"sampler kernel disagrees with its plain "
                                 f"version at {case['name']}")
        out.append(dict(case=case["name"], batch=batch, vocab=vocab,
                        filt=filt, mode=mode, err=err, mismatches=mismatches,
                        ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                        bound_ms=case["bound_ms"], bound_by=case["bound_by"],
                        **route))
    return out


def check_rmsnorm(torch, shapes=((8, 4096, 1e-5), (4096, 4096, 1e-5),
                                 (8, 2048, 1e-6))):
    """RMSNorm at the main paths' shapes (rows, hidden, eps): Llama-3-8B
    decode and prefill rows, DeepSeek-V2-Lite decode rows; both modes,
    weight_bias 0 and 1. The fused residual must equal the plain version's
    bits, out must hold NORM_TOL. Times (one CUDA graph, and eager for
    ``call_ms``): the plain and the fused launch, the empty kernel of the
    same layout, the add + norm pair the serving steps ran before the fused
    form, ``F.rms_norm`` (the library call of the plain mode) and, for the
    fused mode, which no one PyTorch call computes, ``x + r`` then
    ``F.rms_norm``."""
    import torch.nn.functional as F

    from flashinfer_tpu_torch.ops.norm import (
        fused_add_rmsnorm,
        fused_add_rmsnorm_plain,
        rmsnorm,
        rmsnorm_empty,
        rmsnorm_plain,
    )

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(5)
    out = []
    for rows, hidden, eps in shapes:
        def randn(*shape):
            return torch.randn(*shape, device=dev, generator=gen,
                               dtype=torch.bfloat16)

        x, r = randn(rows, hidden), randn(rows, hidden)
        w = (1 + 0.1 * randn(hidden).float()).to(torch.bfloat16)
        err, bad = 0.0, []
        for bias in (0.0, 1.0):
            got = rmsnorm(x, w, eps, weight_bias=bias)
            want = rmsnorm_plain(x, w, eps, weight_bias=bias)
            (f_got, f_res), (f_want, f_res_want) = (
                fn(x, r, w, eps, weight_bias=bias)
                for fn in (fused_add_rmsnorm, fused_add_rmsnorm_plain))
            for mode, g, wt in (("plain", got, want),
                                ("fused", f_got, f_want)):
                diff = (g.float() - wt.float()).abs()
                err = max(err, float(diff.max()))
                if not bool((diff <= NORM_TOL * wt.float().abs()
                             + 1e-6).all()):
                    bad.append(f"{mode} out at weight_bias {bias}")
            if not torch.equal(f_res, f_res_want):
                bad.append(f"fused residual at weight_bias {bias}")
        t = dict(
            ms=lambda: rmsnorm(x, w, eps),
            fused_ms=lambda: fused_add_rmsnorm(x, r, w, eps),
            empty_ms=lambda: rmsnorm_empty(x, w),
            pair_ms=lambda: rmsnorm(r + x, w, eps),
            library_ms=lambda: F.rms_norm(x, (hidden,), w, eps),
            library_pair_ms=lambda: F.rms_norm(r + x, (hidden,), w, eps))
        row = {k: cuda_ms(torch, fn, 50, graph=True) for k, fn in t.items()}
        row.update(
            call_ms=cuda_ms(torch, t["ms"], 50),
            fused_call_ms=cuda_ms(torch, t["fused_ms"], 50),
            plain_ms=cuda_ms(torch, lambda: rmsnorm_plain(x, w, eps), 20),
            fused_plain_ms=cuda_ms(
                torch, lambda: fused_add_rmsnorm_plain(x, r, w, eps), 20))
        # x (and r) read, out (and r') written, w read; 4 (5) operations a
        # value: square, sum, scale, weight (and the add)
        n = x.numel()
        b_ms, b_by = bound_ms(2 * n * 2 + hidden * 2, 4 * n)
        fb_ms, fb_by = bound_ms(4 * n * 2 + hidden * 2, 5 * n)
        log(f"rmsnorm rows={rows} hidden={hidden} "
            f"err={err:.2e} ms={row['ms']:.5f} fused_ms="
            f"{row['fused_ms']:.5f} empty_ms={row['empty_ms']:.5f} "
            f"pair_ms={row['pair_ms']:.5f} call_ms={row['call_ms']:.5f} "
            f"fused_call_ms={row['fused_call_ms']:.5f} plain_ms="
            f"{row['plain_ms']:.4f} fused_plain_ms={row['fused_plain_ms']:.4f}"
            f" library_ms={row['library_ms']:.5f} library_pair_ms="
            f"{row['library_pair_ms']:.5f} bound_ms={b_ms:.7f} ({b_by}) "
            f"fused_bound_ms={fb_ms:.7f} ({fb_by}) "
            f"{'MISMATCH ' + str(bad) if bad else 'ok'}")
        if bad:
            raise AssertionError(f"rmsnorm kernel disagrees with its plain "
                                 f"version at [{rows}, {hidden}]: {bad}")
        out.append(dict(rows=rows, hidden=hidden, err=err,
                        bound_ms=b_ms, bound_by=b_by, fused_bound_ms=fb_ms,
                        fused_bound_by=fb_by, **row))
    return out


def _mla_plan(np, qo_lens, kv_lens, causal, chunk, page_rng, tile_q=None):
    """An MLA plan at V2-Lite heads, page 16, with a page table drawn from
    ``page_rng`` (tile_q None: the wrapper's choice). Returns (wrapper,
    pages)."""
    from flashinfer_tpu_torch.ops.attention.mla import (
        BatchMLAPagedAttentionWrapper,
    )

    c = V2_LITE
    npages = -(-np.asarray(kv_lens) // MLA_PAGE)
    indptr = np.concatenate([[0], np.cumsum(npages)])
    pages = int(indptr[-1])
    indices = page_rng.permutation(pages)
    w = BatchMLAPagedAttentionWrapper(device=DEVICE, tile_q=tile_q)
    w.plan(np.concatenate([[0], np.cumsum(qo_lens)]), indptr, indices,
           np.asarray(kv_lens), c["num_heads"], c["head_dim_ckv"],
           c["head_dim_kpe"], MLA_PAGE, causal=causal, kv_chunk_size=chunk,
           sm_scale=(c["head_dim_qk_nope"] + c["head_dim_kpe"]) ** -0.5)
    return w, pages


def _mla_bytes(plan, kv_lens, tile_q, d_ckv, d_kpe, kv_itemsize, pages):
    """Bytes the MLA work list must move: the ckv and kpe of every key once,
    the q tiles and partial outputs of the items that have keys, the plan
    and the page-table entries in use."""
    p = plan.reshape(12, -1).cpu().numpy()
    real = (p[0] >= 0) & (p[6] > p[5])
    q_tiles = len(set(p[3][real].tolist()))
    kv = int(sum(kv_lens)) * (d_ckv + d_kpe) * kv_itemsize
    q = q_tiles * tile_q * (d_ckv + d_kpe) * 2
    out = int(real.sum()) * tile_q * (d_ckv * 2 + 4)
    return kv + q + out + p.size * 4 + pages * 4


def mla_cases(torch, np):
    """The MLA check's inputs, one dict a (shape, cache type), at
    DeepSeek-V2-Lite shapes (16 heads, ckv 512, kpe 64, page 16): decode of
    8 requests of 512-4096 keys (KV chunk 256, so split-KV partials merge)
    and causal prefill of 8 prompts of 64-512 tokens (KV chunk 512; tile_q
    128, the wrapper's choice, and again at tile_q 64), each on bf16, e4m3
    and linear int8 caches over ``LAYERS_ROTATED`` layers; and the decode
    the DeepSeek path serves (``deepseek_serve``): 8 requests of 33-160
    keys, KV chunk 64, bf16 caches. ``call(fn, rotate=True)`` runs ``fn``
    (the kernel's wrapper or its plain version) on the case, on the next
    layer's caches when ``rotate``; each case has its byte and operation
    bound."""
    c = V2_LITE
    d_ckv, d_kpe, heads = c["head_dim_ckv"], c["head_dim_kpe"], c["num_heads"]
    rng = np.random.default_rng(4)
    kv_dec = rng.integers(512, 4097, 8)
    qo_pre = rng.integers(64, 513, 8)
    served_rng = np.random.default_rng(14)
    kv_served = served_rng.integers(33, 161, 8)
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(9)
    ones, all_kv = np.ones(8, np.int64), ("bf16", "e4m3", "int8")
    for mode, qo, kv, causal, chunk, page_rng, kv_dtypes, tile_q in (
            ("decode", ones, kv_dec, False, 256, rng, all_kv, None),
            ("prefill", qo_pre, qo_pre, True, 512, rng, all_kv, None),
            ("served", ones, kv_served, False, 64, served_rng, ("bf16",),
             None),
            ("prefill64", qo_pre, qo_pre, True, 512,
             np.random.default_rng(4), all_kv, 64)):
        w, pages = _mla_plan(np, qo, kv, causal, chunk, page_rng, tile_q)
        dp = w.device_plan
        m = dp.meta
        q_ckv = torch.randn(m.bucket_rows, d_ckv, device=dev, generator=gen,
                            dtype=torch.bfloat16)
        q_pe = torch.randn(m.bucket_rows, d_kpe, device=dev, generator=gen,
                           dtype=torch.bfloat16)
        plan, kv_idx = dp.segment("plan"), dp.segment("kv_indices")
        for kv_dtype in kv_dtypes:
            caches = []
            for d in (d_ckv, d_kpe):
                x = torch.randn(LAYERS_ROTATED, pages, MLA_PAGE, d,
                                device=dev, generator=gen,
                                dtype=torch.bfloat16)
                if kv_dtype == "int8":
                    x = (x * 25).round().clamp(-127, 127).to(torch.int8)
                elif kv_dtype == "e4m3":
                    x = (x * 4).to(torch.float8_e4m3fn)
                caches.append(x)
            ckv, kpe = caches
            deq = {"bf16": 1.0, "int8": 0.04, "e4m3": 0.25}[kv_dtype]
            kw = dict(tile_q=m.tile_q, group=m.gqa_group, causal=m.causal,
                      sm_scale=m.sm_scale * deq, v_scale=deq)
            layer = [0]

            def call(fn, rotate=True, ckv=ckv, kpe=kpe, kw=kw, layer=layer):
                li = layer[0] % LAYERS_ROTATED
                if rotate:
                    layer[0] += 1
                return fn(q_ckv, q_pe, ckv[li], kpe[li], kv_idx, plan, **kw)

            nbytes = _mla_bytes(plan, kv, m.tile_q, d_ckv, d_kpe,
                                ckv.element_size(), pages)
            # QK over ckv + kpe and P.V over ckv, 2 operations a product
            ops = 2 * (2 * d_ckv + d_kpe) * _attention_work(kv, qo, heads)
            kind = {"bf16": "bf16", "e4m3": "fp8", "int8": "int8"}[kv_dtype]
            b_ms, b_by = bound_ms(nbytes, ops, kind)
            yield dict(mode=mode, kv=kv_dtype, meta=m, call=call,
                       q_dtype=q_ckv.dtype, kv_dtype=ckv.dtype,
                       on_card=q_ckv.is_cuda,
                       kv_tokens=int(kv.sum()),
                       iters=5 if mode.startswith("prefill") else 20,
                       bound_bytes=nbytes, bound_ops=ops, bound_ms=b_ms,
                       bound_by=b_by)
            del ckv, kpe, caches, call


def check_mla(torch, np):
    """The MLA kernel on each of ``mla_cases``, held against its plain
    version and timed beside it; each row names the route the C entry
    took."""
    from flashinfer_tpu_torch.ops.attention.mla import (
        mla_paged_plain,
        mla_paged_run,
        mla_route,
    )

    c = V2_LITE
    rows = []
    for case in mla_cases(torch, np):
        m, call = case["meta"], case["call"]
        chk = _attn_check(torch, call(mla_paged_run, rotate=False),
                          call(mla_paged_plain, rotate=False))
        ms = cuda_ms(torch, lambda: call(mla_paged_run), case["iters"],
                     graph=True)
        plain_ms = cuda_ms(torch, lambda: call(mla_paged_plain), 3,
                           warmup=1)
        route = (mla_route(case["q_dtype"], case["kv_dtype"], m.tile_q,
                           c["head_dim_ckv"], c["head_dim_kpe"], MLA_PAGE)
                 if case["on_card"] else "plain")
        row = dict(mode=case["mode"], kv=case["kv"], route=route,
                   q_rows=m.bucket_rows, kv_tokens=case["kv_tokens"],
                   T=m.num_work_items, tile_q=m.tile_q, splits=m.max_splits,
                   err_o=chk["err_o"], o_ratio=chk["o_ratio"],
                   err_lse=chk["err_lse"], ms=ms, plain_ms=plain_ms,
                   **{k: case[k] for k in ("bound_bytes", "bound_ops",
                                           "bound_ms", "bound_by")},
                   ok=chk["ok"])
        rows.append(row)
        log(f"mla_attention {row['mode']:9s} {row['kv']:4s} route={route} "
            f"q_rows={m.bucket_rows} kv_tokens={row['kv_tokens']} "
            f"T={m.num_work_items} tile_q={m.tile_q} splits={m.max_splits} "
            f"err_o={chk['err_o']:.2e} (limit ratio {chk['o_ratio']:.3f}) "
            f"err_lse={chk['err_lse']:.2e} ms={ms:.4f} "
            f"plain_ms={plain_ms:.3f} bound_ms={row['bound_ms']:.5f} "
            f"({row['bound_by']}) {'ok' if chk['ok'] else 'MISMATCH'}")
        del case, call
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"MLA kernel disagrees with its plain version: "
                             f"{bad}")
    return rows


def _library_grouped_mm(torch, x_sorted, w_nk, group_sizes):
    """One PyTorch call that computes the same grouped product on the
    unpadded sorted rows (bf16 only): torch._grouped_mm with offsets, or
    None where this PyTorch has no such call."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None
    offs = torch.cumsum(group_sizes, 0).to(torch.int32)
    w_kn = w_nk.transpose(1, 2)  # [E, K, N], column-major as it wants
    return lambda: fn(x_sorted, w_kn, offs=offs)


def check_grouped_gemm(torch, np):
    """Both MoE GEMMs (gate/up with bf16 output, down with f32 output) on
    bf16 and e4m3 weights in the models' [E, N, K] layout, at four
    routings: V2-Lite decode (8 tokens, top-6 of 64 experts, 2048 -> 2816
    and 1408 -> 2048), a 2048-token V2-Lite prefill, the JAX bench's
    Mixtral-8x7B layer (4096 tokens, top-2 of 8, 4096 <-> 14336) and
    Mixtral's decode (8 tokens of it)."""
    from flashinfer_tpu_torch.ops.fused_moe import (
        RoutingMethodType,
        _permute_by_expert,
        route_tokens,
        select_moe_tm,
    )
    from flashinfer_tpu_torch.ops.gemm_grouped import (
        grouped_gemm_padded,
        grouped_gemm_padded_plain,
        make_group_layout,
    )

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(11)
    rows = []
    for name, m, e, top_k, hidden, inter in GG_CASES:
        logits = torch.randn(m, e, device=dev, generator=gen)
        if name.startswith("v2lite"):
            ids, _ = route_tokens(logits, top_k, RoutingMethodType.DeepSeekV3,
                                  n_group=1, topk_group=1)
        else:
            ids, _ = route_tokens(logits, top_k, RoutingMethodType.Renormalize)
        order, group_sizes = _permute_by_expert(ids, e)
        tm = select_moe_tm(m * top_k, e)
        lay = make_group_layout(group_sizes, m * top_k, tm)
        used = lay.expert_of_tile >= 0
        used_rows = int(used.sum()) * tm
        n_experts = int((group_sizes > 0).sum())
        for gemm, k, n, out_dt in (("gemm1", hidden, 2 * inter,
                                    torch.bfloat16),
                                   ("gemm2", inter, hidden, torch.float32)):
            x = torch.randn(lay.m_pad, k, device=dev, generator=gen,
                            dtype=torch.bfloat16)
            x = torch.where(lay.src_valid[:, None], x, 0)
            x_sorted = x[lay.padded_pos]
            for wdt in ("bf16", "e4m3"):
                w = torch.randn(e, n, k, device=dev, generator=gen,
                                dtype=torch.bfloat16).mul_(k ** -0.5)
                scales = None
                if wdt == "e4m3":
                    w = (w * 64).to(torch.float8_e4m3fn)
                    scales = torch.full((e,), 1 / 64, device=dev)

                def run(f):
                    return f(x, w, lay.expert_of_tile, scales,
                             out_dtype=out_dt, rhs_nk=True)

                got = run(grouped_gemm_padded)
                want = run(grouped_gemm_padded_plain)
                torch.cuda.synchronize()
                otype = "bf16" if out_dt == torch.bfloat16 else "f32"
                diff = (got.float() - want.float()).abs()
                rms = float(want.float().pow(2).mean().sqrt())
                limit = GG_RTOL[otype] * want.float().abs() + GG_ATOL_RMS * rms
                ratio = float((diff / limit).max())
                pad_zero = not bool(got[~lay.src_valid].any())
                big = m >= 2048
                ms = cuda_ms(torch, lambda: run(grouped_gemm_padded),
                             5 if big else 20, warmup=1 if big else 2,
                             graph=True)
                plain_ms = cuda_ms(torch, lambda: run(
                    grouped_gemm_padded_plain), 2, warmup=1)
                lib_ms = None
                lib = (_library_grouped_mm(torch, x_sorted, w, group_sizes)
                       if wdt == "bf16" else None)
                if lib is not None:
                    try:  # an eager call first: a refusal must not happen
                        lib()  # inside a graph capture
                        torch.cuda.synchronize()
                    except (RuntimeError, TypeError) as err:
                        log(f"  torch._grouped_mm refused: {err}"[:300])
                        lib = None
                if lib is not None:
                    lib_ms = cuda_ms(torch, lib, 5 if big else 20,
                                     graph=True)
                nbytes = (used_rows * k * 2
                          + n_experts * k * n * w.element_size()
                          + lay.m_pad * n * got.element_size())
                ops = 2 * m * top_k * k * n
                b_ms, b_by = bound_ms(nbytes, ops, "bf16")
                ok = ratio <= 1.0 and pad_zero
                row = dict(case=name, gemm=gemm, w=wdt, out=otype, tm=tm,
                           m_pad=lay.m_pad, rows=m * top_k, K=k, N=n,
                           experts_used=n_experts, err=float(diff.max()),
                           limit_ratio=ratio, pad_zero=pad_zero, ms=ms,
                           plain_ms=plain_ms, library_ms=lib_ms,
                           bound_bytes=nbytes, bound_ops=ops, bound_ms=b_ms,
                           bound_by=b_by, ok=ok)
                rows.append(row)
                log(f"grouped_gemm {name:14s} {gemm} w={wdt:4s} out={otype} "
                    f"tm={tm} m_pad={lay.m_pad} rows={m * top_k} K={k} N={n} "
                    f"experts={n_experts} err={row['err']:.2e} (limit ratio "
                    f"{ratio:.3f}) pad_zero={pad_zero} ms={ms:.4f} plain_ms="
                    f"{plain_ms:.3f} library_ms={lib_ms} bound_ms={b_ms:.5f} "
                    f"({b_by}) {'ok' if ok else 'MISMATCH'}")
                del w, got, want, diff, limit
            del x, x_sorted
        torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"grouped GEMM kernel disagrees with its plain "
                             f"version: {bad}")
    return rows



# Llama-3-8B's five matmul weight shapes (K -> N): fused QKV, o, gate/up,
# down, lm_head; and the row counts of a decode step (8 slots), a verify
# step (8 x 4 rows) and a prefill
W8_SHAPES = (("qkv", 4096, 6144), ("o", 4096, 4096),
             ("gate_up", 4096, 28672), ("down", 14336, 4096),
             ("lm_head", 4096, 128256))
W8_ROWS = (8, 32, 4096)
L2_BYTES = 50 * 2 ** 20


def _rotated(t):
    """``t`` and enough copies of it that a loop over them reads past the
    50 MB L2 three times over, as a step over 32 layers does."""
    nbytes = t.numel() * t.element_size()
    return [t] + [t.clone() for _ in range(-(-3 * L2_BYTES // nbytes) - 1)]


def check_w8_matmul(torch, np):
    """The grouped GEMM as ``w8_matmul`` (the engine's ``_wmm`` on 8-bit
    weights) at Llama-3-8B's five weight shapes, 8 / 32 / 4096 rows, e4m3
    and int8 weights quantized per output column from a seeded bf16
    weight, against its plain version (JAX's ``_wmm`` arithmetic). Times,
    in CUDA graphs over copies of the weight that exceed L2: the kernel;
    the plain version (eager); the route not taken, a cast of the weight
    to bf16 and ``torch.matmul`` and the scale (a different function: the
    cast keeps e4m3 denormals); bf16 ``torch.matmul`` on a bf16 weight of
    the same shape (a different function). No one PyTorch call computes
    the same function (``torch._weight_int8pack_mm`` takes its column
    scales in bf16), so ``library_ms`` is None."""
    from flashinfer_tpu_torch.models.llama import _quantize_weight
    from flashinfer_tpu_torch.ops.gemm_grouped import (
        w8_matmul,
        w8_matmul_plain,
        w8_tm,
    )

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(12)
    rows_out = []
    for name, k, n in W8_SHAPES:
        w_bf16 = (torch.randn(k, n, device=dev, generator=gen)
                  * k ** -0.5).bfloat16()
        bf16_copies = _rotated(w_bf16)
        for container in ("e4m3", "int8"):
            q, s = _quantize_weight(w_bf16[None], container == "int8")
            q, s = q[0], s[0]
            copies = _rotated(q)
            for m in W8_ROWS:
                x = torch.randn(m, k, device=dev, generator=gen).bfloat16()
                got = w8_matmul(x, q, s)
                want = w8_matmul_plain(x, q, s)
                torch.cuda.synchronize()
                diff = (got.float() - want.float()).abs()
                rms = float(want.float().pow(2).mean().sqrt())
                limit = (GG_RTOL["bf16"] * want.float().abs()
                         + GG_ATOL_RMS * rms)
                ratio = float((diff / limit).max())
                finite = bool(torch.isfinite(got).all())
                big = m >= 4096
                it = 4 if big else 20
                cyc = itertools.cycle(copies)
                ms = cuda_ms(torch, lambda: w8_matmul(x, next(cyc), s), it,
                             warmup=1, graph=True)
                plain_ms = cuda_ms(torch, lambda: w8_matmul_plain(x, q, s),
                                   2, warmup=1)
                cyc_c = itertools.cycle(copies)
                cast_ms = cuda_ms(
                    torch, lambda: ((x @ next(cyc_c).to(torch.bfloat16))
                                    .float() * s).bfloat16(), it, warmup=1,
                    graph=True)
                cyc_b = itertools.cycle(bf16_copies)
                bf16_ms = cuda_ms(torch, lambda: x @ next(cyc_b), it,
                                  warmup=1, graph=True)
                nbytes = m * k * 2 + k * n + n * 4 + m * n * 2
                ops = 2 * m * k * n
                b_ms, b_by = bound_ms(nbytes, ops, "bf16")
                ok = ratio <= 1.0 and finite
                row = dict(shape=name, K=k, N=n, rows=m, w=container,
                           tm=w8_tm(m), err=float(diff.max()),
                           limit_ratio=ratio, ms=ms, plain_ms=plain_ms,
                           cast_matmul_ms=cast_ms, bf16_matmul_ms=bf16_ms,
                           library_ms=None, bound_bytes=nbytes,
                           bound_ops=ops, bound_ms=b_ms, bound_by=b_by,
                           bound_share=b_ms / ms, ok=ok)
                rows_out.append(row)
                log(f"w8_matmul {name:8s} {k}->{n} rows={m:<4d} "
                    f"w={container} tm={w8_tm(m)} err={row['err']:.2e} "
                    f"(limit ratio {ratio:.3f}) ms={ms:.5f} bound_ms="
                    f"{b_ms:.5f} ({b_by}, share {b_ms / ms:.3f}) plain_ms="
                    f"{plain_ms:.3f} cast+matmul_ms={cast_ms:.5f} "
                    f"bf16_matmul_ms={bf16_ms:.5f} "
                    f"{'ok' if ok else 'MISMATCH'}")
                del x, got, want, diff, limit
            del q, s, copies
        del w_bf16, bf16_copies
        torch.cuda.empty_cache()
    bad = [r for r in rows_out if not r["ok"]]
    if bad:
        raise AssertionError(f"w8_matmul disagrees with its plain version: "
                             f"{bad}")
    return rows_out

# Llama-3-8B attention widths: q heads, kv heads, head dim
LLAMA_HEADS = (32, 8, 128)
# flash kernel check cases: (name, qo_len, kv_len, hq, hkv, d, dv, dtype,
# causal, variant); the variants run at Llama widths on 2048 tokens
FLASH_CASES = (
    ("llama_prefill", 8192, 8192, 32, 8, 128, 128, "bf16", True, None),
    ("chunked_prefill", 2048, 8192, 32, 8, 128, 128, "bf16", True, None),
    ("decode", 1, 32768, 32, 8, 128, 128, "bf16", False, None),
    # DeepSeek-V2-Lite's MHA prefill: qk 128 + 64 rope, v 128, 16 heads
    ("v2lite_mha_prefill", 4096, 4096, 16, 16, 192, 128, "bf16", True,
     None),
    ("soft_cap_50", 2048, 2048, 32, 8, 128, 128, "bf16", True, "soft_cap"),
    ("window_1024", 2048, 2048, 32, 8, 128, 128, "bf16", True, "window"),
    ("alibi", 2048, 2048, 32, 8, 128, 128, "bf16", True, "alibi"),
    ("sinks", 2048, 2048, 32, 8, 128, 128, "bf16", True, "sink"),
    ("sigmoid", 2048, 2048, 32, 8, 128, 128, "bf16", True, "sigmoid"),
    ("custom_mask", 2048, 2048, 32, 8, 128, 128, "bf16", True, "mask"),
    ("hnd", 2048, 2048, 32, 8, 128, 128, "bf16", True, "hnd"),
    ("small_f32", 100, 300, 8, 2, 64, 64, "f32", True, None),
)


def _flash_pairs(np, qo, kv, causal, window=-1):
    """(query, key) pairs the mask keeps: query i at kv - qo + i."""
    q_pos = kv - qo + np.arange(qo)
    hi = np.minimum(q_pos, kv - 1) if causal else np.full(qo, kv - 1)
    lo = np.maximum(q_pos - window, 0) if window >= 0 else np.zeros(qo)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def _flash_case(torch, np, qo, kv, hq, hkv, d, dv, dtype, causal, variant,
                gen):
    """(kernel call, plain call, library call or None, extra bytes, kept
    pairs, the inputs) of one check case; the kernel and plain calls
    return (o, lse), the library call (SDPA) o [1, hq, qo, dv]."""
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from flashinfer_tpu_torch.ops.attention.kernels.flash import (
        flash_attention_dense,
        flash_attention_plain,
    )
    from flashinfer_tpu_torch.ops.attention.single import (
        default_alibi_slopes,
        single_prefill_with_kv_cache,
    )
    from flashinfer_tpu_torch.ops.attention.variants import (
        FlashSigmoid,
        make_default_variant,
    )
    from flashinfer_tpu_torch.ops.quantization import unpackbits

    dev = torch.device(DEVICE)
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    q = torch.randn(qo, hq, d, device=dev, generator=gen, dtype=dt)
    k = torch.randn(kv, hkv, d, device=dev, generator=gen, dtype=dt)
    v = torch.randn(kv, hkv, dv, device=dev, generator=gen, dtype=dt)
    kw = dict(causal=causal, sm_scale=d ** -0.5)
    single_kw = {}
    extra, window = 0, -1
    pairs = None
    # The variants keep each row's P.V sum unit-size, from weights spread
    # over many keys: the ATTN limit's absolute term is one bf16 step of
    # such a sum, and one bf16 rounding flip of a weight near 1 moves o by
    # as much (PERF.md, "the variant checks' inputs").
    if variant == "soft_cap":
        # one large component shared by every key: the logits sit far past
        # the cap (|x| up to ~70), their spread along a row stays ~1
        k = (k.float() + 24 * torch.randn(1, hkv, d, device=dev,
                                          generator=gen)).to(dt)
        kw["variant"] = make_default_variant(logits_soft_cap=50.0)
    elif variant == "window":
        kw["window_left"] = window = 1024
    elif variant == "alibi":  # the kernel call goes through single.py
        single_kw["pos_encoding_mode"] = "ALIBI"
        kw["variant"] = make_default_variant(use_alibi=True)
        kw["variant_params"] = {"alibi_slopes": default_alibi_slopes(hq,
                                                                     dev)}
        extra = hq * 4
    elif variant == "sink":
        kw["sink"] = torch.randn(hq, device=dev, generator=gen) * 4
        extra = hq * 4
    elif variant == "sigmoid":  # sigmoid attention's bias -log(n)
        kw["variant"] = FlashSigmoid(1.0, -math.log(kv))
    elif variant == "mask":
        bits = torch.randint(0, 256, (-(-qo * kv // 8),), device=dev,
                             generator=gen, dtype=torch.int32)
        kw["custom_mask"] = bits.to(torch.uint8)
        extra = kw["custom_mask"].numel()
        keep = unpackbits(kw["custom_mask"], qo * kv).reshape(qo, kv)
        q_pos = kv - qo + torch.arange(qo, device=dev)
        keep &= torch.arange(kv, device=dev)[None, :] <= q_pos[:, None]
        pairs = int(keep.sum())
    elif variant == "hnd":  # [hkv, kv, d] caches, read in place
        k = k.transpose(0, 1).contiguous().transpose(0, 1)
        v = v.transpose(0, 1).contiguous().transpose(0, 1)
        single_kw["kv_layout"] = "HND"
    if pairs is None:
        pairs = _flash_pairs(np, qo, kv, causal, window)

    if single_kw:
        k_in = k.transpose(0, 1) if variant == "hnd" else k
        v_in = v.transpose(0, 1) if variant == "hnd" else v
        skw = {x: y for x, y in kw.items() if x not in ("variant",
                                                         "variant_params")}

        def kernel():
            return single_prefill_with_kv_cache(q, k_in, v_in,
                                                return_lse=True,
                                                **single_kw, **skw)
    else:
        def kernel():
            return flash_attention_dense(q, k, v, **kw)

    def plain():
        return flash_attention_plain(q, k, v, **kw)

    lib = None
    qt, kt, vt = (x.transpose(0, 1)[None] for x in (q, k, v))
    if variant in (None, "hnd"):  # an HND cache's [1, hkv, kv, d] in place
        # the queries sit at the tail of the keys: SDPA's lower-right causal
        # bias (is_causal aligns top-left; the two agree when qo == kv)
        mask = causal_lower_right(qo, kv) if causal else None

        def lib():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=kw["sm_scale"],
                enable_gqa=hkv != hq)
    elif variant in ("window", "mask", "alibi"):
        # the mask as a boolean attn_mask, ALiBi as an additive bias in q's
        # dtype (SDPA takes no other); K/V heads repeated for the group
        # beforehand, since SDPA's kernels that take a mask take no GQA
        q_pos = kv - qo + torch.arange(qo, device=dev)[:, None]
        kv_pos = torch.arange(kv, device=dev)[None, :]
        keep = kv_pos <= q_pos if causal else torch.ones(
            qo, kv, dtype=torch.bool, device=dev)
        if variant == "window":
            keep = keep & (kv_pos >= q_pos - window)
        elif variant == "mask":
            keep = keep & unpackbits(kw["custom_mask"], qo * kv).reshape(
                qo, kv)
        mask = keep
        if variant == "alibi":
            slopes = kw["variant_params"]["alibi_slopes"]
            bias = slopes[:, None, None] * (kv_pos - q_pos).float()
            mask = torch.where(keep, bias, float("-inf")).to(dt)[None]
            del bias
        kt, vt = (x.repeat_interleave(hq // hkv, dim=1) for x in (kt, vt))

        def lib():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=kw["sm_scale"])
    return kernel, plain, lib, extra, pairs, (q, k, v, kw)


def _time_library(torch, lib, want, big):
    """(ms, o_ratio) of SDPA: its time in a CUDA graph and its largest
    error against the plain version's (o, lse) over the ATTN limit, which
    shows that it computes the same function; (None, None) if it refuses
    the case. Past the limit, the worst element is logged with its row's
    plain lse (-inf: the row sees no key)."""
    try:  # an eager call first: a refusal must not happen inside a capture
        o = lib()[0].transpose(0, 1).float()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError) as err:
        log(f"  scaled_dot_product_attention refused: {err}"[:300])
        return None, None
    ref = want[0].float()
    ratios = (o - ref).abs() / (ATTN_RTOL_O * ref.abs() + ATTN_ATOL_O)
    ratio = float(ratios.max())
    if ratio > 1:
        t, h, c = (int(i) for i in torch.unravel_index(ratios.argmax(),
                                                       ratios.shape))
        log(f"  SDPA departs from the plain version most at [{t}, {h}, {c}]:"
            f" SDPA {float(o[t, h, c]):.5f}, plain {float(ref[t, h, c]):.5f};"
            f" the row's plain lse {float(want[1][t, h]):.4f}")
    del o, ratios
    return cuda_ms(torch, lib, 5 if big else 20, warmup=1 if big else 2,
                   graph=True), ratio


def _kernel_weights(torch, q, k, kw, t, head):
    """The bf16 weights the kernel gives query t of ``head`` over the keys it
    sees, read back through the kernel itself: the one query over the keys
    up to its position, with a one-hot V (key j*dv + c has 1 in column c,
    all other keys 0), so each output column is one key's rounded weight,
    exactly."""
    from flashinfer_tpu_torch.ops.attention.kernels.flash import (
        flash_attention_dense,
    )

    qo, kv = q.shape[0], k.shape[0]
    n = kv - qo + t + 1 if kw.get("causal") else kv
    hkv, dv = k.shape[1], k.shape[2]
    eye = torch.eye(dv, dtype=k.dtype, device=k.device)
    out = []
    for j0 in range(0, n, dv):
        vj = torch.zeros(n, hkv, dv, dtype=k.dtype, device=k.device)
        m = min(dv, n - j0)
        vj[j0:j0 + m] = eye[:m, None, :]
        o, _ = flash_attention_dense(q[t:t + 1], k[:n], vj, **kw)
        out.append(o[0, head, :m])
    return torch.cat(out)


def _sigmoid_witness(torch, np, inputs, got, want):
    """The sigmoid case against a float64 evaluation of its function
    (logits and weights in f64, the weights rounded to v's dtype as the
    function rounds P, P.V in f64): the kernel's and the plain version's
    largest error over the ATTN limit; and, at the element where the
    kernel and the plain version differ most, their errors against f64,
    how many of that row's bf16 weights the kernel (read back by
    ``_kernel_weights``) and the plain version round otherwise than f64,
    and how far those flips alone move that element."""
    q, k, v, kw = inputs
    scale, bias = kw["variant"].kernel.sigmoid
    qo, hq, _ = q.shape
    kv, hkv, dv = v.shape
    group = hq // hkv
    dev = q.device
    keep = torch.ones(qo, kv, dtype=torch.bool, device=dev)
    if kw.get("causal"):
        q_pos = kv - qo + torch.arange(qo, device=dev)
        keep = torch.arange(kv, device=dev)[None, :] <= q_pos[:, None]
    (o, _), (plain_o, _) = got, want
    lim = ATTN_RTOL_O * plain_o.float().abs() + ATTN_ATOL_O
    worst = int(((o.float() - plain_o.float()).abs() / lim).argmax())
    t, hw, c = (int(x) for x in np.unravel_index(worst, tuple(o.shape)))

    def weights(h, dt):  # [group, qo, kv], rounded to v's dtype
        hs = slice(h * group, (h + 1) * group)
        s = torch.einsum("qgd,kd->gqk", q[:, hs].to(dt), k[:, h].to(dt))
        s = s * kw["sm_scale"]
        w = torch.reciprocal(1.0 + torch.exp(-(s * scale + bias)))
        return torch.where(keep[None], w, 0.0).to(v.dtype)

    ref = torch.empty(qo, hq, dv, dtype=torch.float64, device=dev)
    for h in range(hkv):
        w64 = weights(h, torch.float64)
        ref[:, h * group:(h + 1) * group] = torch.einsum(
            "gqk,kd->qgd", w64.double(), v[:, h].double())
        if h == hw // group:
            row64 = w64[hw % group, t].double()
            row32 = weights(h, torch.float32)[hw % group, t].double()
        del w64
    row_k = _kernel_weights(torch, q, k, kw, t, hw).double()
    n = row_k.numel()
    v_c = v[:n, hw // group, c].double()
    row64, row32 = row64[:n], row32[:n]
    lim64 = ATTN_RTOL_O * ref.abs() + ATTN_ATOL_O
    res = dict(
        kernel_vs_f64_ratio=float(((o.double() - ref).abs() / lim64).max()),
        plain_vs_f64_ratio=float(((plain_o.double() - ref).abs()
                                  / lim64).max()),
        worst=[t, hw, c], f64_at_worst=float(ref[t, hw, c]),
        kernel_minus_f64=float(o[t, hw, c].double() - ref[t, hw, c]),
        plain_minus_f64=float(plain_o[t, hw, c].double() - ref[t, hw, c]),
        kernel_weight_flips=int((row_k != row64).sum()),
        kernel_flip_shift=float(((row_k - row64) * v_c).sum()),
        plain_weight_flips=int((row32 != row64).sum()),
        plain_flip_shift=float(((row32 - row64) * v_c).sum()),
        keys_in_row=n)
    log(f"  sigmoid vs float64: kernel ratio {res['kernel_vs_f64_ratio']:.3f},"
        f" plain ratio {res['plain_vs_f64_ratio']:.3f}; at the worst kernel-"
        f"plain element {res['worst']} (f64 {res['f64_at_worst']:.5f}): "
        f"kernel - f64 {res['kernel_minus_f64']:.5f}, plain - f64 "
        f"{res['plain_minus_f64']:.5f}; of the row's {n} bf16 weights the "
        f"kernel rounds {res['kernel_weight_flips']} otherwise than f64 "
        f"(moving o by {res['kernel_flip_shift']:.5f}), the plain version "
        f"{res['plain_weight_flips']} ({res['plain_flip_shift']:.5f})")
    return res


def check_flash_attention(torch, np, cases=FLASH_CASES):
    """The flash kernel against its plain version on the card, case by
    case (Llama-3-8B prefill, chunked prefill and decode, DeepSeek-V2-Lite's
    MHA prefill, each variant at Llama widths, a small f32 case), with its
    time, bound, the plain version's time and SDPA's where one call computes
    the same function (causal as the lower-right bias; HND as transposed
    views; the window and the custom mask as a boolean mask, ALiBi as a
    bias); the soft cap, sinks and the sigmoid have none."""
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    rows = []
    for name, qo, kv, hq, hkv, d, dv, dtype, causal, variant in cases:
        kernel, plain, lib, extra, pairs, inputs = _flash_case(
            torch, np, qo, kv, hq, hkv, d, dv, dtype, causal, variant, gen)
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        chk = _attn_check(torch, got, want)
        big = qo * kv >= 2 ** 24
        lib_ms = lib_ratio = None
        if lib is not None:
            lib_ms, lib_ratio = _time_library(torch, lib, want, big)
        if variant == "sigmoid":
            chk["vs_float64"] = _sigmoid_witness(torch, np, inputs, got, want)
        del got, want, inputs
        ms = cuda_ms(torch, kernel, 5 if big else 20, warmup=1 if big else 2,
                     graph=True)
        plain_ms = cuda_ms(torch, plain, 2, warmup=1)
        isz = 2 if dtype == "bf16" else 4
        nbytes = ((qo * hq * (d + dv) + kv * hkv * (d + dv)) * isz
                  + qo * hq * 4 + extra)
        ops = 2 * (d + dv) * pairs * hq
        b_ms, b_by = bound_ms(nbytes, ops, dtype)
        row = dict(case=name, qo=qo, kv=kv, hq=hq, hkv=hkv, d=d, dv=dv,
                   dtype=dtype, causal=causal, **chk, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms,
                   library_o_ratio=lib_ratio, bound_bytes=nbytes,
                   bound_ops=ops, bound_ms=b_ms, bound_by=b_by)
        rows.append(row)
        log(f"flash_attention {name:18s} q=[{qo}, {hq}, {d}] kv=[{kv}, {hkv},"
            f" {dv}] {dtype} causal={causal} err_o={chk['err_o']:.2e} (limit "
            f"ratio {chk['o_ratio']:.3f} at |ref| {chk['ref_at_worst']:.3f}) "
            f"err_lse={chk['err_lse']:.2e} ms={ms:.4f} plain_ms="
            f"{plain_ms:.3f} library_ms={lib_ms} (its ratio {lib_ratio}) "
            f"bound_ms={b_ms:.5f} ({b_by}) "
            f"{'ok' if chk['ok'] else 'MISMATCH'}")
        del kernel, plain, lib
        torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"flash kernel disagrees with its plain "
                             f"version: {bad}")
    return rows


# the single-request path: prompt tokens, decode steps, layers
SINGLE_PROMPT, SINGLE_STEPS, SINGLE_LAYERS = 8192, 32, 32


def phase_single_request(torch, np, card):
    """The single-request path at Llama-3-8B widths, bf16, all 32 layers
    (LAYERS_ROTATED distinct q/k/v sets, seeded): an 8192-token prompt
    through ``single_prefill_with_kv_cache`` (causal, lse) a layer, then 32
    ``single_decode_with_kv_cache`` steps a layer over the grown KV. Then
    the tiny f32 case, card against CPU."""
    from flashinfer_tpu_torch.ops.attention.kernels.flash import (
        flash_attention_plain,
    )
    from flashinfer_tpu_torch.ops.attention.single import (
        single_decode_with_kv_cache,
        single_prefill_with_kv_cache,
    )

    hq, hkv, d = LLAMA_HEADS
    n, steps, L = SINGLE_PROMPT, SINGLE_STEPS, SINGLE_LAYERS
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(14)
    sets = [dict(q=torch.randn(n, hq, d, device=dev, generator=gen,
                               dtype=torch.bfloat16),
                 qd=torch.randn(steps, hq, d, device=dev, generator=gen,
                                dtype=torch.bfloat16),
                 k=torch.randn(n + steps, hkv, d, device=dev, generator=gen,
                               dtype=torch.bfloat16),
                 v=torch.randn(n + steps, hkv, d, device=dev, generator=gen,
                               dtype=torch.bfloat16))
            for _ in range(LAYERS_ROTATED)]
    single_prefill_with_kv_cache(sets[0]["q"], sets[0]["k"][:n],
                                 sets[0]["v"][:n], causal=True)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = _reset_counts()
    t0 = time.perf_counter()
    for layer in range(L):
        s = sets[layer % LAYERS_ROTATED]
        o, lse = single_prefill_with_kv_cache(
            s["q"], s["k"][:n], s["v"][:n], causal=True, return_lse=True)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3 / L
    assert o.shape == (n, hq, d) and bool(torch.isfinite(o).all())
    assert bool(torch.isfinite(lse).all())  # every row sees key 0
    step_ms = []
    for i in range(steps):
        ts = time.perf_counter()
        for layer in range(L):
            s = sets[layer % LAYERS_ROTATED]
            od = single_decode_with_kv_cache(s["qd"][i], s["k"][:n + i + 1],
                                             s["v"][:n + i + 1])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - ts) * 1e3)
    counts = {k: counters[k].launches for k in SINGLE_PATH}
    peak = torch.cuda.max_memory_allocated() / 1e9
    # the last step's output of the last layer against the plain version
    s = sets[(L - 1) % LAYERS_ROTATED]
    got = single_decode_with_kv_cache(s["qd"][-1], s["k"], s["v"],
                                      return_lse=True)
    want = flash_attention_plain(s["qd"][-1][None], s["k"], s["v"])
    chk = _attn_check(torch, (got[0][None], got[1][None]), want)
    assert od.shape == (hq, d) and chk["ok"], chk
    res = dict(prefill_ms_per_layer=prefill_ms,
               prefill_tokens_per_s=n / (prefill_ms * L / 1e3),
               decode_step_ms_median=float(np.median(step_ms)),
               decode_ms_per_layer=float(np.median(step_ms)) / L,
               decode_check=chk, launches=counts, peak_mem_gb=peak)
    log(f"single request, Llama-3-8B widths, {L} layers: prefill of {n} "
        f"tokens {prefill_ms:.3f} ms a layer "
        f"({res['prefill_tokens_per_s']:.0f}"
        f" tokens/s over {L} layers); {steps} decode steps over {n}-"
        f"{n + steps} keys: median {res['decode_step_ms_median']:.3f} ms a "
        f"step of {L} layers ({res['decode_ms_per_layer']:.4f} ms a layer); "
        f"last decode vs plain err_o {chk['err_o']:.2e} (ratio "
        f"{chk['o_ratio']:.3f}); "
        f"launches {counts}; peak memory {peak:.2f} GB [{card}]")
    del sets
    torch.cuda.empty_cache()
    res["tiny_f32"] = _single_tiny_card_vs_cpu(torch)
    return res


def _single_tiny_card_vs_cpu(torch):
    """A tiny f32 prefill and decode (HND, ALiBi, a packed custom mask,
    lse), card against CPU, within 1e-4."""
    from flashinfer_tpu_torch.ops.attention.single import (
        single_decode_with_kv_cache,
        single_prefill_with_kv_cache,
    )

    gen = torch.Generator().manual_seed(15)
    q = torch.randn(30, 8, 64, generator=gen)
    k = torch.randn(2, 90, 64, generator=gen)
    v = torch.randn(2, 90, 64, generator=gen)
    packed = torch.randint(0, 256, (-(-30 * 90 // 8),), generator=gen,
                           dtype=torch.int32).to(torch.uint8)
    outs = []
    for device in ("cpu", DEVICE):
        t = [x.to(device) for x in (q, k, v, packed)]
        o, lse = single_prefill_with_kv_cache(
            t[0], t[1], t[2], packed_custom_mask=t[3], causal=True,
            kv_layout="HND", pos_encoding_mode="ALIBI", return_lse=True)
        od, dlse = single_decode_with_kv_cache(t[0][0], t[1], t[2],
                                               kv_layout="HND",
                                               return_lse=True)
        outs.append([x.cpu() for x in (o, lse, od, dlse)])
    err = 0.0
    for a, b in zip(*outs):
        finite = torch.isfinite(b)
        assert torch.equal(finite, torch.isfinite(a))
        err = max(err, float((a[finite] - b[finite]).abs().max()))
    log(f"tiny f32 single request, card vs CPU: max |diff| {err:.2e}")
    if err > 1e-4:
        raise AssertionError(f"tiny f32 single request: card and CPU differ "
                             f"by {err}")
    return err


# POD: decode batch, its lengths, the prefill chunk and its prompt
POD_DECODES, POD_KV_RANGE, POD_CHUNK, POD_PROMPT = 32, (512, 4096), 2048, 8192
POD_LAYERS, POD_PAGE, POD_KV_CHUNK = 32, 16, 512


def _pod_plain(torch, s, indptr, indices, kv_lens):
    """The plain versions of POD's two parts on one layer set, as (o, lse)
    pairs: the chunk against its dense KV (causal, queries at the tail),
    and each decode against its own pages of the HND cache gathered into a
    dense KV, one ``flash_attention_plain`` call a request."""
    from flashinfer_tpu_torch.ops.attention.kernels.flash import (
        flash_attention_plain,
    )

    prefill = flash_attention_plain(s["q_p"], s["k_p"], s["v_p"], causal=True)
    outs = []
    for i, n in enumerate(kv_lens.tolist()):
        pages = torch.as_tensor(indices[indptr[i]:indptr[i + 1]],
                                device=s["kc"].device)
        k, v = (c[pages].transpose(1, 2).reshape(-1, c.shape[1], c.shape[3])
                [:n] for c in (s["kc"], s["vc"]))
        outs.append(flash_attention_plain(s["q_d"][i:i + 1], k, v))
    decode = tuple(torch.cat(x) for x in zip(*outs))
    return prefill, decode


def phase_pod(torch, np, card):
    """POD at Llama-3-8B widths, page 16, HND, over 32 layers
    (LAYERS_ROTATED distinct sets): 32 decodes of 512-4096 tokens beside a
    2048-token chunk at the end of an 8192-token prompt, in both modes
    (two launches: flash + paged kernel; combined: append, then one paged
    launch). On the first layer set each mode's chunk and decodes are held
    to their plain versions (``_pod_plain``), and the two modes to each
    other, within the ATTN tolerances."""
    from flashinfer_tpu_torch.ops.attention.pod import (
        PODWithPagedKVCacheWrapper,
    )

    hq, hkv, d = LLAMA_HEADS
    ps = POD_PAGE
    rng = np.random.default_rng(16)
    kv_lens = rng.integers(POD_KV_RANGE[0], POD_KV_RANGE[1] + 1, POD_DECODES)
    pages = -(-kv_lens // ps)
    indptr = np.concatenate([[0], np.cumsum(pages)])
    n_dec = int(indptr[-1])
    num_pages = n_dec + -(-POD_PROMPT // ps)
    perm = rng.permutation(num_pages)
    indices, free = perm[:n_dec], perm[n_dec:]
    last = kv_lens - (pages - 1) * ps
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(17)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen,
                           dtype=torch.bfloat16)

    sets = [dict(q_p=randn(POD_CHUNK, hq, d), k_p=randn(POD_PROMPT, hkv, d),
                 v_p=randn(POD_PROMPT, hkv, d), q_d=randn(POD_DECODES, hq, d),
                 kc=randn(num_pages, hkv, ps, d),
                 vc=randn(num_pages, hkv, ps, d))
            for _ in range(LAYERS_ROTATED)]
    plan = (indptr, indices, last, hq, hkv, d, ps)
    kw = dict(kv_len_arr=kv_lens, kv_chunk_size=POD_KV_CHUNK)
    modes = {
        "two_launch": PODWithPagedKVCacheWrapper(device=DEVICE).plan(
            *plan, **kw),
        "combined": PODWithPagedKVCacheWrapper(device=DEVICE).plan(
            *plan, prefill_qo_len=POD_CHUNK, prefill_kv_len=POD_PROMPT,
            prefill_page_indices=free, **kw)}

    def run(mode, s):
        out = modes[mode].run(s["q_p"], s["k_p"], s["v_p"], s["q_d"],
                              (s["kc"], s["vc"]), return_lse=True)
        if mode == "combined":
            (po, do), _, (pl, dl) = out
        else:
            (po, do), (pl, dl) = out
        return (po, pl), (do, dl)

    first = {m: run(m, sets[0]) for m in modes}  # warm-up and the checks
    plain = _pod_plain(torch, sets[0], indptr, indices, kv_lens)
    torch.cuda.synchronize()
    parts = (("prefill", 0), ("decode", 1))
    checks = {f"{m} {part} vs plain": _attn_check(torch, first[m][i],
                                                  plain[i])
              for m in modes for part, i in parts}
    checks.update({f"combined vs two_launch {part}": _attn_check(
        torch, first["combined"][i], first["two_launch"][i])
        for part, i in parts})
    del first, plain
    counters = _reset_counts()
    ms = {}
    for mode in modes:
        t0 = time.perf_counter()
        for layer in range(POD_LAYERS):
            run(mode, sets[layer % LAYERS_ROTATED])
        torch.cuda.synchronize()
        ms[mode] = (time.perf_counter() - t0) * 1e3 / POD_LAYERS
    counts = {k: counters[k].launches for k in POD_PATH}
    res = dict(decode_kv_tokens=int(kv_lens.sum()), ms_per_layer=ms,
               checks=checks, launches=counts)
    log(f"POD, Llama-3-8B widths, HND, page {ps}: {POD_DECODES} decodes of "
        f"{kv_lens.min()}-{kv_lens.max()} keys ({int(kv_lens.sum())} in all) "
        f"+ a {POD_CHUNK}-token chunk at the end of a {POD_PROMPT}-token "
        f"prompt, {POD_LAYERS} layers: two launches {ms['two_launch']:.3f} ms "
        f"a layer, combined {ms['combined']:.3f} ms a layer; launches "
        f"{counts} [{card}]")
    for name, c in checks.items():
        log(f"  POD {name}: err_o {c['err_o']:.2e} (limit ratio "
            f"{c['o_ratio']:.3f}) err_lse {c['err_lse']:.2e} "
            f"{'ok' if c['ok'] else 'MISMATCH'}")
    # where a two-launch layer's wall time goes: device time by family
    layer_sets = itertools.cycle(sets)
    prof = _profile_steps(torch, lambda: run("two_launch", next(layer_sets)),
                          LAYERS_ROTATED)
    res["two_launch_profile"] = prof
    if prof:
        prof["busy_share"] = prof["device_ms_per_step"] / ms["two_launch"]
        log(f"POD two_launch profile, per layer: device "
            f"{prof['device_ms_per_step']:.3f} ms (traced wall "
            f"{prof['profiled_wall_ms_per_step']:.3f} ms), busy share "
            f"{prof['busy_share']:.3f}; by family "
            f"{json.dumps(prof['ms_per_step'])}")
        for t, n, name in prof["top_kernels"][:6]:
            log(f"  device {t:8.3f} ms  x{n:<5d} {name}")
        for t, n, name in prof["top_host_ops"][:6]:
            log(f"  host   {t:8.3f} ms  x{n:<5d} {name}")
    else:
        log("POD two_launch profile: the profiler recorded no device time "
            "(not measured)")
    del sets, modes
    torch.cuda.empty_cache()
    bad = {k: c for k, c in checks.items() if not c["ok"]}
    if bad:
        raise AssertionError(f"POD outputs disagree: {bad}")
    return res

# ------------------------------------------------------------------ engines

def phase_tiny_reference(torch, np):
    """Greedy tokens of the f32 tiny engine, card vs CPU, for every KV
    container and layout; then with speculative decoding (3 drafts) on
    repetitive prompts: card, CPU and the non-spec card engine; then with
    e4m3 and int8 weights, decoding, in windows of 4 and speculatively."""
    from flashinfer_tpu_torch import EngineConfig, LlamaConfig, \
        LlamaServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    mc = LlamaConfig.tiny()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, mc.vocab_size, n).tolist()
               for n in (9, 30, 4, 17)]
    params = LlamaServingEngine(
        EngineConfig(model=mc, device="cpu"), seed=0).params
    bad = []
    for kv_dtype in ("model", "fp8_e4m3", "int8"):
        for layout in ("NHD", "HND"):
            outs = []
            for device in ("cpu", DEVICE):
                cfg = EngineConfig(model=mc, max_batch=2, num_pages=64,
                                   page_size=8, max_seq_len=64, greedy=True,
                                   kv_dtype=kv_dtype, kv_scale=0.3,
                                   kv_layout=layout, device=device)
                eng = LlamaServingEngine(cfg, params=params)
                reqs = [eng.add_request(p, 8) for p in prompts]
                eng.run_to_completion(max_steps=200)
                outs.append([r.output for r in reqs])
            same = outs[0] == outs[1]
            log(f"tiny f32 engine {kv_dtype:8s} {layout}: card "
                f"{'==' if same else '!='} cpu")
            if not same:
                bad.append((kv_dtype, layout, outs))
    # repetitive prompts (a core repeated) give the n-gram proposer hits
    core = rng.integers(0, mc.vocab_size, 4).tolist()
    spec_prompts = [core * 3, core * 2 + core[:2],
                    rng.integers(0, mc.vocab_size, 7).tolist()]
    outs, accepted = {}, {}
    for device, spec in (("cpu", SPEC_TOKENS), (DEVICE, SPEC_TOKENS),
                         (DEVICE, 0)):
        cfg = EngineConfig(model=mc, max_batch=2, num_pages=64, page_size=8,
                           max_seq_len=64, greedy=True, spec_tokens=spec,
                           device=device)
        eng = LlamaServingEngine(cfg, params=params)
        reqs = [eng.add_request(p, 8) for p in spec_prompts]
        eng.run_to_completion(max_steps=200)
        outs[device, spec] = [r.output for r in reqs]
        accepted[device, spec] = eng.spec_stats["accepted"]
    same = (outs["cpu", SPEC_TOKENS] == outs[DEVICE, SPEC_TOKENS]
            == outs[DEVICE, 0])
    log(f"tiny f32 spec engine (spec_tokens={SPEC_TOKENS}): card "
        f"{'==' if same else '!='} cpu == non-spec; drafts accepted: card "
        f"{accepted[DEVICE, SPEC_TOKENS]}, cpu {accepted['cpu', SPEC_TOKENS]}")
    if not same or accepted[DEVICE, SPEC_TOKENS] == 0:
        bad.append(("spec", outs, accepted))
    # 8-bit weights, each quantized by the engine from the unfused f32
    # weights: every matmul a grouped-GEMM launch on the card (CUDA cores)
    from flashinfer_tpu_torch.models.llama import llama_init_weights
    from flashinfer_tpu_torch.ops.gemm_grouped import grouped_gemm_padded

    f32_params = llama_init_weights(torch.Generator().manual_seed(0), mc,
                                    "cpu")
    for wdt in ("fp8_e4m3", "int8"):
        for extra in (dict(), dict(decode_window=4),
                      dict(spec_tokens=SPEC_TOKENS)):
            outs = []
            for device in ("cpu", DEVICE):
                cfg = EngineConfig(model=mc, max_batch=2, num_pages=64,
                                   page_size=8, max_seq_len=64, greedy=True,
                                   weight_dtype=wdt, device=device, **extra)
                eng = LlamaServingEngine(cfg, params=f32_params)
                gg0 = grouped_gemm_padded.launches
                reqs = [eng.add_request(p, 8) for p in prompts]
                eng.run_to_completion(max_steps=200)
                outs.append([r.output for r in reqs])
            launched = grouped_gemm_padded.launches - gg0
            same = outs[0] == outs[1]
            log(f"tiny f32 engine weight_dtype={wdt} {json.dumps(extra)}: "
                f"card {'==' if same else '!='} cpu ({launched} grouped "
                f"GEMM launches on the card)")
            if not same or launched == 0:
                bad.append((wdt, extra, outs, launched))
    if bad:
        raise AssertionError(f"card and CPU engines disagree: {bad}")


def _reset_counts():
    """Set every kernel's launch count to 0; returns name -> wrapper."""
    from flashinfer_tpu_torch.ops.attention.kernels.flash import (
        flash_attention_dense,
    )
    from flashinfer_tpu_torch.ops.attention.kernels.paged import (
        batch_paged_attention_run,
    )
    from flashinfer_tpu_torch.ops.attention.mla import mla_paged_run
    from flashinfer_tpu_torch.ops.gemm_grouped import grouped_gemm_padded
    from flashinfer_tpu_torch.ops.norm import rmsnorm
    from flashinfer_tpu_torch.ops.sampling import family_call

    fns = {"paged_attention": batch_paged_attention_run,
           "paged_attention_gather": _GatherLaunches(),
           "sampler_family": family_call, "rmsnorm": rmsnorm,
           "mla_attention": mla_paged_run,
           "grouped_gemm": grouped_gemm_padded,
           "flash_attention": flash_attention_dense}
    for fn in fns.values():
        fn.launches = 0
    return fns


class _GatherLaunches:
    """The launches of the paged kernel's gather build (pages that are not
    a multiple of 8 tokens; its wrapper's ``gather_launches``, also counted
    in ``launches``) as a count of its own."""

    @property
    def launches(self):
        from flashinfer_tpu_torch.ops.attention.kernels.paged import (
            batch_paged_attention_run,
        )

        return batch_paged_attention_run.gather_launches

    @launches.setter
    def launches(self, n):
        from flashinfer_tpu_torch.ops.attention.kernels.paged import (
            batch_paged_attention_run,
        )

        batch_paged_attention_run.gather_launches = n


LLAMA_PATH = ("paged_attention", "sampler_family", "rmsnorm")
# Llama with 8-bit weights: every matmul is a grouped-GEMM launch
LLAMA_W8_PATH = LLAMA_PATH + ("grouped_gemm",)
SPEC_TOKENS = 3  # drafts a sequence in the spec modes
DEEPSEEK_PATH = ("mla_attention", "grouped_gemm", "rmsnorm",
                 "sampler_family")
MIXTRAL_PATH = ("paged_attention", "grouped_gemm", "rmsnorm",
                "sampler_family")
SINGLE_PATH = ("flash_attention",)
POD_PATH = ("flash_attention", "paged_attention")


def _family(name):
    name = name.lower()
    for fam, keys in (("paged_attention", ("paged_tc_kernel",
                                           "paged_dec_kernel",
                                           "paged_f32_kernel")),
                      ("flash_attention", ("flash_tc_kernel",
                                           "flash_f32_kernel",
                                           "merge_splits_kernel")),
                      ("mla_attention", ("mla_attention_kernel",
                                         "mla_dec_kernel", "mla_pre_kernel")),
                      ("grouped_gemm", ("grouped_gemm",)),
                      ("sampler_family", ("family_cluster_kernel",
                                          "family_stream_kernel")),
                      ("rmsnorm", ("rmsnorm",)),
                      ("matmul", ("gemm", "gemv", "xmma", "cutlass", "nvjet",
                                  "splitk")),
                      ("copies", ("memcpy", "memset"))):
        if any(k in name for k in keys):
            return fam
    return "other"


def _profile_steps(torch, step, steps, per_call=1):
    """Device time by kernel family, the device ops, the top kernels and
    the top host ops over ``steps`` calls of ``step`` (``per_call`` decode
    steps each; the numbers are per decode step), from torch.profiler; None
    where the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    n = steps * per_call
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    fams, kernels, host, ops = {}, [], [], 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:  # a kernel, memcpy or memset
            ms = ev.self_device_time_total / 1e3 / n
            fams[_family(ev.key)] = fams.get(_family(ev.key), 0.0) + ms
            kernels.append((ms, ev.count // n, ev.key[:90]))
            ops += ev.count
        elif ev.self_cpu_time_total:
            host.append((ev.self_cpu_time_total / 1e3 / n,
                         ev.count // n, ev.key[:60]))
    total = sum(fams.values())
    if total == 0.0:
        return None
    return dict(profiled_wall_ms_per_step=wall, device_ms_per_step=total,
                device_ops_per_step=ops // n,
                ms_per_step=dict(sorted(fams.items(), key=lambda kv: -kv[1])),
                top_kernels=sorted(kernels, reverse=True)[:12],
                top_host_ops=sorted(host, reverse=True)[:12])


def _profile_decode(torch, eng, prompts, steps=3):
    """``_profile_steps`` over ``steps`` engine steps that decode a full
    batch (a window of N each, so the numbers are per decode step), and for
    a graphed engine the device ms of one replay of the step's graph, from
    CUDA events over back-to-back replays of the last step (which rewrite
    the same cache entries). A spec engine's numbers are per verify step.
    Leaves the engine idle."""
    spec = eng.cfg.spec_tokens
    n = 1 if spec else eng.cfg.decode_window
    for p in prompts[: eng.cfg.max_batch]:
        # prefill's token, a first decode (or window), then ``steps`` more,
        # each emitting at most n tokens (spec: G + 1)
        eng.add_request(p, 2 + (steps + 1) * (spec + 1 if spec else n))
    eng.step()  # admission, prefill and the first decode
    prof = _profile_steps(torch, eng.step, steps, per_call=n)
    replay_ms = None
    if eng.graphs.enabled:
        key = eng.graphs.last_key
        replay_ms = cuda_ms(torch, lambda: eng.graphs.replay(key), 10)
    eng.run_to_completion()
    return prof, replay_ms


def tail_pct(samples):
    """The highest percentile with at least ten samples beyond it (the
    maximum, 100, when there are fewer than ten)."""
    return int(100 * (1 - 10 / len(samples))) if len(samples) >= 10 else 100


def _serve(torch, eng, prompts, n_new):
    """Serve the prompts to completion. Returns (requests, wall s, the wall
    ms of each step that admitted nothing, per device step (a window's over
    its decode steps; a verify step is one), whether each of those ran a
    full batch, the wall ms of the steps that admitted)."""
    reqs = [eng.add_request(p, n_new) for p in prompts]
    decode_ms, full, prefill_ms = [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.has_work():
        pending, running = len(eng._pending), eng.num_running
        ran = eng.decode_steps + eng.spec_stats["steps"]
        ts = time.perf_counter()
        eng.step()
        dt = (time.perf_counter() - ts) * 1e3
        if len(eng._pending) < pending:
            prefill_ms.append(dt)
        else:
            ran = eng.decode_steps + eng.spec_stats["steps"] - ran
            decode_ms.append(dt / max(1, ran))
            full.append(running == eng.cfg.max_batch)
        if eng.steps > 10000:
            raise RuntimeError("engine did not finish")
    torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0, decode_ms, full, prefill_ms


# the engine's decode step three ways: eager, replayed from CUDA graphs,
# and replayed four steps a window; then speculative decoding, its verify
# step eager and replayed from CUDA graphs
ENGINE_MODES = (("eager", dict(cuda_graphs=False)), ("graphed", {}),
                ("window4", dict(decode_window=4)),
                ("spec_eager", dict(spec_tokens=SPEC_TOKENS,
                                    cuda_graphs=False)),
                ("spec", dict(spec_tokens=SPEC_TOKENS)))


def _engine_mode(torch, np, mc, params, prompts, n_new, card, label,
                 path, **cfg_kw):
    """Serve the prompts on one engine configuration (``cfg_kw`` over 8
    slots), its launch counts of ``path`` zeroed just before, then profile
    a few full-batch steps. Returns (results, outputs, the engine's
    params)."""
    from flashinfer_tpu_torch import EngineConfig, LlamaServingEngine

    cfg = EngineConfig(model=mc, max_batch=8, device=DEVICE, **cfg_kw)
    torch.cuda.reset_peak_memory_stats()
    eng = LlamaServingEngine(cfg, params=params, seed=0)
    counters = _reset_counts()
    reqs, wall, dec, full_at, pre = _serve(torch, eng, prompts, n_new)
    counts = {k: counters[k].launches for k in path}
    steps, decode_steps = eng.steps, eng.decode_steps
    spec = dict(eng.spec_stats)
    plan_ms = eng.plan_seconds * 1e3 / (decode_steps + spec["steps"])
    graphs = dict(captured=eng.graphs.captures,
                  capture_s=eng.graphs.capture_seconds,
                  pool_bytes=eng.graphs.pool_bytes)
    prof, replay_ms = _profile_decode(torch, eng, prompts)
    outs = [r.output for r in reqs]
    assert all(r.done for r in reqs)
    assert all(len(o) == n_new for o in outs), [len(o) for o in outs]
    assert all(0 <= t < mc.vocab_size for o in outs for t in o)
    assert eng.pool.free_pages == cfg.num_pages
    gen_tokens = sum(len(o) for o in outs)
    full = [ms for ms, f in zip(dec, full_at) if f]
    weight_gb = sum(t.numel() * t.element_size()
                    for t in eng.params.values()) / 1e9
    pool = f"{type(eng.pool).__module__}.{type(eng.pool).__name__}"
    res = dict(pool=pool, planner=os.environ.get("FLASHINFER_TPU_PLANNER",
                                                  "auto"),
        tokens_per_s=gen_tokens / wall, wall_s=wall,
        generated_tokens=gen_tokens, steps=steps,
        decode_steps=decode_steps, preemptions=eng.preemptions,
        decode_step_ms_median=float(np.median(dec)) if dec else None,
        decode_step_ms_median_batch8=(float(np.median(full)) if full
                                      else None),
        decode_steps_batch8=len(full),
        # the highest percentile with at least ten steps beyond it
        decode_step_tail_pct_batch8=tail_pct(full),
        decode_step_ms_tail_batch8=(
            float(np.percentile(full, tail_pct(full))) if full else None),
        prefill_steps=len(pre),
        prefill_step_ms_mean=float(np.mean(pre)) if pre else None,
        plan_ms_per_decode_step=plan_ms, graphs=graphs,
        replay_device_ms=replay_ms, launches=counts, profile=prof,
        first_tokens=[o[:4] for o in outs[:3]], weight_gb=weight_gb,
        # everything allocated at once, weights held beside it included
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if spec["steps"]:
        res.update(
            spec=spec, verify_steps=spec["steps"],
            tokens_per_verify_step=spec["emitted"] / spec["seqs"],
            acceptance=spec["accepted"] / spec["drafts"])
    # a step's device time: CUDA events around a replay where the step is
    # a graph, else the profiler's kernels
    dev_ms = replay_ms or (prof or {}).get("device_ms_per_step")
    res["device_ms_per_step"] = dev_ms
    if dev_ms and full:
        res["busy_share"] = dev_ms / res["decode_step_ms_median_batch8"]
    log(f"engine {label}: {gen_tokens} tokens in {wall:.2f} s = "
        f"{res['tokens_per_s']:.1f} tokens/s; decode step median "
        f"{res['decode_step_ms_median']:.2f} ms (batch 8: median "
        f"{res['decode_step_ms_median_batch8']}, "
        f"p{res['decode_step_tail_pct_batch8']} "
        f"{res['decode_step_ms_tail_batch8']}, n={len(full)}); device "
        f"{dev_ms} ms a step, busy share {res.get('busy_share')}; planner "
        f"({res['planner']}, pool {pool}) {plan_ms:.3f} ms a decode step; "
        f"graphs {json.dumps(graphs)}; "
        f"{len(pre)} prefill steps, mean {res['prefill_step_ms_mean']:.1f} "
        f"ms; preemptions {eng.preemptions}; weights {weight_gb:.2f} GB, "
        f"peak memory {res['peak_mem_gb']:.2f} GB; launches {counts} "
        f"[{card}]")
    if spec["steps"]:
        log(f"engine {label}: {spec['steps']} verify steps over "
            f"{spec['seqs']} sequence-steps emitted "
            f"{res['tokens_per_verify_step']:.3f} tokens a sequence a step; "
            f"drafts accepted {spec['accepted']} of {spec['drafts']} "
            f"({res['acceptance']:.3f})")
    if prof:
        log(f"engine {label} profile, per decode step at batch 8: device "
            f"{prof['device_ms_per_step']:.2f} ms in "
            f"{prof['device_ops_per_step']} device ops (traced wall "
            f"{prof['profiled_wall_ms_per_step']:.2f} ms; replay {replay_ms} "
            f"ms from CUDA events); by family {json.dumps(prof['ms_per_step'])}")
        for ms, n, name in prof["top_kernels"]:
            log(f"  device {ms:8.3f} ms  x{n:<5d} {name}")
        for ms, n, name in prof["top_host_ops"]:
            log(f"  host   {ms:8.3f} ms  x{n:<5d} {name}")
    else:
        log(f"engine {label} profile: the profiler recorded no device time "
            "(not measured)")
    params = eng.params
    del eng
    torch.cuda.empty_cache()
    return res, outs, params


def phase_engine(torch, np, card, shared):
    from flashinfer_tpu_torch import LlamaConfig
    from flashinfer_tpu_torch.models.llama import llama_init_weights

    mc = LlamaConfig.llama3_8b()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    t0 = time.perf_counter()
    params = llama_init_weights(gen, mc, DEVICE)
    torch.cuda.synchronize()
    log(f"Llama-3-8B weights: {sum(t.numel() for t in params.values())/1e9:.3f}"
        f"B parameters, bf16, {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 513, 12)
    prompts = [rng.integers(0, mc.vocab_size, int(n)).tolist() for n in lens]
    n_new = 32
    results, outs_by = {}, {}
    for mode, extra in ENGINE_MODES:
        results[mode] = {}
        for sampling in ("sampled", "greedy"):
            res, outs, params = _engine_mode(
                torch, np, mc, params, prompts, n_new, card,
                f"{mode} {sampling}", LLAMA_PATH,
                greedy=(sampling == "greedy"), **extra)
            # the fused QKV weights, shared by the next engine
            results[mode][sampling] = res
            outs_by[mode, sampling] = outs
    missing = [(path, k) for path in ("graphed", "spec")
               for k, n in results[path]["sampled"]["launches"].items()
               if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    same = {"greedy, all three modes": (
                outs_by["eager", "greedy"] == outs_by["graphed", "greedy"]
                == outs_by["window4", "greedy"]),
            "sampled, eager and graphed": (
                outs_by["eager", "sampled"] == outs_by["graphed", "sampled"]),
            "spec greedy, eager and graphed": (
                outs_by["spec_eager", "greedy"] == outs_by["spec", "greedy"]),
            "spec sampled, eager and graphed": (
                outs_by["spec_eager", "sampled"]
                == outs_by["spec", "sampled"])}
    log(f"engine tokens identical: {same}")
    # not asserted: the verify step's 32-row GEMMs round otherwise than
    # the decode step's 8-row ones, in bf16
    match = float(np.mean(np.asarray(outs_by["spec", "greedy"])
                          == np.asarray(outs_by["graphed", "greedy"])))
    results["spec_greedy_match_decode"] = match
    log(f"engine spec greedy tokens equal to the graphed decode's: "
        f"{match:.3f}")
    if not all(same.values()):
        raise AssertionError(f"the modes' tokens differ: {same}")
    results["planner_numpy"] = _engine_numpy_planner(
        torch, np, mc, params, prompts, n_new, card, results,
        outs_by["graphed", "greedy"])
    results["trace"] = _trace_llama_step(torch, mc, params, prompts, card)
    results["variants"] = _engine_variants(
        torch, np, mc, params, prompts[:8], outs_by["graphed", "greedy"])
    results["w8"] = _engine_w8(torch, np, mc, params, prompts, n_new, card,
                               outs_by["graphed", "greedy"])
    # the distributed phase serves these weights next
    shared["llama"] = (mc, params, prompts)
    return results


# pages that are not a multiple of 8 tokens: the paged kernel's gather build
ODD_PAGES = (12, 20)
PAGES_REQUESTS = 8  # of the engine phase's prompts (64-512 tokens)
PAGES_NEW = 16
PAGES_PATH = ("paged_attention", "paged_attention_gather", "rmsnorm")


def _repack_flat(np, lens, ps):
    """The gather map of the route pages of ``ps`` tokens took before the
    gather build (the wrappers' repack, now kept for pages under 8): flat
    token ids (page * ps + slot) of the caller's cache, [n, 128] in the
    order of the page ids ``_engine_like_plans`` gives 128-token pages, so
    the plan at page 128 reads the repacked cache; slots past a request's
    end repeat its last token, as the wrapper's map does."""
    kv = np.asarray(lens, np.int64)
    indptr, indices = _page_table(np, kv, ps)
    syn_indptr, syn_ids = _page_table(np, kv, 128)
    r = np.repeat(np.arange(len(kv)), np.diff(syn_indptr))
    j = np.arange(len(r)) - syn_indptr[r]
    t = np.minimum(j[:, None] * 128 + np.arange(128), kv[r][:, None] - 1)
    flat = np.empty((len(r), 128), np.int64)
    flat[syn_ids] = indices[indptr[r][:, None] + t // ps] * ps + t % ps
    return flat


def _repack_route(torch, np, mode, lens, gather_row, ps=12, d=128):
    """The repack route on the decode or prefill case of ``gather_row`` (NHD
    bf16): the gather of the caller's pages into 128-token pages (both K
    and V, the wrapper's ``kernel_caches``) and the TMA build's launch on
    the plan at page 128, each timed over ``LAYERS_ROTATED`` caches,
    beside the gather build's launch on the caller's pages."""
    from flashinfer_tpu_torch.ops.attention.kernels.paged import (
        batch_paged_attention_run,
    )

    hq, hkv = 32, 8
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(8)
    lens_d, lens_p = ((lens, [64]) if mode == "decode" else ([64], lens))
    dp, syn_pages, _, _ = _engine_like_plans(np, lens_d, lens_p, d=d,
                                             ps=128)[mode]
    flat = torch.from_numpy(_repack_flat(np, lens, ps)).to(dev)
    pages = int(-(-np.asarray(lens) // ps).sum())
    L = LAYERS_ROTATED
    kc, vc = (torch.randn(L * pages, ps, hkv, d, device=dev, generator=gen,
                          dtype=torch.bfloat16) for _ in range(2))
    turn = [0]

    def gather():
        off = (turn[0] % L) * pages * ps
        turn[0] += 1
        return (kc.reshape(-1, hkv, d)[flat + off],
                vc.reshape(-1, hkv, d)[flat + off])

    syn = [gather() for _ in range(L)]
    m = dp.meta
    q = torch.randn(hkv, m.bucket_rows, d, device=dev, generator=gen,
                    dtype=torch.bfloat16)
    kw = dict(tile_q=m.tile_q, group=hq // hkv, causal=m.causal,
              sm_scale=m.sm_scale, row_valid=dp.segment("row_valid"))

    def launch():
        k, v = syn[turn[0] % L]
        turn[0] += 1
        return batch_paged_attention_run(q, k, v, dp.segment("kv_indices"),
                                         dp.segment("plan"), **kw)

    gather_ms = cuda_ms(torch, gather, 10, graph=True)
    launch_ms = cuda_ms(torch, launch, 20, graph=True)
    row = dict(mode=mode, page_size=ps, synthetic_pages=syn_pages,
               gather_ms=gather_ms, launch_ms=launch_ms,
               repack_ms=gather_ms + launch_ms,
               gather_build_ms=gather_row["ms"],
               gather_build_bound_ms=gather_row["bound_ms"])
    log(f"paged repack route {mode:7s} page {ps}: gather {gather_ms:.4f} ms "
        f"+ launch on 128-token pages {launch_ms:.4f} ms = "
        f"{row['repack_ms']:.4f} ms; the gather build on the caller's pages "
        f"{gather_row['ms']:.4f} ms (bound {gather_row['bound_ms']:.5f})")
    del syn, kc, vc
    torch.cuda.empty_cache()
    return row


def phase_pages(torch, np, card, shared, lens_decode, lens_prefill):
    """Pages of 12 and 20 tokens (the pages path): the paged kernel's
    gather build at the engine's Llama-3-8B decode and prefill plans on
    pages of 12 and 20 (NHD and HND; bf16, e4m3 and int8 caches; decode
    also at head_dim 256 on pages of 12) against its plain version, timed,
    every launch the gather build's (its count); the repack route it
    replaces at page 12, its gather and launch timed apart; then the
    engine phase's Llama-3-8B weights through ``LlamaServingEngine`` at
    page 12, greedy, eager and graphed (tokens identical; the graphed run's
    launch counts are the pages path's, the gather build's among them),
    and at page 16 graphed on the same traffic (no gather launch)."""
    rows = []
    for ps in ODD_PAGES:
        plans = _engine_like_plans(np, lens_decode, lens_prefill, ps=ps)
        cases = [(mode, 128, plans[mode], ("NHD", "HND"))
                 for mode in ("decode", "prefill")]
        if ps == ODD_PAGES[0]:
            cases.append(("decode", 256, _engine_like_plans(
                np, lens_decode, lens_prefill, d=256, ps=ps)["decode"],
                ("NHD",)))
        counters = _reset_counts()
        rows += _paged_rows(torch, cases, ps, "paged_attention_gather")
        n, g = (counters[k].launches for k in ("paged_attention",
                                               "paged_attention_gather"))
        log(f"pages of {ps}: {n} paged launches, {g} of the gather build")
        if not 0 < n == g:
            raise AssertionError(f"pages of {ps}: {g} of {n} launches went "
                                 f"to the gather build")

    def nhd_bf16(mode):
        return next(r for r in rows if r["mode"] == mode and r["d"] == 128
                    and r["page_size"] == ODD_PAGES[0]
                    and r["layout"] == "NHD" and r["kv"] == "bf16")

    repack = [_repack_route(torch, np, "decode", lens_decode,
                            nhd_bf16("decode")),
              _repack_route(torch, np, "prefill", lens_prefill,
                            nhd_bf16("prefill"))]
    mc, params, prompts = shared["llama"]
    prompts = prompts[:PAGES_REQUESTS]
    engine, outs = {}, {}
    for label, extra in (("page12 eager", dict(page_size=12,
                                               cuda_graphs=False)),
                         ("page12 graphed", dict(page_size=12)),
                         ("page16 graphed", dict(page_size=16))):
        res, outs[label], params = _engine_mode(
            torch, np, mc, params, prompts, PAGES_NEW, card, label,
            PAGES_PATH, greedy=True, **extra)
        engine[label] = res
    shared["llama"] = (shared["llama"][0], params, shared["llama"][2])
    same = outs["page12 eager"] == outs["page12 graphed"]
    agree = float(np.mean(np.asarray(outs["page12 graphed"])
                          == np.asarray(outs["page16 graphed"])))
    log(f"engine page 12: greedy tokens eager == graphed: {same}; equal to "
        f"page 16's: {agree:.3f} (not asserted: other KV chunks sum in "
        f"other orders); graphed step device ms page 12 "
        f"{engine['page12 graphed']['device_ms_per_step']} vs page 16 "
        f"{engine['page16 graphed']['device_ms_per_step']}, wall ms "
        f"{engine['page12 graphed']['decode_step_ms_median_batch8']} vs "
        f"{engine['page16 graphed']['decode_step_ms_median_batch8']} "
        f"[{card}]")
    launches = engine["page12 graphed"]["launches"]
    if not same:
        raise AssertionError("page-12 greedy tokens differ eager and graphed")
    if not all(launches.values()):
        raise AssertionError(f"page 12: a kernel of the pages path was not "
                             f"launched: {launches}")
    if engine["page16 graphed"]["launches"]["paged_attention_gather"]:
        raise AssertionError("page 16 launched the gather build")
    return dict(rows=rows, repack=repack, engine=engine,
                page16_agreement=agree, launches=launches)


def _engine_numpy_planner(torch, np, mc, params, prompts, n_new, card,
                          results, native_greedy):
    """The graphed greedy run again with ``FLASHINFER_TPU_PLANNER=numpy``:
    the same tokens as on the native planner, and its own planner ms."""
    native = results["graphed"]["greedy"]
    if not native["pool"].endswith("native.PagePool"):
        raise AssertionError(f"the engine ran on {native['pool']}, not the "
                             "C++ pool")
    prev = os.environ.get("FLASHINFER_TPU_PLANNER")
    os.environ["FLASHINFER_TPU_PLANNER"] = "numpy"
    try:
        res, outs, _ = _engine_mode(torch, np, mc, params, prompts, n_new,
                                    card, "graphed greedy, NumPy planner",
                                    LLAMA_PATH, greedy=True)
    finally:
        if prev is None:
            del os.environ["FLASHINFER_TPU_PLANNER"]
        else:
            os.environ["FLASHINFER_TPU_PLANNER"] = prev
    same = outs == native_greedy
    log(f"engine planner ms a decode step: native "
        f"{native['plan_ms_per_decode_step']:.3f}, NumPy "
        f"{res['plan_ms_per_decode_step']:.3f}; greedy tokens identical: "
        f"{same} [{card}]")
    if not same:
        raise AssertionError("the NumPy planner's engine emits other tokens")
    return dict(plan_ms_per_decode_step=res["plan_ms_per_decode_step"],
                native_plan_ms_per_decode_step=native[
                    "plan_ms_per_decode_step"],
                decode_step_ms_median_batch8=res[
                    "decode_step_ms_median_batch8"], tokens_equal=same)


# kernel name fragments of the Llama decode step's kernels in a trace
TRACE_KERNELS = (("paged_attention", ("paged_dec_kernel", "paged_tc_kernel",
                                      "paged_f32_kernel")),
                 ("rmsnorm", ("rmsnorm",)),
                 ("sampler_family", ("family_cluster_kernel",
                                     "family_stream_kernel")))


def _trace_llama_step(torch, mc, params, prompts, card):
    """One graphed, sampled Llama-3-8B decode step at batch 8 traced with
    ``profiler.profile_trace``; ``summarize_trace`` must find the paged,
    RMSNorm and sampler kernels by name."""
    import tempfile

    from flashinfer_tpu_torch import EngineConfig, LlamaServingEngine
    from flashinfer_tpu_torch import profiler

    eng = LlamaServingEngine(EngineConfig(model=mc, max_batch=8,
                                          device=DEVICE), params=params,
                             seed=0)
    for p in prompts[:8]:
        eng.add_request(p, 8)
    eng.step()  # admission, prefill and the first decode (its capture)
    eng.step()
    with tempfile.TemporaryDirectory() as d:
        with profiler.profile_trace(d):
            with profiler.annotate("llama_decode_step"):
                eng.step()
        top = profiler.summarize_trace(d, top=60)
        trace_mb = os.path.getsize(profiler.latest_trace_path(d)) / 1e6
    eng.run_to_completion()
    found = {fam: sorted({n[:60] for n, _, _ in top
                          if any(k in n for k in keys)})
             for fam, keys in TRACE_KERNELS}
    total = sum(ms for _, ms, _ in top)
    log(f"traced decode step: {len(top)} kernel names, {total:.2f} ms of "
        f"device time, trace {trace_mb:.1f} MB; found {found} [{card}]")
    for name, ms, n in top[:8]:
        log(f"  device {ms:8.3f} ms  x{n:<5d} {name[:90]}")
    missing = [fam for fam, names in found.items() if not names]
    if missing:
        raise AssertionError(f"summarize_trace missed {missing}")
    del eng
    torch.cuda.empty_cache()
    return dict(found=found, device_ms=total, kernels=len(top),
                trace_mb=trace_mb)


def _unfused(params, mc):
    """The engine's bf16 params with wqkv split back into wq / wk / wv
    (views), the names the 8-bit quantizers take."""
    p = dict(params)
    d = mc.head_dim
    p["wq"], p["wk"], p["wv"] = p.pop("wqkv").split(
        [mc.num_qo_heads * d, mc.num_kv_heads * d, mc.num_kv_heads * d],
        dim=-1)
    return p


# the 8-bit engine runs: (label, weight_dtype, sampled, more EngineConfig);
# the first is the 8-bit weight path, whose launch counts are read
W8_MODES = (("fp8_e4m3 graphed sampled", "fp8_e4m3", True, {}),
            ("fp8_e4m3 graphed greedy", "fp8_e4m3", False, {}),
            ("fp8_e4m3 eager greedy", "fp8_e4m3", False,
             dict(cuda_graphs=False)),
            ("int8 graphed greedy", "int8", False, {}))


def _engine_w8(torch, np, mc, params, prompts, n_new, card, bf16_greedy):
    """Llama-3-8B with 8-bit weights, each set quantized (a layer at a
    time, on the card, as the engine's ``weight_dtype`` does) from the bf16
    weights served above, which stay beside it, and freed before the next
    is built. Eager and graphed greedy tokens must be identical; agreement
    with the bf16 greedy tokens is reported."""
    from flashinfer_tpu_torch.models.llama import (
        quantize_llama_weights_fp8,
        quantize_llama_weights_int8,
    )
    from flashinfer_tpu_torch.serving.engine import fuse_qkv_weights

    quantize = {"fp8_e4m3": quantize_llama_weights_fp8,
                "int8": quantize_llama_weights_int8}
    base = _unfused(params, mc)
    out, outs_by, w8_params = {}, {}, {}
    for label, wdt, sampled, extra in W8_MODES:
        if wdt not in w8_params:
            w8_params.clear()
            gc.collect()  # an engine's cycles may hold the last set
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            w8_params[wdt] = fuse_qkv_weights(quantize[wdt](base))
            torch.cuda.synchronize()
            nbytes = sum(t.numel() * t.element_size()
                         for t in w8_params[wdt].values())
            log(f"Llama-3-8B {wdt} weights: {nbytes / 1e9:.2f} GB, "
                f"quantized in {time.perf_counter() - t0:.1f} s")
        res, outs = _engine_mode(
            torch, np, mc, w8_params[wdt], prompts, n_new, card,
            f"w8 {label}", LLAMA_W8_PATH, greedy=not sampled,
            weight_dtype=wdt, **extra)[:2]
        if not sampled:
            got, want = np.asarray(outs), np.asarray(bf16_greedy)
            res["agreement_with_bf16_greedy"] = float(np.mean(got == want))
            res["first_token_agreement_with_bf16"] = float(
                np.mean(got[:, 0] == want[:, 0]))
            log(f"engine w8 {label}: greedy tokens agree with the bf16 "
                f"engine's at {res['agreement_with_bf16_greedy']:.3f} (first "
                f"token {res['first_token_agreement_with_bf16']:.3f}; not "
                f"asserted)")
        out[label] = res
        outs_by[label] = outs
    w8_params.clear()
    torch.cuda.empty_cache()
    missing = [k for k, n in out[W8_MODES[0][0]]["launches"].items()
               if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the 8-bit weight "
                             f"path: {missing}")
    same = (outs_by["fp8_e4m3 eager greedy"]
            == outs_by["fp8_e4m3 graphed greedy"])
    log(f"engine w8 fp8_e4m3 greedy tokens, eager and graphed identical: "
        f"{same}")
    if not same:
        raise AssertionError("the 8-bit engine's eager and graphed greedy "
                             "tokens differ")
    return out


def _engine_variants(torch, np, mc, params, prompts, greedy_outs, n_new=8):
    """The other KV layouts and containers at full size: the first 8 greedy
    tokens of the first 8 prompts (the same first batch as the greedy run).
    The HND cache runs the same arithmetic as NHD, so its tokens must be
    identical; the 8-bit caches report their agreement with bf16."""
    from flashinfer_tpu_torch import EngineConfig, LlamaServingEngine

    out = {}
    for layout, kv_dtype in (("HND", "model"), ("NHD", "fp8_e4m3"),
                             ("HND", "int8")):
        cfg = EngineConfig(model=mc, max_batch=8, greedy=True,
                           kv_layout=layout, kv_dtype=kv_dtype,
                           device=DEVICE)
        eng = LlamaServingEngine(cfg, params=params)
        reqs, wall, dec, _, _ = _serve(torch, eng, prompts, n_new)
        got = np.asarray([r.output for r in reqs])
        want = np.asarray([o[:n_new] for o in greedy_outs[: len(prompts)]])
        agree = float(np.mean(got == want))
        first = float(np.mean(got[:, 0] == want[:, 0]))
        out[f"{layout}/{kv_dtype}"] = dict(
            agreement_with_nhd_bf16=agree, first_token_agreement=first,
            decode_step_ms_median=float(np.median(dec)) if dec else None)
        log(f"engine {layout} kv={kv_dtype}: greedy tokens agree with NHD "
            f"bf16 at {agree:.3f} (first token {first:.3f}); decode step median "
            f"{out[f'{layout}/{kv_dtype}']['decode_step_ms_median']:.2f} ms")
        assert got.shape == want.shape and bool(
            ((got >= 0) & (got < mc.vocab_size)).all())
        if kv_dtype == "model" and agree != 1.0:
            raise AssertionError(f"HND and NHD bf16 engines disagree: {got} "
                                 f"vs {want}")
        del eng
        torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------- DeepSeek

def _pages_needed(prompts, n_new, page_size):
    """Pages of a pool that gives every request room for its prompt and
    ``n_new`` tokens."""
    total = max(len(p) for p in prompts) + n_new
    return len(prompts) * -(-total // page_size)


def _token_loop(torch, np, prompts, n_new, page_size, forward, *, device,
                sampled, seed=0, profile_at=None):
    """Serve ``prompts`` a token a step: every step feeds each unfinished
    request its next prompt token (prefill token by token) or its last
    generated token, all at position t, and a request emits a token from
    its last prompt position on, until it has ``n_new``. ``forward(tokens,
    t, indptr, indices, last, tables)`` plans and runs the step for the
    live requests (``tables``: kv_indices, kv_indptr and kv_last_page_len
    as int32 device tensors, uploaded with the tokens in one copy) and
    returns their logits [live, vocab] f32. Sampled: top-k 40, top-p 0.9
    on the sampler kernel; else greedy. With ``profile_at``, the three
    steps from that one are traced (and left out of the step times).
    Request i takes pages from the bottom of a pool of ``_pages_needed``
    pages in turn (request i's first page is page i). Returns a dict:
    ``outs`` (the tokens of each request), ``wall_s``, ``step_ms``,
    ``profile`` and the first and the last step's logits (``logits0``,
    ``logits``)."""
    from flashinfer_tpu_torch.ops.sampling import (
        draw_seed,
        softmax,
        top_k_top_p_sampling_from_probs,
    )
    from flashinfer_tpu_torch.scheduler.native import PagePool

    B = len(prompts)
    pool = PagePool(_pages_needed(prompts, n_new, page_size), page_size)
    seqs = [pool.create() for _ in prompts]
    gen = torch.Generator().manual_seed(seed)
    outs = [[] for _ in prompts]
    step_ms, prof, logits = [], None, {}
    t = 0

    def step():
        nonlocal t
        live = [i for i in range(B) if len(outs[i]) < n_new]
        for i in live:
            pool.extend(seqs[i], t + 1)
        indptr, indices, last = pool.batch_export([seqs[i] for i in live])
        toks = [prompts[i][t] if t < len(prompts[i]) else outs[i][-1]
                for i in live]
        host = np.concatenate([toks, indices, indptr, last]).astype(np.int64)
        dev = torch.from_numpy(host).to(device)
        n, ni = len(live), len(indices)
        tabs = (dev[n: n + ni].int(), dev[n + ni: 2 * n + ni + 1].int(),
                dev[2 * n + ni + 1:].int())
        lg = forward(dev[:n], t, indptr, indices, last, tabs)
        logits.setdefault("logits0", lg)
        logits["logits"] = lg
        emit = [j for j, i in enumerate(live) if t >= len(prompts[i]) - 1]
        if emit:
            lg = lg[emit]
            if sampled:
                new = top_k_top_p_sampling_from_probs(
                    softmax(lg), 40, 0.9, seed=draw_seed(gen))
            else:
                new = lg.argmax(dim=-1)
            for j, tok in zip(emit, new.tolist()):
                outs[live[j]].append(int(tok))
        t += 1

    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    while any(len(o) < n_new for o in outs):
        if profile_at is not None and t == profile_at:
            prof = _profile_steps(torch, step, 3)
            continue
        ts = time.perf_counter()
        step()
        sync()
        step_ms.append((time.perf_counter() - ts) * 1e3)
    sync()
    return dict(outs=outs, wall_s=time.perf_counter() - t0, step_ms=step_ms,
                profile=prof, **logits)


def deepseek_serve(torch, np, cfg, params, prompts, n_new, *, device,
                   sampled, kv="model", kv_scale=0.25, chunk=64, seed=0,
                   profile_at=None):
    """Serve ``prompts`` through ``deepseek_decode_step`` in
    ``_token_loop``, one MLA plan a step (KV chunk ``chunk``). The caches
    are bf16 (``kv="model"``) or e4m3 with ``kv_scale``. Returns
    ``_token_loop``'s dict and the caches (``ckv``, ``kpe``)."""
    from flashinfer_tpu_torch.models.deepseek import deepseek_decode_step
    from flashinfer_tpu_torch.ops.attention.mla import (
        BatchMLAPagedAttentionWrapper,
    )
    from flashinfer_tpu_torch.ops.rope import rope_cos_sin_cache

    L = cfg.num_layers
    total = max(len(p) for p in prompts) + n_new
    dt = torch.float8_e4m3fn if kv == "e4m3" else cfg.dtype
    shape = (L, _pages_needed(prompts, n_new, MLA_PAGE), MLA_PAGE)
    ckv = torch.zeros(*shape, cfg.head_dim_ckv, device=device).to(dt)
    kpe = torch.zeros(*shape, cfg.head_dim_kpe, device=device).to(dt)
    cos_sin = (rope_cos_sin_cache(total, cfg.head_dim_kpe,
                                  rope_theta=cfg.rope_theta, device=device)
               if kv == "e4m3" else None)
    sm_scale = (cfg.head_dim_qk_nope + cfg.head_dim_kpe) ** -0.5

    def forward(toks, t, indptr, indices, last, tabs):
        n = len(toks)
        w = BatchMLAPagedAttentionWrapper(device=device)
        w.plan(np.arange(n + 1), indptr, indices, np.full(n, t + 1),
               cfg.num_heads, cfg.head_dim_ckv, cfg.head_dim_kpe, MLA_PAGE,
               sm_scale=sm_scale, kv_chunk_size=chunk)
        return deepseek_decode_step(
            params, cfg, toks, torch.full((n,), t, device=device), ckv, kpe,
            *tabs, w, kv_scale=kv_scale if kv == "e4m3" else 1.0,
            cos_sin_cache=cos_sin)[0]

    return dict(_token_loop(torch, np, prompts, n_new, MLA_PAGE, forward,
                            device=device, sampled=sampled, seed=seed,
                            profile_at=profile_at), ckv=ckv, kpe=kpe)


@contextlib.contextmanager
def _step_recorder(torch, fake_e4m3_scale=None):
    """While open, ``deepseek_decode_step`` records the residual stream
    that enters each rmsnorm, after the add the norm makes (two a layer,
    then the final norm), and the experts each layer's routing picks. With
    ``fake_e4m3_scale`` s, the new c_kv and k_pe are rounded as an e4m3
    cache of scale s holds them (e4m3(v / s) * s) before they are appended
    to a bf16 cache."""
    from flashinfer_tpu_torch.models import deepseek as mod

    names = ("add_rmsnorm", "fused_add_rmsnorm", "route_tokens",
             "append_paged_mla_kv_cache")
    orig = {n: getattr(mod, n) for n in names}
    rec = dict(x=[], ids=[])

    def recorded(norm):
        def fn(*args, **kw):
            xn, x = orig[norm](*args, **kw)
            rec["x"].append(x.float())
            return xn, x
        return fn

    def route_tokens(*args, **kw):
        ids, scales = orig["route_tokens"](*args, **kw)
        rec["ids"].append(ids)
        return ids, scales

    def append_paged_mla_kv_cache(c_kv, k_pe, *args, **kw):
        if fake_e4m3_scale is not None:
            s = fake_e4m3_scale
            c_kv, k_pe = ((v.float() / s).to(torch.float8_e4m3fn).float()
                          .mul(s).to(v.dtype) for v in (c_kv, k_pe))
        return orig["append_paged_mla_kv_cache"](c_kv, k_pe, *args, **kw)

    for name, fn in zip(names, (recorded("add_rmsnorm"),
                                recorded("fused_add_rmsnorm"), route_tokens,
                                append_paged_mla_kv_cache)):
        setattr(mod, name, fn)
    try:
        yield rec
    finally:
        for name, fn in orig.items():
            setattr(mod, name, fn)


E4M3_WITNESS_TOL = 0.02  # B vs C logits, in units of the logits' std


def deepseek_e4m3_witness(torch, np, cfg, params, prompts, kv_scale=0.25,
                          device=None):
    """One decode step of every request's first token, three ways: on bf16
    caches (A), on e4m3 caches (B) and on bf16 caches fed the values an
    e4m3 cache holds (C). With one cached key, attention returns that key's
    c_kv, so B and C compute the same values: their agreement holds the
    e4m3 rope + quantize prologue, the append and the MLA kernel's e4m3
    read at full width, and fails the phase otherwise. A against B shows,
    layer by layer, how far the e4m3 rounding of c_kv alone moves the
    residual stream and the routing."""
    runs = []
    for kv, fake in (("model", None), ("e4m3", None), ("model", kv_scale)):
        with _step_recorder(torch, fake) as rec:
            res = deepseek_serve(torch, np, cfg, params,
                                 [p[:1] for p in prompts], 1,
                                 device=device or DEVICE, sampled=False,
                                 kv=kv, kv_scale=kv_scale)
        runs.append((rec, res["logits0"]))
    (ra, la), (rb, lb), (rc, lc) = runs

    def rel(x, ref):  # the largest relative L2 distance over the tokens
        return float(((x - ref).norm(dim=-1) / ref.norm(dim=-1)).max())

    def changed(ids, ref):  # routed (token, expert) picks not in ref
        return int(sum(len(set(a) - set(b))
                       for a, b in zip(ids.tolist(), ref.tolist())))

    L, std = cfg.num_layers, float(la.std())
    layers = [dict(layer=i,
                   attn_in_rel_ab=rel(rb["x"][2 * i], ra["x"][2 * i]),
                   ffn_in_rel_ab=rel(rb["x"][2 * i + 1], ra["x"][2 * i + 1]),
                   routing_changed_ab=changed(rb["ids"][i], ra["ids"][i]),
                   ffn_in_rel_bc=rel(rb["x"][2 * i + 1], rc["x"][2 * i + 1]),
                   routing_changed_bc=changed(rb["ids"][i], rc["ids"][i]))
              for i in range(L)]
    out = dict(
        layers=layers, logit_std=std,
        picks_per_layer=int(ra["ids"][0].numel()),
        final_rel_ab=rel(rb["x"][2 * L], ra["x"][2 * L]),
        logits_max_abs_ab=float((lb - la).abs().max()),
        argmax_shared_ab=int((lb.argmax(-1) == la.argmax(-1)).sum()),
        final_rel_bc=rel(rb["x"][2 * L], rc["x"][2 * L]),
        logits_max_abs_bc=float((lb - lc).abs().max()),
        argmax_shared_bc=int((lb.argmax(-1) == lc.argmax(-1)).sum()))
    for r in layers:
        if r["layer"] in (0, 1, 2, 4, 8, 16, L - 1):
            log(f"  e4m3 witness layer {r['layer']:2d}: residual into "
                f"attention {r['attn_in_rel_ab']:.4f}, into the MoE "
                f"{r['ffn_in_rel_ab']:.4f} (A vs B, relative L2); routed "
                f"picks changed {r['routing_changed_ab']} of "
                f"{out['picks_per_layer']} (A vs B), "
                f"{r['routing_changed_bc']} (B vs C)")
    log(f"deepseek e4m3 witness, first step: A (bf16) vs B (e4m3): final "
        f"residual {out['final_rel_ab']:.4f}, max |logit diff| "
        f"{out['logits_max_abs_ab']:.4f} (logit std {std:.4f}), argmax shared "
        f"{out['argmax_shared_ab']} of {len(prompts)}, routed picks changed "
        f"{sum(r['routing_changed_ab'] for r in layers)} of "
        f"{L * out['picks_per_layer']}; B vs C (bf16 fed the e4m3 values): "
        f"final residual {out['final_rel_bc']:.2e}, max |logit diff| "
        f"{out['logits_max_abs_bc']:.2e}, routed picks changed "
        f"{sum(r['routing_changed_bc'] for r in layers)}")
    if out["logits_max_abs_bc"] > E4M3_WITNESS_TOL * std:
        raise AssertionError(f"the e4m3 path disagrees with the bf16 path fed "
                             f"the same e4m3 values: {out}")
    return out


def phase_tiny_deepseek(torch, np):
    """Greedy tokens of the f32 tiny DeepSeek model, card vs CPU, on f32
    and e4m3 caches."""
    from flashinfer_tpu_torch.models.deepseek import (
        DeepSeekConfig,
        deepseek_init_weights,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = DeepSeekConfig.tiny()
    params = deepseek_init_weights(torch.Generator().manual_seed(0), cfg,
                                   "cpu")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (7, 3,
                                                                     12)]
    bad = []
    for kv in ("model", "e4m3"):
        outs = []
        for device in ("cpu", DEVICE):
            p = {k: v.to(device) for k, v in params.items()}
            outs.append(deepseek_serve(torch, np, cfg, p, prompts, 8,
                                       device=device, sampled=False, kv=kv,
                                       chunk=8)["outs"])
        same = outs[0] == outs[1]
        log(f"tiny f32 DeepSeek kv={kv:5s}: card {'==' if same else '!='} "
            f"cpu")
        if not same:
            bad.append((kv, outs))
    if bad:
        raise AssertionError(f"card and CPU DeepSeek disagree: {bad}")


def _served_modes(torch, np, name, path, serve, vocab, prompts, n_new,
                  card):
    """Serve ``prompts`` sampled and then greedy through ``serve(prompts,
    n_new, sampled=..., profile_at=...)`` (a ``_token_loop`` server),
    each run's launch counts of ``path`` zeroed just before it; three steps
    from half the shortest prompt on are traced. The sampled run fails the
    phase if a kernel of ``path`` launched no time. Returns a dict:
    ``sampled`` and ``greedy`` (tokens/s, step ms, launches, profile, peak
    memory) and their tokens under ``sampled_outs``, ``greedy_outs``."""
    results = {}
    for mode in ("sampled", "greedy"):
        counters = _reset_counts()
        run = serve(prompts, n_new, sampled=mode == "sampled",
                    profile_at=min(len(p) for p in prompts) // 2)
        outs, wall, step_ms, prof = (run["outs"], run["wall_s"],
                                     run["step_ms"], run["profile"])
        del run
        counts = {k: counters[k].launches for k in path}
        assert all(len(o) == n_new for o in outs), [len(o) for o in outs]
        assert all(0 <= t < vocab for o in outs for t in o)
        gen_tokens = sum(len(o) for o in outs)
        res = dict(tokens_per_s=gen_tokens / wall, wall_s=wall,
                   generated_tokens=gen_tokens, steps=len(step_ms) + 3,
                   step_ms_median=float(np.median(step_ms)),
                   step_ms_p90=float(np.percentile(step_ms, 90)),
                   launches=counts, profile=prof,
                   first_tokens=[o[:4] for o in outs[:3]],
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        if prof:
            prof["busy_share"] = (prof["device_ms_per_step"]
                                  / res["step_ms_median"])
        results[mode] = res
        results[f"{mode}_outs"] = outs
        log(f"{name} {mode}: {gen_tokens} tokens in {wall:.2f} s = "
            f"{res['tokens_per_s']:.1f} tokens/s over {res['steps']} steps "
            f"(prompts {[len(p) for p in prompts]} fed token by token); step "
            f"median {res['step_ms_median']:.2f} ms, p90 "
            f"{res['step_ms_p90']:.2f} ms; launches {counts}; peak memory "
            f"{res['peak_mem_gb']:.2f} GB [{card}]")
        if prof:
            log(f"{name} {mode} profile, per step at batch "
                f"{len(prompts)}: device {prof['device_ms_per_step']:.2f} ms "
                f"in {prof['device_ops_per_step']} device ops (traced wall "
                f"{prof['profiled_wall_ms_per_step']:.2f} ms), busy share "
                f"{prof['busy_share']:.3f}; by family "
                f"{json.dumps(prof['ms_per_step'])}")
            for ms, n, kname in prof["top_kernels"]:
                log(f"  device {ms:8.3f} ms  x{n:<5d} {kname}")
        else:
            log(f"{name} {mode} profile: the profiler recorded no device "
                "time (not measured)")
        missing = [k for k, n in counts.items() if n == 0]
        if mode == "sampled" and missing:
            raise AssertionError(f"kernels not launched on the {name} path: "
                                 f"{missing}")
    return results


def phase_deepseek(torch, np, card):
    from flashinfer_tpu_torch.models.deepseek import (
        DeepSeekConfig,
        deepseek_init_weights,
    )

    cfg = DeepSeekConfig(dtype=torch.bfloat16, **V2_LITE)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    t0 = time.perf_counter()
    params = deepseek_init_weights(gen, cfg, DEVICE)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params.values())
    log(f"DeepSeek-V2-Lite widths, {cfg.num_layers} layers: {n_params/1e9:.3f}"
        f"B parameters, bf16 ({n_params * 2 / 1e9:.1f} GB), "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(32, 129, 8)]

    def serve(prompts, n_new, **kw):
        return deepseek_serve(torch, np, cfg, params, prompts, n_new,
                              device=DEVICE, **kw)

    results = _served_modes(torch, np, "deepseek", DEEPSEEK_PATH, serve,
                            cfg.vocab_size, prompts, 32, card)
    n_e4m3 = 4
    run = deepseek_serve(torch, np, cfg, params, prompts, n_e4m3,
                         device=DEVICE, sampled=False, kv="e4m3")
    want = [o[:n_e4m3] for o in results["greedy_outs"]]
    first = sum(a[0] == b[0] for a, b in zip(run["outs"], want))
    agree = float(np.mean(np.asarray(run["outs"]) == np.asarray(want)))
    results["e4m3"] = dict(first_tokens_shared=first, agreement=agree,
                           step_ms_median=float(np.median(run["step_ms"])))
    log(f"deepseek e4m3 caches (scale 0.25), greedy: {first} of "
        f"{len(prompts)} first tokens shared with bf16, {agree:.3f} of the "
        f"first {n_e4m3}; step median {np.median(run['step_ms']):.2f} ms")
    del run
    results["e4m3_witness"] = deepseek_e4m3_witness(torch, np, cfg, params,
                                                    prompts)
    results["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params
    torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------------ Mixtral

# Mixtral-8x7B's published widths (MixtralConfig's defaults: huggingface.co/
# mistralai/Mixtral-8x7B-v0.1, config.json) at 16 of its 32 layers: the 32
# layers' bf16 weights are ~93 GB, more than the card's 80; 16 are ~46.5 GB
MIXTRAL_LAYERS = 16
MIXTRAL_PAGE = 16
MIXTRAL_KV_CHUNK = 64


def mixtral_serve(torch, np, cfg, params, prompts, n_new, *, device,
                  sampled, page_size=MIXTRAL_PAGE, chunk=MIXTRAL_KV_CHUNK,
                  seed=0, profile_at=None):
    """Serve ``prompts`` through ``mixtral_decode_step`` in ``_token_loop``:
    NHD caches [L, pages, page_size, kv heads, head_dim] in the model
    dtype, a fresh ``BatchDecodeWithPagedKVCacheWrapper`` plan a step (KV
    chunk ``chunk``). Returns ``_token_loop``'s dict and the caches (``k``,
    ``v``)."""
    from flashinfer_tpu_torch.models.mixtral import mixtral_decode_step
    from flashinfer_tpu_torch.ops.attention.batch import (
        BatchDecodeWithPagedKVCacheWrapper,
    )

    shape = (cfg.num_layers, _pages_needed(prompts, n_new, page_size),
             page_size, cfg.num_kv_heads, cfg.head_dim)
    kc = torch.zeros(shape, dtype=cfg.dtype, device=device)
    vc = torch.zeros_like(kc)

    def forward(toks, t, indptr, indices, last, tabs):
        w = BatchDecodeWithPagedKVCacheWrapper(kv_layout="NHD",
                                               device=device)
        w.plan(indptr, indices, last, cfg.num_qo_heads, cfg.num_kv_heads,
               cfg.head_dim, page_size, kv_chunk_size=chunk)
        return mixtral_decode_step(
            params, cfg, toks, torch.full((len(toks),), t, device=device),
            (kc, vc), *tabs, w)[0]

    return dict(_token_loop(torch, np, prompts, n_new, page_size, forward,
                            device=device, sampled=sampled, seed=seed,
                            profile_at=profile_at), k=kc, v=vc)


def phase_tiny_mixtral(torch, np):
    """Greedy tokens of the f32 tiny Mixtral, card (every kernel on) vs CPU
    (every plain version), and the card run's launches of the kernels on
    its path."""
    from flashinfer_tpu_torch.models.mixtral import (
        MixtralConfig,
        mixtral_init_weights,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = MixtralConfig.tiny()
    params = mixtral_init_weights(torch.Generator().manual_seed(0), cfg,
                                  "cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (7, 3, 12)]
    outs = []
    for device in ("cpu", DEVICE):
        counters = _reset_counts()
        p = {k: v.to(device) for k, v in params.items()}
        outs.append(mixtral_serve(torch, np, cfg, p, prompts, 8,
                                  device=device, sampled=False, page_size=8,
                                  chunk=8)["outs"])
    counts = {k: counters[k].launches for k in MIXTRAL_PATH
              if k != "sampler_family"}  # greedy: no draw
    same = outs[0] == outs[1]
    log(f"tiny f32 Mixtral: card {'==' if same else '!='} cpu; card "
        f"launches {counts}")
    if not same or not all(counts.values()):
        raise AssertionError(f"card and CPU Mixtral disagree, or a kernel "
                             f"did not launch: {outs} {counts}")


def phase_mixtral(torch, np, card):
    from flashinfer_tpu_torch.models.mixtral import (
        MixtralConfig,
        mixtral_init_weights,
    )

    cfg = MixtralConfig(num_layers=MIXTRAL_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    t0 = time.perf_counter()
    params = mixtral_init_weights(gen, cfg, DEVICE)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params.values())
    log(f"Mixtral-8x7B widths, {cfg.num_layers} of 32 layers: "
        f"{n_params / 1e9:.3f}B parameters, bf16 ({n_params * 2 / 1e9:.1f} "
        f"GB), {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(32, 129, 8)]

    def serve(prompts, n_new, **kw):
        return mixtral_serve(torch, np, cfg, params, prompts, n_new,
                             device=DEVICE, **kw)

    results = _served_modes(torch, np, "mixtral", MIXTRAL_PATH, serve,
                            cfg.vocab_size, prompts, 32, card)
    results["weights_gb"] = n_params * 2 / 1e9
    results["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params
    torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------------ cascade

# 32 requests share a 4096-token prefix (level 0, one group, not causal)
# and each reads its own suffix of 64-512 tokens (level 1, causal), at
# Llama-3-8B's attention widths, bf16, page 16, KV chunk 512
CASCADE_REQUESTS = 32
CASCADE_PREFIX = 4096
CASCADE_SUFFIX = (64, 512)
CASCADE_PAGE = 16
CASCADE_KV_CHUNK = 512
# (mode, query tokens a request, layouts)
CASCADE_MODES = (("decode", 1, ("NHD", "HND")), ("append", 16, ("NHD",)))


def _cascade_tables(np):
    """The cascade's page tables: prefix pages 0..255 shared, then each
    request's suffix pages, in a seeded permutation of the pool. Returns
    (num_pages, suffix lengths, level tables, flat table); a table is
    (kv_indptr, kv_indices, kv_last_page_len)."""
    ps = CASCADE_PAGE
    rng = np.random.default_rng(13)
    suffix = rng.integers(CASCADE_SUFFIX[0], CASCADE_SUFFIX[1] + 1,
                          CASCADE_REQUESTS)
    n_pre = CASCADE_PREFIX // ps
    n_suf = -(-suffix // ps)
    num_pages = n_pre + int(n_suf.sum())
    perm = rng.permutation(num_pages)
    pre_pages, suf_pages = perm[:n_pre], perm[n_pre:]
    suf_indptr = np.concatenate([[0], np.cumsum(n_suf)])
    last = suffix - (n_suf - 1) * ps
    level0 = (np.array([0, n_pre]), pre_pages, np.array([ps]))
    level1 = (suf_indptr, suf_pages, last)
    flat_indices = np.concatenate([
        np.concatenate([pre_pages, suf_pages[a:b]])
        for a, b in zip(suf_indptr[:-1], suf_indptr[1:])])
    flat = (suf_indptr + n_pre * np.arange(CASCADE_REQUESTS + 1),
            flat_indices, last)
    return num_pages, suffix, (level0, level1), flat


def phase_cascade(torch, np, card):
    """``MultiLevelCascadeAttentionWrapper`` (two levels) against flat
    ``BatchAttention`` over the concatenated page tables (the prefix's
    pages named in every request), both modes: o and lse to the attention
    tolerances, and against the f32 oracle (``attention_reference`` over
    each request's keys); each level's and the flat plan's kernel launch
    against its plain version on the same plan; cascade and flat timed
    with CUDA events over caches rotated through ``LAYERS_ROTATED`` copies
    (a CUDA graph of 10 calls, and eager), each beside the byte bound of
    the function (every key read once) and of what the flat plan reads (the
    prefix once a request), and traced (device time by kernel family). The
    cascade path's launch counts are read from each layout's first cascade
    run, counts zeroed just before each."""
    from flashinfer_tpu_torch.ops.attention.batch import (
        BatchAttention,
        pack_queries,
    )
    from flashinfer_tpu_torch.ops.attention.cascade import (
        MultiLevelCascadeAttentionWrapper,
    )
    from flashinfer_tpu_torch.ops.attention.kernels.paged import (
        batch_paged_attention_run,
    )
    from flashinfer_tpu_torch.ops.attention.reference import (
        attention_reference,
    )
    from flashinfer_tpu_torch.utils import TensorLayout

    hq, hkv, d = LLAMA_HEADS
    ps, nreq = CASCADE_PAGE, CASCADE_REQUESTS
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(17)
    num_pages, suffix, levels, flat = _cascade_tables(np)
    kv_lens = CASCADE_PREFIX + suffix
    launches = {"paged_attention": 0}
    rows = []
    for mode, qo, layouts in CASCADE_MODES:
        qo_indptr = np.arange(nreq + 1) * qo
        nnz = nreq * qo
        q = torch.randn(nnz, hq, d, device=dev, generator=gen,
                        dtype=torch.bfloat16)
        for layout in layouts:
            shape = ((LAYERS_ROTATED * num_pages, hkv, ps, d)
                     if layout == "HND"
                     else (LAYERS_ROTATED * num_pages, ps, hkv, d))
            kc, vc = (torch.randn(shape, device=dev, generator=gen,
                                  dtype=torch.bfloat16) for _ in range(2))
            kw = dict(kv_chunk_size=CASCADE_KV_CHUNK)
            casc = MultiLevelCascadeAttentionWrapper(
                2, kv_layout=layout, device=DEVICE).plan(
                    [np.array([0, nnz]), qo_indptr],
                    *zip(*levels), hq, hkv, d, ps, causal=True, **kw)
            flat_w = BatchAttention(kv_layout=layout, device=DEVICE).plan(
                qo_indptr, *flat, hq, hkv, d, ps, causal=True, **kw)
            layer = [0]

            def cache(rotate=True):
                off = (layer[0] % LAYERS_ROTATED) * num_pages
                if rotate:
                    layer[0] += 1
                return kc[off:off + num_pages], vc[off:off + num_pages]

            def run(w, rotate=True):
                return w.run(q, cache(rotate), return_lse=True)

            counters = _reset_counts()
            got = run(casc, rotate=False)
            launches["paged_attention"] += counters[
                "paged_attention"].launches
            want = run(flat_w, rotate=False)
            torch.cuda.synchronize()
            chk = _attn_check(torch, got, want)
            # the f32 oracle, request by request
            k0, v0 = cache(rotate=False)
            if layout == "HND":
                k0, v0 = k0.transpose(1, 2), v0.transpose(1, 2)
            ind, idx = flat[0], flat[1]
            ref_o, ref_lse = [], []
            for r in range(nreq):
                pages = torch.from_numpy(idx[ind[r]:ind[r + 1]]).to(dev)
                kr = k0[pages].reshape(-1, hkv, d)[:kv_lens[r]]
                vr = v0[pages].reshape(-1, hkv, d)[:kv_lens[r]]
                o_r, l_r = attention_reference(q[r * qo:(r + 1) * qo].float(),
                                               kr.float(), vr.float(),
                                               causal=True)
                ref_o.append(o_r)
                ref_lse.append(l_r)
            oracle = _attn_check(torch, got, (torch.cat(ref_o),
                                              torch.cat(ref_lse)))
            # each plan's kernel launch against its plain version, timed
            # alone beside its bound: every key it reads once (the flat
            # plan names the prefix's pages in every request, but reading
            # them once is the least it must move)
            plain = []
            n_pre = len(levels[0][1])
            once = np.concatenate([[CASCADE_PREFIX], suffix])
            for label, w, lens, qos, keys, pages in (
                    ("level0", casc.levels[0], [CASCADE_PREFIX], [nnz],
                     once[:1], n_pre),
                    ("level1", casc.levels[1], suffix, [qo] * nreq, suffix,
                     num_pages - n_pre),
                    ("flat", flat_w, kv_lens, [qo] * nreq, once,
                     len(flat[1]))):
                dp = w.device_plan
                m = dp.meta
                qp = pack_queries(dp, q)
                pkw = dict(tile_q=m.tile_q, group=hq // hkv, causal=m.causal,
                           sm_scale=m.sm_scale,
                           kv_layout=TensorLayout[layout],
                           row_valid=dp.segment("row_valid"))
                tabs = (dp.segment("kv_indices"), dp.segment("plan"))

                def launch(fn, rotate=True):
                    return fn(qp, *cache(rotate), *tabs, **pkw)

                def plain_fn(*args, **kw_):
                    return _paged_plain(torch, *args, **kw_)

                c = _attn_check(torch, launch(batch_paged_attention_run,
                                              rotate=False),
                                launch(plain_fn, rotate=False))
                k_ms = cuda_ms(torch, lambda: launch(
                    batch_paged_attention_run), 20, graph=True)
                p_ms = cuda_ms(torch, lambda: launch(plain_fn), 2, warmup=1)
                pairs = (_attention_work(lens, qos, hq) if m.causal else
                         sum(int(a) * int(b) for a, b in zip(lens, qos)) * hq)
                p_bytes = _attention_bytes(tabs[1], pages, keys, m.tile_q,
                                           hkv, d, 2)
                pb_ms, pb_by = bound_ms(p_bytes, 4 * d * pairs)
                plain.append(dict(plan=label, tile_q=m.tile_q,
                                  T=m.num_work_items, splits=m.max_splits,
                                  ms=k_ms, plain_ms=p_ms, bound_ms=pb_ms,
                                  bound_by=pb_by, **c))
            torch.cuda.synchronize()
            del got, want, ref_o, ref_lse
            ms = {name: cuda_ms(torch, lambda w=w: run(w), 10, graph=True)
                  for name, w in (("cascade", casc), ("flat", flat_w))}
            call_ms = {name: cuda_ms(torch, lambda w=w: run(w), 10)
                       for name, w in (("cascade", casc), ("flat", flat_w))}
            # device time by kernel family: the paged kernel against the
            # plain PyTorch around it (q packing, split merges, level merge)
            fams = {}
            for name, w in (("cascade", casc), ("flat", flat_w)):
                prof = _profile_steps(torch, lambda w=w: run(w), 3)
                fams[name] = prof and dict(
                    device_ms=prof["device_ms_per_step"],
                    device_ops=prof["device_ops_per_step"],
                    by_family=prof["ms_per_step"])
            tok_bytes = 2 * hkv * d * 2  # K and V of a token, bf16
            qo_bytes = nnz * hq * (2 * d * 2 + 4)  # q read, o and lse out
            nbytes = int(kv_lens.sum() - (nreq - 1) * CASCADE_PREFIX) \
                * tok_bytes + qo_bytes
            flat_bytes = int(kv_lens.sum()) * tok_bytes + qo_bytes
            ops = 4 * d * _attention_work(kv_lens, [qo] * nreq, hq)
            b_ms, b_by = bound_ms(nbytes, ops)
            ok = chk["ok"] and oracle["ok"] and all(x["ok"] for x in plain)
            row = dict(mode=mode, layout=layout, qo=qo, nnz=nnz,
                       kv_tokens=int(kv_lens.sum()), vs_flat=chk,
                       vs_oracle=oracle, plain=plain, ms=ms, call_ms=call_ms,
                       bound_bytes=nbytes, flat_bytes=flat_bytes,
                       bound_ops=ops, bound_ms=b_ms, bound_by=b_by,
                       flat_bytes_ms=flat_bytes / HBM_BYTES_PER_S * 1e3,
                       profile=fams, ok=ok)
            rows.append(row)
            log(f"cascade {mode:6s} {layout} q={list(q.shape)} prefix "
                f"{CASCADE_PREFIX} + suffixes {int(suffix.min())}-"
                f"{int(suffix.max())}: vs flat err_o={chk['err_o']:.2e} "
                f"(limit ratio {chk['o_ratio']:.3f}) err_lse="
                f"{chk['err_lse']:.2e}; vs f32 oracle err_o="
                f"{oracle['err_o']:.2e} (limit ratio "
                f"{oracle['o_ratio']:.3f}) err_lse={oracle['err_lse']:.2e}; "
                f"cascade ms={ms['cascade']:.4f} call_ms="
                f"{call_ms['cascade']:.4f}; flat ms={ms['flat']:.4f} "
                f"call_ms={call_ms['flat']:.4f}; bound_ms={b_ms:.5f} ({b_by}; "
                f"the flat plan's reads {row['flat_bytes_ms']:.5f} ms at the "
                f"byte rate) {'ok' if ok else 'MISMATCH'} [{card}]")
            for name, f in fams.items():
                log(f"  {name} profile, a call: " + (
                    f"device {f['device_ms']:.4f} ms in {f['device_ops']} "
                    f"ops; by family {json.dumps(f['by_family'])}" if f
                    else "the profiler recorded no device time (not "
                    "measured)"))
            for x in plain:
                log(f"  paged_attention {x['plan']:6s} tile_q={x['tile_q']} "
                    f"T={x['T']} splits={x['splits']} vs plain err_o="
                    f"{x['err_o']:.2e} (limit ratio {x['o_ratio']:.3f}) "
                    f"err_lse={x['err_lse']:.2e} ms={x['ms']:.4f} plain_ms="
                    f"{x['plain_ms']:.3f} bound_ms={x['bound_ms']:.5f} "
                    f"({x['bound_by']}) {'ok' if x['ok'] else 'MISMATCH'}")
            del kc, vc
            torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"cascade attention disagrees: {bad}")
    return dict(rows=rows, launches=launches)


# ------------------------------------------------------------ paged surface

SURFACE_PAGE = 16
SURFACE_CHUNK = 512
# GPT-OSS-120B attention (huggingface.co/openai/gpt-oss-120b config.json:
# num_attention_heads 64, num_key_value_heads 8, head_dim 64,
# sliding_window 128)
GPT_OSS_HEADS = (64, 8, 64)
GPT_OSS_WINDOW = 128
# MPT-7B attention (huggingface.co/mosaicml/mpt-7b config.json: n_heads 32,
# d_model 4096, ALiBi, no GQA)
MPT_7B_HEADS = (32, 32, 128)
# token counts of the cases: contexts and draft of the tree verify step;
# prefix, items and item length of multi-item scoring; the sink decode's
# keys and prefill's tokens; ALiBi's prompts; the ragged prompts' and the
# small pages' key range; the BSR side and block; the variable blocks'
# side and extents
SURFACE_SIZES = dict(tree=(512, 4096, 64), multi_item=(1024, 64, 16),
                     sink=(4096, 2048), alibi=1024, ragged=(512, 4096),
                     small_pages=(1024, 4096), bsr=(8192, 64),
                     variable=(4096, 32, 256))
SURFACE_CASES = ("tree_verify", "multi_item", "sink_decode", "sink_prefill",
                 "alibi_prefill", "alibi_decode", "ragged", "page1_decode",
                 "page4_decode", "bsr", "variable_bsr", "chunk_none_decode",
                 "chunk_none_prefill")


def _paged_table(np, rng, lens, ps):
    """(kv_indptr, kv_indices: a seeded permutation of the pool, last page
    lengths, pool pages) of requests of ``lens`` tokens on pages of ps."""
    lens = np.asarray(lens, np.int64)
    npages = -(-lens // ps)
    indptr = np.concatenate([[0], np.cumsum(npages)])
    pool = int(indptr[-1])
    return indptr, rng.permutation(pool), lens - (npages - 1) * ps, pool


def _block_sizes(np, rng, total, lo, hi):
    """Block extents in [lo, hi] summing to ``total`` (the last one cut)."""
    sizes = []
    while sum(sizes) < total:
        sizes.append(int(rng.integers(lo, hi + 1)))
    sizes[-1] -= sum(sizes) - total
    return np.asarray(sizes, np.int64)


def _surface_case(torch, np, name, lens_decode, lens_prefill):
    """One case of the paged-surface phase: a dict of its heads, a wrapper
    factory ``make(backend)``, the plan's (args, kw), q, the run inputs of
    cache copy i (``inputs(i)``: what ``run`` takes after q) and the kv
    cache ``BatchAttention.run`` sees for them (``kv_cache(i)``)."""
    from flashinfer_tpu_torch.ops.attention import batch, sparse
    from flashinfer_tpu_torch.ops.attention.single import (
        default_alibi_slopes,
    )
    from flashinfer_tpu_torch.ops.attention.variants import (
        make_default_variant,
    )

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SURFACE_CASES.index(name))
    rng = np.random.default_rng(31 + SURFACE_CASES.index(name))
    hq, hkv, d = LLAMA_HEADS
    ps, L = SURFACE_PAGE, LAYERS_ROTATED

    def rand(*shape):
        return torch.randn(*shape, device=dev, generator=gen,
                           dtype=torch.bfloat16)

    def paged(pool, ps_=ps, heads=None):
        hk, dd = heads or (hkv, d)
        kvs = [(rand(pool, ps_, hk, dd), rand(pool, ps_, hk, dd))
               for _ in range(L)]
        return dict(inputs=lambda i: (kvs[i],), kv_cache=lambda i: kvs[i])

    def wrapper(cls, **kw):
        return lambda b: cls(kv_layout="NHD", backend=b, device=DEVICE, **kw)

    kw = dict(kv_chunk_size=SURFACE_CHUNK)
    c = dict(heads=(hq, hkv, d))
    size = SURFACE_SIZES
    if name == "tree_verify":  # 8 requests: context + a 64-token draft tree
        lo, hi, draft = size["tree"]
        ctx = rng.integers(lo, hi + 1, 8)
        masks = []
        for n in ctx:
            anc = np.eye(draft, dtype=bool)  # node i: itself and ancestors
            for i in range(1, draft):
                anc[i] |= anc[rng.integers(0, i)]
            masks.append(np.concatenate([np.ones((draft, n), bool), anc], 1))
        indptr, idx, last, pool = _paged_table(np, rng, ctx + draft, ps)
        bits = np.concatenate([m.ravel() for m in masks])
        c.update(make=wrapper(batch.BatchPrefillWithPagedKVCacheWrapper),
                 plan=((np.arange(9) * draft, indptr, idx, last, hq, hkv, d,
                        ps),
                       dict(kw, packed_custom_mask=np.packbits(bits),
                            mask_indptr=np.concatenate(
                                [[0], np.cumsum([m.size for m in masks])]))),
                 q=rand(8 * draft, hq, d), **paged(pool))
    elif name == "multi_item":  # 1024-token prefix + 64 items of 16
        prefix, items, item_len = size["multi_item"]
        n = prefix + items * item_len
        indptr, idx, last, pool = _paged_table(np, rng, [n, n], ps)
        tpos = np.tile(np.arange(item_len), 2 * items)  # delimiter first
        c.update(make=wrapper(batch.BatchPrefillWithPagedKVCacheWrapper),
                 plan=((np.asarray([0, n, 2 * n]), indptr, idx, last, hq,
                        hkv, d, ps),
                       dict(kw, causal=True,
                            prefix_len_ptr=np.asarray([prefix, prefix]),
                            token_pos_in_items_ptr=tpos,
                            token_pos_in_items_len=items * item_len)),
                 q=rand(2 * n, hq, d), **paged(pool))
    elif name.startswith("sink"):  # GPT-OSS: sinks, a 128-token window
        hq, hkv, d = GPT_OSS_HEADS
        sink = torch.randn(hq, device=dev, generator=gen)
        keys, prompt = size["sink"]
        lens, qo = (([keys] * 8, np.arange(9)) if name == "sink_decode"
                    else ([prompt], np.asarray([0, prompt])))
        indptr, idx, last, pool = _paged_table(np, rng, lens, ps)
        c.update(heads=(hq, hkv, d), sink=sink,
                 make=lambda b: batch.BatchAttentionWithAttentionSinkWrapper(
                     sink, kv_layout="NHD", backend=b, device=DEVICE),
                 plan=((qo, indptr, idx, last, hq, hkv, d, ps),
                       dict(kw, causal=name == "sink_prefill",
                            window_left=GPT_OSS_WINDOW - 1)),
                 q=rand(int(qo[-1]), hq, d), **paged(pool, heads=(hkv, d)))
    elif name.startswith("alibi"):  # MPT-7B: ALiBi, no GQA
        hq, hkv, d = MPT_7B_HEADS
        variant = make_default_variant(use_alibi=True)
        slopes = default_alibi_slopes(hq, DEVICE)
        prefill = name == "alibi_prefill"
        n = size["alibi"]
        lens = [n] * 8 if prefill else [n + 1] * 8
        indptr, idx, last, pool = _paged_table(np, rng, lens, ps)
        cls = (batch.BatchPrefillWithPagedKVCacheWrapper if prefill
               else batch.BatchDecodeWithPagedKVCacheWrapper)
        args = (indptr, idx, last, hq, hkv, d, ps)
        if prefill:
            args = (np.arange(9) * n,) + args
        c.update(heads=(hq, hkv, d), alibi=slopes,
                 make=wrapper(cls, variant=variant),
                 plan=(args, dict(kw, causal=prefill,
                                  variant_params={"alibi_slopes": slopes})),
                 q=rand(8 * n if prefill else 8, hq, d),
                 **paged(pool, heads=(hkv, d)))
    elif name == "ragged":  # contiguous K/V, 8 prompts, causal
        lo, hi = size["ragged"]
        ind = np.concatenate([[0], np.cumsum(rng.integers(lo, hi + 1, 8))])
        kvs = [(rand(int(ind[-1]), hkv, d), rand(int(ind[-1]), hkv, d))
               for _ in range(L)]
        c.update(make=lambda b: batch.BatchPrefillWithRaggedKVCacheWrapper(
                     backend=b, device=DEVICE),
                 plan=((ind, ind, hq, hkv, d), dict(kw, causal=True)),
                 q=rand(int(ind[-1]), hq, d), inputs=lambda i: kvs[i],
                 kv_cache=lambda i: tuple(t[:, None] for t in kvs[i]))
    elif name in ("page1_decode", "page4_decode"):  # token slots permuted
        ps1 = 1 if name == "page1_decode" else 4
        lo, hi = size["small_pages"]
        indptr, idx, last, pool = _paged_table(
            np, rng, rng.integers(lo, hi + 1, 8), ps1)
        c.update(make=wrapper(batch.BatchDecodeWithPagedKVCacheWrapper),
                 plan=((indptr, idx, last, hq, hkv, d, ps1), kw),
                 q=rand(8, hq, d), **paged(pool, ps1))
    elif name in ("bsr", "variable_bsr"):
        if name == "bsr":  # R = C blocks, ~10% of them
            n, R = size["bsr"]
            C = R
            rows = cols = np.full(n // R, R)
        else:  # blocks of varying extents, ~20%
            n, lo, hi = size["variable"]
            rows = _block_sizes(np, rng, n, lo, hi)
            cols = _block_sizes(np, rng, n, lo, hi)
        m = rng.random((len(rows), len(cols))) < (0.1 if name == "bsr"
                                                  else 0.2)
        m[np.arange(len(rows)), rng.integers(0, len(cols), len(rows))] = True
        kvs = [(rand(n, hkv, d), rand(n, hkv, d)) for _ in range(L)]
        if name == "bsr":
            def make(b):
                return sparse.BlockSparseAttentionWrapper(backend=b,
                                                          device=DEVICE)
            plan = ((np.concatenate([[0], np.cumsum(m.sum(1))]),
                     np.nonzero(m)[1], n, n, R, C, hq, hkv, d), kw)
            def view(i):
                return tuple(t.reshape(n // C, C, hkv, d) for t in kvs[i])
        else:
            def make(b):
                return sparse.VariableBlockSparseAttentionWrapper(
                    backend=b, device=DEVICE)
            plan = ((m, rows, cols, hq, hkv, d), kw)
            def view(i):
                return tuple(t[:, None] for t in kvs[i])
        c.update(make=make, plan=plan, q=rand(n, hq, d),
                 inputs=lambda i: kvs[i], kv_cache=view)
    elif name in ("chunk_none_decode", "chunk_none_prefill"):
        decode = name == "chunk_none_decode"
        lens = lens_decode if decode else lens_prefill
        indptr, idx, last, pool = _paged_table(np, rng, lens, ps)
        cls = (batch.BatchDecodeWithPagedKVCacheWrapper if decode
               else batch.BatchPrefillWithPagedKVCacheWrapper)
        args = (indptr, idx, last, hq, hkv, d, ps)
        if not decode:
            args = (np.concatenate([[0], np.cumsum(lens)]),) + args
        c.update(make=wrapper(cls), plan=(args, dict(causal=not decode)),
                 q=rand(len(lens) if decode else int(sum(lens)), hq, d),
                 **paged(pool))
    return c


def _surface_work(np, w):
    """(query-head, key) pairs the plan's mask keeps, and the distinct key
    tokens they read (a token: its page and slot in the caller's table),
    from the wrapper's host copy of its requests."""
    h, m = w._state.host, w.device_plan.meta
    qo_ind, kv_ind, kv_idx = h["qo_indptr"], h["kv_indptr"], h["kv_indices"]
    pairs, tokens = 0, []
    for r in range(len(qo_ind) - 1):
        qo, kv = int(qo_ind[r + 1] - qo_ind[r]), int(h["kv_lens"][r])
        keep = _keep_matrix(np, m, h["req_masks"], r, qo, kv)
        pairs += int(keep.sum())
        cols = np.nonzero(keep.any(0))[0]
        ps = h["page_size"]
        tokens.append(kv_idx[kv_ind[r] + cols // ps] * ps + cols % ps)
    keys = len(np.unique(np.concatenate(tokens))) if tokens else 0
    return pairs * m.num_qo_heads, keys


def _keep_matrix(np, meta, masks, r, qo, kv):
    """Request r's [qo, kv] keep mask: causal, window and its own mask."""
    q_pos = (kv - qo + np.arange(qo))[:, None]
    k_pos = np.arange(kv)[None, :]
    keep = np.ones((qo, kv), bool)
    if meta.causal:
        keep &= k_pos <= q_pos
    if meta.window_left >= 0:
        keep &= k_pos > q_pos - meta.window_left - 1
    if masks is not None:
        keep &= masks[r]
    return keep


def _mask_input_bytes(np, plan_kw):
    """Bytes of the mask the caller hands the function: the packed custom
    mask's bits (a dense one counted as bits too) and the int32 index
    arrays of either form. The work mask the plan legalises them into is
    reported beside it, not counted in the bound."""
    n = 0
    for key, v in plan_kw.items():
        if v is None:
            continue
        if key == "packed_custom_mask":
            n += np.asarray(v).size
        elif key == "custom_mask":
            n += -(-np.asarray(v).size // 8)
        elif key in ("mask_indptr", "prefix_len_ptr",
                     "token_pos_in_items_ptr", "max_item_len_ptr"):
            n += 4 * np.asarray(v).size
    return n


def _surface_library(torch, np, w, c, q, kv_cache):
    """One ``scaled_dot_product_attention`` call a request over its keys
    (gathered beforehand, not timed) with its boolean keep mask (ALiBi: a
    bf16 bias with -inf where masked); None where no such call exists (the
    sinks)."""
    import torch.nn.functional as F

    if "sink" in c:
        return None
    h, m = w._state.host, w.device_plan.meta
    keys = w._request_keys(kv_cache)
    calls = []
    for r in range(len(h["qo_indptr"]) - 1):
        a, b = int(h["qo_indptr"][r]), int(h["qo_indptr"][r + 1])
        kr, vr = (t.transpose(0, 1)[None] for t in keys(r))
        keep = torch.from_numpy(_keep_matrix(
            np, m, h["req_masks"], r, b - a, kr.shape[2])).to(q.device)
        mask = keep
        if "alibi" in c:
            rel = (torch.arange(kr.shape[2], device=q.device)[None, :]
                   - (kr.shape[2] - (b - a)
                      + torch.arange(b - a, device=q.device))[:, None])
            bias = c["alibi"][:, None, None] * rel[None].float()
            mask = torch.where(keep, bias, float("-inf")).bfloat16()
        calls.append((q[a:b].transpose(0, 1)[None], kr, vr, mask))

    def run():
        return [F.scaled_dot_product_attention(
                    qr, kr, vr, attn_mask=mk, scale=m.sm_scale,
                    enable_gqa=True) for qr, kr, vr, mk in calls]
    return run


def phase_paged_surface(torch, np, card, lens_decode, lens_prefill):
    """The paged-attention surface at full width, each case through the
    wrapper a user calls (the surface path: its paged launches are read
    from each case's first run, counts zeroed just before it): a tree
    verify step under a packed custom mask, multi-item scoring, GPT-OSS
    sinks with a 128-token window (decode and prefill), MPT-7B ALiBi
    (prefill and decode), ragged prefill, pages of 1 and 4, BSR and
    variable block-sparse, and ``kv_chunk_size=None`` on the engine's
    decode and prefill batches. Each case: the wrapper against the f32
    oracle (its reference backend on f32 copies of q and the caches), its
    kernel launch against ``paged_attention_plain`` on the same inputs (the
    ATTN limits), the launch timed in a CUDA graph over caches rotated
    through ``LAYERS_ROTATED`` copies beside its bound (each key the mask
    keeps read once, the caller's mask, q, o and lse; the kept pairs'
    operations at the bf16 rate), the wrapper's call, the plain version,
    SDPA a call a request and, where the wrapper gathers its keys (small
    pages, ragged KV, variable blocks), the gather alone."""
    from flashinfer_tpu_torch.ops.attention.batch import (
        kernel_caches,
        pack_queries,
    )
    from flashinfer_tpu_torch.ops.attention.kernels.paged import (
        batch_paged_attention_run,
    )

    L = LAYERS_ROTATED
    launches = {"paged_attention": 0}
    rows = []
    for name in SURFACE_CASES:
        c = _surface_case(torch, np, name, lens_decode, lens_prefill)
        hq, hkv, d = c["heads"]
        q = c["q"]
        w = c["make"]("auto").plan(*c["plan"][0], **c["plan"][1])
        counters = _reset_counts()
        got = w.run(q, *c["inputs"](0), return_lse=True)
        n_launch = counters["paged_attention"].launches
        launches["paged_attention"] += n_launch
        ref = c["make"]("reference").plan(*c["plan"][0], **c["plan"][1])

        def f32(abs_v):  # copy 0's run inputs in f32 (|v| with abs_v)
            x = c["inputs"](0)
            k, v = x[0] if len(x) == 1 else x
            kv = (k.float(), v.float().abs() if abs_v else v.float())
            return (kv,) if len(x) == 1 else kv

        mag = ref.run(q.float(), *f32(True))
        oracle = _attn_check(torch, got, ref.run(q.float(), *f32(False),
                                                 return_lse=True), mag)
        del ref, mag
        dp, st = w.device_plan, w._state
        m = dp.meta
        views = [kernel_caches(dp, *c["kv_cache"](i), w._layout)[:3]
                 for i in range(L)]
        qp = pack_queries(dp, q)
        tabs = (dp.segment("kv_indices"), dp.segment("plan"))
        kw = dict(tile_q=m.tile_q, group=m.gqa_group, causal=m.causal,
                  sm_scale=m.sm_scale, window_left=m.window_left,
                  row_valid=dp.segment("row_valid"), work_mask=dp.work_mask,
                  variant=st.variant, variant_params=st.variant_params)
        turn = [0]

        def copy(rotate=True):  # the cache copy of this call
            turn[0] += rotate
            return turn[0] % L

        def launch(fn, rotate=True):
            kc, vc, layout = views[copy(rotate)]
            return fn(qp, kc, vc, *tabs, kv_layout=layout, **kw)

        items = max(1, int(2 ** 31 // (m.num_kv_heads * m.tile_q
                                       * m.kv_chunk_size * 4)))

        def plain(*args, **kw_):
            return _paged_plain(torch, *args, items=items, **kw_)

        chk = _attn_check(torch, launch(batch_paged_attention_run, False),
                          launch(plain, False))
        torch.cuda.synchronize()
        ms = cuda_ms(torch, lambda: launch(batch_paged_attention_run), 10,
                     graph=True)
        call_ms = cuda_ms(torch, lambda: w.run(q, *c["inputs"](copy())), 5)
        repack_ms = None
        if name in ("ragged", "page1_decode", "page4_decode",
                    "variable_bsr"):
            repack_ms = cuda_ms(torch, lambda: kernel_caches(
                dp, *c["kv_cache"](copy()), w._layout), 10, graph=True)
        plain_ms = cuda_ms(torch, lambda: launch(plain), 1, warmup=1)
        lib = _surface_library(torch, np, w, c, q, c["kv_cache"](0))
        library_ms = cuda_ms(torch, lib, 3, warmup=1) if lib else None
        del lib
        pairs, keys = _surface_work(np, w)
        mask_bytes = _mask_input_bytes(np, c["plan"][1])
        work_mask_bytes = (0 if dp.work_mask is None
                           else dp.work_mask.numel())
        nbytes = (keys * hkv * 2 * d * 2 + m.nnz * hq * (2 * d * 2 + 4)
                  + mask_bytes)
        b_ms, b_by = bound_ms(nbytes, 4 * d * pairs)
        ok = chk["ok"] and oracle["ok"] and n_launch == 1
        row = dict(case=name, heads=[hq, hkv, d], nnz=m.nnz,
                   q_shape=list(qp.shape), T=m.num_work_items,
                   tile_q=m.tile_q, chunk=m.kv_chunk_size,
                   splits=m.max_splits, page_size=m.page_size,
                   mask_bytes=mask_bytes, work_mask_bytes=work_mask_bytes,
                   kept_pairs=pairs, keys=keys,
                   launches=n_launch, vs_plain=chk, vs_oracle=oracle, ms=ms,
                   call_ms=call_ms, repack_ms=repack_ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_bytes=nbytes,
                   bound_ops=4 * d * pairs, bound_ms=b_ms, bound_by=b_by,
                   err_o=chk["err_o"], ok=ok)
        rows.append(row)
        log(f"surface {name:18s} heads={hq}/{hkv}/{d} nnz={m.nnz} "
            f"T={m.num_work_items} tile_q={m.tile_q} chunk="
            f"{m.kv_chunk_size} splits={m.max_splits} page={m.page_size} "
            f"mask={mask_bytes} B work_mask={work_mask_bytes} B: vs plain err_o={chk['err_o']:.2e} "
            f"(limit ratio {chk['o_ratio']:.3f}) err_lse="
            f"{chk['err_lse']:.2e}; vs f32 oracle err_o="
            f"{oracle['err_o']:.2e} (limit ratio {oracle['o_ratio']:.3f}) "
            f"err_lse={oracle['err_lse']:.2e}; ms={ms:.4f} call_ms="
            f"{call_ms:.4f} repack_ms="
            f"{'none' if repack_ms is None else f'{repack_ms:.4f}'} "
            f"plain_ms={plain_ms:.3f} library_ms="
            f"{'none' if library_ms is None else f'{library_ms:.4f}'} "
            f"bound_ms={b_ms:.5f} ({b_by}) launches={n_launch} "
            f"{'ok' if ok else 'MISMATCH'} [{card}]")
        del c, w, views, qp, got, kw
        torch.cuda.empty_cache()
    bad = [r["case"] for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"paged surface cases failed: {bad}")
    return dict(rows=rows, launches=launches)


# --------------------------------------------------------------------- main

# ---------------------------------------------------- native host runtime

# ------------------------------------------------------ caller variants

VARIANT_TOKENS = 8192  # the single-request prompt (causal)
VARIANT_DOC = 1024  # tokens a document of the flash doc-mask case
VARIANT_BATCH_DOC = 64  # tokens a document of the batch doc-mask case
VARIANT_NAMES = ("alibi", "doc_mask", "q_out", "sigmoid")
VARIANT_PAGED = ("alibi", "doc_mask", "q_out")  # softmax: the paged kernel
VARIANT_KV = (("bf16", (1.0, 1.0)), ("e4m3", (0.25, 0.25)))
VARIANT_PATH = ("flash_attention", "paged_attention")


def _caller_variant(torch, name, hq, n_tokens, doc_len, dev):
    """(variant, variant_params, built-in variant of the same function or
    None) of one caller variant, its hooks plain torch: (a) ALiBi from its
    slopes, (b) a document mask over a table of document ids (covering a
    tile past the keys), (c) a q scale and an output affine, (d) the
    sigmoid with bias -log(n) (a row's weights sum to ~1)."""
    from flashinfer_tpu_torch.ops.attention.single import (
        default_alibi_slopes,
    )
    from flashinfer_tpu_torch.ops.attention.variants import (
        AttentionVariant,
        FlashSigmoid,
        make_default_variant,
    )

    if name == "alibi":
        return (AttentionVariant(
            name="caller_alibi",
            logits_transform=lambda p, s, qp, kp, h: (
                s + p["alibi_slopes"][h] * (kp - qp).float())),
            {"alibi_slopes": default_alibi_slopes(hq, dev)},
            make_default_variant(use_alibi=True))
    if name == "doc_mask":
        doc = (torch.arange(n_tokens + 256, device=dev) // doc_len).int()
        return (AttentionVariant(
            name="doc_mask",
            logits_mask=lambda p, qp, kp, h: p["doc"][qp] == p["doc"][kp]),
            {"doc": doc}, None)
    if name == "q_out":
        return (AttentionVariant(
            name="q_out", query_transform=lambda p, x: x * p["q_scale"],
            output_transform=lambda p, o: o * 1.5 + p["o_bias"]),
            {"q_scale": torch.tensor(0.75, device=dev), "o_bias": 0.25},
            None)
    bias = -math.log(n_tokens)
    return (AttentionVariant(
        name="caller_sigmoid", use_softmax=False,
        logits_transform=lambda p, s, qp, kp, h: torch.reciprocal(
            1.0 + torch.exp(-(s + bias)))),
        None, FlashSigmoid(1.0, bias))


def _doc_pairs(np, kv_lens, qo_lens, doc_len):
    """(query, key) pairs a causal document mask keeps: query i of a
    request sits at kv - qo + i and sees its document's keys up to it."""
    total = 0
    for kv, qo in zip(kv_lens, qo_lens):
        pos = np.arange(int(kv) - int(qo), int(kv))
        total += int((pos % doc_len + 1).sum())
    return total


def _variant_flash_case(torch, np, name, gen):
    """The single-request call of one caller variant at 8192 tokens,
    causal, bf16 (MPT-7B's heads for ALiBi, Llama-3-8B's else): a dict of
    the kernel, built-in, plain and SDPA calls (each returning (o, lse),
    SDPA o), the bound's bytes and operations."""
    import torch.nn.functional as F

    from flashinfer_tpu_torch.ops.attention.kernels.flash import (
        flash_attention_plain,
    )
    from flashinfer_tpu_torch.ops.attention.single import (
        single_prefill_with_kv_cache,
    )
    from flashinfer_tpu_torch.ops.quantization import packbits

    hq, hkv, d = MPT_7B_HEADS if name == "alibi" else LLAMA_HEADS
    n = VARIANT_TOKENS
    dev = torch.device(DEVICE)
    q, k, v = (torch.randn(n, h, d, device=dev, generator=gen,
                           dtype=torch.bfloat16) for h in (hq, hkv, hkv))
    variant, params, builtin = _caller_variant(torch, name, hq, n,
                                               VARIANT_DOC, dev)
    kw = dict(causal=True, sm_scale=d ** -0.5)
    vkw = dict(kw, variant=variant, variant_params=params)

    def kernel():
        return single_prefill_with_kv_cache(q, k, v, return_lse=True, **vkw)

    def plain():
        return flash_attention_plain(q, k, v, **vkw)

    q_pos = torch.arange(n, device=dev)[:, None]
    kv_pos = torch.arange(n, device=dev)[None, :]
    keep = kv_pos <= q_pos
    builtin_call = lib = None
    extra = 0
    pairs = n * (n + 1) // 2
    if builtin is not None:  # ALiBi's slopes, the sigmoid's numbers
        bkw = dict(kw, variant=builtin, variant_params=params)

        def builtin_call():
            return single_prefill_with_kv_cache(q, k, v, return_lse=True,
                                                **bkw)
    if name == "alibi":
        extra = hq * 4
        slopes = params["alibi_slopes"]
        bias = torch.where(keep, slopes[:, None, None]
                           * (kv_pos - q_pos).float(),
                           float("-inf")).to(q.dtype)[None]

        def lib():
            return F.scaled_dot_product_attention(
                q.transpose(0, 1)[None], k.transpose(0, 1)[None],
                v.transpose(0, 1)[None], attn_mask=bias,
                scale=kw["sm_scale"])
    elif name == "doc_mask":  # the same mask as packed bits, and for SDPA
        doc = params["doc"][:n]
        keep = keep & (doc[:, None] == doc[None, :])
        extra = params["doc"].numel() * 4
        pairs = _doc_pairs(np, [n], [n], VARIANT_DOC)
        packed = packbits(keep.reshape(-1))

        def builtin_call():
            return single_prefill_with_kv_cache(
                q, k, v, return_lse=True, packed_custom_mask=packed, **kw)

        group = hq // hkv
        kt, vt = (x.transpose(0, 1)[None].repeat_interleave(group, dim=1)
                  for x in (k, v))

        def lib():
            return F.scaled_dot_product_attention(
                q.transpose(0, 1)[None], kt, vt, attn_mask=keep,
                scale=kw["sm_scale"])
    else:
        del keep
    nbytes = (n * hq * d * 2) * 2 + 2 * n * hkv * d * 2 + n * hq * 4 + extra
    ops = 4 * d * pairs * hq
    return dict(kernel=kernel, builtin=builtin_call, plain=plain, lib=lib,
                nbytes=nbytes, ops=ops, heads=(hq, hkv, d), pairs=pairs)


def _variant_batch_cases(torch, np, lens_decode, lens_prefill, gen):
    """The batch wrappers with the caller variants (a)-(c) at Llama-3-8B
    widths (MPT-7B's for ALiBi), page 16, NHD, chunk 512: the engine's
    8-prompt prefill and an 8-request decode, bf16 and e4m3 caches. Yields
    (label, wrapper, q, (k, v), scales, variant, params, kv_lens, qo_lens,
    pages)."""
    from flashinfer_tpu_torch.ops.attention.batch import (
        BatchDecodeWithPagedKVCacheWrapper,
        BatchPrefillWithPagedKVCacheWrapper,
    )

    ps = 16
    dev = torch.device(DEVICE)
    for name in VARIANT_PAGED:
        hq, hkv, d = MPT_7B_HEADS if name == "alibi" else LLAMA_HEADS
        for mode, lens in (("prefill", lens_prefill),
                           ("decode", lens_decode)):
            kv_lens = np.asarray(lens, np.int64)
            qo_lens = kv_lens if mode == "prefill" else np.ones_like(kv_lens)
            npages = -(-kv_lens // ps)
            indptr = np.concatenate([[0], np.cumsum(npages)])
            pages = int(indptr[-1])
            indices = np.random.default_rng(3).permutation(pages)
            last = kv_lens - (npages - 1) * ps
            variant, params, _ = _caller_variant(
                torch, name, hq, int(kv_lens.max()), VARIANT_BATCH_DOC, dev)
            if mode == "prefill":
                w = BatchPrefillWithPagedKVCacheWrapper(
                    kv_layout="NHD", device=DEVICE, variant=variant)
                w.plan(np.concatenate([[0], np.cumsum(qo_lens)]), indptr,
                       indices, last, hq, hkv, d, ps, causal=True,
                       kv_chunk_size=512, variant_params=params)
            else:
                w = BatchDecodeWithPagedKVCacheWrapper(
                    kv_layout="NHD", device=DEVICE, variant=variant)
                w.plan(indptr, indices, last, hq, hkv, d, ps,
                       kv_chunk_size=512, variant_params=params)
            q = torch.randn(int(qo_lens.sum()), hq, d, device=dev,
                            generator=gen, dtype=torch.bfloat16)
            for kv_name, scales in VARIANT_KV:
                caches = []
                for _ in range(2):
                    x = torch.randn(pages, ps, hkv, d, device=dev,
                                    generator=gen, dtype=torch.bfloat16)
                    caches.append(x if kv_name == "bf16"
                                  else (x * 4).to(torch.float8_e4m3fn))
                yield (f"{name}/{mode}/{kv_name}", w, q, tuple(caches),
                       scales, variant, params, kv_lens, qo_lens, pages)


def _variant_targets(torch, np, lens_decode, lens_prefill):
    """Every (kernel, header) the phase launches, traced first: the JIT's
    libraries, to be built at once."""
    from flashinfer_tpu_torch.jit.variant import compile_variant

    dev = torch.device(DEVICE)
    targets = []
    for name in VARIANT_NAMES:
        hq = (MPT_7B_HEADS if name == "alibi" else LLAMA_HEADS)[0]
        variant, params, _ = _caller_variant(torch, name, hq, VARIANT_TOKENS,
                                             VARIANT_DOC, dev)
        c = compile_variant(variant, params, "flash", hq)
        targets.append(("flash_attention", c.header_path()))
        if name in VARIANT_PAGED:
            kv_max = max(max(lens_decode), max(lens_prefill))
            variant, params, _ = _caller_variant(
                torch, name, hq, kv_max, VARIANT_BATCH_DOC, dev)
            c = compile_variant(variant, params, "paged", hq)
            targets.append(("paged_attention", c.header_path()))
    return list(dict.fromkeys(targets))


def phase_variants(torch, np, card, lens_decode, lens_prefill):
    """Callers' attention variants (plain torch hooks) through the variant
    JIT on the card: their flash and paged libraries built at once from the
    checkout's sources; then the variants path (launch counts set to 0
    before it, read after): each of (a) ALiBi, (b) a document mask, (c) a q
    scale and output affine, (d) the sigmoid through
    ``single_prefill_with_kv_cache`` (8192 tokens, causal; 8 documents of
    1024 for (b)), and (a)-(c) through ``BatchPrefillWithPagedKVCacheWrapper``
    (the engine's 8 prompts) and ``BatchDecodeWithPagedKVCacheWrapper`` (8
    requests) on bf16 and e4m3 caches; a second call of each runs no
    build. Then each kernel launch against its plain version (ATTN limits),
    (a) and (d) against the built-in variant's library too, each timed
    beside the built-in variant's ms (or the default's), its bound, the
    plain version's ms and SDPA's where one call computes it (ALiBi as a
    bias, the document mask as a boolean mask)."""
    from flashinfer_tpu_torch import jit
    from flashinfer_tpu_torch.jit import core
    from flashinfer_tpu_torch.ops.attention.batch import pack_queries
    from flashinfer_tpu_torch.ops.attention.kernels.paged import (
        batch_paged_attention_run,
    )

    t0 = time.perf_counter()
    targets = _variant_targets(torch, np, lens_decode, lens_prefill)
    built = jit.build_all(targets)
    build_s = time.perf_counter() - t0
    for t in targets:
        label = core._label(t)
        log(f"variant library {label}: "
            + (f"built in {built[label]:.1f} s" if label in built
               else "cached"))
        for ln in jit.build_log(t).splitlines():  # spills; C75xx but C7519
            if "spill" in ln and " 0 bytes spill" not in ln or (
                    "C75" in ln and "C7519" not in ln):
                log("  ptxas:", ln.strip())
    log(f"variant libraries: {len(targets)} in {build_s:.1f} s")

    gen = torch.Generator(device=DEVICE).manual_seed(23)
    flash_cases = {name: _variant_flash_case(torch, np, name, gen)
                   for name in VARIANT_NAMES}
    batch_cases = list(_variant_batch_cases(torch, np, lens_decode,
                                            lens_prefill, gen))
    # the variants path: each call once through its entry point
    torch.cuda.synchronize()
    counters = _reset_counts()
    outs = {}
    for name, c in flash_cases.items():
        outs[name] = c["kernel"]()
    for label, w, q, kv, scales, *_ in batch_cases:
        outs[label] = w.run(q, kv, k_scale=scales[0], v_scale=scales[1])
    torch.cuda.synchronize()
    counts = {k: counters[k].launches for k in VARIANT_PATH}
    log(f"variants path: launches {counts}")
    missing = [k for k in VARIANT_PATH if counts[k] == 0]
    if missing:
        raise AssertionError(f"variants path launched no {missing}")
    for key, o in outs.items():
        o = o[0] if isinstance(o, tuple) else o
        assert bool(torch.isfinite(o).all()), key
    del outs
    # a second call of each: no nvcc, no library load
    builds = []
    real_build = core.build_all
    core.build_all = lambda *a, **k: builds.append(a) or real_build(*a, **k)
    try:
        for c in flash_cases.values():
            c["kernel"]()
        for label, w, q, kv, scales, *_ in batch_cases:
            w.run(q, kv, k_scale=scales[0], v_scale=scales[1])
        torch.cuda.synchronize()
    finally:
        core.build_all = real_build
    if builds:
        raise AssertionError(f"second calls built {builds}")
    log("variants: second calls ran 0 builds")

    rows = []
    for name, c in flash_cases.items():
        got = c["kernel"]()
        want = c["plain"]()
        torch.cuda.synchronize()
        chk = _attn_check(torch, got, want)
        row = dict(case=f"flash/{name}", heads=c["heads"], **chk,
                   build_s=build_s, builds_second_call=0)
        if c["builtin"] is not None and name in ("alibi", "sigmoid"):
            bchk = _attn_check(torch, got, c["builtin"]())
            row["vs_builtin"] = bchk
            row["ok"] = row["ok"] and bchk["ok"]
        del got
        lib_ms = lib_ratio = None
        if c["lib"] is not None:
            lib_ms, lib_ratio = _time_library(torch, c["lib"], want, True)
        del want
        row["ms"] = cuda_ms(torch, c["kernel"], 5, warmup=1, graph=True)
        row["builtin_ms"] = (cuda_ms(torch, c["builtin"], 5, warmup=1,
                                     graph=True)
                             if c["builtin"] is not None else None)
        row["plain_ms"] = cuda_ms(torch, c["plain"], 2, warmup=1)
        row["library_ms"], row["library_o_ratio"] = lib_ms, lib_ratio
        row["bound_ms"], row["bound_by"] = bound_ms(c["nbytes"], c["ops"])
        row.update(bound_bytes=c["nbytes"], bound_ops=c["ops"],
                   pairs=c["pairs"])
        rows.append(row)
        log(f"variant flash/{name:8s} heads={c['heads']} err_o="
            f"{chk['err_o']:.2e} (limit ratio {chk['o_ratio']:.3f}) "
            f"err_lse={chk['err_lse']:.2e}"
            + (f" vs built-in ratio {row['vs_builtin']['o_ratio']:.3f}"
               if "vs_builtin" in row else "")
            + f" ms={row['ms']:.4f} builtin_ms={row['builtin_ms']} "
            f"plain_ms={row['plain_ms']:.3f} library_ms={lib_ms} "
            f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}) "
            f"{'ok' if row['ok'] else 'MISMATCH'}")
        torch.cuda.empty_cache()
    del flash_cases

    for (label, w, q, kv, scales, variant, params, kv_lens, qo_lens,
         pages) in batch_cases:
        dp = w.device_plan
        m = dp.meta
        qp = pack_queries(dp, q)
        args = (qp, kv[0], kv[1], dp.segment("kv_indices"),
                dp.segment("plan"))
        kw = dict(tile_q=m.tile_q, group=m.gqa_group, causal=m.causal,
                  sm_scale=m.sm_scale, k_scale=scales[0], v_scale=scales[1],
                  row_valid=dp.segment("row_valid"))
        vkw = dict(kw, variant=variant, variant_params=params)
        got = batch_paged_attention_run(*args, **vkw)
        want = _paged_plain(torch, *args, **vkw)
        torch.cuda.synchronize()
        chk = _attn_check(torch, got, want)
        del got, want
        ms = cuda_ms(torch, lambda: batch_paged_attention_run(*args, **vkw),
                     20, graph=True)
        default_ms = cuda_ms(
            torch, lambda: batch_paged_attention_run(*args, **kw), 20,
            graph=True)
        plain_ms = cuda_ms(torch, lambda: _paged_plain(torch, *args, **vkw),
                           3, warmup=1)
        hq, hkv, d = qp.shape[0] * m.gqa_group, qp.shape[0], qp.shape[2]
        name = label.split("/")[0]
        pairs = (_doc_pairs(np, kv_lens, qo_lens, VARIANT_BATCH_DOC)
                 if name == "doc_mask"
                 else _attention_work(kv_lens, qo_lens, 1))
        nbytes = _attention_bytes(dp.segment("plan"), pages, kv_lens,
                                  m.tile_q, hkv, d, kv[0].element_size())
        b_ms, b_by = bound_ms(nbytes, 4 * d * pairs * hq)
        row = dict(case=f"paged/{label}", heads=(hq, hkv, d),
                   tile_q=m.tile_q, T=m.num_work_items, **chk, ms=ms,
                   default_ms=default_ms, plain_ms=plain_ms,
                   library_ms=None, bound_ms=b_ms, bound_by=b_by,
                   bound_bytes=nbytes, pairs=pairs)
        rows.append(row)
        log(f"variant paged/{label:24s} tile_q={m.tile_q} T="
            f"{m.num_work_items} err_o={chk['err_o']:.2e} (limit ratio "
            f"{chk['o_ratio']:.3f}) err_lse={chk['err_lse']:.2e} ms={ms:.4f} "
            f"default_ms={default_ms:.4f} plain_ms={plain_ms:.3f} "
            f"bound_ms={b_ms:.5f} ({b_by}) "
            f"{'ok' if chk['ok'] else 'MISMATCH'}")
    del batch_cases
    torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"a caller variant's kernel disagrees: {bad}")
    return dict(rows=rows, launches=counts, build_s=build_s,
                built={k: v for k, v in built.items()},
                libraries=[core._label(t) for t in targets])


PLAN_ARRAYS = ("request_indices", "qo_tile_indices", "kv_tile_indices",
               "qo_start_row", "qo_tile_len", "kv_start", "kv_end",
               "kv_page_start", "num_kv_splits", "q_pos_base",
               "merge_out_row")
PLAN_SCALARS = ("tile_q", "kv_chunk_size", "num_work_items", "total_rows",
                "batch_size", "page_size", "gqa_group", "num_valid_items")


def _plans_differ(np, a, b):
    """The fields where two AttentionPlans differ ([] where equal)."""
    bad = [f for f in PLAN_SCALARS if int(getattr(a, f)) != int(getattr(b, f))]
    return bad + [f for f in PLAN_ARRAYS
                  if not np.array_equal(getattr(a, f), getattr(b, f))]


@contextlib.contextmanager
def _both_planners(np):
    """While open, every plan the paged and MLA wrappers build is planned by
    the native and the NumPy planner and the two held equal field by field;
    the native plan is used. Yields the list of (args, kwargs, wrapper
    module) of the calls."""
    from flashinfer_tpu_torch.ops.attention import batch, mla

    calls, orig = [], {}

    def checked(mod):
        real = orig[mod]

        def fn(*a, **k):
            got = real(*a, backend="native", **k)
            bad = _plans_differ(np, got, real(*a, backend="numpy", **k))
            if bad:
                raise AssertionError(f"native and NumPy plans differ in {bad}")
            calls.append((a, k, mod.__name__.rsplit(".", 1)[-1]))
            return got
        return fn

    for mod in (batch, mla):
        orig[mod] = mod.plan_attention
        mod.plan_attention = checked(mod)
    try:
        yield calls
    finally:
        for mod, fn in orig.items():
            mod.plan_attention = fn


def _deepseek_loop_plans(np, prompts, n_new):
    """The MLA plans ``deepseek_serve`` builds at V2-Lite widths for these
    prompts, step by step (the token loop's pool and live set, no model)."""
    from flashinfer_tpu_torch.ops.attention.mla import (
        BatchMLAPagedAttentionWrapper,
    )
    from flashinfer_tpu_torch.scheduler.native import PagePool

    c = V2_LITE
    pool = PagePool(_pages_needed(prompts, n_new, MLA_PAGE), MLA_PAGE)
    seqs = [pool.create() for _ in prompts]
    done_at = [len(p) - 1 + n_new for p in prompts]
    t = 0
    while t < max(done_at):
        live = [i for i in range(len(prompts)) if t < done_at[i]]
        for i in live:
            pool.extend(seqs[i], t + 1)
        indptr, indices, _ = pool.batch_export([seqs[i] for i in live])
        BatchMLAPagedAttentionWrapper(device=DEVICE).plan(
            np.arange(len(live) + 1), indptr, indices,
            np.full(len(live), t + 1), c["num_heads"], c["head_dim_ckv"],
            c["head_dim_kpe"], MLA_PAGE, kv_chunk_size=64,
            sm_scale=(c["head_dim_qk_nope"] + c["head_dim_kpe"]) ** -0.5)
        t += 1
    return t


def _planner_us(np, args, kwargs, backend, n=300):
    """Median host µs of ``plan_attention`` on one backend."""
    from flashinfer_tpu_torch.scheduler.plan import plan_attention

    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        plan_attention(*args, backend=backend, **kwargs)
        times.append((time.perf_counter() - t0) * 1e6)
    return float(np.median(times))


def phase_native(torch, np, lens_decode, lens_prefill):
    """The host runtime: the C++ planner and page pool build and load (ABI
    4); the engine's decode, prefill and verify plans and every MLA plan of
    the DeepSeek loop at V2-Lite widths are equal native and NumPy, field
    by field; the two planners' host µs a call on the engine's decode and
    prefill batches."""
    from flashinfer_tpu_torch import jit
    from flashinfer_tpu_torch.scheduler.native import native_plan_available

    lib = jit.get_native_runtime()
    if lib is None or not native_plan_available():
        raise AssertionError("the host runtime did not load")
    abi = int(lib.fi_native_abi_version())
    if abi != 4:
        raise AssertionError(f"host runtime ABI {abi} != 4")
    stats = jit.jit_registry.get_stats()["fi_native"]
    log(f"host runtime: ABI {abi}, {stats}")
    with _both_planners(np) as calls:
        _engine_like_plans(np, lens_decode, lens_prefill)
        engine_calls = list(calls)
        rng = np.random.default_rng(1)  # phase_deepseek's prompts
        prompts = [rng.integers(0, V2_LITE["vocab_size"], int(n)).tolist()
                   for n in rng.integers(32, 129, 8)]
        steps = _deepseek_loop_plans(np, prompts, 32)
    n_mla = sum(1 for c in calls if c[2] == "mla")
    log(f"native == NumPy plans, field by field: {len(engine_calls)} engine "
        f"plans (decode, prefill, verify), {n_mla} MLA plans over the "
        f"DeepSeek loop's {steps} steps")
    timing = {}
    for name, (a, k, _) in zip(("decode", "prefill", "verify"),
                               engine_calls):
        timing[name] = {b: _planner_us(np, a, k, b)
                        for b in ("native", "numpy")}
        log(f"planner host us a call, Llama {name} batch: native "
            f"{timing[name]['native']:.1f}, numpy "
            f"{timing[name]['numpy']:.1f}")
    return dict(abi=abi, build=stats, engine_plans=len(engine_calls),
                mla_plans=n_mla, planner_us=timing)


# ----------------------------------------------- fused_moe's entry points

# (name, entry point, experts, hidden, intermediate, top_k, routing): the
# published configs' MoE layers. Mixtral-8x7B (huggingface.co/mistralai/
# Mixtral-8x7B-v0.1 config.json), DeepSeek-V3 (huggingface.co/deepseek-ai/
# DeepSeek-V3 config.json: n_routed_experts 256, moe_intermediate_size 2048,
# num_experts_per_tok 8, n_group 8, topk_group 4, routed_scaling_factor
# 2.5), gpt-oss-120b (huggingface.co/openai/gpt-oss-120b config.json:
# num_local_experts 128, intermediate_size 2880, experts_per_token 4)
MOE_ENTRY_CASES = (
    ("cutlass_fused_moe", "mixtral", 8, 4096, 14336, 2),
    ("trtllm_fp8_per_tensor_scale_moe", "mixtral", 8, 4096, 14336, 2),
    ("trtllm_fp8_block_scale_moe", "deepseek_v3", 256, 7168, 2048, 8),
    ("trtllm_fp4_block_scale_moe", "gpt_oss_120b", 128, 2880, 2880, 4),
)
MOE_ENTRY_TOKENS = (8, 1024)  # a decode batch and a prefill chunk
# against the plain ragged_dot route (backend="xla"): two bf16 steps of the
# output (h1, the activation and the output are rounded to bf16 on both
# sides from f32 sums taken in other orders), plus 2^-5 of the output's rms
# (the plain route rounds e4m3 weights times their scale to bf16, where the
# kernel scales the f32 sum)
MOE_RTOL, MOE_ATOL_RMS = 2.0 ** -6, 2.0 ** -5


def _moe_entry_inputs(torch, name, e, hidden, inter, gen):
    """The entry point's weights on the card, made a few experts at a time
    (their full-size f32 temporaries would not fit): returns (weight
    arguments, the bf16 weights where the entry point takes them as they
    are, else None, weight bytes an expert as the entry point reads
    them)."""
    dev = torch.device(DEVICE)

    def chunked(shape, fn, dtype):
        out = torch.empty(shape, dtype=dtype, device=dev)
        for e0 in range(0, shape[0], 16):
            out[e0:e0 + 16] = fn(min(16, shape[0] - e0))
        return out

    def randn(n, rows, cols, scale):
        return torch.randn(n, rows, cols, device=dev, generator=gen,
                           dtype=torch.bfloat16) * scale

    s13, s2 = hidden ** -0.5, inter ** -0.5
    if name == "cutlass_fused_moe":
        w13 = chunked((e, 2 * inter, hidden), lambda n: randn(
            n, 2 * inter, hidden, s13), torch.bfloat16)
        w2 = chunked((e, hidden, inter), lambda n: randn(n, hidden, inter,
                                                         s2), torch.bfloat16)
        return (w13, w2), (w13, w2), 2 * 3 * inter * hidden
    if name == "trtllm_fp8_per_tensor_scale_moe":
        # e4m3 weights at 64x their values, one 1/64 scale a GEMM
        w13 = chunked((e, 2 * inter, hidden), lambda n: (randn(
            n, 2 * inter, hidden, s13) * 64).to(torch.float8_e4m3fn),
            torch.float8_e4m3fn)
        w2 = chunked((e, hidden, inter), lambda n: (randn(
            n, hidden, inter, s2) * 64).to(torch.float8_e4m3fn),
            torch.float8_e4m3fn)
        sc = torch.tensor(1 / 64, device=dev)
        return (w13, sc, w2, sc), None, 3 * inter * hidden
    if name == "trtllm_fp8_block_scale_moe":
        def blocks(n, rows, cols, scale):
            s = (torch.rand(n, rows // 128, cols // 128, device=dev,
                            generator=gen) + 0.5) * scale / 64
            w = randn(n, rows, cols, scale) / s.repeat_interleave(
                128, 1).repeat_interleave(128, 2)
            return w.to(torch.float8_e4m3fn), s
        w13 = torch.empty(e, 2 * inter, hidden, dtype=torch.float8_e4m3fn,
                          device=dev)
        w2 = torch.empty(e, hidden, inter, dtype=torch.float8_e4m3fn,
                         device=dev)
        sc13 = torch.empty(e, 2 * inter // 128, hidden // 128, device=dev)
        sc2 = torch.empty(e, hidden // 128, inter // 128, device=dev)
        for e0 in range(0, e, 16):
            w13[e0:e0 + 16], sc13[e0:e0 + 16] = blocks(16, 2 * inter, hidden,
                                                       s13)
            w2[e0:e0 + 16], sc2[e0:e0 + 16] = blocks(16, hidden, inter, s2)
        return ((w13, sc13, w2, sc2), None,
                3 * inter * hidden + 4 * 3 * inter * hidden // 128 ** 2)
    # mxfp4: random e2m1 codes, e8m0 scales of 2^-8 .. 2^-5
    def fp4(n, rows, cols):
        packed = torch.randint(0, 256, (n, rows, cols // 2), device=dev,
                               generator=gen, dtype=torch.uint8)
        sf = torch.randint(119, 123, (n, rows, cols // 32), device=dev,
                           generator=gen, dtype=torch.uint8)
        return packed, sf
    p13, f13 = fp4(e, 2 * inter, hidden)
    p2, f2 = fp4(e, hidden, inter)
    return ((p13, f13, p2, f2), None,
            3 * inter * hidden // 2 + 3 * inter * hidden // 32)


def _moe_entry_call(moe, name, logits, bias, x, weights, e, inter, top_k,
                    backend):
    """One call of entry point ``name`` on these inputs (its own routing,
    from ``logits``, for the trtllm entry points)."""
    if name == "cutlass_fused_moe":
        ids, sc = moe.route_tokens(logits, top_k,
                                   moe.RoutingMethodType.Renormalize)
        return moe.cutlass_fused_moe(x, ids, sc, *weights, x.dtype,
                                     backend=backend)
    if name == "trtllm_fp8_per_tensor_scale_moe":
        w13, s13, w2, s2 = weights
        return moe.trtllm_fp8_per_tensor_scale_moe(
            logits, None, x, w13, s13, w2, s2, e, top_k, None, None, inter,
            routing_method_type=moe.RoutingMethodType.Renormalize,
            backend=backend)
    if name == "trtllm_fp8_block_scale_moe":
        xq, sx = x
        w13, s13, w2, s2 = weights
        return moe.trtllm_fp8_block_scale_moe(
            logits, bias, xq, sx, w13, s13, w2, s2, e, top_k, 8, 4, inter,
            routed_scaling_factor=2.5, backend=backend)
    p13, f13, p2, f2 = weights
    return moe.trtllm_fp4_block_scale_moe(
        logits, None, x, None, p13, f13, p2, f2, num_experts=e, top_k=top_k,
        intermediate_size=inter, backend=backend)


def phase_moe_entries(torch, np, card):
    """fused_moe's four API entry points at the published layers' widths,
    each at a decode batch of 8 tokens and a 1024-token prefill chunk: the
    kernel path (two grouped-GEMM launches a call) held to the plain
    ragged_dot route on the same inputs and routing, timed (CUDA events,
    eager) beside its bound, the plain route and, where the weights reach
    the GEMMs in bf16, two ``torch._grouped_mm`` calls; the block-scale
    entry points' dequantization timed on its own. Returns the rows and
    the grouped-GEMM launches of the kernel calls (the moe_api path)."""
    import importlib

    moe = importlib.import_module("flashinfer_tpu_torch.ops.fused_moe")
    from flashinfer_tpu_torch.ops.gemm_grouped import grouped_gemm_padded

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(21)
    rows, launches = [], 0
    for name, model, e, hidden, inter, top_k in MOE_ENTRY_CASES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        weights, bf16_w, w_bytes = _moe_entry_inputs(torch, name, e, hidden,
                                                     inter, gen)
        torch.cuda.synchronize()
        gb = sum(t.numel() * t.element_size() for t in weights) / 1e9
        log(f"{name} at {model}: {e} experts, hidden {hidden}, intermediate "
            f"{inter}, top-{top_k}; weights {gb:.2f} GB made in "
            f"{time.perf_counter() - t0:.1f} s")
        deq = {"trtllm_fp8_block_scale_moe": moe._dequant_block_fp8,
               "trtllm_fp4_block_scale_moe": moe._dequant_mxfp4}.get(name)
        deq_ms = None
        if deq is not None:  # every weight to bf16, as each call does
            w13, s13, w2, s2 = weights
            deq_ms = cuda_ms(torch, lambda: (deq(w13, s13), deq(w2, s2)), 3,
                             warmup=1)
            log(f"  {name} dequantization of every weight to bf16: "
                f"{deq_ms:.3f} ms a call [{card}]")
            bf16_w = (deq(w13, s13), deq(w2, s2))  # for the library's time
        for m in MOE_ENTRY_TOKENS:
            logits = torch.randn(m, e, device=dev, generator=gen)
            bias = torch.randn(e, device=dev, generator=gen) * 0.1
            xb = torch.randn(m, hidden, device=dev, generator=gen,
                             dtype=torch.bfloat16)
            if name == "trtllm_fp8_block_scale_moe":
                sx = torch.rand(m, hidden // 128, device=dev,
                                generator=gen) / 64 + 1 / 128
                x = ((xb.float() / sx.repeat_interleave(128, 1)).to(
                    torch.float8_e4m3fn), sx)
            else:
                x = xb

            def call(backend):
                return _moe_entry_call(moe, name, logits, bias, x, weights,
                                       e, inter, top_k, backend)

            before = grouped_gemm_padded.launches
            got = call("auto")
            torch.cuda.synchronize()
            n_launch = grouped_gemm_padded.launches - before
            launches += n_launch
            want = call("xla")
            diff = (got.float() - want.float()).abs()
            rms = float(want.float().pow(2).mean().sqrt())
            ratio = float((diff / (MOE_RTOL * want.float().abs()
                                   + MOE_ATOL_RMS * rms)).max())
            finite = bool(torch.isfinite(got.float()).all())
            iters = 3 if e >= 128 else 10
            ms = cuda_ms(torch, lambda: call("auto"), iters, warmup=1)
            plain_ms = cuda_ms(torch, lambda: call("xla"), 2, warmup=0)
            # routing as the entry point routes, for the bound's experts
            if name == "trtllm_fp8_block_scale_moe":
                ids, _ = moe.route_tokens(logits, top_k,
                                          moe.RoutingMethodType.DeepSeekV3,
                                          n_group=8, topk_group=4,
                                          routed_scaling_factor=2.5,
                                          routing_bias=bias)
            else:
                ids, _ = moe.route_tokens(logits, top_k,
                                          moe.RoutingMethodType.Renormalize)
            used = int(torch.unique(ids).numel())
            x_bytes = (m * hidden + x[1].numel() * 4 if isinstance(x, tuple)
                       else m * hidden * 2)
            nbytes = used * w_bytes + x_bytes + m * hidden * 2 + m * e * 4
            ops = 2 * m * top_k * 3 * inter * hidden
            b_ms, b_by = bound_ms(nbytes, ops, "bf16")
            lib_ms = None
            if bf16_w is not None:
                lib_ms = _moe_library_ms(torch, moe, xb, ids, *bf16_w)
            ok = ratio <= 1.0 and finite and n_launch == 2
            row = dict(entry=name, model=model, tokens=m, experts=e,
                       hidden=hidden, inter=inter, top_k=top_k,
                       experts_used=used, grouped_gemm_launches=n_launch,
                       err=float(diff.max()), limit_ratio=ratio, ms=ms,
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       bound_bytes=nbytes, bound_ops=ops, library_ms=lib_ms,
                       dequant_ms=deq_ms, ok=ok,
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
            rows.append(row)
            log(f"  {name} {m:5d} tokens: {used} experts used, grouped GEMM "
                f"launches {n_launch}, err {row['err']:.3e} (limit ratio "
                f"{ratio:.3f}), ms {ms:.4f}, plain ms {plain_ms:.3f}, bound "
                f"ms {b_ms:.5f} ({b_by}), library ms {lib_ms}, peak "
                f"{row['peak_mem_gb']:.1f} GB {'ok' if ok else 'MISMATCH'} "
                f"[{card}]")
            del got, want, diff
        del weights, bf16_w
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"MoE entry points disagree with their plain "
                             f"route: {bad}")
    return dict(rows=rows, launches={"grouped_gemm": launches})


def _moe_library_ms(torch, moe, x, ids, w13, w2):
    """Two ``torch._grouped_mm`` calls (gate/up, then down on the
    activation) over the rows sorted by expert: the same bf16 products,
    without the gathers and the combine; None where this PyTorch lacks it
    or refuses the call."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None
    order, sizes = moe._permute_by_expert(ids, w13.shape[0])
    xs = x[order // ids.shape[1]]
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    w13t, w2t = w13.transpose(1, 2), w2.transpose(1, 2)
    h = torch.zeros(xs.shape[0], w13.shape[1] // 2, dtype=x.dtype,
                    device=x.device)

    def run():
        fn(h, w2t, offs=offs)
        return fn(xs, w13t, offs=offs)
    try:
        run()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError) as err:
        log(f"  torch._grouped_mm refused: {err}"[:300])
        return None
    return cuda_ms(torch, run, 10)


# ------------------------------------------------------- the logits pipe

LOGITS_PIPES = (
    (("Temperature", "Softmax", "TopK", "TopP", "Sample"),
     dict(temperature=0.7, top_k=40, top_p=0.9)),
    (("Softmax", "Sample"), {}),
    (("Temperature", "Softmax", "MinP", "Sample"),
     dict(temperature=0.7, min_p=0.05)),
    (("TopK", "Softmax", "TopP", "Sample"), dict(top_k=40, top_p=0.9)),
)


def _pipe_direct(torch, S, names, logits, seed, p):
    """The sampler surface called as the pipe compiles ``names``."""
    if names[0] == "Temperature":
        probs = torch.softmax((logits / p["temperature"]).float(), -1)
        if "MinP" in names:
            return S.min_p_sampling_from_probs(probs, p["min_p"], seed=seed)
        return S.top_k_top_p_sampling_from_probs(probs, p["top_k"],
                                                 p["top_p"], seed=seed)
    if names[0] == "TopK":
        probs = torch.softmax(S.top_k_mask_logits(logits, p["top_k"]).float(),
                              -1)
        return S.top_p_sampling_from_probs(probs, p["top_p"], seed=seed)
    return S.sampling_from_logits(logits, seed=seed)


def phase_logits_pipe(torch, card):
    """Four ``LogitsPipe``s on [8, 128256] f32 logits (Llama-3-8B's
    vocabulary): each pipe's compiled steps, its tokens bit-equal to the
    direct sampler calls with the same seed, its sampler launches and its
    ms (CUDA events, eager) beside the direct calls'."""
    from flashinfer_tpu_torch import logits_processor as lp
    from flashinfer_tpu_torch.ops import sampling as S
    from flashinfer_tpu_torch.ops.sampling import family_call

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(23)
    logits = torch.randn(8, 128256, device=dev, generator=gen) * 3
    rows, launches = [], 0
    for names, params in LOGITS_PIPES:
        pipe = lp.LogitsPipe([getattr(lp, n)() for n in names])
        equal = True
        for seed in (5, 2**31 - 7, 123456):
            before = family_call.launches
            got = pipe(logits, seed=seed, **params)
            torch.cuda.synchronize()
            n_launch = family_call.launches - before
            launches += n_launch
            want = _pipe_direct(torch, S, names, logits, seed, params)
            equal &= bool(torch.equal(got, want))
        ms = cuda_ms(torch, lambda: pipe(logits, seed=5, **params), 20)
        direct_ms = cuda_ms(torch, lambda: _pipe_direct(
            torch, S, names, logits, 5, params), 20)
        row = dict(pipe=list(names), params=params,
                   compiled_names=pipe.compiled_names,
                   sampler_launches=n_launch, tokens_equal=equal, ms=ms,
                   direct_ms=direct_ms)
        rows.append(row)
        log(f"pipe {list(names)} -> {pipe.compiled_names}: sampler launches "
            f"{n_launch} a call, tokens equal to the direct calls: {equal}, "
            f"ms {ms:.4f} (direct {direct_ms:.4f}) [{card}]")
    if not all(r["tokens_equal"] and r["sampler_launches"] for r in rows):
        raise AssertionError(f"a pipe differs from its direct calls: {rows}")
    return dict(rows=rows, launches={"sampler_family": launches})


# ---------------------------------------------------------------- tooling

def phase_tooling(torch, np, card):
    """``aot.warmup()`` over the default universe, ``python -m
    flashinfer_tpu_torch show-config`` in its own process, and the
    autotuner: ``tune --quick`` (the paged and MLA prefill tiles, timed
    inside ``autotune()``) persisting its winners to a temporary config
    path."""
    import tempfile

    from flashinfer_tpu_torch import aot, autotuner
    from flashinfer_tpu_torch.__main__ import main as cli

    t0 = time.perf_counter()
    n = aot.warmup()
    warm_s = time.perf_counter() - t0
    log(f"aot.warmup(): {n} configs in {warm_s:.1f} s")
    out = subprocess.run([sys.executable, "-m", "flashinfer_tpu_torch",
                          "show-config"], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    log("show-config:\n" + out.strip())
    info = json.loads(out)
    if not info["native_runtime_available"]:
        raise AssertionError("show-config: no native runtime")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "autotuner_configs.json")
        real = autotuner.get_config_path
        autotuner.get_config_path = lambda: path
        autotuner.AutoTuner._instance = None
        try:
            t0 = time.perf_counter()
            cli(["tune", "--quick"])
            with open(path) as f:
                winners = json.load(f)
            tune_s = time.perf_counter() - t0
        finally:
            autotuner.get_config_path = real
            autotuner.AutoTuner._instance = None
    log(f"autotuner: winners {winners} persisted in {tune_s:.1f} s")
    if len(winners) != 2:
        raise AssertionError(f"the tuner persisted {winners}")
    return dict(aot_configs=n, aot_s=warm_s, show_config=info,
                tuned=winners, tune_s=tune_s)


# ----------------------------------------------------------- distributed

DIST_REQUESTS = 8  # of the engine phase's prompts (64-512 tokens)
DIST_NEW = 16
DIST_ROWS = 512  # max_tokens_per_step: the longest prompt fits one step
# the share of greedy tokens equal to LlamaServingEngine's on the same
# traffic, held with the weights in f32. In bf16 it is reported: the two
# engines round differently (512-row against 8-row GEMMs, attention tiles
# of 8 rows against 256), and on random weights their greedy paths part a
# few tokens in (0.672 on the H100 in bf16, 1.000 in f32: PERF.md)
DIST_MIN_AGREEMENT = 0.9
DIST_PATH = ("paged_attention", "sampler_family", "rmsnorm")
RING_TOKENS = 8192  # the single-request phase's prompt
DIST_MOE_TOKENS = 8
DIST_MOE_LAYER = (8, 4096, 14336)  # Mixtral-8x7B: experts, hidden, inter
DIST_BACKEND = "nccl"
# the pipelined forward (bf16, two layers) against the dense one: four
# bf16 roundings of the largest logit
PIPE_TOL = 2.0 ** -6
# a probe of NCCL send/recv to the own rank, in a process of its own (a
# hang there cannot stall this one); the port never depends on it
SELF_P2P_PROBE = """
import sys, torch, torch.distributed as dist
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method="file://" + sys.argv[1],
                        rank=0, world_size=1)
x = torch.arange(1024, device="cuda", dtype=torch.float32)
y = torch.empty_like(x)
for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 0),
                                   dist.P2POp(dist.irecv, y, 0)]):
    req.wait()
torch.cuda.synchronize()
print("SELF_P2P", bool(torch.equal(x, y)))
dist.destroy_process_group()
"""


def _dist_collectives(torch, np, mesh, moe_mesh):
    """Every collective at world 1 against its local math (the same
    kernels, or the plain versions within NORM_TOL), and ``MoeAlltoAll``
    round trips, one with copies past the capacity."""
    from flashinfer_tpu_torch.ops.fp8 import fp8_quantize_rowwise
    from flashinfer_tpu_torch.ops.norm import (
        fused_add_rmsnorm,
        fused_add_rmsnorm_plain,
    )
    from flashinfer_tpu_torch.parallel import (
        MoeAlltoAll,
        all_reduce,
        allreduce_rmsnorm,
        allreduce_rmsnorm_quant_fp8,
        gemm_allreduce,
        moe_allreduce_fusion,
    )

    gen = torch.Generator(device=DEVICE).manual_seed(5)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, device=DEVICE, generator=gen).to(dtype)

    x, res, w = randn(8, 4096), randn(8, 4096), randn(4096)
    checks = {}
    checks["all_reduce"] = bool(torch.equal(all_reduce(x, mesh=mesh), x))
    got = allreduce_rmsnorm(x, res, w, 1e-5, mesh=mesh)
    want = fused_add_rmsnorm(x, res, w, 1e-5)
    plain = fused_add_rmsnorm_plain(x, res, w, 1e-5)
    err = float((got[0].float() - plain[0].float()).abs().max()
                / plain[0].float().abs().max())
    checks["allreduce_rmsnorm"] = (torch.equal(got[0], want[0])
                                   and torch.equal(got[1], want[1])
                                   and err <= NORM_TOL)
    # an f32 partial into a bf16 residual, as the serving steps call it: the
    # sum rounded once, the same values as the fused launch on bf16 x
    got = allreduce_rmsnorm(x.float(), res, w, 1e-5, mesh=mesh)
    checks["allreduce_rmsnorm_f32_partial"] = bool(
        torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]))
    q, s, r = allreduce_rmsnorm_quant_fp8(x, res, w, 1e-5, mesh=mesh)
    q_want, s_want = fp8_quantize_rowwise(want[0])
    checks["allreduce_rmsnorm_quant_fp8"] = bool(
        torch.equal(q.view(torch.int8), q_want.view(torch.int8))
        and torch.equal(s, s_want) and torch.equal(r, want[1]))
    wg = randn(4096, 4096)
    checks["gemm_allreduce"] = bool(torch.equal(
        gemm_allreduce(x, wg, mesh=mesh), (x.float() @ wg.float()).to(
            x.dtype)))
    shared = randn(8, 4096)
    got = moe_allreduce_fusion(x, 0.5, shared, res, w, 1e-5, mesh=mesh)
    new_res = (x.float() * 0.5 + shared.float() + res.float()).to(x.dtype)
    checks["moe_allreduce_fusion"] = bool(
        torch.equal(got[1], new_res)
        and torch.equal(got[0], fused_add_rmsnorm(
            torch.zeros_like(new_res), new_res, w, 1e-5)[0]))
    # MoeAlltoAll at ep 1: y = x (expert + 1), each token's copies summed
    ids = torch.randint(0, 8, (64, 2), device=DEVICE, generator=gen,
                        dtype=torch.int32)
    scales = torch.rand(64, 2, device=DEVICE, generator=gen)
    xs = randn(64, 256, dtype=torch.float32)
    for cap in (128, 100):  # 128 copies: all kept, then 28 dropped
        a2a = MoeAlltoAll(8, cap, mesh=moe_mesh)
        recv_x, recv_e, slot = a2a.dispatch(xs, ids)
        y = recv_x * torch.where(recv_e >= 0, recv_e + 1, 0)[:, None]
        got = a2a.combine(y, slot, ids, scales)
        kept = (slot >= 0).float()
        want = (xs[:, None, :] * ((ids + 1) * scales * kept)[..., None]).sum(1)
        checks[f"moe_alltoall_cap{cap}"] = (
            float((got - want).abs().max()) <= 1e-4
            and int((slot < 0).sum()) == 128 - cap)
    log(f"collectives at world 1: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"collectives disagree with their local math: "
                             f"{checks}")
    return checks


def _dist_attention(torch, np, mesh, counters):
    """Ring (causal and not) and Ulysses attention at cp 1 on the single
    request phase's Llama-3-8B attention shapes: the same o and lse as one
    direct flash call, bit for bit. Returns the rows and the flash launches
    of the ring / Ulysses calls."""
    from flashinfer_tpu_torch.ops.attention.kernels.flash import (
        flash_attention_dense,
    )
    from flashinfer_tpu_torch.parallel import ring_attention, \
        ulysses_attention

    hq, hkv, d = LLAMA_HEADS
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    q, k, v = (torch.randn(RING_TOKENS, h, d, device=DEVICE, generator=gen,
                           dtype=torch.bfloat16) for h in (hq, hkv, hkv))
    rows, launches = [], 0
    for causal in (False, True):
        direct = flash_attention_dense(q, k, v, causal=causal)
        n0 = counters["flash_attention"].launches
        ring = ring_attention(q, k, v, mesh, causal=causal, return_lse=True)
        uly = ulysses_attention(q, k, v, mesh, causal=causal)
        launches += counters["flash_attention"].launches - n0
        same = dict(ring_o=bool(torch.equal(ring[0], direct[0])),
                    ring_lse=bool(torch.equal(ring[1], direct[1])),
                    ulysses_o=bool(torch.equal(uly, direct[0])))
        ms = cuda_ms(torch, lambda: ring_attention(q, k, v, mesh,
                                                   causal=causal), 5)
        direct_ms = cuda_ms(torch, lambda: flash_attention_dense(
            q, k, v, causal=causal), 5)
        rows.append(dict(causal=causal, same=same, ring_ms=ms,
                         direct_ms=direct_ms))
        log(f"ring / Ulysses attention at cp 1, {RING_TOKENS} tokens, "
            f"causal={causal}: {same}; ring {ms:.3f} ms, direct "
            f"{direct_ms:.3f} ms")
        if not all(same.values()):
            raise AssertionError(f"cp-1 attention differs from the direct "
                                 f"flash call: {same}")
    return rows, launches


def _dist_moe(torch, np, moe_mesh, counters):
    """``fused_moe_ep`` and ``fused_moe_tp`` at size 1 on a Mixtral-8x7B
    layer (8 tokens, top-2 of 8), bf16 and e4m3 per-tensor, against
    ``fused_moe`` on the same routing: within 2e-2 of its largest output
    (the EP combine rounds each expert's output to bf16 first, as JAX's).
    Returns the rows and the grouped-GEMM launches of the sharded calls."""
    import importlib

    from flashinfer_tpu_torch.parallel import fused_moe_ep, fused_moe_tp

    moe = importlib.import_module("flashinfer_tpu_torch.ops.fused_moe")

    e, hidden, inter = DIST_MOE_LAYER
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    x = torch.randn(DIST_MOE_TOKENS, hidden, device=DEVICE, generator=gen,
                    dtype=torch.bfloat16)
    logits = torch.randn(DIST_MOE_TOKENS, e, device=DEVICE, generator=gen)
    rows, launches = [], 0
    for name in ("cutlass_fused_moe", "trtllm_fp8_per_tensor_scale_moe"):
        weights, _, _ = _moe_entry_inputs(torch, name, e, hidden, inter,
                                          gen)
        if len(weights) == 2:
            (w13, w2), sc = weights, None
        else:
            w13, sc, w2, _ = weights
        ids, scales = moe.route_tokens(logits, 2)
        want = moe.fused_moe(x, w13, w2, ids, scales, w13_scale=sc,
                             w2_scale=sc).float()
        n0 = counters["grouped_gemm"].launches
        got = dict(
            ep=fused_moe_ep(x, logits, w13, w2, moe_mesh, top_k=2,
                            w13_scale=sc, w2_scale=sc),
            tp=fused_moe_tp(x, logits, w13, w2, moe_mesh, top_k=2,
                            w13_scale=sc, w2_scale=sc))
        launches += counters["grouped_gemm"].launches - n0
        mag = float(want.abs().max())
        errs = {k: float((g.float() - want).abs().max()) / mag
                for k, g in got.items()}
        rows.append(dict(weights="bf16" if sc is None else "e4m3",
                         rel_err=errs))
        log(f"MoE at size 1, Mixtral-8x7B layer, {rows[-1]['weights']}: "
            f"error / largest output {errs}")
        del weights, w13, w2
        if max(errs.values()) > 2e-2:
            raise AssertionError(f"sharded MoE disagrees with fused_moe: "
                                 f"{errs}")
    return rows, launches


def _dist_pipeline(torch, np, mesh, mc, params, counters):
    """``llama_forward_pipelined`` at pp 1 over two layers at Llama-3-8B
    width (the engine's weights), batch 2 x 128 tokens in 2 microbatches,
    against ``llama_forward_dense``: within PIPE_TOL of the largest
    logit."""
    import dataclasses

    from flashinfer_tpu_torch.models.llama import (
        PER_LAYER,
        llama_forward_dense,
    )
    from flashinfer_tpu_torch.parallel import llama_forward_pipelined

    cfg = dataclasses.replace(mc, num_layers=2)
    two = {k: (v[:2] if k in PER_LAYER else v) for k, v in params.items()}
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    tokens = torch.randint(0, mc.vocab_size, (2, 128), device=DEVICE,
                           generator=gen)
    want = llama_forward_dense(two, tokens, cfg)
    n0 = counters["rmsnorm"].launches
    got = llama_forward_pipelined(two, tokens, cfg, mesh,
                                  num_microbatches=2)
    launches = counters["rmsnorm"].launches - n0
    rel = float((got - want).abs().max() / want.abs().max())
    argmax = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    log(f"pipelined Llama forward at pp 1 (2 layers, 2 x 128 tokens): "
        f"error / largest logit {rel:.2e}, argmax agreement {argmax:.3f}")
    if rel > PIPE_TOL:
        raise AssertionError(f"pipelined forward off the dense one: {rel}")
    return dict(rel_err=rel, argmax_agreement=argmax), launches


def _dist_tiny(torch, np, mesh, counters):
    """The tiny f32 model on the card: ``DistributedServingEngine`` at dp =
    tp = 1 emits ``LlamaServingEngine``'s greedy tokens exactly on model,
    e4m3 and int8 KV; ``make_tp_decode_step`` at tp 1 gives
    ``llama_forward_dense``'s last-token logits within 2e-4 (JAX's
    tests/test_tp_serving.py). Returns the TP step's launches."""
    from flashinfer_tpu_torch import EngineConfig, LlamaConfig, \
        LlamaServingEngine
    from flashinfer_tpu_torch.models.llama import (
        llama_forward_dense,
        llama_init_weights,
    )
    from flashinfer_tpu_torch.ops.attention.batch import (
        BatchDecodeWithPagedKVCacheWrapper,
    )
    from flashinfer_tpu_torch.parallel import (
        make_tp_decode_step,
        shard_llama_params_tp,
    )
    from flashinfer_tpu_torch.scheduler.native import PagePool
    from flashinfer_tpu_torch.serving.distributed import (
        DistributedServingEngine,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    mc = LlamaConfig.tiny()
    params = llama_init_weights(torch.Generator(device=DEVICE).manual_seed(0),
                                mc, DEVICE)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, mc.vocab_size, n).tolist()
               for n in (9, 30, 4, 17)]
    same = {}
    for kv in ("model", "fp8_e4m3", "int8"):
        cfg = EngineConfig(model=mc, max_batch=2, num_pages=64, page_size=8,
                           max_seq_len=64, greedy=True, kv_dtype=kv,
                           kv_scale=0.3, device=DEVICE)
        outs = []
        for eng in (LlamaServingEngine(cfg, params=params),
                    DistributedServingEngine(cfg, mesh, params=params,
                                             max_tokens_per_step=32)):
            reqs = [eng.add_request(p, 8) for p in prompts]
            eng.run_to_completion(max_steps=200)
            outs.append([r.output for r in reqs])
        same[kv] = outs[0] == outs[1]
    log(f"tiny f32 DistributedServingEngine (dp = tp = 1) == "
        f"LlamaServingEngine: {same}")
    # the TP step, token by token over 4-token prompts
    B, S, PS, PAGES = 2, 4, 4, 16
    tokens = torch.from_numpy(rng.integers(0, mc.vocab_size, (B, S))).to(
        DEVICE)
    want = llama_forward_dense(params, tokens, mc)[:, -1]
    params_tp = shard_llama_params_tp(params, mesh, mc)
    step = make_tp_decode_step(mesh, mc)
    pool = PagePool(num_pages=PAGES, page_size=PS)
    seqs = [pool.create() for _ in range(B)]
    kc = torch.zeros(mc.num_layers, PAGES, PS, mc.num_kv_heads, mc.head_dim,
                     device=DEVICE)
    vc = torch.zeros_like(kc)
    n0 = {k: counters[k].launches for k in ("paged_attention", "rmsnorm")}
    for pos in range(S):
        for s in seqs:
            pool.extend(s, pos + 1)
        indptr, indices, last = pool.batch_export(seqs)
        w = BatchDecodeWithPagedKVCacheWrapper(kv_layout="NHD",
                                               device=DEVICE)
        w.plan(indptr, indices, last, mc.num_qo_heads, mc.num_kv_heads,
               mc.head_dim, PS)

        def dev(a):
            return torch.from_numpy(np.asarray(a, np.int32)).to(DEVICE)

        logits, kc, vc = step(
            params_tp, kc, vc, tokens[:, pos],
            torch.full((B,), pos, device=DEVICE),
            torch.ones(B, dtype=torch.bool, device=DEVICE), dev(indices),
            dev(indptr), dev(last), w.device_plan)
    launches = {k: counters[k].launches - n for k, n in n0.items()}
    err = float((logits - want).abs().max())
    ok_step = bool(torch.allclose(logits, want, rtol=2e-4, atol=2e-4))
    log(f"make_tp_decode_step at tp 1 vs llama_forward_dense: max |err| "
        f"{err:.2e} ({'within' if ok_step else 'OUTSIDE'} 2e-4); launches "
        f"{launches}")
    if not (all(same.values()) and ok_step):
        raise AssertionError(f"tiny distributed paths disagree: {same}, "
                             f"TP step err {err}")
    return dict(engine_tokens_equal=same, tp_step_err=err), launches


def _dist_serve(torch, eng, prompts, n_new, profile_steps=0):
    """Serve the prompts on a distributed engine. Returns (outputs, the
    tokens/s of the steps not profiled, the wall ms of each step that
    admitted nothing, of each that could admit, the profile of
    ``profile_steps`` steps of the first kind or None)."""
    reqs = [eng.add_request(p, n_new) for p in prompts]
    decode_ms, admit_ms = [], []
    prof, profiled, prof_s, prof_tokens = None, not profile_steps, 0.0, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.has_work():
        pending = sum(len(r.pending) for r in eng._reps)
        if (not profiled and not pending
                and eng.num_running == len(prompts)
                and min(r.max_new_tokens - len(r.output)
                        for r in reqs) > profile_steps + 1):
            tp, n0 = time.perf_counter(), eng.generated_tokens
            prof, profiled = _profile_steps(torch, eng.step,
                                            profile_steps), True
            prof_s += time.perf_counter() - tp
            prof_tokens += eng.generated_tokens - n0
            continue
        ts = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        # a step with requests pending may admit some
        (admit_ms if pending else decode_ms).append(
            (time.perf_counter() - ts) * 1e3)
    wall = time.perf_counter() - t0 - prof_s
    tokens_per_s = (eng.generated_tokens - prof_tokens) / wall
    return [r.output for r in reqs], tokens_per_s, decode_ms, admit_ms, prof


def _first_divergence(a, b):
    """For each request, the index of its first token that differs (its
    length where none does)."""
    return [next((i for i, (x, y) in enumerate(zip(p, q)) if x != y),
                 len(p)) for p, q in zip(a, b)]


def _greedy_pair(torch, np, mesh, mc, params, prompts):
    """Greedy tokens of ``LlamaServingEngine`` (graphed) and of
    ``DistributedServingEngine`` at dp = tp = 1 on the same weights and
    traffic, and the share of equal tokens."""
    from flashinfer_tpu_torch import EngineConfig, LlamaServingEngine
    from flashinfer_tpu_torch.serving.distributed import (
        DistributedServingEngine,
    )

    cfg = EngineConfig(model=mc, max_batch=DIST_REQUESTS, page_size=16,
                       greedy=True, device=DEVICE)
    outs = []
    for eng in (LlamaServingEngine(cfg, params=params),
                DistributedServingEngine(cfg, mesh, params=params,
                                         max_tokens_per_step=DIST_ROWS)):
        reqs = [eng.add_request(p, DIST_NEW) for p in prompts]
        eng.run_to_completion()
        outs.append([r.output for r in reqs])
        del eng
        torch.cuda.empty_cache()
    return outs, float(np.mean(np.asarray(outs[0]) == np.asarray(outs[1])))


def _dist_kernel_gate(torch, np, mesh, mc, params, prompts, card):
    """The paged kernel on the distributed engine's own bf16 plans, held to
    its plain version: a greedy Llama-3-8B run at dp = tp = 1 whose steps
    are checked until one with prefill and decode rows together and one of
    decode rows alone have been (layers 0, L / 2 and L - 1 of each: the
    kernel's partial o and lse at every row, against ``paged_attention_
    plain`` on the same q, caches and plan, to the ATTN limits). Runs
    before the counted runs; the check launches nothing."""
    from flashinfer_tpu_torch import EngineConfig
    from flashinfer_tpu_torch.ops.attention import batch as batch_mod
    from flashinfer_tpu_torch.serving.distributed import (
        DistributedServingEngine,
    )

    cfg = EngineConfig(model=mc, max_batch=DIST_REQUESTS, page_size=16,
                       greedy=True, device=DEVICE)
    eng = DistributedServingEngine(cfg, mesh, params=params,
                                   max_tokens_per_step=DIST_ROWS)
    B = cfg.max_batch
    layers = {0, mc.num_layers // 2, mc.num_layers - 1}
    kind = [None]
    checks = []
    run_inputs = eng._replica_inputs

    def record_kind(rep):
        out = run_inputs(rep)
        qo = np.diff(out[1][0])[:B]
        kind[0] = ("mixed" if (qo > 1).any() and (qo == 1).any()
                   else "prefill" if (qo > 1).any() else "decode")
        return out

    kernel = batch_mod.batch_paged_attention_run
    done = set()

    def checked(q, kc, vc, kv_idx, plan, **kw):
        got = kernel(q, kc, vc, kv_idx, plan, **kw)
        layer = kw["kv_indices_offset"] // cfg.num_pages
        if kind[0] in ("mixed", "decode") and kind[0] not in done \
                and layer in layers:
            want = _paged_plain(torch, q, kc, vc, kv_idx, plan, items=64,
                                **kw)
            r = _attn_check(torch, got, want)
            r.update(step=eng.steps, kind=kind[0], layer=layer,
                     items=plan.numel() // 12, tile_q=kw["tile_q"],
                     rows=q.shape[1])
            checks.append(r)
            if layer == max(layers):
                done.add(kind[0])
        return got

    eng._replica_inputs = record_kind
    batch_mod.batch_paged_attention_run = checked
    try:
        for p in prompts:
            eng.add_request(p, DIST_NEW)
        while eng.has_work() and done != {"mixed", "decode"}:
            eng.step()
    finally:
        batch_mod.batch_paged_attention_run = kernel
    del eng
    torch.cuda.empty_cache()
    for r in checks:
        log(f"paged kernel on the distributed engine's plan, step "
            f"{r['step']} ({r['kind']}), layer {r['layer']}: {r['items']} "
            f"items of tile_q {r['tile_q']}, {r['rows']} packed rows; "
            f"err_o {r['err_o']:.3g} ({r['o_ratio']:.3f} of the limit), "
            f"err_lse {r['err_lse']:.3g}, -inf rows equal {r['same_inf']} "
            f"[{card}]")
    bad = [r for r in checks if not r["ok"]]
    if done != {"mixed", "decode"} or bad:
        raise AssertionError(f"paged kernel on the distributed engine's "
                             f"bf16 plans: kinds checked {sorted(done)}, "
                             f"failing {bad}")
    return checks


def _dist_llama(torch, np, mesh, mc, params, prompts, card, counters):
    """The main path: Llama-3-8B at full width through
    ``DistributedServingEngine`` at dp = tp = 1 (the engine phase's
    weights, shared), greedy then sampled, beside ``LlamaServingEngine``'s
    graphed greedy run on the same traffic; greedy token agreement at
    least DIST_MIN_AGREEMENT."""
    from flashinfer_tpu_torch import EngineConfig, LlamaServingEngine
    from flashinfer_tpu_torch.serving.distributed import (
        DistributedServingEngine,
    )

    res = {"kernel_gate": _dist_kernel_gate(torch, np, mesh, mc, params,
                                            prompts, card)}
    outs = {}
    for sampling in ("greedy", "sampled"):
        cfg = EngineConfig(model=mc, max_batch=DIST_REQUESTS, page_size=16,
                           greedy=sampling == "greedy", device=DEVICE)
        eng = DistributedServingEngine(cfg, mesh, params=params,
                                       max_tokens_per_step=DIST_ROWS)
        for k in DIST_PATH:
            counters[k].launches = 0
        # the greedy run is profiled (3 steps, left out of its tokens/s)
        out, tokens_per_s, decode_ms, admit_ms, prof = _dist_serve(
            torch, eng, prompts, DIST_NEW,
            profile_steps=3 if sampling == "greedy" else 0)
        counts = {k: counters[k].launches for k in DIST_PATH}
        outs[sampling] = out
        res[sampling] = dict(
            tokens_per_s=tokens_per_s, steps=eng.steps,
            step_ms_median=float(np.median(decode_ms)),
            step_ms_p90=float(np.percentile(decode_ms, 90)),
            decode_steps_timed=len(decode_ms), admit_step_ms=admit_ms,
            device_ms_per_step=(prof or {}).get("device_ms_per_step"),
            device_ops_per_step=(prof or {}).get("device_ops_per_step"),
            ms_per_step=(prof or {}).get("ms_per_step"),
            top_kernels=(prof or {}).get("top_kernels"),
            planner_ms_per_step=eng.plan_seconds * 1e3 / eng.steps,
            launches=counts, peak_mem_gb=torch.cuda.max_memory_allocated()
            / 1e9)
        log(f"DistributedServingEngine dp=tp=1 Llama-3-8B {sampling}: "
            f"{res[sampling]['tokens_per_s']:.1f} tokens/s, {eng.steps} "
            f"steps of {DIST_ROWS} rows, decode step median "
            f"{res[sampling]['step_ms_median']:.2f} ms (n "
            f"{len(decode_ms)}), device "
            f"{res[sampling]['device_ms_per_step']} ms a step "
            f"{res[sampling]['ms_per_step']} (top kernels "
            f"{(res[sampling]['top_kernels'] or [])[:6]}), steps that could "
            f"admit "
            f"{[round(x, 1) for x in admit_ms]} ms, planner "
            f"{res[sampling]['planner_ms_per_step']:.3f} ms; launches "
            f"{counts} [{card}]")
        del eng
        torch.cuda.empty_cache()
    # LlamaServingEngine, graphed greedy, on the same weights and traffic
    cfg = EngineConfig(model=mc, max_batch=DIST_REQUESTS, page_size=16,
                       greedy=True, device=DEVICE)
    eng = LlamaServingEngine(cfg, params=params)
    reqs, wall, decode_ms, _, _ = _serve(torch, eng, prompts, DIST_NEW)
    replay_ms = None
    if eng.graphs.enabled:
        replay_ms = cuda_ms(torch, lambda: eng.graphs.replay(
            eng.graphs.last_key), 10)
    single = [r.output for r in reqs]
    res["llama_engine_graphed_greedy"] = dict(
        tokens_per_s=sum(len(o) for o in single) / wall,
        step_ms_median=float(np.median(decode_ms)),
        replay_device_ms=replay_ms)
    del eng
    torch.cuda.empty_cache()
    agree = float(np.mean(np.asarray(outs["greedy"]) == np.asarray(single)))
    res["greedy_agreement"] = agree
    res["first_divergence"] = _first_divergence(outs["greedy"], single)
    res["requests_equal"] = sum(a == b for a, b in zip(outs["greedy"],
                                                       single))
    g, s = res["greedy"], res["llama_engine_graphed_greedy"]
    log(f"Llama-3-8B greedy step: DistributedServingEngine "
        f"{g['step_ms_median']:.2f} ms wall / {g['device_ms_per_step']} ms "
        f"device (eager, {DIST_ROWS} rows) vs LlamaServingEngine graphed "
        f"{s['step_ms_median']:.2f} ms wall / {replay_ms} ms device "
        f"(a replay, 8 rows); token agreement {agree:.3f} "
        f"({res['requests_equal']} of {len(single)} requests identical; "
        f"first differing token of each: {res['first_divergence']}) "
        f"[{card}]")
    # the same traffic with the weights in f32 (TF32 off), both engines:
    # what the bf16 roundings leave of the agreement
    import dataclasses

    f32 = {k: v.float() for k, v in params.items()}
    outs32, agree32 = _greedy_pair(
        torch, np, mesh, dataclasses.replace(mc, dtype=torch.float32), f32,
        prompts)
    del f32
    torch.cuda.empty_cache()
    res["f32_greedy_agreement"] = agree32
    res["f32_first_divergence"] = _first_divergence(*outs32)
    log(f"Llama-3-8B in f32: token agreement {agree32:.3f}, first differing "
        f"token of each request {res['f32_first_divergence']} [{card}]")
    missing = [k for k, n in res["sampled"]["launches"].items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the distributed "
                             f"path: {missing}")
    if agree32 < DIST_MIN_AGREEMENT:
        raise AssertionError(f"f32 greedy token agreement {agree32:.3f} "
                             f"below {DIST_MIN_AGREEMENT}")
    return res


def phase_distributed(torch, np, card, shared):
    """World size 1 through NCCL: the process group (a FileStore), the
    mesh views of ``Mapping(world_size=1)``, every collective and
    ``MoeAlltoAll``, ring / Ulysses attention, the sharded MoE layers, the
    pipelined forward, the tiny f32 engine and TP step, then Llama-3-8B
    through ``DistributedServingEngine``; a probe of NCCL send/recv to
    the own rank runs beside it in a process of its own. The group is
    destroyed at the end, whatever happened."""
    import tempfile

    import torch.distributed as dist

    from flashinfer_tpu_torch.parallel import Mapping, make_mesh

    counters = _reset_counts()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    probe = subprocess.Popen(
        [sys.executable, "-c", SELF_P2P_PROBE, os.path.join(tmp, "probe")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(DIST_BACKEND, init_method="file://" + os.path.join(
        tmp, "store"), rank=0, world_size=1)
    res = {}
    try:
        ctx = make_mesh(Mapping(world_size=1), DEVICE)
        if "llama" in shared:
            mc, params, prompts = shared.pop("llama")
        else:  # the engine phase failed: draw its weights again
            from flashinfer_tpu_torch import LlamaConfig
            from flashinfer_tpu_torch.models.llama import llama_init_weights

            mc = LlamaConfig.llama3_8b()
            params = llama_init_weights(
                torch.Generator(device=DEVICE).manual_seed(0), mc, DEVICE)
            rng = np.random.default_rng(0)
            prompts = [rng.integers(0, mc.vocab_size, int(n)).tolist()
                       for n in rng.integers(64, 513, 12)]
        res["collectives"] = _dist_collectives(torch, np, ctx.mesh,
                                               ctx.moe_mesh)
        res["attention"], attn_n = _dist_attention(torch, np, ctx.mesh,
                                                   counters)
        res["moe"], moe_n = _dist_moe(torch, np, ctx.moe_mesh, counters)
        res["pipeline"], pipe_n = _dist_pipeline(torch, np, ctx.mesh, mc,
                                                 params, counters)
        res["tiny"], tp_n = _dist_tiny(torch, np, ctx.mesh, counters)
        res["llama"] = _dist_llama(torch, np, ctx.mesh, mc, params,
                                   prompts[:DIST_REQUESTS], card, counters)
        del params
        res["launches"] = dict(
            distributed=res["llama"]["sampled"]["launches"],
            parallel_attention={"flash_attention": attn_n},
            parallel_moe={"grouped_gemm": moe_n},
            pipeline={"rmsnorm": pipe_n}, tp_step=tp_n)
    finally:
        dist.destroy_process_group()
        try:
            out = probe.communicate(timeout=120)[0]
        except subprocess.TimeoutExpired:
            probe.kill()
            out = probe.communicate()[0] + "\n(probe timed out, killed)"
        shutil.rmtree(tmp, ignore_errors=True)
    works = "SELF_P2P True" in out
    res["self_send_recv"] = works
    log(f"NCCL batch_isend_irecv to the own rank at world 1: "
        f"{'works' if works else 'does not work'} (rc {probe.returncode}; "
        f"{out.strip().splitlines()[-1] if out.strip() else 'no output'})")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every measurement here (JSON)")
    args = ap.parse_args()
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a machine with a CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, SOURCE_DIR)):
        print(f"chip_smoke: no {SOURCE_DIR}/ beside this script; run it "
              "from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, root)

    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    ph = Phases()
    t_start = time.perf_counter()
    card = ph.run("card", phase_card) or "card unknown"
    ph.run("build", phase_build)
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 513, 12)
    # the engine's first prefill (8 slots) and a decode batch whose longest
    # sequence crosses the 512-token chunk, so split-KV partials merge
    lens_prefill = [int(n) for n in lens[:8]]
    lens_decode = [int(n) + 16 for n in lens[:7]] + [540]
    native = ph.run("native host runtime", phase_native, torch, np,
                    lens_decode, lens_prefill)
    attn = ph.run("kernel check: paged attention", check_paged_attention,
                  torch, np, lens_decode, lens_prefill)
    samp = ph.run("kernel check: sampler", check_sampler, torch)
    pipes = ph.run("logits pipe", phase_logits_pipe, torch, card)
    norm = ph.run("kernel check: rmsnorm", check_rmsnorm, torch)
    mla = ph.run("kernel check: MLA attention", check_mla, torch, np)
    gg = ph.run("kernel check: grouped GEMM", check_grouped_gemm, torch, np)
    w8 = ph.run("kernel check: grouped GEMM as w8_matmul", check_w8_matmul,
                torch, np)
    torch.cuda.empty_cache()
    moe_api = ph.run("MoE entry points", phase_moe_entries, torch, np, card)
    torch.cuda.empty_cache()
    flash = ph.run("kernel check: flash attention", check_flash_attention,
                   torch, np)
    single = ph.run("single request", phase_single_request, torch, np, card)
    pod = ph.run("POD", phase_pod, torch, np, card)
    casc = ph.run("cascade", phase_cascade, torch, np, card)
    surf = ph.run("paged surface", phase_paged_surface, torch, np, card,
                  lens_decode, lens_prefill)
    torch.cuda.empty_cache()
    var = ph.run("variants", phase_variants, torch, np, card, lens_decode,
                 lens_prefill)
    torch.cuda.empty_cache()
    ph.run("tiny reference", phase_tiny_reference, torch, np)
    ph.run("tiny DeepSeek reference", phase_tiny_deepseek, torch, np)
    ph.run("tiny Mixtral reference", phase_tiny_mixtral, torch, np)
    shared = {}
    eng = ph.run("engine", phase_engine, torch, np, card, shared)
    # before the distributed phase, which takes the engine's weights
    pages = ph.run("pages", phase_pages, torch, np, card, shared,
                   lens_decode, lens_prefill)
    dist_res = ph.run("distributed", phase_distributed, torch, np, card,
                      shared)
    shared.clear()
    torch.cuda.empty_cache()
    dsk = ph.run("DeepSeek", phase_deepseek, torch, np, card)
    torch.cuda.empty_cache()
    mix = ph.run("Mixtral", phase_mixtral, torch, np, card)
    torch.cuda.empty_cache()
    tools = ph.run("tooling", phase_tooling, torch, np, card)

    # each path's sampled run, its counts set to 0 just before it; a kernel
    # on both paths reports the launches of both runs
    by_path = {"llama": (eng or {}).get("graphed", {}).get(
                   "sampled", {}).get("launches", {}),
               "spec": (eng or {}).get("spec", {}).get(
                   "sampled", {}).get("launches", {}),
               "llama_w8": (eng or {}).get("w8", {}).get(
                   W8_MODES[0][0], {}).get("launches", {}),
               "deepseek": (dsk or {}).get("sampled", {}).get("launches", {}),
               "mixtral": (mix or {}).get("sampled", {}).get("launches", {}),
               "single": (single or {}).get("launches", {}),
               "pod": (pod or {}).get("launches", {}),
               "cascade": (casc or {}).get("launches", {}),
               "surface": (surf or {}).get("launches", {}),
               "variants": (var or {}).get("launches", {}),
               "moe_api": (moe_api or {}).get("launches", {}),
               "pipe": (pipes or {}).get("launches", {}),
               "pages": (pages or {}).get("launches", {})}
    # the distributed phase's paths: the engine's sampled run, then the
    # ring / Ulysses, sharded MoE, pipelined and TP-step calls
    by_path.update((dist_res or {}).get("launches", {}))

    def launches(name):
        return sum(counts.get(name, 0) for counts in by_path.values())

    kernels = []
    if attn:
        main_row = next(r for r in attn if r["mode"] == "decode"
                        and r["d"] == 128 and r["layout"] == "NHD"
                        and r["kv"] == "bf16")
        kernels.append(dict(
            name="paged_attention", route="cuda",
            source="flashinfer_tpu_torch/csrc/paged_attention.cu",
            replaces="flashinfer_tpu/ops/attention/kernels/paged.py:161",
            launches=launches("paged_attention"),
            max_abs_err=max(r["err_o"] for r in attn), ms=main_row["ms"],
            plain_ms=main_row["plain_ms"], bound_ms=main_row["bound_ms"],
            bound_by=main_row["bound_by"], library_ms=None))
    if pages:
        main_row = next(r for r in pages["rows"] if r["mode"] == "decode"
                        and r["d"] == 128 and r["page_size"] == ODD_PAGES[0]
                        and r["layout"] == "NHD" and r["kv"] == "bf16")
        kernels.append(dict(
            name=GATHER_LIB, route="cuda",
            source=f"flashinfer_tpu_torch/csrc/{GATHER_LIB}.cu",
            replaces="flashinfer_tpu/ops/attention/kernels/paged.py:161",
            launches=launches(GATHER_LIB),
            max_abs_err=max(r["err_o"] for r in pages["rows"]),
            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=None))
    if samp:
        kernels.append(dict(
            name="sampler_family", route="cuda",
            source="flashinfer_tpu_torch/csrc/sampling.cu",
            replaces="flashinfer_tpu/ops/sampling.py:484",
            launches=launches("sampler_family"),
            max_abs_err=max(x["err"] for x in samp), ms=samp[0]["ms"],
            plain_ms=samp[0]["plain_ms"], bound_ms=samp[0]["bound_ms"],
            bound_by=samp[0]["bound_by"], library_ms=None))
    if norm:
        r = norm[0]
        kernels.append(dict(
            name="rmsnorm", route="cuda",
            source="flashinfer_tpu_torch/csrc/norm.cu",
            replaces="flashinfer_tpu/ops/norm.py:80",
            launches=launches("rmsnorm"),
            max_abs_err=max(x["err"] for x in norm), ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            # the fused mode, which 64 of 65 Llama and 54 of 55 DeepSeek
            # norms a step launch
            fused_ms=r["fused_ms"], fused_bound_ms=r["fused_bound_ms"]))
    if mla:
        main_row = next(r for r in mla if r["mode"] == "decode"
                        and r["kv"] == "bf16")
        kernels.append(dict(
            name="mla_attention", route="cuda",
            source="flashinfer_tpu_torch/csrc/mla_attention.cu",
            replaces="flashinfer_tpu/ops/attention/mla.py:67",
            launches=launches("mla_attention"),
            max_abs_err=max(r["err_o"] for r in mla), ms=main_row["ms"],
            plain_ms=main_row["plain_ms"], bound_ms=main_row["bound_ms"],
            bound_by=main_row["bound_by"], library_ms=None))
    if gg and w8:
        main_row = next(r for r in gg if r["case"] == "v2lite_decode"
                        and r["gemm"] == "gemm1" and r["w"] == "bf16")
        # the 8-bit weight path's largest decode matmul
        w8_row = next(r for r in w8 if r["shape"] == "gate_up"
                      and r["rows"] == 8 and r["w"] == "e4m3")
        kernels.append(dict(
            name="grouped_gemm", route="cuda",
            source="flashinfer_tpu_torch/csrc/grouped_gemm.cu",
            replaces="flashinfer_tpu/ops/gemm_grouped.py:157",
            launches=launches("grouped_gemm"),
            max_abs_err=max(r["err"] for r in gg + w8), ms=main_row["ms"],
            plain_ms=main_row["plain_ms"], bound_ms=main_row["bound_ms"],
            bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"],
            # w8_matmul (the engine's _wmm on 8-bit weights) at
            # Llama-3-8B's decode gate/up, e4m3
            w8_ms=w8_row["ms"], w8_plain_ms=w8_row["plain_ms"],
            w8_bound_ms=w8_row["bound_ms"], w8_bound_by=w8_row["bound_by"],
            w8_cast_matmul_ms=w8_row["cast_matmul_ms"],
            w8_bf16_matmul_ms=w8_row["bf16_matmul_ms"]))
    if flash:
        main_row = next(r for r in flash if r["case"] == "llama_prefill")
        kernels.append(dict(
            name="flash_attention", route="cuda",
            source="flashinfer_tpu_torch/csrc/flash_attention.cu",
            replaces="flashinfer_tpu/ops/attention/kernels/flash.py:93",
            launches=launches("flash_attention"),
            max_abs_err=max(r["err_o"] for r in flash), ms=main_row["ms"],
            plain_ms=main_row["plain_ms"], bound_ms=main_row["bound_ms"],
            bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"]))
    for row in kernels:  # the paths that launch each kernel
        row["launches_by_path"] = {k: v[row["name"]]
                                   for k, v in by_path.items()
                                   if v.get(row["name"])}
    log(f"total {time.perf_counter() - t_start:.1f} s [{card}]")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, native=native, pipes=pipes,
                           moe_api=moe_api, tooling=tools,
                           attention=attn, sampler=samp,
                           rmsnorm=norm, mla=mla, grouped_gemm=gg,
                           w8_matmul=w8,
                           flash=flash, single=single, pod=pod,
                           cascade=casc, surface=surf, variants=var,
                           engine=eng,
                           deepseek=dsk, distributed=dist_res, pages=pages,
                           mixtral=mix, kernels=kernels,
                           launches_by_path=by_path, failed=ph.failed), f,
                      indent=1)
    if ph.failed:
        log(f"FAILED phases: {ph.failed}")
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
