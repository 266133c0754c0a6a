#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``flashinfer_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out PATH]

Run from the root of a checkout. Phases, in order:

1. card: the card's name and power limit from nvidia-smi;
2. build: every CUDA kernel built with nvcc from ``flashinfer_tpu_torch/csrc``
   (one process per source, all at once); ``cuobjdump -sass`` counts the
   wgmma (HGMMA), TMA load (UTMALDG) and mma.sync (HMMA) instructions of
   the flash, grouped-GEMM and paged-attention libraries, and the phase
   fails if one lacks wgmma or TMA, or the grouped GEMM holds an mma.sync;
3. kernel checks: each kernel against its plain PyTorch version on the card
   with its time (CUDA events), its bound, the plain version's time and,
   where one PyTorch call computes the same function, that call's time:
   paged attention, the sampler and RMSNorm at the shapes the Llama-3-8B
   engine gives them (paged attention also at the speculative verify plan,
   at head_dim 256 and on POD's combined plan; the sampler also in renorm
   mode at the verify step's 32 rows and its draw); MLA attention at
   DeepSeek-V2-Lite shapes (decode and causal prefill, bf16/e4m3/int8
   caches); the grouped GEMM (both MoE GEMMs, bf16 and e4m3 weights) at
   the V2-Lite decode and prefill routings and a Mixtral-8x7B layer, and
   as ``w8_matmul`` (one group, per-column scales) at Llama-3-8B's five
   weight shapes, 8 / 32 / 4096 rows, e4m3 and int8 weights, beside the
   cast + ``torch.matmul`` route and bf16 ``torch.matmul``; the flash kernel at Llama-3-8B prefill (8192 tokens
   causal), chunked prefill (2048 at the tail of 8192) and decode (32K
   keys), DeepSeek-V2-Lite's MHA prefill (d 192, dv 128), each variant at
   Llama widths on 2048 tokens, and a small f32 case;
4. single request: Llama-3-8B widths over 32 layers, an 8192-token prompt
   through ``single_prefill_with_kv_cache`` and 32
   ``single_decode_with_kv_cache`` steps (the single path: its flash
   launches are read here), then a tiny f32 case card vs CPU;
5. POD: 32 decodes of 512-4096 keys beside a 2048-token chunk of an
   8192-token prompt, Llama-3-8B widths, page 16, HND, 32 layers, both modes
   (the pod path: its launches are read here); the modes must agree with
   their plain versions and each other; the two-launch mode is then traced
   (device time by kernel family, busy share);
6. tiny references: the f32 tiny Llama engine and the f32 tiny DeepSeek
   decode loop on the card (every kernel on) emit the greedy tokens of the
   same model on the CPU (every plain version); the tiny engine with
   speculative decoding (3 drafts) on repetitive prompts emits them on the
   card, on the CPU and without drafts, with drafts accepted; the tiny
   engine with e4m3 and int8 weights (decode, window 4, 3 drafts) emits
   the CPU's tokens;
7. engine: ``LlamaServingEngine`` at Llama-3-8B widths and depth in bf16,
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
   with the bf16 greedy tokens;
8. DeepSeek: ``deepseek_decode_step`` at DeepSeek-V2-Lite widths and full
   depth (27 layers) in bf16, random weights from a seeded CUDA generator,
   8 requests of 32-128 prompt tokens prefilled token by token and 32 new
   tokens each, one MLA plan per step: sampled (top-k 40, top-p 0.9: the
   DeepSeek path, whose launch counts are read from this run), greedy,
   then a short greedy run on e4m3 caches and the e4m3 witness (one step
   on bf16, e4m3 and bf16-fed-e4m3-values caches: the last two must
   agree);
9. one ``{"kernels": [...]}`` line, then the result line.

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
                    or (name in TENSOR_CORE_LIBS and "C75" in ln
                        and "C7519" not in ln)):
                log("  ptxas:", ln.strip())
    for name in TENSOR_CORE_LIBS:
        sass = sass_counts(name)
        log(f"{name} SASS: {sass}")
        if not (sass["HGMMA"] and sass["UTMALDG"]):
            raise AssertionError(f"{name} lacks wgmma or TMA: {sass}")
        if name == "grouped_gemm" and sass["HMMA"]:
            raise AssertionError(f"{name} still holds mma.sync: {sass}")
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


def _engine_like_plans(np, lens_decode, lens_prefill, d=128):
    """Plans built as the engine builds them (engine.py _decode and
    _prefill) at Llama-3-8B heads (head_dim ``d``), page 16, chunk 512."""
    from flashinfer_tpu_torch.ops.attention.batch import (
        BatchDecodeWithPagedKVCacheWrapper,
        BatchPrefillWithPagedKVCacheWrapper,
    )
    from flashinfer_tpu_torch.utils import next_power_of_2

    ps, hq, hkv, chunk, page_bucket = 16, 32, 8, 512, 1024

    def table(lens):
        npages = -(-np.asarray(lens) // ps)
        indptr = np.concatenate([[0], np.cumsum(npages)]).astype(np.int32)
        indices = np.random.default_rng(1).permutation(
            int(indptr[-1])).astype(np.int32)
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


def _attn_check(torch, got, want):
    """err_o (largest |o| error), o_ratio (the largest error over its ATTN
    limit: <= 1 passes), ref_at_worst (|ref o| where that ratio is
    reached), err_lse, same_inf (-inf lse at the same places) and ok."""
    (o, lse), (ref_o, ref_lse) = got, want
    diff = (o.float() - ref_o.float()).abs()
    ratios = diff / (ATTN_RTOL_O * ref_o.float().abs() + ATTN_ATOL_O)
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


def _paged_plain(torch, q, kc, vc, kv_idx, plan, items=256, **kw):
    """``paged_attention_plain`` over the work list ``items`` items at a
    time (POD's combined plan holds ~1000 items of 256 rows x 512 keys)."""
    from flashinfer_tpu_torch.ops.attention.kernels.paged import (
        paged_attention_plain,
    )

    rows = plan.reshape(12, -1)
    outs = [paged_attention_plain(
                q, kc, vc, kv_idx,
                rows[:, a:a + items].contiguous().reshape(-1), **kw)
            for a in range(0, rows.shape[1], items)]
    return tuple(torch.cat(x) for x in zip(*outs))


def check_paged_attention(torch, np, lens_decode, lens_prefill):
    """The paged kernel against its plain version on every row (padding
    rows: the identity in both), timed, at the engine's Llama-3-8B decode
    and prefill plans (NHD and HND; bf16, e4m3 and int8 caches), the same
    decode at head_dim 256, and POD's combined plan (HND, Llama-3-8B widths:
    32 decodes in 256-row tiles beside a 2048-token chunk)."""
    from flashinfer_tpu_torch.ops.attention.batch import pack_queries
    from flashinfer_tpu_torch.ops.attention.kernels.paged import (
        batch_paged_attention_run,
    )
    from flashinfer_tpu_torch.utils import TensorLayout

    hq, hkv, ps = 32, 8, 16
    group = hq // hkv
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(7)
    cases = [(mode, 128, plan,
              ("NHD",) if mode == "verify" else ("NHD", "HND"))
             for mode, plan in
             _engine_like_plans(np, lens_decode, lens_prefill).items()]
    cases.append(("decode", 256, _engine_like_plans(
        np, lens_decode, lens_prefill, d=256)["decode"], ("NHD", "HND")))
    cases.append(("pod_combined", 128, _pod_combined_case(np), ("HND",)))
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
                           q_shape=list(q.shape), kv_tokens=int(kv_lens.sum()),
                           T=m.num_work_items, tile_q=m.tile_q,
                           splits=m.max_splits, err_o=chk["err_o"],
                           o_ratio=chk["o_ratio"], err_lse=chk["err_lse"],
                           same_inf=chk["same_inf"], ms=ms, call_ms=call_ms,
                           plain_ms=plain_ms, bound_bytes=nbytes,
                           bound_ops=ops, bound_ms=b_ms, bound_by=b_by,
                           ok=chk["ok"])
                rows.append(row)
                log(f"paged_attention {mode:12s} d={d} {layout} {kv_dtype:4s} "
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
        raise AssertionError(f"paged attention kernel disagrees with its "
                             f"plain version: {bad}")
    return rows


# (name, batch, vocab, filter, out mode): the seq draw at both paths'
# shapes (the DeepSeek path draws for one row when one request emits), and
# the row-writing modes at the Llama shape
SAMPLER_CASES = (
    ("llama", 8, 128256, "top_k_top_p_seq", "sample"),
    ("deepseek", 8, 102400, "top_k_top_p_seq", "sample"),
    ("deepseek_one", 1, 102400, "top_k_top_p_seq", "sample"),
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
    bf16 and e4m3 weights in the models' [E, N, K] layout, at three
    routings: V2-Lite decode (8 tokens, top-6 of 64 experts, 2048 -> 2816
    and 1408 -> 2048), a 2048-token V2-Lite prefill, and the JAX bench's
    Mixtral-8x7B layer (4096 tokens, top-2 of 8, 4096 <-> 14336)."""
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
           "sampler_family": family_call, "rmsnorm": rmsnorm,
           "mla_attention": mla_paged_run,
           "grouped_gemm": grouped_gemm_padded,
           "flash_attention": flash_attention_dense}
    for fn in fns.values():
        fn.launches = 0
    return fns


LLAMA_PATH = ("paged_attention", "sampler_family", "rmsnorm")
# Llama with 8-bit weights: every matmul is a grouped-GEMM launch
LLAMA_W8_PATH = LLAMA_PATH + ("grouped_gemm",)
SPEC_TOKENS = 3  # drafts a sequence in the spec modes
DEEPSEEK_PATH = ("mla_attention", "grouped_gemm", "rmsnorm",
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
    res = dict(
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
        f"{plan_ms:.3f} ms a decode step; graphs {json.dumps(graphs)}; "
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


def phase_engine(torch, np, card):
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
    results["variants"] = _engine_variants(
        torch, np, mc, params, prompts[:8], outs_by["graphed", "greedy"])
    results["w8"] = _engine_w8(torch, np, mc, params, prompts, n_new, card,
                               outs_by["graphed", "greedy"])
    return results


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

def deepseek_serve(torch, np, cfg, params, prompts, n_new, *, device,
                   sampled, kv="model", kv_scale=0.25, chunk=64, seed=0,
                   profile_at=None):
    """Serve ``prompts`` through ``deepseek_decode_step``: every step feeds
    each unfinished request its next prompt token (prefill token by token)
    or its last generated token, under one MLA plan, and a request emits a
    token from its last prompt position on, until it has ``n_new``.
    Sampled: top-k 40, top-p 0.9 on the sampler kernel; else greedy. The
    caches are bf16 (``kv="model"``) or e4m3 with ``kv_scale``. With
    ``profile_at``, the three steps from that one are traced (and left out
    of the step times). Request i takes pages from the bottom of the pool
    in turn (request i's first page is page i). Returns a dict: ``outs``
    (the tokens of each request), ``wall_s``, ``step_ms``, ``profile``, the
    first and the last step's logits (``logits0``, ``logits``) and the
    caches (``ckv``, ``kpe``)."""
    from flashinfer_tpu_torch.models.deepseek import deepseek_decode_step
    from flashinfer_tpu_torch.ops.attention.mla import (
        BatchMLAPagedAttentionWrapper,
    )
    from flashinfer_tpu_torch.ops.rope import rope_cos_sin_cache
    from flashinfer_tpu_torch.ops.sampling import (
        draw_seed,
        softmax,
        top_k_top_p_sampling_from_probs,
    )
    from flashinfer_tpu_torch.scheduler.page_pool import PagePool

    B, L = len(prompts), cfg.num_layers
    total = max(len(p) for p in prompts) + n_new
    per_req = -(-total // MLA_PAGE)
    pool = PagePool(B * per_req, MLA_PAGE)
    seqs = [pool.create() for _ in prompts]
    dt = torch.float8_e4m3fn if kv == "e4m3" else cfg.dtype
    shape = (L, B * per_req, MLA_PAGE)
    ckv = torch.zeros(*shape, cfg.head_dim_ckv, device=device).to(dt)
    kpe = torch.zeros(*shape, cfg.head_dim_kpe, device=device).to(dt)
    cos_sin = (rope_cos_sin_cache(total, cfg.head_dim_kpe,
                                  rope_theta=cfg.rope_theta, device=device)
               if kv == "e4m3" else None)
    sm_scale = (cfg.head_dim_qk_nope + cfg.head_dim_kpe) ** -0.5
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
        w = BatchMLAPagedAttentionWrapper(device=device)
        w.plan(np.arange(len(live) + 1), indptr, indices,
               np.full(len(live), t + 1), cfg.num_heads, cfg.head_dim_ckv,
               cfg.head_dim_kpe, MLA_PAGE, sm_scale=sm_scale,
               kv_chunk_size=chunk)
        toks = [prompts[i][t] if t < len(prompts[i]) else outs[i][-1]
                for i in live]
        host = np.concatenate([toks, indices, indptr, last]).astype(np.int64)
        dev = torch.from_numpy(host).to(device)
        n, ni = len(live), len(indices)
        tabs = (dev[n: n + ni].int(), dev[n + ni: 2 * n + ni + 1].int(),
                dev[2 * n + ni + 1:].int())
        lg, _, _ = deepseek_decode_step(
            params, cfg, dev[:n], torch.full((n,), t, device=device), ckv,
            kpe, *tabs, w, kv_scale=kv_scale if kv == "e4m3" else 1.0,
            cos_sin_cache=cos_sin)
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
                profile=prof, ckv=ckv, kpe=kpe, **logits)


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
    n_new = 32
    results = {}
    for mode in ("sampled", "greedy"):
        counters = _reset_counts()
        run = deepseek_serve(torch, np, cfg, params, prompts, n_new,
                             device=DEVICE, sampled=mode == "sampled",
                             profile_at=min(len(p) for p in prompts) // 2)
        outs, wall, step_ms, prof = (run["outs"], run["wall_s"],
                                     run["step_ms"], run["profile"])
        del run
        counts = {k: counters[k].launches for k in DEEPSEEK_PATH}
        assert all(len(o) == n_new for o in outs), [len(o) for o in outs]
        assert all(0 <= t < cfg.vocab_size for o in outs for t in o)
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
        log(f"deepseek {mode}: {gen_tokens} tokens in {wall:.2f} s = "
            f"{res['tokens_per_s']:.1f} tokens/s over {res['steps']} steps "
            f"(prompts {[len(p) for p in prompts]} fed token by token); step "
            f"median {res['step_ms_median']:.2f} ms, p90 "
            f"{res['step_ms_p90']:.2f} ms; launches {counts}; peak memory "
            f"{res['peak_mem_gb']:.2f} GB [{card}]")
        if prof:
            log(f"deepseek {mode} profile, per step at batch 8: device "
                f"{prof['device_ms_per_step']:.2f} ms in "
                f"{prof['device_ops_per_step']} device ops (traced wall "
                f"{prof['profiled_wall_ms_per_step']:.2f} ms), busy share "
                f"{prof['busy_share']:.3f}; by family "
                f"{json.dumps(prof['ms_per_step'])}")
            for ms, n, name in prof["top_kernels"]:
                log(f"  device {ms:8.3f} ms  x{n:<5d} {name}")
        else:
            log(f"deepseek {mode} profile: the profiler recorded no device "
                "time (not measured)")
        missing = [k for k, n in counts.items() if n == 0]
        if mode == "sampled" and missing:
            raise AssertionError(f"kernels not launched on the DeepSeek "
                                 f"path: {missing}")
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


# --------------------------------------------------------------------- main

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
    attn = ph.run("kernel check: paged attention", check_paged_attention,
                  torch, np, lens_decode, lens_prefill)
    samp = ph.run("kernel check: sampler", check_sampler, torch)
    norm = ph.run("kernel check: rmsnorm", check_rmsnorm, torch)
    mla = ph.run("kernel check: MLA attention", check_mla, torch, np)
    gg = ph.run("kernel check: grouped GEMM", check_grouped_gemm, torch, np)
    w8 = ph.run("kernel check: grouped GEMM as w8_matmul", check_w8_matmul,
                torch, np)
    torch.cuda.empty_cache()
    flash = ph.run("kernel check: flash attention", check_flash_attention,
                   torch, np)
    single = ph.run("single request", phase_single_request, torch, np, card)
    pod = ph.run("POD", phase_pod, torch, np, card)
    ph.run("tiny reference", phase_tiny_reference, torch, np)
    ph.run("tiny DeepSeek reference", phase_tiny_deepseek, torch, np)
    eng = ph.run("engine", phase_engine, torch, np, card)
    torch.cuda.empty_cache()
    dsk = ph.run("DeepSeek", phase_deepseek, torch, np, card)

    # each path's sampled run, its counts set to 0 just before it; a kernel
    # on both paths reports the launches of both runs
    by_path = {"llama": (eng or {}).get("graphed", {}).get(
                   "sampled", {}).get("launches", {}),
               "spec": (eng or {}).get("spec", {}).get(
                   "sampled", {}).get("launches", {}),
               "llama_w8": (eng or {}).get("w8", {}).get(
                   W8_MODES[0][0], {}).get("launches", {}),
               "deepseek": (dsk or {}).get("sampled", {}).get("launches", {}),
               "single": (single or {}).get("launches", {}),
               "pod": (pod or {}).get("launches", {})}

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
            # the paths that launch it, and w8_matmul (the engine's _wmm
            # on 8-bit weights) at Llama-3-8B's decode gate/up, e4m3
            launches_by_path={k: v.get("grouped_gemm", 0)
                              for k, v in by_path.items()
                              if v.get("grouped_gemm")},
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
    log(f"total {time.perf_counter() - t_start:.1f} s [{card}]")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, attention=attn, sampler=samp,
                           rmsnorm=norm, mla=mla, grouped_gemm=gg,
                           w8_matmul=w8,
                           flash=flash, single=single, pod=pod,
                           engine=eng, deepseek=dsk, kernels=kernels,
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
