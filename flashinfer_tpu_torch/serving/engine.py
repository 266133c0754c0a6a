"""Continuous-batching serving engine for the Llama family.

Counterpart of ``flashinfer_tpu/serving/engine.py``, with the same host-side
scheduling: a page pool for KV blocks, one attention plan per step, admission
with prefill, one decode token per running sequence per step (or N of them
with ``decode_window`` N, or up to G + 1 with speculative decoding,
``spec_tokens`` G), and recompute preemption (the youngest sequence is
evicted and later re-prefilled with its prompt and output) when the pool
runs out.

The device step is plain PyTorch around the package's CUDA kernels: RMSNorm
(every norm after the first adds the residual in the same launch), paged
attention, the sampler and, with 8-bit weights, the grouped GEMM as every
matmul (``_wmm``). On CPU tensors every kernel runs its plain version.

The decode step has fixed shapes, as JAX's jitted ``_decode_step``: all
``max_batch`` slots run, a ``valid`` mask marks the live ones, and one
int32 input buffer holds the plan blob, the step's rows and the sampling
seed, which go up in one copy. On a CUDA device the step runs as a CUDA
graph, one per ``PlanMeta`` (``serving/graphs.py``); ``cuda_graphs=False``
runs it eagerly, with the same tokens. Prefill, ``score()`` and
``calibrate_kv_scales`` run eagerly.

Speculative decoding (``spec_tokens`` G > 0) proposes G drafts a sequence
from its own context (``propose_ngram``) and verifies the G + 1 rows in one
causal qo > 1 step of fixed shape, replayed from a CUDA graph per
``("verify", PlanMeta)``: greedy keeps the drafts the argmax agrees with
and adds its next token; sampled runs ``chain_speculative_sampling`` on
the top-k/top-p renormalised targets with one-hot drafts. The KV of the
rejected rows is rolled back.

The engine serves model-dtype, e4m3 or linear-int8 weights
(``weight_dtype``; the 8-bit ones quantized at init as JAX's engine does,
with per-output-channel scales) with KV caches in the model dtype, e4m3
(``torch.float8_e4m3fn``) or linear int8, in the NHD or HND layout, greedy
or sampled. An 8-bit weight runs ``ops.gemm_grouped.w8_matmul``: one
launch of the grouped GEMM that decodes the weight in registers and
applies its scales to the f32 accumulator, in every path (prefill, the
graphed decode step, the window, the verify step, ``score()``,
``calibrate_kv_scales``). ``EngineConfig`` has no ``interpret`` field: the
JAX engine's Pallas interpret switch has no meaning on the card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from flashinfer_tpu_torch.models.llama import (
    PER_LAYER,
    SCALE_SUFFIXES,
    LlamaConfig,
    e4m3_views,
    llama_init_weights,
    quantize_llama_weights_fp8,
    quantize_llama_weights_int8,
)
from flashinfer_tpu_torch.ops.activation import silu_and_mul
from flashinfer_tpu_torch.ops.gemm_grouped import w8_matmul
from flashinfer_tpu_torch.ops.attention.batch import (
    BatchDecodeWithPagedKVCacheWrapper,
    BatchPrefillWithPagedKVCacheWrapper,
    DevicePlan,
    PlanMeta,
    run_device_plan,
)
from flashinfer_tpu_torch.ops.norm import add_rmsnorm, fused_add_rmsnorm
from flashinfer_tpu_torch.ops.rope import apply_rope_pos_ids
from flashinfer_tpu_torch.ops.sampling import (
    chain_speculative_sampling,
    draw_seed,
    softmax,
    top_k_renorm_probs,
    top_k_top_p_sampling_from_probs,
    top_p_renorm_probs,
)
from flashinfer_tpu_torch.scheduler.native import PagePool
from flashinfer_tpu_torch.serving.graphs import StepGraphs
from flashinfer_tpu_torch.utils import (
    TensorLayout,
    cdiv,
    next_power_of_2,
    resolve_device,
)

__all__ = ["EngineConfig", "GenerationRequest", "LlamaServingEngine",
           "calibrate_kv_scales", "fuse_qkv_weights", "propose_ngram"]


@dataclasses.dataclass
class EngineConfig:
    model: LlamaConfig
    max_batch: int = 8
    num_pages: int = 1024
    page_size: int = 16
    max_seq_len: int = 2048
    top_k: int = 40
    top_p: float = 0.9
    temperature: float = 1.0
    greedy: bool = False
    eos_token: int = -1  # -1: never stop on eos
    # "model"/"bf16": the model dtype; "fp8_e4m3": torch.float8_e4m3fn
    # (the bits of the reference's int8 e4m3 container); "int8": linear
    # int8 (value = q * scale)
    kv_dtype: str = "model"
    # per-tensor 8-bit KV scale: one float for K and V, or (k_scale, v_scale)
    kv_scale: object = 0.05
    # "model": the model dtype; "fp8_e4m3": e4m3 matmul weights with one f32
    # scale an output channel (amax / 448); "int8": linear int8 (amax / 127).
    # Embedding and norms stay in the model dtype.
    weight_dtype: str = "model"
    # G > 0: propose G draft tokens a sequence (``propose_ngram``) and
    # verify all G + 1 rows in one step; a step emits 1 to G + 1 tokens
    spec_tokens: int = 0
    spec_ngram: int = 3  # longest suffix n-gram the proposer matches
    kv_layout: str = "NHD"
    # N > 1: plan N decode steps at once (lengths grow by one a step) and
    # run them back to back, each step's tokens fed to the next on the
    # device; tokens after an eos are dropped and their KV rolled back
    decode_window: int = 1
    device: str = "cuda"
    # replay the decode step as a CUDA graph; False runs it eagerly (same
    # tokens). Ignored on the CPU, where there is nothing to capture.
    cuda_graphs: bool = True


@dataclasses.dataclass
class GenerationRequest:
    prompt: List[int]
    max_new_tokens: int
    # filled by the engine
    request_id: int = -1
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    _seq: int = -1
    _slot: int = -1


def fuse_qkv_weights(params: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Concatenate wq/wk/wv (and their 8-bit scales) into one wqkv, so each
    layer runs one QKV matmul."""
    if "wqkv" in params or "wq" not in params:
        return params
    p = dict(params)
    for suf in ("",) + SCALE_SUFFIXES:
        if "wq" + suf in p:
            p["wqkv" + suf] = torch.cat(
                [p.pop("wq" + suf), p.pop("wk" + suf), p.pop("wv" + suf)],
                dim=-1)
    return p


def _wmm(x: torch.Tensor, params: Dict[str, torch.Tensor],
         name: str) -> torch.Tensor:
    """``x @ params[name]``; an 8-bit weight (a ``_scale`` or ``_iscale``
    key beside it) through ``w8_matmul``, its scale applied to the f32
    product (flashinfer_tpu/serving/engine.py:904)."""
    for suf in SCALE_SUFFIXES:
        if name + suf in params:
            return w8_matmul(x, params[name], params[name + suf])
    return x @ params[name]


def _layer_keys(params: Dict[str, torch.Tensor]) -> Tuple[str, ...]:
    """The keys of the per-layer tensors (stacked on a leading layer axis),
    8-bit scales included."""
    return tuple(k for k in params if k in PER_LAYER or any(
        k == base + suf for base in PER_LAYER for suf in SCALE_SUFFIXES))


def _norm_kv_scale(s) -> Tuple[float, float]:
    if isinstance(s, (tuple, list)):
        ks, vs = s
        return float(ks), float(vs)
    return float(s), float(s)


class _LayerStack:
    """The layer loop of both engines: this module's, and the distributed
    engine's on its tp shard. It reads ``cfg``, ``params``,
    ``_layer_keys``, ``_hq`` / ``_hkv`` (the heads this process computes),
    ``_kv_quant``, ``_kv_scale``, ``_hnd`` (the caches' layout is HND),
    ``_k_rows`` / ``_v_rows`` and ``k_cache`` / ``v_cache``. The two hooks are where tensor parallelism reduces the
    row-parallel partials; on one card they round into the residual's
    dtype."""

    def _attn_out_norm(self, part: torch.Tensor, x: torch.Tensor,
                       weight: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(normed, new residual) of the attention's output projection
        ``part`` added to the residual x."""
        return fused_add_rmsnorm(part.to(x.dtype), x, weight,
                                 self.cfg.model.rms_eps)

    def _mlp_out(self, part: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The MLP's output in the residual's dtype."""
        return part.to(x.dtype)

    def _run_layers(self, x, positions, page_rows, entries, dplan):
        """The layers over the residual stream x. Returns (x, the last MLP
        output): each norm adds the output before it in its own launch
        (``fused_add_rmsnorm``), so the final norm adds the last one."""
        mc = self.cfg.model
        d, hq, hkv = mc.head_dim, self._hq, self._hkv
        n = x.shape[0]
        num_pages = self.cfg.num_pages
        k_scale, v_scale = self._kv_scale
        hnd = self._hnd
        # the plan may pad the query rows past n (prefill's dummy request)
        q_pad = dplan.meta.nnz - n
        # 8-bit caches take their bytes through an int8 view
        kc, vc = self._k_rows, self._v_rows
        if self._kv_quant:
            kc, vc = kc.view(torch.int8), vc.view(torch.int8)
        mlp = None
        for layer in range(mc.num_layers):
            lp = {k: self.params[k][layer] for k in self._layer_keys}
            xn, x = add_rmsnorm(mlp, x, lp["attn_norm"], mc.rms_eps)
            qkv = _wmm(xn, lp, "wqkv")
            q = qkv[:, : hq * d].reshape(n, hq, d)
            k = qkv[:, hq * d: (hq + hkv) * d].reshape(n, hkv, d)
            v = qkv[:, (hq + hkv) * d:].reshape(n, hkv, d)
            q, k = apply_rope_pos_ids(q, k, positions, rope_theta=mc.rope_theta)
            k = _quantize_kv(k, self._kv_quant, k_scale, self.k_cache.dtype)
            v = _quantize_kv(v, self._kv_quant, v_scale, self.v_cache.dtype)
            if self._kv_quant:
                k, v = k.view(torch.int8), v.view(torch.int8)
            # in-place page scatter into the layer-stacked cache (the JAX
            # engine donates its cache buffers to the jitted step instead)
            pid = page_rows[layer]
            if hnd:
                kc[pid, :, entries] = k
                vc[pid, :, entries] = v
            else:
                kc[pid, entries] = k
                vc[pid, entries] = v
            if q_pad:
                q = torch.cat([q, q.new_zeros(q_pad, hq, d)])
            attn = run_device_plan(
                dplan, q, self.k_cache, self.v_cache,
                kv_layout=TensorLayout.HND if hnd else TensorLayout.NHD,
                k_scale=k_scale, v_scale=v_scale,
                kv_indices_offset=layer * num_pages,
            )[:n]
            xn, x = self._attn_out_norm(
                _wmm(attn.reshape(n, hq * d), lp, "wo"), x, lp["mlp_norm"])
            mlp = self._mlp_out(
                _wmm(silu_and_mul(_wmm(xn, lp, "w_gate_up")), lp, "w_down"),
                x)
        return x, mlp


class LlamaServingEngine(_LayerStack):
    """Single-card continuous-batching engine for the Llama family."""

    def __init__(self, config: EngineConfig,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 seed: int = 0):
        self.cfg = config
        mc = config.model
        if config.kv_dtype not in ("model", "bf16", "fp8_e4m3", "int8"):
            raise ValueError(f"unknown kv_dtype {config.kv_dtype!r}")
        if config.kv_layout not in ("NHD", "HND"):
            raise ValueError(f"unknown kv_layout {config.kv_layout!r}")
        if config.weight_dtype not in ("model", "fp8_e4m3", "int8"):
            raise ValueError(f"unknown weight_dtype {config.weight_dtype!r}")
        # pages under 8 tokens are the repacked regime (JAX's engine refuses
        # them too); the paged kernel reads any larger page in place, so
        # the decode step's CUDA graph takes the plan's blob alone
        if config.page_size < 8:
            raise ValueError(
                f"engine page_size must be >= 8, got {config.page_size}")
        self.device = resolve_device(config.device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = llama_init_weights(gen, mc, self.device)
        params = e4m3_views({k: v.to(self.device) for k, v in params.items()})
        # quantized here as JAX's engine does (its __init__, engine.py:
        # 134-164), on the device, a layer at a time
        if config.weight_dtype == "fp8_e4m3":
            if "wo_iscale" in params:
                raise ValueError(
                    "weight_dtype='fp8_e4m3' but params hold linear-int8 "
                    "containers (_iscale keys present)")
            if params["wo"].dtype != torch.float8_e4m3fn:
                params = quantize_llama_weights_fp8(params)
        elif config.weight_dtype == "int8" and "wo_iscale" not in params:
            if params["wo"].dtype in (torch.int8, torch.float8_e4m3fn):
                raise ValueError(
                    "weight_dtype='int8' but params hold e4m3 bits (8-bit "
                    "weights without _iscale keys)")
            params = quantize_llama_weights_int8(params)
        self.params = fuse_qkv_weights(params)
        self._layer_keys = _layer_keys(self.params)
        self._hq, self._hkv = mc.num_qo_heads, mc.num_kv_heads
        self.pool = PagePool(config.num_pages, config.page_size)
        # sampling seeds are drawn on the host, one int32 per step
        self.generator = torch.Generator().manual_seed(seed + 1)

        # all layers share one page id space: layer l's copy of page p sits
        # at row l * num_pages + p of one cache tensor. One more row, after
        # them all, takes the K/V of the decode step's idle slots (JAX drops
        # those writes; no plan reads the row). k_cache / v_cache view the
        # rows without it.
        rows = mc.num_layers * config.num_pages
        if config.kv_layout == "HND":
            shape = (rows + 1, mc.num_kv_heads, config.page_size,
                     mc.head_dim)
        else:
            shape = (rows + 1, config.page_size, mc.num_kv_heads,
                     mc.head_dim)
        self._scratch_row = rows
        self._hnd = config.kv_layout == "HND"
        self._kv_quant = {"fp8_e4m3": "e4m3", "int8": "int8"}.get(
            config.kv_dtype)
        if self._kv_quant:
            cache_dtype = (torch.float8_e4m3fn if self._kv_quant == "e4m3"
                           else torch.int8)
            self._kv_scale = _norm_kv_scale(config.kv_scale)
        else:
            cache_dtype = mc.dtype
            self._kv_scale = (1.0, 1.0)
        self._k_rows = torch.zeros(shape, dtype=cache_dtype,
                                   device=self.device)
        self._v_rows = torch.zeros(shape, dtype=cache_dtype,
                                   device=self.device)
        self.k_cache, self.v_cache = self._k_rows[:rows], self._v_rows[:rows]
        # temperature, top-k and top-p as device scalars: a CUDA graph
        # cannot copy a host value up
        self._sample_args = (
            torch.tensor(config.temperature, dtype=torch.float32,
                         device=self.device),
            torch.tensor(config.top_k, dtype=torch.int32, device=self.device),
            torch.tensor(config.top_p, dtype=torch.float32,
                         device=self.device))

        self._slots: List[Optional[GenerationRequest]] = [None] * config.max_batch
        self._pending: List[GenerationRequest] = []
        self._next_id = 0
        self._decode_wrapper = BatchDecodeWithPagedKVCacheWrapper(
            kv_layout=config.kv_layout, device=self.device)
        self._prefill_wrapper = BatchPrefillWithPagedKVCacheWrapper(
            kv_layout=config.kv_layout, tile_q=256, device=self.device)
        # the verify step's G + 1 rows a slot: tile_q auto-sizes to the
        # packed draft rows
        self._spec_wrapper = BatchPrefillWithPagedKVCacheWrapper(
            kv_layout=config.kv_layout, device=self.device)
        self._page_bucket = next_power_of_2(config.num_pages)
        self.graphs = StepGraphs(self.device, config.cuda_graphs)
        self.steps = 0
        self.generated_tokens = 0
        self.preemptions = 0
        # decode steps run (a window of N counts N), and the host seconds
        # their plans took
        self.decode_steps = 0
        self.plan_seconds = 0.0
        # speculative decoding: verify steps, the sequences they ran, the
        # drafts proposed and emitted, the tokens emitted
        self.spec_stats = dict(steps=0, seqs=0, drafts=0, accepted=0,
                               emitted=0)

    # ------------------------------------------------------------------ API

    def add_request(self, prompt, max_new_tokens: int) -> GenerationRequest:
        total = len(prompt) + max_new_tokens
        if total > self.cfg.max_seq_len:
            raise ValueError(
                f"prompt_len + max_new_tokens = {total} exceeds "
                f"max_seq_len={self.cfg.max_seq_len}")
        req = GenerationRequest(list(map(int, prompt)), max_new_tokens)
        req.request_id = self._next_id
        self._next_id += 1
        self._pending.append(req)
        return req

    @property
    def num_running(self) -> int:
        return sum(s is not None for s in self._slots)

    def has_work(self) -> bool:
        return self.num_running > 0 or bool(self._pending)

    def run_to_completion(self, max_steps: int = 100000) -> None:
        for _ in range(max_steps):
            if not self.has_work():
                return
            self.step()

    def score(self, prompt) -> np.ndarray:
        """Teacher-forced next-token logits of every position of one prompt,
        [len(prompt), vocab] f32 (row i predicts token i + 1). The prompt's
        KV goes to pages taken from the pool for the call and given back;
        running requests are untouched. Raises when the pool has no room."""
        P = len(prompt)
        seq = self.pool.create()
        if not self.pool.extend(seq, P):
            self.pool.release(seq)
            raise RuntimeError("KV page pool exhausted")
        try:
            logits = self._prefill_logits(
                [list(prompt)], *self._batch_tables([seq]), last_rows=None)
            return logits.cpu().numpy()
        finally:
            self.pool.release(seq)

    def step(self) -> List[Tuple[int, int]]:
        """Admit pending requests (prefill), then decode one token (or a
        window of them) for every running sequence. Returns [(request_id,
        token)] emitted this step."""
        emitted: List[Tuple[int, int]] = []
        self._admit(emitted)
        if self.num_running:
            if self.cfg.spec_tokens > 0:
                emitted.extend(self._spec_decode())
            elif self.cfg.decode_window > 1:
                emitted.extend(self._decode_window())
            else:
                emitted.extend(self._decode())
        self.steps += 1
        return emitted

    # ------------------------------------------------------------ admission

    def _admit(self, emitted: List[Tuple[int, int]]) -> None:
        """Move pending requests into free slots and prefill them as one
        batch. A request resuming after preemption re-prefills its whole
        context (prompt + output), so its KV is as if never evicted."""
        admitted: List[GenerationRequest] = []
        for slot in range(self.cfg.max_batch):
            if not self._pending or self._slots[slot] is not None:
                continue
            req = self._pending[0]
            ctx_len = len(req.prompt) + len(req.output)
            need_pages = cdiv(ctx_len, self.cfg.page_size)
            if need_pages > self.pool.num_pages:
                raise ValueError(
                    f"request {req.request_id} needs {need_pages} pages but "
                    f"the pool only has {self.pool.num_pages}: it can never "
                    "be admitted")
            if need_pages > self.pool.free_pages:
                break
            seq = self.pool.create()
            if not self.pool.extend(seq, ctx_len):
                raise RuntimeError("page pool refused a checked extension")
            req._seq, req._slot = seq, slot
            self._slots[slot] = req
            self._pending.pop(0)
            admitted.append(req)
        if admitted:
            self._prefill(admitted, emitted)

    def _preempt_youngest(self) -> Optional[GenerationRequest]:
        """Evict the youngest running request: free its pages and put it at
        the front of the queue."""
        cands = [r for r in self._slots if r is not None]
        if not cands:
            return None
        victim = max(cands, key=lambda r: r.request_id)
        self.pool.release(victim._seq)
        self._slots[victim._slot] = None
        victim._seq = victim._slot = -1
        self._pending.insert(0, victim)
        self.preemptions += 1
        return victim

    def _reserve(self, reqs: List[GenerationRequest],
                 extra: int) -> List[GenerationRequest]:
        """Reserve room for ``extra`` tokens per request, preempting the
        youngest sequence when the pool runs out. Returns the survivors."""
        live = list(reqs)
        i = 0
        while i < len(live):
            r = live[i]
            if self.pool.extend(r._seq, self.pool.seq_len(r._seq) + extra):
                i += 1
                continue
            if self.num_running == 1:
                raise RuntimeError(
                    "KV page pool exhausted: one sequence alone exceeds "
                    f"the pool ({self.pool.num_pages} pages)")
            victim = self._preempt_youngest()
            if victim is r:
                live.pop(i)
            elif victim in live:
                vi = live.index(victim)
                live.pop(vi)
                if vi < i:
                    i -= 1
        return live

    def _batch_tables(self, seqs):
        """The pool's export of ``seqs``, the page table padded to the page
        bucket."""
        indptr, indices, last = self.pool.batch_export(seqs)
        padded = np.zeros(self._page_bucket, np.int32)
        padded[: len(indices)] = indices
        return indptr, padded, last

    def _prefill(self, reqs: List[GenerationRequest], emitted) -> None:
        tables = self._batch_tables([r._seq for r in reqs])
        prompts = [r.prompt + r.output for r in reqs]
        last_rows = np.cumsum([len(p) for p in prompts]) - 1
        logits = self._prefill_logits(prompts, *tables, last_rows)
        seed = None if self.cfg.greedy else draw_seed(self.generator)
        toks = self._sample_tokens(logits, seed).cpu().numpy()
        for r, t in zip(reqs, toks):
            self._emit(r, int(t), emitted)

    def _prefill_logits(self, prompts: Sequence[List[int]], indptr, indices,
                        last, last_rows) -> torch.Tensor:
        """Causal prefill of the prompts into their pages (``_batch_tables``
        of their sequences); the f32 logits of ``last_rows`` (every row when
        None)."""
        mc = self.cfg.model
        lens = np.asarray([len(p) for p in prompts])
        nnz = int(lens.sum())
        # the plan is the reference's: a trailing dummy request (no pages)
        # pads the rows to a power of two
        bucket = next_power_of_2(max(nnz, 8))
        self._prefill_wrapper.plan(
            np.concatenate([[0], np.cumsum(lens), [bucket]]),
            np.concatenate([indptr, [indptr[-1]]]), indices,
            np.concatenate([last, [0]]),
            mc.num_qo_heads, mc.num_kv_heads, mc.head_dim, self.cfg.page_size,
            causal=True, kv_chunk_size=self._kv_chunk(),
        )
        tokens = np.concatenate(prompts)
        positions = np.concatenate([np.arange(len(p)) for p in prompts])
        batch_idx = np.repeat(np.arange(len(prompts)), lens)
        page_ids = indices[indptr[batch_idx] + positions // self.cfg.page_size]
        sel = np.zeros(0, np.int64) if last_rows is None else last_rows
        host = np.concatenate([tokens, positions, page_ids, sel]).astype(
            np.int64)
        dev = torch.from_numpy(host).to(self.device)
        tok, pos, pages = dev[:nnz], dev[nnz: 2 * nnz], dev[2 * nnz: 3 * nnz]
        return self._logits(tok, pos, pages, None,
                            self._prefill_wrapper.device_plan,
                            None if last_rows is None else dev[3 * nnz:])

    # --------------------------------------------------------------- decode

    def _kv_chunk(self) -> int:
        return min(512, next_power_of_2(self.cfg.max_seq_len))

    def _slot_tables(self, reqs):
        """The compact batch export expanded into fixed max_batch-slot
        tables (an inactive slot has kv_len 0 and no pages)."""
        B = self.cfg.max_batch
        indptr, indices, last = self._batch_tables([r._seq for r in reqs])
        full_indptr = np.zeros(B + 1, np.int32)
        full_last = np.zeros(B, np.int32)
        kv_lens = np.zeros(B, np.int64)
        counts = np.zeros(B, np.int64)
        for i, r in enumerate(reqs):
            s = r._slot
            kv_lens[s] = self.pool.seq_len(r._seq)
            full_last[s] = last[i]
            counts[s] = indptr[i + 1] - indptr[i]
        full_indptr[1:] = np.cumsum(counts)
        slot_indices = np.zeros(self._page_bucket, np.int32)
        for i, r in enumerate(reqs):
            s = r._slot
            slot_indices[full_indptr[s]: full_indptr[s + 1]] = indices[
                indptr[i]: indptr[i + 1]]
        return full_indptr, slot_indices, full_last, kv_lens

    def _step_tokens(self, reqs) -> Tuple[np.ndarray, np.ndarray]:
        """Each slot's current token and whether it is live."""
        B = self.cfg.max_batch
        tokens = np.zeros(B, np.int32)
        valid = np.zeros(B, np.int32)
        for r in reqs:
            tokens[r._slot] = r.output[-1] if r.output else r.prompt[-1]
            valid[r._slot] = 1
        return tokens, valid

    def _plan_decode(self, tables, kv_lens, **kw) -> DevicePlan:
        full_indptr, slot_indices, full_last, _ = tables
        mc = self.cfg.model
        t0 = time.perf_counter()
        self._decode_wrapper.plan(
            full_indptr, slot_indices, full_last,
            mc.num_qo_heads, mc.num_kv_heads, mc.head_dim, self.cfg.page_size,
            kv_len_arr=kv_lens, kv_chunk_size=self._kv_chunk(),
            defer_upload=True, **kw)
        self.plan_seconds += time.perf_counter() - t0
        return self._decode_wrapper.device_plan

    def _step_row(self, dplan: DevicePlan, tokens, positions, valid, tables,
                  seed: int) -> np.ndarray:
        """The decode step's input buffer on the host: the plan's blob, then
        JAX's step blob (tokens, positions, valid, slot page table, indptr,
        last-page lengths), then the sampling seed."""
        full_indptr, slot_indices, full_last, _ = tables
        return np.concatenate([
            dplan.blob.numpy(), tokens, positions, valid, slot_indices,
            full_indptr, full_last, [seed]]).astype(np.int32)

    def _draw_seed(self) -> int:
        return 0 if self.cfg.greedy else draw_seed(self.generator)

    def _decode(self) -> List[Tuple[int, int]]:
        reqs = [r for r in self._slots if r is not None]
        reqs = self._reserve(reqs, 1)  # room for this step's token
        if not reqs:
            return []
        tables = self._slot_tables(reqs)
        kv_lens = tables[3]
        tokens, valid = self._step_tokens(reqs)
        positions = np.maximum(kv_lens - 1, 0)
        dplan = self._plan_decode(tables, kv_lens,
                                  work_capacity=self._decode_capacity(kv_lens))
        row = self._step_row(dplan, tokens, positions, valid, tables,
                             self._draw_seed())
        toks = self._run_steps(dplan.meta, row[None])[0]
        out: List[Tuple[int, int]] = []
        for r in reqs:
            self._emit(r, int(toks[r._slot]), out)
        return out

    def _decode_window(self) -> List[Tuple[int, int]]:
        """N decode steps planned at once (``EngineConfig.decode_window``),
        counterpart of JAX's ``_decode_window``. Decode lengths grow by one
        token a step, so all N plans are made here and share one PlanMeta
        (work capacity and the split bucket pinned to the window-end
        lengths). Their inputs go up in one copy; each step's tokens feed
        the next on the device; the host reads the tokens once at the end.
        Tokens after an eos are dropped and their KV rolled back."""
        reqs = [r for r in self._slots if r is not None]
        window = min(self.cfg.decode_window,
                     min(r.max_new_tokens - len(r.output) for r in reqs))
        if window <= 1:
            return self._decode()
        reqs = self._reserve(reqs, window)
        if not reqs:
            return []
        tables = self._slot_tables(reqs)
        kv_end = tables[3]
        active = kv_end > 0
        base = np.where(active, kv_end - window, 0)
        cap = self._decode_capacity(kv_end)
        min_splits = next_power_of_2(
            max(1, int(np.max(-(-kv_end // self._kv_chunk()), initial=1))))
        tokens, valid = self._step_tokens(reqs)
        rows, metas = [], []
        for i in range(window):
            dplan = self._plan_decode(
                tables, np.where(active, base + i + 1, 0),
                work_capacity=cap, min_max_splits=min_splits)
            metas.append(dplan.meta)
            rows.append(self._step_row(dplan, tokens, base + i, valid,
                                       tables, self._draw_seed()))
        if any(m != metas[0] for m in metas[1:]):
            raise AssertionError("window plans must share one PlanMeta")
        toks = self._run_steps(metas[0], np.stack(rows))  # [window, B]
        out: List[Tuple[int, int]] = []
        for r in reqs:
            accepted: List[int] = []
            for t in toks[:, r._slot]:
                accepted.append(int(t))
                if self.cfg.eos_token >= 0 and t == self.cfg.eos_token:
                    break
            if len(accepted) < window:
                # keep the KV of the accepted tokens but the last (whose KV
                # the next step appends)
                self.pool.truncate(r._seq, int(base[r._slot]) + len(accepted))
            for t in accepted:
                self._emit(r, t, out)
        return out

    def _run_steps(self, meta: PlanMeta, rows: np.ndarray) -> np.ndarray:
        """Run len(rows) decode steps of one PlanMeta on the step's static
        input buffer (the CUDA graph's, on the card), each step's tokens
        fed to the next; one copy up and one read back. Returns the tokens
        [steps, max_batch]."""
        B = self.cfg.max_batch
        n, width = rows.shape
        buf = self.graphs.inputs(meta, width)
        if n == 1:
            _upload(buf, rows[0])
            toks = self.graphs.run(meta, self._decode_body)[None]
        else:
            host = torch.from_numpy(rows)
            if buf.is_cuda:
                host = host.pin_memory()
            stacked = host.to(self.device, non_blocking=True)
            toks = torch.empty(n, B, dtype=torch.int32, device=self.device)
            off = _blob_size(meta)
            tok_in = buf[off: off + B]
            for i in range(n):
                buf.copy_(stacked[i])
                if i:
                    tok_in.copy_(toks[i - 1])
                toks[i].copy_(self.graphs.run(meta, self._decode_body))
        self.decode_steps += n
        return toks.cpu().numpy()

    def _decode_body(self, buf: torch.Tensor, meta: PlanMeta) -> torch.Tensor:
        """The fixed-shape decode step on its input buffer (``_step_row``'s
        layout): tokens [max_batch] int32. Idle slots run too; their K/V go
        to the scratch row."""
        B, pb = self.cfg.max_batch, self._page_bucket
        n = _blob_size(meta)
        step = buf[n:]
        tok, pos, valid = step[:B], step[B: 2 * B], step[2 * B: 3 * B] != 0
        kv_indices = step[3 * B: 3 * B + pb]
        kv_indptr = step[3 * B + pb: 4 * B + pb]
        seed = step[-1:]
        slot = (kv_indptr + pos // self.cfg.page_size).clamp(max=pb - 1)
        logits = self._logits(tok, pos, kv_indices[slot], valid,
                              DevicePlan(buf[:n], meta))
        return self._sample_tokens(logits, seed)

    # ---------------------------------------------------- speculative decode

    def _spec_decode(self) -> List[Tuple[int, int]]:
        """One speculative step, counterpart of JAX's ``_spec_decode``:
        propose G drafts a sequence, verify the G + 1 rows (the current
        token and the drafts) in one causal step, emit the accepted drafts
        and one more token, and roll the KV of the rest back."""
        mc, B = self.cfg.model, self.cfg.max_batch
        G = self.cfg.spec_tokens
        rows = G + 1
        reqs = [r for r in self._slots if r is not None]
        reqs = self._reserve(reqs, rows)
        if not reqs:
            return []
        kv0 = np.zeros(B, np.int64)
        drafts = np.zeros((B, G), np.int64)
        for r in reqs:
            s = r._slot
            kv0[s] = self.pool.seq_len(r._seq) - rows  # before the reserve
            drafts[s] = propose_ngram(r.prompt + r.output, G,
                                      self.cfg.spec_ngram)
        tables = self._slot_tables(reqs)
        full_indptr, slot_indices, full_last, kv_lens = tables
        bucket = next_power_of_2(max(B * rows, 8))
        tokens = np.zeros(bucket, np.int64)
        positions = np.zeros(bucket, np.int64)
        batch_idx = np.zeros(bucket, np.int64)
        valid = np.zeros(bucket, np.int64)
        for r in reqs:
            s, o = r._slot, r._slot * rows
            tokens[o] = r.output[-1] if r.output else r.prompt[-1]
            tokens[o + 1: o + rows] = drafts[s]
            positions[o: o + rows] = kv0[s] + np.arange(rows)
            batch_idx[o: o + rows] = s
            valid[o: o + rows] = 1
        # every slot has G + 1 query rows (an idle slot's have no keys and
        # no work items); a trailing dummy request takes the pad rows
        plan_indptr = np.concatenate([full_indptr, [full_indptr[-1]]])
        plan_last = np.concatenate([full_last, [0]])
        t0 = time.perf_counter()
        self._spec_wrapper.plan(
            np.concatenate([np.arange(B + 1) * rows, [bucket]]),
            plan_indptr, slot_indices, plan_last,
            mc.num_qo_heads, mc.num_kv_heads, mc.head_dim, self.cfg.page_size,
            causal=True, kv_chunk_size=self._kv_chunk(),
            kv_len_arr=np.concatenate([kv_lens, [0]]),
            work_capacity=self._work_capacity(), defer_upload=True)
        self.plan_seconds += time.perf_counter() - t0
        dplan = self._spec_wrapper.device_plan
        # [plan blob | JAX's spec blob | seed]
        row = np.concatenate([
            dplan.blob.numpy(), tokens, positions, batch_idx, valid,
            drafts.ravel(), slot_indices, plan_indptr, plan_last,
            [self._draw_seed()]]).astype(np.int32)
        key = ("verify", dplan.meta)
        _upload(self.graphs.inputs(key, len(row)), row)
        out_toks = self.graphs.run(key, self._verify_body).cpu().numpy()
        st = self.spec_stats
        st["steps"] += 1
        out: List[Tuple[int, int]] = []
        for r in reqs:
            s = r._slot
            toks: List[int] = []
            for t in out_toks[s]:
                if t < 0:
                    break
                toks.append(int(t))
                if self.cfg.eos_token >= 0 and t == self.cfg.eos_token:
                    break
            toks = toks[: r.max_new_tokens - len(r.output)]
            st["seqs"] += 1
            st["drafts"] += G
            st["accepted"] += min(len(toks), int((out_toks[s] >= 0).sum()) - 1)
            st["emitted"] += len(toks)
            # the KV of the current token and the accepted drafts stays;
            # the last emitted token's KV enters with the next step
            self.pool.truncate(r._seq, int(kv0[s]) + len(toks))
            for t in toks:
                self._emit(r, t, out)
        return out

    def _verify_body(self, buf: torch.Tensor, key) -> torch.Tensor:
        """The fixed-shape verify step on its input buffer
        (``_spec_decode``'s layout), counterpart of JAX's
        ``_spec_verify_step``: tokens [max_batch, G + 1] int32, -1 after the
        first rejected draft. Idle slots' and pad rows' K/V go to the
        scratch row."""
        meta = key[1]
        B, G, pb = self.cfg.max_batch, self.cfg.spec_tokens, self._page_bucket
        rows = G + 1
        n = _blob_size(meta)
        bucket = meta.nnz
        step = buf[n:]
        tok, pos = step[:bucket], step[bucket: 2 * bucket]
        bidx = step[2 * bucket: 3 * bucket]
        valid = step[3 * bucket: 4 * bucket] != 0
        o = 4 * bucket
        drafts = step[o: o + B * G].view(B, G)
        kv_indices = step[o + B * G: o + B * G + pb]
        kv_indptr = step[o + B * G + pb: o + B * G + pb + B + 2]
        seed = step[-1:]
        slot = (kv_indptr[bidx] + pos // self.cfg.page_size).clamp(max=pb - 1)
        logits = self._logits(tok, pos, kv_indices[slot], valid,
                              DevicePlan(buf[:n], meta),
                              slice(0, B * rows)).view(B, rows, -1)
        if self.cfg.greedy:
            out = logits.argmax(dim=-1).to(torch.int32)  # [B, rows]
            match = (out[:, :G] == drafts).to(torch.int32)
            # row j is emitted iff every draft before it matched
            keep = torch.cat([torch.ones_like(match[:, :1]),
                              torch.cumprod(match, dim=1)], dim=1) != 0
            return torch.where(keep, out, -1)
        temperature, top_k, top_p = self._sample_args
        probs = softmax(logits.view(B * rows, -1), temperature=temperature)
        probs = top_p_renorm_probs(top_k_renorm_probs(probs, top_k), top_p)
        one_hot = F.one_hot(drafts.long(), probs.shape[-1]).float()
        return chain_speculative_sampling(
            one_hot, drafts, probs.view(B, rows, -1), seed=seed)[0]

    def _work_capacity(self) -> int:
        chunks = cdiv(self.cfg.max_seq_len, self._kv_chunk())
        return next_power_of_2(max(8, self.cfg.max_batch * chunks))

    def _decode_capacity(self, kv_lens) -> int:
        """Power-of-two work-item capacity sized to this step's items
        (decode has ceil(kv_len / chunk) items per active sequence)."""
        chunk = self._kv_chunk()
        needed = sum(cdiv(int(n), chunk) for n in kv_lens if n > 0)
        return min(self._work_capacity(), next_power_of_2(max(8, needed)))

    # ----------------------------------------------------------- device step

    def _logits(self, tok, pos, pages, valid, dplan: DevicePlan,
                sel=None) -> torch.Tensor:
        """Embed, run the layers, take the f32 logits of the rows ``sel``
        (every row when None). Row i's K/V enter the cache at (pages[i],
        pos[i] % page_size) of each layer, or the scratch row where
        ``valid`` (None: every row) is false."""
        p = self.params
        mc = self.cfg.model
        layer_rows = torch.arange(0, self._scratch_row, self.cfg.num_pages,
                                  device=self.device)
        page_rows = pages[None, :] + layer_rows[:, None]  # [layers, rows]
        if valid is not None:
            page_rows = torch.where(valid, page_rows, self._scratch_row)
        x = p["embedding"][tok]
        x, mlp = self._run_layers(x, pos, page_rows,
                                  pos % self.cfg.page_size, dplan)
        if sel is not None:  # the add is elementwise: select first
            x, mlp = x[sel], mlp[sel]
        x = fused_add_rmsnorm(mlp, x, p["final_norm"], mc.rms_eps)[0]
        return _wmm(x, p, "lm_head").float()

    def _sample_tokens(self, logits: torch.Tensor, seed) -> torch.Tensor:
        """Greedy argmax, or top-k/top-p sampling with ``seed`` (an int, or
        a one-element int32 tensor the sampler kernel reads on the card)."""
        if self.cfg.greedy:
            return logits.argmax(dim=-1).to(torch.int32)
        temperature, top_k, top_p = self._sample_args
        probs = softmax(logits, temperature=temperature)
        return top_k_top_p_sampling_from_probs(probs, top_k, top_p, seed=seed)

    def _emit(self, req: GenerationRequest, token: int, out_list) -> None:
        req.output.append(token)
        self.generated_tokens += 1
        out_list.append((req.request_id, token))
        if (len(req.output) >= req.max_new_tokens
                or token == self.cfg.eos_token):
            req.done = True
            self.pool.release(req._seq)
            self._slots[req._slot] = None


def _quantize_kv(t: torch.Tensor, quant: Optional[str], scale: float,
                 dtype: torch.dtype) -> torch.Tensor:
    """K or V as the cache stores it: linear int8 (round(t / scale),
    clipped to +-127) for ``quant`` "int8", t / scale in e4m3 for "e4m3",
    else t in the cache's ``dtype``."""
    if quant == "int8":
        return torch.clamp(torch.round(t.float() / scale), -127,
                           127).to(torch.int8)
    if quant == "e4m3":
        return (t.float() / scale).to(torch.float8_e4m3fn)
    return t.to(dtype)


def _upload(buf: torch.Tensor, row: np.ndarray) -> None:
    """Copy a host int32 row into a step's static input buffer (from
    pinned memory, without a wait, on the card)."""
    host = torch.from_numpy(row)
    if buf.is_cuda:
        host = host.pin_memory()
    buf.copy_(host, non_blocking=True)


def propose_ngram(ctx: List[int], num_spec: int, max_ngram: int) -> List[int]:
    """Prompt-lookup drafts: the tokens that followed the latest earlier
    occurrence of the longest suffix n-gram of ``ctx`` (n = max_ngram
    down to 1), padded with their last; the last token repeated when no
    suffix occurred before."""
    L = len(ctx)
    arr = np.asarray(ctx)
    for n in range(min(max_ngram, L - 1), 0, -1):
        windows = np.lib.stride_tricks.sliding_window_view(arr[: L - 1], n)
        hits = np.nonzero((windows == arr[L - n:]).all(axis=1))[0]
        if hits.size:
            i = int(hits[-1])
            cont = ctx[i + n: i + n + num_spec]
            if cont:
                return list(cont) + [cont[-1]] * (num_spec - len(cont))
    return [ctx[-1]] * num_spec


def _blob_size(meta: PlanMeta) -> int:
    """Length in int32s of a plan blob of this meta."""
    return sum(length for _, length, _ in meta.blob_layout())


def calibrate_kv_scales(
    config: EngineConfig,
    prompts: List[List[int]],
    params: Optional[Dict[str, torch.Tensor]] = None,
    *,
    seed: int = 0,
    headroom: float = 1.0,
) -> Tuple[float, float]:
    """Per-tensor 8-bit KV scales (k_scale, v_scale) from sample prompts:
    amax / 448 for e4m3, amax / 127 when ``config.kv_dtype == "int8"``.

    Prefills the prompts on an engine with model-dtype caches and reads the
    roped K and V amax from them, the values an 8-bit cache would store.
    Pass the result as ``EngineConfig(kv_scale=...)``."""
    cal = dataclasses.replace(config, kv_dtype="model", spec_tokens=0,
                              greedy=True,
                              max_batch=max(config.max_batch, len(prompts)))
    eng = LlamaServingEngine(cal, params=params, seed=seed)
    for p in prompts:
        eng.add_request(list(p), 1)
    while eng.has_work():
        eng.step()
    qmax = 127.0 if config.kv_dtype == "int8" else 448.0
    amax_k = float(eng.k_cache.float().abs().max())
    amax_v = float(eng.v_cache.float().abs().max())
    return (max(amax_k, 1e-6) * headroom / qmax,
            max(amax_v, 1e-6) * headroom / qmax)
