"""Continuous-batching serving engine for the Llama family.

Counterpart of ``flashinfer_tpu/serving/engine.py``, with the same host-side
scheduling: a page pool for KV blocks, one attention plan per step, admission
with prefill, one decode token per running sequence per step, and recompute
preemption (the youngest sequence is evicted and later re-prefilled with its
prompt and output) when the pool runs out.

The device step is plain PyTorch around the package's CUDA kernels: RMSNorm
(every norm after the first adds the residual in the same launch), paged
attention and the sampler. On CPU tensors every kernel runs its plain
version.

This slice serves model-dtype weights with KV caches in the model dtype,
e4m3 (``torch.float8_e4m3fn``) or linear int8, in the NHD or HND layout,
greedy or sampled. Weight quantization, speculative decoding, the multi-step
decode window, ``score()`` and ``calibrate_kv_scales`` raise
``NotImplementedError`` (ROADMAP Queue 1, items 3 and 5).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from flashinfer_tpu_torch.models.llama import (
    PER_LAYER,
    LlamaConfig,
    check_dense_params,
    llama_init_weights,
)
from flashinfer_tpu_torch.ops.activation import silu_and_mul
from flashinfer_tpu_torch.ops.attention.batch import (
    BatchDecodeWithPagedKVCacheWrapper,
    BatchPrefillWithPagedKVCacheWrapper,
    DevicePlan,
    run_device_plan,
)
from flashinfer_tpu_torch.ops.norm import add_rmsnorm, fused_add_rmsnorm
from flashinfer_tpu_torch.ops.rope import apply_rope_pos_ids
from flashinfer_tpu_torch.ops.sampling import (
    draw_seed,
    softmax,
    top_k_top_p_sampling_from_probs,
)
from flashinfer_tpu_torch.scheduler.page_pool import PagePool
from flashinfer_tpu_torch.utils import (
    TensorLayout,
    cdiv,
    next_power_of_2,
    resolve_device,
)

__all__ = ["EngineConfig", "GenerationRequest", "LlamaServingEngine",
           "calibrate_kv_scales", "fuse_qkv_weights"]


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
    weight_dtype: str = "model"
    spec_tokens: int = 0
    kv_layout: str = "NHD"
    decode_window: int = 1
    device: str = "cuda"


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
    """Concatenate wq/wk/wv into one wqkv, so each layer runs one QKV
    matmul."""
    if "wqkv" in params or "wq" not in params:
        return params
    p = dict(params)
    p["wqkv"] = torch.cat([p.pop("wq"), p.pop("wk"), p.pop("wv")], dim=-1)
    return p


def _norm_kv_scale(s) -> Tuple[float, float]:
    if isinstance(s, (tuple, list)):
        ks, vs = s
        return float(ks), float(vs)
    return float(s), float(s)


def _not_in_slice(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not in this slice of the port (ROADMAP Queue 1, "
        f"item {item})")


class LlamaServingEngine:
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
        if config.weight_dtype != "model":
            raise _not_in_slice(f"weight_dtype={config.weight_dtype!r}", 3)
        if config.spec_tokens > 0:
            raise _not_in_slice("speculative decoding (spec_tokens > 0)", 5)
        if config.decode_window > 1:
            raise _not_in_slice("the multi-step decode window", 5)
        if config.page_size < 8:
            raise ValueError(
                f"engine page_size must be >= 8, got {config.page_size}")
        self.device = resolve_device(config.device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = llama_init_weights(gen, mc, self.device)
        check_dense_params(params)
        self.params = fuse_qkv_weights(
            {k: v.to(self.device) for k, v in params.items()})
        self.pool = PagePool(config.num_pages, config.page_size)
        # sampling seeds are drawn on the host, one int32 per step
        self.generator = torch.Generator().manual_seed(seed + 1)

        # all layers share one page id space: layer l's copy of page p sits
        # at row l * num_pages + p of one cache tensor
        if config.kv_layout == "HND":
            shape = (mc.num_layers * config.num_pages, mc.num_kv_heads,
                     config.page_size, mc.head_dim)
        else:
            shape = (mc.num_layers * config.num_pages, config.page_size,
                     mc.num_kv_heads, mc.head_dim)
        self._kv_quant = {"fp8_e4m3": "e4m3", "int8": "int8"}.get(
            config.kv_dtype)
        if self._kv_quant:
            cache_dtype = (torch.float8_e4m3fn if self._kv_quant == "e4m3"
                           else torch.int8)
            self._kv_scale = _norm_kv_scale(config.kv_scale)
        else:
            cache_dtype = mc.dtype
            self._kv_scale = (1.0, 1.0)
        self.k_cache = torch.zeros(shape, dtype=cache_dtype, device=self.device)
        self.v_cache = torch.zeros(shape, dtype=cache_dtype, device=self.device)

        self._slots: List[Optional[GenerationRequest]] = [None] * config.max_batch
        self._pending: List[GenerationRequest] = []
        self._next_id = 0
        self._decode_wrapper = BatchDecodeWithPagedKVCacheWrapper(
            kv_layout=config.kv_layout, device=self.device)
        self._prefill_wrapper = BatchPrefillWithPagedKVCacheWrapper(
            kv_layout=config.kv_layout, tile_q=256, device=self.device)
        self._page_bucket = next_power_of_2(config.num_pages)
        self.steps = 0
        self.generated_tokens = 0
        self.preemptions = 0

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
        raise _not_in_slice("score()", 5)

    def step(self) -> List[Tuple[int, int]]:
        """Admit pending requests (prefill), then decode one token for every
        running sequence. Returns [(request_id, token)] emitted this step."""
        emitted: List[Tuple[int, int]] = []
        self._admit(emitted)
        if self.num_running:
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

    def _batch_tables(self, reqs):
        indptr, indices, last = self.pool.batch_export([r._seq for r in reqs])
        padded = np.zeros(self._page_bucket, np.int32)
        padded[: len(indices)] = indices
        return indptr, padded, last

    def _prefill(self, reqs: List[GenerationRequest], emitted) -> None:
        mc = self.cfg.model
        prompts = [r.prompt + r.output for r in reqs]
        lens = np.asarray([len(p) for p in prompts])
        nnz = int(lens.sum())
        # the plan is the reference's: a trailing dummy request (no pages)
        # pads the rows to a power of two
        bucket = next_power_of_2(max(nnz, 8))
        qo_indptr = np.concatenate([[0], np.cumsum(lens), [bucket]])
        indptr, indices, last = self._batch_tables(reqs)
        indptr = np.concatenate([indptr, [indptr[-1]]])
        last = np.concatenate([last, [0]])
        self._prefill_wrapper.plan(
            qo_indptr, indptr, indices, last,
            mc.num_qo_heads, mc.num_kv_heads, mc.head_dim, self.cfg.page_size,
            causal=True, kv_chunk_size=self._kv_chunk(),
        )
        tokens = np.concatenate(prompts)
        positions = np.concatenate([np.arange(len(p)) for p in prompts])
        batch_idx = np.repeat(np.arange(len(prompts)), lens)
        page_ids = indices[indptr[batch_idx] + positions // self.cfg.page_size]
        last_rows = np.cumsum(lens) - 1
        toks = self._device_step(
            tokens, positions, np.arange(nnz), page_ids,
            self._prefill_wrapper.device_plan, last_rows)
        for r, t in zip(reqs, toks):
            self._emit(r, int(t), emitted)

    # --------------------------------------------------------------- decode

    def _kv_chunk(self) -> int:
        return min(512, next_power_of_2(self.cfg.max_seq_len))

    def _slot_tables(self, reqs):
        """The compact batch export expanded into fixed max_batch-slot
        tables (an inactive slot has kv_len 0 and no pages)."""
        B = self.cfg.max_batch
        indptr, indices, last = self._batch_tables(reqs)
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

    def _decode(self) -> List[Tuple[int, int]]:
        mc, B = self.cfg.model, self.cfg.max_batch
        reqs = [r for r in self._slots if r is not None]
        reqs = self._reserve(reqs, 1)  # room for this step's token
        if not reqs:
            return []
        full_indptr, slot_indices, full_last, kv_lens = self._slot_tables(reqs)
        tokens = np.zeros(B, np.int64)
        positions = np.zeros(B, np.int64)
        slots = np.asarray([r._slot for r in reqs])
        for r in reqs:
            s = r._slot
            tokens[s] = r.output[-1] if r.output else r.prompt[-1]
            positions[s] = kv_lens[s] - 1
        self._decode_wrapper.plan(
            full_indptr, slot_indices, full_last,
            mc.num_qo_heads, mc.num_kv_heads, mc.head_dim, self.cfg.page_size,
            kv_len_arr=kv_lens, kv_chunk_size=self._kv_chunk(),
            work_capacity=self._decode_capacity(kv_lens),
        )
        page_ids = slot_indices[full_indptr[slots]
                                + positions[slots] // self.cfg.page_size]
        toks = self._device_step(tokens, positions, slots, page_ids,
                                 self._decode_wrapper.device_plan, None)
        out: List[Tuple[int, int]] = []
        for r in reqs:
            self._emit(r, int(toks[r._slot]), out)
        return out

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

    def _device_step(self, tokens, positions, write_rows, page_ids,
                     dplan: DevicePlan, last_rows) -> np.ndarray:
        """Embed, run the layers, sample. ``write_rows`` are the rows whose
        K/V enter the cache at (page_ids, positions % page_size); other rows
        are dropped by indexing. ``last_rows`` selects the rows that sample
        (all rows when None). Host arrays go up in one copy."""
        ps = self.cfg.page_size
        n, w = len(tokens), len(write_rows)
        host = np.concatenate([
            tokens, positions, write_rows, page_ids,
            positions[write_rows] % ps,
            np.zeros(0, np.int64) if last_rows is None else last_rows,
        ]).astype(np.int64)
        dev = torch.from_numpy(host).to(self.device)
        tok, pos = dev[:n], dev[n: 2 * n]
        rows, pages, entries = (dev[2 * n: 2 * n + w],
                                dev[2 * n + w: 2 * n + 2 * w],
                                dev[2 * n + 2 * w: 2 * n + 3 * w])
        p = self.params
        mc = self.cfg.model
        x = p["embedding"][tok]
        x, mlp = self._run_layers(x, pos, rows, pages, entries, dplan)
        if last_rows is not None:  # the add is elementwise: select first
            sel = dev[2 * n + 3 * w:]
            x, mlp = x[sel], mlp[sel]
        x = fused_add_rmsnorm(mlp, x, p["final_norm"], mc.rms_eps)[0]
        logits = (x @ p["lm_head"]).float()
        return self._sample_tokens(logits).cpu().numpy()

    def _run_layers(self, x, positions, rows, pages, entries, dplan):
        """The layers over the residual stream x. Returns (x, the last MLP
        output): each norm adds the output before it in its own launch
        (``fused_add_rmsnorm``), so the final norm adds the last one."""
        mc = self.cfg.model
        d, hq, hkv = mc.head_dim, mc.num_qo_heads, mc.num_kv_heads
        n = x.shape[0]
        num_pages = self.cfg.num_pages
        k_scale, v_scale = self._kv_scale
        hnd = self.cfg.kv_layout == "HND"
        # the plan may pad the query rows past n (prefill's dummy request)
        q_pad = dplan.meta.nnz - n
        mlp = None
        for layer in range(mc.num_layers):
            lp = {k: self.params[k][layer] for k in PER_LAYER
                  if k in self.params}
            xn, x = add_rmsnorm(mlp, x, lp["attn_norm"], mc.rms_eps)
            qkv = xn @ lp["wqkv"]
            q = qkv[:, : hq * d].reshape(n, hq, d)
            k = qkv[:, hq * d: (hq + hkv) * d].reshape(n, hkv, d)
            v = qkv[:, (hq + hkv) * d:].reshape(n, hkv, d)
            q, k = apply_rope_pos_ids(q, k, positions, rope_theta=mc.rope_theta)
            k, v = self._quantize_kv(k[rows], k_scale), self._quantize_kv(
                v[rows], v_scale)
            # in-place page scatter into the layer-stacked cache (the JAX
            # engine donates its cache buffers to the jitted step instead);
            # 8-bit caches scatter their bytes through an int8 view
            pid = pages + layer * num_pages
            kc, vc = self.k_cache, self.v_cache
            if self._kv_quant:
                kc, vc = kc.view(torch.int8), vc.view(torch.int8)
                k, v = k.view(torch.int8), v.view(torch.int8)
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
            xn, x = fused_add_rmsnorm(
                (attn.reshape(n, hq * d) @ lp["wo"]).to(x.dtype), x,
                lp["mlp_norm"], mc.rms_eps)
            mlp = (silu_and_mul(xn @ lp["w_gate_up"]) @ lp["w_down"]).to(
                x.dtype)
        return x, mlp

    def _quantize_kv(self, t: torch.Tensor, scale: float) -> torch.Tensor:
        if self._kv_quant == "int8":
            return torch.clamp(torch.round(t.float() / scale), -127,
                               127).to(torch.int8)
        if self._kv_quant == "e4m3":
            return (t.float() / scale).to(torch.float8_e4m3fn)
        return t.to(self.k_cache.dtype)

    def _sample_tokens(self, logits: torch.Tensor) -> torch.Tensor:
        if self.cfg.greedy:
            return logits.argmax(dim=-1).to(torch.int32)
        probs = softmax(logits, temperature=self.cfg.temperature)
        return top_k_top_p_sampling_from_probs(
            probs, self.cfg.top_k, self.cfg.top_p,
            seed=draw_seed(self.generator))

    def _emit(self, req: GenerationRequest, token: int, out_list) -> None:
        req.output.append(token)
        self.generated_tokens += 1
        out_list.append((req.request_id, token))
        if (len(req.output) >= req.max_new_tokens
                or token == self.cfg.eos_token):
            req.done = True
            self.pool.release(req._seq)
            self._slots[req._slot] = None


def calibrate_kv_scales(*args, **kwargs):
    raise _not_in_slice("calibrate_kv_scales", 5)
