"""Data-parallel x tensor-parallel continuous batching on
``torch.distributed``.

Counterpart of ``flashinfer_tpu/serving/distributed.py``. One process a
rank, on a ``DeviceMesh`` with dimensions "dp" and "tp" (other dimensions
hold independent copies of the engine): dp replicas each serve their own
continuous batch, and tensor parallelism splits each replica's heads and
MLP columns over its tp ranks.

  * Host scheduling runs identically on every rank: each rank feeds the
    same requests and keeps every replica's queue, slots and page pool, so
    all ranks emit the same tokens and hold the same state. A step admits
    and plans each replica as JAX does (``_admit``; one unified
    prefill + decode ``BatchAttention`` plan, kv-major, with the bucket
    floors that pin its shapes; JAX's int32 step blob).
  * Each rank computes only its replica's step on its tp shard: weights
    from ``shard_llama_params_tp``, caches [L * pages + 1, page_size,
    kvh / tp, d] for that replica (the last row takes the K/V of padding
    rows, which JAX drops), the paged kernel on the local heads,
    ``allreduce_rmsnorm`` at the attention boundary and one all-reduce
    after the MLP, as JAX's ``_dist_step``; KV in the model dtype, e4m3 or
    linear int8.
  * Sampling: greedy takes each tp rank's (max, index) of its vocabulary
    shard and all-gathers them over tp (a tie goes to the lowest tp rank,
    as in JAX); sampled all-gathers the full rows and runs the sampler
    kernel. Sampled steps draw one host seed a replica (JAX splits a key).
  * The tokens of every replica are all-gathered over dp, so every rank
    emits them all.

The step runs eagerly, every one of its ``max_tokens_per_step`` rows (the
padding rows too), as JAX's fixed-shape step does. Start the processes
with torchrun (or ``bootstrap_distributed``'s arguments) and build the
mesh on every rank.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from flashinfer_tpu_torch.models.llama import llama_init_weights
from flashinfer_tpu_torch.ops.attention.batch import BatchAttention, DevicePlan
from flashinfer_tpu_torch.ops.norm import fused_add_rmsnorm
from flashinfer_tpu_torch.ops.sampling import (
    draw_seed,
    softmax,
    top_k_top_p_sampling_from_probs,
)
from flashinfer_tpu_torch.parallel.collectives import (
    all_gather,
    all_reduce,
    allreduce_rmsnorm,
)
from flashinfer_tpu_torch.parallel.mesh import axis_rank, axis_size
from flashinfer_tpu_torch.parallel.tp_serving import shard_llama_params_tp
from flashinfer_tpu_torch.scheduler.native import PagePool
from flashinfer_tpu_torch.serving.engine import (
    EngineConfig,
    GenerationRequest,
    _blob_size,
    _layer_keys,
    _LayerStack,
    _norm_kv_scale,
    _upload,
    fuse_qkv_weights,
)
from flashinfer_tpu_torch.utils import next_power_of_2, resolve_device

__all__ = ["bootstrap_distributed", "DistributedServingEngine"]


def bootstrap_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Initialise the default process group; returns this process's rank.

    ``coordinator_address`` ("host:port", or a URL such as
    "tcp://host:port" or "file:///path") with ``num_processes`` and
    ``process_id``; by default torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``; ``LOCAL_RANK`` picks the
    card). NCCL where a card is present, else gloo. A no-op returning 0 when neither is given, and returning the rank when
    the group already exists."""
    if dist.is_initialized():
        return dist.get_rank()
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" not in env:
        return 0
    if coordinator_address is None:
        init = "env://"
    elif "://" in coordinator_address:
        init = coordinator_address
    else:
        init = f"tcp://{coordinator_address}"
    world = int(env["WORLD_SIZE"] if num_processes is None else num_processes)
    rank = int(env["RANK"] if process_id is None else process_id)
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(env.get(
            "LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)
    return dist.get_rank()


@dataclasses.dataclass
class _Replica:
    """Host-side scheduling state of one dp replica."""

    pool: PagePool
    slots: List[Optional[GenerationRequest]]
    pending: List[GenerationRequest] = dataclasses.field(default_factory=list)
    new_this_step: set = dataclasses.field(default_factory=set)


class DistributedServingEngine(_LayerStack):
    """Continuous-batching engine over the mesh's ("dp", "tp") dimensions:
    per-replica request queues, one step a call on every rank. Greedy
    tokens match ``LlamaServingEngine``'s (up to the TP reduction order).

    ``params``: the full weights (numpy arrays as the JAX package's, or
    tensors; a fused ``wqkv`` is taken too), of which each rank keeps its
    tp shard (views where the shard is the whole weight); None draws them
    from ``seed`` as ``LlamaServingEngine`` does. As JAX's engine, it
    serves model-dtype weights on its own NHD caches, one token a step,
    whatever ``weight_dtype``, ``spec_tokens``, ``decode_window`` and
    ``kv_layout`` say (those are the single-card engine's; a config that
    sets them is served so, with one ``UserWarning`` naming them), on
    pages of any size >= 8."""

    def __init__(self, config: EngineConfig, mesh: Optional[DeviceMesh],
                 params: Optional[Dict[str, object]] = None, seed: int = 0,
                 max_tokens_per_step: Optional[int] = None):
        self.cfg = config
        self.mesh = mesh
        mc = config.model
        if config.kv_dtype not in ("model", "bf16", "fp8_e4m3", "int8"):
            raise ValueError(f"unknown kv_dtype {config.kv_dtype!r}")
        unapplied = [name for name, default in (
            ("weight_dtype", config.weight_dtype == "model"),
            ("spec_tokens", not config.spec_tokens),
            ("decode_window", config.decode_window <= 1),
            ("kv_layout", config.kv_layout == "NHD")) if not default]
        if unapplied:
            warnings.warn(
                f"DistributedServingEngine does not apply "
                f"{', '.join(unapplied)}: it serves model-dtype weights on "
                f"NHD caches, one token a step, as JAX's engine does",
                UserWarning, stacklevel=2)
        if config.page_size < 8:
            raise ValueError(
                f"engine page_size must be >= 8, got {config.page_size}")
        self.device = resolve_device(config.device)
        self.dp = axis_size(mesh, "dp")
        self.tp = axis_size(mesh, "tp")
        self._dp_rank = axis_rank(mesh, "dp")
        self._tp_rank = axis_rank(mesh, "tp")
        if mc.num_kv_heads % self.tp or mc.num_qo_heads % self.tp:
            raise ValueError(f"{mc.num_qo_heads}/{mc.num_kv_heads} heads do "
                             f"not split over tp {self.tp}")
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = llama_init_weights(gen, mc, self.device)
        self.params = fuse_qkv_weights(shard_llama_params_tp(
            params, mesh, mc, device=self.device))
        self._layer_keys = _layer_keys(self.params)
        self._hq, self._hkv = (mc.num_qo_heads // self.tp,
                               mc.num_kv_heads // self.tp)

        self._kv_quant = {"fp8_e4m3": "e4m3", "int8": "int8"}.get(
            config.kv_dtype)
        if self._kv_quant:
            cache_dtype = (torch.float8_e4m3fn if self._kv_quant == "e4m3"
                           else torch.int8)
            self._kv_scale = _norm_kv_scale(config.kv_scale)
        else:
            cache_dtype = mc.dtype
            self._kv_scale = (1.0, 1.0)
        rows = mc.num_layers * config.num_pages
        shape = (rows + 1, config.page_size, self._hkv, mc.head_dim)
        self._scratch_row = rows
        self._hnd = False
        self._k_rows = torch.zeros(shape, dtype=cache_dtype,
                                   device=self.device)
        self._v_rows = torch.zeros(shape, dtype=cache_dtype,
                                   device=self.device)
        # this replica's caches on this rank's kv heads
        self.k_cache, self.v_cache = self._k_rows[:rows], self._v_rows[:rows]
        self._sample_args = (
            torch.tensor(config.temperature, dtype=torch.float32,
                         device=self.device),
            torch.tensor(config.top_k, dtype=torch.int32, device=self.device),
            torch.tensor(config.top_p, dtype=torch.float32,
                         device=self.device))

        self._reps = [_Replica(PagePool(config.num_pages, config.page_size),
                               [None] * config.max_batch)
                      for _ in range(self.dp)]
        self._rr = 0
        self._next_id = 0
        self.generator = torch.Generator().manual_seed(seed + 1)
        self._page_bucket = next_power_of_2(config.num_pages)

        # the step's static shapes (JAX's bucket floors, distributed.py:
        # 188-202), the same on every replica and every step
        group = mc.num_qo_heads // mc.num_kv_heads
        self._tile_q = max(8, next_power_of_2(group))
        self._attn = BatchAttention(kv_layout="NHD", device=self.device,
                                    tile_q=self._tile_q)
        self._kv_chunk = min(2048, next_power_of_2(config.max_seq_len))
        self._rows = next_power_of_2(
            max(max_tokens_per_step or 4 * config.max_batch, 8))
        B = config.max_batch
        chunks = -(-config.max_seq_len // self._kv_chunk)
        tiles = self._rows * group // self._tile_q + B + 2
        self._work_capacity = next_power_of_2(max(8, tiles * chunks))
        self._min_bucket_rows = next_power_of_2(
            self._rows * group + (B + 2) * self._tile_q)
        self._min_splits = next_power_of_2(chunks)
        self.steps = 0
        self.generated_tokens = 0
        self.plan_seconds = 0.0

    # ------------------------------------------------------------------ API

    def add_request(self, prompt, max_new_tokens: int,
                    replica: Optional[int] = None) -> GenerationRequest:
        """Queue a request on ``replica`` (round robin by default). Every
        rank adds the same requests in the same order."""
        total = len(prompt) + max_new_tokens
        if total > self.cfg.max_seq_len:
            raise ValueError(f"prompt+max_new_tokens={total} > max_seq_len"
                             f"={self.cfg.max_seq_len}")
        if len(prompt) > self._rows:
            raise ValueError(f"prompt_len {len(prompt)} > "
                             f"max_tokens_per_step {self._rows}")
        req = GenerationRequest(list(map(int, prompt)), max_new_tokens)
        req.request_id = self._next_id
        self._next_id += 1
        r = self._rr % self.dp if replica is None else replica
        self._rr += 1
        self._reps[r].pending.append(req)
        return req

    @property
    def num_running(self) -> int:
        return sum(s is not None for rep in self._reps for s in rep.slots)

    def has_work(self) -> bool:
        return self.num_running > 0 or any(r.pending for r in self._reps)

    def run_to_completion(self, max_steps: int = 100000) -> None:
        for _ in range(max_steps):
            if not self.has_work():
                return
            self.step()

    # ----------------------------------------------------------------- step

    def step(self) -> List[Tuple[int, int]]:
        """Admit and run one unified prefill + decode step of every replica
        (this rank computes its own). Returns [(request_id, token)] emitted
        this step, the same on every rank."""
        B = self.cfg.max_batch
        inputs = []
        for rep in self._reps:
            self._admit(rep)
            inputs.append(self._replica_inputs(rep))
        seeds = [0 if self.cfg.greedy else draw_seed(self.generator)
                 for _ in range(self.dp)]
        blob, kv = inputs[self._dp_rank]
        t0 = time.perf_counter()
        dplan = self._plan(*kv)
        self.plan_seconds += time.perf_counter() - t0
        toks = self._device_step(blob, dplan, seeds[self._dp_rank])
        toks = all_gather(toks, "dp", mesh=self.mesh).cpu().numpy()

        emitted: List[Tuple[int, int]] = []
        for r, rep in enumerate(self._reps):
            rep.new_this_step.clear()
            for slot in range(B):
                req = rep.slots[slot]
                if req is not None:
                    self._emit(rep, req, int(toks[r, slot]), emitted)
        self.steps += 1
        return emitted

    # ------------------------------------------------------------ internals

    def _admit(self, rep: _Replica) -> None:
        budget = self._rows - sum(1 for s in rep.slots if s is not None)
        for slot in range(self.cfg.max_batch):
            if not rep.pending or rep.slots[slot] is not None:
                continue
            req = rep.pending[0]
            need_pages = -(-len(req.prompt) // self.cfg.page_size)
            if need_pages > rep.pool.free_pages or len(req.prompt) > budget:
                break
            seq = rep.pool.create()
            if not rep.pool.extend(seq, len(req.prompt)):
                raise RuntimeError("page pool refused a checked extension")
            req._seq, req._slot = seq, slot
            rep.slots[slot] = req
            rep.pending.pop(0)
            rep.new_this_step.add(req.request_id)
            budget -= len(req.prompt)

    def _replica_inputs(self, rep: _Replica):
        """Extend the replica's running sequences by this step's token and
        lay out its rows: (JAX's int32 step blob, the plan's host arrays).
        Admitted requests prefill their prompts; a trailing dummy request
        takes the padding rows."""
        B, R = self.cfg.max_batch, self._rows
        qo_lens = np.zeros(B + 1, np.int64)
        kv_lens = np.zeros(B + 1, np.int64)
        tokens = np.zeros(R, np.int64)
        positions = np.zeros(R, np.int32)
        slot_idx = np.full(R, B, np.int32)  # padding rows: the dummy
        valid = np.zeros(R, bool)
        last_rows = np.zeros(B, np.int32)
        row = 0
        for slot in range(B):
            req = rep.slots[slot]
            if req is None:
                continue
            if req.request_id in rep.new_this_step:
                toks, pos0 = req.prompt, 0
            else:
                if not rep.pool.extend(req._seq,
                                       rep.pool.seq_len(req._seq) + 1):
                    raise RuntimeError("KV page pool exhausted")
                toks = [req.output[-1] if req.output else req.prompt[-1]]
                pos0 = rep.pool.seq_len(req._seq) - 1
            n = len(toks)
            qo_lens[slot] = n
            kv_lens[slot] = rep.pool.seq_len(req._seq)
            tokens[row: row + n] = toks
            positions[row: row + n] = pos0 + np.arange(n)
            slot_idx[row: row + n] = slot
            valid[row: row + n] = True
            last_rows[slot] = row + n - 1
            row += n
        qo_lens[B] = R - row

        active = [s for s in rep.slots if s is not None]
        kv_indptr = np.zeros(B + 2, np.int32)
        kv_last = np.zeros(B + 1, np.int32)
        kv_indices = np.zeros(self._page_bucket, np.int32)
        if active:
            indptr_c, indices_c, last_c = rep.pool.batch_export(
                [r._seq for r in active])
            counts = np.zeros(B + 1, np.int64)
            for i, req in enumerate(active):
                counts[req._slot] = indptr_c[i + 1] - indptr_c[i]
                kv_last[req._slot] = last_c[i]
            kv_indptr[1:] = np.cumsum(counts)
            for i, req in enumerate(active):
                s = req._slot
                kv_indices[kv_indptr[s]: kv_indptr[s + 1]] = indices_c[
                    indptr_c[i]: indptr_c[i + 1]]
        slot_valid = np.asarray([s is not None for s in rep.slots], np.int32)
        blob = np.concatenate([
            tokens.astype(np.int32), positions, slot_idx,
            valid.astype(np.int32), last_rows, slot_valid, kv_indices,
            kv_indptr, kv_last])
        qo_indptr = np.concatenate([[0], np.cumsum(qo_lens)])
        return blob, (qo_indptr, kv_indptr, kv_indices, kv_last, kv_lens)

    def _plan(self, qo_indptr, kv_indptr, kv_indices, kv_last,
              kv_lens) -> DevicePlan:
        mc = self.cfg.model
        self._attn.plan(
            qo_indptr, kv_indptr, kv_indices, kv_last, self._hq, self._hkv,
            mc.head_dim, self.cfg.page_size, causal=True,
            sm_scale=1.0 / float(np.sqrt(mc.head_dim)), kv_len_arr=kv_lens,
            kv_chunk_size=self._kv_chunk, work_capacity=self._work_capacity,
            min_bucket_rows=self._min_bucket_rows,
            min_max_splits=self._min_splits, force_kv_major=True,
            defer_upload=True)
        return self._attn.device_plan

    def _device_step(self, blob: np.ndarray, dplan: DevicePlan,
                     seed: int) -> torch.Tensor:
        """This rank's shard of its replica's step; the replica's tokens
        [max_batch] int32 (the same on its tp ranks). The plan blob and the
        step blob go up in one copy."""
        mc, cfg = self.cfg.model, self.cfg
        B, R, pb = cfg.max_batch, self._rows, self._page_bucket
        n = _blob_size(dplan.meta)
        row = np.concatenate([dplan.blob.numpy(), blob]).astype(np.int32)
        buf = torch.empty(len(row), dtype=torch.int32, device=self.device)
        _upload(buf, row)
        dplan = DevicePlan(buf[:n], dplan.meta)
        step = buf[n:]
        tokens, positions = step[:R], step[R: 2 * R]
        slot_idx = step[2 * R: 3 * R]
        valid = step[3 * R: 4 * R] != 0
        last_rows = step[4 * R: 4 * R + B]
        o = 4 * R + 2 * B
        kv_indices = step[o: o + pb]
        kv_indptr = step[o + pb: o + pb + B + 2]
        page_ids = kv_indices[(kv_indptr[slot_idx]
                               + positions // cfg.page_size).clamp(max=pb - 1)]
        layer_rows = torch.arange(0, self._scratch_row, cfg.num_pages,
                                  device=self.device)
        page_rows = torch.where(valid, page_ids[None, :] + layer_rows[:, None],
                                self._scratch_row)
        x = self.params["embedding"][tokens]
        x, mlp = self._run_layers(x, positions, page_rows,
                                  positions % cfg.page_size, dplan)
        x = fused_add_rmsnorm(mlp[last_rows], x[last_rows],
                              self.params["final_norm"], mc.rms_eps)[0]
        logits_local = (x @ self.params["lm_head"]).float()
        return self._tp_sample(logits_local, seed)

    def _attn_out_norm(self, part, x, weight):
        # row-parallel partials, reduced over tp in f32
        return allreduce_rmsnorm(part.float(), x, weight,
                                 self.cfg.model.rms_eps, "tp",
                                 mesh=self.mesh)

    def _mlp_out(self, part, x):
        return all_reduce(part.float(), "tp", mesh=self.mesh).to(x.dtype)

    def _tp_sample(self, logits_local: torch.Tensor,
                   seed: int) -> torch.Tensor:
        """Tokens [B] int32 from this rank's vocabulary shard [B, vocab /
        tp]. Greedy: one all-gather of each shard's (max, global index), the
        first maximum over the shards (a tie goes to the lowest tp rank);
        sampled: the full rows gathered, then the sampler."""
        v_l = logits_local.shape[1]
        if self.cfg.greedy:
            li = logits_local.argmax(dim=-1)
            lm = logits_local.gather(1, li[:, None])[:, 0]
            gi = (li + self._tp_rank * v_l).float()  # exact below 2^24
            g = all_gather(torch.stack([lm, gi]), "tp", mesh=self.mesh)
            sel = g[:, 0].argmax(dim=0)  # [B]
            return g[:, 1].gather(0, sel[None])[0].to(torch.int32)
        full = all_gather(logits_local, "tp", mesh=self.mesh)
        full = full.permute(1, 0, 2).reshape(logits_local.shape[0], -1)
        temperature, top_k, top_p = self._sample_args
        probs = softmax(full, temperature=temperature)
        return top_k_top_p_sampling_from_probs(probs, top_k, top_p,
                                               seed=seed)

    def _emit(self, rep: _Replica, req: GenerationRequest, token: int,
              out_list) -> None:
        req.output.append(token)
        self.generated_tokens += 1
        out_list.append((req.request_id, token))
        if len(req.output) >= req.max_new_tokens or (
                self.cfg.eos_token >= 0 and token == self.cfg.eos_token):
            req.done = True
            rep.pool.release(req._seq)
            rep.slots[req._slot] = None
