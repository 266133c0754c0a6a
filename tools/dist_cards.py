#!/usr/bin/env python3
"""The distributed layer across the cards of one host, one process a card,
NCCL over a FileStore:

    python3 tools/dist_cards.py [--world N] [--out FILE]

N defaults to the card count (4 is what the checks are written for). Each
rank runs, against its own single-card reference on the same seeded
inputs:

  * ``DistributedServingEngine`` at (dp, tp) = (2, 2) on the tiny f32
    Llama with model, e4m3 and int8 KV: greedy tokens equal to
    ``LlamaServingEngine``'s;
  * Llama-3-8B (random bf16 weights, the same on every rank) at (2, 2) and
    (1, 4): 8 requests of 64-512 tokens, 16 new greedy tokens, 512 rows a
    step, eager: step ms, tokens/s, every rank's tokens equal, and the
    agreement with ``LlamaServingEngine`` on rank 0 (reported);
  * ring attention (causal and not) and Ulysses at cp 4 over 8192 tokens
    of Llama-3-8B attention: o and lse against one flash call on the
    whole sequence, to chip_smoke's flash limits;
  * ``fused_moe_ep`` (ep 4) and ``fused_moe_tp`` (moe_tp 4) on a
    Mixtral-8x7B layer (32 tokens, bf16) against ``fused_moe``: within
    2e-2 of the largest output;
  * ``llama_forward_pipelined`` at pp 4 over 4 Llama-3-8B layers (4 x 128
    tokens, 4 microbatches) against ``llama_forward_dense``: within 2^-6
    of the largest logit.

Prints each rank's results and one summary line; exits 1 if a check
fails. ``--device cpu`` runs it on gloo at tiny sizes (a rehearsal).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SIZES = {  # cuda: the published widths; cpu: a rehearsal
    "cuda": dict(ring_tokens=8192, heads=(32, 8, 128), moe=(8, 4096, 14336),
                 moe_tokens=32, rows=512, prompt=(64, 513), llama=None),
    "cpu": dict(ring_tokens=256, heads=(8, 4, 32), moe=(8, 256, 512),
                moe_tokens=32, rows=64, prompt=(8, 60),
                llama=dict(vocab_size=512, hidden_size=256,
                           intermediate_size=512, num_layers=4,
                           num_qo_heads=8, num_kv_heads=4, head_dim=32)),
}
N_NEW, REQUESTS = 16, 8
PIPE_TOL = 2.0 ** -6
MOE_TOL = 2e-2


def _mesh(torch, dev, shape, names):
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for s in shape:
        n *= s
    return DeviceMesh(dev, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def _serve(eng, prompts, n_new):
    reqs = [eng.add_request(p, n_new) for p in prompts]
    eng.run_to_completion()
    return [r.output for r in reqs]


def _tiny_engines(torch, np, dev, out):
    from flashinfer_tpu_torch import EngineConfig, LlamaConfig, \
        LlamaServingEngine
    from flashinfer_tpu_torch.models.llama import llama_init_weights
    from flashinfer_tpu_torch.serving.distributed import (
        DistributedServingEngine,
    )

    mc = LlamaConfig.tiny()
    params = llama_init_weights(torch.Generator(device=dev).manual_seed(0),
                                mc, dev)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, mc.vocab_size, n).tolist()
               for n in (9, 30, 4, 17, 12, 5)]
    mesh = _mesh(torch, dev, (2, 2), ("dp", "tp"))
    for kv in ("model", "fp8_e4m3", "int8"):
        cfg = EngineConfig(model=mc, max_batch=2, num_pages=64, page_size=8,
                           max_seq_len=64, greedy=True, kv_dtype=kv,
                           kv_scale=0.3, device=dev)
        want = _serve(LlamaServingEngine(cfg, params=params), prompts, 8)
        got = _serve(DistributedServingEngine(cfg, mesh, params=params,
                                              max_tokens_per_step=32),
                     prompts, 8)
        out[f"tiny_{kv}_equal"] = got == want


def _llama(torch, np, dev, sizes, rank, out):
    import torch.distributed as dist

    from flashinfer_tpu_torch import EngineConfig, LlamaConfig, \
        LlamaServingEngine
    from flashinfer_tpu_torch.models.llama import llama_init_weights
    from flashinfer_tpu_torch.parallel.collectives import all_gather
    from flashinfer_tpu_torch.serving.distributed import (
        DistributedServingEngine,
    )

    mc = (LlamaConfig.llama3_8b() if sizes["llama"] is None
          else LlamaConfig(**sizes["llama"]))
    params = llama_init_weights(torch.Generator(device=dev).manual_seed(0),
                                mc, dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, mc.vocab_size, int(n)).tolist()
               for n in rng.integers(*sizes["prompt"], REQUESTS)]
    cfg = EngineConfig(model=mc, max_batch=REQUESTS, page_size=16,
                       greedy=True, device=dev)
    world = _mesh(torch, dev, (4,), ("all",))
    for shape in ((2, 2), (1, 4)):
        name = f"llama_dp{shape[0]}_tp{shape[1]}"
        eng = DistributedServingEngine(
            cfg, _mesh(torch, dev, shape, ("dp", "tp")), params=params,
            max_tokens_per_step=sizes["rows"])
        reqs = [eng.add_request(p, N_NEW) for p in prompts]
        step_ms = []
        t0 = time.perf_counter()
        while eng.has_work():
            pending = sum(len(r.pending) for r in eng._reps)
            ts = time.perf_counter()
            eng.step()
            if not pending:
                step_ms.append((time.perf_counter() - ts) * 1e3)
        wall = time.perf_counter() - t0
        toks = torch.tensor([r.output for r in reqs], device=dev)
        every = all_gather(toks, "all", mesh=world)
        out[name] = dict(step_ms_median=float(np.median(step_ms)),
                         tokens_per_s=eng.generated_tokens / wall,
                         steps=eng.steps,
                         same_on_every_rank=bool((every == toks).all()))
        out[name + "_tokens"] = toks.tolist()
        del eng
    if rank == 0:
        single = _serve(LlamaServingEngine(cfg, params=params), prompts,
                        N_NEW)
        for shape in ((2, 2), (1, 4)):
            name = f"llama_dp{shape[0]}_tp{shape[1]}"
            got = np.asarray(out.pop(name + "_tokens"))
            out[name]["agreement_with_single_card"] = float(
                np.mean(got == np.asarray(single)))
    else:
        for shape in ((2, 2), (1, 4)):
            out.pop(f"llama_dp{shape[0]}_tp{shape[1]}_tokens")
    dist.barrier()


def _ring(torch, dev, sizes, rank, out):
    import chip_smoke as cs
    from flashinfer_tpu_torch.ops.attention.kernels.flash import (
        flash_attention_dense,
    )
    from flashinfer_tpu_torch.parallel import ring_attention, \
        ulysses_attention
    from flashinfer_tpu_torch.parallel.collectives import all_gather

    cp = _mesh(torch, dev, (4,), ("cp",))
    hq, hkv, d = sizes["heads"]
    n = sizes["ring_tokens"]
    gen = torch.Generator(device=dev).manual_seed(6)
    dt = torch.bfloat16 if dev == "cuda" else torch.float32
    q, k, v = (torch.randn(n, h, d, device=dev, generator=gen, dtype=dt)
               for h in (hq, hkv, hkv))
    rows = slice(rank * n // 4, (rank + 1) * n // 4)
    for causal in (False, True):
        want = flash_attention_dense(q, k, v, causal=causal)
        o, lse = ring_attention(q[rows], k[rows], v[rows], cp, causal=causal,
                                return_lse=True)
        uly = ulysses_attention(q[rows], k[rows], v[rows], cp, causal=causal)
        got = (all_gather(o, "cp", mesh=cp).reshape(want[0].shape),
               all_gather(lse, "cp", mesh=cp).reshape(want[1].shape))
        chk = cs._attn_check(torch, got, want)
        uly = all_gather(uly, "cp", mesh=cp).reshape(want[0].shape)
        chk_u = cs._attn_check(torch, (uly, want[1]), want)
        out[f"ring_causal{int(causal)}"] = dict(
            ok=chk["ok"], err_o=chk["err_o"], err_lse=chk["err_lse"])
        out[f"ulysses_causal{int(causal)}"] = dict(
            ok=chk_u["ok"], err_o=chk_u["err_o"])


def _moe(torch, dev, sizes, rank, out):
    import importlib

    from flashinfer_tpu_torch.parallel import fused_moe_ep, fused_moe_tp
    from flashinfer_tpu_torch.parallel.mesh import local_shard
    from flashinfer_tpu_torch.parallel.moe import shard_w13_for_tp

    moe = importlib.import_module("flashinfer_tpu_torch.ops.fused_moe")
    e, hidden, inter = sizes["moe"]
    m = sizes["moe_tokens"]
    gen = torch.Generator(device=dev).manual_seed(7)
    dt = torch.bfloat16 if dev == "cuda" else torch.float32

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale).to(dt)

    x = randn(m, hidden)
    logits = torch.randn(m, e, device=dev, generator=gen)
    w13 = randn(e, 2 * inter, hidden, scale=hidden ** -0.5)
    w2 = randn(e, hidden, inter, scale=inter ** -0.5)
    ids, scales = moe.route_tokens(logits, 2)
    want = moe.fused_moe(x, w13, w2, ids, scales).float()
    mag = float(want.abs().max())
    ep = _mesh(torch, dev, (4,), ("ep",))
    tok = slice(rank * m // 4, (rank + 1) * m // 4)
    mine = slice(rank * e // 4, (rank + 1) * e // 4)
    # a capacity of every local copy: no drops, so fused_moe is the reference
    got = fused_moe_ep(x[tok], logits[tok], w13[mine], w2[mine], ep,
                       top_k=2, capacity=2 * m // 4)
    out["moe_ep4_rel_err"] = float((got.float() - want[tok]).abs().max()
                                   / mag)
    tp = _mesh(torch, dev, (4,), ("moe_tp",))
    # the shards made contiguous once, as a deployment loads them
    w13_l = local_shard(shard_w13_for_tp(w13), (None, None, "moe_tp"),
                        tp).reshape(e, -1, hidden)
    w2_l = local_shard(w2, (None, None, "moe_tp"), tp).contiguous()
    got = fused_moe_tp(x, logits, w13_l, w2_l, tp, top_k=2)
    out["moe_tp4_rel_err"] = float((got.float() - want).abs().max() / mag)


def _pipeline(torch, dev, sizes, rank, out):
    from flashinfer_tpu_torch import LlamaConfig
    from flashinfer_tpu_torch.models.llama import (
        PER_LAYER,
        llama_forward_dense,
        llama_init_weights,
    )
    from flashinfer_tpu_torch.parallel import llama_forward_pipelined

    mc = (LlamaConfig.llama3_8b() if sizes["llama"] is None
          else LlamaConfig(**sizes["llama"]))
    mc = dataclasses.replace(mc, num_layers=4)
    params = llama_init_weights(torch.Generator(device=dev).manual_seed(8),
                                mc, dev)
    tokens = torch.randint(0, mc.vocab_size, (4, 128), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(9))
    want = llama_forward_dense(params, tokens, mc)
    stage = {k: (v[rank: rank + 1] if k in PER_LAYER else v)
             for k, v in params.items()}
    pp = _mesh(torch, dev, (4,), ("pp",))
    got = llama_forward_pipelined(stage, tokens, mc, pp, num_microbatches=4)
    out["pipeline_pp4_rel_err"] = float((got - want).abs().max()
                                        / want.abs().max())


def child(rank, world, store, dev):
    import numpy as np
    import torch
    import torch.distributed as dist

    from flashinfer_tpu_torch.serving.distributed import bootstrap_distributed

    bootstrap_distributed(f"file://{store}", world, rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    sizes = SIZES[dev]
    out = dict(rank=rank, backend=dist.get_backend())
    t0 = time.perf_counter()
    try:
        _tiny_engines(torch, np, dev, out)
        _ring(torch, dev, sizes, rank, out)
        _moe(torch, dev, sizes, rank, out)
        _pipeline(torch, dev, sizes, rank, out)
        _llama(torch, np, dev, sizes, rank, out)
    finally:
        out["seconds"] = time.perf_counter() - t0
        print("RESULT " + json.dumps(out), flush=True)
        dist.destroy_process_group()


def _failed(r):
    bad = [k for k, v in r.items() if k.endswith("_equal") and not v]
    bad += [k for k, v in r.items() if isinstance(v, dict)
            and v.get("ok") is False]
    bad += [k for k in ("moe_ep4_rel_err", "moe_tp4_rel_err")
            if r.get(k, 0) > MOE_TOL]
    bad += [k for k in ("pipeline_pp4_rel_err",) if r.get(k, 0) > PIPE_TOL]
    bad += [k for k, v in r.items() if k.startswith("llama_")
            and not v.get("same_on_every_rank")]
    return bad


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", help="also write the ranks' results (JSON)")
    ap.add_argument("--child", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--store", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        child(args.child, args.world, args.store, args.device)
        return 0
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("dist_cards: no CUDA device", file=sys.stderr)
        return 2
    world = args.world or (torch.cuda.device_count()
                           if args.device == "cuda" else 4)
    if world != 4:
        print(f"dist_cards: the checks are written for 4 ranks, not "
              f"{world}", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip() if args.device == "cuda" else "cpu"
    tmp = tempfile.mkdtemp(prefix="dist_cards_")
    env = dict(os.environ, TORCH_NCCL_ASYNC_ERROR_HANDLING="1")
    if args.device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", str(r),
         "--world", str(world), "--store", os.path.join(tmp, "store"),
         "--device", args.device], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=900)[0])
    finally:
        for p in procs:
            p.kill()
    results = []
    for r, log in enumerate(logs):
        lines = [x for x in log.splitlines() if x.startswith("RESULT ")]
        if procs[r].returncode or not lines:
            print(f"rank {r} failed (rc {procs[r].returncode}):\n"
                  f"{log[-4000:]}")
            results.append(None)
            continue
        results.append(json.loads(lines[-1][len("RESULT "):]))
        print(f"rank {r}: {lines[-1][len('RESULT '):]}")
    bad = {r: (_failed(x) if x else ["crashed"])
           for r, x in enumerate(results)}
    print(json.dumps({"card": card, "world": world,
                      "failed": {r: b for r, b in bad.items() if b}}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, ranks=results), f, indent=1)
    return 1 if any(bad.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
