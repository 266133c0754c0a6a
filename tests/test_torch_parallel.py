"""The distributed layer (``flashinfer_tpu_torch.parallel``) on gloo
against the JAX package's ``parallel`` on the same numpy inputs.

The JAX side runs here, on the virtual 8-device CPU mesh of
``tests/conftest.py`` (Pallas in interpret mode), as ``tests/test_parallel.py``
runs it. The port's side runs in worker processes, one a rank, at world 4
and world 2: this file run as a script (``python tests/test_torch_parallel.py
GROUP DIR RANK WORLD``), which imports no JAX. Each world is one spawn that
runs every check of its group; a rank writes its local results to DIR.

Tolerances: f32 results to 2e-4 relative and absolute (JAX's own, which
covers other reduction orders); bf16 MoE to 2e-2 (JAX's for that test);
fp8 bits and capacity drops exactly."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-4)

# ------------------------------------------------------------------ inputs
# (numpy, seeded; the same arrays reach JAX and the port's workers)


def _bf16(a):
    """a rounded to bf16 values, kept as f32 (numpy has no bf16)."""
    import ml_dtypes

    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float32)


def _e4m3_bits(a):
    import ml_dtypes

    return np.asarray(a, np.float32).astype(ml_dtypes.float8_e4m3fn).view(
        np.int8)


def _llama_cfg_args():
    return dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                num_layers=4, num_qo_heads=4, num_kv_heads=2, head_dim=16)


def inputs_world4():
    rng = np.random.default_rng(0)
    n = rng.standard_normal
    d = {}
    d["ar_x"] = n((4, 8, 32)).astype(np.float32)
    d["ar_res"] = n((8, 32)).astype(np.float32)
    d["ar_w"] = n(32).astype(np.float32)
    d["moe_fx"] = n((4, 4, 16)).astype(np.float32)
    d["moe_fshared"] = n((4, 16)).astype(np.float32)
    d["moe_fres"] = n((4, 16)).astype(np.float32)
    d["gemm_x"] = n((16, 64)).astype(np.float32)
    d["gemm_w"] = n((64, 32)).astype(np.float32)
    # MoeAlltoAll: 16 tokens, top-2 of 8 experts over 4 ranks
    d["a2a_x"] = n((16, 16)).astype(np.float32)
    d["a2a_ids"] = rng.integers(0, 8, (16, 2)).astype(np.int32)
    d["a2a_scales"] = rng.uniform(0.2, 1.0, (16, 2)).astype(np.float32)
    # ring attention (seq 32, 2 heads, d 16) and Ulysses (seq 16, 4, 8)
    for t in "qkv":
        d[f"ring_{t}"] = n((32, 2, 16)).astype(np.float32)
        d[f"uly_{t}"] = n((16, 4, 8)).astype(np.float32)
    # EP MoE: 32 tokens, hidden 64, inter 32, 8 experts, top-2
    d["ep_x"] = (n((32, 64)) * 0.3).astype(np.float32)
    d["ep_logits"] = n((32, 8)).astype(np.float32)
    d["ep_w13"] = (n((8, 64, 64)) * 0.1).astype(np.float32)
    d["ep_w2"] = (n((8, 64, 32)) * 0.1).astype(np.float32)
    # capacity drop: every token to expert 0, capacity 2
    d["drop_x"] = (n((16, 32)) * 0.3).astype(np.float32)
    logits = np.zeros((16, 4), np.float32)
    logits[:, 0] = 10.0
    d["drop_logits"] = logits
    d["drop_w13"] = (n((4, 32, 32)) * 0.1).astype(np.float32)
    d["drop_w2"] = (n((4, 32, 16)) * 0.1).astype(np.float32)
    # TP MoE (bf16 values; e4m3 bits at scale 0.1): 24 tokens, 4 experts
    d["tp_x"] = _bf16(n((24, 64)) * 0.3)
    d["tp_logits"] = n((24, 4)).astype(np.float32)
    d["tp_w13"] = _bf16(n((4, 64, 64)) * 0.1)
    d["tp_w2"] = _bf16(n((4, 64, 32)) * 0.1)
    d["tp_w13_e4m3"] = _e4m3_bits(d["tp_w13"] / 0.1)
    d["tp_w2_e4m3"] = _e4m3_bits(d["tp_w2"] / 0.1)
    # ep x moe_tp: 16 tokens, 8 experts; per-expert e4m3 scales
    d["ept_x"] = (n((16, 64)) * 0.3).astype(np.float32)
    d["ept_logits"] = n((16, 8)).astype(np.float32)
    d["ept_w13"] = (n((8, 64, 64)) * 0.1).astype(np.float32)
    d["ept_w2"] = (n((8, 64, 32)) * 0.1).astype(np.float32)
    d["ept_s13"] = rng.uniform(0.05, 0.15, 8).astype(np.float32)
    d["ept_s2"] = rng.uniform(0.05, 0.15, 8).astype(np.float32)
    d["ept_w13_e4m3"] = _e4m3_bits(d["ept_w13"] / d["ept_s13"][:, None, None])
    d["ept_w2_e4m3"] = _e4m3_bits(d["ept_w2"] / d["ept_s2"][:, None, None])
    # pipeline: 4 stages, 6 microbatches of 2 x 16
    d["pp_W"] = (n((4, 16, 16)) * 0.3).astype(np.float32)
    d["pp_b"] = (n((4, 16)) * 0.1).astype(np.float32)
    d["pp_x"] = n((6, 2, 16)).astype(np.float32)
    d["pl_tokens"] = rng.integers(0, 128, (8, 6)).astype(np.int64)
    return d


def inputs_world2():
    rng = np.random.default_rng(1)
    d = {}
    for t in "qkv":
        d[f"ring_{t}"] = rng.standard_normal((32, 2, 16)).astype(np.float32)
        d[f"uly_{t}"] = rng.standard_normal((16, 4, 8)).astype(np.float32)
    d["tps_prompts"] = rng.integers(0, 256, (2, 4)).astype(np.int64)
    return d


def _jax_llama_params(cfg_args, tiny=False):
    """JAX's llama_init_weights(key 0) as numpy, with its config."""
    import jax
    import jax.numpy as jnp

    from flashinfer_tpu.models.llama import LlamaConfig, llama_init_weights

    cfg = (LlamaConfig.tiny() if tiny
           else LlamaConfig(**cfg_args, dtype=jnp.float32))
    params = llama_init_weights(jax.random.key(0), cfg)
    return cfg, {k: np.asarray(v) for k, v in params.items()}


# ------------------------------------------------------------ port workers

def _mesh(torch, shape, names):
    from torch.distributed.device_mesh import DeviceMesh

    n = int(np.prod(shape))
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def _port_world4(d, out, rank):
    import torch

    from flashinfer_tpu_torch.ops.fused_moe import RoutingMethodType
    from flashinfer_tpu_torch.parallel import (
        Mapping,
        MoeAlltoAll,
        all_reduce,
        allreduce_rmsnorm,
        allreduce_rmsnorm_quant_fp8,
        fused_moe_ep,
        fused_moe_tp,
        gemm_allreduce,
        llama_forward_pipelined,
        make_mesh,
        moe_allreduce_fusion,
        pipeline_forward,
        ring_attention,
        ulysses_attention,
    )
    from flashinfer_tpu_torch.parallel.moe import shard_w13_for_tp
    from flashinfer_tpu_torch.parallel.mesh import local_shard

    t = {k: torch.from_numpy(v) for k, v in d.items()}
    r = rank
    tp = _mesh(torch, (4,), ("tp",))
    out["all_reduce"] = all_reduce(t["ar_x"][r], mesh=tp)
    out["arn_normed"], out["arn_res"] = allreduce_rmsnorm(
        t["ar_x"][r], t["ar_res"], t["ar_w"], mesh=tp)
    # an f32 partial into a bf16 residual, as the serving steps call it
    out["arn_mixed_normed"], out["arn_mixed_res"] = (
        o.float() for o in allreduce_rmsnorm(
            t["ar_x"][r], t["ar_res"].bfloat16(), t["ar_w"].bfloat16(),
            mesh=tp))
    q, scale, res = allreduce_rmsnorm_quant_fp8(t["ar_x"][r], t["ar_res"],
                                                t["ar_w"], mesh=tp)
    out["arq_bits"], out["arq_scale"], out["arq_res"] = (
        q.view(torch.int8), scale, res)
    out["maf_normed"], out["maf_res"] = moe_allreduce_fusion(
        t["moe_fx"][r], 0.5, t["moe_fshared"], t["moe_fres"],
        torch.ones(16), mesh=tp)
    out["gemm_ar"] = gemm_allreduce(t["gemm_x"][:, 16 * r: 16 * r + 16],
                                    t["gemm_w"][16 * r: 16 * r + 16], mesh=tp)

    ep = _mesh(torch, (4,), ("ep",))
    tok = slice(4 * r, 4 * r + 4)
    for cap in (16, 2):
        a2a = MoeAlltoAll(8, capacity=cap, axis_name="ep", mesh=ep)
        ids = t["a2a_ids"][tok]
        recv_x, recv_e, slot = a2a.dispatch(t["a2a_x"][tok], ids)
        y = recv_x * torch.where(recv_e >= 0, recv_e + 1, 0)[:, None]
        out[f"a2a_{cap}"] = a2a.combine(y, slot, ids, t["a2a_scales"][tok])
        out[f"a2a_slot_{cap}"] = slot

    cp = _mesh(torch, (4,), ("cp",))
    rows = slice(8 * r, 8 * r + 8)
    for causal in (False, True):
        o, lse = ring_attention(*(t[f"ring_{x}"][rows] for x in "qkv"), cp,
                                causal=causal, return_lse=True)
        out[f"ring_o_{causal}"], out[f"ring_lse_{causal}"] = o, lse
    out["uly"] = ulysses_attention(
        *(t[f"uly_{x}"][4 * r: 4 * r + 4] for x in "qkv"), cp, causal=True)

    experts = slice(2 * r, 2 * r + 2)
    for routing in (RoutingMethodType.Default, RoutingMethodType.Renormalize):
        out[f"ep_{routing.name}"] = fused_moe_ep(
            t["ep_x"][8 * r: 8 * r + 8], t["ep_logits"][8 * r: 8 * r + 8],
            t["ep_w13"][experts], t["ep_w2"][experts], ep, top_k=2,
            routing_method=routing, capacity=64)
    out["ep_drop"] = fused_moe_ep(
        t["drop_x"][tok], t["drop_logits"][tok], t["drop_w13"][r: r + 1],
        t["drop_w2"][r: r + 1], ep, top_k=1, capacity=2)

    mtp = _mesh(torch, (4,), ("moe_tp",))
    for fp8 in (False, True):
        if fp8:
            w13 = t["tp_w13_e4m3"].view(torch.float8_e4m3fn)
            w2 = t["tp_w2_e4m3"].view(torch.float8_e4m3fn)
            s13 = s2 = torch.full((4,), 0.1)
        else:
            w13, w2 = t["tp_w13"].bfloat16(), t["tp_w2"].bfloat16()
            s13 = s2 = None
        w13_l = local_shard(shard_w13_for_tp(w13), (None, None, "moe_tp"),
                            mtp).reshape(4, -1, 64)
        w2_l = local_shard(w2, (None, None, "moe_tp"), mtp)
        out[f"tp_{fp8}"] = fused_moe_tp(
            t["tp_x"].bfloat16(), t["tp_logits"], w13_l, w2_l, mtp, top_k=2,
            w13_scale=s13, w2_scale=s2).float()

    ept = _mesh(torch, (2, 2), ("ep", "moe_tp"))
    e_rank = ept.get_local_rank("ep")
    for fp8 in (False, True):
        if fp8:
            w13 = t["ept_w13_e4m3"].view(torch.float8_e4m3fn)
            w2 = t["ept_w2_e4m3"].view(torch.float8_e4m3fn)
            s13, s2 = t["ept_s13"], t["ept_s2"]
        else:
            w13, w2, s13, s2 = t["ept_w13"], t["ept_w2"], None, None
        w13_l = local_shard(shard_w13_for_tp(w13), ("ep", None, "moe_tp"),
                            ept).reshape(4, -1, 64)
        w2_l = local_shard(w2, ("ep", None, "moe_tp"), ept)
        xt = slice(8 * e_rank, 8 * e_rank + 8)
        out[f"ept_{fp8}"] = fused_moe_ep(
            t["ept_x"][xt], t["ept_logits"][xt], w13_l, w2_l, ept, top_k=2,
            capacity=32, tp_axis_name="moe_tp", w13_scale=s13, w2_scale=s2)

    pp = _mesh(torch, (4,), ("pp",))
    out["pipeline"] = pipeline_forward(
        lambda p, a: torch.tanh(a @ p[0] + p[1]), (t["pp_W"][r], t["pp_b"][r]),
        t["pp_x"], pp)
    from flashinfer_tpu_torch.models.llama import PER_LAYER, LlamaConfig

    cfg = LlamaConfig(**_llama_cfg_args(), dtype=torch.float32)
    params = {k[3:]: v for k, v in t.items() if k.startswith("pl/")}
    # this stage's layer of the four
    stage = {k: v[r: r + 1] if k in PER_LAYER else v
             for k, v in params.items()}
    out["pipelined"] = llama_forward_pipelined(
        stage, t["pl_tokens"], cfg, pp, num_microbatches=4)

    # the mesh views of a Mapping: each rank's coordinates and groups
    mapping = Mapping(world_size=4, rank=r, tp_size=2, cp_size=2,
                      moe_tp_size=1, moe_ep_size=4)
    ctx = make_mesh(mapping)
    import torch.distributed as dist

    coords, groups = [], []
    for mesh in (ctx.mesh, ctx.moe_mesh):
        for name in mesh.mesh_dim_names:
            coords.append(mesh.get_local_rank(name))
            groups.append(dist.get_process_group_ranks(mesh.get_group(name)))
    out["mesh_coords"] = torch.tensor(coords)
    out["mesh_groups"] = torch.tensor([g + [-1] * (4 - len(g))
                                       for g in groups])


def _port_world2(d, out, rank):
    import torch

    from flashinfer_tpu_torch.models.llama import LlamaConfig
    from flashinfer_tpu_torch.ops.attention.batch import (
        BatchDecodeWithPagedKVCacheWrapper,
    )
    from flashinfer_tpu_torch.parallel import (
        make_tp_decode_step,
        ring_attention,
        shard_llama_params_tp,
        ulysses_attention,
    )
    from flashinfer_tpu_torch.scheduler.native import PagePool

    t = {k: torch.from_numpy(v) for k, v in d.items()}
    r = rank
    cp = _mesh(torch, (2,), ("cp",))
    rows = slice(16 * r, 16 * r + 16)
    for causal in (False, True):
        o, lse = ring_attention(*(t[f"ring_{x}"][rows] for x in "qkv"), cp,
                                causal=causal, return_lse=True)
        out[f"ring_o_{causal}"], out[f"ring_lse_{causal}"] = o, lse
    out["uly"] = ulysses_attention(
        *(t[f"uly_{x}"][8 * r: 8 * r + 8] for x in "qkv"), cp, causal=True)

    # the TP decode step at tp 2, token by token over 4-token prompts
    tpm = _mesh(torch, (2,), ("tp",))
    cfg = LlamaConfig.tiny()
    np_params = {k[4:]: v for k, v in d.items() if k.startswith("tps/")}
    params = shard_llama_params_tp(np_params, tpm, cfg, device="cpu")
    B, S, PS, PAGES = 2, 4, 4, 16
    prompts = t["tps_prompts"]
    pool = PagePool(num_pages=PAGES, page_size=PS)
    seqs = [pool.create() for _ in range(B)]
    hkv_l = cfg.num_kv_heads // 2
    kc = torch.zeros(cfg.num_layers, PAGES, PS, hkv_l, cfg.head_dim)
    vc = torch.zeros_like(kc)
    step = make_tp_decode_step(tpm, cfg)
    for pos in range(S):
        for s in seqs:
            pool.extend(s, pos + 1)
        indptr, indices, last = pool.batch_export(seqs)
        w = BatchDecodeWithPagedKVCacheWrapper(kv_layout="NHD", device="cpu")
        w.plan(indptr, indices, last, cfg.num_qo_heads // 2, hkv_l,
               cfg.head_dim, PS)
        logits, kc, vc = step(
            params, kc, vc, prompts[:, pos], torch.full((B,), pos),
            torch.ones(B, dtype=torch.bool),
            torch.from_numpy(np.asarray(indices, np.int32)),
            torch.from_numpy(np.asarray(indptr, np.int32)),
            torch.from_numpy(np.asarray(last, np.int32)), w.device_plan)
    out["tp_logits"] = logits


GROUPS = {"world4": (4, inputs_world4, _port_world4),
          "world2": (2, inputs_world2, _port_world2)}


def _worker(group, outdir, rank, world):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{outdir}/store",
                            rank=rank, world_size=world)
    data = dict(np.load(os.path.join(outdir, "inputs.npz")))
    out = {}
    GROUPS[group][2](data, out, rank)
    np.savez(os.path.join(outdir, f"out_{rank}.npz"),
             **{k: v.detach().numpy() for k, v in out.items()})
    dist.barrier()
    dist.destroy_process_group()


def spawn(script, group, outdir, world, data, timeout=240):
    """Run ``script GROUP DIR RANK WORLD`` as ``world`` processes (gloo over
    a FileStore in ``outdir``); returns each rank's results."""
    np.savez(os.path.join(outdir, "inputs.npz"), **data)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, script, group, str(outdir), str(r), str(world)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [dict(np.load(os.path.join(outdir, f"out_{r}.npz")))
            for r in range(world)]


def _spawn_group(tmp_path_factory, group):
    world, make, _ = GROUPS[group]
    data = make()
    if group == "world4":
        _, params = _jax_llama_params(_llama_cfg_args())
        data.update({f"pl/{k}": v for k, v in params.items()})
    else:
        _, params = _jax_llama_params(None, tiny=True)
        data.update({f"tps/{k}": v for k, v in params.items()})
    outs = spawn(os.path.abspath(__file__), group,
                 tmp_path_factory.mktemp(group), world, data)
    return data, outs


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _spawn_group(tmp_path_factory, "world4")


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _spawn_group(tmp_path_factory, "world2")


# ------------------------------------------------------------- JAX helpers

def _shard_map(fn, mesh, in_specs, out_specs):
    import jax

    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def _jit(fn, *args):
    """fn(*args) under one ``jax.jit``: a shard_map region run eagerly
    dispatches op by op (~12 s for one MoE layer here), jitted ~1 s."""
    import jax

    return jax.jit(fn)(*args)


def _mesh1d(name, n):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:n]), (name,))


def _cat(outs, key):
    return np.concatenate([o[key] for o in outs])


# ------------------------------------------------------------------- tests

@pytest.mark.parametrize("kw", [
    dict(world_size=16, rank=7, tp_size=2, pp_size=2, cp_size=2),
    dict(world_size=8, rank=3, tp_size=4, cp_size=2, moe_tp_size=2,
         moe_ep_size=4),
    dict(world_size=8, rank=5, tp_size=2, pp_size=4, enable_attention_dp=True),
    dict(world_size=12, rank=11, tp_size=3, cp_size=2, dp_size=2),
])
def test_mapping_matches_jax(kw):
    from flashinfer_tpu.parallel import Mapping as JaxMapping
    from flashinfer_tpu_torch.parallel import Mapping

    ours, theirs = Mapping(**kw), JaxMapping(**kw)
    for name in ("tp_group", "cp_group", "pp_group", "dp_group",
                 "moe_ep_group", "moe_tp_group"):
        assert getattr(ours, name)() == getattr(theirs, name)(), name
    for name in ("tp_rank", "cp_rank", "pp_rank", "dp_rank", "moe_tp_rank",
                 "moe_ep_rank", "attn_tp_size", "attn_dp_size",
                 "prev_pp_rank", "next_pp_rank", "is_first_pp_rank",
                 "is_last_pp_rank", "dp_size", "moe_tp_size", "moe_ep_size"):
        assert getattr(ours, name) == getattr(theirs, name), name
    with pytest.raises(ValueError):
        Mapping(world_size=6, tp_size=4)
    with pytest.raises(ValueError):
        Mapping(world_size=8, tp_size=4, moe_tp_size=3, moe_ep_size=2)


def test_make_mesh_views_follow_the_mapping(world4):
    """Rank r is device r, row-major: each view's coordinates and groups
    are ``Mapping``'s (world 4: tp 2 x cp 2, MoE view ep 4 x moe_tp 1)."""
    from flashinfer_tpu_torch.parallel import Mapping

    _, outs = world4
    for r, o in enumerate(outs):
        m = Mapping(world_size=4, rank=r, tp_size=2, cp_size=2,
                    moe_tp_size=1, moe_ep_size=4)
        want_coords = [m.dp_rank, m.pp_rank, m.cp_rank, m.tp_rank,
                       m.dp_rank, m.pp_rank, m.moe_ep_rank, m.moe_tp_rank]
        want_groups = [m.dp_group(), m.pp_group(), m.cp_group(),
                       m.tp_group(), m.dp_group(), m.pp_group(),
                       m.moe_ep_group(), m.moe_tp_group()]
        assert o["mesh_coords"].tolist() == want_coords
        got = [[x for x in g if x >= 0] for g in o["mesh_groups"].tolist()]
        assert got == want_groups


@pytest.mark.parametrize("name", ["all_reduce", "allreduce_rmsnorm",
                                  "allreduce_rmsnorm_quant_fp8",
                                  "moe_allreduce_fusion", "gemm_allreduce"])
def test_collectives_match_jax(world4, name):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from flashinfer_tpu.parallel import collectives as jc

    d, outs = world4
    mesh = _mesh1d("tp", 4)
    x, res, w = (jnp.asarray(d[k]) for k in ("ar_x", "ar_res", "ar_w"))
    if name == "all_reduce":
        want = {"all_reduce": _shard_map(
            lambda a: jc.all_reduce(a[0]), mesh, (P("tp"),), P())(x)}
    elif name == "allreduce_rmsnorm":
        n, r = _shard_map(lambda a, b, c: jc.allreduce_rmsnorm(a[0], b, c),
                          mesh, (P("tp"), P(), P()), (P(), P()))(x, res, w)
        want = {"arn_normed": n, "arn_res": r}
    elif name == "allreduce_rmsnorm_quant_fp8":
        q, s, r = _shard_map(
            lambda a, b, c: jc.allreduce_rmsnorm_quant_fp8(a[0], b, c),
            mesh, (P("tp"), P(), P()), (P(), P(), P()))(x, res, w)
        want = {"arq_bits": np.asarray(q).view(np.int8), "arq_scale": s,
                "arq_res": r}
    elif name == "moe_allreduce_fusion":
        n, r = _shard_map(
            lambda a, b, c, e: jc.moe_allreduce_fusion(
                a[0], jnp.float32(0.5), b, c, e),
            mesh, (P("tp"), P(), P(), P()), (P(), P()))(
                jnp.asarray(d["moe_fx"]), jnp.asarray(d["moe_fshared"]),
                jnp.asarray(d["moe_fres"]), jnp.ones(16, jnp.float32))
        want = {"maf_normed": n, "maf_res": r}
    else:
        want = {"gemm_ar": _shard_map(
            lambda a, b: jc.gemm_allreduce(a, b, "tp"), mesh,
            (P(None, "tp"), P("tp", None)), P())(
                jnp.asarray(d["gemm_x"]), jnp.asarray(d["gemm_w"]))}
    for o in outs:  # every rank holds the reduced result
        for key, ref in want.items():
            if key == "arq_bits":
                np.testing.assert_array_equal(o[key], np.asarray(ref))
            else:
                np.testing.assert_allclose(o[key], np.asarray(ref), **TOL)


def test_allreduce_rmsnorm_rounds_an_f32_sum_once_into_a_bf16_residual(
        world4):
    """An f32 partial and a bf16 residual (the serving steps' call): the
    residual is the f32 sum rounded once to bf16, normed by the plain
    RMSNorm, the same on every rank (the port's rule; JAX rounds to the
    partial's dtype, which no caller of the port mixes)."""
    import torch

    from flashinfer_tpu_torch.ops.norm import rmsnorm_plain

    d, outs = world4
    full = torch.from_numpy(d["ar_x"].sum(0, dtype=np.float32))
    res = (full + torch.from_numpy(d["ar_res"]).bfloat16().float()).bfloat16()
    normed = rmsnorm_plain(res, torch.from_numpy(d["ar_w"]).bfloat16(), 1e-6)
    for o in outs:
        np.testing.assert_allclose(o["arn_mixed_res"], res.float().numpy(),
                                   rtol=2 ** -8, atol=0)
        np.testing.assert_array_equal(
            o["arn_mixed_normed"], rmsnorm_plain(
                torch.from_numpy(o["arn_mixed_res"]).bfloat16(),
                torch.from_numpy(d["ar_w"]).bfloat16(),
                1e-6).float().numpy())
        np.testing.assert_allclose(o["arn_mixed_normed"],
                                   normed.float().numpy(), rtol=2 ** -7,
                                   atol=2 ** -7)


@pytest.mark.parametrize("capacity", [16, 2])
def test_moe_alltoall_matches_jax(world4, capacity):
    """Round trip through dispatch and combine; capacity 2 drops copies,
    in the same slots as JAX."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from flashinfer_tpu.parallel.collectives import MoeAlltoAll

    d, outs = world4
    a2a = MoeAlltoAll(8, capacity=capacity, axis_name="ep")

    def body(x, ids, scales):
        recv_x, recv_e, slot = a2a.dispatch(x, ids)
        y = recv_x * jnp.where(recv_e >= 0, recv_e + 1, 0)[:, None]
        return a2a.combine(y, slot, ids, scales), slot

    want, slot = _shard_map(body, _mesh1d("ep", 4), (P("ep"),) * 3,
                            (P("ep"), P("ep")))(
        *(jnp.asarray(d[k]) for k in ("a2a_x", "a2a_ids", "a2a_scales")))
    np.testing.assert_array_equal(_cat(outs, f"a2a_slot_{capacity}"),
                                  np.asarray(slot))
    np.testing.assert_allclose(_cat(outs, f"a2a_{capacity}"),
                               np.asarray(want), **TOL)
    if capacity == 2:
        assert (np.asarray(slot) < 0).any()


def _ring_check(d, outs, n):
    import jax.numpy as jnp

    from flashinfer_tpu.parallel.ring_attention import (
        ring_attention,
        ulysses_attention,
    )

    mesh = _mesh1d("cp", n)
    q, k, v = (jnp.asarray(d[f"ring_{x}"]) for x in "qkv")
    for causal in (False, True):
        o, lse = _jit(lambda a, b, c: ring_attention(
            a, b, c, mesh, causal=causal, return_lse=True), q, k, v)
        np.testing.assert_allclose(_cat(outs, f"ring_o_{causal}"),
                                   np.asarray(o), **TOL)
        np.testing.assert_allclose(_cat(outs, f"ring_lse_{causal}"),
                                   np.asarray(lse), **TOL)
    want = _jit(lambda a, b, c: ulysses_attention(a, b, c, mesh,
                                                  causal=True),
                *(jnp.asarray(d[f"uly_{x}"]) for x in "qkv"))
    np.testing.assert_allclose(_cat(outs, "uly"), np.asarray(want), **TOL)


def test_ring_and_ulysses_at_cp4_match_jax(world4):
    _ring_check(*world4, 4)


def test_ring_and_ulysses_at_cp2_match_jax(world2):
    _ring_check(*world2, 2)


@pytest.mark.parametrize("routing", ["Default", "Renormalize"])
def test_fused_moe_ep_matches_jax(world4, routing):
    import jax.numpy as jnp

    from flashinfer_tpu.ops.fused_moe import RoutingMethodType
    from flashinfer_tpu.parallel import fused_moe_ep

    d, outs = world4
    want = _jit(lambda *a: fused_moe_ep(
        *a, _mesh1d("ep", 4), top_k=2,
        routing_method=getattr(RoutingMethodType, routing), capacity=64),
        *(jnp.asarray(d[k]) for k in ("ep_x", "ep_logits", "ep_w13",
                                      "ep_w2")))
    np.testing.assert_allclose(_cat(outs, f"ep_{routing}"), np.asarray(want),
                               **TOL)


def test_fused_moe_ep_capacity_drop_matches_jax(world4):
    import jax.numpy as jnp

    from flashinfer_tpu.parallel import fused_moe_ep

    d, outs = world4
    want = np.asarray(_jit(lambda *a: fused_moe_ep(
        *a, _mesh1d("ep", 4), top_k=1, capacity=2),
        *(jnp.asarray(d[k]) for k in ("drop_x", "drop_logits", "drop_w13",
                                      "drop_w2"))))
    got = _cat(outs, "ep_drop")
    kept = np.abs(got).sum(axis=1) > 0
    assert (kept == (np.abs(want).sum(axis=1) > 0)).all()
    assert kept.reshape(4, 4)[:, :2].all() and not kept.reshape(4, 4)[
        :, 2:].any()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("fp8", [False, True])
def test_fused_moe_tp_matches_jax(world4, fp8):
    import jax.numpy as jnp

    from flashinfer_tpu.parallel import fused_moe_tp

    d, outs = world4
    if fp8:
        w13, w2 = (jnp.asarray(d[k]) for k in ("tp_w13_e4m3", "tp_w2_e4m3"))
        s13 = s2 = jnp.full((4,), 0.1, jnp.float32)
    else:
        w13, w2 = (jnp.asarray(d[k], jnp.bfloat16)
                   for k in ("tp_w13", "tp_w2"))
        s13 = s2 = None
    want = _jit(lambda x, lg, a, b: fused_moe_tp(
        x, lg, a, b, _mesh1d("moe_tp", 4), top_k=2, w13_scale=s13,
        w2_scale=s2),
        jnp.asarray(d["tp_x"], jnp.bfloat16), jnp.asarray(d["tp_logits"]),
        w13, w2)
    for o in outs:  # replicated over moe_tp
        np.testing.assert_allclose(o[f"tp_{fp8}"],
                                   np.asarray(want, np.float32), rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.parametrize("fp8", [False, True])
def test_fused_moe_ep_x_moe_tp_matches_jax(world4, fp8):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from flashinfer_tpu.parallel import fused_moe_ep

    d, outs = world4
    if fp8:
        w13, w2 = (jnp.asarray(d[k]) for k in ("ept_w13_e4m3", "ept_w2_e4m3"))
        s13, s2 = jnp.asarray(d["ept_s13"]), jnp.asarray(d["ept_s2"])
    else:
        w13, w2 = jnp.asarray(d["ept_w13"]), jnp.asarray(d["ept_w2"])
        s13 = s2 = None
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("ep", "moe_tp"))
    want = np.asarray(_jit(lambda x, lg, a, b: fused_moe_ep(
        x, lg, a, b, mesh, top_k=2, capacity=32, tp_axis_name="moe_tp",
        w13_scale=s13, w2_scale=s2),
        jnp.asarray(d["ept_x"]), jnp.asarray(d["ept_logits"]), w13, w2))
    # ranks (e, t): e's tokens, equal over t
    got = np.concatenate([outs[0]["ept_" + str(fp8)],
                          outs[2]["ept_" + str(fp8)]])
    np.testing.assert_array_equal(outs[0][f"ept_{fp8}"],
                                  outs[1][f"ept_{fp8}"])
    tol = dict(rtol=2e-2, atol=2e-2) if fp8 else TOL  # JAX's tolerances
    np.testing.assert_allclose(got, want, **tol)


def test_pipeline_forward_matches_jax(world4):
    import jax.numpy as jnp

    from flashinfer_tpu.parallel import pipeline_forward

    d, outs = world4

    def stage(params, a):
        W, b = params
        return jnp.tanh(a @ W + b)

    want = _jit(lambda p, x: pipeline_forward(stage, p, x,
                                              _mesh1d("pp", 4)),
                (jnp.asarray(d["pp_W"]), jnp.asarray(d["pp_b"])),
                jnp.asarray(d["pp_x"]))
    for o in outs:  # every rank returns the last stage's outputs
        np.testing.assert_allclose(o["pipeline"], np.asarray(want), **TOL)


def test_llama_forward_pipelined_matches_jax(world4):
    """The 4-stage pipelined Llama (each rank given its stage's layers)
    against JAX's pipelined and dense forwards."""
    import jax.numpy as jnp

    from flashinfer_tpu.models.llama import llama_forward_dense
    from flashinfer_tpu.parallel import llama_forward_pipelined

    d, outs = world4
    cfg, _ = _jax_llama_params(_llama_cfg_args())
    params = {k[3:]: jnp.asarray(v) for k, v in d.items()
              if k.startswith("pl/")}
    tokens = jnp.asarray(d["pl_tokens"], jnp.int32)
    want = _jit(lambda p, t: llama_forward_pipelined(
        p, t, cfg, _mesh1d("pp", 4), num_microbatches=4), params, tokens)
    dense = _jit(lambda p, t: llama_forward_dense(p, t, cfg), params, tokens)
    for o in outs:
        np.testing.assert_allclose(o["pipelined"], np.asarray(want), **TOL)
        np.testing.assert_allclose(o["pipelined"], np.asarray(dense), **TOL)


def test_tp_decode_step_at_tp2_matches_jax_dense(world2):
    """The port's TP decode step at tp 2, token by token, against JAX's
    dense forward's last-token logits (JAX's own test of its TP step)."""
    import jax.numpy as jnp

    from flashinfer_tpu.models.llama import llama_forward_dense

    d, outs = world2
    cfg, _ = _jax_llama_params(None, tiny=True)
    params = {k[4:]: jnp.asarray(v) for k, v in d.items()
              if k.startswith("tps/")}
    want = np.asarray(llama_forward_dense(
        params, jnp.asarray(d["tps_prompts"], jnp.int32), cfg))[:, -1]
    got = np.concatenate([o["tp_logits"] for o in outs], axis=1)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
