#!/usr/bin/env python3
"""Time the paged-attention kernel of several checkouts in turns on one card.

    python3 tools/paged_ab.py DIR [DIR ...] [--out FILE]

Each DIR is the root of a checkout (``git archive`` of a commit unpacked
into a gitignored directory, say). For each DIR, in the order given (name
one twice for parent / change / change / parent), a fresh process imports
that checkout's ``flashinfer_tpu_torch`` and times its
``batch_paged_attention_run`` on the cases of this checkout's
``chip_smoke.check_paged_attention`` that every version takes (head_dim
128): the Llama-3-8B engine's decode and prefill plans (NHD and HND) and
POD's combined plan (HND), each on bf16, e4m3 and int8 caches rotated over
``LAYERS_ROTATED`` layers, 20 calls in one CUDA graph. A version whose
wrapper takes the plan's ``row_valid`` gets it, as ``run_device_plan``
passes it. Prints the card, then a line per case with each run's ms and
the first run's bound (``tools/ab.py``); exits 1 if a run fails.
"""

from __future__ import annotations

import inspect
import json
import os
import sys

import ab


def child() -> None:
    """One run, from the root of the checkout under test."""
    import numpy as np
    import torch

    cs = ab.chip_smoke()
    from flashinfer_tpu_torch.ops.attention.kernels.paged import (
        batch_paged_attention_run as run,
    )
    from flashinfer_tpu_torch.utils import TensorLayout

    takes_valid = "row_valid" in inspect.signature(run).parameters
    hq, hkv, d, ps = 32, 8, 128, 16
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 513, 12)
    plans = cs._engine_like_plans(np, [int(n) + 16 for n in lens[:7]] + [540],
                                  [int(n) for n in lens[:8]])
    cases = [(mode, plan, ("NHD", "HND")) for mode, plan in plans.items()]
    cases.append(("pod_combined", cs._pod_combined_case(np), ("HND",)))
    rows = []
    for mode, (dp, pages, kv_lens, qo_lens), layouts in cases:
        m = dp.meta
        # run_device_plan's packing: row = token * group + head in group,
        # padding rows 0
        x = torch.randn(m.nnz, hq, d, device=dev, generator=gen,
                        dtype=torch.bfloat16)
        x = (x.reshape(m.nnz, hkv, hq // hkv, d).permute(1, 0, 2, 3)
             .reshape(hkv, -1, d))
        valid = dp.segment("row_valid") != 0
        q = torch.where(valid[None, :, None],
                        x[:, dp.segment("row_src").long()], 0)
        for layout in layouts:
            shape = ((cs.LAYERS_ROTATED * pages, hkv, ps, d) if layout == "HND"
                     else (cs.LAYERS_ROTATED * pages, ps, hkv, d))
            for kv in ("bf16", "e4m3", "int8"):
                kc, vc = (torch.randn(shape, device=dev, generator=gen,
                                      dtype=torch.bfloat16) for _ in "kv")
                if kv == "int8":
                    kc, vc = ((x * 25).round().clamp(-127, 127).to(torch.int8)
                              for x in (kc, vc))
                elif kv == "e4m3":
                    kc, vc = ((x * 4).to(torch.float8_e4m3fn)
                              for x in (kc, vc))
                kw = dict(tile_q=m.tile_q, group=hq // hkv, causal=m.causal,
                          sm_scale=m.sm_scale, kv_layout=TensorLayout[layout])
                if takes_valid:
                    kw["row_valid"] = dp.segment("row_valid")
                layer = [0]

                def call():
                    off = (layer[0] % cs.LAYERS_ROTATED) * pages
                    layer[0] += 1
                    return run(q, kc, vc, dp.segment("kv_indices"),
                               dp.segment("plan"), kv_indices_offset=off, **kw)

                ms = cs.cuda_ms(torch, call, 20, graph=True)
                nbytes = cs._attention_bytes(dp.segment("plan"), pages,
                                             kv_lens, m.tile_q, hkv, d,
                                             kc.element_size())
                ops = 4 * d * cs._attention_work(kv_lens, qo_lens, hq)
                b_ms, b_by = cs.bound_ms(nbytes, ops)
                rows.append(dict(case=f"{mode} {layout} {kv}", ms=ms,
                                 bound_ms=b_ms, bound_by=b_by))
                del kc, vc
        torch.cuda.empty_cache()
    print("ROWS " + json.dumps(rows), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--child"]:
        child()
    else:
        args = ab.parse_args(__doc__)
        sys.exit(ab.run(args.dirs, [os.path.abspath(__file__), "--child"],
                        args.out))
