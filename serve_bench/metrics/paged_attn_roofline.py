"""The paged-attention kernels' share of their roofline in the traced
slices: the least time the live requests' attention needs (each cached K/V
byte once, q read and o written once, or the causal operations at the bf16
peak, the larger, a replay at a time) over the device time of the
``paged_attention`` family. The split merge runs as plain PyTorch ops,
which the trace cannot tell from other glue, so it is not in the time."""

from serve_bench.model import bound_s


def read(run):
    m = run.model
    need = 0.0
    for s in run.steps:
        if not s.traced:
            continue
        if s.prefill_rows:
            need += bound_s(m.attn_flops(s.prefill_pairs),
                            m.kv_bytes(s.prefill_rows)
                            + m.qo_bytes(s.prefill_rows))
        if s.decode_rows:
            need += bound_s(m.attn_flops(s.decode_keys),
                            m.kv_bytes(s.decode_keys)
                            + m.qo_bytes(s.decode_rows))
    took = sum(sl.by_family.get("paged_attention", 0.0) for sl in run.slices)
    return 100.0 * need / took if need > 0 and took > 0 else None
