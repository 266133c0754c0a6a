"""The cuBLAS GEMMs' share of their roofline in the traced slices: for
each replay, the larger of the live rows' operations at the bf16 peak and
the weights read once at the HBM peak, over the ``matmul`` family's device
time. Padded rows are not work, so padding shows as a lower share."""

from serve_bench.model import bound_s


def read(run):
    m = run.model
    need = 0.0
    for s in run.steps:
        if not s.traced:
            continue
        if s.prefill_rows:
            need += bound_s(m.matmul_flops(s.prefill_rows, s.admitted),
                            m.weight_bytes())
        if s.decode_rows:
            need += bound_s(m.matmul_flops(s.decode_rows, s.decode_rows),
                            m.weight_bytes())
    took = sum(sl.by_family.get("matmul", 0.0) for sl in run.slices)
    return 100.0 * need / took if need > 0 and took > 0 else None
