"""The whole step's share of the chip's bf16 peak over the window: the
useful operations of every step (the projections, MLPs and head of the
live prefill and decode rows, attention over their live contexts) over
the window's seconds at 989 TFLOP/s. Steps inside traced slices, and the
slices' seconds, are left out: the profiler slows the host there."""

from serve_bench.model import PEAK_BF16_FLOPS


def read(run):
    m = run.model
    flops = sum(m.matmul_flops(s.prefill_rows + s.decode_rows,
                               s.admitted + s.decode_rows)
                + m.attn_flops(s.prefill_pairs + s.decode_keys)
                for s in run.steps if not s.traced)
    seconds = run.window_s - run.traced_s
    if flops <= 0 or seconds <= 0:
        return None
    return 100.0 * flops / (seconds * PEAK_BF16_FLOPS)
