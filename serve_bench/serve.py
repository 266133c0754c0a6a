"""One run of a cell: seeded weights, the port's serving engine, warm-up,
the measured window, and the records the metrics read.

The window drives ``LlamaServingEngine`` through its public surface only:
``add_request`` at each request's due time, then ``step()`` in a loop,
reading the counters the engine keeps (``plan_seconds``, ``decode_steps``,
``generated_tokens``, ``preemptions``, ``graphs.stats``) and its page
pool's free count.

The window runs on a clock that stands still while a traced run starts a
profiler session or stops and reads one, so the open loop's arrivals, the
tokens' times and the window's seconds leave that out.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from serve_bench import traffic as T
from serve_bench import weights as W
from serve_bench.model import ModelShape
from serve_bench.trace import Slice, Tracer, span


def log(msg: str) -> None:
    print(f"[serve_bench] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class StepRec:
    t0: float
    t1: float
    traced: bool
    admitted: int = 0  # requests whose first token came from this step
    prefill_rows: int = 0  # their prompt tokens
    prefill_pairs: float = 0.0  # their causal (query, key) pairs
    decode_rows: int = 0  # decode tokens emitted
    decode_keys: int = 0  # the keys those decodes attended
    prefill_replays: int = 0
    plan_s: float = 0.0  # the engine's planning seconds in this step
    decode_steps: int = 0  # the engine's decode steps in this step


@dataclasses.dataclass
class Run:
    """What a metric's ``read(run)`` sees."""
    model: ModelShape
    cell: dict
    setup_s: float
    window_s: float
    tokens: int  # output tokens emitted in the window
    ttft_s: List[float]  # one a request due in the window
    itl_s: List[float]  # every gap between two tokens of a request
    steps: List[StepRec]
    counters: Dict[str, float]  # the engine's counters over the window
    slices: List[Slice]
    traced_s: float = 0.0  # the window's seconds inside traced slices
    kv_pages_peak: int = 0  # most KV pages in use after a window step


class _Track:
    """A request's progress, as the host sees it."""
    __slots__ = ("gen", "due", "n", "last", "first")

    def __init__(self, gen, due: float):
        self.gen, self.due = gen, due
        self.n, self.last, self.first = 0, None, None


def ttft_samples(tracks, end: float) -> List[float]:
    """Time to first token of each request, from its due time; one still
    waiting at ``end`` enters with its wait so far."""
    return [(tr.first if tr.first is not None else end) - tr.due
            for tr in tracks]


def _kinds(eng) -> Dict[str, int]:
    return {k: int(v["captures"]) for k, v in eng.graphs.stats.items()}


def _key_summary(key) -> str:
    kind, meta = (key if isinstance(key, tuple) and isinstance(key[0], str)
                  else ("step", key))
    fields = ("nnz", "bucket_rows", "num_work_items", "max_splits")
    return f"{kind} " + " ".join(f"{f}={getattr(meta, f, '?')}"
                                 for f in fields)


def _captures(eng) -> int:
    return int(sum(v["captures"] for v in eng.graphs.stats.values()))


def _counters(eng) -> Dict[str, float]:
    return dict(plan_seconds=eng.plan_seconds, decode_steps=eng.decode_steps,
                preemptions=eng.preemptions, captures=_captures(eng))


def build_engine(m: ModelShape, cell: dict, params: dict, seed: int,
                 device: torch.device, overrides: Optional[dict] = None):
    from flashinfer_tpu_torch.models.llama import LlamaConfig
    from flashinfer_tpu_torch.serving.engine import (
        EngineConfig,
        LlamaServingEngine,
    )

    lc = LlamaConfig(vocab_size=m.vocab, hidden_size=m.hidden,
                     intermediate_size=m.intermediate, num_layers=m.layers,
                     num_qo_heads=m.q_heads, num_kv_heads=m.kv_heads,
                     head_dim=m.head_dim, rope_theta=m.rope_theta,
                     rms_eps=m.rms_eps, dtype=torch.bfloat16)
    ec = EngineConfig(model=lc, device=str(device),
                      **{**cell["engine"], **(overrides or {})})
    return LlamaServingEngine(ec, params=params, seed=seed)


def quantize_for_control(m: ModelShape, params: dict) -> dict:
    """The program's own e4m3 weights (one scale an output channel), made a
    tensor at a time with its quantizer, the fused projection split into
    the q, k, v weights the quantizer names."""
    from flashinfer_tpu_torch.models.llama import quantize_llama_weights_fp8

    qd, kd = m.q_heads * m.head_dim, m.kv_heads * m.head_dim
    wqkv = params.pop("wqkv")
    for name, cols in (("wq", slice(0, qd)), ("wk", slice(qd, qd + kd)),
                       ("wv", slice(qd + kd, qd + 2 * kd))):
        params[name] = wqkv[..., cols].contiguous()
    del wqkv
    for name in ("wq", "wk", "wv", "wo", "w_gate_up", "w_down", "lm_head"):
        params.update(quantize_llama_weights_fp8({name: params.pop(name)}))
    return params


def _groups(items, cap: int, key=lambda x: x) -> List[list]:
    """Consecutive items in groups whose ``key`` sums stay within ``cap``
    (an item over it alone)."""
    out, total = [[]], 0
    for it in items:
        if out[-1] and total + key(it) > cap:
            out.append([])
            total = 0
        out[-1].append(it)
        total += key(it)
    return out


class Session:
    """One cell's engine through set-up, warm-up and one window."""

    def __init__(self, reg, name: str, seed: int, device: torch.device,
                 trace: bool, t_start: float,
                 overrides: Optional[dict] = None,
                 hook: Optional[Callable] = None, out_dir: Path = None,
                 order_seed: Optional[int] = None):
        self.seed = seed
        w = reg.workload(name)
        self.cell = reg.cell(name)
        self.bench_dir = reg.bench_dir
        self.mix = reg.traffic(w["traffic"])
        if order_seed is not None:  # another order of the same mix
            self.mix = dict(self.mix, order_seed=order_seed)
        self.m = ModelShape.from_config(reg.config(w["config"]))
        self.device, self.trace, self.t_start = device, trace, t_start
        self.tracks: Dict[int, _Track] = {}
        self.failed = 0
        params = W.fill_params(self.m, seed, device)
        if overrides and overrides.get("weight_dtype") == "fp8_e4m3":
            params = quantize_for_control(self.m, params)
            # hand the freed bf16 blocks back: the graphs' capture runs on
            # a side stream and its private pool, which cannot reuse them
            gc.collect()
            torch.cuda.empty_cache()
        log(f"weights made at {time.perf_counter() - t_start:.1f} s")
        self.eng = build_engine(self.m, self.cell, params, seed, device,
                                overrides)
        del params
        if hook is not None:
            hook(self.eng)
        self.tracer = Tracer(out_dir) if trace else None
        self.window = False
        self.t0 = 0.0
        self.paused = 0.0  # seconds the window's clock stood still
        self._reset()

    def _now(self) -> float:
        return time.perf_counter() - self.paused

    def _reset(self) -> None:
        self.tokens = 0
        self.traced_s = 0.0
        self.slice_t0 = 0.0
        self.kv_pages_peak = 0
        self.ttft_pending: List[_Track] = []
        self.itl: List[float] = []
        self.steps: List[StepRec] = []
        self.finished = []

    # ---------------------------------------------------------- requests

    def _add(self, spec: T.Request, due: float, measured: bool) -> None:
        try:
            gen = self.eng.add_request(spec.prompt.tolist(),
                                       spec.max_new_tokens)
        except ValueError as e:
            log(f"request refused: {e}")
            self.failed += measured
            return
        tr = _Track(gen, due)
        self.tracks[gen.request_id] = tr
        if measured:
            self.ttft_pending.append(tr)

    def _step(self, k: int) -> None:
        eng, tracer = self.eng, self.tracer
        if tracer is not None and self.window:
            h = time.perf_counter()
            if tracer.before(k):
                self.paused += time.perf_counter() - h
                self.slice_t0 = self._now()
        traced = tracer is not None and tracer.active
        pre = eng.graphs.stats.get("prefill", {}).get("replays", 0)
        cap = _captures(eng)
        plan, dec = eng.plan_seconds, eng.decode_steps
        t0 = self._now()
        with span("step", self.trace):
            out = eng.step()
        t1 = self._now()
        with span("bookkeeping", self.trace):
            rec = StepRec(t0, t1, traced)
            rec.prefill_replays = eng.graphs.stats.get("prefill", {}).get(
                "replays", 0) - pre
            rec.plan_s = eng.plan_seconds - plan
            rec.decode_steps = eng.decode_steps - dec
            for rid, _ in out:
                tr = self.tracks[rid]
                j, tr.n = tr.n, tr.n + 1
                plen = len(tr.gen.prompt)
                if j == 0:
                    tr.first = t1
                    rec.admitted += 1
                    rec.prefill_rows += plen
                    rec.prefill_pairs += plen * (plen + 1) / 2
                else:
                    rec.decode_rows += 1
                    rec.decode_keys += plen + j
                    if self.window:
                        self.itl.append(t1 - tr.last)
                tr.last = t1
                if self.window and tr.gen.done and tr.n == len(tr.gen.output):
                    self.finished.append(tr.gen)
            if _captures(eng) > cap and self.window:
                log(f"capture in the window at step {k}: "
                    f"{_kinds(eng)} after the step, last key "
                    f"{_key_summary(eng.graphs.last_key)}")
            if not eng.graphs.enabled:  # eager: no replay to count
                rec.prefill_replays = int(rec.admitted > 0)
            if self.window:
                self.tokens += len(out)
                self.steps.append(rec)
                self.kv_pages_peak = max(
                    self.kv_pages_peak,
                    eng.cfg.num_pages - eng.pool.free_pages)
        if tracer is not None and self.window:
            h, end = time.perf_counter(), self._now()
            if tracer.after(k):
                self.traced_s += end - self.slice_t0
                self.paused += time.perf_counter() - h

    def _loop(self, arrivals: List[T.Request], t0: float, t_end: float,
              measured: bool, stop: Optional[Callable[[float], bool]] = None
              ) -> float:
        """Serve until ``t_end`` (or ``stop(now)``): requests added at their
        due times from ``t0`` on, ``step()`` whenever there is work. Returns
        the time the last step or wait ended."""
        i, k, last = 0, 0, t0
        while True:
            now = self._now()
            if now >= t_end or (stop is not None and stop(now)):
                return max(last, min(now, t_end))
            with span("add_request", self.trace):
                while i < len(arrivals) and t0 + arrivals[i].due_s <= now:
                    self._add(arrivals[i], t0 + arrivals[i].due_s, measured)
                    i += 1
            if not self.eng.has_work():
                nxt = t0 + arrivals[i].due_s if i < len(arrivals) else t_end
                with span("idle", self.trace):
                    time.sleep(max(0.0, min(nxt, t_end) - now))
                last = self._now()
                continue
            self._step(k)
            k += 1
            last = self._now()

    # ----------------------------------------------------------- warm-up

    def _sweep_prefill(self) -> None:
        """Prefill every power-of-two bucket of rows up to the cell's
        ``prefill_rows_max``, each with a longest prompt of every power of
        two up to the mix's longest and the longest itself, so that each
        prefill shape the traffic can send is met before the window."""
        eng, mix, warm = self.eng, self.mix, self.cell["warmup"]
        slots = eng.cfg.max_batch
        lo, hi = mix["prompt"]["min"], mix["prompt"]["max"]
        rng = np.random.default_rng(T.derived_seed(self.seed, "sweep"))
        lengths = sorted({1 << p for p in range(max(lo - 1, 1).bit_length(),
                                                hi.bit_length())} | {hi})
        b = 1 << max(lo - 1, 1).bit_length()
        while b <= warm["prefill_rows_max"]:
            for longest in (x for x in lengths if x <= b):
                n = -(-b // longest)
                if n > slots:
                    continue
                lens = [longest] * (n - 1) + [b - longest * (n - 1)]
                for ln in lens:
                    eng.add_request(rng.integers(0, self.m.vocab, ln).tolist(),
                                    1)
                while eng.has_work():
                    eng.step()
            b *= 2

    def reseed(self, seed: int) -> None:
        """Serve what is left to its end, then draw the next seed's weights
        into the engine's own tensors (its graphs keep reading them)."""
        while self.eng.has_work():
            self.eng.step()
        self.tracks.clear()
        self.seed = seed
        W.fill_params(self.m, seed, self.device, params=self.eng.params)

    def _sweep_decode(self) -> None:
        """Decode once over a batch of every (work-item, split) class the
        cell's traffic can reach: for each longest context of 1, 2, 4, ...
        key chunks (``decode_chunk`` tokens) and each power-of-two count of
        the batch's chunks up to ``decode_items_max``, one long request and
        as many short ones as that count needs, each just past a chunk
        edge so that its prefill is short. The requests are added a
        ``prefill_rows_max`` group a step and leave soon after."""
        eng, warm = self.eng, self.cell["warmup"]
        chunk, items_max = warm["decode_chunk"], warm["decode_items_max"]
        cap, slots = warm["prefill_rows_max"], eng.cfg.max_batch
        longest = self.mix["prompt"]["max"] + self.mix["output"]["max"]
        rng = np.random.default_rng(T.derived_seed(self.seed, "decode"))
        s = 1
        while (s // 2) * chunk < longest:
            c = 8
            while c <= items_max:
                need = max(c // 2 + 1, 1) - s  # chunks the others hold
                q = max(1, -(-need // (slots - 1)))
                n = max(0, -(-need // q))
                if q <= s and s + n * q <= c and (c == 8 or s + n * q > c // 2):
                    lens = [(s - 1) * chunk + 16] + [(q - 1) * chunk + 16] * n
                    groups = _groups(lens, cap)
                    for g in groups:
                        for ln in g:
                            eng.add_request(
                                rng.integers(0, self.m.vocab, ln).tolist(),
                                len(groups) + 2)
                        eng.step()
                    while eng.has_work():
                        eng.step()
                c *= 2
            s *= 2

    def warm_up(self, shapes: bool = True) -> None:
        """Meet the shapes the cell's traffic sends (``shapes``), then serve
        the cell's own traffic from a seed derived from the run's until no
        graph was captured for ``quiet_s`` (``min_s`` .. ``max_s``)."""
        warm, eng = self.cell["warmup"], self.eng
        if self.mix["arrivals"] == "closed":
            self._admit_sessions()
        elif shapes:
            self._sweep_prefill()
            if "decode_chunk" in warm:
                self._sweep_decode()
        log(f"prefill shapes met at {time.perf_counter() - self.t_start:.1f}"
            f" s, {_captures(eng)} captures")
        rate = self.cell.get("rate_per_s", 0.0)
        arrivals = [] if self.mix["arrivals"] == "closed" else \
            T.make_requests(self.mix, T.derived_seed(self.seed, "warmup"),
                            warm["max_s"], rate, self.m.vocab,
                            eng.cfg.max_seq_len, phase="warmup",
                            bench_dir=self.bench_dir)
        state = dict(n=_captures(eng), at=self._now())
        t = self._now()

        def settled(now: float) -> bool:
            n = _captures(eng)
            if n != state["n"]:
                state.update(n=n, at=now)
            return (now - t >= warm["min_s"]
                    and now - state["at"] >= warm["quiet_s"])

        self._loop(arrivals, t, t + warm["max_s"], False, settled)
        if self.tracer is not None:
            self.tracer.warm(lambda: torch.zeros(1, device=self.device))
        log(f"warm at {time.perf_counter() - self.t_start:.1f} s: "
            f"{_kinds(eng)} captures, {eng.num_running} running; capture s "
            + str({k: round(v["capture_s"], 3)
                   for k, v in eng.graphs.stats.items()}))

    def _admit_sessions(self) -> None:
        """A closed batch: every session added and prefilled during set-up,
        a group an admission so that no prefill passes
        ``prefill_rows_max`` rows."""
        self.sessions = T.make_requests(self.mix, self.seed, 0.0, 0.0,
                                        self.m.vocab, self.eng.cfg.max_seq_len,
                                        bench_dir=self.bench_dir)
        for g in _groups(range(len(self.sessions)),
                         self.cell["warmup"]["prefill_rows_max"],
                         key=lambda i: len(self.sessions[i].prompt)):
            for i in g:
                self._add(self.sessions[i], 0.0, False)
            self._step(0)

    # ------------------------------------------------------------ window

    def measure(self, seconds: float) -> Run:
        eng = self.eng
        arrivals = [] if self.mix["arrivals"] == "closed" else \
            T.make_requests(self.mix, self.seed, seconds,
                            self.cell["rate_per_s"], self.m.vocab,
                            eng.cfg.max_seq_len, bench_dir=self.bench_dir)
        self._reset()
        before = _counters(eng)
        self.window = True
        self.t0 = self._now()
        setup_s = self.t0 - self.t_start + self.paused
        end = self._loop(arrivals, self.t0, self.t0 + seconds, True)
        self.window = False
        after = _counters(eng)
        if self.tracer is not None:
            if self.tracer.active:
                self.traced_s += end - self.slice_t0
            self.tracer.close()
        ttft = ttft_samples(self.ttft_pending, end)
        return Run(model=self.m, cell=self.cell, setup_s=setup_s,
                   window_s=end - self.t0, tokens=self.tokens, ttft_s=ttft,
                   itl_s=self.itl, steps=self.steps,
                   counters={k: after[k] - before[k] for k in after},
                   slices=self.tracer.slices if self.tracer else [],
                   traced_s=self.traced_s, kv_pages_peak=self.kv_pages_peak)

    def attempted(self) -> int:
        if self.mix["arrivals"] == "closed":
            return len(self.sessions)
        return len(self.ttft_pending) + self.failed

    def served(self):
        """The requests the window finished, or, for a closed batch, every
        session with its tokens so far."""
        if self.mix["arrivals"] == "closed":
            return [tr.gen for tr in self.tracks.values()]
        return self.finished

    def free(self) -> None:
        """Drop the engine and its memory (before the reference runs)."""
        self.eng = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
