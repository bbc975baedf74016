"""The serving runner (traffic kinds "open_loop" and "closed_loop"): the
port's ContinuousBatcher over the configuration's model, fed by
`submit` and read from the request handles.

Set-up builds the model (configs/<config>.py), loads the seed's weights,
starts the batcher with the configuration's `serving` settings, and
warms it: one request a slot at once, each two prefill chunks long, so
that every slot's chunk graph and the decode graph are captured before
the window. Open loop: each request is sent when it is due, whether or
not earlier ones have finished, and its time to first token is taken
from when it was due. Closed loop: `clients_per_slot` x slots clients
each send their next request when their last one finished. After the
window every request already sent is waited for (at most
`drain_seconds`); a closed loop's still-queued ones are cancelled first.
Then a sample of the finished requests, drawn from the seed and holding
the longest, is checked against the reference's logits.

With --trace 1 the program's spans are recorded over the window, with no
profiler open, and torch.profiler traces a slice of the same traffic
after it: once the window's requests have finished, the profiler is
started (which takes seconds and turns CUPTI on, slowing every launch),
the traffic resumes and settles for `trace_settle_seconds`, and
`trace_seconds` are marked. The requests of that stretch are not judged.
"""
from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from benchmark import judge
from benchmark import traffic as gen
from benchmark.observe import Observations, Outcome, RequestRecord
from benchmark.readers import decode_iter_ms
from benchmark.stats import percentile
from benchmark.trace import PAD_S, Slice


# seconds of open-loop requests made for the traced stretch after the
# window (its settling and its slice)
AFTER_S = 60.0
# the quantiles of the tails a run's notes keep
TAIL_Q = (50, 75, 90, 95, 97.5, 99)


class _Steps:
    """Steps taken, each once its time has come, from the traffic loop's
    own checks of `stop()` (no thread of its own: kineto wants the thread
    that started the profiler); holds once every step was taken."""

    def __init__(self, steps):
        self.steps = list(steps)

    def __call__(self) -> bool:
        now = time.monotonic()
        while self.steps and self.steps[0][0] <= now:
            self.steps.pop(0)[1]()
        return not self.steps


def _record(h, due: float) -> RequestRecord:
    return RequestRecord(rid=h.id, prompt=h.prompt, max_new=h.max_new_tokens,
                         due=due)


def _fill(rec: RequestRecord, h) -> None:
    rec.first = h.t_first_token
    rec.token_times = list(h.token_times)
    rec.tokens = list(h.tokens)
    rec.queue_wait_s = h.queue_wait_s
    if h.error is not None:
        rec.error = f"{type(h.error).__name__}: {h.error}"


def build(cell, seed: int, device: str):
    """The model with the seed's weights, its started batcher, and the
    seconds each took."""
    from flexflow_tpu_torch.serving.sched import ContinuousBatcher

    cfg = cell.config
    sv = cfg["serving"]
    t = [time.monotonic()]
    model = cell.model_file().build_serve(cfg, device)
    t.append(time.monotonic())
    model.load_params(cell.reference().make_weights(cfg, seed, device))
    t.append(time.monotonic())
    batcher = ContinuousBatcher(
        model, max_len=sv["max_len"], num_slots=sv["num_slots"],
        page_size=sv["page_size"],
        prefill_chunk_tokens=sv["prefill_chunk_tokens"],
        prefix_cache_pages=None if sv["prefix_cache"] else 0,
        max_queue=sv["max_queue"], temperature=sv["temperature"])
    batcher.start()
    t.append(time.monotonic())
    return model, batcher, dict(zip(
        ("setup_build_s", "setup_weights_s", "setup_batcher_s"),
        np.diff(t).tolist()))


def warm(batcher, vocab: int) -> dict:
    """One request a slot, all sent at once, each two prefill chunks
    long and 16 tokens out, so that each holds its slot while the others
    are admitted: every slot's chunk graph, the decode graph and the
    prefix cache's insert run before the window (again, up to twice, if a
    slot was missed). Returns the graph counts after it."""
    length = batcher.prefill_chunk_tokens + 1
    prompts = gen.warmup_prompts(batcher.num_slots, length, vocab)
    for _ in range(3):
        handles = [batcher.submit(p, 16) for p in prompts]
        for h in handles:
            h.result(timeout=600.0)
        graphs = dict(batcher.stats()["graphs"])
        if graphs["captures"] >= batcher.num_slots + 1:
            break
    return graphs


def _open_loop(batcher, requests, t0: float, stop, records: list,
               handles: list) -> dict:
    """Sends each request when it is due until `stop()` holds, whether or
    not earlier ones have finished; a request turned away is recorded
    with its error. Returns the latest send behind its due time."""
    from flexflow_tpu_torch.serving.sched import AdmissionError

    late = 0.0
    for r in requests:
        due = t0 + r.due
        while not stop() and time.monotonic() < due:
            time.sleep(min(0.05, max(0.0, due - time.monotonic())))
        if stop():
            break
        late = max(late, time.monotonic() - due)
        try:
            h = batcher.submit(r.prompt, r.max_new)
        except AdmissionError as e:
            records.append(RequestRecord(-1, r.prompt, r.max_new, due,
                                         error=f"refused: {e}"))
            continue
        records.append(_record(h, due))
        handles.append((records[-1], h))
    while not stop():
        time.sleep(0.01)
    return {"late_max_s": late}


class _Clients:
    """A closed loop: `clients` clients each send their next request
    when their last one finished; a send the full queue turns away is
    sent again 2 ms later (the clients' start, when all of them send at
    once)."""

    def __init__(self, batcher, requests, clients: int):
        self.batcher, self.it = batcher, iter(requests)
        self.records, self.handles, self.retries = [], [], 0
        self.n, self.spent = clients, False
        self.active = [self._send() for _ in range(clients)]

    def _send(self):
        """The next request of the pool, sent; None once it is spent."""
        from flexflow_tpu_torch.serving.sched import QueueFull

        r = next(self.it, None)
        if r is None:
            self.spent = True
            return None
        while True:
            try:
                h = self.batcher.submit(r.prompt, r.max_new)
                break
            except QueueFull:
                self.retries += 1
                time.sleep(0.002)
        self.records.append(_record(h, time.monotonic()))
        return self.records[-1], h

    def run(self, stop) -> None:
        while not stop():
            for j, sent in enumerate(self.active):
                if sent is not None and sent[1].done():
                    self.handles.append(sent)
                    self.active[j] = self._send()
            time.sleep(0.002)

    def close(self) -> int:
        """Cancels the requests still queued (they leave the records) and
        keeps those in a slot; returns how many were cancelled."""
        cancelled = 0
        for rec, h in filter(None, self.active):
            if self.batcher.cancel(h):
                cancelled += 1
                self.records.remove(rec)
            else:
                self.handles.append((rec, h))
        self.active = []
        return cancelled


def _traced_stretch(batcher, cell, seed: int, vocab: int, seconds: float,
                    clients, tracer, problems: list):
    """--trace 1, once every request of the window has finished and the
    batcher idles: torch.profiler starts (which takes seconds; it starts
    on an idle card, as a set-up would, since starting it while the
    batcher launches has hung), the same traffic resumes for
    `trace_settle_seconds`, PAD_S, the marked slice of `trace_seconds`
    (also a `bench.slice` span of the program's tracer) and PAD_S; then
    the stretch's requests are cancelled or waited for and the profiler
    is stopped. Returns the slice and notes."""
    mix = cell.traffic
    sl = Slice()
    sl.open()
    mark = tracer.span("bench.slice")

    def begin():
        mark.__enter__()
        sl.begin()

    def end():
        sl.end()
        mark.__exit__(None, None, None)

    t = time.monotonic()
    settle = t + float(mix["trace_settle_seconds"])
    length = float(mix["trace_seconds"])
    stop = _Steps([(settle, sl.record), (settle + PAD_S, begin),
                   (settle + PAD_S + length, end),
                   (settle + 2 * PAD_S + length, lambda: None)])
    handles, notes = [], {}
    if clients is None:
        later = [r for r in gen.open_loop(mix, vocab, seed, seconds + AFTER_S)
                 if r.due >= seconds]
        notes = _open_loop(batcher, later, t - seconds, stop, [], handles)
    else:
        more = _Clients(batcher, clients.it, clients.n)
        more.run(stop)
        more.close()
        handles = more.handles
    for _, h in handles:
        if batcher.cancel(h):
            continue
        try:
            h.result(timeout=float(mix["drain_seconds"]))
        except Exception as e:  # noqa: BLE001 - recorded, judged below
            problems.append(f"traced-stretch request {h.id} failed: {e!r}")
    sl.close()
    notes["requests"] = len(handles)
    return sl, {f"traced_stretch_{k}": v for k, v in notes.items()}


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float = None) -> Outcome:
    from flexflow_tpu_torch.obs.tracing import get_tracer

    t_start = time.monotonic() if t_start is None else t_start
    cfg, mix = cell.config, cell.traffic
    ref = cell.reference()
    dims = ref.dims(cfg)
    model, batcher, notes = build(cell, seed, device)
    problems, prof = [], None
    try:
        t = time.monotonic()
        graphs = warm(batcher, dims["vocab"])
        notes["setup_warm_s"] = time.monotonic() - t
        notes["num_slots"] = batcher.num_slots
        obs = Observations(cfg, mix, dims, seed, seconds)
        clients = None
        if mix["kind"] == "open_loop":
            requests = gen.open_loop(mix, dims["vocab"], seed, seconds)
        else:
            requests = gen.closed_loop(mix, dims["vocab"], seed)
        tracer = get_tracer()
        if trace:
            tracer.clear()
            tracer.enable()
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.monotonic()
        obs.setup_s = t0 - t_start

        def window_over() -> bool:
            return time.monotonic() - t0 >= seconds

        with tracer.span("bench.window"):
            if mix["kind"] == "open_loop":
                records, handles = [], []
                extra = _open_loop(batcher, requests, t0, window_over,
                                   records, handles)
                extra = {"generator_late_max_s": extra["late_max_s"]}
            else:
                clients = _Clients(batcher, requests, math.ceil(
                    float(mix["clients_per_slot"]) * batcher.num_slots))
                clients.run(window_over)
                records, handles = clients.records, clients.handles
                extra = {"clients": len(clients.active),
                         "queue_full_retries": clients.retries,
                         "pool_spent_in_window": clients.spent}
        obs.window = (t0, t0 + seconds)
        if clients is not None:
            extra["cancelled_at_close"] = clients.close()
        notes.update(extra)
        deadline = t0 + seconds + float(mix["drain_seconds"])
        for rec, h in handles:
            try:
                h.result(timeout=max(0.0, deadline - time.monotonic()))
            except TimeoutError:
                problems.append(f"request {h.id} did not finish within "
                                f"{mix['drain_seconds']} s of the close")
            except Exception as e:  # noqa: BLE001 - recorded, judged below
                problems.append(f"request {h.id} failed: {e!r}")
            _fill(rec, h)
        if trace:
            prof, more = _traced_stretch(batcher, cell, seed, dims["vocab"],
                                         seconds, clients, tracer, problems)
            notes.update(more)
            tracer.disable()
            notes["tracer_dropped_events"] = tracer.dropped_events
            events = tracer.events()
            obs.spans = _spans_in(events, "bench.window")
            profiled = _spans_in(events, "bench.slice")
            notes["decode_iter_ms_profiled"] = decode_iter_ms(
                Observations(cfg, mix, dims, seed, seconds, spans=profiled))
            notes["decode_iter_ms_unprofiled"] = decode_iter_ms(obs)
        now = batcher.stats()["graphs"]
        notes["captures_in_window"] = now["captures"] - graphs["captures"]
        if prof is not None:
            notes.update({f"profiler_{k}_s": v
                          for k, v in prof.seconds.items()})
        info = {"platform": "gpu" if device == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                         else "cpu"),
                "count": cell.chips,
                "memory_peak_bytes": (int(torch.cuda.max_memory_allocated())
                                      if device == "cuda" else 0)}
    finally:
        batcher.stop()
    obs.requests = records
    obs.device = prof.result() if prof is not None else None
    notes["tail_quantiles_ms"] = _tails(records)
    for rec in records:
        if rec.error is None and not rec.finished:
            problems.append(f"request {rec.rid} gave {len(rec.tokens)} of "
                            f"{rec.max_new} tokens")
    del batcher, model
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    checked = sample([r for r in records if r.finished], seed,
                     int(mix["check_requests"]))
    gap = logit_gaps(cell, seed, device, checked)
    notes.update(logit_gap=gap, checked_requests=len(checked),
                 checked_tokens=sum(len(r.tokens) for r in checked))
    if not checked:
        problems.append("no finished request to check")
    failed = sum(1 for r in records if r.error is not None)
    return Outcome(obs, judge.checks({"logit_gap": gap}, cell.limits),
                   problems, attempted=len(records), failed=failed,
                   device=info, notes=notes)


def _tails(records) -> dict:
    """Quantiles of the window's times to first token and of the gaps
    between tokens, in ms (where the tail metrics sit in their
    distributions)."""
    done = [r for r in records if r.finished]
    samples = {"ttft": [r.first - r.due for r in done],
               "itl": [b - a for r in done
                       for a, b in zip(r.token_times, r.token_times[1:])]}
    return {k: {str(q): 1e3 * percentile(v, q) for q in TAIL_Q}
            for k, v in samples.items() if v}


def _spans_in(events, marker: str) -> list:
    """The complete spans that started inside the span named `marker`."""
    mark = next(e for e in events if e["name"] == marker)
    lo, hi = mark["ts"], mark["ts"] + mark["dur"]
    return [e for e in events if e.get("ph") == "X" and e is not mark
            and lo <= e["ts"] < hi]


def sample(finished, seed: int, n: int):
    """n finished requests drawn from the seed, the longest among them."""
    if not finished:
        return []
    longest = max(finished, key=lambda r: r.prompt_len + len(r.tokens))
    rest = [r for r in finished if r is not longest]
    rng = gen.rng_for(seed, 4)
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def logit_gaps(cell, seed: int, device: str, sample,
               control: bool = False):
    """The widest gap of a served token's reference logit below the
    reference's best at its position; with `control`, also that of the
    token the reference computed on fp8 operands puts first there."""
    ref = cell.reference()
    w = ref.make_weights(cell.config, seed, device)
    worst, worst_ctrl = 0.0, 0.0
    for r in sample:
        seq = torch.tensor(np.concatenate(
            [r.prompt, np.asarray(r.tokens[:-1], np.int32)]), device=device)
        z = ref.logits(cell.config, w, seq)[r.prompt_len - 1:]
        served = torch.tensor(r.tokens, device=device)
        worst = max(worst, judge.widest_gap([z], [served]))
        if control:
            zc = ref.logits(cell.config, w, seq, "fp8")[r.prompt_len - 1:]
            worst_ctrl = max(worst_ctrl, judge.widest_gap(
                [z], [zc.argmax(dim=-1)]))
    return (worst, worst_ctrl) if control else worst
