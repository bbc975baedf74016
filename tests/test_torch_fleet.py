"""The serving fleet of flexflow_tpu_torch on the CPU (ROADMAP A10): the
scenarios of tests/test_fleet.py (all but the model repository's, which
waits for A5.10c) through the port's Router, Replica and Autoscaler over
the port's ContinuousBatcher, the port holding the JAX test LM's
weights; and the process-wide gc guard of CUDA graph capture.

Against the JAX package:
 - greedy tokens through the port's affine fleet equal the JAX
   ContinuousBatcher's on the same prompts (identical);
 - the routing order and label for the same replica states, and the
   merged exposition (`render_merged`) of the same metric values, equal
   JAX's Router's and renderer's (identical);
the other scenarios hold the port's fleet to the port's own batcher.
Waits poll a condition with a short sleep between reads, never a fixed
delay."""
import gc
import threading
import time

import numpy as np
import pytest

from flexflow_tpu.obs.registry import MetricsRegistry as JaxRegistry
from flexflow_tpu.obs.registry import render_merged as jax_render_merged
from flexflow_tpu.serving.fleet import Router as JaxRouter
from flexflow_tpu.serving.sched import ContinuousBatcher as JaxBatcher
from flexflow_tpu.serving.sched.kvpool import \
    prefix_route_chain as jax_chain
from flexflow_tpu_torch import params_from_jax
from flexflow_tpu_torch.obs.registry import (MetricsRegistry, render_merged,
                                             validate_exposition)
from flexflow_tpu_torch.runtime import graphs
from flexflow_tpu_torch.serving.fleet import (Autoscaler, FleetUnavailable,
                                              Replica, ReplicaState, Router)
from flexflow_tpu_torch.serving.sched import SLOExceeded
from flexflow_tpu_torch.serving.sched.bench import build_tiny_lm
from flexflow_tpu_torch.serving.sched.kvpool import prefix_route_chain
from tests.conftest import module_xla_cache
from tests.test_generate import _build_lm
from tests.test_torch_zoo import one_torch_thread

_xla_cache = pytest.fixture(scope="module", autouse=True)(module_xla_cache)
_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)

WAIT_S = 120


@pytest.fixture(scope="module")
def lms():
    """JAX's test LM (batch 2, window 12, vocab 50) and the port's copy
    of it holding JAX's weights."""
    jm = _build_lm(2, 12)
    pm = build_tiny_lm(2, 12, vocab=50, device="cpu")
    params_from_jax(pm, jm.params)
    return jm, pm


@pytest.fixture(scope="module")
def lm(lms):
    return lms[1]


def _mk_replica(lm, name, slots=2, max_len=48, page_size=4, max_queue=32,
                **kw):
    return Replica(name, lm, max_len=max_len, num_slots=slots,
                   page_size=page_size, max_queue=max_queue, **kw)


def _mk_fleet(lm, n=2, **kw):
    router = Router(**{k: v for k, v in kw.items()
                       if k in ("policy", "slo_ttft_s", "route_depth")})
    rep_kw = {k: v for k, v in kw.items()
              if k not in ("policy", "slo_ttft_s", "route_depth")}
    for i in range(n):
        router.add_replica(f"r{i}", _mk_replica(lm, f"r{i}", **rep_kw))
    return router


def _prompt(n, seed=0, vocab=50):
    rng = np.random.RandomState(seed)
    return rng.randint(1, vocab, size=(n,)).astype(np.int32)


def _wait_for(cond):
    deadline = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < deadline
        time.sleep(0.005)


def _jax_tokens(jm, prompts, max_new):
    """The JAX ContinuousBatcher's greedy tokens, the fleet's geometry."""
    b = JaxBatcher(jm, max_len=48, num_slots=2, page_size=4, max_queue=32)
    with b:
        return [list(map(int, b.submit(p, max_new).result(timeout=300)))
                for p in prompts]


# ---------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------
def test_affine_routing_lands_on_prefix_owner(lms):
    jm, lm = lms
    router = _mk_fleet(lm, 2)
    try:
        prefix = _prompt(8, seed=1)  # two full pages at page_size=4
        prompts = [np.concatenate([prefix, _prompt(3, seed=2)]),
                   np.concatenate([prefix, _prompt(3, seed=3)]),
                   np.concatenate([_prompt(8, seed=9), _prompt(3, seed=4)])]
        lead = router.submit(prompts[0], 3)
        lead.result(timeout=300)
        home = lead.replica
        # a follower sharing the prefix lands on its owner, affine, a hit
        f = router.submit(prompts[1], 3)
        f.result(timeout=300)
        assert f.replica == home
        assert f.route == "affine"
        assert f.cache_hit and f.prefix_tokens >= 8
        # another tenant spreads to the other replica
        other = router.submit(prompts[2], 3)
        other.result(timeout=300)
        assert other.replica != home
        # the fleet's greedy tokens are the JAX batcher's
        got = [list(map(int, h.tokens)) for h in (lead, f, other)]
        assert got == _jax_tokens(jm, prompts, 3)
    finally:
        router.shutdown()


def test_sticky_routing_before_cache_is_warm(lm):
    router = _mk_fleet(lm, 2)
    try:
        prefix = _prompt(8, seed=5)
        suffix = _prompt(3, seed=6)
        lead = router.submit(np.concatenate([prefix, suffix]), 2)
        # back to back: the leader still prefills, no page is cached yet,
        # and the key pins the follower to the leader's replica anyway
        follow = router.submit(np.concatenate([prefix, _prompt(3, 7)]), 2)
        assert follow.route in ("sticky", "affine")
        assert follow.replica == lead.replica
        lead.result(timeout=300)
        follow.result(timeout=300)
    finally:
        router.shutdown()


def test_cold_short_prompts_route_least_loaded(lm):
    router = _mk_fleet(lm, 2)
    try:
        # under one full page: no routing key at all
        a = router.submit(_prompt(3, seed=10), 2)
        b = router.submit(_prompt(3, seed=11), 2)
        assert a.route == "least_loaded" and b.route == "least_loaded"
        a.result(timeout=300)
        b.result(timeout=300)
    finally:
        router.shutdown()


def test_round_robin_policy_cycles(lm):
    router = _mk_fleet(lm, 2, policy="round_robin")
    try:
        reqs = [router.submit(_prompt(4, seed=20 + i), 2)
                for i in range(4)]
        for r in reqs:
            r.result(timeout=300)
        assert [r.route for r in reqs] == ["round_robin"] * 4
        assert {r.replica for r in reqs} == {"r0", "r1"}
    finally:
        router.shutdown()


class _FakeReplica:
    """A replica's routing signals, nothing else."""

    def __init__(self, load, owned):
        self.load, self.owned = load, owned

    def load_score(self):
        return self.load

    def prefix_probe_chain(self, chain, prompt_len):
        return min(self.owned, max(prompt_len - 1, 0))


@pytest.mark.parametrize("policy", ["affine", "least_loaded", "round_robin"])
def test_route_order_matches_jax(policy):
    """The same replica states (loads, owned prefixes, homes and sticky
    keys) give JAX's Router's candidate order and label."""
    cases = [
        ([(3.0, 0), (1.0, 0), (1.0, 0)], {}, None),       # cold: by load
        ([(3.0, 8), (1.0, 4), (0.5, 0)], {}, None),       # deepest owner
        ([(2.0, 0), (1.0, 0), (1.0, 0)], {"r0": 2}, "r0"),  # sticky key
        ([(1.0, 0), (1.0, 0), (1.0, 0)], {"r0": 1, "r1": 0}, None),
    ]
    prompt = _prompt(11, seed=3)
    for loads, homes, sticky in cases:
        orders = []
        for cls, chainf in ((JaxRouter, jax_chain),
                            (Router, prefix_route_chain)):
            router = cls(policy=policy)
            router._homes.update(homes)
            chain = chainf(prompt, 4)
            key = chain[0] if chain else ""
            if sticky is not None:
                router._affinity[key] = sticky
            ready = [(f"r{i}", _FakeReplica(load, owned))
                     for i, (load, owned) in enumerate(loads)]
            got = []
            for _ in range(3):  # round robin advances
                order, label = router._route_order(len(prompt), key, chain,
                                                   ready)
                got.append(([(n, s) for n, _, s in order], label))
            orders.append(got)
        assert orders[1] == orders[0], (loads, homes, sticky)


def test_fleet_unavailable_when_all_draining(lm):
    router = _mk_fleet(lm, 1)
    try:
        router.drain("r0")
        with pytest.raises(FleetUnavailable) as ei:
            router.submit(_prompt(4), 2)
        assert ei.value.http_status == 503
    finally:
        router.shutdown()


def test_mismatched_page_size_rejected(lm):
    router = _mk_fleet(lm, 1, page_size=4)
    try:
        with pytest.raises(ValueError, match="page geometry"):
            router.add_replica("bad", _mk_replica(lm, "bad", page_size=8))
    finally:
        router.shutdown()


# ---------------------------------------------------------------------
# SLO admission
# ---------------------------------------------------------------------
def test_slo_sheds_by_predicted_ttft_only_after_measurement(lm):
    router = _mk_fleet(lm, 1, slots=1, slo_ttft_s=1e-9)
    try:
        # cold: no rate sample, predicted 0, admitted despite the budget
        first = router.submit(_prompt(6, seed=30), 2)
        first.result(timeout=300)
        rep = router.replica("r0")
        assert rep.batcher.stats()["prefill_s_per_token"] is not None
        # warm: the measured model predicts more than 1e-9 s
        with pytest.raises(SLOExceeded) as ei:
            router.submit(_prompt(6, seed=31), 2)
        assert ei.value.http_status == 429
        assert ei.value.reason == "slo_ttft"
        assert router.registry.counter(
            "ff_fleet_shed_total", labels=("reason",)).value(
                reason="slo_ttft") == 1
    finally:
        router.shutdown()


def test_predicted_ttft_grows_with_queue_backlog(lm):
    rep = _mk_replica(lm, "solo", slots=1, max_queue=64)
    try:
        warm = rep.submit(_prompt(6, seed=32), 2)
        warm.result(timeout=300)
        base = rep.predicted_ttft_s(8)
        assert base > 0
        # a held queue inflates the backlog term
        long_req = rep.submit(_prompt(6, seed=33), 40)
        queued = [rep.submit(_prompt(8, seed=40 + i), 2)
                  for i in range(4)]
        loaded = rep.predicted_ttft_s(8)
        assert loaded > base
        assert rep.batcher.queued_prefill_tokens() > 0
        for q in queued:
            q.result(timeout=300)
        long_req.result(timeout=300)
    finally:
        rep.stop()


# ---------------------------------------------------------------------
# drain / handoff
# ---------------------------------------------------------------------
def test_drain_hands_off_queued_requests_zero_drop(lm):
    router = _mk_fleet(lm, 2, slots=1, max_queue=16)
    try:
        # pin both single slots with long decodes, then queue more work
        pin = [router.submit(_prompt(5, seed=50 + i), 40)
               for i in range(2)]
        _wait_for(lambda: all(p.tokens for p in pin))
        queued = [router.submit(_prompt(5, seed=60 + i), 3)
                  for i in range(4)]
        victim = queued[0].replica
        stats = router.drain(victim)
        assert router.replica(victim).state is ReplicaState.DRAINING
        # every queued request on the victim re-homed or stayed, and all
        # finish whole
        assert stats["handed_off"] + stats["kept"] >= 1
        for q in queued:
            assert q.result(timeout=300).size == 3
        for p in pin:
            assert p.result(timeout=300).size == 40
        handed = [q for q in queued if q.handoffs]
        assert len(handed) == stats["handed_off"]
        for q in handed:
            assert q.replica != victim
    finally:
        router.shutdown()


def test_second_drain_rehomes_the_callers_handle_again(lm):
    """After a handoff the router tracks the caller's FleetRequest on its
    new home, so draining that home re-homes it again."""
    router = _mk_fleet(lm, 3, slots=1, max_queue=16)
    try:
        pin = [router.submit(_prompt(5, seed=150 + i), 40)
               for i in range(3)]
        _wait_for(lambda: all(p.tokens for p in pin))
        q = router.submit(_prompt(5, seed=160), 3)
        first_home = q.replica
        s1 = router.drain(first_home)
        assert s1["handed_off"] == 1 and q.handoffs == 1
        second_home = q.replica
        assert second_home != first_home
        s2 = router.drain(second_home)
        assert s2["handed_off"] == 1 and q.handoffs == 2
        assert q.replica not in (first_home, second_home)
        assert q.result(timeout=300).size == 3
        for p in pin:
            assert p.result(timeout=300).size == 40
    finally:
        router.shutdown()


def test_affinity_lru_is_bounded_and_homes_stay_consistent(lm):
    router = _mk_fleet(lm, 2)
    router.max_affinity_keys = 4
    try:
        for i in range(10):
            router.submit(
                np.concatenate([_prompt(4, seed=200 + i),
                                _prompt(2, seed=300 + i)]),
                2).result(timeout=300)
        with router._lock:
            assert len(router._affinity) == 4
            homes = dict(router._homes)
        assert sum(homes.values()) == 4
        assert set(homes) <= {"r0", "r1"}
    finally:
        router.shutdown()


def test_remove_waits_for_drain_and_stops(lm):
    router = _mk_fleet(lm, 2)
    try:
        r = router.submit(_prompt(5, seed=70), 3)
        r.result(timeout=300)
        name = r.replica
        router.remove(name, timeout=120)
        assert name not in router.replica_names()
        assert len(router.replica_names()) == 1
    finally:
        router.shutdown()


# ---------------------------------------------------------------------
# autoscaler
# ---------------------------------------------------------------------
def test_autoscaler_grow_and_shrink_cycle(lm):
    router = _mk_fleet(lm, 1, slots=2, max_queue=64)
    asc = Autoscaler(router, min_slots=1, max_slots=4, grow_step=2,
                     shrink_step=3, queue_hi=1, util_lo=0.9,
                     idle_ticks_before_shrink=2,
                     idle_ticks_before_drain=10**9)
    try:
        rep = router.replica("r0")
        flood = [router.submit(_prompt(5, seed=80 + i), 6)
                 for i in range(8)]
        acts = asc.tick()
        assert any(a["action"] == "grow" and a["to"] == 4 for a in acts)
        for h in flood:
            assert h.result(timeout=300).size == 6
        deadline = time.monotonic() + WAIT_S
        while asc.pending_resizes():
            assert time.monotonic() < deadline
            asc.tick()
            time.sleep(0.02)
        assert rep.num_slots() == 4
        # idle now: the shrink fires after the hysteresis ticks
        shrunk = []
        while rep.num_slots() != 1:
            assert time.monotonic() < deadline
            shrunk += [a for a in asc.tick() if a["action"] == "shrink"]
            time.sleep(0.02)
        assert shrunk and shrunk[0]["to"] == 1
        assert rep.batcher.stats()["failed"] == 0
    finally:
        router.shutdown()


def test_autoscaler_adds_then_retires_replicas(lm):
    router = _mk_fleet(lm, 1, slots=1, max_queue=64)
    asc = Autoscaler(
        router, min_slots=1, max_slots=1,  # the mesh pinned: overload
        queue_hi=0, util_lo=0.9,           # adds a REPLICA instead
        replica_factory=lambda: _mk_replica(lm, "auto", slots=1),
        max_replicas=2, min_replicas=1, idle_ticks_before_drain=2)
    try:
        flood = [router.submit(_prompt(5, seed=90 + i), 4)
                 for i in range(4)]
        acts = asc.tick()
        assert any(a["action"] == "add_replica" for a in acts)
        assert len(router.replica_names()) == 2
        for h in flood:
            h.result(timeout=300)
        # sustained idleness retires one (drain and remove run in the
        # background: poll until the membership shrinks back)
        deadline = time.monotonic() + WAIT_S
        drained = False
        while len(router.replica_names()) > 1:
            assert time.monotonic() < deadline
            drained = drained or any(a["action"] == "drain_replica"
                                     for a in asc.tick())
            time.sleep(0.02)
        assert drained
    finally:
        router.shutdown()


def test_autoscaler_ttft_slo_is_windowed_not_lifetime(lm):
    router = _mk_fleet(lm, 1, slots=2)
    asc = Autoscaler(router, min_slots=1, max_slots=4, queue_hi=10**9,
                     util_hi=2.0, util_lo=0.9, ttft_p99_slo_ms=50.0,
                     idle_ticks_before_shrink=1,
                     idle_ticks_before_drain=10**9)
    try:
        rep = router.replica("r0")
        fam = rep.registry.get("ff_serving_ttft_ms")
        fam.observe(5000.0, cache="miss")  # a slow burst, long ago
        assert rep.ttft_p99_ms() > 50.0   # the lifetime read is over
        acts = asc.tick() + asc.tick()
        # idle, the burst outside the window: shrink, never grow
        assert any(a["action"] == "shrink" for a in acts)
        assert not any(a["action"] == "grow" for a in acts)
        deadline = time.monotonic() + WAIT_S
        while asc.pending_resizes():
            assert time.monotonic() < deadline
            asc.tick()
            time.sleep(0.02)
        # a fresh breach inside the window still reads as overload
        fam.observe(5000.0, cache="miss")
        grown = []
        while not grown:
            assert time.monotonic() < deadline
            grown = [a for a in asc.tick() if a["action"] == "grow"]
            time.sleep(0.01)
    finally:
        router.shutdown()


def test_autoscaler_preplans_next_resize_target():
    """tests/test_search_cache.py:510's case on the port: an overloaded
    replica already at its slot ceiling makes the Autoscaler submit the
    next resize target's plan to the port's BackgroundPlanner, once an
    overload."""
    from flexflow_tpu_torch.search.plan_cache import BackgroundPlanner

    class FakeReplica:
        state = ReplicaState.READY

        def queue_depth(self):
            return 5

        def utilization(self):
            return 0.9

        def num_slots(self):
            return 8  # at the ceiling: only a replica add could help

        def live_sequences(self):
            return 1

    class FakeRouter:
        def __init__(self):
            self.registry = MetricsRegistry()
            self._reps = {"r0": FakeReplica()}

        def replica_names(self):
            return list(self._reps)

        def replica(self, name):
            return self._reps[name]

    planned = []
    bp = BackgroundPlanner(idle_timeout_s=0.2)
    auto = Autoscaler(FakeRouter(), min_slots=1, max_slots=8,
                      preplanner=bp,
                      preplan_fn=lambda: planned.append("warm") or "ok")
    actions = auto.tick()
    assert any(a["action"] == "preplan" for a in actions), actions
    assert bp.join(timeout=10)
    assert planned == ["warm"]
    # edge-triggered: the next overloaded tick does not submit again
    assert not any(a.get("action") == "preplan" for a in auto.tick())


# ---------------------------------------------------------------------
# observability fan-in
# ---------------------------------------------------------------------
def test_merged_exposition_has_replica_label_and_validates(lm):
    router = _mk_fleet(lm, 2)
    try:
        for i in range(3):
            router.submit(_prompt(6, seed=100 + i), 2).result(timeout=300)
        text = router.registry.render() + render_merged(
            router.replica_registries())
        fams = validate_exposition(text)
        ttft = fams["ff_serving_ttft_ms"]
        assert all("replica" in lbls for _, lbls, _ in ttft["samples"])
        assert {lbls["replica"] for _, lbls, _ in ttft["samples"]} \
            <= {"r0", "r1"}
        assert text.count("# TYPE ff_fleet_requests_total counter") == 1
        assert text.count("# TYPE ff_serving_ttft_ms histogram") == 1
    finally:
        router.shutdown()


def test_render_merged_matches_jax():
    """The same families and values in two registries of each package
    merge into the same document, collisions refused alike."""
    texts = []
    for reg_cls, merge in ((JaxRegistry, jax_render_merged),
                           (MetricsRegistry, render_merged)):
        regs = {}
        for i, name in enumerate(("r1", "r0")):
            reg = reg_cls()
            reg.counter("ff_serving_tokens_total", "Tokens").inc(3 + i)
            reg.gauge("ff_kvpool_pages_used", "Pages",
                      labels=("pool",)).set(2 * i, pool=f"pool{i}")
            h = reg.histogram("ff_serving_ttft_ms", "TTFT",
                              labels=("cache",))
            h.observe(1.5 + i, cache="miss")
            h.observe(40.0, cache="hit")
            regs[name] = reg
        texts.append(merge(regs))
        bad = reg_cls()
        bad.gauge("g", "x", labels=("replica",)).set(1, replica="a")
        with pytest.raises(ValueError, match="ambiguous"):
            merge({"a": bad})
        clash = reg_cls()
        clash.counter("ff_serving_tokens_total", "Tokens",
                      labels=("kind",)).inc(kind="x")
        with pytest.raises(ValueError, match="collision"):
            merge({"a": regs["r0"], "b": clash})
    assert texts[1] == texts[0]
    validate_exposition(texts[1])


def test_server_fleet_fanin_healthz_and_load_failures(lm):
    import json
    from urllib.request import urlopen

    from flexflow_tpu_torch.obs.registry import REGISTRY
    from flexflow_tpu_torch.serving import InferenceServer

    server = InferenceServer()
    router = _mk_fleet(lm, 2)
    server.register_fleet("lm", router)
    # a non-fleet series of the same family in the process-wide registry:
    # /metrics still renders one document, one TYPE header a family
    REGISTRY.gauge("ff_kvpool_pages_used", "KV pages in use",
                   labels=("pool",)).set(1, pool="solo")
    httpd = server.serve_http(port=0)
    try:
        port = httpd.server_address[1]
        out = server.generate("lm", [[1, 2, 3], [4, 5]], 3)
        assert [len(t) for t in out] == [3, 3]
        with urlopen(f"http://127.0.0.1:{port}/healthz") as r:
            health = json.loads(r.read())
        assert health["status"] == "ok"
        assert health["fleets"]["lm"]["ready"] == 2
        # a failed replica load counts and degrades /healthz
        router.add_replica("bad", lambda: (_ for _ in ()).throw(
            RuntimeError("no checkpoint")))
        router.drain("r1")
        with urlopen(f"http://127.0.0.1:{port}/healthz") as r:
            health = json.loads(r.read())
        assert health["status"] == "degraded"
        assert health["fleets"]["lm"]["failed_loads"]
        text = server.prometheus_text()
        validate_exposition(text)
        assert 'ff_model_load_failures_total{model="lm/bad"} 1' in text
        assert 'replica="r0"' in text and "ff_fleet_requests_total" in text
        # the whole fleet gone: "down"
        router.drain("r0")
        with urlopen(f"http://127.0.0.1:{port}/healthz") as r:
            assert json.loads(r.read())["status"] == "down"
    finally:
        REGISTRY.get("ff_kvpool_pages_used").remove(pool="solo")
        httpd.shutdown()
        server.shutdown()


def test_stream_through_fleet(lm):
    from flexflow_tpu_torch.serving import InferenceServer

    server = InferenceServer()
    router = _mk_fleet(lm, 1)
    server.register_fleet("lm", router)
    try:
        gen = server.generate_stream("lm", [1, 2, 3, 4], 4)
        toks = list(gen.stream(timeout=300))
        assert len(toks) == 4
        assert toks == list(gen.tokens)
    finally:
        server.shutdown()


# ---------------------------------------------------------------------
# the capture's gc guard (runtime/graphs.py gc_paused)
# ---------------------------------------------------------------------
def test_gc_guard_holds_until_the_last_of_overlapping_holders():
    """Two threads hold the guard in overlapping spans: gc stays off
    until the LAST one leaves, then comes back on; a guard entered with
    gc already off leaves it off."""
    was = gc.isenabled()
    gc.enable()
    try:
        a_in, b_in, a_out, b_go = (threading.Event() for _ in range(4))
        seen = {}

        def holder(name, entered, wait_on, left=None):
            with graphs.gc_paused():
                entered.set()
                wait_on.wait(timeout=30)
                seen[name] = gc.isenabled()
            if left is not None:
                left.set()

        ta = threading.Thread(target=holder, args=("a", a_in, b_in, a_out))
        ta.start()
        assert a_in.wait(timeout=30) and not gc.isenabled()
        tb = threading.Thread(target=holder, args=("b", b_in, b_go))
        tb.start()
        # a leaves while b still holds: gc stays off
        assert a_out.wait(timeout=30)
        ta.join(timeout=30)
        assert not gc.isenabled()
        b_go.set()
        tb.join(timeout=30)
        assert seen == {"a": False, "b": False}
        assert gc.isenabled()
        gc.disable()
        with graphs.gc_paused():
            assert not gc.isenabled()
        assert not gc.isenabled()
    finally:
        (gc.enable if was else gc.disable)()


def test_cast_cache_makes_one_cast_a_version_under_threads():
    """Many threads read one weight's bf16 cast at once (the replicas of
    a fleet walking one model): every reader gets the one cached copy,
    made once a version of the master (core/op.py's lock)."""
    import sys

    import torch

    pm = build_tiny_lm(2, 12, vocab=50, mixed_precision=True,
                       device="cpu")
    op = next(o for o in pm.ops if o.weights and o.specs)
    name = op.specs[0].name
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            op._cast.clear()
            got, go = [], threading.Barrier(16)

            def read():
                go.wait(timeout=30)
                got.append(op.w(name, torch.bfloat16))

            ts = [threading.Thread(target=read) for _ in range(16)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in ts)
            assert len(got) == 16 and all(g is got[0] for g in got)
            assert op._cast[(name, torch.bfloat16)][1] is got[0]
    finally:
        sys.setswitchinterval(old)


def test_two_replicas_share_one_model_and_serve_one_replicas_tokens(lm):
    """Two replicas of one model serve concurrently (each scheduler
    thread walks the shared model; the cast cache is locked): the tokens
    are one replica's."""
    prompts = [_prompt(7 + i, seed=400 + i) for i in range(6)]
    solo = _mk_replica(lm, "solo")
    try:
        want = [list(solo.submit(p, 5).result(timeout=300))
                for p in prompts]
    finally:
        solo.stop()
    router = _mk_fleet(lm, 2, policy="round_robin")
    try:
        hs = [router.submit(p, 5) for p in prompts]
        got = [list(h.result(timeout=300)) for h in hs]
        assert {h.replica for h in hs} == {"r0", "r1"}
        assert got == want
    finally:
        router.shutdown()


def test_fleet_stats_and_health_shapes(lm):
    """stats() and health() carry JAX's keys."""
    router = _mk_fleet(lm, 2)
    try:
        router.submit(_prompt(5, seed=500), 2).result(timeout=300)
        st, health = router.stats(), router.health()
        jr = JaxRouter()
        try:
            assert set(st) == set(jr.stats())
            assert set(health) == set(jr.health())
        finally:
            jr.shutdown()
        assert health["status"] == "ok" and health["ready"] == 2
        assert set(st["replicas"]) == {"r0", "r1"}
    finally:
        router.shutdown()

