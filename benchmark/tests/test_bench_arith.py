"""The benchmark's own arithmetic: percentiles, the interval union,
operation and byte counts, and the metric readers on made-up runs."""
import numpy as np
import pytest

from benchmark import flops, harness, readers, stats
from benchmark.observe import Observations, RequestRecord
from benchmark.trace import DeviceTrace

BERT = {"hidden": 1024, "layers": 24, "heads": 16, "ffn": 4096,
        "vocab": 30522, "head_params": 1024 * 1024 + 1024 * 30522}
GPT2 = {"hidden": 1024, "layers": 24, "heads": 16, "ffn": 4096,
        "vocab": 50257, "head_params": 1024 * 50257}


@pytest.mark.parametrize("q", [0, 5, 50, 95, 99, 100])
def test_percentile_matches_numpy(q):
    xs = np.random.default_rng(3).lognormal(size=101)
    assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))
    assert stats.percentile([], q) is None


def test_union_counts_overlap_once():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (7.0, 7.0)]
    assert stats.union(iv) == [(0.0, 3.0), (5.0, 6.0)]
    assert stats.covered(iv) == 4.0
    assert stats.clip(iv, 1.5, 5.6) == [(1.5, 2.0), (1.5, 3.0), (5.0, 5.6),
                                        (5.5, 5.6)]
    assert stats.gaps(iv, -1.0, 8.0) == [(-1.0, 0.0), (3.0, 5.0),
                                        (6.0, 8.0)]


def test_bert_large_step_by_hand():
    # matrices a token: 24 x (4 x 1024^2 + 2 x 1024 x 4096) + 1024^2 +
    # 1024 x 30522 = 334,292,992; 6 x that x 16,384 tokens, plus
    # attention 12 x 24 x 32 x 512^2 x 1024
    p = 24 * (4 * 1024 ** 2 + 2 * 1024 * 4096) + 1024 ** 2 + 1024 * 30522
    assert flops.matmul_params(BERT) == p == 334_292_992
    want = 6 * p * 16384 + 12 * 24 * 32 * 512 * 512 * 1024
    assert flops.train_step_flops(BERT, 32, 512) == want
    assert 35.2e12 < want < 35.5e12


def test_decoder_forward_by_hand():
    p = 24 * 12 * 1024 ** 2 + 1024 * 50257
    # one token at position 99 attends 100 keys: 4 x 1024 a key a layer
    assert flops.forward_flops(GPT2, 99, 1) == 2 * p + 4 * 24 * 1024 * 100
    # a chunk of 16 at offset 32 attends 33 + ... + 48 keys
    keys = sum(range(33, 49))
    assert flops.forward_flops(GPT2, 32, 16) == \
        16 * 2 * p + 4 * 24 * 1024 * keys


def test_attention_backward_least_time():
    f, nbytes = flops.attn_bwd_cost(8, 16, 512, 64)
    assert f == 8 * 8 * 16 * 512 * 512 * 64
    assert nbytes == 7 * 8 * 512 * 1024 * 2 + 2 * 8 * 16 * 512 * 4
    assert flops.least_time_s(f, nbytes) == pytest.approx(
        max(f / 989e12, nbytes / 3.35e12))
    # bytes bound it at the kernel table's shape: 59,244,544 bytes over
    # 3.35 TB/s, 0.01768 ms (the products alone 0.01737)
    assert flops.least_time_s(f, nbytes) == pytest.approx(1.76849e-5,
                                                          rel=1e-4)


def _obs(**kw):
    o = Observations({}, {"batch": 32, "seq": 512}, GPT2, 1, 10.0)
    for k, v in kw.items():
        setattr(o, k, v)
    return o


def test_device_trace_readings():
    dt = DeviceTrace(0.0, 10.0, [
        ("void flash_bwd_dkv_tc<64, 2>(CUtensorMap)", 1.0, 2.0),
        ("void flash_bwd_dq_tc<64>(CUtensorMap)", 2.0, 2.5),
        ("Memcpy HtoD (Pinned -> Device)", 2.2, 3.0),
        ("ampere_bf16_gemm", 6.0, 8.0)],
        [("aten::item", 3.0, 6.0), ("cudaGraphLaunch", 8.0, 8.1)])
    assert dt.busy_s == pytest.approx(4.0)
    assert readers.idle_pct(_obs(device=dt)) == pytest.approx(60.0)
    assert dt.time_of(["flash_bwd"]) == (pytest.approx(1.5), 2)
    b = dt.breakdown()
    assert b["device_ops"][0] == ["ampere_bf16_gemm", 2.0]
    assert b["idle_gaps"][0] == ["aten::item", 3.0]
    assert b["idle_gaps"][1] == ["cudaGraphLaunch", 2.0]
    assert b["idle_gaps"][2] == ["host idle", 1.0]


@pytest.mark.parametrize("cell", ["s512", "s128"])
def test_roofline_reader(cell):
    per_call = flops.least_time_s(*flops.attn_bwd_cost(32, 16, 512, 64))
    dt = DeviceTrace(0.0, 1.0, [("flash_bwd_dkv_tc", 0.0, 0.002),
                                ("flash_bwd_dq_tc", 0.002, 0.003)] * 2)
    obs = _obs(device=dt, dims=BERT)
    got = harness.read_metric(f"attn_bwd_roofline.{cell}", obs)
    assert got == pytest.approx(100.0 * 2 * per_call / 0.006)
    assert harness.read_metric(f"attn_bwd_roofline.{cell}",
                               _obs(device=None)) is None


def test_serving_readers_on_spans():
    reqs = [RequestRecord(7, np.zeros(10, np.int32), 3, due=0.0,
                          first=0.5, token_times=[0.5, 0.6, 0.8],
                          tokens=[1, 2, 3], queue_wait_s=0.2),
            RequestRecord(8, np.zeros(4, np.int32), 2, due=1.0, first=1.1,
                          token_times=[1.1, 1.4], tokens=[1, 2],
                          queue_wait_s=0.0)]
    spans = [{"name": "serve.decode", "ph": "X", "ts": 0.0, "dur": 2000.0,
              "args": {"slots": 2, "requests": [7, 8]}},
             {"name": "serve.decode", "ph": "X", "ts": 5000.0,
              "dur": 4000.0, "args": {"slots": 1, "requests": [7]}},
             {"name": "serve.prefill", "ph": "X", "ts": 100.0, "dur": 1.0,
              "args": {"offset": 16, "tokens": 4}}]
    obs = _obs(requests=reqs, spans=spans, window=(0.0, 2.0))
    assert readers.decode_iter_ms(obs) == 3.0
    assert harness.read_metric("decode_occupancy.offline", obs) == 1.5
    want = (flops.forward_flops(GPT2, 10, 1) + flops.forward_flops(GPT2, 4, 1)
            + flops.forward_flops(GPT2, 11, 1))
    assert readers.decode_flops(obs) == want
    assert harness.read_metric("mfu.chat", obs) == pytest.approx(
        100 * want / 6e-3 / 989e12)
    assert harness.read_metric("mfu.offline", obs) == pytest.approx(
        100 * (want + flops.forward_flops(GPT2, 16, 4)) / 2.0 / 989e12)
    assert harness.read_metric("ttft_p95_ms", obs) == pytest.approx(
        1e3 * stats.percentile([0.5, 0.1], 95))
    assert harness.read_metric("itl_p95_ms", obs) == pytest.approx(
        1e3 * stats.percentile([0.1, 0.2, 0.3], 95))
    assert harness.read_metric("serve_tokens_per_s", obs) == 2.5
    assert harness.read_metric("queue_wait_p95_ms.chat", obs) == \
        pytest.approx(1e3 * stats.percentile([0.2, 0.0], 95))


@pytest.mark.parametrize("cell", ["s512", "s128"])
def test_training_readers(cell):
    obs = _obs(dims=BERT, steps=40, window=(1.0, 9.0), trace_steps=8,
               device=DeviceTrace(0.0, 2.0, [("k", 0.0, 1.0)]))
    assert harness.read_metric(f"train_tokens_per_s.{cell}", obs) == \
        40 * 32 * 512 / 8.0
    step = flops.train_step_flops(BERT, 32, 512)
    assert harness.read_metric(f"mfu.train.{cell}", obs) == pytest.approx(
        100 * step * 8 / 2.0 / 989e12)
    assert harness.read_metric(f"device_idle.train.{cell}", obs) == 50.0
