"""The plain references against the port at tiny widths on the CPU, in
f32 on both sides, through the runners the card runs; and the fp8
control against the reference at the configurations' own widths, cut in
depth, batch and length to what a test run holds."""
import numpy as np
import pytest
import torch

from benchmark import harness, judge
from benchmark import traffic as gen
from benchmark.tests import tiny

SEED = 2 ** 31 + 5


@pytest.mark.parametrize("name", ["bert-large.train-s512",
                                  "bert-large.train-s128"])
def test_training_port_matches_reference(name):
    cell = tiny.cell(name)
    drv = cell.runner()
    model, (x, y), prog = drv.setup(cell, SEED, "cpu")
    del model
    ref = drv.reference_readings(cell, SEED, "cpu", x, y)
    numbers, notes = judge.train_numbers(prog, ref)
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-3 and numbers["change_gap"] < 1e-2
    # the attention key biases have no gradient under softmax: left out
    assert notes["still_leaves"] >= 2
    assert len(prog["loss"]) == 2 and prog["loss"][1] < prog["loss"][0]


@pytest.mark.parametrize("name", ["gpt2-medium.chat-poisson",
                                  "gpt2-medium.offline-closed"])
def test_served_tokens_are_the_reference_argmax(name):
    cell = tiny.cell(name)
    out = cell.runner().run(cell, SEED, 2.0, False, "cpu")
    assert not out.problems and out.checks["logit_gap"][0] < 1e-4
    assert out.notes["checked_tokens"] > 0


def test_gpt2_reference_is_causal():
    cell = tiny.cell("gpt2-medium.chat-poisson")
    ref = cell.reference()
    w = ref.make_weights(cell.config, SEED, "cpu")
    seq = torch.tensor(gen.rng_for(1, 1).integers(0, 101, 12))
    full = ref.logits(cell.config, w, seq)
    head = ref.logits(cell.config, w, seq[:5])
    assert torch.allclose(full[:5], head, atol=1e-5)


def _full_width(name, layers):
    cell = harness.load_cell(name, tiny.spec())
    cfg = cell.config
    cfg.update({"num_hidden_layers" if "num_hidden_layers" in cfg
                else "n_layer": layers})
    return cell


def test_fp8_control_fails_the_training_limits():
    """The reference on fp8 operands, in the port's place, at BERT-Large's
    widths cut to 4 layers, batch 4, 64 positions: a number past its
    limit."""
    cell = _full_width("bert-large.train-s128", 4)
    mix = dict(cell.traffic, batch=4, seq=64, pool_batches=8)
    x, y = gen.train_pool(mix, cell.config["vocab_size"], SEED)
    ref = cell.reference()
    f32 = ref.train_readings(cell.config, x, y, 4, "cpu", SEED, rows=4)
    fp8 = ref.train_readings(cell.config, x, y, 4, "cpu", SEED, "fp8",
                             rows=4)
    numbers, _ = judge.train_numbers(fp8, f32)
    assert any(numbers[k] > v for k, v in cell.limits.items()), numbers


def test_fp8_control_fails_the_serving_limit():
    """At GPT-2 Medium's widths cut to 2 layers: the token the fp8
    reference puts first lies below the float32 reference's best by more
    than the limit somewhere in 64 positions."""
    cell = _full_width("gpt2-medium.chat-poisson", 2)
    ref = cell.reference()
    w = ref.make_weights(cell.config, SEED, "cpu")
    seq = torch.tensor(gen.rng_for(SEED, 9).integers(0, 50257, 64))
    z = ref.logits(cell.config, w, seq)
    zc = ref.logits(cell.config, w, seq, "fp8")
    gap = judge.widest_gap([z], [zc.argmax(-1)])
    assert gap > cell.limits["logit_gap"], gap
    assert judge.widest_gap([z], [z.argmax(-1)]) == 0.0


def test_half_batch_fault_moves_the_gradient():
    cell = tiny.cell("bert-large.train-s128")
    x, y = gen.train_pool(cell.traffic, 97, SEED)
    ref = cell.reference()
    full = ref.train_readings(cell.config, x[:8], y[:8], 4, "cpu", SEED)
    half = ref.train_readings(cell.config, x[:8], y[:8], 4, "cpu", SEED,
                              half_batch=True)
    numbers, _ = judge.train_numbers(half, full)
    assert numbers["grad_gap"] > cell.limits["grad_gap"]
    assert np.isfinite(list(numbers.values())).all()
