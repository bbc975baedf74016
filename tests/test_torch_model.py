"""flexflow_tpu_torch model layer on the CPU: the port's forward (chunk
offset and per-slot decode) against the JAX executor's `forward_values`
on the same weights, carried across by `params_from_jax`; the weight
checks; and the package's import boundary."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ffconst import CompMode
from flexflow_tpu_torch import params_from_jax
from flexflow_tpu_torch.serving.sched.bench import build_tiny_lm
from tests.test_generate import _build_lm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# f32: the same math through another BLAS (observed ~1e-7)
F32_TOL = dict(rtol=1e-5, atol=1e-6)
# mixed precision: bf16 activations, so a few bf16 ulps (2^-8 relative)
# where the two round a product or a sum differently
BF16_TOL = dict(rtol=2e-2, atol=4e-3)


def test_import_loads_neither_jax_nor_flexflow_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import flexflow_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flexflow_tpu'))\n"
        "new = ('flexflow_tpu_torch.kernels.registry',\n"
        "       'flexflow_tpu_torch.kernels.reduction',\n"
        "       'flexflow_tpu_torch.obs.registry',\n"
        "       'flexflow_tpu_torch.core.machine',\n"
        "       'flexflow_tpu_torch.runtime.distributed',\n"
        "       'flexflow_tpu_torch.runtime.collectives',\n"
        "       'flexflow_tpu_torch.search.simulator',\n"
        "       'flexflow_tpu_torch.tools.tp_train')\n"
        "bad += [m + ' not imported' for m in new if m not in sys.modules]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _models(mixed_precision):
    jm = _build_lm(2, 8)
    jm.config.allow_mixed_precision = mixed_precision
    pm = build_tiny_lm(2, 8, vocab=50, mixed_precision=mixed_precision,
                       device="cpu")
    params_from_jax(pm, jm.params)
    return jm, pm


@pytest.mark.parametrize("mixed_precision", [False, True])
def test_forward_matches_jax_chunk_offset_then_vector_decode(
        mixed_precision):
    jm, pm = _models(mixed_precision)
    tol = BF16_TOL if mixed_precision else F32_TOL
    m, heads, hd = 24, 4, 8
    jdt = jnp.bfloat16 if mixed_precision else jnp.float32
    tdt = torch.bfloat16 if mixed_precision else torch.float32
    attn = [op.name for op in pm.ops
            if op.op_type.value == "multihead_attention"]
    jcache = {n: {v: jnp.zeros((2, m, heads, hd), jdt)
                  for v in ("k_cache", "v_cache")} for n in attn}
    pcache = {n: {v: torch.zeros((2, m, heads, hd), dtype=tdt)
                  for v in ("k_cache", "v_cache")} for n in attn}
    rng = np.random.RandomState(3)
    jin, pin = jm.input_ops[0].name, pm.input_ops[0].name
    # two 4-token chunks at a shared offset, then one decode step with
    # ragged per-slot positions (slot 1 rewrites its row 5)
    steps = [(rng.randint(1, 50, size=(2, 4)).astype(np.int32), 0),
             (rng.randint(1, 50, size=(2, 4)).astype(np.int32), 4),
             (rng.randint(1, 50, size=(2, 1)).astype(np.int32),
              np.array([8, 5], np.int32))]
    for toks, pos in steps:
        jpos = jnp.asarray(pos, jnp.int32)
        tpos = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
        vals, new_state, _ = jm.executor.forward_values(
            jm.params, {**jm.state, **jcache}, {jin: jnp.asarray(toks)},
            None, CompMode.COMP_MODE_INFERENCE, decode_pos=jpos)
        jcache = {n: {v: new_state[n][v] for v in ("k_cache", "v_cache")}
                  for n in attn}
        pvals = pm.executor.forward_values({pin: torch.from_numpy(toks)},
                                           state=pcache, decode_pos=tpos)
        probs = pvals[pm.final_tensor.guid]
        assert probs.dtype == tdt
        np.testing.assert_allclose(
            probs.float().numpy(),
            np.asarray(vals[jm.final_tensor.guid], np.float32), **tol)
        for n in attn:
            for v in ("k_cache", "v_cache"):
                np.testing.assert_allclose(
                    pcache[n][v].float().numpy(),
                    np.asarray(jcache[n][v], np.float32),
                    **(dict(rtol=2e-2, atol=2e-2) if mixed_precision
                       else F32_TOL))


def test_full_sequence_attention_is_not_ported():
    """Full-sequence attention runs the flash path now (the training
    slice): a forward with no caches matches the JAX executor's; what of
    it is still not ported — attention dropout, sequence parallelism —
    raises."""
    jm, pm = _models(False)
    toks = np.random.RandomState(4).randint(1, 50, size=(2, 8)).astype(
        np.int32)
    vals, _, _ = jm.executor.forward_values(
        jm.params, jm.state, {jm.input_ops[0].name: jnp.asarray(toks)},
        None, CompMode.COMP_MODE_INFERENCE)
    pvals = pm.executor.forward_values(
        {pm.input_ops[0].name: torch.from_numpy(toks)})
    np.testing.assert_allclose(
        pvals[pm.final_tensor.guid].numpy(),
        np.asarray(vals[jm.final_tensor.guid]), **F32_TOL)
    t = pm.ops[1].outputs[0]
    with pytest.raises(NotImplementedError, match="dropout"):
        pm.multihead_attention(t, t, t, 32, 4, dropout=0.1)
    with pytest.raises(NotImplementedError, match="sequence-parallel"):
        pm.multihead_attention(t, t, t, 32, 4, sequence_parallel=True)


def test_params_from_jax_checks_names_and_shapes():
    jm = _build_lm(1, 4)
    pm = build_tiny_lm(1, 4, vocab=50, device="cpu")
    params = {op: {w: np.asarray(v) for w, v in ws.items()}
              for op, ws in jm.params.items()}
    params_from_jax(pm, params)
    np.testing.assert_array_equal(pm.params["l0_attn"]["wq"].numpy(),
                                  params["l0_attn"]["wq"])

    missing = {op: dict(ws) for op, ws in params.items()}
    del missing["l1_ff1"]["bias"]
    with pytest.raises(KeyError, match="l1_ff1"):
        params_from_jax(pm, missing)
    no_op = {op: ws for op, ws in params.items() if op != "lm_head"}
    with pytest.raises(KeyError, match="lm_head"):
        params_from_jax(pm, no_op)
    bad = {op: dict(ws) for op, ws in params.items()}
    bad["l0_attn"]["wo"] = bad["l0_attn"]["wo"].transpose(2, 0, 1)
    with pytest.raises(ValueError, match="'wo'"):
        params_from_jax(pm, bad)
    # a refused tree loads nothing
    np.testing.assert_array_equal(pm.params["l0_attn"]["wo"].numpy(),
                                  params["l0_attn"]["wo"])


def test_same_builder_gives_the_jax_op_and_weight_names():
    jm = _build_lm(2, 8)
    pm = build_tiny_lm(2, 8, vocab=50, device="cpu")
    assert [op.name for op in pm.executor.topo] == \
        [op.name for op in jm.executor.topo]
    assert {op: {w: tuple(v.shape) for w, v in ws.items()}
            for op, ws in pm.params.items()} == \
        {op: {w: tuple(v.shape) for w, v in ws.items()}
         for op, ws in jm.params.items()}
