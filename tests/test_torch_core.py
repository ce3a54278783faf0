"""Parity of the port's core and ops (univid_tpu_torch) with univid_tpu.

Inputs are made with numpy from a seed and handed to both packages. fp32
comparisons hold to ~1e-6 relative (conftest pins JAX matmuls to the
highest precision); solver coefficients are the same numpy code.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univid_tpu.core import config as jcfg
from univid_tpu.core import nn as jnn
from univid_tpu.ops import embeddings as jemb
from univid_tpu.ops import rope as jrope
from univid_tpu.ops import samplers as jsamp
from univid_tpu.ops import tma as jtma
from univid_tpu_torch.core import config as tcfg
from univid_tpu_torch.core import nn as tnn
from univid_tpu_torch.core import dtypes as tdt
from univid_tpu_torch.ops import embeddings as temb
from univid_tpu_torch.ops import rope as trope
from univid_tpu_torch.ops import samplers as tsamp
from univid_tpu_torch.ops import tma as ttma

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("name", ["t2v-1.3B", "ti2v-5B", "tiny"])
def test_configs_match(name):
    a, b = jcfg.WAN_CONFIGS[name], tcfg.WAN_CONFIGS[name]
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for size in ((832, 480), (1280, 704), (64, 64)):
        for frames in (81, 9):
            assert jcfg.latent_shape(a, *size, frames) == \
                tcfg.latent_shape(b, *size, frames)
            assert jcfg.dit_seq_len(a, *size, frames) == \
                tcfg.dit_seq_len(b, *size, frames)
    assert tcfg.DEFAULT_NEG_PROMPT == jcfg.DEFAULT_NEG_PROMPT


def test_dtype_policies_have_the_same_flags():
    from univid_tpu.core import dtypes as jdt
    for pol in ("DEFAULT_POLICY", "BF16_RESIDUAL_POLICY", "FP32_POLICY"):
        a = dataclasses.asdict(getattr(jdt, pol))
        b = dataclasses.asdict(getattr(tdt, pol))
        assert a.keys() == b.keys()
        for k in a:
            want = a[k] if isinstance(a[k], bool) else np.dtype(a[k]).name
            got = b[k] if isinstance(b[k], bool) else str(b[k]).split(".")[1]
            assert want == got, (pol, k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nn_layers_match(dtype):
    """linear / rms_norm / layer_norm / l2_normalize_rms / gelu / silu; fp32
    to 1e-5, bf16 to one bf16 rounding (2^-8 relative)."""
    x = _rand((3, 5, 16), 0)
    w = _rand((16, 24), 1, 0.3)
    b = _rand((24,), 2)
    g = _rand((16,), 3) + 1.0
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" \
        else dict(rtol=1e-2, atol=1e-2)
    lin = tnn.Linear(16, 24, device="cpu")
    lin.load_state_dict({"w": torch.as_tensor(w.T), "b": torch.as_tensor(b)})
    pairs = [
        (jnn.linear({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                    jnp.asarray(x), compute_dtype=jd),
         tnn.linear(lin, torch.as_tensor(x), compute_dtype=td)),
        (jnn.rms_norm(jnp.asarray(x, jd), jnp.asarray(g, jd), eps=1e-6),
         tnn.rms_norm(torch.as_tensor(x).to(td), torch.as_tensor(g).to(td),
                      eps=1e-6)),
        (jnn.layer_norm(jnp.asarray(x, jd), eps=1e-6),
         tnn.layer_norm(torch.as_tensor(x).to(td), eps=1e-6)),
        (jnn.l2_normalize_rms(jnp.asarray(x, jd), jnp.asarray(g, jd)),
         tnn.l2_normalize_rms(torch.as_tensor(x).to(td),
                              torch.as_tensor(g).to(td))),
        (jnn.gelu_tanh(jnp.asarray(x, jd)),
         tnn.gelu_tanh(torch.as_tensor(x).to(td))),
        (jnn.silu(jnp.asarray(x, jd)), tnn.silu(torch.as_tensor(x).to(td))),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **tol)


def test_rope_and_embeddings_match():
    """Tables from the same float64 numpy math; rotation in fp32."""
    grid, d = (3, 4, 5), 128
    jc, js = jrope.build_rope_3d(d, grid)
    tc, ts = trope.build_rope_3d(d, grid, device="cpu")
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    x = _rand((2, 60, 2, d), 4)
    want = jrope.apply_rope(jnp.asarray(x), jc, js)
    got = trope.apply_rope(torch.as_tensor(x), tc, ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    t = np.array([[999.0, 0.0], [3.0, 0.0]], np.float32)
    np.testing.assert_allclose(
        temb.sinusoidal_embedding_1d(32, torch.as_tensor(t)).numpy(),
        np.asarray(jemb.sinusoidal_embedding_1d(32, jnp.asarray(t))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("solver", ["unipc", "dpm++", "dpm++3"])
def test_solver_steps_match(solver):
    """The same host coefficients; device steps agree to fp32 rounding."""
    steps = 6
    if solver == "unipc":
        sig, ts = jsamp.flow_sigmas(steps, shift=5.0)
        tsig, tts = tsamp.flow_sigmas(steps, shift=5.0)
        np.testing.assert_array_equal(tsig, sig)
        jc = jsamp.precompute_unipc(sig, timesteps=ts)
        tc = tsamp.precompute_unipc(tsig, timesteps=tts)
        jstep, tstep = jsamp.unipc_step, tsamp.unipc_step
    else:
        order = 3 if solver == "dpm++3" else 2
        sig = np.concatenate([jsamp.get_sampling_sigmas(steps, 5.0), [0.0]])
        jc = jsamp.precompute_dpm_solver(sig, solver_order=order)
        tc = tsamp.precompute_dpm_solver(sig, solver_order=order)
        jstep, tstep = jsamp.dpm_step, tsamp.dpm_step
    for f in ("sigma", "has_corr", "corr_a", "corr_mt", "corr_m", "pred_a",
              "pred_m", "timesteps"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))
    x = _rand((1, 2, 3, 4, 4), 5)
    order = jc.pred_m.shape[1]
    js = jsamp.unipc_init_state(jnp.asarray(x), order=order)
    ts_ = tsamp.unipc_init_state(torch.as_tensor(x), order=order)
    arrs = jc.device_arrays()
    for i in range(steps):
        v = _rand(x.shape, 10 + i)
        js = jstep(js, {k: a[i] for k, a in arrs.items()}, jnp.asarray(v))
        ts_ = tstep(ts_, tc.step(i), torch.as_tensor(v))
    np.testing.assert_allclose(ts_["sample"].numpy(),
                               np.asarray(js["sample"]), rtol=1e-5,
                               atol=1e-5)


def test_tma_matches():
    cfg = jcfg.TMAConfig(weight_max=1.5, transition_ratio=0.5)
    tcfg_ = tcfg.TMAConfig(weight_max=1.5, transition_ratio=0.5)
    for sched in ("linear", "cosine", "exponential"):
        a = jtma.tma_schedule_weights(
            dataclasses.replace(cfg, schedule=sched), 10)
        b = ttma.tma_schedule_weights(
            dataclasses.replace(tcfg_, schedule=sched), 10)
        np.testing.assert_array_equal(a, b)
    ctx = _rand((2, 8, 4), 6)
    np.testing.assert_allclose(
        ttma.apply_text_weight(torch.as_tensor(ctx), 1.3, 4).numpy(),
        np.asarray(jtma.apply_text_weight(jnp.asarray(ctx), 1.3, 4)),
        rtol=1e-6)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of univid_tpu_torch (the fusion and packed-training
    slices' included) and chip_smoke.py import without JAX or univid_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import univid_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "assert len(mods) > 20, mods\n"
        "new = {'core.checkpoint', 'models.bagel.bagel', "
        "'models.bagel.qwen2_mot', 'models.bagel.siglip', "
        "'models.bagel.packed', 'data.packed_dataset', "
        "'models.fusion.extractor', 'pipelines.fusion', 'core.mesh', "
        "'parallel', 'parallel.ulysses', 'parallel.ring', "
        "'parallel.sharding'}\n"
        "assert {p.__name__ + '.' + m for m in new} <= set(mods), mods\n"
        "for m in mods + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'univid_tpu' or m.startswith('univid_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
