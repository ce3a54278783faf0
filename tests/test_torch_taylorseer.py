"""TaylorSeer step caching (--taylorseer): the port's ops/taylorseer.py and
the denoise loop's hook against univid_tpu's.

The schedule is host bookkeeping and equals JAX's array for array; the
factor update and the prediction are the same fp32 operations in the same
order, equal to 1e-7 relative. Through the pipeline (tiny config, fp32
policy, the same numpy noise and context): threshold 1 makes every step
full and equals the loop without TaylorSeer exactly; threshold 3 over 10
UniPC steps matches JAX's loop to 1e-4 (the fp32 summation order of the
DiT, accumulated over 10 steps and extrapolated, as
tests/test_torch_pipeline.py holds the plain loop).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import np_params
from univid_tpu.core.config import TMAConfig as JTMA
from univid_tpu.core.config import WAN_CONFIGS as JCONFIGS
from univid_tpu.core.dtypes import FP32_POLICY as J_FP32
from univid_tpu.models.wan.dit import init_wan_dit
from univid_tpu.ops import taylorseer as jts
from univid_tpu.pipelines.ti2v import WanTI2VPipeline as JPipeline
from univid_tpu_torch import convert
from univid_tpu_torch.core.config import TMAConfig, WAN_CONFIGS
from univid_tpu_torch.core.dtypes import FP32_POLICY
from univid_tpu_torch.ops import taylorseer as tts
from univid_tpu_torch.pipelines.ti2v import WanTI2VPipeline, padded_seq_len

torch.set_num_threads(2)


@pytest.mark.parametrize("steps,threshold", [(8, 2), (10, 3), (50, 2),
                                             (50, 3)])
def test_schedule_matches_jax(steps, threshold):
    got = tts.taylorseer_schedule(
        steps, tts.TaylorSeerConfig(fresh_threshold=threshold))
    want = jts.taylorseer_schedule(
        steps, jts.TaylorSeerConfig(fresh_threshold=threshold))
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    full = np.flatnonzero(got["is_full"])
    if (steps, threshold) == (8, 2):
        assert full.tolist() == [0, 1, 2, 3, 4, 6]
    if steps == 50:
        assert len(full) == {2: 27, 3: 20}[threshold]


def test_update_and_predict_match_jax():
    """Five full-step updates of a [7, 2, 3, 4, 5] stack with the (10, 3)
    schedule's dd and n_upd, and the prediction at each Taylor step: equal
    to JAX's to 1e-7 relative."""
    sched = jts.taylorseer_schedule(10, jts.TaylorSeerConfig())
    shape = (2, 3, 4, 5)
    jf = jts.init_taylor_cache(shape)
    tf = tts.init_taylor_cache(shape, device="cpu")
    rng = np.random.default_rng(0)
    for step in range(10):
        if sched["is_full"][step]:
            feat = rng.standard_normal(shape).astype(np.float32)
            jf = jts.taylor_update(jf, jnp.asarray(feat),
                                   jnp.asarray(sched["dd"][step]),
                                   jnp.asarray(sched["n_upd"][step]))
            tf = tts.taylor_update(tf, torch.as_tensor(feat),
                                   sched["dd"][step], sched["n_upd"][step])
            np.testing.assert_allclose(tf.numpy(), np.asarray(jf),
                                       rtol=1e-7, atol=0)
        else:
            want = jts.taylor_predict(jf, jnp.asarray(sched["x"][step]),
                                      jnp.asarray(sched["n_stored"][step]))
            got = tts.taylor_predict(tf, sched["x"][step],
                                     sched["n_stored"][step])
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-7, atol=1e-7)
    assert int(np.count_nonzero(tf.numpy().reshape(7, -1).any(-1))) == 3


def _tiny_case(seed):
    jspec, tspec = JCONFIGS["tiny"], WAN_CONFIGS["tiny"]
    dit_p = np_params(init_wan_dit, jspec.dit, 0, stacked=True)
    rng = np.random.default_rng(seed)
    f, h, w, c = 3, 4, 4, 4   # latent_shape(tiny, 64, 64, 9)
    noise = rng.standard_normal((1, f, h, w, c)).astype(np.float32)
    ctx = (rng.standard_normal((1, 16, 64)) * 0.5).astype(np.float32)
    nctx = (rng.standard_normal((1, 16, 64)) * 0.5).astype(np.float32)
    seq_len = padded_seq_len(tspec, (64, 64), 9)
    return jspec, tspec, dit_p, (f, h, w), seq_len, noise, ctx, nctx


def _port_run(tspec, dit_p, grid, seq_len, steps, noise, ctx, nctx, ts):
    dit = convert.dit_from_jax(dit_p, tspec.dit, device="cpu")
    pipe = WanTI2VPipeline(tspec, dit, None, policy=FP32_POLICY)
    run = pipe.denoise_fn(grid, seq_len, steps, 5.0, 5.0, "unipc",
                          TMAConfig(enabled=True, weight_max=1.3,
                                    text_prefix_len=16),
                          taylorseer_threshold=ts)
    return run(dit, torch.as_tensor(noise), torch.as_tensor(ctx),
               torch.as_tensor(nctx), torch.zeros(noise.shape))


def test_threshold_1_equals_no_taylorseer():
    """Threshold 1: every step full, so the loop (with its factor updates)
    gives exactly the latent of the loop without TaylorSeer."""
    _, tspec, dit_p, grid, seq_len, noise, ctx, nctx = _tiny_case(3)
    plain = _port_run(tspec, dit_p, grid, seq_len, 6, noise, ctx, nctx, 0)
    ts1 = _port_run(tspec, dit_p, grid, seq_len, 6, noise, ctx, nctx, 1)
    assert torch.equal(plain, ts1)


def test_threshold_3_matches_jax_pipeline():
    """Threshold 3 over 10 steps (7 full DiT steps, 3 Taylor steps): the
    port's loop vs JAX's _denoise_fn, latents to 1e-4; and the Taylor
    steps really change the result (vs threshold 0)."""
    jspec, tspec, dit_p, grid, seq_len, noise, ctx, nctx = _tiny_case(4)
    tma = dict(enabled=True, weight_max=1.3, text_prefix_len=16)
    jpipe = JPipeline(jspec, dit_p, None, policy=J_FP32, dispatch_steps=0)
    tma_key = tuple(sorted(dataclasses.asdict(JTMA(**tma)).items()))
    jx = jpipe._denoise_fn(grid, seq_len, 10, 5.0, 5.0, "unipc", False,
                           tma_key, 3)(
        dit_p, jnp.asarray(noise), jnp.asarray(ctx), jnp.asarray(nctx),
        jnp.zeros(noise.shape, jnp.float32))
    tx = _port_run(tspec, dit_p, grid, seq_len, 10, noise, ctx, nctx, 3)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-4,
                               atol=1e-4)
    plain = _port_run(tspec, dit_p, grid, seq_len, 10, noise, ctx, nctx, 0)
    assert float((plain - tx).abs().max()) > 1e-3
