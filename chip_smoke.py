"""GPU smoke run of the PyTorch/CUDA port (univid_tpu_torch) on one card.

    python3 chip_smoke.py              # build, check kernels, drive t2v-1.3B
    python3 chip_smoke.py --steps 2    # fewer denoise steps
    python3 chip_smoke.py --kernels-only

Phases:
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels (one nvcc per source, in parallel);
  3. hold each kernel against its plain PyTorch version at the main path's
     shapes, time both with CUDA events, and time one PyTorch library call
     (scaled_dot_product_attention) on the same inputs as a yardstick;
  4. hold the port's t2v pipeline on the card (kernels) against the same
     pipeline on the CPU (plain versions) on a small d=128 model;
  5. drive the main path through the port's CLI: t2v-1.3B at 832x480x81,
     full depth and width, random weights from a seed, a few steps; check
     the kernels' launch counts and the mp4.
The last line is {"ok": true, "device": {...}}; any failure exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

H100_BF16_FLOPS = 989e12   # dense tensor-core bf16 (SXM data sheet)
H100_FP32_FLOPS = 67e12    # fp32 on the CUDA cores
H100_BYTES = 3.35e12       # HBM3


def log(msg):
    print(msg, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def cuda_time(fn, iters, warmup=1):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops, nbytes, peak_flops):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / H100_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def qk_normed(shape, gen, dtype):
    """Rows RMS-normalised to norm sqrt(d), as Wan's qk-norm leaves them
    (unit gains), so the bound 1.01 * d holds."""
    import torch
    x = torch.randn(shape, generator=gen, device="cuda")
    x = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6)
    return x.to(dtype)


def check_kernels():
    """Phase 3: each kernel vs its plain version at the main path's shapes.
    Returns the per-kernel records of the `kernels` line."""
    import torch
    import torch.nn.functional as F

    from univid_tpu_torch.kernels import flash_attention as fa
    from univid_tpu_torch.ops.rope import build_rope_3d

    gen = torch.Generator(device="cuda").manual_seed(0)
    records = {}

    def compare(name, got, want, atol, rtol, why):
        err = (got.float() - want.float()).abs()
        max_err = float(err.max())
        lim = atol + rtol * want.float().abs()
        ok = bool((err <= lim).all()) and bool(torch.isfinite(got).all())
        log(json.dumps({"check": name, "max_abs_err": max_err,
                        "max_abs_ref": float(want.float().abs().max()),
                        "atol": atol, "rtol": rtol, "why": why, "ok": ok}))
        if not ok:
            fail(f"{name}: kernel disagrees with its plain version")
        return max_err

    # ---- DiT self-attention: t2v-1.3B at 832x480x81 ----------------------
    b, l, n, d = 2, 32768, 12, 128
    grid = (21, 30, 52)   # latent 21 x 60 x 104, patch (1, 2, 2)
    kv_real = grid[0] * grid[1] * grid[2]   # 32760
    q = qk_normed((b, l, n, d), gen, torch.bfloat16)
    k = qk_normed((b, l, n, d), gen, torch.bfloat16)
    v = torch.randn((b, l, n, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    # padded keys hold large values: a kernel that let them into the
    # softmax or the p @ v product would be far off
    k[:, kv_real:] = 50.0
    v[:, kv_real:] = 50.0
    cos, sin = build_rope_3d(d, grid, device="cuda")
    tabs = fa._pad_tables(fa.build_fused_rope_tables(cos, sin, d), l, l,
                          fa.LOG2E / math.sqrt(d))
    cq, sq, ck, sk = tabs
    kv_len = torch.full((b,), kv_real, dtype=torch.int32, device="cuda")
    sc = fa.LOG2E / math.sqrt(d)
    bound = torch.tensor([1.01 * d * sc], device="cuda")
    tol = dict(atol=1e-3, rtol=2.0 ** -7,
               why="one bf16 ulp of the output (at most 2^-7 relative) "
                   "plus 1e-3 for the fp32 summation order and the "
                   "approximate exp2 before p rounds to bf16")
    with torch.no_grad():
        # rope pre-pass: same fp32 products and sum, one rounding to bf16
        qr = fa._rope_bf16(q, cq, sq)
        kr = fa._rope_bf16(k, ck, sk)
        rope_err = max(
            compare("rope_rotate_bf16 q", qr, fa.rotate(q, cq, sq, q.dtype),
                    atol=0.0, rtol=2.0 ** -7,
                    why="the same fp32 multiplies and add in the same "
                        "order; at most one bf16 ulp apart"),
            compare("rope_rotate_bf16 k", kr, fa.rotate(k, ck, sk, v.dtype),
                    atol=0.0, rtol=2.0 ** -7,
                    why="the same fp32 multiplies and add in the same "
                        "order; at most one bf16 ulp apart"))
        rope_ms = cuda_time(lambda: fa._rope_bf16(q, cq, sq), 5)
        rope_plain_ms = cuda_time(lambda: fa.rotate(q, cq, sq, q.dtype), 3)

        got = fa._flash_cuda(q, k, v, kv_len, bound, tabs)
        want = fa.attention_plain(q, k, v, kv_len=kv_len, bound=bound,
                                  rope_tables=tabs)
        err = compare("flash_attention_bf16 bounded+rope+kv_len", got, want,
                      **tol)
        got_r = fa._flash_cuda(q, k, v, kv_len, None, tabs)
        compare("flash_attention_bf16 running max+rope+kv_len", got_r,
                want, **tol)
        # the attention kernel alone, on the pre-rotated q and k
        ms = cuda_time(lambda: fa._flash_cuda(qr, kr, v, kv_len, bound,
                                              None), 3)
        plain_ms = cuda_time(lambda: fa.attention_plain(
            qr, kr, v, kv_len=kv_len, bound=bound), 1)
        qs, ks, vs = (x.transpose(1, 2) for x in (qr, kr, v))
        ks, vs = ks[:, :, :kv_real], vs[:, :, :kv_real]
        lib_ms = cuda_time(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, scale=1.0 / fa.LOG2E), 3)
    flops = 4 * b * n * l * kv_real * d
    bms, by = bound_ms(flops, nbytes(qr, kr, v, got), H100_BF16_FLOPS)
    records["flash_attention_bf16"] = dict(
        name="flash_attention_bf16", route="cuda",
        source="univid_tpu_torch/kernels/csrc/flash_attention.cu",
        replaces="univid_tpu/kernels/flash_attention.py:44",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=lib_ms)
    # 2 multiplies and an add per element, fp32
    bms, by = bound_ms(3 * q.numel(), nbytes(q, cq, sq, qr), H100_FP32_FLOPS)
    records["rope_rotate_bf16"] = dict(
        name="rope_rotate_bf16", route="cuda",
        source="univid_tpu_torch/kernels/csrc/flash_attention.cu",
        replaces="univid_tpu/kernels/flash_attention.py:157",
        max_abs_err=rope_err, ms=rope_ms, plain_ms=rope_plain_ms,
        bound_ms=bms, bound_by=by, library_ms=None)
    del q, k, v, got, got_r, want, qr, kr, qs, ks, vs

    # ---- DiT cross-attention: 32768 video tokens x 512 text tokens -------
    lk = 512
    q = (qk_normed((b, l, n, d), gen, torch.bfloat16)
         * torch.tensor(sc, dtype=torch.bfloat16, device="cuda"))
    k = qk_normed((b, lk, n, d), gen, torch.bfloat16)
    v = torch.randn((b, lk, n, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    with torch.no_grad():
        got = fa.cross_attention_padded(q, k, v, score_bound=bound)
        want = fa.attention_plain(q, k, v, bound=bound)
        err = compare("cross_attention_bf16 bounded", got, want, **tol)
        kvl = torch.tensor([lk, 100], dtype=torch.int32, device="cuda")
        km, vm = k.clone(), v.clone()   # masked keys hold large values
        km[1, 100:] = 50.0
        vm[1, 100:] = 50.0
        # referenced to the row max, the largest p lie in [0.5, 1], where
        # one bf16 step is 2^-8; l >= 1, so one p that rounds the other way
        # (exp2.approx, summation order) moves an output by <= 2^-8 max|v|
        compare("cross_attention_bf16 one-shot max+kv_len",
                fa.cross_attention_padded(q, km, vm, kv_len=kvl),
                fa.attention_plain(q, km, vm, kv_len=kvl),
                atol=2.0 ** -8 * float(v.float().abs().max()),
                rtol=2.0 ** -7,
                why="one bf16 ulp of the output plus one p in [0.5, 1] "
                    "rounded to the other bf16 neighbour (2^-8 max|v|, "
                    "l >= 1); a leaked masked key (v = 50) is far outside")
        del km, vm
        zero = fa.cross_attention_padded(
            q, k, v, kv_len=torch.tensor([0, lk], dtype=torch.int32,
                                         device="cuda"))
        if float(zero[0].abs().max()) != 0.0:
            fail("cross_attention_bf16: kv_len == 0 rows are not zero")
        ms = cuda_time(lambda: fa.cross_attention_padded(
            q, k, v, score_bound=bound), 5)
        plain_ms = cuda_time(lambda: fa.attention_plain(q, k, v,
                                                        bound=bound), 1)
        qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = cuda_time(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, scale=1.0 / math.log2(math.e)), 5)
    flops = 4 * b * n * l * lk * d
    bms, by = bound_ms(flops, nbytes(q, k, v, got), H100_BF16_FLOPS)
    records["cross_attention_bf16"] = dict(
        name="cross_attention_bf16", route="cuda",
        source="univid_tpu_torch/kernels/csrc/flash_attention.cu",
        replaces="univid_tpu/kernels/flash_attention.py:355",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=lib_ms)
    del q, k, v, got, want, qs, ks, vs

    # ---- VAE mid-block attention: 1 head, d=384, fp32, 60x104 tokens -----
    lv, lv_pad, dv = 60 * 104, 6272, 384
    q, k, v = (torch.randn((1, lv_pad, 1, dv), generator=gen,
                           device="cuda") for _ in range(3))
    q = q * (fa.LOG2E / math.sqrt(dv))     # the wrapper's fold, in fp32
    k[:, lv:] = 50.0                       # padded keys: large values
    v[:, lv:] = 50.0
    kvl = torch.tensor([lv], dtype=torch.int32, device="cuda")
    with torch.no_grad():
        got = fa._flash_cuda(q, k, v, kvl, None, None)
        want = fa.attention_plain(q, k, v, kv_len=kvl)
        err = compare("flash_attention_f32 running max+kv_len", got, want,
                      atol=1e-5, rtol=1e-4,
                      why="fp32 throughout; summation order and the "
                          "approximate exp2 (2^-22 relative)")
        ms = cuda_time(lambda: fa._flash_cuda(q, k, v, kvl, None, None), 5)
        plain_ms = cuda_time(lambda: fa.attention_plain(q, k, v,
                                                        kv_len=kvl), 1)
        qs, ks, vs = (x.transpose(1, 2)[:, :, :lv] for x in (q, k, v))
        try:
            lib_ms = cuda_time(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, scale=1.0 / math.log2(math.e)), 5)
        except RuntimeError as e:  # no SDPA backend for this shape
            log(f"library_ms for flash_attention_f32: {e}")
            lib_ms = None
    flops = 4 * lv_pad * lv * dv
    bms, by = bound_ms(flops, nbytes(q, k, v, got), H100_FP32_FLOPS)
    records["flash_attention_f32"] = dict(
        name="flash_attention_f32", route="cuda",
        source="univid_tpu_torch/kernels/csrc/flash_attention_f32.cu",
        replaces="univid_tpu/kernels/flash_attention.py:44",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=lib_ms)
    for r in records.values():
        log(json.dumps({"kernel": r}))
    return records


def small_parity():
    """Phase 4: the port's t2v pipeline on the card (kernels) against the
    same pipeline on the CPU (plain versions), same weights and noise, on a
    2-layer d=128 DiT with the t2v-1.3B VAE (d=384 mid-block attention)."""
    import copy

    import numpy as np
    import torch

    from univid_tpu_torch.core.config import (WAN_CONFIGS, WanDiTConfig,
                                              WanModelSpec)
    from univid_tpu_torch.core.dtypes import DEFAULT_POLICY
    from univid_tpu_torch.kernels import flash_attention as fa
    from univid_tpu_torch.models.wan.dit import WanDiT
    from univid_tpu_torch.models.wan.vae_api import WanVAE, vae_decode
    from univid_tpu_torch.pipelines.ti2v import WanT2VPipeline
    import dataclasses

    base = WAN_CONFIGS["t2v-1.3B"]
    dit_cfg = WanDiTConfig(model_type="t2v", in_dim=16, out_dim=16, dim=256,
                           ffn_dim=512, freq_dim=32, text_dim=64,
                           num_heads=2, num_layers=2, text_len=32)
    spec = WanModelSpec(name="smoke-d128", dit=dit_cfg, vae=base.vae,
                        generation=base.generation)
    gen = torch.Generator().manual_seed(0)
    dit = WanDiT(dit_cfg, dtype=torch.bfloat16, device="cpu", gen=gen)
    # non-zero head and non-unit qk gains so the output and the bounds move
    with torch.no_grad():
        dit.head.head.w.normal_(0.0, 0.05, generator=gen)
        for blk in dit.blocks:
            for a in (blk.self_attn, blk.cross_attn):
                a.norm_q.uniform_(0.5, 1.5, generator=gen)
                a.norm_k.uniform_(0.5, 1.5, generator=gen)
    vae = WanVAE(base.vae, dtype=torch.bfloat16, device="cpu", gen=gen)
    policy = dataclasses.replace(DEFAULT_POLICY, bounded_softmax=True)
    rng = np.random.default_rng(0)
    # 64x64x9 frames: latent 3 x 8 x 8 -> 48 tokens (padded to 64, kv_len)
    noise = torch.as_tensor(rng.standard_normal((1, 3, 8, 8, 16)),
                            dtype=torch.float32)
    ctx = torch.as_tensor(rng.standard_normal((1, 32, 64)) * 0.5,
                          dtype=torch.float32)
    nctx = torch.as_tensor(rng.standard_normal((1, 32, 64)) * 0.5,
                           dtype=torch.float32)

    def run(device):
        d, v = copy.deepcopy(dit).to(device), copy.deepcopy(vae).to(device)
        pipe = WanT2VPipeline(spec, d, v, policy=policy)
        fn = pipe.denoise_fn((3, 8, 8), 48, 4, 5.0, 5.0, "unipc", None)
        x0 = fn(d, noise.to(device), ctx.to(device), nctx.to(device),
                torch.zeros_like(noise).to(device))
        return x0.float().cpu(), vae_decode(v, x0).float().cpu()

    fa.reset_launches()
    x_gpu, v_gpu = run("cuda")
    used = dict(fa.LAUNCHES)
    x_cpu, v_cpu = run("cpu")
    for name in used:
        if used[name] == 0:
            fail(f"small parity run did not launch {name}")

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-12))

    out = {"check": "small_parity", "latent_rel_l2": rel(x_gpu, x_cpu),
           "video_rel_l2": rel(v_gpu, v_cpu), "limit": 3e-2,
           "why": "bf16 compute policy: cuBLAS and the CPU round each GEMM "
                  "at other points (2^-8 relative), over 2 blocks x 4 steps",
           "launches": used,
           "finite": bool(torch.isfinite(v_gpu).all())}
    out["ok"] = (out["finite"] and out["latent_rel_l2"] < 3e-2
                 and out["video_rel_l2"] < 3e-2)
    log(json.dumps(out))
    if not out["ok"]:
        fail("the port on the card disagrees with its CPU reference")


def main_path(steps, output_dir):
    """Phase 5: t2v-1.3B at 832x480x81 through the port's CLI; returns the
    kernels' launch counts of that run."""
    import torch

    from univid_tpu_torch.cli import inference
    from univid_tpu_torch.data.video_io import read_video_frames
    from univid_tpu_torch.kernels import flash_attention as fa

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.perf_counter()
    meta = inference.main([
        "--mode", "t2v", "--no_bagel", "--mock_weights", "--model",
        "t2v-1.3B", "--video_size", "832x480", "--video_length", "81",
        "--steps", str(steps), "--seed", "0", "--output_dir", output_dir])[0]
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    expected = {"flash_attention_bf16": 30 * steps,
                "cross_attention_bf16": 30 * steps,
                "flash_attention_f32": 21,
                "rope_rotate_bf16": 60 * steps}   # q and k per self-attn
    frames = read_video_frames(meta["video_path"])
    log(json.dumps({
        "phase": "main_path", "seconds": wall,
        "phase_times_s": meta["phase_times_s"],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "expected_launches": expected,
        "frames": len(frames),
        "frame_shape": list(frames[0].shape) if frames else None}))
    if launches != expected:
        fail(f"launch counts {launches} != {expected}")
    if len(frames) != 81 or frames[0].shape != (480, 832, 3):
        fail("the mp4 is not 81 frames of 480x832")
    return launches


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--kernels-only", action="store_true")
    ap.add_argument("--output_dir", default="smoke_out")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs the GPU")
    try:
        from univid_tpu_torch.kernels import build
        from univid_tpu_torch.kernels import flash_attention as fa
    except ImportError as e:
        fail(f"the port is not importable from here: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log(f"card: {card}")
    t0 = time.perf_counter()
    times = build.build_all()
    log(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                    "per_source_s": times}))
    for name, text in build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    t0 = time.perf_counter()
    records = check_kernels()
    log(json.dumps({"phase": "kernel_checks",
                    "seconds": time.perf_counter() - t0}))

    launches = {name: None for name in records}
    if not args.kernels_only:
        t0 = time.perf_counter()
        small_parity()
        log(json.dumps({"phase": "small_parity",
                        "seconds": time.perf_counter() - t0}))
        launches = main_path(args.steps, args.output_dir)
    kernels = [dict(records[nm], launches=launches[nm]) for nm in records]
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
