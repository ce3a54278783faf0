"""Video generation CLI of the PyTorch/CUDA port (T2V / I2V on the Wan
stack, with BAGEL fusion and TMA).

    python -m univid_tpu_torch.cli.inference --model ti2v-5B --mode both \
        --image first_frame.png --mock_weights

Flag-compatible with univid_tpu/cli/inference.py: prompt -> UMT5 (freed
before the DiT is placed), and unless --no_bagel, BAGEL semantic tokens of
the prompt (and the image) -> ContextProjector, whose context replaces
UMT5's -> UniPC / DPM++ flow-matching denoise over the Wan DiT (batch-2
CFG, TMA text weights; i2v clamps the first latent frame to the image's)
or, for the dual-expert models t2v-A14B / i2v-A14B, over two DiTs switched
at the model's timestep boundary (pipelines/moe.py; i2v conditions through
the image's latent and a first-frame mask) -> causal VAE decode -> mp4 + a
JSON sidecar per mode. Runs on `cuda` unless `--device cpu`. The
serving knobs: --bf16_softmax (the attention kernels' softmax chain in
bf16), --qk_int8 (int8 QK^T in self-attention), --int8 (W8A8 DiT GEMMs,
quantized after --use_lora's merge) and --taylorseer N (TaylorSeer step
caching of the CFG velocity, fresh threshold N). --checkpoint_dir loads a
reference Wan checkpoint dir (the DiT's shards, or for A14B the experts'
low_noise_model/ and high_noise_model/, the VAE .pth, UMT5 and its
tokenizer; core/checkpoint.py) and --bagel_path BAGEL's ema.safetensors
and tokenizer for the fusion; --mock_weights draws random weights instead.
Flags of later port slices (animate, prompt extension) exit with an error
naming the slice; they never fall back to another path.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import time
from datetime import datetime

from .common import build_bagel, model_spec

DEFAULT_PROMPT = (
    "A cinematic shot of a corgi running through a sunlit meadow, shallow "
    "depth of field, golden hour lighting, 24fps smooth motion."
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="High-Quality Video Generation with Dynamic Text "
                    "Weight (PyTorch/CUDA port)")
    p.add_argument("--mode", type=str,
                   choices=["t2v", "i2v", "both", "animate"], default="t2v")
    p.add_argument("--image", type=str, default=None)
    p.add_argument("--output_dir", type=str, default="./outputs")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--guidance", type=float, default=5.0)
    p.add_argument("--use_lora", action="store_true")
    p.add_argument("--lora_path", type=str,
                   default="./lora_checkpoints/best")
    p.add_argument("--bagel_strength", type=float, default=1.0)
    p.add_argument("--video_length", type=int, default=None)
    p.add_argument("--video_size", type=str, default="hd",
                   help="'training' (512x320), 'hd' (1280x704) or 'WxH'")
    p.add_argument("--disable_dynamic_weight", action="store_true")
    p.add_argument("--text_weight_max", type=float, default=1.3)
    p.add_argument("--text_weight_min", type=float, default=1.0)
    p.add_argument("--weight_schedule", type=str, default="cosine",
                   choices=["linear", "cosine", "exponential"])
    p.add_argument("--transition_ratio", type=float, default=0.4)
    p.add_argument("--prompt", type=str, default=None)
    p.add_argument("--shift", type=float, default=5.0)
    p.add_argument("--taylorseer", type=int, default=0)
    p.add_argument("--bf16_residual", action="store_true",
                   help="run the DiT residual stream in bf16 (fp32 AdaLN/"
                        "time-embed/softmax islands kept)")
    p.add_argument("--bf16_softmax", action="store_true")
    p.add_argument("--int8", action="store_true")
    p.add_argument("--qk_int8", action="store_true")
    p.add_argument("--bounded_softmax", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="bounded-softmax flash kernel (default on): the "
                        "qk-norm gains bound the raw scores by d * "
                        "max|g_q| * max|g_k|, so the kernel pins the "
                        "softmax reference point there instead of "
                        "tracking a running max (exact)")
    p.add_argument("--solver", type=str, default="unipc",
                   choices=["unipc", "dpm++", "dpm++3"])
    p.add_argument("--model", type=str, default="ti2v-5B")
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--bagel_path", type=str, default=None)
    p.add_argument("--training_state", type=str, default=None)
    p.add_argument("--null_context", type=str, default="bagel",
                   choices=["bagel", "t5", "zeros"])
    p.add_argument("--mock_weights", action="store_true",
                   help="random weights drawn on the device from fixed "
                        "seeds (hermetic run; the code path is the one "
                        "real weights take)")
    p.add_argument("--no_bagel", action="store_true",
                   help="skip BAGEL fusion; pure UMT5 context path")
    p.add_argument("--use_prompt_extend", action="store_true")
    p.add_argument("--prompt_extend_method", default="offline",
                   choices=["dashscope", "local_qwen", "offline"])
    p.add_argument("--prompt_extend_model", default=None)
    p.add_argument("--prompt_extend_target_lang", default="en",
                   choices=["zh", "en"])
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda by default; cpu runs the "
                        "kernels' plain versions)")
    return p


# (is the flag set?, the later port slice that brings it: a ROADMAP.md item)
_LATER = [
    (lambda a: a.mode == "animate",
     "--mode animate is a later slice (ROADMAP.md queue 1: WanAnimate)"),
    (lambda a: a.use_prompt_extend,
     "--use_prompt_extend is a later slice (ROADMAP.md queue 1: prompt "
     "extension)"),
]


def _parse_size(s: str):
    if s == "hd":
        return (1280, 704)
    if s == "training":
        return (512, 320)
    w, h = s.replace("*", "x").split("x")
    return (int(w), int(h))


def build_text_encoder(args, spec):
    """UMT5 on args.device: from --checkpoint_dir (bf16, with the
    checkpoint's tokenizer), else with --mock_weights random (fp32)."""
    import torch

    from ..pipelines.encoders import WanTextEncoder

    dev = torch.device(args.device)
    if args.checkpoint_dir:
        return WanTextEncoder.from_checkpoint(args.checkpoint_dir, spec,
                                              device=dev)
    if args.mock_weights:
        return WanTextEncoder.random_init(
            spec, device=dev, gen=torch.Generator(device=dev).manual_seed(2))
    raise SystemExit("pass --checkpoint_dir or --mock_weights")


def build_pipeline(args, spec):
    """The pipeline of `spec` on args.device: the DiT (two experts for a model
    with a moe_boundary, served by WanMoEPipeline) and the VAE, from
    --checkpoint_dir (the DiT in bf16 with JAX's fp32 leaves, the VAE in
    fp32), else with --mock_weights random (DiT and VAE in bf16, as the JAX
    CLI's mock weights; the experts from seeds 0 and 5); with --use_lora,
    the LoRA of --lora_path merged into each DiT; with --int8, each DiT's
    block GEMMs then quantized to W8A8; the policy takes --bf16_residual,
    --bf16_softmax, --qk_int8, --bounded_softmax."""
    import torch

    from ..core.dtypes import BF16_RESIDUAL_POLICY, DEFAULT_POLICY
    from ..models.wan.dit import WanDiT
    from ..models.wan.vae_api import WanVAE
    from ..pipelines.moe import WanMoEPipeline
    from ..pipelines.ti2v import WanTI2VPipeline

    moe = spec.moe_boundary is not None
    dev = torch.device(args.device)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    if args.checkpoint_dir:
        from ..core.checkpoint import load_wan_checkpoint, \
            load_wan_moe_checkpoint
        if moe:
            dits, vae = load_wan_moe_checkpoint(args.checkpoint_dir, spec,
                                                device=dev)
        else:
            dit, vae = load_wan_checkpoint(args.checkpoint_dir, spec,
                                           device=dev)
            dits = (dit,)
    elif args.mock_weights:
        dits = tuple(WanDiT(spec.dit, dtype=torch.bfloat16, device=dev,
                            gen=gen(s)) for s in ((0, 5) if moe else (0,)))
        vae = WanVAE(spec.vae, dtype=torch.bfloat16, device=dev, gen=gen(1))
    else:
        raise SystemExit("pass --checkpoint_dir or --mock_weights")
    if args.use_lora:
        from ..train.lora import load_lora, merge_lora
        lora, _ = load_lora(args.lora_path, device=dev)
        for dit in dits:
            merged = merge_lora(dit, lora)
            with torch.no_grad():   # merged in place, as the JAX CLI merges
                for name, p in dit.named_parameters():
                    if name in merged:
                        p.copy_(merged[name])
            del merged
    if args.int8:
        # W8A8 after any LoRA merge: quantize the weights the model runs
        from ..core.quant import quantize_dit_w8a8
        for dit in dits:
            quantize_dit_w8a8(dit)
    policy = BF16_RESIDUAL_POLICY if args.bf16_residual else DEFAULT_POLICY
    policy = dataclasses.replace(policy, softmax_bf16=args.bf16_softmax,
                                 qk_int8=args.qk_int8,
                                 bounded_softmax=args.bounded_softmax)
    if moe:
        return WanMoEPipeline(spec, *dits, vae, policy=policy)
    return WanTI2VPipeline(spec, dits[0], vae, policy=policy)


def build_fusion(args, wan_pipe, spec):
    """FusionPipeline (BAGEL extractor + ContextProjector + Wan) or None for
    the UMT5 path (--no_bagel, or a Wan checkpoint without --bagel_path or
    --mock_weights). BAGEL from `build_bagel`; bagel_sequence_length is the
    config's default for BAGEL-7B-MoT and min(64, text_len) for the mock."""
    if args.no_bagel or not (args.bagel_path or args.mock_weights):
        return None

    import torch

    from ..core.config import FusionConfig
    from ..models.fusion.extractor import BagelSemanticExtractor
    from ..models.fusion.projector import init_context_projector
    from ..pipelines.fusion import FusionPipeline

    dev = torch.device(args.device)
    bagel, cfg, scfg, sig, tokenizer, compute_dtype = build_bagel(args, dev)
    mock = args.mock_weights or not args.bagel_path
    seq_len = dict(bagel_sequence_length=min(64, spec.dit.text_len)) \
        if mock else {}
    fusion_cfg = FusionConfig(
        bagel_hidden_dim=cfg.llm.hidden_size,
        wan_text_dim=spec.dit.text_dim,
        wan_text_length=spec.dit.text_len,
        fusion_alpha=args.bagel_strength, **seq_len)
    extractor = BagelSemanticExtractor(
        bagel, cfg, tokenizer, siglip=sig, siglip_cfg=scfg,
        target_len=fusion_cfg.bagel_sequence_length,
        compute_dtype=compute_dtype)
    if args.training_state:
        from ..core.checkpoint import load_projector_checkpoint
        projector = load_projector_checkpoint(args.training_state,
                                              fusion_cfg, device=dev)
    else:
        projector = init_context_projector(
            torch.Generator(device=dev).manual_seed(12), fusion_cfg,
            device=dev)
    return FusionPipeline(wan_pipe, projector, fusion_cfg,
                          bagel_extractor=extractor)


def load_image(path: str):
    """[H, W, 3] fp32 in [-1, 1], as the JAX CLI reads it (no resize: the
    image must already be at --video_size)."""
    import numpy as np
    import torch
    from PIL import Image

    pil = Image.open(path).convert("RGB")
    return torch.as_tensor(np.array(pil), dtype=torch.float32) / 127.5 \
        - 1.0


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..core.debug import apply_debug_flags
    apply_debug_flags()
    for is_set, why in _LATER:
        if is_set(args):
            raise SystemExit(f"not in this port yet: {why}")

    import torch

    from ..core.config import TMAConfig
    from ..data.video_io import save_video
    from ..utils.profiling import PhaseTimer

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run the "
                         "plain versions on the CPU")
    # fp32 products in full fp32, as the JAX package's fp32 parts compute
    # (PyTorch would otherwise run fp32 convolutions in TF32 on the card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.output_dir, exist_ok=True)

    timer = PhaseTimer()
    spec = model_spec(args)
    prompt = args.prompt or DEFAULT_PROMPT
    # the prompt first: UMT5-XXL (fp32 ~23 GB with mock weights) is freed
    # before any DiT is placed, so a request's peak is the DiT(s) and one
    # working set (two A14B experts hold 57 GB)
    text_enc = timer.time_phase("init_weights", build_text_encoder, args,
                                spec)
    ctx_pair = timer.time_phase("text_encode", text_enc,
                                [prompt, spec.sample_neg_prompt])
    ctx, nctx = ctx_pair[0], ctx_pair[1]
    del text_enc, ctx_pair
    gc.collect()
    if ctx.is_cuda:
        torch.cuda.empty_cache()
    pipe = timer.time_phase("init_weights", build_pipeline, args, spec)
    fusion = timer.time_phase("init_weights", build_fusion, args, pipe,
                              spec)
    size = _parse_size(args.video_size)
    frames = args.video_length or spec.generation.frame_num
    tma = TMAConfig(
        enabled=not args.disable_dynamic_weight,
        weight_max=args.text_weight_max, weight_min=args.text_weight_min,
        schedule=args.weight_schedule,
        transition_ratio=args.transition_ratio,
        text_prefix_len=spec.dit.text_len)

    modes = ["t2v", "i2v"] if args.mode == "both" else [args.mode]
    results = []
    for mode in modes:
        img = None
        if mode == "i2v":
            if not args.image:
                print("skipping i2v: no --image", flush=True)
                continue
            img = load_image(args.image)
            if tuple(img.shape[:2]) != (size[1], size[0]):
                raise SystemExit(f"--image is {img.shape[1]}x{img.shape[0]}"
                                 f"; it must be at --video_size {size[0]}x"
                                 f"{size[1]}")
        gen_kwargs = dict(size=size, frame_num=frames, shift=args.shift,
                          sample_solver=args.solver,
                          sampling_steps=args.steps,
                          guide_scale=args.guidance, seed=args.seed,
                          tma=tma, timer=timer,
                          taylorseer_threshold=args.taylorseer)
        t0 = time.time()
        if fusion is not None:
            video = fusion.generate_video_with_bagel_context(
                text=prompt, image=img, t5_context=ctx, t5_context_null=nctx,
                null_context=args.null_context, **gen_kwargs)
        else:
            video = pipe.generate(ctx, nctx, img=img, **gen_kwargs)
        frames_u8 = ((video.clamp(-1.0, 1.0) + 1.0) * 127.5).round() \
            .to(torch.uint8).cpu().numpy()
        dt = time.time() - t0

        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        out = os.path.join(args.output_dir, f"{mode}_{stamp}.mp4")
        path = timer.time_phase("save", save_video, frames_u8, out,
                                fps=spec.generation.fps)
        meta = {
            "prompt": prompt, "mode": mode, "model": args.model,
            "size": list(size), "frames": frames, "steps": args.steps,
            "guidance": args.guidance, "seed": args.seed,
            "solver": args.solver, "tma": dataclasses.asdict(tma),
            "knobs": {"bf16_softmax": args.bf16_softmax,
                      "qk_int8": args.qk_int8, "int8": args.int8,
                      "taylorseer": args.taylorseer},
            "device": str(pipe.device), "generation_time_s": round(dt, 2),
            "phase_times_s": timer.summary(),
            "context_path": "bagel_fusion" if fusion is not None
            else "umt5",
            "video_path": path,
        }
        with open(path + ".json", "w") as f:
            json.dump(meta, f, indent=2)
        print(json.dumps(meta), flush=True)
        results.append(meta)
    return results


if __name__ == "__main__":
    main()
