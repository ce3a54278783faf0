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
--use_prompt_extend rewrites the prompt first (utils/prompt_extend.py:
'offline' returns it unchanged, 'dashscope' without DASH_API_KEY falls back
to it, 'local_qwen' reads --prompt_extend_model).

    python -m univid_tpu_torch.cli.inference --mode animate \
        --model animate-14B --src_root_path <dir> --mock_weights

--mode animate (`run_animate`) animates, or with --replace_flag replaces,
the character of src_ref.png along src_pose.mp4 and src_face.mp4 (+
src_bg.mp4 and src_mask.mp4), the preprocess's output dir: UMT5 encodes
the prompt and is freed, then WanAnimate-14B (or --model tiny-animate),
the Wan2.1 VAE and the CLIP ViT-H tower generate clip by clip
(pipelines/animate.py) -> one mp4 + its sidecar.
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
    p.add_argument("--src_root_path", type=str, default=None,
                   help="animate: the dir of src_pose.mp4, src_face.mp4 and "
                        "src_ref.png (+ src_bg.mp4 and src_mask.mp4 with "
                        "--replace_flag)")
    p.add_argument("--replace_flag", action="store_true",
                   help="animate: character replacement (background and "
                        "mask conditioning)")
    p.add_argument("--refert_num", type=int, default=1, choices=[1, 5],
                   help="animate: temporal-guidance overlap frames between "
                        "clips")
    p.add_argument("--clip_len", type=int, default=77)
    p.add_argument("--use_relighting_lora", action="store_true")
    p.add_argument("--relight_lora_path", type=str, default=None)
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


def encode_prompts(args, spec, prompts, timer):
    """UMT5 contexts of `prompts` ([text_len, dim] each) on args.device. The
    encoder (fp32 ~23 GB with mock weights) is freed before anything else is
    placed, so a request's peak is its DiT(s) and one working set."""
    import torch

    text_enc = timer.time_phase("init_weights", build_text_encoder, args,
                                spec)
    ctx = list(timer.time_phase("text_encode", text_enc, prompts))
    del text_enc
    gc.collect()
    if ctx[0].is_cuda:
        torch.cuda.empty_cache()
    return ctx


def extend_prompt(args, prompt: str) -> str:
    """With --use_prompt_extend, the expander of --prompt_extend_method
    rewrites the prompt (as the JAX CLI: the model's task prompt, the
    image for i2v with a VL expander, --seed); the prompt itself if the
    expander fails or the flag is off."""
    if not args.use_prompt_extend:
        return prompt
    from ..utils.prompt_extend import make_prompt_expander
    expander = make_prompt_expander(
        args.prompt_extend_method, task=args.model,
        is_vl=args.mode != "t2v" and args.image is not None,
        model_name=args.prompt_extend_model)
    ext = expander(prompt, tar_lang=args.prompt_extend_target_lang,
                   image=args.image if expander.is_vl else None,
                   seed=args.seed)
    return ext.prompt if ext.status else prompt


def load_animate_inputs(root: str, replace: bool, motion_size: int):
    """The preprocess dir's inputs as fp32 numpy in [-1, 1]: (pose [T, H,
    W, 3], face [T, S, S, 3], ref [H, W, 3], bg [T, H, W, 3] or None, mask
    [T, H, W] in {0, 1} or None). The reference image is resized to the
    pose size and the faces to motion_size, both by jax.image.resize's
    antialiased 'bilinear' (ops.resize), as the JAX CLI does."""
    import numpy as np
    import torch
    from PIL import Image

    from ..data.video_io import read_video_frames
    from ..ops.resize import resize

    def vid(name):
        frames = np.stack(read_video_frames(os.path.join(root, name)))
        return frames.astype(np.float32) / 127.5 - 1.0

    cond = vid("src_pose.mp4")
    face = vid("src_face.mp4")
    ref = np.asarray(Image.open(os.path.join(root, "src_ref.png"))
                     .convert("RGB"), np.float32) / 127.5 - 1.0
    bg = mask = None
    if replace:
        bg = vid("src_bg.mp4")
        mask = (vid("src_mask.mp4").mean(axis=-1) > 0.0).astype(np.float32)
    if ref.shape[:2] != cond.shape[1:3]:
        ref = resize(torch.as_tensor(ref), cond.shape[1:3] + (3,),
                     "bilinear").numpy()
    if face.shape[1:3] != (motion_size, motion_size):
        face = resize(torch.as_tensor(face),
                      (face.shape[0], motion_size, motion_size, 3),
                      "bilinear").numpy()
    return cond, face, ref, bg, mask


def animate_t5_spec(args, acfg):
    """The UMT5 spec of --mode animate: UMT5-XXL from --checkpoint_dir,
    else the JAX CLI's small mock (vocab 512, 2 layers at the DiT's text
    width)."""
    import types

    from ..core.config import T5Config

    t5 = T5Config(text_len=acfg.text_len) if not args.mock_weights \
        else T5Config(vocab_size=512, dim=acfg.text_dim,
                      dim_attn=acfg.text_dim, dim_ffn=2 * acfg.text_dim,
                      num_heads=4, num_layers=2, text_len=acfg.text_len)
    return types.SimpleNamespace(t5=t5)


def build_animate(args, acfg, vae_cfg, clip_cfg):
    """(WanAnimate, WanVAE, ClipVision) on args.device: from
    --checkpoint_dir (load_wan_animate_checkpoint; a dir without the CLIP
    file exits), else with --mock_weights drawn from seeds in the loader's
    dtypes (the DiT and CLIP in bf16 with fp32 islands, the VAE in fp32)."""
    import torch

    from ..models.wan.animate import ClipVision, WanAnimate
    from ..models.wan.vae_api import WanVAE

    dev = torch.device(args.device)
    if args.checkpoint_dir:
        from ..core.checkpoint import load_wan_animate_checkpoint
        model, vae, clip = load_wan_animate_checkpoint(
            args.checkpoint_dir, acfg, vae_cfg, clip_cfg, device=dev)
        if clip is None:
            raise SystemExit("no CLIP checkpoint in --checkpoint_dir "
                             "(models_clip_open-clip-xlm-roberta-large-"
                             "vit-huge-14.pth)")
        return model, vae, clip
    if not args.mock_weights:
        raise SystemExit("pass --checkpoint_dir or --mock_weights")

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    return (WanAnimate(acfg, dtype=torch.bfloat16, device=dev, gen=gen(0)),
            WanVAE(vae_cfg, dtype=torch.float32, device=dev, gen=gen(1)),
            ClipVision(clip_cfg, dtype=torch.bfloat16, device=dev,
                       gen=gen(3)))


def run_animate(args):
    """--mode animate: character animation (or, with --replace_flag,
    replacement) from the preprocess output dir, clip by clip; one mp4 and
    a sidecar with the JAX CLI's keys. --model tiny-animate or animate-14B
    (any other name: animate-14B, as the JAX CLI). Of the serving knobs
    only --bf16_residual and --bf16_softmax reach the policy, as in the
    JAX CLI (the animate DiT keeps its residual in fp32 either way)."""
    from ..core.config import ANIMATE_CONFIGS, DEFAULT_NEG_PROMPT
    from ..core.dtypes import BF16_RESIDUAL_POLICY, DEFAULT_POLICY
    from ..data.video_io import save_video
    from ..pipelines.animate import WanAnimatePipeline
    from ..utils.profiling import PhaseTimer, trace

    if not args.src_root_path:
        raise SystemExit("--mode animate needs --src_root_path (the "
                         "preprocess_animate output dir)")
    model_name = args.model if args.model in ANIMATE_CONFIGS \
        else "animate-14B"
    acfg, vae_cfg, clip_cfg = ANIMATE_CONFIGS[model_name]()
    cond, face, ref, bg, mask = load_animate_inputs(
        args.src_root_path, args.replace_flag, acfg.motion_size)
    timer = PhaseTimer()
    prompt = args.prompt or DEFAULT_PROMPT
    ctx, nctx = encode_prompts(args, animate_t5_spec(args, acfg),
                               [prompt, DEFAULT_NEG_PROMPT], timer)
    model, vae, clip = timer.time_phase("init_weights", build_animate, args,
                                        acfg, vae_cfg, clip_cfg)
    policy = BF16_RESIDUAL_POLICY if args.bf16_residual else DEFAULT_POLICY
    policy = dataclasses.replace(policy, softmax_bf16=args.bf16_softmax)
    relight = args.relight_lora_path if args.use_relighting_lora else None
    pipe = WanAnimatePipeline(acfg, model, vae_cfg, vae, clip_cfg=clip_cfg,
                              clip=clip, policy=policy, relight_lora=relight)

    t0 = time.time()
    with trace("generate"):
        video = timer.time_phase(
            "generate", pipe.generate, ctx, nctx, cond_video=cond,
            face_video=face, ref_image=ref, bg_video=bg, mask_video=mask,
            clip_len=args.clip_len, refert_num=args.refert_num,
            shift=args.shift, sample_solver=args.solver,
            sampling_steps=args.steps, guide_scale=args.guidance,
            seed=args.seed, timer=timer)
    dt = time.time() - t0

    stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    out = os.path.join(args.output_dir, f"animate_{stamp}.mp4")
    path = timer.time_phase("save", save_video, video.cpu().numpy(), out,
                            fps=30)
    meta = {
        "prompt": prompt, "mode": "animate", "model": model_name,
        "frames": int(video.shape[0]),
        "size": [int(video.shape[2]), int(video.shape[1])],
        "steps": args.steps, "guidance": args.guidance,
        "seed": args.seed, "replace": bool(args.replace_flag),
        "refert_num": args.refert_num, "clip_len": args.clip_len,
        "generation_time_s": round(dt, 2),
        "phase_times_s": timer.summary(), "video_path": path,
    }
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=2)
    print(json.dumps(meta), flush=True)
    return [meta]


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..core.debug import apply_debug_flags
    apply_debug_flags()

    import torch

    from ..core.config import TMAConfig
    from ..data.video_io import save_video
    from ..utils.profiling import PhaseTimer, trace

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run the "
                         "plain versions on the CPU")
    # fp32 products in full fp32, as the JAX package's fp32 parts compute
    # (PyTorch would otherwise run fp32 convolutions in TF32 on the card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.output_dir, exist_ok=True)

    if args.mode == "animate":
        return run_animate(args)
    timer = PhaseTimer()
    spec = model_spec(args)
    prompt = extend_prompt(args, args.prompt or DEFAULT_PROMPT)
    ctx, nctx = encode_prompts(args, spec, [prompt, spec.sample_neg_prompt],
                               timer)
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
        with trace("generate"):
            if fusion is not None:
                video = fusion.generate_video_with_bagel_context(
                    text=prompt, image=img, t5_context=ctx,
                    t5_context_null=nctx, null_context=args.null_context,
                    **gen_kwargs)
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
