"""Adapter / LoRA training CLI of the PyTorch/CUDA port.

    python -m univid_tpu_torch.cli.train --video_dir DIR --csv_file CSV \
        --mock_weights --train_lora

Flag-compatible with univid_tpu/cli/train.py (reference model_pipeline.py
main() -> train_cross_attention_fusion, :3618-3723), plus --device: an
OpenVid directory and CSV (data/openvid.py) feed the semantic-alignment
objective (the ContextProjector against UMT5 features of the caption) or,
with --objective diffusion or --train_lora, the velocity MSE through the
LoRA-merged Wan DiT of --model on VAE latents of the clip; OneCycle or
cosine schedule, periodic and best checkpoints (`latest/`, `best/`, the
best adapter as `lora_best/` in the save_lora format), resume from
`latest/`, 200 steps by default. Runs on `cuda` unless `--device cpu`.

--mock_weights draws random weights from fixed seeds instead of loading
them: JAX's tiny BAGEL and SigLIP (cli/common.build_bagel), the DiT of
--model at full width in fp32 with its zero head redrawn normal(0, 0.02)
(without that every gradient is zero), the VAE in fp32, and UMT5 at the
spec's width. From checkpoints: --checkpoint_dir (the Wan DiT and VAE for
the diffusion objective, UMT5 and its tokenizer for the semantic one) and
--bagel_path (BAGEL's ema.safetensors and tokenizer; only the extractor's
parts reach the device). UMT5 is built only for the semantic objective,
the one that reads its features (JAX builds it for both).
"""

from __future__ import annotations

import argparse
import json
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("UniVid cross-attention fusion training "
                                "(PyTorch/CUDA port)")
    p.add_argument("--video_dir", default=os.getenv("OPENVID_VIDEO_PATH",
                                                    "data/openvid/videos"))
    p.add_argument("--csv_file", default=os.getenv("OPENVID_CSV",
                                                   "data/openvid.csv"))
    p.add_argument("--output_dir", default="./training_output")
    p.add_argument("--max_steps", type=int, default=200)
    p.add_argument("--save_interval", type=int, default=50)
    p.add_argument("--log_interval", type=int, default=10)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--no_one_cycle", action="store_true")
    p.add_argument("--objective", default="semantic",
                   choices=["semantic", "diffusion"],
                   help="semantic = projector alignment vs UMT5 "
                        "(model_pipeline.py:3328-3373); diffusion = "
                        "velocity MSE through the LoRA-merged DiT "
                        "(:2765-3142)")
    p.add_argument("--train_lora", action="store_true",
                   help="train Wan DiT LoRA — implies "
                        "--objective diffusion (the semantic loss never "
                        "reaches the LoRA leaves)")
    p.add_argument("--lora_rank", type=int, default=16)
    p.add_argument("--lora_strategy", default="wan_cross_attention")
    p.add_argument("--no_resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model", default="ti2v-5B")
    p.add_argument("--checkpoint_dir", default=None,
                   help="Wan checkpoint dir (UMT5 supervision features; "
                        "the DiT and VAE of the diffusion objective)")
    p.add_argument("--bagel_path", default=None)
    p.add_argument("--mock_weights", action="store_true")
    p.add_argument("--max_samples", type=int, default=1000)
    p.add_argument("--video_size", default="512x320")
    p.add_argument("--video_length", type=int, default=21)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda by default; cpu runs the "
                        "kernels' plain versions)")
    return p


def build_diffusion(args, spec, size, device):
    """{'spec', 'dit', 'vae', 'latent_grid'} of the diffusion objective:
    load_wan_checkpoint from --checkpoint_dir (without --mock_weights),
    else JAX's mock: the DiT and the VAE in fp32 from seeds 20 and 21, the
    DiT's zero head redrawn normal(0, 0.02) from seed 22."""
    import torch

    from ..core.config import latent_shape

    if args.checkpoint_dir and not args.mock_weights:
        from ..core.checkpoint import load_wan_checkpoint
        dit, vae = load_wan_checkpoint(args.checkpoint_dir, spec,
                                       device=device)
    else:
        from ..models.wan.dit import WanDiT
        from ..models.wan.vae_api import WanVAE

        def gen(seed):
            return torch.Generator(device=device).manual_seed(seed)

        dit = WanDiT(spec.dit, dtype=torch.float32, device=device,
                     gen=gen(20))
        # a fresh DiT's head is zero (reference init parity), which blocks
        # every gradient: mock runs need live weights
        with torch.no_grad():
            dit.head.head.w.normal_(0.0, 0.02, generator=gen(22))
        vae = WanVAE(spec.vae, dtype=torch.float32, device=device,
                     gen=gen(21))
    w, h = size
    _, f, hh, ww = latent_shape(spec, w, h, args.video_length)
    return {"spec": spec, "dit": dit, "vae": vae, "latent_grid": (f, hh, ww)}


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..core.debug import apply_debug_flags
    apply_debug_flags()

    import torch

    from ..core.config import FusionConfig
    from ..data.openvid import OpenVidConfig, OpenVidDataset
    from ..models.fusion.extractor import BagelSemanticExtractor
    from ..train.fusion_trainer import (FusionTrainConfig,
                                        train_cross_attention_fusion)
    from ..train.lora import LoRAConfig
    from .common import build_bagel, model_spec

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run the "
                         "plain versions on the CPU")
    # fp32 products in full fp32, as the JAX package's fp32 parts compute
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.output_dir, exist_ok=True)
    spec = model_spec(args)
    dev = torch.device(args.device)

    # ---- dataset (before any weight: an empty dir exits at once) -------
    w, h = (int(v) for v in args.video_size.split("x"))
    dataset = OpenVidDataset(OpenVidConfig(
        video_base_path=args.video_dir, csv_file=args.csv_file,
        video_size=(w, h), video_length=args.video_length,
        max_samples=args.max_samples))
    if len(dataset) == 0:
        raise SystemExit(f"no samples under {args.video_dir}")
    objective = "diffusion" if args.train_lora else args.objective

    # ---- supervision encoder (UMT5, semantic objective) + BAGEL --------
    t5_supervision = None
    if objective == "semantic":
        from ..pipelines.encoders import WanTextEncoder
        if args.checkpoint_dir and not args.mock_weights:
            text_enc = WanTextEncoder.from_checkpoint(args.checkpoint_dir,
                                                      spec, device=dev)
        else:
            text_enc = WanTextEncoder.random_init(
                spec, device=dev,
                gen=torch.Generator(device=dev).manual_seed(0))

        def t5_supervision(caption: str):
            return text_enc([caption])[0]

    bagel, cfg, scfg, sig, tokenizer, compute_dtype = build_bagel(args, dev)
    fusion_cfg = FusionConfig(
        bagel_hidden_dim=cfg.llm.hidden_size,
        wan_text_dim=spec.dit.text_dim,
        wan_text_length=spec.dit.text_len,
        bagel_sequence_length=min(256, spec.dit.text_len))
    extractor = BagelSemanticExtractor(
        bagel, cfg, tokenizer, siglip=sig, siglip_cfg=scfg,
        target_len=fusion_cfg.bagel_sequence_length,
        compute_dtype=compute_dtype)

    train_cfg = FusionTrainConfig(
        learning_rate=args.learning_rate,
        use_one_cycle_lr=not args.no_one_cycle,
        max_steps=args.max_steps, save_interval=args.save_interval,
        log_interval=args.log_interval, train_lora=args.train_lora)
    diffusion = build_diffusion(args, spec, (w, h), dev) \
        if objective == "diffusion" else None

    out = train_cross_attention_fusion(
        dataset, extractor.extract_semantic_tokens, t5_supervision,
        fusion_cfg, train_cfg, args.output_dir, seed=args.seed,
        resume=not args.no_resume,
        dit_cfg=spec.dit if args.train_lora else None,
        lora_cfg=LoRAConfig(rank=args.lora_rank,
                            target_strategy=args.lora_strategy),
        diffusion=diffusion, log=lambda s: print(s, flush=True),
        device=dev)
    summary = {"steps": out["steps"], "best_loss": out["best_loss"],
               "output_dir": args.output_dir}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
