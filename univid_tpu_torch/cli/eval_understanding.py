"""Video QA evaluation CLI: Pyramid Reflection over a video directory.

Counterpart of univid_tpu/cli/eval_understanding.py, with the same flags,
traces and summary: per video id, reflexion_answer_one on its question,
`video{ID}_reflexion.json` traces and an `{output_name}.json` summary.

    python -m univid_tpu_torch.cli.eval_understanding --video_dir DIR \\
        --gt_file DIR/gt.json --output_dir OUT --output_name batch1 \\
        --id_from 1 --id_to 1 --mock_weights --device cpu

It runs on `cuda` unless given `--device cpu`. `--model_path` (without
`--mock_weights`) loads BAGEL-7B-MoT's ema.safetensors and its tokenizer
(core.checkpoint.load_bagel_checkpoint) and runs it in bf16; otherwise
`--mock_weights` (and the run without `--model_path`) builds the JAX CLI's
tiny random BAGEL and SigLIP tower and a HashTokenizer, drawn from fixed
seeds, fp32 with `--mock_weights` and bf16 without. A `--siglip_ckpt`
directory is loaded by its config.json's `model_type`: `siglip2`, the
NaFlex scorer (reflection/naflex.py, the reference's default
google/siglip2-base-patch16-naflex), anything else the fixed-resolution
Siglip2Scorer; where the directory has no tokenizer (or `transformers` is
missing), the scorer takes the LM's tokenizer with a warning, as the JAX
CLI does. Any other `--siglip_ckpt` gives the random-init scorer. Without
an API key the judge and the reflector are the offline no-ops.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("UniVid video QA with Pyramid Reflection "
                                "(PyTorch / CUDA)")
    p.add_argument("--video_dir", required=True)
    p.add_argument("--gt_file", required=True,
                   help="JSON with entries: video_id, question, answer")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--output_name", required=True)
    p.add_argument("--id_from", type=int, required=True)
    p.add_argument("--id_to", type=int, required=True)
    p.add_argument("--model_path", default=None,
                   help="BAGEL checkpoint dir (omit with --mock_weights)")
    p.add_argument("--siglip_ckpt",
                   default="google/siglip2-base-patch16-naflex")
    p.add_argument("--static_seq", default="4,8,16")
    p.add_argument("--dynamic_seq", default="64,32,16")
    p.add_argument("--pool_frames", type=int, default=64)
    p.add_argument("--siglip_bs", type=int, default=64)
    p.add_argument("--save_frames_root", default="sample_frames")
    p.add_argument("--deepseek_api_key",
                   default=os.getenv("DEEPSEEK_API_KEY", ""))
    p.add_argument("--max_think_token_n", type=int, default=512)
    p.add_argument("--do_sample", action="store_true")
    p.add_argument("--temperature", type=float, default=0.3)
    p.add_argument("--video_exts", nargs="*",
                   default=[".mp4", ".avi", ".mov", ".mkv"])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--mock_weights", action="store_true",
                   help="Random-init models (hermetic smoke run)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    # accepted for compatibility, no effect: the reference's torchrun DDP
    # ranker and accelerate offload knobs (the scorer runs in process)
    p.add_argument("--no_ddp_ranker", action="store_true",
                   help="(no-op: the ranker is always in-process)")
    p.add_argument("--ddp_ranker", default=None,
                   help="(no-op; kept for compatibility)")
    p.add_argument("--nproc", type=int, default=4,
                   help="(no-op; kept for compatibility)")
    p.add_argument("--max_mem_per_gpu", default=None,
                   help="(no-op; kept for compatibility)")
    p.add_argument("--offload_folder", default=None,
                   help="(no-op; kept for compatibility)")
    p.add_argument("--print_plan", action="store_true",
                   help="(No-op) kept for compatibility")
    return p


def find_video_by_id(video_dir: str, vid: int, exts):
    base = f"video{vid}"
    for ext in exts:
        p = Path(video_dir) / f"{base}{ext}"
        if p.exists():
            return str(p.resolve())
    return None


def mock_models(device):
    """The JAX CLI's hermetic configuration: a 2-layer BAGEL (hidden 64, 4
    heads over 2 kv heads, head dim 16), a 2-layer SigLIP (hidden 32, patch
    14, 224 px) and HashTokenizer(4090), random from seeds 0 and 1.
    Returns (bagel, cfg, siglip cfg, siglip, tokenizer)."""
    import torch

    from ..models.bagel.bagel import BagelConfig, init_bagel
    from ..models.bagel.qwen2_mot import Qwen2MoTConfig
    from ..models.bagel.siglip import SiglipConfig, init_siglip
    from ..utils.tokenizers import HashTokenizer

    llm = Qwen2MoTConfig(vocab_size=4096, hidden_size=64,
                         intermediate_size=128, num_layers=2, num_heads=4,
                         num_kv_heads=2)
    cfg = BagelConfig(llm=llm, vit_hidden_size=32, vit_patch_size=14,
                      start_of_image=4090, end_of_image=4091,
                      bos_token_id=4092, eos_token_id=4093)
    scfg = SiglipConfig(hidden_size=32, intermediate_size=64, num_layers=2,
                        num_heads=2, patch_size=14, image_size=224)
    dev = torch.device(device)
    params = init_bagel(torch.Generator(device=dev).manual_seed(0), cfg,
                        device=dev)
    sig = init_siglip(torch.Generator(device=dev).manual_seed(1), scfg,
                      device=dev)
    return params, cfg, scfg, sig, HashTokenizer(vocab_size=4090)


def load_scorer(args, tokenizer):
    """A --siglip_ckpt directory by its config.json's model_type (siglip2:
    the NaFlex tower), falling back to the LM's tokenizer with a warning
    where the checkpoint's own cannot be loaded; else the random-init
    Siglip2Scorer."""
    from ..reflection.scorer import Siglip2Scorer

    if not os.path.isdir(args.siglip_ckpt):
        if not args.mock_weights:
            print(f"WARNING: --siglip_ckpt '{args.siglip_ckpt}' is not a "
                  "local checkpoint directory; using a RANDOM-init SigLIP "
                  "scorer — frame-relevance ranking will be noise.",
                  file=sys.stderr)
        return Siglip2Scorer(tokenizer=tokenizer, device=args.device)
    model_type = ""
    cfg_json = os.path.join(args.siglip_ckpt, "config.json")
    if os.path.exists(cfg_json):
        with open(cfg_json) as f:
            model_type = json.load(f).get("model_type", "")
    cls = Siglip2Scorer
    if model_type == "siglip2":
        from ..reflection.naflex import Siglip2NaflexScorer
        cls = Siglip2NaflexScorer
    try:
        return cls.from_checkpoint(args.siglip_ckpt, device=args.device)
    except RuntimeError as e:
        # a checkpoint dir without tokenizer files: the embeddings stay
        # the checkpoint's, only the text tokenization differs from the
        # shipped AutoProcessor (from_checkpoint raised before placing
        # any weight, so the weights are loaded once)
        print(f"WARNING: {e}; using the LM tokenizer for the SigLIP text "
              "tower", file=sys.stderr)
        return cls.from_checkpoint(args.siglip_ckpt, tokenizer=tokenizer,
                                   device=args.device)


def load_models(args):
    """(inferencer, scorer) of the run."""
    import torch

    from ..pipelines.interleave import InterleaveInferencer

    if args.model_path and not args.mock_weights:
        from ..core.checkpoint import load_bagel_checkpoint
        params, cfg, scfg, sig, tokenizer = load_bagel_checkpoint(
            args.model_path, device=args.device)
        inferencer = InterleaveInferencer(params, cfg, tokenizer,
                                          siglip=sig, siglip_cfg=scfg,
                                          compute_dtype=torch.bfloat16)
    else:
        params, cfg, scfg, sig, tokenizer = mock_models(args.device)
        inferencer = InterleaveInferencer(
            params, cfg, tokenizer, siglip=sig, siglip_cfg=scfg,
            compute_dtype=torch.float32 if args.mock_weights
            else torch.bfloat16)
    return inferencer, load_scorer(args, tokenizer)


def main(argv=None):
    args = build_parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)

    from ..reflection.clients import make_reflection_clients
    from ..reflection.reflexion import ReflexionConfig, reflexion_answer_one

    with open(args.gt_file) as f:
        gt = json.load(f)
    gt_by_id = {int(e["video_id"]): e for e in gt}

    bagel, scorer = load_models(args)
    ds_client, qwen_client = make_reflection_clients(args.deepseek_api_key)
    cfg = ReflexionConfig(
        pool_frames=args.pool_frames,
        static_seq=tuple(int(x) for x in args.static_seq.split(",")),
        dynamic_seq=tuple(int(x) for x in args.dynamic_seq.split(",")),
        max_think_token_n=args.max_think_token_n,
        do_sample=args.do_sample, temperature=args.temperature,
        siglip_bs=args.siglip_bs,
        save_frames_root=args.save_frames_root)

    results = []
    for vid in range(args.id_from, args.id_to + 1):
        entry = gt_by_id.get(vid)
        if entry is None:
            continue
        path = find_video_by_id(args.video_dir, vid, args.video_exts)
        if path is None:
            results.append({"video_id": vid, "error": "video_not_found"})
            continue
        answer, trace = reflexion_answer_one(
            path, entry["question"], bagel, ds_client, qwen_client,
            scorer, cfg)
        trace_path = os.path.join(args.output_dir,
                                  f"video{vid}_reflexion.json")
        with open(trace_path, "w") as f:
            json.dump(trace, f, indent=2, ensure_ascii=False)
        rec = {"video_id": vid, "question": entry["question"],
               "answer": answer, "gt": entry.get("answer"),
               "trace": trace_path}
        results.append(rec)
        print(json.dumps(rec, ensure_ascii=False))

    summary = {
        "num_samples": len(results),
        "results": results,
    }
    with open(os.path.join(args.output_dir,
                           f"{args.output_name}.json"), "w") as f:
        json.dump(summary, f, indent=2, ensure_ascii=False)
    return summary


if __name__ == "__main__":
    main()
