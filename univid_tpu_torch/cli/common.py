"""Model construction shared by the port's CLIs (inference and train):
the Wan spec of --model and BAGEL's extractor parts."""

from __future__ import annotations


def model_spec(args):
    """The WanModelSpec of --model; an unknown name exits."""
    from ..core.config import WAN_CONFIGS

    if args.model not in WAN_CONFIGS:
        raise SystemExit(f"--model {args.model}: the port has "
                         f"{sorted(WAN_CONFIGS)}")
    return WAN_CONFIGS[args.model]


def build_bagel(args, device):
    """BAGEL's extractor parts on `device` -> (bagel, cfg, siglip cfg,
    siglip, tokenizer, compute dtype). --bagel_path (without --mock_weights)
    loads BAGEL-7B-MoT with only the LLM's embed_tokens placed
    (`llm_layers=False`: the extractor reads nothing else); otherwise the
    JAX CLIs' mock BAGEL: a tiny random LLM embedding (hidden 64) and SigLIP
    tower (hidden 32, 2 layers, 224 px). Computed in fp32 under
    --mock_weights, else in bf16, as the JAX CLIs choose it (so the JAX
    training CLI's mock BAGEL beside a Wan --checkpoint_dir runs in bf16)."""
    import torch

    compute_dtype = torch.float32 if args.mock_weights else torch.bfloat16
    if args.bagel_path and not args.mock_weights:
        from ..core.checkpoint import load_bagel_checkpoint
        bagel, cfg, scfg, sig, tokenizer = load_bagel_checkpoint(
            args.bagel_path, device=device, llm_layers=False)
        return bagel, cfg, scfg, sig, tokenizer, compute_dtype

    from ..models.bagel.bagel import BagelConfig, init_bagel
    from ..models.bagel.qwen2_mot import Qwen2MoTConfig
    from ..models.bagel.siglip import SiglipConfig, init_siglip
    from ..utils.tokenizers import HashTokenizer

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    llm = Qwen2MoTConfig(vocab_size=4096, hidden_size=64,
                         intermediate_size=128, num_layers=2,
                         num_heads=4, num_kv_heads=2)
    cfg = BagelConfig(llm=llm, vit_hidden_size=32, vit_patch_size=14,
                      start_of_image=4090, end_of_image=4091,
                      bos_token_id=4092, eos_token_id=4093)
    scfg = SiglipConfig(hidden_size=32, intermediate_size=64,
                        num_layers=2, num_heads=2, patch_size=14,
                        image_size=224)
    bagel = init_bagel(gen(10), cfg, device=device, llm_layers=False)
    sig = init_siglip(gen(11), scfg, device=device)
    return bagel, cfg, scfg, sig, HashTokenizer(vocab_size=4090), \
        compute_dtype
