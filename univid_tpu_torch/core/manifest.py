"""Checkpoint key + shape manifests and the strict ingestion audit
(counterpart of univid_tpu/core/manifest.py).

  * generators of the exact source state-dict key -> shape map that each
    converter of core/checkpoint.py reads, in the reference's torch
    naming (Linear.weight [out, in], ConvNd.weight [out, in, k...]): the
    Wan DiT, the Wan video VAE, the UMT5 encoder, the Qwen2-MoT LLM with
    BAGEL's heads and NaViT tower, and the SigLIP / SigLIP2 (NaFlex)
    dual towers;
  * `audit_keys(sd, manifest)`: a checkpoint's keys and shapes against a
    manifest, before any conversion;
  * `RecordingDict` + `audited`: run a converter while recording which
    source keys it read, and fail on leftovers (the strict mode);
  * JSON save / load of the pinned manifests under manifests/.

The SAM2, FLUX, T5-HF and CLIP generators come with their models.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Mapping, Tuple

Shape = Tuple[int, ...]
Manifest = Dict[str, Shape]


# ---------------------------------------------------------------------------
# strict-mode plumbing
# ---------------------------------------------------------------------------


class RecordingDict(Mapping):
    """Read-through wrapper over a state dict recording key reads.

    Membership probes (`k in sd`) intentionally do NOT count as
    consumption — converters use them to branch on optional leaves
    (e.g. `_lin`'s bias probe); only actual value reads do."""

    def __init__(self, sd: Mapping):
        self._sd = sd
        self.consumed = set()

    def __getitem__(self, k):
        self.consumed.add(k)
        return self._sd[k]

    def __contains__(self, k):
        return k in self._sd

    def __iter__(self):
        return iter(self._sd)

    def __len__(self):
        return len(self._sd)


def audited(sd: Mapping, convert_fn, *, ignore: Iterable[str] = (),
            strict: bool = True):
    """Run `convert_fn(recording_sd)`; in strict mode raise if any
    source key was never consumed (ignoring exact-match `ignore` keys
    and dotted prefixes ending in '.')."""
    rec = RecordingDict(sd)
    params = convert_fn(rec)
    leftover = sorted(set(sd) - rec.consumed)
    ignored = []
    for k in list(leftover):
        for ig in ignore:
            if k == ig or (ig.endswith(".") and k.startswith(ig)):
                ignored.append(k)
                break
    leftover = [k for k in leftover if k not in set(ignored)]
    if leftover and strict:
        raise ValueError(
            f"{len(leftover)} checkpoint keys were not consumed by the "
            f"converter (first 10: {leftover[:10]}) — renamed/new keys "
            "in the source checkpoint would silently random-init; pass "
            "strict=False to downgrade to a warning")
    if leftover:
        import warnings
        warnings.warn(f"unconsumed checkpoint keys: {leftover[:10]}"
                      f"{'...' if len(leftover) > 10 else ''}")
    return params, leftover


def audit_keys(sd: Mapping, manifest: Manifest) -> Dict[str, List[str]]:
    """Checkpoint-vs-manifest diff: returns {'missing': keys the
    manifest expects but the checkpoint lacks, 'unexpected': checkpoint
    keys the manifest doesn't know, 'shape_mismatch': 'key: got vs
    want' strings}."""
    missing = sorted(set(manifest) - set(sd))
    unexpected = sorted(set(sd) - set(manifest))
    mismatch = []
    for k, want in manifest.items():
        if k in sd:
            got = tuple(getattr(sd[k], "shape", ()))
            if tuple(want) != got:
                mismatch.append(f"{k}: {got} vs {tuple(want)}")
    return {"missing": missing, "unexpected": unexpected,
            "shape_mismatch": sorted(mismatch)}


def assert_checkpoint_matches(sd: Mapping, manifest: Manifest,
                              name: str = "checkpoint") -> None:
    diff = audit_keys(sd, manifest)
    problems = {k: v for k, v in diff.items() if v}
    if problems:
        head = {k: v[:5] for k, v in problems.items()}
        raise ValueError(f"{name} does not match its manifest: "
                         f"counts={ {k: len(v) for k, v in problems.items()} } "
                         f"first entries={head}")


def save_manifest(path: str, manifest: Manifest) -> None:
    with open(path, "w") as fh:
        json.dump({k: list(v) for k, v in sorted(manifest.items())},
                  fh, indent=0)


def load_manifest(path: str) -> Manifest:
    with open(path) as fh:
        return {k: tuple(v) for k, v in json.load(fh).items()}


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------


def _linear(m: Manifest, key: str, din: int, dout: int,
            bias: bool = True) -> None:
    m[f"{key}.weight"] = (dout, din)
    if bias:
        m[f"{key}.bias"] = (dout,)


def wan_dit_manifest(cfg) -> Manifest:
    """WanModel (reference model.py:294-408; torch naming)."""
    m: Manifest = {}
    d = cfg.dim
    pt, ph, pw = cfg.patch_size
    m["patch_embedding.weight"] = (d, cfg.in_dim, pt, ph, pw)
    m["patch_embedding.bias"] = (d,)
    _linear(m, "text_embedding.0", cfg.text_dim, d)
    _linear(m, "text_embedding.2", d, d)
    _linear(m, "time_embedding.0", cfg.freq_dim, d)
    _linear(m, "time_embedding.2", d, d)
    _linear(m, "time_projection.1", d, 6 * d)
    _linear(m, "head.head", d, pt * ph * pw * cfg.out_dim)
    m["head.modulation"] = (1, 2, d)
    for i in range(cfg.num_layers):
        b = f"blocks.{i}"
        for attn in ("self_attn", "cross_attn"):
            for proj in "qkvo":
                _linear(m, f"{b}.{attn}.{proj}", d, d)
            if cfg.qk_norm:
                m[f"{b}.{attn}.norm_q.weight"] = (d,)
                m[f"{b}.{attn}.norm_k.weight"] = (d,)
        _linear(m, f"{b}.ffn.0", d, cfg.ffn_dim)
        _linear(m, f"{b}.ffn.2", cfg.ffn_dim, d)
        m[f"{b}.modulation"] = (1, 6, d)
        if cfg.cross_attn_norm:
            m[f"{b}.norm3.weight"] = (d,)
            m[f"{b}.norm3.bias"] = (d,)
    return m


def _conv3d(m: Manifest, key: str, cin: int, cout: int,
            k: Tuple[int, int, int]) -> None:
    m[f"{key}.weight"] = (cout, cin) + k
    m[f"{key}.bias"] = (cout,)


def _vae_res_block(m: Manifest, prefix: str, cin: int, cout: int) -> None:
    """ResidualBlock (vae2_2.py:193-235): RMS_norm gammas are
    (dim, 1, 1, 1) with images=False."""
    m[f"{prefix}.residual.0.gamma"] = (cin, 1, 1, 1)
    _conv3d(m, f"{prefix}.residual.2", cin, cout, (3, 3, 3))
    m[f"{prefix}.residual.3.gamma"] = (cout, 1, 1, 1)
    _conv3d(m, f"{prefix}.residual.6", cout, cout, (3, 3, 3))
    if cin != cout:
        _conv3d(m, f"{prefix}.shortcut", cin, cout, (1, 1, 1))


def _vae_attn_block(m: Manifest, prefix: str, c: int) -> None:
    m[f"{prefix}.norm.gamma"] = (c, 1, 1)
    m[f"{prefix}.to_qkv.weight"] = (3 * c, c, 1, 1)
    m[f"{prefix}.to_qkv.bias"] = (3 * c,)
    m[f"{prefix}.proj.weight"] = (c, c, 1, 1)
    m[f"{prefix}.proj.bias"] = (c,)


def wan_vae_manifest(cfg) -> Manifest:
    """WanVAE_ (reference vae2_2.py:500-898)."""
    m: Manifest = {}
    in_ch = 3 * cfg.spatial_patch ** 2
    enc_dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
    dec_dims = [cfg.dec_dim * u for u in
                (cfg.dim_mult[-1],) + tuple(cfg.dim_mult)[::-1]]
    z2 = cfg.z_dim * 2
    n_levels = len(cfg.dim_mult)

    _conv3d(m, "encoder.conv1", in_ch, enc_dims[0], (3, 3, 3))
    for i in range(n_levels):
        cin, cout = enc_dims[i], enc_dims[i + 1]
        base = f"encoder.downsamples.{i}.downsamples"
        for j in range(cfg.num_res_blocks):
            _vae_res_block(m, f"{base}.{j}", cin if j == 0 else cout,
                           cout)
        if i != n_levels - 1:
            r = f"{base}.{cfg.num_res_blocks}"
            # Resample down: [ZeroPad2d, Conv2d(dim, dim, 3, stride 2)]
            m[f"{r}.resample.1.weight"] = (cout, cout, 3, 3)
            m[f"{r}.resample.1.bias"] = (cout,)
            t_down = cfg.temporal_downsample[i] if i < len(
                cfg.temporal_downsample) else False
            if t_down:
                _conv3d(m, f"{r}.time_conv", cout, cout, (3, 1, 1))
    c_mid = enc_dims[-1]
    _vae_res_block(m, "encoder.middle.0", c_mid, c_mid)
    _vae_attn_block(m, "encoder.middle.1", c_mid)
    _vae_res_block(m, "encoder.middle.2", c_mid, c_mid)
    m["encoder.head.0.gamma"] = (c_mid, 1, 1, 1)
    _conv3d(m, "encoder.head.2", c_mid, z2, (3, 3, 3))

    _conv3d(m, "decoder.conv1", cfg.z_dim, dec_dims[0], (3, 3, 3))
    _vae_res_block(m, "decoder.middle.0", dec_dims[0], dec_dims[0])
    _vae_attn_block(m, "decoder.middle.1", dec_dims[0])
    _vae_res_block(m, "decoder.middle.2", dec_dims[0], dec_dims[0])
    ups = tuple(reversed(tuple(cfg.temporal_downsample)))
    for i in range(n_levels):
        cin, cout = dec_dims[i], dec_dims[i + 1]
        base = f"decoder.upsamples.{i}.upsamples"
        for j in range(cfg.num_res_blocks + 1):
            _vae_res_block(m, f"{base}.{j}", cin if j == 0 else cout,
                           cout)
        if i != n_levels - 1:
            r = f"{base}.{cfg.num_res_blocks + 1}"
            # Resample up: [Upsample, Conv2d(dim, dim, 3)]
            m[f"{r}.resample.1.weight"] = (cout, cout, 3, 3)
            m[f"{r}.resample.1.bias"] = (cout,)
            t_up = ups[i] if i < len(ups) else False
            if t_up:
                _conv3d(m, f"{r}.time_conv", cout, 2 * cout, (3, 1, 1))
    m["decoder.head.0.gamma"] = (dec_dims[-1], 1, 1, 1)
    _conv3d(m, "decoder.head.2", dec_dims[-1], in_ch, (3, 3, 3))

    _conv3d(m, "conv1", z2, z2, (1, 1, 1))
    _conv3d(m, "conv2", cfg.z_dim, cfg.z_dim, (1, 1, 1))
    return m


def umt5_manifest(cfg) -> Manifest:
    """T5Encoder (reference t5.py:456-513; bias-free linears,
    per-layer relative position embeddings)."""
    m: Manifest = {
        "token_embedding.weight": (cfg.vocab_size, cfg.dim),
        "norm.weight": (cfg.dim,),
    }
    for i in range(cfg.num_layers):
        b = f"blocks.{i}"
        m[f"{b}.norm1.weight"] = (cfg.dim,)
        for proj in "qkv":
            m[f"{b}.attn.{proj}.weight"] = (cfg.dim_attn, cfg.dim)
        m[f"{b}.attn.o.weight"] = (cfg.dim, cfg.dim_attn)
        m[f"{b}.pos_embedding.embedding.weight"] = (cfg.num_buckets,
                                                    cfg.num_heads)
        m[f"{b}.norm2.weight"] = (cfg.dim,)
        m[f"{b}.ffn.gate.0.weight"] = (cfg.dim_ffn, cfg.dim)
        m[f"{b}.ffn.fc1.weight"] = (cfg.dim_ffn, cfg.dim)
        m[f"{b}.ffn.fc2.weight"] = (cfg.dim, cfg.dim_ffn)
    return m


def bagel_llm_manifest(cfg, prefix: str = "language_model.model"
                       ) -> Manifest:
    """Qwen2-MoT (reference qwen2_navit.py:943-1092 naming; MoT twins
    carry the _moe_gen suffix)."""
    m: Manifest = {}
    d = cfg.hidden_size
    hd = cfg.head_dim
    qd, kvd = cfg.num_heads * hd, cfg.num_kv_heads * hd

    def attn_set(b: str, suffix: str) -> None:
        _linear(m, f"{b}.q_proj{suffix}", d, qd)
        _linear(m, f"{b}.k_proj{suffix}", d, kvd)
        _linear(m, f"{b}.v_proj{suffix}", d, kvd)
        _linear(m, f"{b}.o_proj{suffix}", qd, d, bias=False)
        if cfg.qk_norm:
            nq = "q_norm_moe_gen" if suffix else "q_norm"
            nk = "k_norm_moe_gen" if suffix else "k_norm"
            m[f"{b}.{nq}.weight"] = (hd,)
            m[f"{b}.{nk}.weight"] = (hd,)

    def mlp_set(b: str) -> None:
        _linear(m, f"{b}.gate_proj", d, cfg.intermediate_size,
                bias=False)
        _linear(m, f"{b}.up_proj", d, cfg.intermediate_size, bias=False)
        _linear(m, f"{b}.down_proj", cfg.intermediate_size, d,
                bias=False)

    m[f"{prefix}.embed_tokens.weight"] = (cfg.vocab_size, d)
    for i in range(cfg.num_layers):
        b = f"{prefix}.layers.{i}"
        m[f"{b}.input_layernorm.weight"] = (d,)
        attn_set(f"{b}.self_attn", "")
        m[f"{b}.post_attention_layernorm.weight"] = (d,)
        mlp_set(f"{b}.mlp")
        if cfg.moe:
            m[f"{b}.input_layernorm_moe_gen.weight"] = (d,)
            attn_set(f"{b}.self_attn", "_moe_gen")
            m[f"{b}.post_attention_layernorm_moe_gen.weight"] = (d,)
            mlp_set(f"{b}.mlp_moe_gen")
    m[f"{prefix}.norm.weight"] = (d,)
    if cfg.moe:
        m[f"{prefix}.norm_moe_gen.weight"] = (d,)
    _linear(m, "language_model.lm_head", d, cfg.vocab_size, bias=False)
    return m


def siglip_vision_manifest(cfg, prefix: str = "vision_model",
                           conv_patch: bool = True) -> Manifest:
    """SiglipVisionTransformer encoder (HF naming)."""
    m: Manifest = {}
    d = cfg.hidden_size
    if conv_patch:
        m[f"{prefix}.embeddings.patch_embedding.weight"] = (
            d, cfg.num_channels, cfg.patch_size, cfg.patch_size)
    else:
        m[f"{prefix}.embeddings.patch_embedding.weight"] = (
            d, cfg.num_channels * cfg.patch_size ** 2)
    m[f"{prefix}.embeddings.patch_embedding.bias"] = (d,)
    m[f"{prefix}.embeddings.position_embedding.weight"] = (
        cfg.num_patches_per_side ** 2, d)
    for i in range(cfg.num_layers):
        b = f"{prefix}.encoder.layers.{i}"
        m[f"{b}.layer_norm1.weight"] = (d,)
        m[f"{b}.layer_norm1.bias"] = (d,)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(m, f"{b}.self_attn.{proj}", d, d)
        m[f"{b}.layer_norm2.weight"] = (d,)
        m[f"{b}.layer_norm2.bias"] = (d,)
        _linear(m, f"{b}.mlp.fc1", d, cfg.intermediate_size)
        _linear(m, f"{b}.mlp.fc2", cfg.intermediate_size, d)
    m[f"{prefix}.post_layernorm.weight"] = (d,)
    m[f"{prefix}.post_layernorm.bias"] = (d,)
    return m


def siglip2_manifest(vision_cfg, text_cfg) -> Manifest:
    """Full HF SigLIP/SigLIP2 dual tower: vision encoder + MAP head +
    text tower + logit scalars (what load_siglip2_checkpoint reads)."""
    m = siglip_vision_manifest(vision_cfg, "vision_model")
    d = vision_cfg.hidden_size
    m["vision_model.head.probe"] = (1, 1, d)
    m["vision_model.head.attention.in_proj_weight"] = (3 * d, d)
    m["vision_model.head.attention.in_proj_bias"] = (3 * d,)
    _linear(m, "vision_model.head.attention.out_proj", d, d)
    m["vision_model.head.layernorm.weight"] = (d,)
    m["vision_model.head.layernorm.bias"] = (d,)
    _linear(m, "vision_model.head.mlp.fc1", d,
            vision_cfg.intermediate_size)
    _linear(m, "vision_model.head.mlp.fc2",
            vision_cfg.intermediate_size, d)

    t = text_cfg.hidden_size
    m["text_model.embeddings.token_embedding.weight"] = (
        text_cfg.vocab_size, t)
    m["text_model.embeddings.position_embedding.weight"] = (
        text_cfg.max_len, t)
    for i in range(text_cfg.num_layers):
        b = f"text_model.encoder.layers.{i}"
        m[f"{b}.layer_norm1.weight"] = (t,)
        m[f"{b}.layer_norm1.bias"] = (t,)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(m, f"{b}.self_attn.{proj}", t, t)
        m[f"{b}.layer_norm2.weight"] = (t,)
        m[f"{b}.layer_norm2.bias"] = (t,)
        _linear(m, f"{b}.mlp.fc1", t, text_cfg.intermediate_size)
        _linear(m, f"{b}.mlp.fc2", text_cfg.intermediate_size, t)
    m["text_model.final_layer_norm.weight"] = (t,)
    m["text_model.final_layer_norm.bias"] = (t,)
    _linear(m, "text_model.head", t, text_cfg.proj_dim)
    m["logit_scale"] = ()
    m["logit_bias"] = ()
    return m


def siglip2_naflex_manifest(vision_cfg, text_cfg) -> Manifest:
    """HF Siglip2Model (NaFlex) dual tower — the reference's DEFAULT
    frame scorer, google/siglip2-base-patch16-naflex
    (eval_understanding.py:42). Differs from siglip2_manifest only in the
    vision embedding: a Linear patch embedding over (h, w, c)-flattened
    patches and a square pos grid of num_patches entries
    (what reflection.naflex.convert_naflex_checkpoint reads)."""
    m = siglip2_manifest(vision_cfg, text_cfg)
    d = vision_cfg.hidden_size
    m["vision_model.embeddings.patch_embedding.weight"] = (
        d, vision_cfg.num_channels * vision_cfg.patch_size ** 2)
    m["vision_model.embeddings.position_embedding.weight"] = (
        vision_cfg.num_patches, d)
    return m


def bagel_manifest(llm_cfg, vit_cfg=None) -> Manifest:
    """Full BAGEL ema.safetensors surface: LLM + fusion heads + the
    NaViT SigLIP tower (what load_bagel_checkpoint reads)."""
    m = bagel_llm_manifest(llm_cfg)
    d = llm_cfg.hidden_size
    # time embedder MLP (modeling_utils.py:74-110), vae bridges +
    # learned pos embeds (bagel.py:74-78), ViT connector
    _linear(m, "time_embedder.mlp.0", 256, d)
    _linear(m, "time_embedder.mlp.2", d, d)
    _linear(m, "vae2llm", 64, d)
    _linear(m, "llm2vae", d, 64)
    m["latent_pos_embed.pos_embed"] = (4096, d)
    if vit_cfg is not None:
        _linear(m, "connector.fc1", vit_cfg.hidden_size, d)
        _linear(m, "connector.fc2", d, d)
        m["vit_pos_embed.pos_embed"] = (4900, d)
        m.update(siglip_vision_manifest(
            vit_cfg, "vit_model.vision_model", conv_patch=False))
    return m
