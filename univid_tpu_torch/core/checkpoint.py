"""Checkpoint ingestion: the reference's torch files -> the port's modules
(counterpart of univid_tpu/core/checkpoint.py).

Load surfaces: the Wan DiT (diffusers-style sharded safetensors with a
*.safetensors.index.json, or .pth), the Wan video VAE and UMT5 (raw torch
.pth state dicts), the WanAnimate DiT and its CLIP ViT-H visual tower,
BAGEL's ema.safetensors (the Qwen2-MoT LLM, its heads and the NaViT SigLIP
tower), the HF SigLIP / SigLIP2 dual tower, BAGEL's FLUX image VAE
(ae.safetensors), the FLUX.1-Kontext editor's directory (the BFL
transformer, the AE, HF's T5-XXL v1.1 and CLIP-L text towers), and the
ContextProjector of a training state.

Raw loading gives CPU tensors in the file's dtype (the JAX package widens
bf16 to fp32 numpy; the values are equal). Safetensors are read here, not
through the `safetensors` package: an 8-byte little-endian header length,
a JSON header of dtype / shape / data_offsets (offsets from the end of the
header; an optional `__metadata__`), then the raw bytes, viewed as tensors
of a private memory map. Torch files load with `torch.load(weights_only=
True, mmap=True)`. Neither reads a tensor before it is used.

Each converter goes from the reference's state dict straight to the port's
module, with the JAX converter's leaf dtypes and the port's layouts (a
linear [out, in] as in torch, a conv3d [Cout, Cin, kt, kh, kw], a 2-D conv
[Cout, Cin, 1, kh, kw]). A tensor is cast, laid out and made contiguous on
the target device, then assigned to its parameter of a module built on the
meta device: a module holds fp32 and bf16 leaves side by side, nothing is
drawn at random, and a memory-mapped file is never written. Converters
read the state dict only by indexing, so `manifest.audited` sees every key
they consume.
"""

from __future__ import annotations

import json
import math
import mmap
import os
import struct
from typing import Dict

import numpy as np
import torch

from .config import FusionConfig, T5Config, WanDiTConfig, WanModelSpec, \
    WanVAEConfig

# ---------------------------------------------------------------------------
# loading raw state dicts
# ---------------------------------------------------------------------------

_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32,
              "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def _find_index_json(path: str):
    """HF / diffusers sharded-checkpoint index (model.safetensors.index.json
    etc.) in a checkpoint dir, or None."""
    for fname in sorted(os.listdir(path)):
        if fname.endswith(".safetensors.index.json"):
            return os.path.join(path, fname)
    return None


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A .safetensors file, a directory of them (sharded or not) or a torch
    .pth -> {key: CPU tensor in the file's dtype}.

    A directory with a *.safetensors.index.json reads exactly the shard
    files its weight_map names, and every mapped key must be there: a
    half-downloaded checkpoint raises instead of loading in part."""
    if os.path.isdir(path):
        idx = _find_index_json(path)
        if idx is not None:
            with open(idx) as fh:
                weight_map = json.load(fh)["weight_map"]
            out = {}
            for fname in sorted(set(weight_map.values())):
                out.update(_load_safetensors(os.path.join(path, fname)))
            missing = sorted(set(weight_map) - set(out))
            if missing:
                raise ValueError(
                    f"sharded checkpoint {path}: {len(missing)} keys in "
                    f"the index are absent from the shards, first: "
                    f"{missing[:5]}")
            return out
        out = {}
        for fname in sorted(os.listdir(path)):
            if fname.endswith(".safetensors"):
                out.update(_load_safetensors(os.path.join(path, fname)))
        if out:
            return out
        for fname in sorted(os.listdir(path)):
            if fname.endswith((".pth", ".pt", ".bin")):
                out.update(_load_torch(os.path.join(path, fname)))
        return out
    if path.endswith(".safetensors"):
        return _load_safetensors(path)
    return _load_torch(path)


def _read_header(fh):
    (n,) = struct.unpack("<Q", fh.read(8))
    return n, json.loads(fh.read(n))


def read_safetensors_header(path: str) -> Dict[str, tuple]:
    """{key: (dtype_str, shape)} from a .safetensors header, reading no
    tensor data: the audit of a multi-GB checkpoint takes milliseconds."""
    with open(path, "rb") as fh:
        _, header = _read_header(fh)
    return {k: (v["dtype"], tuple(v["shape"]))
            for k, v in header.items() if k != "__metadata__"}


def collect_checkpoint_shapes(path: str) -> Dict[str, tuple]:
    """{key: shape} for a checkpoint file or dir: header-only for
    safetensors (a sharded dir through its index weight_map); a torch .pth
    is loaded (memory-mapped)."""
    if os.path.isdir(path):
        idx = _find_index_json(path)
        if idx is not None:
            with open(idx) as fh:
                weight_map = json.load(fh)["weight_map"]
            shapes: Dict[str, tuple] = {}
            for fname in sorted(set(weight_map.values())):
                for k, (_, shp) in read_safetensors_header(
                        os.path.join(path, fname)).items():
                    shapes[k] = shp
            missing = sorted(set(weight_map) - set(shapes))
            if missing:
                raise ValueError(
                    f"index lists {len(missing)} keys absent from shard "
                    f"headers, first: {missing[:5]}")
            return shapes
        shapes = {}
        found = False
        for fname in sorted(os.listdir(path)):
            if fname.endswith(".safetensors"):
                found = True
                shapes.update({k: s for k, (_, s) in
                               read_safetensors_header(
                                   os.path.join(path, fname)).items()})
        if found:
            return shapes
    elif path.endswith(".safetensors"):
        return {k: s for k, (_, s) in
                read_safetensors_header(path).items()}
    return {k: tuple(v.shape) for k, v in load_state_dict(path).items()}


def audit_checkpoint(path: str, manifest) -> Dict[str, list]:
    """Key + shape diff of an on-disk checkpoint against a pinned manifest
    (manifest.audit_keys), header-only for safetensors: run it before any
    conversion, so that a mismatched download fails loudly."""
    from types import SimpleNamespace

    from .manifest import audit_keys
    shapes = collect_checkpoint_shapes(path)
    shim = {k: SimpleNamespace(shape=s) for k, s in shapes.items()}
    return audit_keys(shim, manifest)


def _load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a .safetensors file as a view of one private
    (copy-on-write) memory map of it; a tensor whose bytes are not aligned
    to its dtype is copied out."""
    with open(path, "rb") as fh:
        n, header = _read_header(fh)
        size = os.fstat(fh.fileno()).st_size
        buf = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_COPY) \
            if size > 8 + n else None
    base = 8 + n
    out = {}
    for k, v in header.items():
        if k == "__metadata__":
            continue
        dt = _ST_DTYPES[v["dtype"]]
        shape = tuple(v["shape"])
        start, end = v["data_offsets"]
        count = math.prod(shape)
        item = torch.empty((), dtype=dt).element_size()
        if end - start != count * item or base + end > size:
            raise ValueError(f"{path}: tensor {k} has {end - start} bytes "
                             f"for {v['dtype']} {list(shape)}")
        if count == 0:
            out[k] = torch.empty(shape, dtype=dt)
        elif (base + start) % item == 0:
            out[k] = torch.frombuffer(buf, dtype=dt, count=count,
                                      offset=base + start).reshape(shape)
        else:
            raw = torch.frombuffer(buf, dtype=torch.uint8, count=end - start,
                                   offset=base + start)
            out[k] = raw.clone().view(dt).reshape(shape)
    return out


def _load_torch(path: str) -> Dict[str, torch.Tensor]:
    sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    # published SAM2 .pt checkpoints wrap the weights under "model"
    if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
        sd = sd["model"]
    return dict(sd)


# ---------------------------------------------------------------------------
# placing tensors into modules
# ---------------------------------------------------------------------------


def _place(t, dtype, device, layout=None) -> torch.Tensor:
    """t cast to dtype on device, laid out there, contiguous, and never a
    view of the source (a memory-mapped file)."""
    src = torch.as_tensor(t)
    out = src.to(device=device, dtype=dtype)
    if layout is not None:
        out = layout(out)
    out = out.contiguous()
    if out.untyped_storage().data_ptr() == src.untyped_storage().data_ptr():
        out = out.clone()
    return out


def _assemble(module, entries: Dict[str, torch.Tensor]):
    """Assign every entry to the parameter of the same name of a module
    built on the meta device (each keeps its dtype and device); a missing
    or unexpected name, or a shape that differs, raises."""
    module.load_state_dict(entries, strict=True, assign=True)
    return module


class _Entries(dict):
    """{port key: tensor}, filled from a reference state dict."""

    def __init__(self, sd, device):
        super().__init__()
        self.sd, self.device = sd, device

    def put(self, dst, src, dtype, layout=None):
        self[dst] = _place(self.sd[src], dtype, self.device, layout)

    def lin(self, dst, src, dtype):
        """torch Linear -> the port's {w [out, in], b}."""
        self.put(f"{dst}.w", f"{src}.weight", dtype)
        if f"{src}.bias" in self.sd:
            self.put(f"{dst}.b", f"{src}.bias", dtype)

    def conv(self, dst, src, dtype):
        """torch Conv3d [O, I, kt, kh, kw] as it is; a Conv2d [O, I, kh,
        kw] as a kt = 1 conv3d."""
        self.put(f"{dst}.w", f"{src}.weight", dtype,
                 lambda w: w[:, :, None] if w.ndim == 4 else w)
        if f"{src}.bias" in self.sd:
            self.put(f"{dst}.b", f"{src}.bias", dtype)

    def norm(self, dst, src, dtype):
        """LayerNorm weight / bias -> {w, b}."""
        self.put(f"{dst}.w", f"{src}.weight", dtype)
        self.put(f"{dst}.b", f"{src}.bias", dtype)


def _flat(x):
    return x.reshape(-1)


# ---------------------------------------------------------------------------
# Wan DiT
# ---------------------------------------------------------------------------


def convert_wan_dit(sd, cfg: WanDiTConfig, dtype=torch.bfloat16, *,
                    device="cuda"):
    """WanModel state dict (reference model.py:294-408 naming) -> WanDiT:
    the time MLPs, the head and every modulation in fp32, the rest in
    `dtype`; the Conv3d patch embedding [dim, in, pt, ph, pw] as the dense
    [dim, (pt ph pw in)]."""
    from ..models.wan.dit import WanDiT

    f32 = torch.float32
    e = _Entries(sd, device)
    e.put("patch_embed.w", "patch_embedding.weight", dtype,
          lambda w: w.permute(0, 2, 3, 4, 1).reshape(cfg.dim, -1))
    e.put("patch_embed.b", "patch_embedding.bias", dtype)
    e.lin("text_embedding.fc0", "text_embedding.0", dtype)
    e.lin("text_embedding.fc1", "text_embedding.2", dtype)
    e.lin("time_embedding.fc0", "time_embedding.0", f32)
    e.lin("time_embedding.fc1", "time_embedding.2", f32)
    e.lin("time_projection.fc0", "time_projection.1", f32)
    e.lin("head.head", "head.head", f32)
    e.put("head.modulation", "head.modulation", f32,
          lambda m: m.reshape(2, cfg.dim))
    for i in range(cfg.num_layers):
        b = f"blocks.{i}"
        for attn in ("self_attn", "cross_attn"):
            for k in "qkvo":
                e.lin(f"{b}.{attn}.{k}", f"{b}.{attn}.{k}", dtype)
            if cfg.qk_norm:
                e.put(f"{b}.{attn}.norm_q", f"{b}.{attn}.norm_q.weight",
                      dtype)
                e.put(f"{b}.{attn}.norm_k", f"{b}.{attn}.norm_k.weight",
                      dtype)
        e.lin(f"{b}.ffn.fc0", f"{b}.ffn.0", dtype)
        e.lin(f"{b}.ffn.fc1", f"{b}.ffn.2", dtype)
        e.put(f"{b}.modulation", f"{b}.modulation", f32,
              lambda m: m.reshape(6, cfg.dim))
        if cfg.cross_attn_norm:
            e.norm(f"{b}.norm3", f"{b}.norm3", dtype)
    return _assemble(WanDiT(cfg, dtype=dtype, device="meta"), e)


# ---------------------------------------------------------------------------
# Wan video VAE
# ---------------------------------------------------------------------------


def _res_block_from(e, dst, src, dtype):
    """ResidualBlock (vae2_2.py:193-212): residual = [RMS, SiLU, conv,
    RMS, SiLU, Dropout, conv]; shortcut conv when dims differ."""
    e.put(f"{dst}.norm1", f"{src}.residual.0.gamma", dtype, _flat)
    e.conv(f"{dst}.conv1", f"{src}.residual.2", dtype)
    e.put(f"{dst}.norm2", f"{src}.residual.3.gamma", dtype, _flat)
    e.conv(f"{dst}.conv2", f"{src}.residual.6", dtype)
    if f"{src}.shortcut.weight" in e.sd:
        e.conv(f"{dst}.shortcut", f"{src}.shortcut", dtype)


def _vae_attn_from(e, dst, src, dtype):
    """AttentionBlock (vae2_2.py:238-277): 1x1 conv qkv / proj -> linear."""
    e.put(f"{dst}.norm", f"{src}.norm.gamma", dtype, _flat)
    for name, conv in (("qkv", "to_qkv"), ("proj", "proj")):
        e.put(f"{dst}.{name}.w", f"{src}.{conv}.weight", dtype,
              lambda w: w[:, :, 0, 0])
        e.put(f"{dst}.{name}.b", f"{src}.{conv}.bias", dtype)


def convert_wan_vae(sd, cfg: WanVAEConfig, dtype=torch.float32, *,
                    device="cuda"):
    """WanVAE_ state dict (vae2_2.py naming) -> WanVAE, every leaf in
    `dtype` (fp32, as the JAX converter keeps it)."""
    from ..models.wan.vae_api import WanVAE

    e = _Entries(sd, device)
    n_levels = len(cfg.dim_mult)
    e.conv("encoder.conv1", "encoder.conv1", dtype)
    for i in range(n_levels):
        base = f"encoder.downsamples.{i}.downsamples"
        for j in range(cfg.num_res_blocks):
            _res_block_from(e, f"encoder.down{i}.res{j}", f"{base}.{j}",
                            dtype)
        if i != n_levels - 1:
            r = f"{base}.{cfg.num_res_blocks}"
            t_down = cfg.temporal_downsample[i] if i < len(
                cfg.temporal_downsample) else False
            # Resample: [ZeroPad2d, Conv2d] (down)
            e.conv(f"encoder.down{i}.resample", f"{r}.resample.1", dtype)
            if t_down:
                e.conv(f"encoder.down{i}.time_conv", f"{r}.time_conv",
                       dtype)
    for part in ("encoder", "decoder"):
        _res_block_from(e, f"{part}.mid_res1", f"{part}.middle.0", dtype)
        _vae_attn_from(e, f"{part}.mid_attn", f"{part}.middle.1", dtype)
        _res_block_from(e, f"{part}.mid_res2", f"{part}.middle.2", dtype)
        e.put(f"{part}.head_norm", f"{part}.head.0.gamma", dtype, _flat)
        e.conv(f"{part}.head_conv", f"{part}.head.2", dtype)
    e.conv("decoder.conv1", "decoder.conv1", dtype)
    ups = cfg.temporal_upsample
    for i in range(n_levels):
        base = f"decoder.upsamples.{i}.upsamples"
        for j in range(cfg.num_res_blocks + 1):
            _res_block_from(e, f"decoder.up{i}.res{j}", f"{base}.{j}", dtype)
        if i != n_levels - 1:
            r = f"{base}.{cfg.num_res_blocks + 1}"
            t_up = ups[i] if i < len(ups) else False
            # Resample: [Upsample, Conv2d] (up)
            e.conv(f"decoder.up{i}.resample", f"{r}.resample.1", dtype)
            if t_up:
                e.conv(f"decoder.up{i}.time_conv", f"{r}.time_conv", dtype)
    e.conv("conv_mu", "conv1", dtype)
    e.conv("conv_z", "conv2", dtype)
    return _assemble(WanVAE(cfg, dtype=dtype, device="meta"), e)


# ---------------------------------------------------------------------------
# UMT5 encoder
# ---------------------------------------------------------------------------


def convert_umt5(sd, cfg: T5Config, dtype=torch.bfloat16, *,
                 device="cuda"):
    """T5Encoder state dict (t5.py naming) -> UMT5Encoder in `dtype`."""
    from ..models.wan.t5 import UMT5Encoder

    e = _Entries(sd, device)
    e.put("token_embedding", "token_embedding.weight", dtype)
    e.put("norm", "norm.weight", dtype)
    for i in range(cfg.num_layers):
        b = f"blocks.{i}"
        e.put(f"{b}.norm1", f"{b}.norm1.weight", dtype)
        for k in "qkvo":
            e.put(f"{b}.attn.{k}.w", f"{b}.attn.{k}.weight", dtype)
        e.put(f"{b}.pos_embedding", f"{b}.pos_embedding.embedding.weight",
              dtype)
        e.put(f"{b}.norm2", f"{b}.norm2.weight", dtype)
        e.put(f"{b}.ffn.gate.w", f"{b}.ffn.gate.0.weight", dtype)
        e.put(f"{b}.ffn.fc1.w", f"{b}.ffn.fc1.weight", dtype)
        e.put(f"{b}.ffn.fc2.w", f"{b}.ffn.fc2.weight", dtype)
    return _assemble(UMT5Encoder(cfg, dtype=dtype, device="meta"), e)


# ---------------------------------------------------------------------------
# BAGEL (Qwen2-MoT LLM + heads) and the SigLIP towers
# ---------------------------------------------------------------------------


def _bagel_llm_entries(e, cfg, dtype, prefix, dst=""):
    def attn_set(out, base, suffix=""):
        for k in "qkvo":
            e.lin(f"{out}.{k}", f"{base}.{k}_proj{suffix}", dtype)
        if cfg.qk_norm:
            qn = "q_norm_moe_gen" if suffix else "q_norm"
            kn = "k_norm_moe_gen" if suffix else "k_norm"
            e.put(f"{out}.q_norm", f"{base}.{qn}.weight", dtype)
            e.put(f"{out}.k_norm", f"{base}.{kn}.weight", dtype)

    def mlp_set(out, base):
        for k in ("gate", "up", "down"):
            e.lin(f"{out}.{k}", f"{base}.{k}_proj", dtype)

    e.put(f"{dst}embed_tokens", f"{prefix}.embed_tokens.weight", dtype)
    for i in range(cfg.num_layers):
        b, o = f"{prefix}.layers.{i}", f"{dst}layers.{i}"
        e.put(f"{o}.input_ln", f"{b}.input_layernorm.weight", dtype)
        attn_set(f"{o}.attn", f"{b}.self_attn")
        e.put(f"{o}.post_ln", f"{b}.post_attention_layernorm.weight", dtype)
        mlp_set(f"{o}.mlp", f"{b}.mlp")
        if cfg.moe:
            e.put(f"{o}.input_ln_gen", f"{b}.input_layernorm_moe_gen.weight",
                  dtype)
            attn_set(f"{o}.attn_gen", f"{b}.self_attn", "_moe_gen")
            e.put(f"{o}.post_ln_gen",
                  f"{b}.post_attention_layernorm_moe_gen.weight", dtype)
            mlp_set(f"{o}.mlp_gen", f"{b}.mlp_moe_gen")
    e.put(f"{dst}norm", f"{prefix}.norm.weight", dtype)
    e.lin(f"{dst}lm_head", "language_model.lm_head", dtype)
    if cfg.moe:
        e.put(f"{dst}norm_gen", f"{prefix}.norm_moe_gen.weight", dtype)


def convert_bagel_llm(sd, cfg, dtype=torch.bfloat16,
                      prefix: str = "language_model.model", *,
                      device="cuda"):
    """Qwen2MoT state dict (qwen2_navit.py naming) -> the `llm` module of
    qwen2_mot.init_qwen2_mot."""
    from ..models.bagel.qwen2_mot import init_qwen2_mot

    e = _Entries(sd, device)
    _bagel_llm_entries(e, cfg, dtype, prefix)
    return _assemble(init_qwen2_mot(None, cfg, dtype=dtype, device="meta"),
                     e)


def _siglip_entries(e, cfg, dtype, prefix, dst=""):
    pe_key = f"{prefix}.embeddings.patch_embedding.weight"
    p, c = cfg.patch_size, cfg.num_channels
    # conv [O, I, p, p] or linear [O, I*p*p] with torch's (c, h, w)
    # flatten -> [O, (p p I)] in the (h, w, c) order of image_to_patches
    e.put(f"{dst}patch_embed.w", pe_key, dtype,
          lambda w: w.reshape(w.shape[0], c, p, p).permute(0, 2, 3, 1)
          .reshape(w.shape[0], -1))
    e.put(f"{dst}patch_embed.b", f"{prefix}.embeddings.patch_embedding.bias",
          dtype)
    e.norm(f"{dst}post_ln", f"{prefix}.post_layernorm", dtype)
    if f"{prefix}.embeddings.position_embedding.weight" in e.sd:
        e.put(f"{dst}pos_embed",
              f"{prefix}.embeddings.position_embedding.weight", dtype)
    _encoder_entries(e, cfg.num_layers, dtype, prefix, dst)


def _encoder_entries(e, n_layers, dtype, prefix, dst=""):
    """HF Siglip encoder layers -> layers.{i}.{ln1, attn.{q,k,v,o}, ln2,
    mlp.{fc0,fc1}}."""
    for i in range(n_layers):
        b, o = f"{prefix}.encoder.layers.{i}", f"{dst}layers.{i}"
        e.norm(f"{o}.ln1", f"{b}.layer_norm1", dtype)
        for k, src in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                       ("o", "out_proj")):
            e.lin(f"{o}.attn.{k}", f"{b}.self_attn.{src}", dtype)
        e.norm(f"{o}.ln2", f"{b}.layer_norm2", dtype)
        e.lin(f"{o}.mlp.fc0", f"{b}.mlp.fc1", dtype)
        e.lin(f"{o}.mlp.fc1", f"{b}.mlp.fc2", dtype)


def convert_siglip(sd, cfg, dtype=torch.bfloat16,
                   prefix: str = "vision_model", *, device="cuda"):
    """SiglipVisionTransformer (navit) -> Siglip. The patch embedding may
    be a Conv2d [O, I, p, p] or already linearised (siglip_navit.py:167)."""
    from ..models.bagel.siglip import Siglip

    e = _Entries(sd, device)
    _siglip_entries(e, cfg, dtype, prefix)
    return _assemble(Siglip(cfg, dtype=dtype, device="meta"), e)


def convert_siglip2_text(sd, cfg, dtype=torch.float32,
                         prefix: str = "text_model", *, device="cuda"):
    """HF SiglipTextTransformer -> SiglipText; the pooling head
    (text_model.head, with its bias) becomes `proj`, applied to the last
    token (pooling 'hf_last')."""
    from ..reflection.scorer import SiglipText

    e = _Entries(sd, device)
    e.put("token_embed", f"{prefix}.embeddings.token_embedding.weight",
          dtype)
    e.put("pos_embed", f"{prefix}.embeddings.position_embedding.weight",
          dtype)
    e.norm("final_ln", f"{prefix}.final_layer_norm", dtype)
    e.lin("proj", f"{prefix}.head", dtype)
    _encoder_entries(e, cfg.num_layers, dtype, prefix)
    return _assemble(SiglipText(cfg, dtype=dtype, device="meta",
                                proj_bias="proj.b" in e), e)


def _map_head_entries(e, dtype, prefix, dst=""):
    """HF SiglipMultiheadAttentionPoolingHead -> {probe, q, k, v, o, ln,
    mlp}: the packed MultiheadAttention in_proj [3d, d] split into q / k /
    v. -> d."""
    d = e.sd[f"{prefix}.probe"].shape[-1]
    e.put(f"{dst}probe", f"{prefix}.probe", dtype)
    for i, k in enumerate("qkv"):
        e.put(f"{dst}{k}.w", f"{prefix}.attention.in_proj_weight", dtype,
              lambda w, i=i: w[i * d:(i + 1) * d])
        e.put(f"{dst}{k}.b", f"{prefix}.attention.in_proj_bias", dtype,
              lambda b, i=i: b[i * d:(i + 1) * d])
    e.lin(f"{dst}o", f"{prefix}.attention.out_proj", dtype)
    e.norm(f"{dst}ln", f"{prefix}.layernorm", dtype)
    e.lin(f"{dst}mlp.fc0", f"{prefix}.mlp.fc1", dtype)
    e.lin(f"{dst}mlp.fc1", f"{prefix}.mlp.fc2", dtype)
    return d


def convert_siglip_map_head(sd, dtype=torch.float32,
                            prefix: str = "vision_model.head", *,
                            device="cuda"):
    """HF SiglipMultiheadAttentionPoolingHead -> SiglipMapHead."""
    from ..reflection.scorer import SiglipMapHead

    e = _Entries(sd, device)
    d = _map_head_entries(e, dtype, prefix)
    return _assemble(SiglipMapHead(d, e["mlp.fc0.w"].shape[0], dtype=dtype,
                                   device="meta"), e)


# ---------------------------------------------------------------------------
# top-level loaders
# ---------------------------------------------------------------------------
# the FLUX image VAE (BAGEL's ae.safetensors)
# ---------------------------------------------------------------------------


def convert_flux_ae(sd, cfg, dtype=torch.float32, *, device="cuda"):
    """FLUX AutoEncoder state dict (BAGEL's ae.safetensors, the reference
    modeling/autoencoder.py naming: encoder.down.{i}.block.{j},
    encoder.down.{i}.downsample.conv, {encoder,decoder}.mid.{block_1,
    attn_1,block_2}, decoder.up.{i}.block.{j}, decoder.up.{i}.upsample.conv)
    -> models.bagel.autoencoder.ImageVAE, every leaf in `dtype` (fp32, as
    the JAX converter keeps it); convs stay [Cout, Cin, kh, kw]."""
    from ..models.bagel.autoencoder import ImageVAE

    e = _Entries(sd, device)

    def conv(dst, src):
        e.put(f"{dst}.w", f"{src}.weight", dtype)
        e.put(f"{dst}.b", f"{src}.bias", dtype)

    def res(dst, src):
        e.norm(f"{dst}.norm1", f"{src}.norm1", dtype)
        conv(f"{dst}.conv1", f"{src}.conv1")
        e.norm(f"{dst}.norm2", f"{src}.norm2", dtype)
        conv(f"{dst}.conv2", f"{src}.conv2")
        if f"{src}.nin_shortcut.weight" in e.sd:
            conv(f"{dst}.shortcut", f"{src}.nin_shortcut")

    def mid(part):
        res(f"{part}.mid_res1", f"{part}.mid.block_1")
        a = f"{part}.mid.attn_1"
        e.norm(f"{part}.mid_attn.norm", f"{a}.norm", dtype)
        for dst, src in (("q", "q"), ("k", "k"), ("v", "v"),
                         ("proj", "proj_out")):
            conv(f"{part}.mid_attn.{dst}", f"{a}.{src}")
        res(f"{part}.mid_res2", f"{part}.mid.block_2")
        e.norm(f"{part}.norm_out", f"{part}.norm_out", dtype)
        conv(f"{part}.conv_in", f"{part}.conv_in")
        conv(f"{part}.conv_out", f"{part}.conv_out")

    n_levels = len(cfg.ch_mult)
    for i in range(n_levels):
        for j in range(cfg.num_res_blocks):
            res(f"encoder.down{i}.res{j}", f"encoder.down.{i}.block.{j}")
        if i != n_levels - 1:
            conv(f"encoder.down{i}.down", f"encoder.down.{i}.downsample.conv")
        for j in range(cfg.num_res_blocks + 1):
            res(f"decoder.up{i}.res{j}", f"decoder.up.{i}.block.{j}")
        if i != 0:
            conv(f"decoder.up{i}.up", f"decoder.up.{i}.upsample.conv")
    mid("encoder")
    mid("decoder")
    return _assemble(ImageVAE(cfg, dtype=dtype, device="meta"), e)


def load_flux_ae_checkpoint(path: str, cfg=None, *, device="cuda"):
    """BAGEL's FLUX image VAE (ae.safetensors beside ema.safetensors; a
    directory or the file) -> (ImageVAE on `device`, fp32, cfg), at
    ImageVAEConfig() unless cfg is given. A key the converter never reads
    raises."""
    from ..models.bagel.autoencoder import ImageVAEConfig
    from .manifest import audited

    cfg = cfg or ImageVAEConfig()
    if os.path.isdir(path):
        path = os.path.join(path, "ae.safetensors")
    vae, _ = audited(load_state_dict(path),
                     lambda sd: convert_flux_ae(sd, cfg, device=device))
    return vae, cfg


# ---------------------------------------------------------------------------
# FLUX.1-Kontext (the BFL transformer and the HF text towers)
# ---------------------------------------------------------------------------


def convert_flux_transformer(sd, cfg, dtype=torch.bfloat16, *,
                             device="cuda"):
    """BFL flux1-kontext-dev.safetensors (img_in / txt_in / time_in /
    vector_in / guidance_in, double_blocks.{i}.{img,txt}_{mod,attn,mlp},
    single_blocks.{i}.{modulation,linear1,norm,linear2}, final_layer) ->
    models.flux.kontext.Flux, every leaf in `dtype`, linears [out, in]."""
    from ..models.flux.kontext import Flux

    e = _Entries(sd, device)
    e.lin("img_in", "img_in", dtype)
    e.lin("txt_in", "txt_in", dtype)
    embedders = ("time_in", "vector_in") + (
        ("guidance_in",) if cfg.guidance_embed else ())
    for emb in embedders:
        e.lin(f"{emb}.in_layer", f"{emb}.in_layer", dtype)
        e.lin(f"{emb}.out_layer", f"{emb}.out_layer", dtype)
    e.lin("final_layer.linear", "final_layer.linear", dtype)
    e.lin("final_layer.adaLN", "final_layer.adaLN_modulation.1", dtype)
    for i in range(cfg.depth_double):
        for s in ("img", "txt"):
            b = f"double_blocks.{i}.{s}"
            e.lin(f"{b}.mod", f"{b}_mod.lin", dtype)
            e.lin(f"{b}.qkv", f"{b}_attn.qkv", dtype)
            e.put(f"{b}.norm_q", f"{b}_attn.norm.query_norm.scale", dtype)
            e.put(f"{b}.norm_k", f"{b}_attn.norm.key_norm.scale", dtype)
            e.lin(f"{b}.proj", f"{b}_attn.proj", dtype)
            e.lin(f"{b}.mlp.fc0", f"{b}_mlp.0", dtype)
            e.lin(f"{b}.mlp.fc1", f"{b}_mlp.2", dtype)
    for i in range(cfg.depth_single):
        b = f"single_blocks.{i}"
        e.lin(f"{b}.mod", f"{b}.modulation.lin", dtype)
        e.lin(f"{b}.linear1", f"{b}.linear1", dtype)
        e.put(f"{b}.norm_q", f"{b}.norm.query_norm.scale", dtype)
        e.put(f"{b}.norm_k", f"{b}.norm.key_norm.scale", dtype)
        e.lin(f"{b}.linear2", f"{b}.linear2", dtype)
    return _assemble(Flux(cfg, dtype=dtype, device="meta"), e)


def convert_t5_hf(sd, cfg: T5Config, dtype=torch.bfloat16, *,
                  device="cuda"):
    """HF T5EncoderModel (google/t5-v1_1-xxl, FLUX's text_encoder_2:
    shared.weight, encoder.block.{i}.layer.{0,1}) -> UMT5Encoder in
    `dtype`; with cfg.shared_pos only layer 0's relative-position table is
    read, the one every layer uses."""
    from ..models.wan.t5 import UMT5Encoder

    e = _Entries(sd, device)
    e.put("token_embedding", "shared.weight" if "shared.weight" in sd
          else "encoder.embed_tokens.weight", dtype)
    e.put("norm", "encoder.final_layer_norm.weight", dtype)
    for i in range(cfg.num_layers):
        src, dst = f"encoder.block.{i}.layer", f"blocks.{i}"
        e.put(f"{dst}.norm1", f"{src}.0.layer_norm.weight", dtype)
        for k in "qkvo":
            e.put(f"{dst}.attn.{k}.w", f"{src}.0.SelfAttention.{k}.weight",
                  dtype)
        if not cfg.shared_pos or i == 0:
            e.put(f"{dst}.pos_embedding",
                  f"{src}.0.SelfAttention.relative_attention_bias.weight",
                  dtype)
        e.put(f"{dst}.norm2", f"{src}.1.layer_norm.weight", dtype)
        # HF's gated act: act(wi_0) * wi_1
        e.put(f"{dst}.ffn.gate.w", f"{src}.1.DenseReluDense.wi_0.weight",
              dtype)
        e.put(f"{dst}.ffn.fc1.w", f"{src}.1.DenseReluDense.wi_1.weight",
              dtype)
        e.put(f"{dst}.ffn.fc2.w", f"{src}.1.DenseReluDense.wo.weight", dtype)
    return _assemble(UMT5Encoder(cfg, dtype=dtype, device="meta"), e)


def convert_clip_text(sd, cfg, dtype=torch.float32, *, device="cuda"):
    """HF CLIPTextModel (openai/clip-vit-large-patch14, FLUX's
    text_encoder) -> models.flux.clip_text.ClipText in `dtype`."""
    from ..models.flux.clip_text import ClipText

    p = "text_model"
    e = _Entries(sd, device)
    e.put("token_embedding", f"{p}.embeddings.token_embedding.weight", dtype)
    e.put("position_embedding", f"{p}.embeddings.position_embedding.weight",
          dtype)
    e.norm("final_norm", f"{p}.final_layer_norm", dtype)
    for i in range(cfg.num_layers):
        src, dst = f"{p}.encoder.layers.{i}", f"blocks.{i}"
        e.norm(f"{dst}.ln1", f"{src}.layer_norm1", dtype)
        e.norm(f"{dst}.ln2", f"{src}.layer_norm2", dtype)
        for k in "qkv":
            e.lin(f"{dst}.attn.{k}", f"{src}.self_attn.{k}_proj", dtype)
        e.lin(f"{dst}.attn.o", f"{src}.self_attn.out_proj", dtype)
        e.lin(f"{dst}.mlp.fc0", f"{src}.mlp.fc1", dtype)
        e.lin(f"{dst}.mlp.fc1", f"{src}.mlp.fc2", dtype)
    return _assemble(ClipText(cfg, dtype=dtype, device="meta"), e)


def load_kontext_checkpoint(flux_dir: str, dtype=torch.bfloat16, *,
                            device="cuda", tiny: bool = False):
    """The Kontext editor's directory -> (Flux, FluxConfig(), ImageVAE,
    ImageVAEConfig(), UMT5Encoder, FLUX_T5_CONFIG, ClipText,
    ClipTextConfig()) on `device`: flux1-kontext-dev.safetensors, ae.
    safetensors (fp32), text_encoder_2/ (T5-XXL v1.1) and text_encoder/
    (CLIP-L), the transformer and both towers in `dtype`. A key that no
    converter reads raises (HF's tied encoder.embed_tokens.weight and
    CLIP's position_ids buffer aside). tiny: a directory at the mock
    pipeline's geometry (TINY_FLUX, TINY_FLUX_VAE, TINY_FLUX_T5,
    TINY_CLIP_TEXT), as the tests and the card's check write one."""
    from ..models.flux import (ClipTextConfig, FluxConfig, TINY_CLIP_TEXT,
                               TINY_FLUX)
    from ..pipelines.kontext import (FLUX_T5_CONFIG, TINY_FLUX_T5,
                                     TINY_FLUX_VAE)
    from .manifest import audited

    flux_cfg, t5_cfg, clip_cfg = ((TINY_FLUX, TINY_FLUX_T5, TINY_CLIP_TEXT)
                                  if tiny else (FluxConfig(), FLUX_T5_CONFIG,
                                                ClipTextConfig()))
    flux, _ = audited(
        load_state_dict(os.path.join(flux_dir,
                                     "flux1-kontext-dev.safetensors")),
        lambda sd: convert_flux_transformer(sd, flux_cfg, dtype,
                                            device=device))
    vae, vae_cfg = load_flux_ae_checkpoint(
        os.path.join(flux_dir, "ae.safetensors"),
        TINY_FLUX_VAE if tiny else None, device=device)
    t5, _ = audited(
        load_state_dict(os.path.join(flux_dir, "text_encoder_2")),
        lambda sd: convert_t5_hf(sd, t5_cfg, dtype, device=device),
        ignore=("encoder.embed_tokens.weight",))
    clip, _ = audited(
        load_state_dict(os.path.join(flux_dir, "text_encoder")),
        lambda sd: convert_clip_text(sd, clip_cfg, dtype, device=device),
        ignore=("text_model.embeddings.position_ids",))
    return flux, flux_cfg, vae, vae_cfg, t5, t5_cfg, clip, clip_cfg


# ---------------------------------------------------------------------------
# WanAnimate (the DiT with its motion encoder, face encoder and adapters;
# the CLIP ViT-H visual tower)
# ---------------------------------------------------------------------------


def convert_wan_animate(sd, cfg, dtype=torch.bfloat16, *, device="cuda"):
    """WanAnimateModel state dict (model_animate.py naming with its
    motion_encoder / face_encoder / face_adapter submodules) -> WanAnimate:
    the DiT, img_emb, face encoder's out_proj and padding token and the
    face adapters in `dtype`; the time MLPs, head, modulations, the motion
    encoder and the face encoder's convs in fp32, as JAX converts them.
    The Conv3d patch embeddings become dense [dim, (pt ph pw in)]. The
    motion encoder's ConvLayers are Sequentials: the conv at .0 (.1 after
    the Blur when downsampling), its FusedLeakyReLU bias after it; a conv
    without a bias in the file takes zeros (the JAX tree omits it)."""
    from ..models.wan.animate import WanAnimate

    f32 = torch.float32
    e = _Entries(sd, device)
    for name in ("patch_embed", "pose_patch_embed"):
        src = name.replace("embed", "embedding")
        e.put(f"{name}.w", f"{src}.weight", dtype,
              lambda w: w.permute(0, 2, 3, 4, 1).reshape(cfg.dim, -1))
        e.put(f"{name}.b", f"{src}.bias", dtype)
    e.lin("text_embedding.fc0", "text_embedding.0", dtype)
    e.lin("text_embedding.fc1", "text_embedding.2", dtype)
    e.lin("time_embedding.fc0", "time_embedding.0", f32)
    e.lin("time_embedding.fc1", "time_embedding.2", f32)
    e.lin("time_projection.fc0", "time_projection.1", f32)
    e.lin("head.head", "head.head", f32)
    e.put("head.modulation", "head.modulation", f32,
          lambda m: m.reshape(2, cfg.dim))
    if cfg.use_img_emb:
        e.norm("img_emb.ln0", "img_emb.proj.0", dtype)
        e.lin("img_emb.fc0", "img_emb.proj.1", dtype)
        e.lin("img_emb.fc1", "img_emb.proj.3", dtype)
        e.norm("img_emb.ln1", "img_emb.proj.4", dtype)
    for i in range(cfg.num_layers):
        b = f"blocks.{i}"
        for attn in ("self_attn", "cross_attn"):
            for k in "qkvo":
                e.lin(f"{b}.{attn}.{k}", f"{b}.{attn}.{k}", dtype)
            norms = ["norm_q", "norm_k"] if cfg.qk_norm else []
            if attn == "cross_attn" and cfg.use_img_emb:
                e.lin(f"{b}.{attn}.k_img", f"{b}.{attn}.k_img", dtype)
                e.lin(f"{b}.{attn}.v_img", f"{b}.{attn}.v_img", dtype)
                norms += ["norm_k_img"] if cfg.qk_norm else []
            for nm in norms:
                e.put(f"{b}.{attn}.{nm}", f"{b}.{attn}.{nm}.weight", dtype)
        e.lin(f"{b}.ffn.fc0", f"{b}.ffn.0", dtype)
        e.lin(f"{b}.ffn.fc1", f"{b}.ffn.2", dtype)
        e.put(f"{b}.modulation", f"{b}.modulation", f32,
              lambda m: m.reshape(6, cfg.dim))
        if cfg.cross_attn_norm:
            e.norm(f"{b}.norm3", f"{b}.norm3", dtype)

    me = "motion_encoder.enc.net_app.convs"

    def conv(dst, src, act_src=None, bias=True):
        e.put(f"{dst}.w", f"{src}.weight", f32)
        if f"{src}.bias" in e.sd:
            e.put(f"{dst}.b", f"{src}.bias", f32)
        elif bias:
            cout = e[f"{dst}.w"].shape[0]
            e[f"{dst}.b"] = torch.zeros(cout, dtype=f32, device=device)
        if act_src is not None:
            e.put(f"{dst}.act_b", f"{act_src}.bias", f32)

    dst = "motion_encoder"
    conv(f"{dst}.first", f"{me}.0.0", f"{me}.0.1")
    n_res = int(math.log2(cfg.motion_size)) - 2
    for i in range(1, 1 + n_res):
        blk, src = f"{dst}.blocks.{i - 1}", f"{me}.{i}"
        conv(f"{blk}.conv1", f"{src}.conv1.0", f"{src}.conv1.1")
        conv(f"{blk}.conv2", f"{src}.conv2.1", f"{src}.conv2.2")
        conv(f"{blk}.skip", f"{src}.skip.1", bias=False)
    conv(f"{dst}.final", f"{me}.{1 + n_res}", bias=False)
    for i in range(5):
        e.lin(f"{dst}.fc.{i}", f"motion_encoder.enc.fc.{i}", f32)
    e.put(f"{dst}.direction", "motion_encoder.dec.direction.weight", f32)

    for name in ("conv1_local", "conv2", "conv3"):
        e.put(f"face_encoder.{name}.w", f"face_encoder.{name}.conv.weight",
              f32)
        e.put(f"face_encoder.{name}.b", f"face_encoder.{name}.conv.bias",
              f32)
    e.lin("face_encoder.out_proj", "face_encoder.out_proj", dtype)
    e.put("face_encoder.padding_tokens", "face_encoder.padding_tokens",
          dtype)
    for j in range(cfg.adapter_layers):
        src, dst = f"face_adapter.fuser_blocks.{j}", f"face_adapter.{j}"
        for k in ("linear1_kv", "linear1_q", "linear2"):
            e.lin(f"{dst}.{k}", f"{src}.{k}", dtype)
        e.put(f"{dst}.q_norm", f"{src}.q_norm.weight", dtype)
        e.put(f"{dst}.k_norm", f"{src}.k_norm.weight", dtype)
    return _assemble(WanAnimate(cfg, dtype=dtype, device="meta"), e)


def convert_clip_vit(sd, cfg, dtype=torch.float32, prefix: str = "visual.",
                     *, device="cuda"):
    """XLM-Roberta-CLIP visual tower state dict (open-clip
    VisionTransformer naming, under `prefix` inside the full CLIPModel
    file) -> ClipVision in `dtype`: the Conv2d patch embedding [D, 3, p, p]
    as the dense [D, (p p 3)] of clip_visual_forward's patch order,
    to_qkv split into q, k and v."""
    from ..models.wan.animate import ClipVision

    e = _Entries(sd, device)
    d = cfg.dim
    e.put("patch_embed.w", f"{prefix}patch_embedding.weight", dtype,
          lambda w: w.permute(0, 2, 3, 1).reshape(d, -1))
    e.put("cls", f"{prefix}cls_embedding", dtype, lambda t: t.reshape(1, d))
    e.put("pos_embed", f"{prefix}pos_embedding", dtype,
          lambda t: t.reshape(-1, d))
    e.norm("pre_norm", f"{prefix}pre_norm", dtype)
    for i in range(cfg.num_layers):
        src, dst = f"{prefix}transformer.{i}", f"layers.{i}"
        e.norm(f"{dst}.ln1", f"{src}.norm1", dtype)
        e.norm(f"{dst}.ln2", f"{src}.norm2", dtype)
        for j, k in enumerate("qkv"):
            rows = slice(j * d, (j + 1) * d)
            e.put(f"{dst}.attn.{k}.w", f"{src}.attn.to_qkv.weight", dtype,
                  lambda w, r=rows: w[r])
            e.put(f"{dst}.attn.{k}.b", f"{src}.attn.to_qkv.bias", dtype,
                  lambda b, r=rows: b[r])
        e.lin(f"{dst}.attn.o", f"{src}.attn.proj", dtype)
        e.lin(f"{dst}.mlp.fc0", f"{src}.mlp.0", dtype)
        e.lin(f"{dst}.mlp.fc1", f"{src}.mlp.2", dtype)
    return _assemble(ClipVision(cfg, dtype=dtype, device="meta"), e)


# the CLIP file's keys the visual tower's 31-block extraction never reads:
# the XLM-R text side, the temperature, and the visual post-norm and head
CLIP_UNREAD = ("textual.", "log_scale", "visual.post_norm.", "visual.head")


def load_wan_animate_checkpoint(checkpoint_dir: str, animate_cfg, vae_cfg,
                                clip_cfg=None, dtype=torch.bfloat16, *,
                                device="cuda"):
    """(WanAnimate, WanVAE, ClipVision or None) on `device` from a
    reference WanAnimate checkpoint dir: the transformer's shards,
    Wan2.1_VAE.pth (or Wan2.2_VAE.pth, vae.pth) in fp32 and, with
    clip_cfg, models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth (or
    clip.pth) in `dtype`. A key no converter reads raises (through
    manifest.audited); in the CLIP file the keys of CLIP_UNREAD are
    skipped."""
    from .manifest import audited

    model, _ = audited(
        load_state_dict(checkpoint_dir),
        lambda sd: convert_wan_animate(sd, animate_cfg, dtype,
                                       device=device))
    vae_path = next((p for p in (
        os.path.join(checkpoint_dir, c)
        for c in ("Wan2.1_VAE.pth", "Wan2.2_VAE.pth", "vae.pth"))
        if os.path.exists(p)), None)
    if vae_path is None:
        raise FileNotFoundError(f"no VAE checkpoint in {checkpoint_dir}")
    vae, _ = audited(load_state_dict(vae_path),
                     lambda sd: convert_wan_vae(sd, vae_cfg, device=device))
    clip = None
    if clip_cfg is not None:
        for cand in (
                "models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth",
                "clip.pth"):
            p = os.path.join(checkpoint_dir, cand)
            if os.path.exists(p):
                clip, _ = audited(
                    load_state_dict(p),
                    lambda sd: convert_clip_vit(sd, clip_cfg, dtype,
                                                device=device),
                    ignore=CLIP_UNREAD)
                break
    return model, vae, clip


# ---------------------------------------------------------------------------


def _find_vae(checkpoint_dir: str) -> str:
    for cand in ("Wan2.2_VAE.pth", "Wan2.1_VAE.pth", "vae.pth"):
        p = os.path.join(checkpoint_dir, cand)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"no VAE checkpoint in {checkpoint_dir}")


def load_wan_checkpoint(checkpoint_dir: str, spec: WanModelSpec, *,
                        device="cuda"):
    """(WanDiT, WanVAE) on `device` from a reference Wan checkpoint dir:
    the DiT's shards (or .pth) and Wan2.2_VAE.pth, Wan2.1_VAE.pth or
    vae.pth. A source key the converters never read raises (through
    manifest.audited): a renamed or new key would otherwise leave part of
    the model unloaded."""
    from .manifest import audited
    dit, _ = audited(
        load_state_dict(checkpoint_dir),
        lambda sd: convert_wan_dit(sd, spec.dit, device=device))
    vae, _ = audited(
        load_state_dict(_find_vae(checkpoint_dir)),
        lambda sd: convert_wan_vae(sd, spec.vae, device=device))
    return dit, vae


def load_wan_moe_checkpoint(checkpoint_dir: str, spec: WanModelSpec, *,
                            device="cuda"):
    """((low WanDiT, high WanDiT), WanVAE) on `device` from an A14B
    dual-expert checkpoint dir: the experts' shards in low_noise_model/ and
    high_noise_model/ (the reference's subfolders), the VAE beside them.
    Each expert dir and the VAE go through manifest.audited: an unread key
    in either raises (JAX's MoE loader does not audit)."""
    from .manifest import audited
    experts = tuple(
        audited(load_state_dict(os.path.join(checkpoint_dir, sub)),
                lambda sd: convert_wan_dit(sd, spec.dit, device=device))[0]
        for sub in ("low_noise_model", "high_noise_model"))
    vae, _ = audited(
        load_state_dict(_find_vae(checkpoint_dir)),
        lambda sd: convert_wan_vae(sd, spec.vae, device=device))
    return experts, vae


def load_bagel_checkpoint(model_path: str, *, device="cuda",
                          llm_layers: bool = True):
    """BAGEL's ema.safetensors + its tokenizer -> (Bagel, cfg, SigLIP cfg,
    Siglip, tokenizer) on `device`, in bf16 (time_embedder and llm2vae in
    fp32), at the BAGEL-7B-MoT configs. Every ema.safetensors key must be
    consumed by the converters; an unread key raises.

    llm_layers=False places only the LLM's embed_tokens (what the fusion
    extractor reads, as init_bagel's llm_layers=False keeps it): the other
    LLM keys are still read, as meta tensors, and checked against the
    LLM's shapes, but never copied. The FLUX image VAE beside it
    (ae.safetensors) has its own loader, load_flux_ae_checkpoint."""
    from ..models.bagel.bagel import Bagel, BagelConfig
    from ..models.bagel.qwen2_mot import Qwen2MoTConfig, init_qwen2_mot
    from ..models.bagel.siglip import SiglipConfig
    from ..utils.tokenizers import load_tokenizer
    from .manifest import RecordingDict

    src = load_state_dict(os.path.join(model_path, "ema.safetensors"))
    sd = RecordingDict(src)
    llm_cfg = Qwen2MoTConfig()
    cfg = BagelConfig(llm=llm_cfg)
    bf16, f32 = torch.bfloat16, torch.float32
    e = _Entries(sd, device)
    llm = e if llm_layers else _Entries(sd, "meta")
    _bagel_llm_entries(llm, llm_cfg, bf16, "language_model.model", "llm.")
    if not llm_layers:
        _assemble(init_qwen2_mot(None, llm_cfg, dtype=bf16, device="meta"),
                  {k[len("llm."):]: v for k, v in llm.items()})
        e.put("llm.embed_tokens", "language_model.model.embed_tokens.weight",
              bf16)
    e.lin("time_embedder.fc0", "time_embedder.mlp.0", f32)
    e.lin("time_embedder.fc1", "time_embedder.mlp.2", f32)
    e.lin("vae2llm", "vae2llm", bf16)
    e.lin("llm2vae", "llm2vae", f32)
    e.put("latent_pos_embed", "latent_pos_embed.pos_embed", bf16)
    e.lin("connector.fc0", "connector.fc1", bf16)
    e.lin("connector.fc1", "connector.fc2", bf16)
    e.put("vit_pos_embed", "vit_pos_embed.pos_embed", bf16)
    scfg = SiglipConfig()
    sig = convert_siglip(sd, scfg, bf16, prefix="vit_model.vision_model",
                         device=device)
    leftover = sorted(set(src) - sd.consumed)
    if leftover:
        raise ValueError(f"{len(leftover)} ema.safetensors keys not consumed "
                         f"(first 10: {leftover[:10]})")
    model = _assemble(Bagel(cfg, dtype=bf16, device="meta",
                            llm_layers=llm_layers), e)
    tokenizer = load_tokenizer(model_path)
    return model, cfg, scfg, sig, tokenizer


def load_siglip2_checkpoint(path: str, dtype=torch.float32, *,
                            device="cuda"):
    """The HF SigLIP / SigLIP2 dual tower -> the scorer's parts on
    `device`. Sizes come from the tensor shapes, head counts from
    config.json (the HF checkpoint layout; without it, the JAX loader's
    guess from the widths)."""
    from ..models.bagel.siglip import SiglipConfig
    from ..reflection.scorer import SiglipTextConfig

    sd = load_state_dict(path)
    vision_heads = text_heads = None
    cfg_dir = path if os.path.isdir(path) else os.path.dirname(path)
    cfg_json = os.path.join(cfg_dir, "config.json")
    if os.path.exists(cfg_json):
        with open(cfg_json) as f:
            hf = json.load(f)
        vision_heads = hf.get("vision_config", {}).get("num_attention_heads")
        text_heads = hf.get("text_config", {}).get("num_attention_heads")

    def count_layers(prefix):
        n = 0
        while f"{prefix}.encoder.layers.{n}.layer_norm1.weight" in sd:
            n += 1
        return n

    v_hidden = sd["vision_model.embeddings.patch_embedding.bias"].shape[0]
    pe = sd["vision_model.embeddings.patch_embedding.weight"]
    patch = pe.shape[-1] if pe.ndim == 4 else int(
        np.sqrt(pe.shape[1] // 3))
    n_pos = sd["vision_model.embeddings.position_embedding.weight"].shape[0]
    image_size = int(np.sqrt(n_pos)) * patch
    v_heads = vision_heads or (16 if v_hidden % 16 == 0 else 12)
    vision_cfg = SiglipConfig(
        hidden_size=v_hidden,
        intermediate_size=sd[
            "vision_model.encoder.layers.0.mlp.fc1.bias"].shape[0],
        num_layers=count_layers("vision_model"), num_heads=v_heads,
        patch_size=patch, image_size=image_size)

    t_hidden = sd["text_model.embeddings.token_embedding.weight"].shape[1]
    text_cfg = SiglipTextConfig(
        vocab_size=sd[
            "text_model.embeddings.token_embedding.weight"].shape[0],
        hidden_size=t_hidden,
        intermediate_size=sd[
            "text_model.encoder.layers.0.mlp.fc1.bias"].shape[0],
        num_layers=count_layers("text_model"),
        num_heads=text_heads or (16 if t_hidden % 16 == 0 else 12),
        max_len=sd[
            "text_model.embeddings.position_embedding.weight"].shape[0],
        proj_dim=sd["text_model.head.bias"].shape[0], pooling="hf_last")

    return {
        "vision": convert_siglip(sd, vision_cfg, dtype,
                                 prefix="vision_model", device=device),
        "vision_cfg": vision_cfg,
        "map_head": convert_siglip_map_head(sd, dtype, device=device),
        "text": convert_siglip2_text(sd, text_cfg, dtype, device=device),
        "text_cfg": text_cfg,
        "logit_scale": (float(sd["logit_scale"].reshape(-1)[0])
                        if "logit_scale" in sd else 0.0),
    }


# ---------------------------------------------------------------------------
# ContextProjector (training states)
# ---------------------------------------------------------------------------

# reference ContextProjector: Sequential(Linear, LayerNorm, GELU, Dropout,
# Linear, LayerNorm) -> the port's module names
_SEQ_INDEX = {"fc0": 0, "ln0": 1, "fc1": 4, "ln1": 5}
_LEAF = {"w": "weight", "b": "bias"}


def _read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A flat {name: tensor} from a torch file (read with weights_only),
    an .npz, or a directory holding the port trainer's train_state.npz."""
    from ..convert import _flatten

    if os.path.isdir(path):
        path = os.path.join(path, "train_state.npz")
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {k: torch.as_tensor(np.array(data[k])) for k in data.files}
    return _flatten(_load_torch(path))


def load_projector_checkpoint(path: str, cfg: FusionConfig, *,
                              dtype=torch.float32, device="cuda"):
    """ContextProjector weights from a reference training_state.pt (the
    projector under `context_projector.`, `projector.` or
    `model_state_dict.`, its layers under `bagel_to_t5_projector.`,
    `projection.` or bare, at Sequential indices 0, 1, 4, 5), a bare
    projector state dict, or the port trainer's train_state.npz
    (`trainable/projector.` + the port's fc0 / ln0 / fc1 / ln1 names)."""
    from ..models.fusion.projector import ContextProjector

    sd = _read_state_dict(path)
    for container in ("context_projector", "projector", "model_state_dict",
                      "trainable/projector"):
        inner = {k[len(container) + 1:]: v for k, v in sd.items()
                 if k.startswith(container + ".")}
        if inner:
            sd = inner
            break
    if "fc0.w" in sd:   # the port's own names
        sd = {f"{_SEQ_INDEX[m]}.{_LEAF[leaf]}": v for m, leaf, v in
              (k.split(".") + [v] for k, v in sd.items())}
    root = next((c for c in ("bagel_to_t5_projector.", "projection.", "")
                 if f"{c}0.weight" in sd), "")
    model = ContextProjector(cfg, dtype=dtype, device=device)
    model.load_state_dict({
        f"{mod}.{leaf}": sd[f"{root}{idx}.{_LEAF[leaf]}"].to(dtype)
        for mod, idx in _SEQ_INDEX.items() for leaf in ("w", "b")})
    return model
