"""Typed configuration for the port (counterpart of univid_tpu/core/config.py).

The dataclasses (FusionConfig included), their defaults, the WAN_CONFIGS
entries (`ti2v-5B`, the dual-expert `t2v-A14B` / `i2v-A14B`, `t2v-1.3B`,
`tiny` and the dual-expert `tiny-moe-t2v` / `tiny-moe-i2v`), the
ANIMATE_CONFIGS (`animate-14B`, `tiny-animate`) and the size tables are
copied from the JAX package, which the port does not import.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Wan2.2 DiT
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class WanDiTConfig:
    """Wan diffusion transformer backbone.

    Semantics follow reference models/wan/utils/modules/model.py:294-408;
    defaults are the ti2v-5B values (configs/wan_ti2v_5B.py:20-29).
    """

    model_type: str = "ti2v"  # t2v | i2v | ti2v | s2v
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    text_len: int = 512
    in_dim: int = 48
    dim: int = 3072
    ffn_dim: int = 14336
    freq_dim: int = 256
    text_dim: int = 4096
    out_dim: int = 48
    num_heads: int = 24
    num_layers: int = 30
    window_size: Tuple[int, int] = (-1, -1)
    qk_norm: bool = True
    cross_attn_norm: bool = True
    eps: float = 1e-6
    rope_max_seq_len: int = 1024

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    def __post_init__(self):
        assert self.dim % self.num_heads == 0
        assert (self.dim // self.num_heads) % 2 == 0


@dataclass(frozen=True)
class WanVAEConfig:
    """Wan2.2 3D causal video VAE (reference vae2_2.py:734-898).

    Effective strides: spatial patchify (2) x conv stride -> (4, 16, 16).
    """

    dim: int = 160          # encoder base width (c_dim)
    dec_dim: int = 256      # decoder base width
    z_dim: int = 48
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_scales: Tuple[float, ...] = ()
    temporal_downsample: Tuple[bool, ...] = (False, True, True)
    spatial_patch: int = 2
    vae_stride: Tuple[int, int, int] = (4, 16, 16)
    # temporal chunking for bounded-memory streaming encode/decode
    encode_chunk: int = 4   # pixel frames per chunk after the first frame
    decode_chunk: int = 1   # latent frames per chunk

    @property
    def temporal_upsample(self) -> Tuple[bool, ...]:
        return tuple(reversed(self.temporal_downsample))


@dataclass(frozen=True)
class T5Config:
    """UMT5-XXL encoder (reference models/wan/utils/modules/t5.py:456-469)."""

    vocab_size: int = 256384
    dim: int = 4096
    dim_attn: int = 4096
    dim_ffn: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    num_buckets: int = 32
    rel_pos_max_dist: int = 128
    shared_pos: bool = False  # umt5: per-layer relative position embeddings
    dropout: float = 0.0
    text_len: int = 512


# ---------------------------------------------------------------------------
# Fusion (BAGEL -> Wan context projector)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FusionConfig:
    """Cross-attention fusion: BAGEL hidden states -> Wan context.

    Mirrors the knobs of reference CrossAttentionConfig
    (model_pipeline.py:154-296) that affect computation.
    """

    bagel_hidden_dim: int = 3584
    wan_text_dim: int = 4096
    wan_text_length: int = 512
    bagel_sequence_length: int = 256
    fusion_mode: str = "context_replacement"
    fusion_alpha: float = 1.0  # 1.0 = pure BAGEL context
    projector_hidden_mult: int = 2  # hidden = wan_text_dim * mult
    projector_dropout: float = 0.1
    use_semantic_alignment: bool = True
    use_cosine_similarity_loss: bool = True


# ---------------------------------------------------------------------------
# Generation / pipeline
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TMAConfig:
    """Temperature Modality Alignment — "Dynamic Text Weight Scheduling".

    Per-sampling-step scalar multiplied onto the text portion of cross-attn
    context (reference model_pipeline.py:1699-1810, inference.py:69-74).
    """

    enabled: bool = True
    weight_max: float = 1.3
    weight_min: float = 1.0
    schedule: str = "cosine"  # linear | cosine | exponential
    transition_ratio: float = 0.4
    # prefix of context tokens treated as "text" when weighting
    text_prefix_len: int = 512


@dataclass(frozen=True)
class GenerationConfig:
    """Sampling defaults (reference inference.py:33-95, wan_ti2v_5B.py:32-36)."""

    size: Tuple[int, int] = (1280, 704)  # (width, height)
    frame_num: int = 121
    fps: int = 24
    sampling_steps: int = 50
    guide_scale: float = 5.0
    shift: float = 5.0
    sample_solver: str = "unipc"  # unipc | dpm++ | euler
    num_train_timesteps: int = 1000
    seed: int = -1
    tma: TMAConfig = field(default_factory=TMAConfig)
    # fuse the CFG cond/uncond pair into one batch-2 DiT call
    fused_cfg_batch: bool = True


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


# Negative prompt used by all Wan configs (configs/shared_config.py:19)
DEFAULT_NEG_PROMPT = (
    "色调艳丽，过曝，静态，细节模糊不清，字幕，风格，作品，画作，画面，静止，整体发灰，最差质量，"
    "低质量，JPEG压缩残留，丑陋的，残缺的，多余的手指，画得不好的手部，画得不好的脸部，畸形的，"
    "毁容的，形态畸形的肢体，手指融合，静止不动的画面，杂乱的背景，三条腿，背景人很多，倒着走"
)


@dataclass(frozen=True)
class WanModelSpec:
    """A named Wan model family entry (DiT + VAE + sampling defaults)."""

    name: str
    dit: WanDiTConfig
    vae: WanVAEConfig
    generation: GenerationConfig
    text_len: int = 512
    num_train_timesteps: int = 1000
    sample_neg_prompt: str = DEFAULT_NEG_PROMPT
    # UMT5 encoder feeding the DiT cross-attention (t5.py:456-469);
    # t5.dim must equal dit.text_dim
    t5: T5Config = field(default_factory=T5Config)
    # A14B dual-expert MoE: two DiT param sets switched at boundary
    # (reference text2video.py:169-201, boundary at :306)
    moe_boundary: Optional[float] = None


def _ti2v_5b() -> WanModelSpec:
    return WanModelSpec(
        name="ti2v-5B",
        dit=WanDiTConfig(),
        vae=WanVAEConfig(),
        generation=GenerationConfig(),
    )


def _t2v_a14b() -> WanModelSpec:
    # Wan2.2 A14B (public release shape): 40 layers, dim 5120, 40 heads,
    # ffn 13824, 16ch VAE (2.1-style, stride (4,8,8)); two experts of this
    # shape, switched at moe_boundary * num_train_timesteps.
    dit = WanDiTConfig(
        model_type="t2v", in_dim=16, out_dim=16, dim=5120, ffn_dim=13824,
        num_heads=40, num_layers=40,
    )
    vae = WanVAEConfig(
        dim=96, dec_dim=96, z_dim=16, temporal_downsample=(True, True, False),
        spatial_patch=1, vae_stride=(4, 8, 8),
    )
    gen = GenerationConfig(size=(1280, 720), frame_num=81, fps=16, shift=12.0)
    return WanModelSpec(
        name="t2v-A14B", dit=dit, vae=vae, generation=gen, moe_boundary=0.875
    )


def _i2v_a14b() -> WanModelSpec:
    spec = _t2v_a14b()
    # i2v conditions on concat(mask, vae(frame0)) -> in_dim 16+20=36
    dit = dataclasses.replace(spec.dit, model_type="i2v", in_dim=36)
    gen = dataclasses.replace(spec.generation, shift=5.0)
    return dataclasses.replace(spec, name="i2v-A14B", dit=dit, generation=gen,
                               moe_boundary=0.900)


def _t2v_1_3b() -> WanModelSpec:
    # Wan2.1-T2V-1.3B (public release shape): dim 1536, 30 layers, 12 heads,
    # ffn 8960, 16ch VAE stride (4,8,8). Used by BASELINE.json config 3.
    dit = WanDiTConfig(
        model_type="t2v", in_dim=16, out_dim=16, dim=1536, ffn_dim=8960,
        num_heads=12, num_layers=30,
    )
    vae = WanVAEConfig(
        dim=96, dec_dim=96, z_dim=16, temporal_downsample=(True, True, False),
        spatial_patch=1, vae_stride=(4, 8, 8),
    )
    gen = GenerationConfig(size=(832, 480), frame_num=81, fps=16, shift=5.0)
    return WanModelSpec(name="t2v-1.3B", dit=dit, vae=vae, generation=gen)


def _tiny_smoke() -> WanModelSpec:
    # hermetic smoke-test config (not a reference model): 2-layer DiT +
    # tiny VAE, used by CLI --mock_weights runs and e2e tests.
    dit = WanDiTConfig(
        model_type="ti2v", in_dim=4, out_dim=4, dim=64, ffn_dim=128,
        freq_dim=32, text_dim=64, num_heads=4, num_layers=2, text_len=16,
    )
    vae = WanVAEConfig(
        dim=8, dec_dim=8, z_dim=4, dim_mult=(1, 2, 2, 2), num_res_blocks=1,
        temporal_downsample=(False, True, True), spatial_patch=2,
    )
    gen = GenerationConfig(size=(64, 64), frame_num=9, fps=8,
                           sampling_steps=4)
    t5 = T5Config(vocab_size=512, dim=64, dim_attn=64, dim_ffn=128,
                  num_heads=4, num_layers=2, text_len=16)
    return WanModelSpec(name="tiny", dit=dit, vae=vae, generation=gen,
                        t5=t5, text_len=16)


def _tiny_moe(i2v: bool = False) -> WanModelSpec:
    # hermetic dual-expert smoke config mirroring the A14B structure:
    # i2v in_dim = z + (4 mask + z) conditioning channels
    base = _tiny_smoke()
    dit = dataclasses.replace(
        base.dit, model_type="i2v" if i2v else "t2v",
        in_dim=(4 + 4 + 4) if i2v else 4)
    return dataclasses.replace(
        base, name="tiny-moe-i2v" if i2v else "tiny-moe-t2v", dit=dit,
        moe_boundary=0.875)


def animate_14b():
    """WanAnimate-14B -> (animate_cfg, vae_cfg, clip_cfg): the model's
    defaults, the Wan2.1 VAE (z 16, stride 4x8x8; t2v-1.3B's) and the
    ViT-H/14 visual tower (ClipVisionConfig's defaults)."""
    from ..models.wan.animate import ClipVisionConfig, WanAnimateConfig
    vae = WanVAEConfig(
        dim=96, dec_dim=96, z_dim=16,
        temporal_downsample=(True, True, False), spatial_patch=1,
        vae_stride=(4, 8, 8))
    return WanAnimateConfig(), vae, ClipVisionConfig()


def animate_tiny():
    """Hermetic smoke shape of the animate CLI path (head dim 8: the
    reference attention route)."""
    from ..models.wan.animate import ClipVisionConfig, WanAnimateConfig
    acfg = WanAnimateConfig(
        patch_size=(1, 2, 2), text_len=12, in_dim=12, dim=32, ffn_dim=64,
        freq_dim=16, text_dim=24, out_dim=4, num_heads=4, num_layers=5,
        motion_encoder_dim=16, clip_tokens=5, clip_dim=16, motion_size=16,
        motion_dim=4, vae_z_dim=4, face_width=8,
        motion_channels=((4, 16), (8, 16), (16, 8)))
    vae = WanVAEConfig(
        dim=8, dec_dim=8, z_dim=4, dim_mult=(1, 2, 2, 2),
        num_res_blocks=1, temporal_downsample=(False, True, True),
        spatial_patch=2)
    clip = ClipVisionConfig(image_size=28, patch_size=14, dim=16,
                            num_heads=2, num_layers=2)
    return acfg, vae, clip


ANIMATE_CONFIGS = {
    "animate-14B": animate_14b,
    "tiny-animate": animate_tiny,
}


WAN_CONFIGS = {
    "ti2v-5B": _ti2v_5b(),
    "t2v-A14B": _t2v_a14b(),
    "i2v-A14B": _i2v_a14b(),
    "t2v-1.3B": _t2v_1_3b(),
    "tiny": _tiny_smoke(),
    "tiny-moe-t2v": _tiny_moe(False),
    "tiny-moe-i2v": _tiny_moe(True),
}


def latent_shape(spec: WanModelSpec, width: int, height: int,
                 frame_num: int) -> Tuple[int, int, int, int]:
    """(C, F, H, W) latent grid for a pixel-space request.

    Matches reference textimage2video.py:284-288.
    """
    st, sh, sw = spec.vae.vae_stride
    return (
        spec.vae.z_dim,
        (frame_num - 1) // st + 1,
        height // sh,
        width // sw,
    )


def dit_seq_len(spec: WanModelSpec, width: int, height: int, frame_num: int,
                sp_size: int = 1) -> int:
    """Token count after patch embedding, padded to a multiple of sp_size.

    Matches reference textimage2video.py:289-291.
    """
    _, f, h, w = latent_shape(spec, width, height, frame_num)
    pt, ph, pw = spec.dit.patch_size
    seq = math.ceil((h * w) / (ph * pw) * f / sp_size) * sp_size
    return seq
