"""SAM2 video predictor: promptable streaming video segmentation
(counterpart of univid_tpu/models/sam2/predictor.py).

The supported workflow is the reference animate preprocess's: single
object, positive body-keypoint point prompts on a few key frames
(`add_new_points`), then forward propagation over the chunk
(`propagate_in_video`).

As in the JAX package, the memory bank is a FIXED-CAPACITY set of device
tensors: 8 conditioning-frame slots, a ring of 6 recent non-conditioning
memories and a ring of 15 object pointers, slot = t mod capacity, with
staleness checked again at read time against the query frame; invalid
slots are hidden from the memory cross-attention by a key mask rather
than sliced away. Published semantics (the sam2_hiera_l eval
configuration): 7 mask memories (cond + 6 most recent), 16 object
pointers split into mem_dim chunks, `directly_add_no_mem_embed`,
multimask-on-clicks with the dynamic stability fallback, a fixed
no-object pointer, binarized memory masks on clicked frames,
fill_hole_area 8.

Frames are normalized on the host (PIL), one frame at a time goes to the
device; the small-hole fill (scipy) and the resize to video resolution
(cv2) run on the host as in JAX. compute_dtype defaults to fp32, run
with TF32 off; bf16 casts the products and convolutions (fp32 softmax and
norm statistics regardless).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...core import nn as unn
from ...ops.resize import resize
from .hiera import (HieraConfig, Init, NeckConfig, hiera_forward,
                    init_hiera, init_neck, neck_forward, sine_pos_encoding)
from .memory import (MemoryConfig, init_memory_attention,
                     init_memory_encoder, memory_attention_forward,
                     memory_encoder_forward)
from .sam_heads import (NO_OBJ_SCORE, SamHeadConfig, dense_pe,
                        encode_points, init_mask_decoder,
                        init_prompt_encoder, mask_decoder_forward, mlp,
                        select_masks)


@dataclass(frozen=True)
class Sam2Config:
    image_size: int = 1024
    hiera: HieraConfig = field(default_factory=HieraConfig)
    neck: NeckConfig = field(default_factory=NeckConfig)
    head: SamHeadConfig = field(default_factory=SamHeadConfig)
    memory: MemoryConfig = field(default_factory=MemoryConfig)
    num_maskmem: int = 7                 # 1 cond slot class + 6 recent
    max_obj_ptrs: int = 16               # published max_obj_ptrs_in_encoder
    max_cond_frames: int = 8             # fixed capacity (ref uses <= 5)
    points_cap: int = 8                  # prompt padding capacity
    fill_hole_area: int = 8
    img_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    img_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    # matmul / conv compute dtype (fp32 softmax / norm islands regardless)
    compute_dtype: torch.dtype = torch.float32

    @property
    def grid(self) -> int:
        """Stride-16 feature grid side (SAM / memory resolution)."""
        return self.image_size // 16

    @property
    def ring_slots(self) -> int:
        return self.num_maskmem - 1

    @property
    def ptr_ring_slots(self) -> int:
        return self.max_obj_ptrs - 1

    @property
    def ptr_chunks(self) -> int:
        """Tokens per object pointer (256-d pointer -> 4 x 64-d)."""
        return self.memory.d_model // self.memory.mem_dim


def tiny_sam2_config(image_size: int = 64) -> Sam2Config:
    """A few-thousand-param config for CPU tests; same code paths."""
    g = image_size // 16
    return Sam2Config(
        image_size=image_size,
        hiera=HieraConfig(embed_dim=8, num_heads=1, stages=(1, 1, 1, 1),
                          window_spec=(2, 2, 2, 2), global_att_blocks=(3,),
                          window_pos_embed_bkg_size=2),
        neck=NeckConfig(d_model=32, num_pos_feats=32),
        head=SamHeadConfig(embed_dim=32, image_size=image_size,
                           embedding_grid=g, transformer_heads=2,
                           transformer_mlp_dim=64, upscale_ch=(16, 8),
                           iou_head_hidden=16),
        memory=MemoryConfig(d_model=32, mem_dim=8, num_layers=1,
                            dim_feedforward=32, feat_size=g),
        max_cond_frames=4, max_obj_ptrs=4)


def init_sam2(cfg: Sam2Config, *, gen: Optional[torch.Generator] = None,
              dtype=torch.float32, device="cuda") -> unn.Node:
    """Every parameter of the JAX package's init_sam2, by its names, drawn
    from `gen` with its distributions; left empty when gen is None."""
    mk = Init(dtype, device, gen)
    d = cfg.memory.d_model
    return unn.Node(
        trunk=init_hiera(cfg.hiera, mk),
        neck=init_neck(cfg.neck, cfg.hiera.channel_list, mk),
        prompt=init_prompt_encoder(cfg.head, mk),
        decoder=init_mask_decoder(cfg.head, mk),
        mem_enc=init_memory_encoder(cfg.memory, mk),
        mem_attn=init_memory_attention(cfg.memory, mk),
        # published SAM2Base learned embeddings (trunc_normal 0.02)
        no_mem_embed=mk.normal((1, 1, d), 0.02),
        no_mem_pos_enc=mk.normal((1, 1, d), 0.02),
        maskmem_tpos_enc=mk.normal((cfg.num_maskmem, 1,
                                    cfg.memory.mem_dim), 0.02),
        # use_mlp_for_obj_ptr_proj: 3-layer 256->256 MLP
        obj_ptr_proj=mk.mlp((d, d, d, d)),
        # fixed_no_obj_ptr learned pointer
        no_obj_ptr=mk.normal((d,), 0.02))


# -------------------------------------------------------------- steps


def encode_frame(params, cfg: Sam2Config, img):
    """img [1, S, S, 3] normalized -> (s0, s1, s16) neck features,
    high-res first (strides 4 / 8 / 16, all d_model channels)."""
    feats = hiera_forward(params.trunk, cfg.hiera, img,
                          compute_dtype=cfg.compute_dtype)
    (s0, s1, s16), _ = neck_forward(params.neck, cfg.neck, feats)
    return s0, s1, s16


def sam_heads(params, cfg: Sam2Config, pix_feat, high_res, points, labels,
              multimask: bool):
    """SAM prompt + decode on memory-conditioned features. Returns
    (low_res_mask [1, 4g, 4g], obj_ptr [1, d], obj_score [1, 1], the
    chosen mask slot [1])."""
    g = cfg.grid
    d = cfg.memory.d_model
    sparse = encode_points(params.prompt, cfg.head, points, labels)
    dense = params.prompt.no_mask.to(pix_feat.dtype).expand(1, g, g, d)
    image_pe = dense_pe(params.prompt.pe_gaussian, g)
    masks, iou, toks, obj_score = mask_decoder_forward(
        params.decoder, cfg.head, pix_feat, image_pe, sparse, dense,
        high_res_feats=high_res, compute_dtype=cfg.compute_dtype)
    mask, tok, _, slot = select_masks(cfg.head, masks, iou, toks,
                                      multimask)
    is_obj = obj_score[:, 0] > 0
    mask = torch.where(is_obj[:, None, None], mask, NO_OBJ_SCORE)
    ptr = mlp(params.obj_ptr_proj, tok)
    ptr = torch.where(is_obj[:, None], ptr,
                      params.no_obj_ptr.to(ptr.dtype)[None])
    return mask, ptr, obj_score, slot


def upsample_mask(cfg: Sam2Config, low_res):
    """[1, 4g, 4g] logits -> [1, S, S, 1] at model input resolution
    (jax.image.resize's bilinear)."""
    s = cfg.image_size
    return resize(low_res.float(), (1, s, s), "bilinear")[..., None]


def cond_frame_step(params, cfg: Sam2Config, img, points, labels,
                    multimask: bool, binarize: bool):
    """Initial-conditioning track step (no memory yet): the published
    is_init_cond_frame + directly_add_no_mem_embed path. Returns
    (low_res_mask, obj_ptr, maskmem [1, g, g, mem], obj_score, slot)."""
    s0, s1, s16 = encode_frame(params, cfg, img)
    pix = s16 + params.no_mem_embed.to(s16.dtype).reshape(1, 1, 1, -1)
    mask, ptr, score, slot = sam_heads(params, cfg, pix, (s0, s1), points,
                                       labels, multimask)
    mem, _ = memory_encoder_forward(params.mem_enc, cfg.memory, s16,
                                    upsample_mask(cfg, mask),
                                    binarize=binarize)
    return mask, ptr, mem, score, slot


def bank_memory(params, cfg: Sam2Config, t: int, bank):
    """The memory cross-attention's keys for query frame t: (memory
    [1, M, mem], memory_pos [1, M, mem], key_mask [M], pointer tokens)."""
    g = cfg.grid
    n = g * g
    mem_dim = cfg.memory.mem_dim
    dev = bank["cond_mem"].device
    tpos = params.maskmem_tpos_enc                    # [num_maskmem, 1, mem]
    mem_pos_grid = sine_pos_encoding(g, g, mem_dim, dev).reshape(n, mem_dim)

    # cond slots: t_pos = 0 -> tpos index num_maskmem - 1
    c = cfg.max_cond_frames
    cond_tpos = tpos[cfg.num_maskmem - 1][None]
    cond_mem = bank["cond_mem"] + cond_tpos
    cond_pos = mem_pos_grid[None].expand(c, n, mem_dim) + cond_tpos
    cond_key = bank["cond_valid"].repeat_interleave(n)

    # ring slots: memory at distance t_rel in [1, ring_slots] gets tpos
    # index t_rel - 1 (published maskmem_tpos_enc[num_maskmem - t_pos - 1]
    # with t_rel = num_maskmem - t_pos)
    r = cfg.ring_slots
    t_rel = t - bank["ring_t"]                                   # [r]
    ring_ok = bank["ring_valid"] & (t_rel >= 1) & (t_rel <= r)
    ring_tpos = tpos[(t_rel - 1).clamp(0, cfg.num_maskmem - 1)]  # [r,1,mem]
    ring_mem = bank["ring_mem"] + ring_tpos
    ring_pos = mem_pos_grid[None].expand(r, n, mem_dim) + ring_tpos
    ring_key = ring_ok.repeat_interleave(n)

    # object pointers: cond pointers + recent non-cond ring, each split
    # into ptr_chunks mem_dim tokens, zero positional encoding
    # (add_tpos_enc_to_obj_ptrs=false in the sam2_hiera_l config)
    pr = cfg.ptr_ring_slots
    ptr_rel = t - bank["ptr_t"]
    ptr_ok = bank["ptr_valid"] & (ptr_rel >= 1) & (ptr_rel <= pr)
    ptrs = torch.cat([bank["cond_ptrs"], bank["ptrs"]], dim=0)
    ptr_key_per = torch.cat([bank["cond_valid"], ptr_ok], dim=0)
    ptr_tokens = ptrs.reshape(-1, mem_dim)
    ptr_key = ptr_key_per.repeat_interleave(cfg.ptr_chunks)

    memory = torch.cat([cond_mem.reshape(-1, mem_dim),
                        ring_mem.reshape(-1, mem_dim), ptr_tokens])[None]
    memory_pos = torch.cat([cond_pos.reshape(-1, mem_dim),
                            ring_pos.reshape(-1, mem_dim),
                            torch.zeros_like(ptr_tokens)])[None]
    key_mask = torch.cat([cond_key, ring_key, ptr_key])
    return memory, memory_pos, key_mask, ptr_tokens.shape[0]


def propagate_step(params, cfg: Sam2Config, img, t: int, bank):
    """One non-cond tracking step: encode -> memory attention over the
    fixed-capacity bank -> SAM head with an empty prompt -> memory encode
    (sigmoid masks). Returns (low_res_mask, obj_ptr, maskmem, obj_score,
    slot)."""
    g = cfg.grid
    n = g * g
    d = cfg.memory.d_model
    s0, s1, s16 = encode_frame(params, cfg, img)
    memory, memory_pos, key_mask, num_ptr_tokens = bank_memory(
        params, cfg, t, bank)
    curr = s16.reshape(1, n, d)
    curr_pos = sine_pos_encoding(g, g, d, s16.device).reshape(1, n, d)
    cond_feat = memory_attention_forward(
        params.mem_attn, cfg.memory, curr, curr_pos, memory, memory_pos,
        num_obj_ptr_tokens=num_ptr_tokens, key_mask=key_mask,
        compute_dtype=cfg.compute_dtype)
    pix = cond_feat.reshape(1, g, g, d)
    points = torch.zeros((1, 1, 2), dtype=torch.float32, device=s16.device)
    labels = -torch.ones((1, 1), dtype=torch.int32, device=s16.device)
    mask, ptr, score, slot = sam_heads(params, cfg, pix, (s0, s1), points,
                                       labels, multimask=False)
    mem, _ = memory_encoder_forward(params.mem_enc, cfg.memory, s16,
                                    upsample_mask(cfg, mask),
                                    binarize=False)
    return mask, ptr, mem, score, slot


# ------------------------------------------------------------ host pieces


def fill_small_holes(mask_logits: np.ndarray, area: int) -> np.ndarray:
    """Published fill_holes_in_mask_scores: connected components of the
    <=0 region smaller than `area` pixels are flipped to a small
    positive score (0.1)."""
    if area <= 0:
        return mask_logits
    from scipy import ndimage
    out = mask_logits.copy()
    lab, num = ndimage.label(out <= 0)
    if num:
        sizes = np.bincount(lab.ravel())
        small = (sizes <= area)
        small[0] = False
        out[small[lab]] = 0.1
    return out


def normalize_frames(cfg: Sam2Config, frames: Sequence[np.ndarray]):
    """Reference load_video_frames_v2: square resize to image_size (PIL
    default bicubic), /255, ImageNet normalize. Returns (images [T, S, S,
    3] f32 on the host, H, W)."""
    from PIL import Image
    s = cfg.image_size
    h, w = frames[0].shape[:2]
    mean = np.asarray(cfg.img_mean, np.float32)
    std = np.asarray(cfg.img_std, np.float32)
    images = np.empty((len(frames), s, s, 3), np.float32)
    for i, f in enumerate(frames):
        f = np.asarray(f)
        if f.dtype != np.uint8:
            f = np.clip(f, 0, 255).astype(np.uint8)
        img = Image.fromarray(f).convert("RGB").resize((s, s))
        images[i] = np.asarray(img, np.float32) / 255.0
    images -= mean
    images /= std
    return images, h, w


class Sam2VideoPredictor:
    """Reference-compatible surface (video_predictor.py): the
    single-object, points-then-propagate workflow the animate preprocess
    uses, on the device of `params`. State is an explicit dict."""

    def __init__(self, params, cfg: Sam2Config):
        self.params = params
        self.cfg = cfg
        self.device = next(params.parameters()).device

    def _image(self, state, t):
        return torch.from_numpy(state["images"][t][None]).to(self.device)

    # -- state ------------------------------------------------------

    def init_state_v2(self, frames: Sequence[np.ndarray]) -> dict:
        images, h, w = normalize_frames(self.cfg, frames)
        return {"images": images, "num_frames": len(images),
                "video_height": h, "video_width": w, "obj_id": None,
                "cond": {}}       # frame_idx -> dict(mask, ptr, mem)

    def reset_state(self, state: dict) -> None:
        state["obj_id"] = None
        state["cond"] = {}

    # -- interactions -----------------------------------------------

    def add_new_points(self, inference_state: dict, frame_idx: int,
                       obj_id: int, points: np.ndarray,
                       labels: np.ndarray, normalize_coords: bool = True):
        """Positive/negative point prompts on one frame (pre-tracking).
        `points` [N, 2] in original video pixels (x, y); labels [N] in
        {0, 1}. Returns (frame_idx, [obj_id], video_res_mask_logits)."""
        state = inference_state
        if state["obj_id"] is not None and state["obj_id"] != obj_id:
            raise NotImplementedError(
                "single-object tracking only (the reference preprocess "
                "tracks one person)")
        state["obj_id"] = obj_id
        cfg = self.cfg
        pts = np.asarray(points, np.float32).reshape(-1, 2)
        lab = np.asarray(labels, np.int32).reshape(-1)
        if pts.shape[0] > cfg.points_cap:
            raise ValueError(f"got {pts.shape[0]} points; capacity is "
                             f"{cfg.points_cap} (Sam2Config.points_cap)")
        if normalize_coords:
            wh = np.array([state["video_width"], state["video_height"]],
                          np.float32)
            pts = pts / wh * cfg.image_size
        n = pts.shape[0]
        pad = cfg.points_cap - n
        pts = np.pad(pts, ((0, pad), (0, 0)))
        lab = np.pad(lab, (0, pad), constant_values=-1)
        # published _use_multimask: clicks with <= 1 point get the
        # multimask head; >= 2 points the single-mask + stability path
        multimask = n <= 1
        with torch.no_grad(), unn.exact_fp32():
            mask, ptr, mem, score, slot = cond_frame_step(
                self.params, cfg, self._image(state, frame_idx),
                torch.from_numpy(pts[None]).to(self.device),
                torch.from_numpy(lab[None]).to(self.device), multimask,
                True)
        low = fill_small_holes(mask[0].float().cpu().numpy(),
                               cfg.fill_hole_area)
        state["cond"][frame_idx] = {
            "mask": low, "ptr": ptr[0], "mem": mem[0],
            "score": float(score[0, 0]), "slot": int(slot[0])}
        return frame_idx, [obj_id], self._to_video_res(state, low)[None]

    # -- propagation -------------------------------------------------

    def propagate_in_video(self, inference_state: dict,
                           start_frame_idx: Optional[int] = None,
                           max_frame_num_to_track: Optional[int] = None,
                           ) -> Iterator[Tuple[int, List[int],
                                               np.ndarray]]:
        """Forward tracking from the first conditioning frame. Yields
        (frame_idx, [obj_id], video_res_mask_logits [1, 1, H, W]):
        threshold > 0 for binary masks, as the reference consumer does.
        Each propagated frame's low-res logits and mask slot are kept in
        state["tracked"]."""
        state = inference_state
        cfg = self.cfg
        if not state["cond"]:
            raise RuntimeError("no points were added; call "
                               "add_new_points first")
        cond_idx = sorted(state["cond"])
        if len(cond_idx) > cfg.max_cond_frames:
            raise ValueError(
                f"{len(cond_idx)} conditioning frames exceed the fixed "
                f"bank capacity {cfg.max_cond_frames}; raise "
                "Sam2Config.max_cond_frames")
        start = (start_frame_idx if start_frame_idx is not None
                 else cond_idx[0])
        end = state["num_frames"]
        if max_frame_num_to_track is not None:
            end = min(end, start + max_frame_num_to_track + 1)

        bank = self.make_bank(state, cond_idx)
        obj_ids = [state["obj_id"]]
        state["tracked"] = {}
        for t in range(start, end):
            if t in state["cond"]:
                low = state["cond"][t]["mask"]
            else:
                with torch.no_grad(), unn.exact_fp32():
                    mask, ptr, mem, _, slot = propagate_step(
                        self.params, cfg, self._image(state, t), t, bank)
                low = mask[0].float().cpu().numpy()
                state["tracked"][t] = {"mask": low, "slot": int(slot[0])}
                bank = self.push(bank, t, mem[0], ptr[0])
            yield t, obj_ids, self._to_video_res(state, low)[None]

    # -- internals ---------------------------------------------------

    def make_bank(self, state: dict, cond_idx: List[int]) -> dict:
        cfg = self.cfg
        n = cfg.grid * cfg.grid
        mem_dim, d = cfg.memory.mem_dim, cfg.memory.d_model
        c, r, pr = cfg.max_cond_frames, cfg.ring_slots, cfg.ptr_ring_slots
        f32 = dict(dtype=torch.float32, device=self.device)
        i32 = dict(dtype=torch.int32, device=self.device)
        b8 = dict(dtype=torch.bool, device=self.device)
        bank = {
            "cond_mem": torch.zeros((c, n, mem_dim), **f32),
            "cond_ptrs": torch.zeros((c, d), **f32),
            "cond_valid": torch.zeros((c,), **b8),
            "ring_mem": torch.zeros((r, n, mem_dim), **f32),
            "ring_t": torch.full((r,), -10 ** 9, **i32),
            "ring_valid": torch.zeros((r,), **b8),
            "ptrs": torch.zeros((pr, d), **f32),
            "ptr_t": torch.full((pr,), -10 ** 9, **i32),
            "ptr_valid": torch.zeros((pr,), **b8),
        }
        for i, fi in enumerate(cond_idx):
            out = state["cond"][fi]
            bank["cond_mem"][i] = out["mem"].reshape(n, mem_dim)
            bank["cond_ptrs"][i] = out["ptr"]
            bank["cond_valid"][i] = True
        return bank

    def push(self, bank: dict, t: int, mem, ptr) -> dict:
        """Ring-buffer insert of a non-cond frame's memory + pointer
        (slot = t mod capacity; staleness is re-checked at read time
        against the query frame index). Returns a new bank; the given one
        is left as it was."""
        cfg = self.cfg
        n = cfg.grid * cfg.grid
        i, j = t % cfg.ring_slots, t % cfg.ptr_ring_slots
        bank = {k: v.clone() for k, v in bank.items()}
        bank["ring_mem"][i] = mem.reshape(n, cfg.memory.mem_dim)
        bank["ring_t"][i] = t
        bank["ring_valid"][i] = True
        bank["ptrs"][j] = ptr
        bank["ptr_t"][j] = t
        bank["ptr_valid"][j] = True
        return bank

    def _to_video_res(self, state: dict, low: np.ndarray) -> np.ndarray:
        """[4g, 4g] logits -> [1, H, W] float logits at video res."""
        import cv2
        h, w = state["video_height"], state["video_width"]
        out = cv2.resize(low.astype(np.float32), (w, h),
                         interpolation=cv2.INTER_LINEAR)
        return out[None]


# ----------------------------------------------------------- mask_fn seam


# the 8 body joints used as positive point prompts (nose, neck,
# shoulders, hips, wrists)
KEY_POINT_INDICES = (0, 1, 2, 5, 8, 11, 10, 13)


def build_sam2_mask_fn(params, cfg: Sam2Config, *, th_step: int = 400):
    """`mask_fn(frames, metas) -> [T, H, W] uint8` adapter for the animate
    preprocess chain: the reference's chunked keyframe-prompt driving loop
    (<= 400-frame chunks, 4 key frames a chunk, 1 if the chunk is <= 4
    frames, confident body joints from KEY_POINT_INDICES as positive
    clicks)."""
    predictor = Sam2VideoPredictor(params, cfg)

    def mask_fn(frames: np.ndarray, metas) -> np.ndarray:
        t = len(frames)
        num_step = 1 if t < th_step else (t + th_step) // th_step
        all_masks: List[np.ndarray] = []
        for s in range(num_step):
            chunk = frames[s * th_step: (s + 1) * th_step]
            ms = metas[s * th_step: (s + 1) * th_step]
            if len(chunk) == 0:
                continue
            key_n = 4 if len(chunk) > 4 else 1
            step = max(len(ms) // key_n, 1)
            key_idx = list(range(0, len(ms), step))
            state = predictor.init_state_v2(list(chunk))
            predictor.reset_state(state)
            for ki in key_idx:
                body = ms[ki].body
                pts = [body[j, :2] for j in KEY_POINT_INDICES
                       if j < body.shape[0] and body[j, 2] > 0]
                if not pts:
                    continue
                predictor.add_new_points(
                    state, frame_idx=ki, obj_id=1,
                    points=np.asarray(pts, np.float32),
                    labels=np.ones((len(pts),), np.int32))
            seg = {}
            for fi, _, logits in predictor.propagate_in_video(state):
                seg[fi] = (logits[0, 0] > 0.0).astype(np.uint8)
            all_masks.extend(seg[i] for i in range(len(seg)))
        return np.stack(all_masks)

    return mask_fn
