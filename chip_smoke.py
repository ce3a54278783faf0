"""GPU smoke run of the PyTorch/CUDA port (univid_tpu_torch) on one card.

    python3 chip_smoke.py                  # build, check, serve and train
    python3 chip_smoke.py --steps 2        # fewer denoise steps
    python3 chip_smoke.py --train-steps 2  # fewer training steps
    python3 chip_smoke.py --kernels-only

Phases:
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels (one nvcc per source, in parallel);
  3. hold each kernel against its plain PyTorch version at its path's
     shapes, time both with CUDA events, and time one PyTorch library call
     (scaled_dot_product_attention, with the boolean mask for masked
     modes; its backward for the backward kernels) on the same inputs as a
     yardstick: serving self- and cross-attention, the q / k pre-pass
     (kernel A of qk_prepass.cu from pre-norm q and k: norm + rope, rope
     only and norm only, each timed in turns with the passes it replaced,
     unn.rms_norm and univid_rope_rotate_bf16, `prepass_vs_old` lines;
     F.rms_norm the norm-only row's yardstick) and the fp32 VAE
     kernel (d=1024, 640 at ti2v-5B's 3,520 tokens, d=384; 3xTF32 on the
     tensor cores, timed in turns with the CUDA-core kernel it replaced,
     `tc_vs_simt` lines, and the name of the kernel SDPA's fp32 call runs),
     the serving kernels again at the ti2v-5B shapes and at the A14B
     shapes (40 heads: self [2, 32768, 40, 128] over 32,760 keys, cross
     over [2, 512, 40, 128], kernel A; `kernel_at_a14b_shape` lines, the
     kernels line's `*_a14b` entries); the training forward with lse
     and the dq and dk/dv kernels at the self and cross shapes, and
     attention() under grad against autograd through an fp32 reference;
     the one-pass sm90 backward (flash_attention_bwd_sm90.cu) at the same
     two shapes, timed in turns with the mma.sync pair it replaced in the
     unmasked modes (`bwd_sm90_vs_mma_sync` lines; its three launches'
     device times on `bwd_sm90_kernels_*` lines), a kv_len = 0 row exactly
     zero;
     the causal mode at the BAGEL QA shapes (question prefill over the
     20,480-row cache, a 16-row batch, a square 2,048 prefill) on
     flash_attention_causal_sm90.cu (its split count and packing logged),
     timed in turns with the mma.sync kernel it replaced, rows with no live
     key exactly 0 with lse +1e30, and the grouped ViT append; the
     grouped running-max mode at BAGEL image generation's flow passes
     ([1, 4098, 28, 128] over 4,162 keys, text to image, and over 13,162,
     editing) beside SDPA, its bound and its plain version; the packed mode (forward with and without lse,
     backward) on the BAGEL training pack's own codes, [1, 4096, 28, 128],
     and padded 4,000 -> 4,032 (pad rows exactly 0, lse +1e30); the
     segment mode at [2, 2048, 12, 128]; their forwards run on the sm90
     kernel over the forward list of tile_lists (mask_tiles_sm90.cu: both
     lists in one launch, from runs of equal codes; both lists equal to
     the plain lists bit for bit at the pack, the padded pack with kv_len,
     the segments and the causal backward cases; at the pack timed in
     turns with the two pre-passes it replaced beside an empty launch,
     CUDA events and device time, `tile_lists_vs_old` line, with the runs
     per tile; the old pre-passes' lists also equal to the plain lists)
     and are timed in turns with the
     mma.sync kernel they replaced; the causal backward (and the causal
     forward with lse, in turns with the mma.sync kernel) at the
     square prefill's shape, offset 0 and q_offsets [0, 37]; every masked
     backward on the one-pass sm90 kernel over its kv-major tile list
     (pad rows and keys no row sees exactly 0), timed in turns
     with the mma.sync dq and dk/dv pair it replaced
     (`bwd_sm90_vs_mma_sync` lines, with the kv tiles in descending and
     in ascending order of list length), each launch's device time logged
     (`bwd_sm90_kernels` lines); the fp32 d=128
     kernels (the forward running, bounded and with the lse, the rope
     pre-pass, dq and dk/dv) at the fp32 fine-tune's self [1, 32768, 12,
     128] and cross (512 keys) shapes, SDPA on fp32 inputs as yardstick:
     the route's flash_attention_f32_sm90.cu (wgmma on three bf16 parts of
     each operand, after the split pre-pass, its parts equal to the plain
     split) and the CUDA-core kernels it replaced, both against the plain
     version, timed in turns, whole calls and kernels alone
     (`f32_sm90_vs_cuda_cores` lines); two sm90 backward calls equal bits.
     The bf16 forward's unmasked modes run on the Hopper kernel
     (flash_attention_sm90.cu): at every shape above where they appear
     (self-attention bounded, cross-attention bounded and one-shot, the
     training forward with lse at the self and cross shapes, the ViT
     append, softmax_bf16 self- and cross-attention, at the t2v-1.3B and
     ti2v-5B shapes) it is timed in turns with the mma.sync kernel it
     replaces (old, new, new, old; `sm90_vs_mma_sync` lines, the records'
     `mma_sync_ms`); the training CLI's shapes (`check_train_cli_kernels`:
     the forward with lse and the one-pass backward at ti2v-5B's [1, 960,
     24, 128], running max, self and over 512 keys; the VAE kernel at
     d=640 on 640 tokens), the kernels line's `*_train_cli` records;
  4. hold the port on the card (kernels) against the port on the CPU
     (plain versions) on small d=128 models: the t2v pipeline, the
     FusionPipeline in t2v and i2v (with the ti2v-5B VAE), the A14B
     dual-expert WanMoEPipeline in t2v and i2v (two 2-block d=128 experts,
     the A14B VAE, 2 steps: one on each expert), three LoRA +
     projector diffusion train steps and the training loop; the
     full-width BAGEL extractor and projector (bf16, 1280x704 image)
     against the CPU at a 224x224 and a 300x500 crop; a small BAGEL's
     video-QA context and teacher-forced logits; a small BAGEL's image
     generation (text to image and editing through interleave_inference,
     with a small FLUX AE: latent and image, and the launches of each
     loop); a small BAGEL's packed
     training loss and every gradient leaf, freeze_und off and on; two
     fp32 make_dit_train_step steps and the fp32 t2v pipeline (fused rope)
     on a small d=128 DiT;
  5. drive the serving path through the port's CLI: t2v-1.3B at
     832x480x81, full depth and width, random weights from a seed, a few
     steps; check the kernels' launch counts and the mp4; then the same
     path from a checkpoint: write a Wan2.1-layout t2v-1.3B dir at full
     width from the pinned manifests, cut to 10 of the DiT's 30 blocks and
     6 of UMT5's 24 (CKPT_LAYERS; the DiT as two fp32
     safetensors shards with their index, by write_safetensors;
     Wan2.1_VAE.pth fp32; the UMT5 .pth bf16), audit each file against
     its manifest, load them onto the card (load_wan_checkpoint,
     load_state_dict + convert_umt5; seconds per file, peak host RSS and
     device memory), hold every parameter to the written tensor bit for
     bit with JAX's leaf dtypes, check that WanTextEncoder.from_checkpoint
     raises without a tokenizer, run 2 steps + the decode through
     WanTI2VPipeline (main_path's launches for 2 steps, finite latents,
     an 81-frame 480x832 mp4), and delete the dir;
  6. drive the training path: t2v-1.3B at 832x480x81, LoRA + projector,
     remat 'attn', a few make_diffusion_train_step steps; check the launch
     counts of every step (59 one-pass sm90 backward calls, none on the
     mma.sync pair), a finite loss, LoRA b off zero, the frozen base
     unchanged; print seconds per step and peak memory; profile one more
     step (device time by kernel family, idle share);
  6b. drive the training CLI (`train_cli_on_card`): an OpenVid dir
     written here (three smooth 640x360 clips of 25 frames, a CSV whose
     filters keep two), each kept clip decoded by OpenVidDataset to the
     frames written within an h264 tolerance, never zeros; then
     univid_tpu_torch.cli.train.main at the JAX CLI's defaults, ti2v-5B
     at 512x320x21 (full width: the 30-block DiT in fp32, the Wan2.2 VAE,
     960 tokens), --mock_weights --train_lora, 3 steps, each step's
     latents, tokens and padding as run and its launches checked (1 serving self-attention, 59 forwards with lse, 59
     one-pass sm90 backward calls, 6 d=640 VAE calls), LoRA b off zero,
     finite losses, the frozen base unchanged, latest/, best/ and
     lora_best/ written; then 3 semantic steps with UMT5-XXL, no kernel;
  7. drive the CLI's default path: ti2v-5B with BAGEL fusion, --mode i2v
     at 1280x704x121 (a seeded first-frame png), full depth and width, 2
     steps; check the mp4, the fusion context, the peak memory and the
     launches (the fp32 VAE kernel once per decoded chunk at d=1024, once
     more at d=640 for the i2v encode, never at d=384); then the t2v mode
     knob-free on the same pipeline, one step and no decode (one of --mode
     both's two decodes is cut for the time limit), its launches and a
     finite latent checked;
  7b. drive Wan2.2 A14B serving through the CLI at full width and depth
     (two 40-block experts, 57.15 GB in bf16), 832x480x81, 2 steps (one
     on each expert): t2v-A14B --no_bagel, then i2v-A14B with a seeded
     first frame and the fusion context, each model freed before the next
     is drawn; check both mp4s, each request's launches (40 a DiT call of
     self- and cross-attention and of kernel A's two modes, 21 d=384 VAE
     calls a decode and 21 for the i2v encode), both experts resident
     through the denoise, and log each phase's peak memory; then, with
     both t2v-A14B experts resident, one 480p DiT call profiled and one
     bare call at the published 1280x720x81 (75,600 tokens padded to
     75,776): seconds, peak memory, launches;
  8. drive the video-QA path: one full-width BAGEL-7B-MoT reflexion
     request (7 of its 28 layers, BAGEL_QA_LAYERS; 16 seed captions,
     K = 4, 8, 16, 512-token greedy decodes)
     with the launches of each phase checked (the 21 causal question
     prefills on the causal sm90 kernel, each QA call's text_prefill_s
     logged); time the question's prefill over the 16-frame context with
     the causal kernel and the mma.sync kernel in turns; profile 16 decode
     steps;
  8b. drive BAGEL image generation at full width and depth: a synthetic
     full-size FLUX ae.safetensors written, loaded and held bit for bit,
     the AE card vs CPU at 256x256 (fp32, rel. L2 < 1e-4); BAGEL-7B-MoT
     (all 28 layers) with the SigLIP so400m tower and that AE in a
     16,384-row inferencer: text to image at 1024x1024 (50 timesteps,
     three CFG branches every step, global renorm) and editing (a
     1024x1024 image through the FLUX encode, the VAE and ViT appends, an
     instruction, 8 timesteps), each from zero counts with every call's
     launches checked (28 x 3 x (T - 1) flash_attention_bf16 a loop, 28 an
     append, 28 causal a prefill), the images (1024x1024x3, finite, in
     [0, 1]) and each context unchanged by gen_image; the seconds of each
     call and flow step, peak memory; one flow step profiled;
  9. drive the BAGEL packed-training path: BAGEL-7B-MoT at full width on
     one 4,096-token pack of the four sample kinds, freeze_und; one
     untimed training pass to warm up (its seconds and allocator growth
     logged), then 3 evaluation forwards (28 packed forwards and one
     tile_lists launch each: the pass's tile plan) and 3 training passes
     (28 packed forwards with lse, 28 one-pass sm90 backward calls, one
     tile_lists launch, none on the mma.sync pair or the old tile-list
     pre-passes), medians and
     spreads; finite loss,
     gradients in every trainable leaf, peak memory; profile one more
     evaluation forward and one more training pass;
  9b. on the same BAGEL-7B-MoT, one training pass on a 4,096-token pack
     fed the way a training run feeds itself (`registry_pack_pass`): JSONL
     files and images written to disk, three groups (t2i_pretrain,
     vlm_sft, unified_edit) from the port's load_data_groups with a dict
     config, the vae entries through the full-size FLUX AE on the card;
     launches asserted from zero counts, a finite loss; the packed pair
     (forward with lse, one-pass backward) at this pack's codes against
     its plain version and SDPA;
 10. drive the full DiT fine-tune at its default fp32 policy:
     make_dit_train_step on t2v-1.3B at 832x480x81, full width, 10 of its
     30 blocks (the time limit), remat 'attn', 2 steps (on the sm90
     kernels: 30 forwards with lse, 20 dq, 20 dk/dv and 170 split
     pre-passes a step, none on the CUDA-core kernels);
     finite losses, every block's weights moved, seconds, peak memory;
     profile one more step (kernel families, attention's share, idle
     share), and derive the 30-block step from it;
 11. run the port's QA CLI with --mock_weights; then with --siglip_ckpt
     at a full-width siglip2-base-patch16-naflex dir written from its
     pinned manifest (the NaFlex scorer, the LM-tokenizer fallback's
     warning, rounds [4, 8, 16]), and that dir's scorer on the card
     against the CPU (fp32, 8 frames of mixed aspect ratios and a
     question: rel. L2 < 1e-4);
 12. drive the Wan serving knobs: ti2v-5B with fusion, --mode t2v at
     1280x704x41 (KNOB_FRAMES, cut from 121 for the time limit), full depth and
     width, with --bf16_softmax --qk_int8
     --int8 --taylorseer 2, 6 steps (5 DiT calls); check the mp4 and the
     launches (per DiT call 30 int8 bf16-softmax self-attention, 30
     bf16-softmax cross-attention, 60 norm-only q / k pre-passes, 30 int8
     pre-passes of two launches, 300 W8A8 GEMMs; no knob-free attention,
     none on the mma.sync int8 kernel); print seconds per DiT and per
     Taylor step, for the video, peak memory; time the ti2v-5B DiT
     forward at 1280x704x121 bare, with each knob alone and all four (one
     timed forward
     each, after one whose launches are checked), and profile one bare and
     one with
     qk_int8 alone (device time by kernel family, the q / k pre-passes
     apart);
 13. drive multi-GPU serving with two ranks on the one card over gloo
     (`sp_main_path`; NCCL refuses two ranks on one device): t2v-1.3B at
     full width, SP_LAYERS blocks, the same seeded weights on each rank;
     WanTI2VPipeline(sp_size=2, mesh) for 2 UniPC steps at 832x480x81
     (Ulysses, fused rope; the launches of each rank checked: per block
     and step one self-attention at 6 heads after kernel A's rope-only
     mode, one cross-attention, kernel A's norm-only mode before the
     exchange and for the cross q / k) held to the single-rank pipeline's
     latent; one ring DiT call held to wan_dit_forward (two lse launches
     a block a rank); one ring_attention call with a kv shard all padding
     held to one kernel call over every key; on an fsdp = 2 mesh one DiT
     call and one UMT5-XXL (fp32, SP_T5_LAYERS blocks) encode held to the
     unsharded module; seconds per step at sp = 2 against one rank, the
     collectives' share, peak memory per rank.
The kernels at the multi-GPU path's shard shapes (Ulysses self-attention
[2, 32768, 6, 128] with kernel A's rope-only mode, the ring's lse kernel
at q [2, 16384, 12, 128] over a 16,384-key shard with kv_len 16,384,
16,376 and 0, cross-attention [2, 16384, 12, 128], kernel A's norm-only
mode on a rank's q and k) are held against their plain versions in phase
3 (`check_sp_kernels`); the kernels line carries them as `*_sp` records
with the sp run's launches (both ranks), and every record's
`launches_by_path` has `sp` and `sp_ring`. Sequence and tensor
parallelism together (`sp_tp_main_path`, four ranks on the one card): the
sp 2 x tp 2 Ulysses pipeline (SP_TP_LAYERS blocks, 2 steps, 3 heads a
rank after the exchange) and a ring DiT call on that mesh, each held to
one rank; one fp32 train step on an fsdp 2 x sp 2 mesh held to the
one-rank step, the sp replicas' shards bitwise equal after it. Its shard
shapes are checked by `check_sp_kernels(tp=2)` (`*_sp_tp` records,
launches from the `sp_tp` and `sp_tp_ring` paths).
The knob kernels (softmax_bf16 on self- and cross-attention, the int8
pre-pass, kernel B of qk_prepass.cu, timed in turns with the pair of
flash_attention_int8.cu it replaced, both against the plain version,
`prepass_vs_old` lines; the int8 QK^T kernel alone and with softmax_bf16: the
route's flash_attention_int8_sm90.cu, s8 wgmma / TMA multicast / warp
specialisation, bounded and running, and the mma.sync kernel it replaced,
timed in turns, `int8_sm90_vs_mma_sync` lines, a kv_len = 0 row exactly 0)
are held against their plain versions at the ti2v-5B and t2v-1.3B shapes
in phase 3, and each knob alone and all four card against CPU on a small
d=128 DiT in phase 4.
FLUX.1 Kontext editing: in phase 3 the sm90
forward at the edit's joint attention, [1, 8704, 24, 128] bf16, running
max, and at a padded bucket (8,652 tokens, kv_len), against its plain
version beside SDPA and the 0.941 ms bound (`check_kontext_kernels`); in
phase 4 a small d=128 editor (hidden 256, 2 + 2 blocks, tiny T5, CLIP and
AE) card against CPU, 4 steps on a 256x256 image (latent and image rel.
L2 < 3e-2), and load_kontext_checkpoint of a tiny synthetic dir on the
card bit for bit against the CPU load (`small_kontext_parity`); after
phase 8b the full 11.9 B transformer with T5-XXL v1.1 and CLIP-L on
random bf16 weights, one 1024x1024 edit through make_edit_fn at 28 steps
and guidance 2.5 (a u8 image, a finite latent, 1,596 sm90 launches and
no reference-route call at d=128; s/edit, s/step, peak memory, one
profiled transformer pass), then the transformer quantized weight-only
in place and a KONTEXT_INT8_STEPS edit (`kontext_main_path`).
WanAnimate: in phase 3 the animate DiT's attention at its 832x480x77
shapes (`check_animate_kernels`: self-attention [1, 32768, 40, 128] over
32,760 keys, running max; the one-shot cross kernel over the 512 text keys
and over the 257 CLIP-image keys padded to 320; the fp32 face call, q [21,
1600, 40, 128] over 5 motion tokens padded to 64, a kv_len = 0 row exactly
0), each against its plain version beside SDPA and its bound; in phase 4 a
small d=128 animate pipeline (hidden 256, 10 layers: two face adapters;
the tiny VAE, CLIP and UMT5) card against CPU, 2 steps at guidance 1.5,
two clips, then replace mode, then a relighting LoRA merged (latent and
video rel. L2 < 3e-2; `small_animate_parity`); after the Kontext edit,
animate-14B (17.3 B parameters) through the CLI on a src_root_path written
on the card (77 frames of 832x480, 512x512 faces), one clip, 2 steps at
guidance 5.0: a 77-frame mp4, a finite video, 160 self-attention, 320
cross (160 text, 160 image), 32 fp32 face and 61 d=384 VAE launches, none
on the mma.sync kernel or at d=128 on the reference route; s/forward, the
motion encoder's seconds, peak memory by phase, the last forward profiled
(`animate_main_path`); then one bare 1280x720x77 forward on the same DiT
and its self-attention and face call alone at that shape
(`animate_dit_720p`).
The animate preprocess (no kernel: JAX's SAM2 attention is plain einsums,
its ONNX executor numpy): in phase 4 the host libraries it imports (cv2,
PIL, imageio, scipy), the ONNX op catalogue of the CPU tests
(`onnx_op_cases`) and a one-block ViTPose-H-shaped graph through
OnnxSession on cuda against the CPU session, and two SAM2 predictor runs
(tiny_sam2_config(64); Hiera-L's widths at a 256 image, depth cut), one
click frame and three propagated, card against CPU (low-res logits rel.
L2 < 1e-4, mask slots equal; `small_preprocess_parity`); after the animate
paths, the port's preprocess CLI in a subprocess with --replace_flag at
the default 1280x720 area on a PREP_FRAMES-frame drive video written on
the card, --ckpt_path holding the full SAM2.1 Hiera-L .pt written from
manifests/sam2_hiera_large.json and a ViTPose-H-shaped graph of
PREP_POSE_BLOCKS blocks: the src_* files at the JAX chain's frame counts
and sizes, 0/1 masks, finite logits, 4 conditioning and 12 propagated
SAM2 steps over the 57,436-key bank; SAM2's seconds a step by stage
(CUDA events), the pose graph's seconds a frame, the host's share, the
peak memory (`preprocess_main_path`).
Each path starts with every launch count at 0; the paths of phases 5-9
and 12 also check their bf16 forward launches by kernel (every unmasked,
segment and packed forward on the sm90 kernel, every causal one on the
causal sm90 kernel, none on the mma.sync kernel; `check_impl`). The `kernels` line gives
each kernel the launches of its own path (the packed modes and
tile_lists: the six timed BAGEL packed-training passes; the
segment modes and the causal backward serve no path of the JAX package at
d=128, and the mma.sync backward pair and the CUDA-core fp32 d=128
kernels are baselines only: 0; the fp32 d=128 serving forward and rope
pre-pass count the fp32 t2v pipeline run of phase 4, the split pre-pass
the fp32 fine-tune; the knob kernels count the knob path, the bf16-softmax self-
attention and the fp32-chain int8 kernel the ti2v-5B DiT forward with
their knob alone; the mma.sync int8 kernel, the pre-passes kernels A and
B replaced, the tile-list pre-passes tile_lists replaced and kernel A's
rope-only mode are no path's kernels: 0; the `*_train_cli` records count
the training CLI's LoRA run, the `*_registry` ones the registry pack's
pass). The
last line is
{"ok": true, "device": {...}}; any failure exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time

H100_BF16_FLOPS = 989e12   # dense tensor-core bf16 (SXM data sheet)
H100_TF32_FLOPS = 495e12   # dense tensor-core TF32
H100_FP32_FLOPS = 67e12    # fp32 on the CUDA cores
H100_BYTES = 3.35e12       # HBM3


LOG_FILE = None   # --log: every line also goes there (the whole run)


def log(msg):
    print(msg, flush=True)
    if LOG_FILE is not None:
        with open(LOG_FILE, "a") as f:
            f.write(f"{msg}\n")


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


def ab_time(new, old, iters):
    """A kernel (`new`) and the kernel it replaces (`old`) timed in turns
    in one call, old, new, new, old, with CUDA events: (new ms, old ms),
    each the mean of its two runs."""
    o1 = cuda_time(old, iters)
    n1 = cuda_time(new, iters)
    n2 = cuda_time(new, iters)
    o2 = cuda_time(old, iters)
    return (n1 + n2) / 2, (o1 + o2) / 2


def log_ab(call, new_ms, old_ms):
    log(json.dumps({"sm90_vs_mma_sync": call, "sm90_ms": new_ms,
                    "mma_sync_ms": old_ms, "speedup": old_ms / new_ms}))


def check_bwd_impl(tag, sm90, mma_sync=0):
    """A path's bf16 backward calls by kernel (BWD_LAUNCHES_BY_IMPL since
    the path's counts were reset): every mode on the one-pass sm90 kernel,
    none on the mma.sync pair."""
    from univid_tpu_torch.kernels import flash_attention as fa
    want = {"sm90": sm90, "mma_sync": mma_sync}
    got = dict(fa.BWD_LAUNCHES_BY_IMPL)
    log(json.dumps({"check": f"{tag}: bf16 backward calls by kernel",
                    "bwd_launches_by_impl": got, "expected": want,
                    "ok": got == want}))
    if got != want:
        fail(f"{tag}: bf16 backward calls by kernel {got} != {want}")


def check_impl(tag, sm90, causal_sm90=0, mma_sync=0):
    """A path's bf16 forward launches by kernel (LAUNCHES_BY_IMPL since the
    path's counts were reset): every unmasked, segment and packed forward
    on the sm90 kernel, every causal one on the causal sm90 kernel, none on
    the mma.sync kernel."""
    from univid_tpu_torch.kernels import flash_attention as fa
    want = {"sm90": sm90, "causal_sm90": causal_sm90, "mma_sync": mma_sync}
    got = dict(fa.LAUNCHES_BY_IMPL)
    log(json.dumps({"check": f"{tag}: bf16 forward launches by kernel",
                    "launches_by_impl": got, "expected": want,
                    "ok": got == want}))
    if got != want:
        fail(f"{tag}: bf16 forward launches by kernel {got} != {want}")


def bound_ms(flops, nbytes, peak_flops):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / H100_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def write_safetensors(path, tensors, metadata=None):
    """A minimal .safetensors writer, so that the script needs no
    `safetensors` package: an 8-byte little-endian header length, the
    JSON header (dtype, shape, data_offsets from the end of the header;
    padded with spaces to 8 bytes), then each tensor's bytes in key
    order. tensors: {key: (torch dtype, shape, make)}, make() giving the
    tensor, so that one tensor at a time is in host memory. Returns the
    file's size in bytes."""
    import struct

    import torch

    names = {torch.float32: "F32", torch.float16: "F16",
             torch.bfloat16: "BF16", torch.int64: "I64",
             torch.int32: "I32", torch.uint8: "U8"}
    header, off = {}, 0
    for k in sorted(tensors):
        dtype, shape, _ = tensors[k]
        n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        header[k] = {"dtype": names[dtype], "shape": list(shape),
                     "data_offsets": [off, off + n]}
        off += n
    if metadata:
        header["__metadata__"] = metadata
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for k in sorted(tensors):
            dtype, shape, make = tensors[k]
            t = make().detach().to("cpu", dtype).contiguous()
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"{k}: {tuple(t.shape)} vs {shape}")
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)
    return 8 + len(raw) + off


def qk_normed(shape, gen, dtype):
    """Rows RMS-normalised to norm sqrt(d), as Wan's qk-norm leaves them
    (unit gains), so the bound 1.01 * d holds."""
    import torch
    x = torch.randn(shape, generator=gen, device="cuda")
    x = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6)
    return x.to(dtype)


def compare(name, got, want, atol, rtol, why):
    """Elementwise |got - want| <= atol + rtol * |want|, got finite."""
    import torch
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


QK_EPS = 1e-6   # the DiT's qk-norm eps
# kernel A against its plain version: the sum of squares in another fp32
# order moves rsqrt's input by a few fp32 ulps, so a normed value may round
# to its neighbouring bf16 step (2^-7 relative); the gain's product and its
# rounding carry that to <= 2^-6 * 1.0625 of the output, and the rotation
# to that share of |n0 c| + |n1 s| plus its own bf16 rounding
QK_STEP = 2.0 ** -6 * 1.0625
QK_WHY = ("the fp32 sum of squares in another order: a normed value may "
          "take its neighbouring bf16 step (2^-7), <= 2^-6 * 1.0625 after "
          "the gain, carried through the rotation (|n0 c| + |n1 s|) plus "
          "one bf16 rounding (tests/test_torch_qk_prepass.py emulates the "
          "order)")


def compare_within(name, got, want, lim, why):
    """|got - want| <= lim elementwise, got finite; logs the share of
    elements that differ at all."""
    import torch
    err = (got.float() - want.float()).abs()
    max_err = float(err.max())
    ok = bool((err <= lim).all()) and bool(torch.isfinite(got).all())
    log(json.dumps({"check": name, "max_abs_err": max_err,
                    "max_abs_ref": float(want.float().abs().max()),
                    "differing_share": float((err > 0).float().mean()),
                    "why": why, "ok": ok}))
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version")
    return max_err


def _rope_abs(x, cf, sf):
    """|x| |cosF| + |swap_pairs(x)| |sinF| over [B, L, N, D]: what a
    rotation's output moves by per unit of relative change in x."""
    a = x.float().abs()
    sw = a.reshape(*a.shape[:-1], a.shape[-1] // 2, 2).flip(-1) \
        .reshape(a.shape)
    return a * cf.abs()[:, None, :] + sw * sf.abs()[:, None, :]


def log_prepass(call, new_ms, old_ms):
    log(json.dumps({"prepass_vs_old": call, "new_ms": new_ms,
                    "old_ms": old_ms, "speedup": old_ms / new_ms}))


def check_qk_norm_rope(gen, tag, n, grid, l):
    """Kernel A (`qk_norm_rope`, csrc/qk_prepass.cu) at one model's path
    shapes from pre-norm q, k [2, l, n, 128] bf16 (randn x 3, the scale of
    the DiT's projections; gains in [0.5, 1.5]): norm + rope (the
    self-attention's pre-pass) and rope only against the plain version,
    norm only at the self-attention's shape (kernel B's input on the knob
    path) and at the cross-attention's (q over 512 text tokens); each
    timed beside its plain version and, in turns, the passes it
    replaced (unn.rms_norm on q and k; univid_rope_rotate_bf16 on each),
    `prepass_vs_old` lines; F.rms_norm on q and k is the norm-only row's
    library yardstick. Returns the kernels-line records (the replaced rope
    kernel's too)."""
    import torch
    import torch.nn.functional as F

    from univid_tpu_torch.kernels import flash_attention as fa
    from univid_tpu_torch.ops.rope import build_rope_3d

    b, d, lk = 2, 128, 512
    recs = {}
    q = (torch.randn((b, l, n, d), generator=gen, device="cuda") * 3).to(
        torch.bfloat16)
    k = (torch.randn((b, l, n, d), generator=gen, device="cuda") * 3).to(
        torch.bfloat16)
    gq, gk = ((torch.rand((n * d,), generator=gen, device="cuda") + 0.5)
              .to(torch.bfloat16) for _ in range(2))
    norm = (gq, gk, QK_EPS)
    cos, sin = build_rope_3d(d, grid, device="cuda")
    tabs = fa._pad_tables(fa.build_fused_rope_tables(cos, sin, d), l, l,
                          fa.LOG2E / math.sqrt(d))
    cq, sq, ck, sk = tabs
    src = "univid_tpu_torch/kernels/csrc/qk_prepass.cu"
    with torch.no_grad():
        # ---- norm + rope: the self-attention's pre-pass ------------------
        nq, nk = fa.qk_norm_rope_plain(q, k, norm)
        want = fa.qk_norm_rope_plain(nq, nk, None, tabs)
        got = fa.qk_norm_rope(q, k, qk_norm=norm, rope_tables=tabs)
        err = 0.0
        for name, g, w, x, c_, s_ in (("q", got[0], want[0], nq, cq, sq),
                                      ("k", got[1], want[1], nk, ck, sk)):
            lim = QK_STEP * _rope_abs(x, c_, s_) + 2.0 ** -7 * 1.0625 * \
                w.float().abs()
            err = max(err, compare_within(
                f"qk_norm_rope_bf16 {tag} norm+rope {name}", g, w, lim,
                QK_WHY))
        del got, lim

        def old_self():   # unn.rms_norm on q and k, the rope kernel on each
            a, c = fa.rms_heads(q, gq, QK_EPS), fa.rms_heads(k, gk, QK_EPS)
            return fa._rope_bf16(a, cq, sq), fa._rope_bf16(c, ck, sk)

        ms, old_ms = ab_time(lambda: fa.qk_norm_rope(
            q, k, qk_norm=norm, rope_tables=tabs), old_self, 5)
        log_prepass(f"qk_norm_rope_bf16 {tag} norm+rope", ms, old_ms)
        plain_ms = cuda_time(lambda: fa.qk_norm_rope_plain(q, k, norm, tabs),
                             2)
        bms, by = bound_ms(0, nbytes(q, k, *want, gq, gk, *tabs),
                           H100_BF16_FLOPS)
        recs["qk_norm_rope_bf16"] = dict(
            name="qk_norm_rope_bf16", route="cuda", source=src,
            replaces="univid_tpu/kernels/flash_attention.py:157",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=by, library_ms=None, old_ms=old_ms)

        # ---- rope only: the same fp32 operations, equal bits --------------
        got = fa.qk_norm_rope(nq, nk, rope_tables=tabs)
        old = (fa._rope_bf16(nq, cq, sq), fa._rope_bf16(nk, ck, sk))
        errs = [float((g.float() - w.float()).abs().max())
                for g, w in zip(got + old, want + want)]
        equal = [bool(torch.equal(g, w)) for g, w in zip(got + old,
                                                          want + want)]
        log(json.dumps({"check": f"qk_rope_bf16 {tag} rope only "
                                 "(q, k; then the replaced kernel's q, k)",
                        "equal": equal, "max_abs_err": errs,
                        "why": "the same fp32 products and sum, one "
                               "rounding to bf16", "ok": all(equal)}))
        if not all(equal):
            fail("qk_rope_bf16: rope only is not bit-equal to the plain "
                 "version")
        del got, old
        ms_r, old_r = ab_time(lambda: fa.qk_norm_rope(nq, nk,
                                                      rope_tables=tabs),
                              lambda: (fa._rope_bf16(nq, cq, sq),
                                       fa._rope_bf16(nk, ck, sk)), 5)
        log_prepass(f"qk_rope_bf16 {tag} rope only", ms_r, old_r)
        plain_r = cuda_time(lambda: fa.qk_norm_rope_plain(nq, nk, None,
                                                          tabs), 2)
        bms, by = bound_ms(0, nbytes(nq, nk, *want, *tabs), H100_BF16_FLOPS)
        common = dict(route="cuda", bound_ms=bms, bound_by=by,
                      library_ms=None,
                      replaces="univid_tpu/kernels/flash_attention.py:157")
        recs["qk_rope_bf16"] = dict(common, name="qk_rope_bf16", source=src,
                                    max_abs_err=0.0, ms=ms_r,
                                    plain_ms=plain_r, old_ms=old_r)
        # the kernel it replaced, on q and k (two launches)
        recs["rope_rotate_bf16"] = dict(
            common, name="rope_rotate_bf16", max_abs_err=max(errs[2:]),
            source="univid_tpu_torch/kernels/csrc/flash_attention.cu",
            ms=old_r, plain_ms=plain_r)
        del want, nq, nk

        # ---- norm only: the knob path's self-attention q and k, then the
        # cross-attention's q over 512 text keys --------------------------
        kc = k[:, :lk].contiguous()
        err = 0.0
        for case, kk in (("self", k), ("cross", kc)):
            want = fa.qk_norm_rope_plain(q, kk, norm)
            got = fa.qk_norm_rope(q, kk, qk_norm=norm)
            err = max([err] + [compare_within(
                f"qk_norm_bf16 {tag} norm only ({case}) {name}", g, w,
                QK_STEP * w.float().abs(), QK_WHY)
                for name, g, w in (("q", got[0], want[0]),
                                   ("k", got[1], want[1]))])
            del got
        ms_n, old_n = ab_time(
            lambda: fa.qk_norm_rope(q, kc, qk_norm=norm),
            lambda: (fa.rms_heads(q, gq, QK_EPS),
                     fa.rms_heads(kc, gk, QK_EPS)), 5)
        log_prepass(f"qk_norm_bf16 {tag} norm only (cross)", ms_n, old_n)
        plain_n = cuda_time(lambda: fa.qk_norm_rope_plain(q, kc, norm), 2)
        w_ = n * d
        lib_n = cuda_time(lambda: (
            F.rms_norm(q.view(b, l, w_), (w_,), gq, QK_EPS),
            F.rms_norm(kc.view(b, lk, w_), (w_,), gk, QK_EPS)), 5)
        bms, by = bound_ms(0, nbytes(q, kc, *want, gq, gk), H100_BF16_FLOPS)
        recs["qk_norm_bf16"] = dict(
            name="qk_norm_bf16", route="cuda", source=src,
            replaces="univid_tpu/kernels/flash_attention.py:157",
            max_abs_err=err, ms=ms_n, plain_ms=plain_n, bound_ms=bms,
            bound_by=by, library_ms=lib_n, old_ms=old_n)
        del want, q, k, kc
    torch.cuda.empty_cache()
    return recs


def check_serving_kernels(gen, tag, n, grid, l):
    """The serving kernels (self-attention, cross-attention, and the q / k
    pre-pass kernel A: `check_qk_norm_rope`) against their plain versions
    at one model's shapes: n heads of d=128, batch-2 CFG, the latent grid's
    tokens padded to l, 512 text tokens. Returns their records (timed
    beside SDPA)."""
    import torch
    import torch.nn.functional as F

    from univid_tpu_torch.kernels import flash_attention as fa
    from univid_tpu_torch.ops.rope import build_rope_3d

    records = {}
    # ---- DiT self-attention ---------------------------------------------
    b, d = 2, 128
    kv_real = grid[0] * grid[1] * grid[2]
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
        qr, kr = fa.qk_norm_rope(q, k, rope_tables=tabs)
        got = fa._flash_cuda(q, k, v, kv_len, bound, tabs)
        want = fa.attention_plain(q, k, v, kv_len=kv_len, bound=bound,
                                  rope_tables=tabs)
        err = compare(f"flash_attention_bf16 {tag} bounded+rope+kv_len",
                      got, want, **tol)
        got_r = fa._flash_cuda(q, k, v, kv_len, None, tabs)
        compare(f"flash_attention_bf16 {tag} running max+rope+kv_len",
                got_r, want, **tol)
        # the attention kernel alone, on the pre-rotated q and k, beside
        # the mma.sync kernel it replaces
        ms, old_ms = ab_time(
            lambda: fa._flash_cuda(qr, kr, v, kv_len, bound, None),
            lambda: fa._launch_bf16(qr, kr, v, kv_len, bound,
                                    fa._MODE_BOUNDED), 3)
        log_ab(f"self-attention {tag} bounded", ms, old_ms)
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
        source="univid_tpu_torch/kernels/csrc/flash_attention_sm90.cu",
        replaces="univid_tpu/kernels/flash_attention.py:44",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=lib_ms, mma_sync_ms=old_ms)
    del q, k, v, got, got_r, want, qr, kr, qs, ks, vs
    records.update(check_qk_norm_rope(gen, tag, n, grid, l))

    # ---- DiT cross-attention: the video tokens x 512 text tokens --------
    lk = 512
    q = (qk_normed((b, l, n, d), gen, torch.bfloat16)
         * torch.tensor(sc, dtype=torch.bfloat16, device="cuda"))
    k = qk_normed((b, lk, n, d), gen, torch.bfloat16)
    v = torch.randn((b, lk, n, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    with torch.no_grad():
        got = fa.cross_attention_padded(q, k, v, score_bound=bound)
        want = fa.attention_plain(q, k, v, bound=bound)
        err = compare(f"cross_attention_bf16 {tag} bounded", got, want,
                      **tol)
        kvl = torch.tensor([lk, 100], dtype=torch.int32, device="cuda")
        km, vm = k.clone(), v.clone()   # masked keys hold large values
        km[1, 100:] = 50.0
        vm[1, 100:] = 50.0
        # referenced to the row max, the largest p lie in [0.5, 1], where
        # one bf16 step is 2^-8; l >= 1, so one p that rounds the other way
        # (exp2.approx, summation order) moves an output by <= 2^-8 max|v|
        compare(f"cross_attention_bf16 {tag} one-shot max+kv_len",
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
        ms, old_ms = ab_time(
            lambda: fa.cross_attention_padded(q, k, v, score_bound=bound),
            lambda: fa._launch_bf16(q, k, v, None, bound, fa._MODE_BOUNDED),
            5)
        log_ab(f"cross-attention {tag} bounded", ms, old_ms)
        log_ab(f"cross-attention {tag} one-shot", *ab_time(
            lambda: fa.cross_attention_padded(q, k, v),
            lambda: fa._launch_bf16(q, k, v, None, None, fa._MODE_ONESHOT),
            5))
        plain_ms = cuda_time(lambda: fa.attention_plain(q, k, v,
                                                        bound=bound), 1)
        qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = cuda_time(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, scale=1.0 / math.log2(math.e)), 5)
    flops = 4 * b * n * l * lk * d
    bms, by = bound_ms(flops, nbytes(q, k, v, got), H100_BF16_FLOPS)
    records["cross_attention_bf16"] = dict(
        name="cross_attention_bf16", route="cuda",
        source="univid_tpu_torch/kernels/csrc/flash_attention_sm90.cu",
        replaces="univid_tpu/kernels/flash_attention.py:355",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=lib_ms, mma_sync_ms=old_ms)
    del q, k, v, got, want, qs, ks, vs

    return records


def vae_kernel_record(gen, dv, lv, lv_pad):
    """The fp32 VAE mid-attention kernel (one head of d=dv over lv tokens,
    padded to lv_pad; padded keys hold 50.0) against its plain version, a
    kv_len = 0 row exactly 0, timed in turns with the CUDA-core kernel it
    replaced (`tc_vs_simt` line), its launches' device times, SDPA on the
    live keys (at d=1024 also the kernel SDPA runs). Returns the record."""
    import torch
    import torch.nn.functional as F

    from univid_tpu_torch.kernels import flash_attention as fa

    tol = dict(atol=1e-5, rtol=1e-4,
               why="fp32 accuracy: 3xTF32 products (each operand split into "
                   "two TF32 parts, ~2^-22 relative), summation order and "
                   "the approximate exp2 (2^-22 relative)")
    q, k, v = (torch.randn((1, lv_pad, 1, dv), generator=gen,
                           device="cuda") for _ in range(3))
    q = q * (fa.LOG2E / math.sqrt(dv))  # the wrapper's fold, in fp32
    k[:, lv:] = 50.0                    # padded keys: large values
    v[:, lv:] = 50.0
    kvl = (torch.tensor([lv], dtype=torch.int32, device="cuda")
           if lv < lv_pad else None)
    with torch.no_grad():
        got = fa._flash_cuda(q, k, v, kvl, None, None)
        err = compare(f"flash_attention_f32 d={dv} path shape", got,
                      fa.attention_plain(q, k, v, kv_len=kvl), **tol)
        # 40 padded keys (50.0) past kv_len in row 0; kv_len = 0 in row 1
        km, vm, q2 = (x.repeat(2, 1, 1, 1) for x in (k, v, q))
        km[0, lv - 40:] = 50.0
        vm[0, lv - 40:] = 50.0
        kv2 = torch.tensor([lv - 40, 0], dtype=torch.int32, device="cuda")
        got_m = fa._flash_cuda(q2, km, vm, kv2, None, None)
        err = max(err, compare(
            f"flash_attention_f32 d={dv} kv_len", got_m,
            fa.attention_plain(q2, km, vm, kv_len=kv2), **tol))
        if float(got_m[1].abs().max()) != 0.0:
            fail("flash_attention_f32: kv_len == 0 rows are not 0")
        del km, vm, q2, got_m
        # beside the CUDA-core kernel it replaced, in turns
        ms, simt_ms = ab_time(
            lambda: fa._flash_cuda(q, k, v, kvl, None, None),
            lambda: fa._launch_f32_simt(q, k, v, kvl), 5)
        log(json.dumps({"tc_vs_simt": f"VAE attention d={dv}",
                        "tc_ms": ms, "simt_ms": simt_ms,
                        "speedup": simt_ms / ms}))
        # device time of its three launches (scores, softmax, p v)
        _, prof = profile_call(lambda: fa._flash_cuda(q, k, v, kvl, None,
                                                      None))
        log(json.dumps({f"vae_attention_d{dv}_kernels": [
            (t["kernel"], t["ms"]) for t in prof["top_kernels"]]}))
        plain_ms = cuda_time(lambda: fa.attention_plain(
            q, k, v, kv_len=kvl), 1)
        qs, ks, vs = (x.transpose(1, 2)[:, :, :lv] for x in (q, k, v))
        try:
            lib_ms = cuda_time(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, scale=1.0 / math.log2(math.e)), 5)
        except RuntimeError as e:  # no SDPA backend for this shape
            log(f"library_ms for flash_attention_f32 d={dv}: {e}")
            lib_ms = None
        if dv == 1024 and lib_ms is not None:   # which kernel SDPA runs
            _, prof = profile_call(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, scale=1.0 / math.log2(math.e)))
            log(json.dumps({"sdpa_fp32_kernels": [
                t["kernel"] for t in prof["top_kernels"]]}))
    # 3xTF32: three TF32 products for each of the 4 Lq kv d flops
    bms, by = bound_ms(3 * 4 * lv_pad * lv * dv, nbytes(q, k, v, got),
                       H100_TF32_FLOPS)
    rec = dict(name="flash_attention_f32", route="cuda",
               source="univid_tpu_torch/kernels/csrc/"
                      "flash_attention_f32_tc.cu",
               replaces="univid_tpu/kernels/flash_attention.py:44",
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
               bound_by=by, library_ms=lib_ms, simt_ms=simt_ms)
    del q, k, v, got, qs, ks, vs
    return rec


def check_kernels():
    """Phase 3: each kernel vs its plain version at the main path's shapes.
    Returns the per-kernel records of the `kernels` line."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    # t2v-1.3B at 832x480x81: latent 21 x 60 x 104, patch (1, 2, 2)
    records = check_serving_kernels(gen, "t2v-1.3B", 12, (21, 30, 52), 32768)

    # ---- VAE mid-block attention: 1 head, fp32 --------------------------
    # ti2v-5B at 1280x704 (44x80 tokens): d=1024 in the decoder (31
    # launches per 121-frame decode), d=640 in the encoder (the i2v
    # first-frame encode); t2v-1.3B at 832x480 (60x104 tokens, padded to
    # 6272): d=384 in the decoder (21 launches per video)
    for dv, lv, lv_pad in ((1024, 3520, 3520), (640, 3520, 3520),
                           (384, 6240, 6272)):
        rec = vae_kernel_record(gen, dv, lv, lv_pad)
        if dv == 1024:   # the shape of this kernel's most launches
            records["flash_attention_f32"] = rec
        else:
            log(json.dumps({f"kernel_at_d{dv}": rec}))
        if dv == 384:   # A14B's decode and i2v encode run this shape
            records["flash_attention_f32_d384"] = dict(
                rec, name="flash_attention_f32_d384",
                counter="flash_attention_f32")
    for r in records.values():
        log(json.dumps({"kernel": r}))
    return records


def retime_ti2v_kernels():
    """The serving kernels at the ti2v-5B shapes (1280x704x121: 31 x 22 x
    40 = 27,280 tokens padded to 28,672, 24 heads), logged on
    `kernel_at_ti2v5b_shape` lines."""
    import torch

    recs = check_serving_kernels(torch.Generator(device="cuda").manual_seed(2),
                                 "ti2v-5B", 24, (31, 22, 40), 28672)
    for rec in recs.values():
        log(json.dumps({"kernel_at_ti2v5b_shape": rec}))
    torch.cuda.empty_cache()


# the kernels-line entries of the A14B shape: the four kernels its DiT
# calls, and the d=384 VAE kernel (its decode and i2v encode)
A14B_KERNELS = ("flash_attention_bf16", "cross_attention_bf16",
                "qk_norm_rope_bf16", "qk_norm_bf16")


def retime_a14b_kernels():
    """The serving kernels at the t2v-A14B / i2v-A14B shapes (832x480x81:
    21 x 30 x 52 = 32,760 tokens padded to 32,768, 40 heads of d=128:
    self-attention [2, 32768, 40, 128], cross-attention over [2, 512, 40,
    128], kernel A's two modes), logged on `kernel_at_a14b_shape` lines.
    Returns them as kernels-line records named `<kernel>_a14b`, counted by
    each kernel's own counter in the A14B requests (the d=384 VAE kernel's
    record, `flash_attention_f32_d384`, comes from check_kernels: the
    t2v-1.3B shape is A14B's, the same VAE at the same size)."""
    import torch

    recs = check_serving_kernels(torch.Generator(device="cuda").manual_seed(3),
                                 "t2v-A14B", 40, (21, 30, 52), 32768)
    out = {}
    for nm, rec in recs.items():
        log(json.dumps({"kernel_at_a14b_shape": rec}))
        if nm in A14B_KERNELS:
            out[f"{nm}_a14b"] = dict(rec, name=f"{nm}_a14b", counter=nm)
    torch.cuda.empty_cache()
    return out


def check_a14b_720p_kernels():
    """The serving kernels at the 1280x720x81 A14B call's shapes (21 x 45 x
    80 = 75,600 tokens padded to 75,776, 40 heads of d=128, batch-2 CFG):
    kernel A's two modes, self-attention (grid 592 x 80) and
    cross-attention, each launched on the whole tensors as the 720p DiT
    call launches it, then held to its plain version on the rows and heads
    that reach the largest offsets and block indices: both batches, the
    first q tile and the last three (past kv_len too), heads 0, 38 and 39
    against every key. Each timed; logged on `kernel_at_a14b_720p_shape`
    lines (self-attention beside SDPA, kernel A's norm-only mode beside
    F.rms_norm on q and k; the plain versions are not timed at this size:
    self-attention's holds 4.6e11 fp32 scores)."""
    import torch
    import torch.nn.functional as F

    from univid_tpu_torch.kernels import flash_attention as fa
    from univid_tpu_torch.ops.rope import build_rope_3d

    gen = torch.Generator(device="cuda").manual_seed(4)
    b, l, n, d, lk = 2, 75776, 40, 128, 512
    grid = (21, 45, 80)
    kv_real = grid[0] * grid[1] * grid[2]
    rows = torch.cat([torch.arange(0, 128), torch.arange(l - 384, l)]).cuda()
    heads = [0, n - 2, n - 1]
    tag = "t2v-A14B 720p"
    sc = fa.LOG2E / math.sqrt(d)
    cos, sin = build_rope_3d(d, grid, device="cuda")
    tabs = fa._pad_tables(fa.build_fused_rope_tables(cos, sin, d), l, l, sc)
    tabs_r = tuple(t[rows] for t in tabs)
    src_a = "univid_tpu_torch/kernels/csrc/qk_prepass.cu"
    src_f = "univid_tpu_torch/kernels/csrc/flash_attention_sm90.cu"

    def sub(x):   # the checked rows and heads of [B, L, N, D]
        return x[:, rows][:, :, heads]

    def record(name, src, replaces, err, ms, flops, nb, lib_ms=None):
        bms, by = bound_ms(flops, nb, H100_BF16_FLOPS)
        log(json.dumps({"kernel_at_a14b_720p_shape": dict(
            name=name, route="cuda", source=src, replaces=replaces,
            max_abs_err=err, ms=ms, bound_ms=bms, bound_by=by,
            library_ms=lib_ms, checked_rows=[0, 128, l - 384, l],
            checked_heads=heads)}))

    with torch.no_grad():
        # ---- kernel A: norm + rope (self), norm only (cross) -------------
        q = (torch.randn((b, l, n, d), generator=gen, device="cuda") * 3).to(
            torch.bfloat16)
        k = (torch.randn((b, l, n, d), generator=gen, device="cuda") * 3).to(
            torch.bfloat16)
        gq, gk = ((torch.rand((n * d,), generator=gen, device="cuda") + 0.5)
                  .to(torch.bfloat16) for _ in range(2))
        norm = (gq, gk, QK_EPS)
        got = fa.qk_norm_rope(q, k, qk_norm=norm, rope_tables=tabs)
        nq, nk = fa.qk_norm_rope_plain(q[:, rows], k[:, rows], norm)
        want = fa.qk_norm_rope_plain(nq, nk, None, tabs_r)
        err = 0.0
        for name, g, w, x, c_, s_ in (
                ("q", got[0][:, rows], want[0], nq, tabs_r[0], tabs_r[1]),
                ("k", got[1][:, rows], want[1], nk, tabs_r[2], tabs_r[3])):
            lim = QK_STEP * _rope_abs(x, c_, s_) + 2.0 ** -7 * 1.0625 * \
                w.float().abs()
            err = max(err, compare_within(
                f"qk_norm_rope_bf16 {tag} norm+rope {name}", g, w, lim,
                QK_WHY))
        nb = nbytes(q, k, *got, gq, gk, *tabs)
        del got, nq, nk, want
        ms = cuda_time(lambda: fa.qk_norm_rope(q, k, qk_norm=norm,
                                               rope_tables=tabs), 2)
        record("qk_norm_rope_bf16", src_a,
               "univid_tpu/kernels/flash_attention.py:157", err, ms, 0, nb)
        kc = k[:, :lk].contiguous()
        del k
        got = fa.qk_norm_rope(q, kc, qk_norm=norm)
        want = fa.qk_norm_rope_plain(q[:, rows], kc, norm)
        err = max(compare_within(f"qk_norm_bf16 {tag} norm only (cross) q",
                                 got[0][:, rows], want[0],
                                 QK_STEP * want[0].float().abs(), QK_WHY),
                  compare_within(f"qk_norm_bf16 {tag} norm only (cross) k",
                                 got[1], want[1],
                                 QK_STEP * want[1].float().abs(), QK_WHY))
        nb = nbytes(q, kc, *got, gq, gk)
        del got, want
        ms = cuda_time(lambda: fa.qk_norm_rope(q, kc, qk_norm=norm), 2)
        w_ = n * d   # the library's yardstick: F.rms_norm on q and k
        lib_ms = cuda_time(lambda: (
            F.rms_norm(q.view(b, l, w_), (w_,), gq, QK_EPS),
            F.rms_norm(kc.view(b, lk, w_), (w_,), gk, QK_EPS)), 2)
        record("qk_norm_bf16", src_a,
               "univid_tpu/kernels/flash_attention.py:157", err, ms, 0, nb,
               lib_ms)
        del q, kc

        # ---- self-attention on kernel A's rotated q and k -----------------
        q = qk_normed((b, l, n, d), gen, torch.bfloat16)
        k = qk_normed((b, l, n, d), gen, torch.bfloat16)
        qr, kr = fa.qk_norm_rope(q, k, rope_tables=tabs)
        del q, k
        v = torch.randn((b, l, n, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        # padded keys hold large values: a kernel that let them into the
        # softmax or the p @ v product would be far off
        kr[:, kv_real:] = 50.0
        v[:, kv_real:] = 50.0
        kv_len = torch.full((b,), kv_real, dtype=torch.int32, device="cuda")
        bound = torch.tensor([1.01 * d * sc], device="cuda")
        tol = dict(atol=1e-3, rtol=2.0 ** -7,
                   why="one bf16 ulp of the output (at most 2^-7 relative) "
                       "plus 1e-3 for the fp32 summation order and the "
                       "approximate exp2 before p rounds to bf16")
        got = fa._flash_cuda(qr, kr, v, kv_len, bound, None)
        want = fa.attention_plain(sub(qr), kr[:, :, heads], v[:, :, heads],
                                  kv_len=kv_len, bound=bound)
        err = compare(f"flash_attention_bf16 {tag} bounded+kv_len",
                      sub(got), want, **tol)
        nb = nbytes(qr, kr, v, got)
        del got, want
        ms = cuda_time(lambda: fa._flash_cuda(qr, kr, v, kv_len, bound,
                                              None), 2)
        qs, ks, vs = (x.transpose(1, 2) for x in (qr, kr, v))
        lib_ms = cuda_time(lambda: F.scaled_dot_product_attention(
            qs, ks[:, :, :kv_real], vs[:, :, :kv_real],
            scale=1.0 / fa.LOG2E), 1)
        record("flash_attention_bf16", src_f,
               "univid_tpu/kernels/flash_attention.py:44", err, ms,
               4 * b * n * l * kv_real * d, nb, lib_ms)
        del qr, kr, v, qs, ks, vs

        # ---- cross-attention: the video tokens x 512 text tokens ---------
        q = (qk_normed((b, l, n, d), gen, torch.bfloat16)
             * torch.tensor(sc, dtype=torch.bfloat16, device="cuda"))
        k = qk_normed((b, lk, n, d), gen, torch.bfloat16)
        v = torch.randn((b, lk, n, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        got = fa.cross_attention_padded(q, k, v, score_bound=bound)
        want = fa.attention_plain(sub(q), k[:, :, heads], v[:, :, heads],
                                  bound=bound)
        err = compare(f"cross_attention_bf16 {tag} bounded", sub(got), want,
                      **tol)
        nb = nbytes(q, k, v, got)
        del got, want
        ms = cuda_time(lambda: fa.cross_attention_padded(
            q, k, v, score_bound=bound), 3)
        qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = cuda_time(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, scale=1.0 / fa.LOG2E), 3)
        record("cross_attention_bf16", src_f,
               "univid_tpu/kernels/flash_attention.py:355", err, ms,
               4 * b * n * l * lk * d, nb, lib_ms)
        del q, k, v, qs, ks, vs
    torch.cuda.empty_cache()


def rel_l2(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def check_grad(name, got, want, rel_limit, why):
    """Relative-L2 check of a gradient (or an output) against its reference,
    with every value finite."""
    import torch
    got, want = got.detach(), want.detach()
    err = rel_l2(got, want)
    ok = err < rel_limit and bool(torch.isfinite(got).all())
    log(json.dumps({"check": name, "rel_l2": err, "limit": rel_limit,
                    "max_abs_err": float((got.float() - want.float()).abs()
                                         .max()),
                    "max_abs_ref": float(want.float().abs().max()),
                    "why": why, "ok": ok}))
    if not ok:
        fail(f"{name}: disagrees with its reference")
    return err


BWD_WHY = ("p and dS round to bf16 at the same points on both sides, but "
           "an fp32 difference of ~1e-6 (approximate exp2, summation order) "
           "flips some roundings by one bf16 step (2^-8 relative); the "
           "output rounds once")


def train_kernel_records(gen, shape, b, l, n, lk, kv_real, bound):
    """The training kernels at one shape: q [b, l, n, 128] over k, v [b,
    lk, n, 128] (keys past kv_real hold 50.0 and kv_len masks them; the
    softmax bounded by `bound`, a [1] tensor in the exp2 domain, or
    running with None): the forward with lse, the one-pass sm90 backward
    and the mma.sync dq / dk-dv pair against their plain versions from the
    plain residuals; the sm90 backward timed in turns with the pair
    (`bwd_sm90_vs_mma_sync` line, its launches' device times on a
    `bwd_sm90_kernels_<shape>` line), the lse forward in turns with the
    mma.sync kernel; SDPA (and its backward) on the live keys as the
    library's yardstick. Returns {counter name: record}."""
    import torch
    import torch.nn.functional as F

    from univid_tpu_torch.kernels import flash_attention as fa

    d = 128
    sc = 1.0 / math.sqrt(d)
    mode = fa._MODE_RUNNING if bound is None else fa._MODE_BOUNDED
    fwd_tol = dict(atol=1e-3, rtol=2.0 ** -7,
                   why="one bf16 ulp of the output plus 1e-3 for the fp32 "
                       "summation order and the approximate exp2")
    out = {}
    q = qk_normed((b, l, n, d), gen, torch.bfloat16)
    k = qk_normed((b, lk, n, d), gen, torch.bfloat16)
    v = torch.randn((b, lk, n, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    do = torch.randn((b, l, n, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    kv_len = None
    if kv_real is not None:
        kv_len = torch.full((b,), kv_real, dtype=torch.int32,
                            device="cuda")
        k[:, kv_real:] = 50.0
        v[:, kv_real:] = 50.0
    kv_eff = kv_real or lk
    qs = fa._fold(q, sc)
    with torch.no_grad():
        o, lse = fa.flash_attention_fwd_folded(qs, k, v, kv_len=kv_len,
                                               score_bound=bound)
        o_p, lse_p = fa.attention_plain(qs, k, v, kv_len=kv_len,
                                        bound=bound, save_residuals=True)
        errs = {"lse_fwd": max(
            compare(f"flash_attention_bf16_lse {shape} output", o, o_p,
                    **fwd_tol),
            compare(f"flash_attention_bf16_lse {shape} lse", lse, lse_p,
                    atol=1e-3, rtol=0.0,
                    why="fp32 log2 of an fp32 row sum; summation "
                        "order and the approximate exp2"))}
        # the backward alone: both sides take the plain residuals; the
        # one-pass sm90 kernel (the path's) and the mma.sync pair it
        # replaced in these modes
        got_sm90 = fa._launch_bwd_sm90(qs, k, v, o_p, lse_p, do, kv_len,
                                       sc)
        dq, delta = fa._bwd_dq_cuda(qs, k, v, o_p, lse_p, do, kv_len, sc)
        dk, dv = fa._bwd_dkv_cuda(qs, k, v, do, lse_p, delta, kv_len)
        want = fa._bwd_plain_folded(qs, k, v, o_p, lse_p, do, kv_len, sc)
        for nm, got, pair_got, ref in zip(("dq", "dk", "dv"), got_sm90,
                                          (dq, dk, dv), want):
            for key, tag, g in (
                    ("bwd_sm90", "flash_attention_bwd_sm90", got),
                    ("bwd_dq" if nm == "dq" else "bwd_dkv",
                     "flash_attention_bwd", pair_got)):
                e = compare(f"{tag} {shape} {nm}", g, ref,
                            atol=2.0 ** -8 * float(ref.float().abs()
                                                   .max()),
                            rtol=2.0 ** -7, why=BWD_WHY)
                check_grad(f"{tag} {shape} {nm} rel_l2", g, ref, 1e-2,
                           BWD_WHY)
                errs[key] = max(errs.get(key, 0.0), e)
        if kv_real is not None and any(
                bool(x[:, kv_real:].any())
                for x in (dk, dv, got_sm90[1], got_sm90[2])):
            fail("flash_attention_bwd: dk / dv past kv_len are not 0")
        del want, got_sm90

        def pair():
            dq_, delta_ = fa._bwd_dq_cuda(qs, k, v, o_p, lse_p, do,
                                          kv_len, sc)
            return dq_, fa._bwd_dkv_cuda(qs, k, v, do, lse_p, delta_,
                                         kv_len)

        def sm90():
            return fa._launch_bwd_sm90(qs, k, v, o_p, lse_p, do, kv_len,
                                       sc)

        bwd_ms, pair_ms = ab_time(sm90, pair, 3)
        log(json.dumps({"bwd_sm90_vs_mma_sync": f"backward, {shape}",
                        "sm90_ms": bwd_ms, "mma_sync_pair_ms": pair_ms,
                        "speedup": pair_ms / bwd_ms}))
        # two calls: the device time of each of the three launches a
        # call (the mean of two)
        _, prof = profile_call(lambda: (sm90(), sm90()))
        log(json.dumps({f"bwd_sm90_kernels_{shape}": [
            (t_["kernel"], t_["ms"] / t_["count"], t_["count"])
            for t_ in prof["top_kernels"]]}))
        lse_old = torch.empty_like(lse)
        lse_ms, lse_old_ms = ab_time(
            lambda: fa.flash_attention_fwd_folded(
                qs, k, v, kv_len=kv_len, score_bound=bound),
            lambda: fa._launch_bf16(qs, k, v, kv_len, bound, mode,
                                    lse=lse_old), 3)
        log_ab(f"training forward with lse, {shape}", lse_ms,
               lse_old_ms)
        ms = {
            "lse_fwd": lse_ms,
            "bwd_sm90": bwd_ms,
            "bwd_dq": cuda_time(lambda: fa._bwd_dq_cuda(
                qs, k, v, o_p, lse_p, do, kv_len, sc), 3),
            "bwd_dkv": cuda_time(lambda: fa._bwd_dkv_cuda(
                qs, k, v, do, lse_p, delta, kv_len), 3),
        }
        plain_fwd = cuda_time(lambda: fa.attention_plain(
            qs, k, v, kv_len=kv_len, bound=bound, save_residuals=True), 1,
            warmup=0)
        plain_bwd = cuda_time(lambda: fa._bwd_plain_folded(
            qs, k, v, o_p, lse_p, do, kv_len, sc), 1, warmup=0)
    # the library's counterpart: SDPA on the live keys, whose forward
    # with inputs that need a gradient saves its logsumexp
    qg, kg, vg = (x.transpose(1, 2)[:, :, :m].detach().requires_grad_(
        True) for x, m in ((qs, l), (k, kv_eff), (v, kv_eff)))
    dog = do.transpose(1, 2)
    lib_fwd = cuda_time(lambda: F.scaled_dot_product_attention(
        qg, kg, vg, scale=1.0 / fa.LOG2E), 3)
    ref_out = F.scaled_dot_product_attention(qg, kg, vg,
                                             scale=1.0 / fa.LOG2E)
    lib_bwd = cuda_time(lambda: torch.autograd.grad(
        ref_out, (qg, kg, vg), dog, retain_graph=True), 3)
    del ref_out, qg, kg, vg, dog

    mm = 2.0 * b * n * l * kv_eff * d   # flops of one of the products
    row = nbytes(qs)                    # one [B, Lq, N, D] bf16 tensor
    kvb = nbytes(k, v)
    bounds = {
        # s = qs k^T, o = p v
        "lse_fwd": bound_ms(2 * mm, 2 * row + kvb + nbytes(lse),
                            H100_BF16_FLOPS),
        # s, dp = dO v^T, dq = dS k; reads qs, o, dO, k, v, lse; writes
        # dq, delta
        "bwd_dq": bound_ms(3 * mm, 4 * row + kvb + 2 * nbytes(lse),
                           H100_BF16_FLOPS),
        # s^T, dp^T, dv = p^T dO, dk = dS^T qs; reads qs, dO, k, v, lse,
        # delta; writes dk, dv
        "bwd_dkv": bound_ms(4 * mm, 2 * row + 2 * kvb + 2 * nbytes(lse),
                            H100_BF16_FLOPS),
    }
    # the one-pass work: 5 products (s, dp, dq, dk, dv); reads qs, o,
    # dO, k, v, lse; writes dq, dk, dv
    bounds["bwd_sm90"] = bound_ms(5 * mm, 4 * row + 2 * kvb
                                  + nbytes(lse), H100_BF16_FLOPS)
    log(json.dumps({"check": f"backward pair {shape}",
                    "pair_ms": ms["bwd_dq"] + ms["bwd_dkv"],
                    "pair_ms_in_turns": pair_ms,
                    "sm90_ms": ms["bwd_sm90"],
                    "one_pass_bound_ms": bounds["bwd_sm90"][0],
                    "one_pass_bound_by": bounds["bwd_sm90"][1],
                    "why": "the one-pass work: 5 products (s, dp, dq, "
                           "dk, dv) of 2 Lq Lk d flops per head"}))
    meta = {
        "lse_fwd": ("flash_attention_bf16_lse",
                    "univid_tpu_torch/kernels/csrc/"
                    "flash_attention_sm90.cu",
                    "univid_tpu/kernels/flash_attention.py:343",
                    plain_fwd, lib_fwd),
        "bwd_dq": ("flash_attention_bwd_dq_bf16",
                   "univid_tpu_torch/kernels/csrc/flash_attention_bwd.cu",
                   "univid_tpu/kernels/flash_attention.py:831",
                   plain_bwd, lib_bwd),
        "bwd_dkv": ("flash_attention_bwd_dkv_bf16",
                    "univid_tpu_torch/kernels/csrc/flash_attention_bwd.cu",
                    "univid_tpu/kernels/flash_attention.py:940",
                    plain_bwd, lib_bwd),
        "bwd_sm90": ("flash_attention_bwd_bf16_sm90",
                     "univid_tpu_torch/kernels/csrc/"
                     "flash_attention_bwd_sm90.cu",
                     "univid_tpu/kernels/flash_attention.py:1057",
                     plain_bwd, lib_bwd),
    }
    for key, (name, src, rep, plain_ms, lib_ms) in meta.items():
        rec = dict(name=name, route="cuda", source=src, replaces=rep,
                   max_abs_err=errs[key], ms=ms[key], plain_ms=plain_ms,
                   bound_ms=bounds[key][0], bound_by=bounds[key][1],
                   library_ms=lib_ms)
        if key == "lse_fwd":
            rec["mma_sync_ms"] = lse_old_ms
        if key == "bwd_sm90":
            rec["mma_sync_ms"] = pair_ms   # the pair, in turns
        out[name] = rec
    del q, k, v, do, qs, o, lse, o_p, lse_p, dq, dk, dv, delta, lse_old
    torch.cuda.empty_cache()
    return out


def check_train_kernels():
    """Phase 3b: the training kernels (forward with lse; the one-pass sm90
    backward, the path's, and the dq and dk/dv mma.sync pair it replaced
    in these modes) against their plain versions at the training path's
    self (q, k, v [1, 32768, 12, 128], kv_len 32760) and cross (k, v
    [1, 512, 12, 128]) shapes, bounded softmax; padded keys hold 50.0. The
    sm90 backward is timed in turns with the pair (`bwd_sm90_vs_mma_sync`
    lines) and its three launches' device times logged
    (`bwd_sm90_kernels_*`); a kv_len = 0 row must come out exactly zero.
    Then the autograd Function against autograd through the fp32
    mha_reference at L = 2048. Returns the per-kernel records (self shape;
    the cross shape's numbers are logged on `kernel_at_cross_shape` lines)."""
    import torch

    from univid_tpu_torch.kernels import attention as att
    from univid_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    b, l, n, d = 1, 32768, 12, 128
    sc = 1.0 / math.sqrt(d)
    bound = torch.tensor([1.01 * d * sc * fa.LOG2E], device="cuda")
    out = {}
    for shape, lk, kv_real in (("self", l, 32760), ("cross", 512, None)):
        for name, rec in train_kernel_records(gen, shape, b, l, n, lk,
                                              kv_real, bound).items():
            if shape == "self":
                out[name] = rec
                log(json.dumps({"kernel": rec}))
            else:
                log(json.dumps({"kernel_at_cross_shape": rec}))

    # a kv_len = 0 row: exactly zero dq, dk and dv from the sm90 kernel
    q = qk_normed((2, 2048, n, d), gen, torch.bfloat16)
    k = qk_normed((2, 2048, n, d), gen, torch.bfloat16)
    v = torch.randn((2, 2048, n, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    do = torch.randn((2, 2048, n, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    kv_len = torch.tensor([2000, 0], dtype=torch.int32, device="cuda")
    qs = fa._fold(q, sc)
    with torch.no_grad():
        o_p, lse_p = fa.attention_plain(qs, k, v, kv_len=kv_len, bound=bound,
                                        save_residuals=True)
        got = fa._launch_bwd_sm90(qs, k, v, o_p, lse_p, do, kv_len, sc)
        want = fa._bwd_plain_folded(qs, k, v, o_p, lse_p, do, kv_len, sc)
    for nm, g, ref in zip(("dq", "dk", "dv"), got, want):
        compare(f"flash_attention_bwd_sm90 kv_len [2000, 0] {nm}", g, ref,
                atol=2.0 ** -8 * float(ref.float().abs().max()),
                rtol=2.0 ** -7, why=BWD_WHY)
    zero_row = all(not bool(g[1].any()) for g in got)
    log(json.dumps({"check": "flash_attention_bwd_sm90 kv_len = 0 row "
                             "exactly zero (dq, dk, dv)", "ok": zero_row}))
    if not zero_row:
        fail("flash_attention_bwd_sm90: a kv_len = 0 row is not exactly 0")
    del q, k, v, do, qs, o_p, lse_p, got, want

    # the autograd Function (attention() under grad) at L = 2048
    q = qk_normed((1, 2048, n, d), gen, torch.bfloat16)
    k = qk_normed((1, 2048, n, d), gen, torch.bfloat16)
    v = torch.randn((1, 2048, n, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    g = torch.randn((1, 2048, n, d), generator=gen, device="cuda")
    qt, kt, vt = (x.clone().requires_grad_(True) for x in (q, k, v))
    o = att.attention(qt, kt, vt, score_bound=1.01 * d)
    got = torch.autograd.grad((o.float() * g).sum(), (qt, kt, vt))
    qr, kr, vr = (x.float().requires_grad_(True) for x in (q, k, v))
    ref = att.mha_reference(qr, kr, vr)
    want = torch.autograd.grad((ref * g).sum(), (qr, kr, vr))
    why = ("bf16 kernels against an fp32 softmax on the same bf16 inputs: "
           "p, dS and the outputs round to bf16 (2^-8 relative)")
    check_grad("attention() under grad output, L=2048", o, ref, 2e-2, why)
    for nm, a, w in zip(("dq", "dk", "dv"), got, want):
        check_grad(f"attention() under grad {nm}, L=2048", a, w, 2e-2, why)
    return out


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
    from univid_tpu_torch.pipelines.ti2v import WanTI2VPipeline
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
        pipe = WanTI2VPipeline(spec, d, v, policy=policy)
        fn = pipe.denoise_fn((3, 8, 8), 48, 4, 5.0, 5.0, "unipc", None)
        x0 = fn(d, noise.to(device), ctx.to(device), nctx.to(device),
                torch.zeros_like(noise).to(device))
        return x0.float().cpu(), vae_decode(v, x0).float().cpu()

    fa.reset_launches()
    x_gpu, v_gpu = run("cuda")
    used = dict(fa.LAUNCHES)
    x_cpu, v_cpu = run("cpu")
    for name in ("flash_attention_bf16", "cross_attention_bf16",
                 "flash_attention_f32", "qk_norm_rope_bf16", "qk_norm_bf16"):
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


def small_fusion_parity():
    """Phase 4a: FusionPipeline on the card against the CPU, t2v and i2v,
    same weights, noise, prompt and image: a 2-layer d=128 DiT (48 latent
    channels) with the full ti2v-5B VAE (the d=640 encoder and d=1024
    decoder attention) and the CLI's mock BAGEL, at 64x64x9."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from univid_tpu_torch.cli.inference import build_fusion, build_parser
    from univid_tpu_torch.core.config import (WAN_CONFIGS, WanDiTConfig,
                                              WanModelSpec)
    from univid_tpu_torch.core.dtypes import DEFAULT_POLICY
    from univid_tpu_torch.kernels import flash_attention as fa
    from univid_tpu_torch.models.wan.dit import WanDiT
    from univid_tpu_torch.models.wan.vae_api import WanVAE, vae_decode
    from univid_tpu_torch.pipelines.ti2v import WanTI2VPipeline

    base = WAN_CONFIGS["ti2v-5B"]
    dit_cfg = WanDiTConfig(in_dim=48, out_dim=48, dim=256, ffn_dim=512,
                           freq_dim=32, text_dim=64, num_heads=2,
                           num_layers=2, text_len=32)
    spec = WanModelSpec(name="smoke-ti2v-d128", dit=dit_cfg, vae=base.vae,
                        generation=base.generation)
    gen = torch.Generator().manual_seed(0)
    dit = WanDiT(dit_cfg, dtype=torch.bfloat16, device="cpu", gen=gen)
    with torch.no_grad():
        dit.head.head.w.normal_(0.0, 0.05, generator=gen)
        for blk in dit.blocks:
            for a in (blk.self_attn, blk.cross_attn):
                a.norm_q.uniform_(0.5, 1.5, generator=gen)
                a.norm_k.uniform_(0.5, 1.5, generator=gen)
    vae = WanVAE(base.vae, dtype=torch.bfloat16, device="cpu", gen=gen)
    policy = dataclasses.replace(DEFAULT_POLICY, bounded_softmax=True)
    args = build_parser().parse_args(["--mock_weights", "--device", "cpu"])
    fusion_cpu = build_fusion(args, None, spec)
    rng = np.random.default_rng(1)
    # 64x64x9: latent 3 x 4 x 4 -> 12 tokens (padded to 64 in attention)
    noise = torch.as_tensor(rng.standard_normal((1, 3, 4, 4, 48)),
                            dtype=torch.float32)
    image = torch.as_tensor(rng.uniform(-1, 1, (64, 64, 3)),
                            dtype=torch.float32)
    t5 = torch.as_tensor(rng.standard_normal((2, 32, 64)) * 0.5,
                         dtype=torch.float32)

    def run(device, img):
        f = copy.deepcopy(fusion_cpu)
        for m in (f.bagel_extractor.params, f.bagel_extractor.siglip,
                  f.projector):
            m.to(device)
        d, v = copy.deepcopy(dit).to(device), copy.deepcopy(vae).to(device)
        f.wan = WanTI2VPipeline(spec, d, v, policy=policy)
        x0 = f.generate_video_with_bagel_context(
            text="a red ball bouncing", image=None if img is None
            else img.to(device), t5_context=t5[0].to(device),
            t5_context_null=t5[1].to(device), size=(64, 64), frame_num=9,
            sampling_steps=4, noise=noise, decode=False)
        return x0.float().cpu(), vae_decode(v, x0).float().cpu()

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-12))

    for mode, img in (("t2v", None), ("i2v", image)):
        fa.reset_launches()
        x_gpu, v_gpu = run("cuda", img)
        used = {k: n for k, n in fa.LAUNCHES.items() if n}
        x_cpu, v_cpu = run("cpu", img)
        need = ("flash_attention_bf16", "cross_attention_bf16",
                "flash_attention_f32", "qk_norm_rope_bf16", "qk_norm_bf16")
        for name in need:
            if name not in used:
                fail(f"small fusion parity ({mode}) did not launch {name}")
        out = {"check": f"small_fusion_parity {mode}",
               "latent_rel_l2": rel(x_gpu, x_cpu),
               "video_rel_l2": rel(v_gpu, v_cpu), "limit": 3e-2,
               "why": "bf16 compute policy: cuBLAS and the CPU round each "
                      "GEMM at other points (2^-8 relative), over 2 blocks "
                      "x 4 steps; the extractor and projector run in fp32",
               "launches": used,
               "finite": bool(torch.isfinite(v_gpu).all())}
        if mode == "i2v":   # the first latent frame is the image's latent
            out["first_frame_rel_l2"] = rel(x_gpu[:, :1], x_cpu[:, :1])
        out["ok"] = (out["finite"] and out["latent_rel_l2"] < 3e-2
                     and out["video_rel_l2"] < 3e-2)
        log(json.dumps(out))
        if not out["ok"]:
            fail(f"FusionPipeline {mode} on the card disagrees with the CPU")


def full_width_extractor(output_dir):
    """Phase 4b: the BAGEL semantic extractor at full width on the card in
    bf16 (BagelConfig(): embed_tokens 152,064 x 3,584; SiglipConfig(): the
    27-layer so400m tower) and the default projector (3,584 -> 8,192 ->
    4,096, 256 -> 512 tokens): one extraction of a seeded 1280x704 image
    plus the prompt (70 x 38 = 2,660 patches in the 4,096 bucket), then the
    projector, timed, with the peak memory; the same modules held against
    the CPU at a 224x224 crop and at a 300x500 crop (resized, a partly
    filled bucket)."""
    import copy
    import gc

    import torch

    from univid_tpu_torch.cli.inference import DEFAULT_PROMPT
    from univid_tpu_torch.core.config import FusionConfig
    from univid_tpu_torch.models.bagel.bagel import BagelConfig, init_bagel
    from univid_tpu_torch.models.bagel.siglip import (SiglipConfig,
                                                      init_siglip)
    from univid_tpu_torch.models.fusion.extractor import \
        BagelSemanticExtractor
    from univid_tpu_torch.models.fusion.projector import (
        context_projector_forward, init_context_projector)
    from univid_tpu_torch.utils.tokenizers import HashTokenizer

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bf = torch.bfloat16
    cfg, scfg, fcfg = BagelConfig(), SiglipConfig(), FusionConfig()

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    t0 = time.perf_counter()
    bagel = init_bagel(gen(20), cfg, dtype=bf, device="cuda",
                       llm_layers=False)
    sig = init_siglip(gen(21), scfg, dtype=bf, device="cuda")
    proj = init_context_projector(gen(22), fcfg, dtype=bf, device="cuda")
    ex = BagelSemanticExtractor(bagel, cfg, HashTokenizer(), siglip=sig,
                                siglip_cfg=scfg,
                                target_len=fcfg.bagel_sequence_length,
                                compute_dtype=bf)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    g = torch.Generator(device="cuda").manual_seed(23)
    image = torch.rand((704, 1280, 3), generator=g, device="cuda") * 2 - 1

    def extract(img):
        return ex(DEFAULT_PROMPT, img)

    def project(tok):
        with torch.no_grad():
            return context_projector_forward(proj, fcfg, tok[None],
                                             compute_dtype=bf)[0]

    tok = extract(image)               # warm-up (cuBLAS handles, caches)
    ctx = project(tok)
    extract_ms = cuda_time(lambda: extract(image), 3)
    project_ms = cuda_time(lambda: project(tok), 3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    # the same modules on the CPU at two crops: 224x224 (256 patches, no
    # resize, a full bucket) and 300x500 (resized to 294x504: 756 patches
    # in the 1,024 bucket, 268 pad patches of segment -1)
    ex_cpu = copy.copy(ex)
    ex_cpu.params = copy.deepcopy(bagel).cpu()
    ex_cpu.siglip = copy.deepcopy(sig).cpu()
    proj_cpu = copy.deepcopy(proj).cpu()
    vs_cpu = {}
    for h, w in ((224, 224), (300, 500)):
        crop = image[:h, :w]
        tok_gpu = extract(crop)
        ctx_gpu = project(tok_gpu)
        tok_cpu = ex_cpu(DEFAULT_PROMPT, crop.cpu())
        with torch.no_grad():
            ctx_cpu = context_projector_forward(proj_cpu, fcfg, tok_cpu[None],
                                                compute_dtype=bf)[0]
        vs_cpu[f"{h}x{w}"] = {
            "tokens_rel_l2": rel_l2(tok_gpu.cpu(), tok_cpu),
            "context_rel_l2": rel_l2(ctx_gpu.cpu(), ctx_cpu)}
    out = {"phase": "full_width_extractor", "init_s": init_s,
           "extract_ms": extract_ms, "project_ms": project_ms,
           "peak_memory_gb": peak, "tokens": list(tok.shape),
           "context": list(ctx.shape), "vs_cpu": vs_cpu, "limit": 2e-2,
           "why": "bf16 on both sides; cuBLAS and the CPU round each GEMM "
                  "at other points (2^-8 relative) over 27 layers"}
    out["ok"] = (list(tok.shape) == [256, 3584]
                 and list(ctx.shape) == [512, 4096]
                 and bool(torch.isfinite(ctx.float()).all())
                 and all(e < 2e-2 for c in vs_cpu.values()
                         for e in c.values()))
    log(json.dumps(out))
    if not out["ok"]:
        fail("the full-width extractor disagrees with the CPU or is off")
    del ex, ex_cpu, bagel, sig, proj, proj_cpu
    gc.collect()
    torch.cuda.empty_cache()


def train_parity(output_dir):
    """Phase 4b: three steps of the port's make_diffusion_train_step on the
    card (kernels) against the same steps on the CPU (plain versions), from
    one initial state, on a 2-layer d=128 DiT with LoRA and the projector
    (remat 'attn', bf16 residual, bounded softmax); then
    train_cross_attention_fusion for a few steps on the card over a
    2-sample dataset, which must write latest/, best/ and lora_best/."""
    import dataclasses
    import os
    import shutil

    import torch

    from univid_tpu_torch.core.config import (WAN_CONFIGS, FusionConfig,
                                              WanDiTConfig, WanModelSpec)
    from univid_tpu_torch.core.dtypes import BF16_RESIDUAL_POLICY
    from univid_tpu_torch.kernels import flash_attention as fa
    from univid_tpu_torch.models.wan.dit import WanDiT
    from univid_tpu_torch.models.wan.vae_api import WanVAE
    from univid_tpu_torch.train import fusion_trainer as ft
    from univid_tpu_torch.train.lora import LoRAConfig, trainable_sites

    base = WAN_CONFIGS["t2v-1.3B"]
    dit_cfg = WanDiTConfig(model_type="t2v", in_dim=16, out_dim=16, dim=256,
                           ffn_dim=512, freq_dim=32, text_dim=64,
                           num_heads=2, num_layers=2, text_len=32)
    spec = WanModelSpec(name="smoke-train-d128", dit=dit_cfg, vae=base.vae,
                        generation=base.generation)
    fusion = FusionConfig(bagel_hidden_dim=64, wan_text_dim=64,
                          wan_text_length=32, bagel_sequence_length=16)
    train_cfg = ft.FusionTrainConfig(max_steps=3, learning_rate=1e-3)
    lora_cfg = LoRAConfig(rank=4)   # cross q/k/v/o and self q/v, 2 layers
    policy = dataclasses.replace(BF16_RESIDUAL_POLICY, bounded_softmax=True)

    def make_dit(device):
        gen = torch.Generator().manual_seed(0)
        dit = WanDiT(dit_cfg, dtype=torch.bfloat16, device="cpu", gen=gen)
        with torch.no_grad():   # the zero head blocks every gradient
            dit.head.head.w.normal_(0.0, 0.02, generator=gen)
            for blk in dit.blocks:
                for a in (blk.self_attn, blk.cross_attn):
                    a.norm_q.uniform_(0.5, 1.5, generator=gen)
                    a.norm_k.uniform_(0.5, 1.5, generator=gen)
        return dit.to(device)

    cpu_gen = torch.Generator().manual_seed(3)
    grid = (3, 8, 8)   # 48 tokens, padded to 64 (kv_len) in attention
    batch = {
        "latents": torch.randn((1, *grid, 16), generator=cpu_gen).to(
            torch.bfloat16),
        "bagel_tokens": torch.randn((1, 16, 64), generator=cpu_gen),
        "noise": torch.randn((1, *grid, 16), generator=cpu_gen).to(
            torch.bfloat16),
        "t": torch.tensor([500.0]),
    }

    def run(device):
        state, tx, tmpl = ft.init_fusion_train_state(
            torch.Generator().manual_seed(1), fusion, train_cfg,
            dit_cfg=dit_cfg, lora_cfg=lora_cfg, device="cpu")
        tmpl = dict(tmpl, sites={
            s: {k: t.detach().to(device) for k, t in p.items()}
            for s, p in tmpl["sites"].items()})
        trainable = {"projector": state["trainable"]["projector"].to(device),
                     "lora": trainable_sites(tmpl)}
        start = {n: t.detach().float().cpu().clone()
                 for n, t in ft.named_leaves(trainable)}
        state = ft.new_train_state(trainable, tx)
        step, _ = ft.make_diffusion_train_step(
            spec, fusion, train_cfg, tx, make_dit(device), None, grid,
            lora_template=tmpl, remat_blocks="attn", policy=policy)
        losses = []
        for _ in range(3):
            state, loss = step(state, {k: v.to(device)
                                       for k, v in batch.items()})
            losses.append(float(loss))
        moved = {n: t.detach().float().cpu() - start[n]
                 for n, t in ft.named_leaves(state["trainable"])}
        return losses, moved

    fa.reset_launches()
    loss_gpu, moved_gpu = run("cuda")
    used = {k: v for k, v in fa.LAUNCHES.items() if v}
    loss_cpu, moved_cpu = run("cpu")
    for name in ("flash_attention_bf16_lse", "flash_attention_bwd_bf16_sm90"):
        if name not in used:
            fail(f"train parity run did not launch {name}")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(loss_gpu, loss_cpu))
    upd = {group: rel_l2(
        torch.cat([moved_gpu[n].flatten() for n in moved_gpu
                   if n.startswith(group)]),
        torch.cat([moved_cpu[n].flatten() for n in moved_cpu
                   if n.startswith(group)]))
        for group in ("projector", "lora")}
    out = {"check": "train_parity", "loss_gpu": loss_gpu,
           "loss_cpu": loss_cpu, "loss_rel_err": loss_err,
           "loss_limit": 2e-2, "update_rel_l2": upd, "update_limit": 0.1,
           "why": "bf16 GEMMs and attention round at other points on the "
                  "card and the CPU (2^-8 relative); the losses agree to "
                  "that; the parameter updates (theta_3 - theta_0) of "
                  "AdamW's first steps are about lr * sign(g), so a "
                  "gradient element near 0 can take either sign",
           "launches": used}
    out["ok"] = (loss_err < 2e-2 and max(upd.values()) < 0.1
                 and all(math.isfinite(x) for x in loss_gpu))
    log(json.dumps(out))
    if not out["ok"]:
        fail("training on the card disagrees with training on the CPU")

    # the loop on the card: checkpoints, best model and the adapter
    run_dir = os.path.join(output_dir, "train_loop")
    shutil.rmtree(run_dir, ignore_errors=True)
    vae = WanVAE(base.vae, dtype=torch.bfloat16, device="cuda",
                 gen=torch.Generator(device="cuda").manual_seed(2))

    def extract(caption):
        g = torch.Generator(device="cuda").manual_seed(sum(map(ord,
                                                               caption)))
        return torch.randn((16, 64), generator=g, device="cuda")

    vgen = torch.Generator(device="cuda").manual_seed(4)
    data = [{"caption": f"sample {i}",
             "video": torch.rand((5, 64, 64, 3), generator=vgen,
                                 device="cuda") * 2 - 1} for i in range(2)]
    res = ft.train_cross_attention_fusion(
        data, extract, None, fusion,
        dataclasses.replace(train_cfg, max_steps=4, save_interval=2),
        run_dir, resume=False, dit_cfg=dit_cfg, lora_cfg=lora_cfg,
        device="cuda",
        diffusion={"spec": spec, "dit": make_dit("cuda"), "vae": vae,
                   "latent_grid": (2, 8, 8), "remat_blocks": "attn",
                   "policy": policy})
    files = {sub: os.path.exists(os.path.join(run_dir, sub, fname))
             for sub, fname in (("latest", "train_state.npz"),
                                ("best", "train_state.npz"),
                                ("lora_best", "lora_weights.npz"))}
    out = {"check": "train_loop", "steps": res["steps"],
           "losses": res["losses"], "files": files}
    out["ok"] = (res["steps"] == 4 and all(files.values())
                 and all(math.isfinite(x) for x in res["losses"]))
    log(json.dumps(out))
    if not out["ok"]:
        fail("train_cross_attention_fusion on the card")


def train_main_path(n_steps):
    """Phase 6: the training path at full width: t2v-1.3B at 832x480x81
    (latents [1, 21, 60, 104, 16], 32,760 tokens padded to 32,768), bf16
    base DiT with random weights, LoRA rank 16 ('wan_cross_attention')
    plus the default projector (BAGEL tokens [1, 256, 3584]), remat
    'attn', bf16 residual, bounded softmax: `n_steps` steps of the port's
    make_diffusion_train_step. Returns the kernels' launch counts."""
    import dataclasses
    import gc

    import torch

    from univid_tpu_torch.core.config import (WAN_CONFIGS, FusionConfig,
                                              latent_shape)
    from univid_tpu_torch.core.dtypes import BF16_RESIDUAL_POLICY
    from univid_tpu_torch.kernels import flash_attention as fa
    from univid_tpu_torch.models.wan.dit import WanDiT
    from univid_tpu_torch.train import fusion_trainer as ft
    from univid_tpu_torch.train.lora import LoRAConfig

    gc.collect()
    torch.cuda.empty_cache()
    spec = WAN_CONFIGS["t2v-1.3B"]
    fusion = FusionConfig(wan_text_dim=spec.dit.text_dim,
                          wan_text_length=spec.dit.text_len)
    train_cfg = ft.FusionTrainConfig(train_lora=True)
    _, f, lh, lw = latent_shape(spec, 832, 480, 81)

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    dit = WanDiT(spec.dit, dtype=torch.bfloat16, device="cuda", gen=gen(0))
    with torch.no_grad():   # the zero head blocks every gradient
        dit.head.head.w.normal_(0.0, 0.02, generator=gen(5))
    state, tx, tmpl = ft.init_fusion_train_state(
        gen(1), fusion, train_cfg, dit_cfg=spec.dit, lora_cfg=LoRAConfig(),
        device="cuda")
    policy = dataclasses.replace(BF16_RESIDUAL_POLICY, bounded_softmax=True)
    step, _ = ft.make_diffusion_train_step(
        spec, fusion, train_cfg, tx, dit, None, (f, lh, lw),
        lora_template=tmpl, remat_blocks="attn", policy=policy)
    c = spec.vae.z_dim
    batch = {
        "latents": torch.randn((1, f, lh, lw, c), generator=gen(2),
                               device="cuda").to(torch.bfloat16),
        "bagel_tokens": torch.randn(
            (1, fusion.bagel_sequence_length, fusion.bagel_hidden_dim),
            generator=gen(3), device="cuda").to(torch.bfloat16),
        "noise": torch.randn((1, f, lh, lw, c), generator=gen(4),
                             device="cuda").to(torch.bfloat16),
        "t": torch.tensor([500.0], device="cuda"),
    }
    snapshot = {k: v.clone() for k, v in dit.state_dict().items()}
    # per step, remat 'attn': self-attention of layers 1-29 on the forward
    # with lse (layer 0's q, k, v have no trainable upstream: the serving
    # kernel, and no backward), cross-attention twice (forward and its
    # recompute in the backward), one one-pass sm90 backward per
    # differentiated call (none on the mma.sync pair)
    per_step = dict(dict.fromkeys(fa.LAUNCHES, 0),
                    flash_attention_bf16=1,
                    flash_attention_bf16_lse=29 + 2 * 30,
                    flash_attention_bwd_bf16_sm90=29 + 30)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    seconds, losses = [], []
    for i in range(n_steps):
        before = dict(fa.LAUNCHES)
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        losses.append(float(loss))   # waits for the step
        seconds.append(time.perf_counter() - t0)
        counts = {k: fa.LAUNCHES[k] - before[k] for k in before}
        if counts != per_step:
            fail(f"train step {i + 1} launches {counts} != {per_step}")
        if i == 0:
            b_max = max(float(p["b"].detach().abs().max())
                        for p in state["trainable"]["lora"].values())
            if not b_max > 0:
                fail("LoRA b is still zero after the first step")
    launches = launch_counts()
    # the serving self-attention of layer 0 and the 89 forwards with lse
    check_impl("LoRA training", (1 + 89) * n_steps)
    check_bwd_impl("LoRA training", 59 * n_steps)
    peak = torch.cuda.max_memory_allocated() / 1e9
    state, profiled = profile_step(step, state, batch)
    base_same = all(torch.equal(v, snapshot[k])
                    for k, v in dit.state_dict().items())
    out = {"phase": "train_main_path", "model": "t2v-1.3B",
           "resolution": "832x480x81", "tokens": f * (lh // 2) * (lw // 2),
           "steps": n_steps, "step_seconds": seconds,
           # the first step also allocates: the median of the others
           "seconds_per_step": statistics.median(seconds[1:] or seconds),
           "peak_memory_gb": peak, "losses": losses,
           "launches": launches, "launches_per_step": per_step,
           "base_unchanged": base_same, "profiled_step": profiled}
    log(json.dumps(out))
    if not all(math.isfinite(x) for x in losses):
        fail("non-finite training loss")
    if not base_same:
        fail("the frozen base DiT changed during training")
    del state, step, dit, snapshot, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the training CLI over an OpenVid directory (cli/train.py)
# ---------------------------------------------------------------------------

TRAIN_CLI_STEPS = 3
# ti2v-5B at the JAX CLI's defaults, 512x320x21: latents [1, 6, 20, 32, 48],
# (6 / 1) x (20 / 2) x (32 / 2) = 960 tokens, unpadded (the trainer pads
# above 2,048); 24 heads of d=128; the VAE encoder's d=640 attention on one
# latent frame's 20 x 32 tokens, once a chunk: 1 + 20 / 4 = 6 an encode
TRAIN_CLI_LATENTS = (1, 6, 20, 32, 48)
TRAIN_CLI_TOKENS = 960
TRAIN_CLI_VAE_CALLS = 6
TRAIN_CLI_CLIP = (640, 360, 25)   # the written clips: W, H, frames
# h264 at imageio's quality 8 on smooth frames: measured on the CPU 0.0175
# mean |err| and 39.6 dB on the [-1, 1] scale; a zero clip is ~0.45 off
DECODE_TOL = dict(mean_abs=0.04, psnr_db=32.0)


def check_train_cli_kernels():
    """The kernels of `train_cli_on_card` at its shapes (running max, no
    kv_len): the forward with lse and the one-pass sm90 backward at self
    [1, 960, 24, 128] (7.5 q tiles of 128: the last one ragged) and cross
    (k, v [1, 512, 24, 128]), each against its plain version
    (`train_kernel_records`), and the fp32 VAE kernel at d=640 on 640
    tokens (`vae_kernel_record`). Logged on `kernel_at_train_cli_shape`
    lines; returns the kernels-line records `<kernel>_train_cli` (and
    `_train_cli_cross`), each counted by its kernel's counter in the
    phase's LoRA run."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(12)
    out = {}
    for shape, lk in (("self", TRAIN_CLI_TOKENS), ("cross", 512)):
        sfx = "_train_cli" + ("_cross" if shape == "cross" else "")
        recs = train_kernel_records(gen, f"ti2v-5B train {shape}", 1,
                                    TRAIN_CLI_TOKENS, 24, lk, None, None)
        for name, rec in recs.items():
            log(json.dumps({"kernel_at_train_cli_shape": dict(
                rec, shape=shape)}))
            if name in ("flash_attention_bf16_lse",
                        "flash_attention_bwd_bf16_sm90"):
                out[name + sfx] = dict(rec, name=name + sfx, counter=name)
    rec = vae_kernel_record(gen, 640, 640, 640)
    log(json.dumps({"kernel_at_train_cli_shape": dict(rec, shape="vae")}))
    out["flash_attention_f32_train_cli"] = dict(
        rec, name="flash_attention_f32_train_cli",
        counter="flash_attention_f32")
    torch.cuda.empty_cache()
    return out


def smooth_clip(n, h, w, seed):
    """[n, h, w, 3] uint8 frames of drifting sinusoids (a phase per channel
    from `seed`): smooth enough for h264 to keep them close."""
    import numpy as np

    t = np.arange(n)[:, None, None, None]
    v = np.linspace(0.0, 1.0, h)[None, :, None, None]
    u = np.linspace(0.0, 1.0, w)[None, None, :, None]
    ph = np.random.default_rng(seed).uniform(0, 2 * np.pi, 3)
    x = (0.5 + 0.22 * np.sin(2 * np.pi * (1.5 * u + 0.04 * t) + ph)
         + 0.22 * np.cos(2 * np.pi * (2.0 * v - 0.03 * t) + ph[::-1]))
    return (x * 255).round().clip(0, 255).astype(np.uint8)


def write_openvid_dir(root):
    """An OpenVid directory: three smooth clips of TRAIN_CLI_CLIP, written
    with the port's save_video, and a CSV in OpenVid-1M's columns whose
    quality filters keep clip0 and clip2 (clip1's aesthetic score is 3.9).
    Returns (video dir, CSV path, {file: the frames written})."""
    import csv
    import os

    from univid_tpu_torch.data.video_io import save_video

    vids = os.path.join(root, "videos")
    os.makedirs(vids, exist_ok=True)
    w, h, n = TRAIN_CLI_CLIP
    written = {}
    for i in range(3):
        name = f"clip{i}.mp4"
        frames = smooth_clip(n, h, w, i)
        path = save_video(frames, os.path.join(vids, name), fps=16)
        if path != os.path.join(vids, name):
            fail(f"save_video wrote {path}, not an mp4")
        written[name] = frames
    csv_path = os.path.join(root, "OpenVid-1M.csv")
    with open(csv_path, "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["video", "caption", "aesthetic score", "motion score",
                     "temporal consistency score", "camera motion", "frame",
                     "fps", "seconds"])
        wr.writerow(["clip0.mp4", "A slow pan across rolling green hills "
                     "at dawn, soft mist in the valleys.", 5.12, 4.3, 0.93,
                     "pan_right", n, 16.0, 6.2])
        wr.writerow(["clip1.mp4", "A shaky handheld shot of an empty "
                     "parking lot at noon.", 3.9, 4.0, 0.9, "static", n,
                     16.0, 5.0])
        wr.writerow(["clip2.mp4", "Waves wash over a pebble beach under a "
                     "grey sky, the camera still.", 4.8, 3.6, 0.86, "static",
                     n, 16.0, 4.1])
    return vids, csv_path, written


def check_openvid_decode(vids, csv_path, written):
    """OpenVidDataset on the card machine: the CSV's filters keep clip0 and
    clip2, and each kept clip decodes to the frames written (sampled as
    read_video_frames samples 21 of 25, resized to 512x320, in [-1, 1])
    within DECODE_TOL, never to zeros (a missing file or a failed decode
    gives zeros, as in JAX)."""
    import numpy as np

    from univid_tpu_torch.data.openvid import OpenVidConfig, OpenVidDataset
    from univid_tpu_torch.data.video_io import _sample_indices
    from univid_tpu_torch.native import resize_bilinear

    ds = OpenVidDataset(OpenVidConfig(video_base_path=vids,
                                      csv_file=csv_path,
                                      video_size=(512, 320), video_length=21))
    kept = [r["video"] for r in ds.records]
    clips = []
    for i, name in enumerate(kept):
        item = ds[i]
        got = item["video"]
        n = len(written[name])
        want = np.stack([(resize_bilinear(written[name][j].astype(np.float32)
                                          / 255.0, 320, 512) - 0.5) * 2.0
                         for j in _sample_indices(n, 21)])
        err = np.abs(got - want) if got.shape == want.shape else None
        rec = {"file": name, "caption": item["caption"],
               "shape": list(got.shape), "std": float(got.std()),
               "max_abs": float(np.abs(got).max())}
        if err is not None:
            rec.update(mean_abs_err=float(err.mean()),
                       max_abs_err=float(err.max()),
                       psnr_db=float(10 * np.log10(4.0 / float(
                           (err ** 2).mean()))))
        rec["ok"] = (err is not None
                     and rec["mean_abs_err"] < DECODE_TOL["mean_abs"]
                     and rec["psnr_db"] > DECODE_TOL["psnr_db"]
                     and rec["std"] > 0.1 and rec["max_abs"] > 0.5)
        clips.append(rec)
    out = {"check": "OpenVidDataset decodes the written clips",
           "kept": kept, "clips": clips, "tolerance": DECODE_TOL,
           "why": "h264 at quality 8 on smooth frames (0.0175 mean |err|, "
                  "39.6 dB on the CPU); a zero clip is ~0.45 off",
           "ok": kept == ["clip0.mp4", "clip2.mp4"]
           and all(c["ok"] for c in clips)}
    log(json.dumps(out))
    if not out["ok"]:
        fail("OpenVidDataset on the card machine: wrong records or a clip "
             "that does not decode to its frames")


def train_cli_on_card(output_dir):
    """Phase 6b: the training CLI (univid_tpu_torch.cli.train.main) on the
    card over an OpenVid directory written here (`write_openvid_dir`,
    decode checked by `check_openvid_decode`), at the JAX CLI's defaults:
    ti2v-5B at 512x320x21, full width (the 30-block DiT in fp32 with its
    head redrawn, the Wan2.2 VAE, JAX's tiny BAGEL), --mock_weights
    --train_lora, TRAIN_CLI_STEPS steps. Per step (the launches since the
    previous step ended, which take in the clip's VAE encode): 1 serving
    self-attention (layer 0: no trainable upstream), 59 forwards with lse
    (29 self + 30 cross) and 59 one-pass sm90 backward calls, 6 d=640 VAE
    calls; the step's latents, DiT tokens and token padding as run, held
    to TRAIN_CLI_LATENTS, TRAIN_CLI_TOKENS and none (the shapes
    check_train_cli_kernels holds the kernels at); LoRA b off zero after
    step 1, a finite loss; the frozen base unchanged (held on the host);
    latest/, best/ and lora_best/ written.
    Then TRAIN_CLI_STEPS semantic steps (no --train_lora): UMT5-XXL (fp32
    mock, drawn only for this objective) against the projector, no kernel
    launched. Returns the launch counts of the LoRA run."""
    import gc
    import os

    import numpy as np
    import torch

    from univid_tpu_torch.cli import train as train_cli
    from univid_tpu_torch.kernels import flash_attention as fa
    from univid_tpu_torch.train import fusion_trainer as ft

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    root = os.path.join(output_dir, "openvid")
    vids, csv_path, written = write_openvid_dir(root)
    check_openvid_decode(vids, csv_path, written)

    per_step = dict(dict.fromkeys(fa.LAUNCHES, 0),
                    flash_attention_bf16=1,
                    flash_attention_bf16_lse=29 + 30,
                    flash_attention_bwd_bf16_sm90=29 + 30,
                    flash_attention_f32=TRAIN_CLI_VAE_CALLS)
    steps = []
    base = {}
    pads = []   # the DiT forward's seq_pad_to, as the trainer passes it
    make_step = ft.make_diffusion_train_step
    dit_forward = ft.wan_dit_forward

    def recording_forward(*a, seq_pad_to=None, **kw):
        pads.append(seq_pad_to)
        return dit_forward(*a, seq_pad_to=seq_pad_to, **kw)

    def counting_make(spec, fusion_cfg, train_cfg, tx, base_dit, *a, **kw):
        """The trainer's step, each call's launches, seconds, loss and
        LoRA b checked; the base DiT held on the host first."""
        base.update({k: v.detach().to("cpu", copy=True)
                     for k, v in base_dit.state_dict().items()})
        base["_dit"] = base_dit
        step, encode = make_step(spec, fusion_cfg, train_cfg, tx, base_dit,
                                 *a, **kw)
        patch = spec.dit.patch_size

        def step_checked(state, batch):
            lat = tuple(batch["latents"].shape)   # [B, F, H, W, C], as run
            tokens = math.prod(n // p for n, p in zip(lat[1:4], patch))
            t0 = time.perf_counter()
            state, loss = step(state, batch)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            now = dict(fa.LAUNCHES)
            prev = steps[-1]["_counts"] if steps else dict.fromkeys(now, 0)
            counts = {k: now[k] - prev[k] for k in now}
            b_max = max(float(p["b"].detach().abs().max())
                        for p in state["trainable"]["lora"].values())
            steps.append({"step": len(steps) + 1, "latents": lat,
                          "tokens": tokens, "seq_pad_to": pads[-1],
                          "loss": float(loss),
                          "step_seconds": seconds, "lora_b_max": b_max,
                          "launches_ok": counts == per_step,
                          "_counts": now})
            if counts != per_step:
                fail(f"train CLI step {len(steps)} launches {counts} != "
                     f"{per_step}")
            if not b_max > 0:
                fail(f"train CLI step {len(steps)}: LoRA b is still zero")
            if not math.isfinite(float(loss)):
                fail(f"train CLI step {len(steps)}: non-finite loss")
            return state, loss

        return step_checked, encode

    out_lora = os.path.join(output_dir, "train_cli_lora")
    argv = ["--video_dir", vids, "--csv_file", csv_path, "--model",
            "ti2v-5B", "--video_size", "512x320", "--video_length", "21",
            "--mock_weights", "--max_steps", str(TRAIN_CLI_STEPS),
            "--log_interval", "1", "--seed", "0"]
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    ft.make_diffusion_train_step = counting_make
    ft.wan_dit_forward = recording_forward
    t0 = time.perf_counter()
    try:
        summary = train_cli.main(argv + ["--train_lora", "--output_dir",
                                         out_lora])
    finally:
        ft.make_diffusion_train_step = make_step
        ft.wan_dit_forward = dit_forward
    lora_s = time.perf_counter() - t0
    lora_peak = torch.cuda.max_memory_allocated() / 1e9
    launches = launch_counts()
    f32_by_d = dict(fa.F32_LAUNCHES_BY_D)
    check_impl("train CLI (LoRA)", 60 * TRAIN_CLI_STEPS)
    check_bwd_impl("train CLI (LoRA)", 59 * TRAIN_CLI_STEPS)
    dit = base.pop("_dit", None)
    base_same = dit is not None and all(
        torch.equal(v.cpu(), base[k]) for k, v in dit.state_dict().items())
    files = {sub: os.path.exists(os.path.join(out_lora, sub, fname))
             for sub, fname in (("latest", "train_state.npz"),
                                ("best", "train_state.npz"),
                                ("lora_best", "lora_weights.npz"))}
    del dit
    base.clear()
    gc.collect()
    torch.cuda.empty_cache()

    # the semantic objective: UMT5-XXL features of each caption
    out_sem = os.path.join(output_dir, "train_cli_semantic")
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.perf_counter()
    sem = train_cli.main(argv + ["--output_dir", out_sem])
    sem_s = time.perf_counter() - t0
    sem_peak = torch.cuda.max_memory_allocated() / 1e9
    sem_launches = {k: v for k, v in launch_counts().items() if v}
    sem_ok = (sem["steps"] == TRAIN_CLI_STEPS
              and math.isfinite(sem["best_loss"]) and not sem_launches
              and os.path.exists(os.path.join(out_sem, "latest",
                                              "train_state.npz")))
    rec = {"phase": "train_cli_on_card", "model": "ti2v-5B",
           "resolution": "512x320x21",
           "lora": {"summary": summary, "seconds": lora_s,
                    "steps": [{k: v for k, v in st.items() if k != "_counts"}
                              for st in steps],
                    "seconds_per_step": statistics.median(
                        [st["step_seconds"] for st in steps[1:]]
                        or [st["step_seconds"] for st in steps]),
                    "peak_memory_gb": lora_peak, "launches": launches,
                    "launches_per_step": per_step,
                    "f32_launches_by_d": f32_by_d,
                    "base_unchanged": base_same, "files": files},
           "semantic": {"summary": sem, "seconds": sem_s,
                        "peak_memory_gb": sem_peak,
                        "launches": sem_launches, "ok": sem_ok},
           "peak_memory_gb": max(lora_peak, sem_peak),
           "seconds": time.perf_counter() - t_phase}
    log(json.dumps(rec))
    if len(steps) != TRAIN_CLI_STEPS or summary["steps"] != TRAIN_CLI_STEPS:
        fail(f"train CLI ran {len(steps)} steps, not {TRAIN_CLI_STEPS}")
    # each step ran at the shapes check_train_cli_kernels held the kernels at
    ran = {(st["latents"], st["tokens"], st["seq_pad_to"]) for st in steps}
    if ran != {(TRAIN_CLI_LATENTS, TRAIN_CLI_TOKENS, None)}:
        fail(f"train CLI steps ran at (latents, tokens, seq_pad_to) {ran}, "
             f"not {TRAIN_CLI_LATENTS}, {TRAIN_CLI_TOKENS}, unpadded")
    if f32_by_d != {384: 0, 640: TRAIN_CLI_VAE_CALLS * TRAIN_CLI_STEPS,
                    1024: 0}:
        fail(f"train CLI VAE kernel launches by d {f32_by_d}")
    if not base_same:
        fail("train CLI: the frozen base DiT changed")
    if not all(files.values()):
        fail(f"train CLI: checkpoints missing {files}")
    if not sem_ok:
        fail(f"train CLI semantic run: {sem}, launches {sem_launches}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def profile_call(fn, families=None):
    """fn() under torch.profiler, to a synchronised end: the device time of
    its kernels by family, their count, the five kernels that took the
    most device time, and the share of the wall time in which no kernel
    ran (the profiler's host overhead inflates the wall time, so this
    share is an upper bound). `families` ({name: kernel-name substrings})
    splits out families of its own, matched before the default ones.
    Returns (fn(), summary)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    families = families or {}
    fam = dict.fromkeys(families, 0.0)
    fam.update({"attention_kernels_ms": 0.0, "gemm_ms": 0.0,
                "other_kernels_ms": 0.0})
    n_kernels = 0
    top = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        n_kernels += e.count
        ms = e.self_device_time_total / 1e3
        top.append({"kernel": e.key[:90], "ms": ms, "count": e.count})
        name = e.key.lower()
        own = [f for f, keys in families.items()
               if any(k in name for k in keys)]
        if own:
            fam[own[0]] += ms
        elif ("flash_" in name or "rope_rotate" in name or "mask_tiles" in name
                or "qk_norm_rope" in name or "quant_q" in name
                or "bwd_pre" in name or "bwd_post" in name
                or "bwd_tiles" in name or "tile_lists" in name
                or "split_bf16x3" in name
                or "causal_merge" in name):
            fam["attention_kernels_ms"] += ms
        elif "gemm" in name or "nvjet" in name or "xmma" in name:
            fam["gemm_ms"] += ms
        else:   # elementwise, reductions, copies, memsets
            fam["other_kernels_ms"] += ms
    busy = sum(fam.values())
    top = sorted(top, key=lambda r: -r["ms"])[:5]
    return out, dict(fam, wall_ms=wall_ms, device_busy_ms=busy,
                     kernels=n_kernels, top_kernels=top,
                     idle_share_upper_bound=max(0.0, 1 - busy / wall_ms))


def profile_step(step, state, batch):
    """One more train step under torch.profiler (`profile_call`).
    Returns (state, summary)."""
    (state, _), summary = profile_call(lambda: step(state, batch))
    return state, summary


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
    launches = launch_counts()
    expected = {"flash_attention_bf16": 30 * steps,
                "flash_attention_bf16_causal": 0,
                "cross_attention_bf16": 30 * steps,
                "flash_attention_f32": 21,
                # kernel A: norm + rope for the self-attention's q and k,
                # norm only for the cross-attention's
                "qk_norm_rope_bf16": 30 * steps,
                "qk_norm_bf16": 30 * steps,
                "flash_attention_bf16_lse": 0,    # serving differentiates
                "flash_attention_bwd_dq_bf16": 0,  # nothing
                "flash_attention_bwd_dkv_bf16": 0}
    expected = dict(dict.fromkeys(launches, 0), **expected)   # no mask mode
    f32_by_d = dict(fa.F32_LAUNCHES_BY_D)
    f32_expected = {384: 21, 640: 0, 1024: 0}   # the 1.3B VAE's d=384
    frames = read_video_frames(meta["video_path"])
    log(json.dumps({
        "phase": "main_path", "seconds": wall,
        "phase_times_s": meta["phase_times_s"],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "expected_launches": expected,
        "f32_launches_by_d": f32_by_d, "frames": len(frames),
        "frame_shape": list(frames[0].shape) if frames else None}))
    if launches != expected or f32_by_d != f32_expected:
        fail(f"launch counts {launches} {f32_by_d} != {expected} "
             f"{f32_expected}")
    check_impl("t2v-1.3B serving", 60 * steps)   # self + cross a block
    if len(frames) != 81 or frames[0].shape != (480, 832, 3):
        fail("the mp4 is not 81 frames of 480x832")
    return launches


# cut from the full request's 121 frames for the time limit (the fp32 BAGEL
# phase's room): its 121-frame decode took ~59 s on an H100; the kernel
# checks keep the 121-frame shapes
TI2V_FRAMES = 41
TI2V_STEPS = 2


def ti2v_main_path(output_dir):
    """Phase 7: the CLI's default path, ti2v-5B with BAGEL fusion at
    1280x704x121 (full width and depth, random weights from a seed), 2
    steps, --mode i2v from a seeded first-frame png: the first-frame
    encode (the d=640 VAE kernel) and one decode (31 d=1024 launches);
    then the t2v mode knob-free on the same pipeline, one step without its
    decode (`ti2v_t2v_step`: one decode of the two --mode both runs is cut
    for the time limit). Checks the mp4,
    the fusion context, the peak memory and the kernels' launches, the
    fp32 VAE kernel's by head dim. Returns the launch counts of the run."""
    import gc
    import os

    import numpy as np
    import torch
    from PIL import Image

    from univid_tpu_torch.cli import inference
    from univid_tpu_torch.data.video_io import read_video_frames
    from univid_tpu_torch.kernels import flash_attention as fa

    gc.collect()
    torch.cuda.empty_cache()
    os.makedirs(output_dir, exist_ok=True)
    png = os.path.join(output_dir, "first_frame.png")
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, (704, 1280, 3), dtype=np.uint8)) \
        .save(png)
    frames, steps = TI2V_FRAMES, TI2V_STEPS
    held = {}   # the CLI's FusionPipeline and its generate kwargs
    build_fusion = inference.build_fusion

    def holding_build_fusion(*a, **kw):
        fusion = build_fusion(*a, **kw)
        generate = fusion.generate_video_with_bagel_context

        def held_generate(**gkw):
            held.update(fusion=fusion, kwargs=gkw)
            return generate(**gkw)

        fusion.generate_video_with_bagel_context = held_generate
        return fusion

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    inference.build_fusion = holding_build_fusion
    t0 = time.perf_counter()
    try:
        metas = inference.main([
            "--model", "ti2v-5B", "--mode", "i2v", "--image", png,
            "--mock_weights", "--video_size", "1280x704", "--video_length",
            str(frames), "--steps", str(steps), "--seed", "0",
            "--output_dir", output_dir])
    finally:
        inference.build_fusion = build_fusion
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    got = dict(fa.LAUNCHES, **{f"flash_attention_f32 d={d}": n for d, n
                               in fa.F32_LAUNCHES_BY_D.items()},
               **{f"bf16 forward on {k}": n for k, n
                  in fa.LAUNCHES_BY_IMPL.items()})
    n_dec = (frames - 1) // 4 + 1   # 1 + 30 chunks of one latent frame
    expected = dict(dict.fromkeys(fa.LAUNCHES, 0), **{
        "flash_attention_bf16": 30 * steps,
        "cross_attention_bf16": 30 * steps,
        "qk_norm_rope_bf16": 30 * steps,   # self-attention: q and k
        "qk_norm_bf16": 30 * steps,        # cross-attention: q and k
        # per decoded chunk at d=1024, and the first-frame encode at d=640
        "flash_attention_f32": n_dec + 1,
        "flash_attention_f32 d=384": 0,
        "flash_attention_f32 d=640": 1,
        "flash_attention_f32 d=1024": n_dec,
        "bf16 forward on sm90": 60 * steps,     # self + cross a block
        "bf16 forward on causal_sm90": 0,
        "bf16 forward on mma_sync": 0})
    fr = read_video_frames(metas[0]["video_path"]) if metas else []
    video = {"mode": metas[0]["mode"] if metas else None,
             "frames": len(fr),
             "frame_shape": list(fr[0].shape) if fr else None,
             "context_path": metas[0]["context_path"] if metas else None}
    log(json.dumps({
        "phase": "ti2v_main_path", "model": "ti2v-5B", "mode": "i2v",
        "resolution": f"1280x704x{frames}", "steps": steps,
        "seconds": wall, "phase_times_s": metas[-1]["phase_times_s"],
        "generation_time_s": metas[-1]["generation_time_s"],
        "peak_memory_gb": peak, "launches": got,
        "expected_launches": expected, "video": video}))
    if got != expected:
        fail(f"ti2v-5B launch counts {got} != {expected}")
    if video != {"mode": "i2v", "frames": frames,
                 "frame_shape": [704, 1280, 3],
                 "context_path": "bagel_fusion"}:
        fail(f"ti2v-5B i2v: {video} is not {frames} frames of 704x1280 "
             "from the BAGEL fusion context")
    if peak >= 80.0:
        fail(f"ti2v-5B peak memory {peak:.1f} GB")
    t2v = ti2v_t2v_step(held, frames)
    held.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return {k: launches[k] + t2v[k] for k in launches}


def ti2v_t2v_step(held, frames):
    """The knob-free t2v mode of the ti2v-5B CLI run: the same
    FusionPipeline (`held`, taken from the i2v run) and kwargs without the
    image, one denoise step and no decode (both of the two --mode both
    decodes went for the time limit): the BAGEL context of the text alone,
    one CFG DiT call at 1280x704x121 with 30 self, 30 cross, 30 kernel A
    norm + rope and 30 norm-only launches and no VAE launch, the latent
    [1, 31, 44, 80, 48] finite. Returns its launch counts."""
    import torch

    from univid_tpu_torch.kernels import flash_attention as fa

    kwargs = dict(held["kwargs"], image=None, sampling_steps=1,
                  decode=False, timer=None)
    torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    latent = held["fusion"].generate_video_with_bagel_context(**kwargs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    got = dict(fa.LAUNCHES, **{f"flash_attention_f32 d={d}": n for d, n
                               in fa.F32_LAUNCHES_BY_D.items()},
               **{f"bf16 forward on {k}": n for k, n
                  in fa.LAUNCHES_BY_IMPL.items()})
    expected = dict(dict.fromkeys(got, 0), **{
        "flash_attention_bf16": 30, "cross_attention_bf16": 30,
        "qk_norm_rope_bf16": 30, "qk_norm_bf16": 30,
        "bf16 forward on sm90": 60})
    shape = [1, (frames - 1) // 4 + 1, 704 // 16, 1280 // 16, 48]
    rec = {"phase": "ti2v_t2v_step", "model": "ti2v-5B", "mode": "t2v",
           "resolution": f"1280x704x{frames}", "steps": 1, "decode": False,
           "seconds": seconds, "launches": got,
           "expected_launches": expected, "latent": list(latent.shape),
           "finite": bool(torch.isfinite(latent).all())}
    log(json.dumps(rec))
    if got != expected:
        fail(f"ti2v-5B t2v step launch counts {got} != {expected}")
    if rec["latent"] != shape or not rec["finite"]:
        fail(f"ti2v-5B t2v step latent {rec['latent']} (finite "
             f"{rec['finite']}), not a finite {shape}")
    return launches


# ---------------------------------------------------------------------------
# Wan2.2 A14B dual-expert serving (pipelines/moe.py)
# ---------------------------------------------------------------------------


def small_moe_parity():
    """Phase 4: WanMoEPipeline on the card (kernels) against the CPU (plain
    versions), t2v and i2v, same weights, noise, context and image: two
    2-block experts with 2 heads of d=128 (their output heads random: the
    mock DiT's zero head gives velocity 0 on both), bf16, the A14B VAE
    config (the d=384 mid-block attention) at 64x64x9, 2 UniPC steps at
    shift 5 (timesteps 999 and 833: one step on each expert)."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from univid_tpu_torch.core.config import WAN_CONFIGS, WanDiTConfig
    from univid_tpu_torch.core.dtypes import DEFAULT_POLICY
    from univid_tpu_torch.kernels import flash_attention as fa
    from univid_tpu_torch.models.wan.dit import WanDiT
    from univid_tpu_torch.models.wan.vae_api import WanVAE, vae_decode
    from univid_tpu_torch.ops.samplers import flow_sigmas
    from univid_tpu_torch.pipelines.moe import (WanMoEPipeline,
                                                expert_schedule)

    policy = dataclasses.replace(DEFAULT_POLICY, bounded_softmax=True)
    for model, in_dim in (("t2v-A14B", 16), ("i2v-A14B", 36)):
        base = WAN_CONFIGS[model]
        dit_cfg = WanDiTConfig(model_type=base.dit.model_type, in_dim=in_dim,
                               out_dim=16, dim=256, ffn_dim=512, freq_dim=32,
                               text_dim=64, num_heads=2, num_layers=2,
                               text_len=32)
        spec = dataclasses.replace(base, dit=dit_cfg)
        gen = torch.Generator().manual_seed(19)
        experts = []
        for _ in range(2):
            dit = WanDiT(dit_cfg, dtype=torch.bfloat16, device="cpu", gen=gen)
            with torch.no_grad():
                dit.head.head.w.normal_(0.0, 0.05, generator=gen)
                for blk in dit.blocks:
                    for a in (blk.self_attn, blk.cross_attn):
                        a.norm_q.uniform_(0.5, 1.5, generator=gen)
                        a.norm_k.uniform_(0.5, 1.5, generator=gen)
            experts.append(dit)
        vae = WanVAE(base.vae, dtype=torch.bfloat16, device="cpu", gen=gen)
        rng = np.random.default_rng(19)
        # 64x64x9: latent 3 x 8 x 8 -> 48 tokens (padded to 64, kv_len)
        noise = torch.as_tensor(rng.standard_normal((1, 3, 8, 8, 16)),
                                dtype=torch.float32)
        ctx = torch.as_tensor(rng.standard_normal((2, 32, 64)) * 0.5,
                              dtype=torch.float32)
        img = (torch.as_tensor(rng.uniform(-1, 1, (64, 64, 3)),
                               dtype=torch.float32)
               if model.startswith("i2v") else None)

        def run(device):
            low, high = (copy.deepcopy(d).to(device) for d in experts)
            v = copy.deepcopy(vae).to(device)
            pipe = WanMoEPipeline(spec, low, high, v, policy=policy)
            x0 = pipe.generate(
                ctx[0].to(device), ctx[1].to(device), size=(64, 64),
                frame_num=9, shift=5.0, sampling_steps=2,
                guide_scale=(3.0, 4.0), noise=noise,
                img=None if img is None else img.to(device), decode=False)
            return x0.float().cpu(), vae_decode(v, x0).float().cpu()

        fa.reset_launches()
        x_gpu, v_gpu = run("cuda")
        used = {k: n for k, n in fa.LAUNCHES.items() if n}
        x_cpu, v_cpu = run("cpu")
        is_high, _ = expert_schedule(spec, flow_sigmas(2, shift=5.0)[1],
                                     (3.0, 4.0))
        # 2 blocks x 2 steps; the d=384 VAE attention: 3 decoded latent
        # frames, and 3 encoded chunks of the i2v frames (1 + 2 x 4)
        n_f32 = 3 + (3 if img is not None else 0)
        want = {"flash_attention_bf16": 4, "cross_attention_bf16": 4,
                "qk_norm_rope_bf16": 4, "qk_norm_bf16": 4,
                "flash_attention_f32": n_f32}
        out = {"check": f"small_moe_parity {model}",
               "latent_rel_l2": rel_l2(x_gpu, x_cpu),
               "video_rel_l2": rel_l2(v_gpu, v_cpu), "limit": 3e-2,
               "why": "bf16 compute policy: cuBLAS and the CPU round each "
                      "GEMM at other points (2^-8 relative), over 2 blocks "
                      "x 2 steps, one on each expert",
               "experts_by_step": ["high" if h else "low" for h in is_high],
               "launches": used, "expected_launches": want,
               "finite": bool(torch.isfinite(v_gpu).all())}
        out["ok"] = (out["finite"] and used == want
                     and list(is_high) == [True, False]
                     and out["latent_rel_l2"] < 3e-2
                     and out["video_rel_l2"] < 3e-2)
        log(json.dumps(out))
        if not out["ok"]:
            fail(f"WanMoEPipeline {model} on the card disagrees with the CPU"
                 " or missed a kernel")


A14B_STEPS = 2       # timesteps 999 and 833 at the CLI's --shift 5: one
                     # step on each expert at both boundaries (0.875, 0.900)
A14B_FRAMES = 81
A14B_EXPERT_PARAMS = {"t2v-A14B": 14_288_491_584,   # JAX's wan_dit_manifest
                      "i2v-A14B": 14_288_901_184}


class _PhasePeaks:
    """The peak device memory of each CLI phase: PhaseTimer.phase patched to
    reset the peak at each phase's start and keep the largest peak by name
    (init_weights runs three times: UMT5, the DiTs and VAE, the fusion
    stack); dit_step runs inside denoise and is left to it. The memory
    allocated when denoise starts shows what is resident."""

    def __init__(self):
        import contextlib

        import torch

        from univid_tpu_torch.utils import profiling

        self.peaks, self.at_start = {}, {}
        self._cls = profiling.PhaseTimer
        self._orig = profiling.PhaseTimer.phase
        orig, peaks, at_start = self._orig, self.peaks, self.at_start

        @contextlib.contextmanager
        def phase(timer, name):
            if name == "dit_step":
                with orig(timer, name):
                    yield
                return
            torch.cuda.synchronize()
            at_start.setdefault(name, torch.cuda.memory_allocated() / 1e9)
            torch.cuda.reset_peak_memory_stats()
            try:
                with orig(timer, name):
                    yield
            finally:
                peaks[name] = max(peaks.get(name, 0.0),
                                  torch.cuda.max_memory_allocated() / 1e9)

        self._cls.phase = phase

    def close(self):
        self._cls.phase = self._orig


def a14b_main_path(output_dir):
    """Wan2.2 A14B serving through the port's CLI at full width and depth
    (two 40-block experts of dim 5120, random bf16 weights from seeds 0 and
    5), 832x480x81 (32,760 tokens padded to 32,768), 2 steps at the CLI's
    --shift 5 (one on each expert), each model freed before the next one
    is drawn: t2v-A14B --mode t2v --no_bagel, then i2v-A14B --mode i2v
    with a seeded 832x480 first frame and the CLI's default fusion
    context. Checks each mp4 (81 frames of 480x832), its context_path, the
    launches of each request (40 a DiT call of self- and cross-attention
    and of kernel A's two modes, all on sm90; 21 d=384 VAE calls a decode
    and 21 more for the i2v encode's 21 chunks; nothing else), both
    experts resident through the denoise, and logs the peak memory of
    each phase. Returns {model: launch counts}."""
    import gc
    import os

    import numpy as np
    import torch
    from PIL import Image

    from univid_tpu_torch.cli import inference
    from univid_tpu_torch.data.video_io import read_video_frames
    from univid_tpu_torch.kernels import flash_attention as fa

    os.makedirs(output_dir, exist_ok=True)
    png = os.path.join(output_dir, "a14b_first_frame.png")
    rng = np.random.default_rng(19)
    Image.fromarray(rng.integers(0, 256, (480, 832, 3), dtype=np.uint8)) \
        .save(png)
    steps, frames = A14B_STEPS, A14B_FRAMES
    by_path = {}
    for model, mode, extra, ctx_path in (
            ("t2v-A14B", "t2v", ["--no_bagel"], "umt5"),
            ("i2v-A14B", "i2v", ["--image", png], "bagel_fusion")):
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated() / 1e9
        fa.reset_launches()
        peaks = _PhasePeaks()
        t0 = time.perf_counter()
        try:
            meta = inference.main([
                "--model", model, "--mode", mode, "--mock_weights",
                "--video_size", "832x480", "--video_length", str(frames),
                "--steps", str(steps), "--seed", "0", "--output_dir",
                output_dir] + extra)[0]
        finally:
            peaks.close()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        f32_by_d = dict(fa.F32_LAUNCHES_BY_D)
        impl = dict(fa.LAUNCHES_BY_IMPL)
        n_f32 = 21 * (2 if mode == "i2v" else 1)
        expected = dict(dict.fromkeys(launches, 0), **{
            "flash_attention_bf16": 40 * steps,
            "cross_attention_bf16": 40 * steps,
            "qk_norm_rope_bf16": 40 * steps,
            "qk_norm_bf16": 40 * steps,
            "flash_attention_f32": n_f32})
        f32_expected = {384: n_f32, 640: 0, 1024: 0}
        impl_expected = {"sm90": 80 * steps, "causal_sm90": 0, "mma_sync": 0}
        fr = read_video_frames(meta["video_path"])
        expert_gb = 2 * 2 * A14B_EXPERT_PARAMS[model] / 1e9   # two, bf16
        resident = peaks.at_start.get("denoise", 0.0)
        gc.collect()
        torch.cuda.empty_cache()
        after = torch.cuda.memory_allocated() / 1e9
        rec = {"phase": "a14b_main_path", "model": model, "mode": mode,
               "resolution": f"832x480x{frames}", "steps": steps,
               "seconds": wall, "generation_time_s": meta["generation_time_s"],
               "phase_times_s": meta["phase_times_s"],
               "peak_memory_gb_by_phase": peaks.peaks,
               "allocated_gb_at_phase_start": peaks.at_start,
               "experts_gb": expert_gb,
               "allocated_gb_before": before, "allocated_gb_after": after,
               "launches": launches, "expected_launches": expected,
               "f32_launches_by_d": f32_by_d, "launches_by_impl": impl,
               "frames": len(fr),
               "frame_shape": list(fr[0].shape) if fr else None,
               "context_path": meta["context_path"]}
        log(json.dumps(rec))
        if (launches != expected or f32_by_d != f32_expected
                or impl != impl_expected):
            fail(f"{model} launch counts {launches} {f32_by_d} {impl} != "
                 f"{expected} {f32_expected} {impl_expected}")
        if len(fr) != frames or fr[0].shape != (480, 832, 3) \
                or meta["context_path"] != ctx_path:
            fail(f"{model}: not {frames} frames of 480x832 from the "
                 f"{ctx_path} context")
        if resident < expert_gb:
            fail(f"{model}: {resident:.2f} GB allocated at the denoise's "
                 f"start, less than both experts' {expert_gb:.2f} GB")
        if max(peaks.peaks.values()) >= 80.0 or after > before + 1.0:
            fail(f"{model}: peak {peaks.peaks} GB, or {after - before:.2f} "
                 "GB left allocated after the request")
        by_path[model] = launches
    return by_path


def a14b_dit_calls():
    """Both t2v-A14B experts resident (random bf16 weights from seeds 0 and
    5, 57.15 GB), nothing else: one high-noise DiT call at 832x480x81
    profiled (batch-2 CFG, 32,760 tokens padded to 32,768, a [2, 512,
    4096] context: device time by kernel family), then one bare call at the
    published default size, 1280x720x81 (21 x 45 x 80 = 75,600 tokens
    padded to 75,776), timed to a synchronised end with its peak memory
    and launches (40 of each of the four kernels); both outputs finite and
    of the latent's shape."""
    import dataclasses
    import gc

    import torch

    from univid_tpu_torch.core.config import WAN_CONFIGS
    from univid_tpu_torch.core.dtypes import DEFAULT_POLICY
    from univid_tpu_torch.kernels import flash_attention as fa
    from univid_tpu_torch.models.wan.dit import WanDiT, wan_dit_forward
    from univid_tpu_torch.ops.rope import build_rope_3d

    gc.collect()
    torch.cuda.empty_cache()
    cfg = WAN_CONFIGS["t2v-A14B"].dit
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    low, high = (WanDiT(cfg, dtype=torch.bfloat16, device=dev,
                        gen=torch.Generator(device=dev).manual_seed(s))
                 for s in (0, 5))
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated() / 1e9
    policy = dataclasses.replace(DEFAULT_POLICY, bounded_softmax=True)
    gen = torch.Generator(device=dev).manual_seed(20)
    ctx = torch.randn((2, cfg.text_len, cfg.text_dim), generator=gen,
                      device=dev) * 0.5
    t = torch.full((2,), 999.0, device=dev)
    want = {nm: cfg.num_layers for nm in A14B_KERNELS}
    # the 720p call's FFN runs over token chunks (dit.FFN_CHUNK_ELEMS):
    # one block's FFN over the chunks against the whole FFN, bit for bit
    from univid_tpu_torch.models.wan import dit as dit_mod
    y = torch.randn((2, 75776, cfg.dim), generator=gen, device=dev).to(
        torch.bfloat16)
    step = dit_mod.FFN_CHUNK_ELEMS // (2 * cfg.ffn_dim)
    with torch.no_grad():
        whole = dit_mod._ffn(high.blocks[0], y, torch.bfloat16)
        parts = torch.cat([dit_mod._ffn(high.blocks[0], y[:, i:i + step],
                                        torch.bfloat16)
                           for i in range(0, y.shape[1], step)], dim=1)
    equal = bool(torch.equal(whole, parts))
    log(json.dumps({"check": "t2v-A14B FFN over token chunks vs whole, "
                             "[2, 75776, 5120]", "chunk_tokens": step,
                    "equal_bits": equal,
                    "max_abs_diff": float((whole.float() - parts.float())
                                          .abs().max()), "ok": equal}))
    if not equal:
        fail("t2v-A14B: the FFN over token chunks is not bit-equal to the "
             "whole FFN at [2, 75776, 5120] (models/wan/dit.py "
             "FFN_CHUNK_ELEMS)")
    del y, whole, parts
    torch.cuda.empty_cache()
    for tag, latent, pad in (("480p", (21, 60, 104), 32768),
                             ("720p", (21, 90, 160), 75776)):
        grid = (latent[0], latent[1] // 2, latent[2] // 2)
        x = torch.randn((1,) + latent + (cfg.in_dim,), generator=gen,
                        device=dev).expand(2, *latent, cfg.in_dim)
        cos, sin = build_rope_3d(cfg.head_dim, grid, device=dev)

        def fwd():
            with torch.no_grad():
                return wan_dit_forward(high, x, t, ctx, cos, sin,
                                       seq_pad_to=pad, policy=policy,
                                       fused_rope=True)

        fa.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if tag == "480p":
            out, prof = profile_call(fwd, families={
                "qk_prepass_ms": ("qk_norm_rope",),
                "attention_ms": ("flash_fwd_sm90",)})
        else:
            out, prof = fwd(), None
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {nm: fa.LAUNCHES[nm] for nm in want}
        rec = {"phase": f"a14b_{tag}_dit_call", "model": "t2v-A14B",
               "tokens": grid[0] * grid[1] * grid[2], "padded_to": pad,
               "seconds": secs, "profiled": prof is not None,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "experts_resident_gb": resident, "experts_draw_s": draw_s,
               "launches": got,
               "finite": bool(torch.isfinite(out).all()),
               "shape": list(out.shape)}
        if prof is not None:
            rec["profile"] = prof
        log(json.dumps(rec))
        if (got != want or not rec["finite"]
                or rec["shape"] != [2, *latent, cfg.out_dim]):
            fail(f"t2v-A14B {tag} DiT call: launches {got} != {want}, or "
                 "its output is not finite or not the latent's shape")
        del out, x, cos, sin
    del low, high
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# BAGEL-7B-MoT video QA (Pyramid Reflection)
# ---------------------------------------------------------------------------

BAGEL_CAPACITY = 20480   # 16 frames x 1,198 rows + the question; the JAX
                         # inferencer's default of 4,096 holds ~3 frames
QA_QUESTION = ("Looking carefully at the whole video from its first frame to "
               "its last frame, what is the main object that moves across "
               "the scene, in which direction does it travel, what color is "
               "it, and what happens to it near the end of the clip?")
FRAME_ROWS = 1198        # a 644x364 frame: 46 x 26 patches + start and end


def _causal_case(gen, b, lq, lk, n, nk, offsets, n_new, mark_new=True):
    """Inputs of one prefill over a cache: q [b, lq, n, 128] (qk-normed,
    folded as the wrapper folds it), a cache k, v [b, lk, nk, 128] in which
    every slot at or past kv_len = offsets + n_new holds 50.0. With
    mark_new, the appended rows offsets[r] .. kv_len[r] (past the diagonal
    for the earlier queries) get k = 50 and v a ramp 50, 58, 66, ...: a
    row that sees them averages the ramp, and a key let past its diagonal
    moves that mean by 4."""
    import torch

    from univid_tpu_torch.kernels import flash_attention as fa

    d = 128
    q = fa._fold(qk_normed((b, lq, n, d), gen, torch.bfloat16), d ** -0.5)
    k = qk_normed((b, lk, nk, d), gen, torch.bfloat16)
    v = torch.randn((b, lk, nk, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    ramp = (50.0 + 8.0 * torch.arange(n_new, device="cuda")).to(
        torch.bfloat16)[:, None, None]
    for r, off in enumerate(offsets):
        if mark_new:
            k[r, off:off + n_new] = 50.0
            v[r, off:off + n_new] = ramp
        k[r, off + n_new:] = 50.0
        v[r, off + n_new:] = 50.0
    qo = torch.tensor(offsets, dtype=torch.int32, device="cuda")
    return q, k, v, qo, qo + n_new


def _causal_work(lq, offsets, kv_len, n, d=128):
    """Live (row, key) pairs of a causal prefill -> flops (q k^T and p v)."""
    pairs = sum(min(i + off + 1, kl) for off, kl in zip(offsets, kv_len)
                for i in range(lq))
    return 4 * pairs * n * d


def check_causal_kernels():
    """The causal kernel mode (flash_attention_causal_sm90.cu) against its
    plain version at the BAGEL path's shapes: the 16-frame QA's question
    prefill (q [1, 64, 28, 128] over the 20,480-row cache, 4 kv heads,
    q_offsets 19,168: the split-kv pass), a batch of 16 rows at different
    offsets over a 2,624-row cache (the batched captioning's shape) and a
    square 2,048-token prefill at offset 0 (the largest text bucket); each
    timed in turns with the mma.sync kernel it replaced (`sm90_vs_mma_sync`
    lines), beside its bound, its plain version and SDPA with the same
    boolean mask on the repeated kv heads, its split count and packing
    logged; rows with no live key (kv_len = 0, rows before key 0) exactly 0
    with lse +1e30 at the prefill's shape; then the running-max mode at the
    ViT append's shape ([1, 2112, 28, 128] over the cache, group 7).
    Returns the flash_attention_bf16_causal record (question shape)."""
    import torch
    import torch.nn.functional as F

    from univid_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(7)
    n, nk, d = 28, 4, 128
    n_q = len(QA_QUESTION.split()) + 2   # bos + words + eos
    tol = dict(atol=1e-3, rtol=2.0 ** -7,
               why="one bf16 ulp of the output (at most 2^-7 relative) "
                   "plus 1e-3 for the fp32 summation order and the "
                   "approximate exp2 before p rounds to bf16")
    cases = (("question_prefill", 1, 64, BAGEL_CAPACITY,
              [16 * FRAME_ROWS], n_q, True),
             ("batched_b16", 16, 64, 2624,
              [FRAME_ROWS + 37 * r for r in range(16)], 40, True),
             ("square_2048", 1, 2048, 2048, [0], 2000, False))
    record = None
    for tag, b, lq, lk, offs, n_new, mark in cases:
        q, k, v, qo, kv = _causal_case(gen, b, lq, lk, n, nk, offs, n_new,
                                       mark)
        kv_host = [o + n_new for o in offs]

        def run():
            return fa._flash_cuda(q, k, v, kv, None, None, causal=True,
                                  q_offsets=qo)

        group = n // nk
        splits = fa.causal_splits(b, n, group, lq, lk)
        pairs = fa.causal_pairs(group, lq)
        log(json.dumps({"check": f"causal kernel plan {tag}",
                        "splits": splits, "slots_per_kv_head":
                        group * lq // fa.CAUSAL_SLOT,
                        "blocks": b * nk * pairs * splits,
                        "cache_reads_per_kv_head": pairs,
                        "packing": "two 64-row slots a block, slot = "
                                   "(position // 64) * group + head"}))
        with torch.no_grad():
            got = run()
            want = fa.attention_plain(q, k, v, kv_len=kv, causal=True,
                                      q_offsets=qo)
            err = compare(f"flash_attention_bf16_causal {tag}", got, want,
                          **tol)
            old = fa._launch_bf16(q, k, v, kv, None, fa._MODE_RUNNING,
                                  causal=True, q_offsets=qo)
            compare(f"flash_attention_bf16_causal mma.sync {tag}", old,
                    want, **tol)
            ms, old_ms = ab_time(run, lambda: fa._launch_bf16(
                q, k, v, kv, None, fa._MODE_RUNNING, causal=True,
                q_offsets=qo), 10)
            log_ab(f"causal {tag}", ms, old_ms)
            # the kernels' device time a call (main kernel and, split, the
            # merge): the wrapper's time above also holds the host's work.
            # The profiler sometimes records no kernel: up to three tries,
            # else None (not measured)
            device_ms = None
            for _ in range(3):
                _, prof = profile_call(lambda: [run() for _ in range(5)])
                rows = [t_ for t_ in prof["top_kernels"]
                        if "causal" in t_["kernel"]]
                log(json.dumps({f"causal_kernels {tag}": [
                    (t_["kernel"][:60], t_["ms"] / t_["count"], t_["count"])
                    for t_ in rows]}))
                if rows:
                    device_ms = sum(t_["ms"] / t_["count"] for t_ in rows)
                    break
            plain_ms = cuda_time(lambda: fa.attention_plain(
                q, k, v, kv_len=kv, causal=True, q_offsets=qo), 1)
            rows = fa.causal_rows(lq, 0, qo, q.device)
            cols = torch.arange(lk, device="cuda")
            mask = ((cols[None, None, :] <= rows[:, :, None])
                    & (cols[None, None, :] < kv[:, None, None]))[:, None]
            qs, ks, vs = (x.transpose(1, 2) for x in (
                q, fa.repeat_kv(k, n), fa.repeat_kv(v, n)))
            lib_ms = cuda_time(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, scale=1.0 / fa.LOG2E), 3)
        live_kv = sum(kv_host) * nk * d * 2 * 2   # k and v up to kv_len
        bms, by = bound_ms(_causal_work(lq, offs, kv_host, n),
                           nbytes(q, got) + live_kv, H100_BF16_FLOPS)
        rec = dict(name="flash_attention_bf16_causal", route="cuda",
                   source="univid_tpu_torch/kernels/csrc/"
                          "flash_attention_causal_sm90.cu",
                   replaces="univid_tpu/kernels/flash_attention.py:44",
                   max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                   bound_by=by, library_ms=lib_ms, mma_sync_ms=old_ms,
                   device_ms=device_ms, splits=splits,
                   shape={"q": list(q.shape), "kv": list(k.shape),
                          "q_offsets": offs[:2], "kv_len": kv_host[:2]})
        if record is None:
            record = {k_: v_ for k_, v_ in rec.items()
                      if k_ not in ("shape", "splits")}
            log(json.dumps({"kernel": record}))
        log(json.dumps({f"kernel_at_{tag}": rec}))
        del q, k, v, got, want, old, qs, ks, vs, mask
        torch.cuda.empty_cache()

    # rows with no live key at the prefill's shape, B = 3 (2 splits): a
    # batch row at q_offsets -32 (its first 32 rows precede key 0) and one
    # with kv_len = 0; with the lse
    q, k, v, qo, kv = _causal_case(gen, 3, 64, BAGEL_CAPACITY, n, nk,
                                   [16 * FRAME_ROWS, -32, 100], n_q, False)
    kv = torch.tensor([16 * FRAME_ROWS + n_q, BAGEL_CAPACITY, 0],
                      dtype=torch.int32, device="cuda")
    with torch.no_grad():
        lse = torch.empty((3, n, 64), device="cuda")
        o = fa._launch_causal_sm90(q, k, v, kv, 0, qo, lse=lse)
        o_p, lse_p = fa.attention_plain(q, k, v, kv_len=kv, causal=True,
                                        q_offsets=qo, save_residuals=True)
    compare("flash_attention_bf16_lse_causal empty rows, output", o, o_p,
            **tol)
    compare("flash_attention_bf16_lse_causal empty rows, lse", lse, lse_p,
            atol=1e-3, rtol=0.0, why="fp32 log2 of an fp32 row sum; "
                                      "summation order and the approximate "
                                      "exp2")
    empty = {"splits": fa.causal_splits(3, n, n // nk, 64, BAGEL_CAPACITY),
             "rows_before_key_0_zero": float(o[1, :32].abs().max()) == 0.0
             and bool((lse[1, :, :32] == 1e30).all()),
             "kv_len_0_row_zero": float(o[2].abs().max()) == 0.0
             and bool((lse[2] == 1e30).all())}
    empty["ok"] = empty["rows_before_key_0_zero"] and empty[
        "kv_len_0_row_zero"]
    log(json.dumps({"check": "causal kernel rows with no live key",
                    **empty}))
    if not empty["ok"]:
        fail("causal kernel: rows with no live key are not 0 with lse +1e30")
    del q, k, v, o, lse, o_p, lse_p
    torch.cuda.empty_cache()

    # the ViT append of the 16th frame: 2,050 rows padded to 2,112 over
    # the cache, non-causal, kv_len 19,168, 28 query heads over 4 kv heads
    q, k, v, _, kv = _causal_case(gen, 1, 2112, BAGEL_CAPACITY, n, nk,
                                  [15 * FRAME_ROWS], FRAME_ROWS, False)
    with torch.no_grad():
        got = fa._flash_cuda(q, k, v, kv, None, None)
        want = fa.attention_plain(q, k, v, kv_len=kv)
        err = compare("flash_attention_bf16 ViT append group 7", got, want,
                      **tol)
        ms, old_ms = ab_time(
            lambda: fa._flash_cuda(q, k, v, kv, None, None),
            lambda: fa._launch_bf16(q, k, v, kv, None, fa._MODE_RUNNING), 10)
        log_ab("ViT append group 7", ms, old_ms)
        plain_ms = cuda_time(lambda: fa.attention_plain(q, k, v, kv_len=kv),
                             1)
        kvl = 16 * FRAME_ROWS
        qs, ks, vs = (x.transpose(1, 2) for x in (
            q, fa.repeat_kv(k[:, :kvl], n), fa.repeat_kv(v[:, :kvl], n)))
        lib_ms = cuda_time(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, scale=1.0 / fa.LOG2E), 3)
    bms, by = bound_ms(4 * 2112 * kvl * n * d,
                       nbytes(q, got) + kvl * nk * d * 2 * 2, H100_BF16_FLOPS)
    log(json.dumps({"kernel_at_bagel_vit_append": dict(
        name="flash_attention_bf16", route="cuda",
        source="univid_tpu_torch/kernels/csrc/flash_attention_sm90.cu",
        replaces="univid_tpu/kernels/flash_attention.py:44", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        library_ms=lib_ms, mma_sync_ms=old_ms, shape={"q": list(q.shape), "kv": list(k.shape),
                                  "kv_len": kvl})}))
    del q, k, v, got, want, qs, ks, vs
    torch.cuda.empty_cache()
    return {"flash_attention_bf16_causal": record}


def small_bagel_parity():
    """A small d=128 BAGEL (hidden 512, 4 heads over 2 kv heads, 2 layers)
    and a tiny SigLIP in bf16: video_understanding's context (3 frames,
    then the question) built on the card (kernels) and on the CPU (plain
    versions), same weights; the KV caches compared, then the logits under
    teacher forcing on the CPU's greedy tokens."""
    import copy

    import numpy as np
    import torch

    from univid_tpu_torch.kernels import flash_attention as fa
    from univid_tpu_torch.models.bagel.bagel import (BagelConfig,
                                                     generate_text,
                                                     init_bagel)
    from univid_tpu_torch.models.bagel.qwen2_mot import (Qwen2MoTConfig,
                                                         lm_head_logits,
                                                         qwen2_mot_forward)
    from univid_tpu_torch.models.bagel.siglip import (SiglipConfig,
                                                      init_siglip)
    from univid_tpu_torch.pipelines.interleave import InterleaveInferencer
    from univid_tpu_torch.utils.tokenizers import HashTokenizer

    bf = torch.bfloat16
    llm = Qwen2MoTConfig(vocab_size=4096, hidden_size=512,
                         intermediate_size=1024, num_layers=2, num_heads=4,
                         num_kv_heads=2)
    cfg = BagelConfig(llm=llm, vit_hidden_size=64, start_of_image=4090,
                      end_of_image=4091, bos_token_id=4092,
                      eos_token_id=4093)
    scfg = SiglipConfig(hidden_size=64, intermediate_size=128, num_layers=2,
                        num_heads=2, patch_size=14, image_size=224)
    gen = torch.Generator().manual_seed(30)
    bagel = init_bagel(gen, cfg, dtype=bf, device="cpu")
    sig = init_siglip(gen, scfg, dtype=bf, device="cpu")
    with torch.no_grad():   # non-unit qk norms move the scores
        for layer in bagel.llm.layers:
            layer.attn.q_norm.uniform_(0.5, 1.5, generator=gen)
            layer.attn.k_norm.uniform_(0.5, 1.5, generator=gen)
    rng = np.random.default_rng(3)
    frames = [rng.uniform(-1, 1, (112, 112 + 28 * i, 3)).astype(np.float32)
              for i in range(3)]
    n_tok = 8

    def context(device):
        inf = InterleaveInferencer(
            copy.deepcopy(bagel).to(device), cfg, HashTokenizer(4090),
            siglip=copy.deepcopy(sig).to(device), siglip_cfg=scfg,
            capacity=1024, compute_dtype=bf)
        ctx = inf.init_gen_context()
        for f in frames:
            ctx = inf.update_context_image(f, ctx)
        return inf, inf.update_context_text(QA_QUESTION, ctx)

    def forced_logits(inf, ctx, tokens):
        """Decode steps fed [bos] + tokens[:-1] -> logits [n_tok, vocab]."""
        out, cache, rope = [], ctx["cache"], ctx["rope"]
        prev = [cfg.bos_token_id] + tokens[:-1]
        with torch.no_grad():
            for t in prev:
                x = inf.params.llm.embed_tokens[
                    torch.tensor([[t]], device=rope.device)].to(bf)
                h, cache = qwen2_mot_forward(inf.params.llm, llm, x,
                                             rope[:, None], cache,
                                             compute_dtype=bf)
                out.append(lm_head_logits(inf.params.llm, llm, h,
                                          compute_dtype=bf)[0, 0].cpu())
                rope = rope + 1
        return torch.stack(out)

    fa.reset_launches()
    inf_g, ctx_g = context("cuda")
    used = {k: v for k, v in fa.LAUNCHES.items() if v}
    inf_c, ctx_c = context("cpu")
    n_live = ctx_c["cache"]["len_host"][0]
    cache_err = {kv: rel_l2(ctx_g["cache"][kv][:, :, :n_live].cpu(),
                            ctx_c["cache"][kv][:, :, :n_live])
                 for kv in ("k", "v")}
    if ctx_g["cache"]["len_host"] != ctx_c["cache"]["len_host"]:
        fail("small BAGEL parity: cache lengths differ")
    with torch.no_grad():
        toks, _ = generate_text(inf_c.params, cfg, copy.deepcopy(ctx_c),
                                n_tok, compute_dtype=bf)
    tokens = [int(t) for t in toks[0]]
    logit_err = rel_l2(forced_logits(inf_g, ctx_g, tokens),
                       forced_logits(inf_c, ctx_c, tokens))
    out = {"check": "small_bagel_parity", "cache_rel_l2": cache_err,
           "logits_rel_l2": logit_err, "limit": 3e-2, "rows": n_live,
           "tokens": tokens,
           "why": "bf16 on both sides: cuBLAS and the CPU round each GEMM "
                  "at other points (2^-8 relative), over 2 layers",
           "launches": used}
    out["ok"] = (max(cache_err.values()) < 3e-2 and logit_err < 3e-2
                 and used.get("flash_attention_bf16") == 3 * 2
                 and used.get("flash_attention_bf16_causal") == 2
                 and set(used) == {"flash_attention_bf16",
                                   "flash_attention_bf16_causal"})
    log(json.dumps(out))
    if not out["ok"]:
        fail("the BAGEL path on the card disagrees with the CPU, or went "
             "through other kernels")


def _qa_video(path, n_frames=64):
    """A seeded 640x360 uint8 video with smooth content (blocky colour
    fields drifting right), written with the port's save_video."""
    import numpy as np

    from univid_tpu_torch.data.video_io import save_video

    return save_video(np.stack(_qa_frames(n_frames)), path, fps=8)


# depth cut for chip_smoke.py's time limit: 7 of BAGEL-7B-MoT's 28 LLM
# layers at full width in the QA request (its decode is host-bound, ~2,300
# eager kernels a token at 28; at 14 the request took 87.5-118.5 s)
BAGEL_QA_LAYERS = 7
# greedy tokens a decode of the QA request, cut from ReflexionConfig's 512
# for the time limit (the fp32 BAGEL phase's room): the four decodes took
# ~34 s of the request's 38.6 on an H100 at 512
BAGEL_QA_TOKENS = 256


def bagel_main_path(output_dir):
    """The video-QA path at full width: BAGEL-7B-MoT (bf16, both experts,
    BAGEL_QA_LAYERS of its 28 layers, random from seeds) with the SigLIP
    so400m tower, the default
    Siglip2Scorer and the offline judge and reflector; reflexion_answer_one
    with ReflexionConfig() on a 64-frame pool of 640x360 frames: 16 seed
    captions as one batch, static rounds K = 4, 8, 16, the fallback;
    BAGEL_QA_TOKENS greedy tokens per decode. The inferencer's cache holds 20,480 rows.
    Checks the trace, the launches of each phase, and logs the seconds of
    each phase and the peak memory; then times the question's prefill
    over the largest QA call's context with the causal kernel and with the
    mma.sync kernel in turns (`_prefill_vs_mma_sync`) and profiles 16
    decode steps after it. Returns
    the reflexion run's launch counts."""
    import dataclasses
    import gc
    import os

    import numpy as np
    import torch

    from univid_tpu_torch.kernels import flash_attention as fa
    from univid_tpu_torch.models.bagel.bagel import (BagelConfig,
                                                     generate_text,
                                                     init_bagel)
    from univid_tpu_torch.models.bagel.qwen2_mot import Qwen2MoTConfig
    from univid_tpu_torch.models.bagel.siglip import (SiglipConfig,
                                                      init_siglip)
    from univid_tpu_torch.pipelines.interleave import InterleaveInferencer
    from univid_tpu_torch.reflection.clients import make_reflection_clients
    from univid_tpu_torch.reflection.reflexion import (ReflexionConfig,
                                                       reflexion_answer_one)
    from univid_tpu_torch.reflection.scorer import Siglip2Scorer
    from univid_tpu_torch.utils.tokenizers import HashTokenizer

    gc.collect()
    torch.cuda.empty_cache()
    os.makedirs(output_dir, exist_ok=True)
    video = _qa_video(os.path.join(output_dir, "qa", "video1.mp4"))
    bf = torch.bfloat16
    cfg = BagelConfig(llm=dataclasses.replace(Qwen2MoTConfig(),
                                              num_layers=BAGEL_QA_LAYERS))
    scfg = SiglipConfig()

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bagel = init_bagel(gen(40), cfg, dtype=bf, device="cuda")
    sig = init_siglip(gen(41), scfg, dtype=bf, device="cuda")
    tok = HashTokenizer()
    scorer = Siglip2Scorer(tokenizer=tok, device="cuda")
    n_params = sum(p.numel() for p in bagel.parameters())
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = torch.cuda.memory_allocated() / 1e9

    phases = []   # one record per timed call, in order

    class Timed(InterleaveInferencer):
        """Each context update, decode and captioning call timed to a
        synchronised end, with the kernels' launches in it."""

        def _timed(self, kind, fn, *a, **kw):
            torch.cuda.synchronize()
            before = dict(fa.LAUNCHES)
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            phases.append({"kind": kind, "s": time.perf_counter() - t,
                           "launches": {k: fa.LAUNCHES[k] - before[k]
                                        for k in before
                                        if fa.LAUNCHES[k] - before[k]}})
            return out

        def vit_features(self, *a):
            return self._timed("siglip", super().vit_features, *a)

        def vit_append(self, *a):
            return self._timed("vit_append", super().vit_append, *a)

        def update_context_text(self, *a):
            return self._timed("text_prefill", super().update_context_text,
                               *a)

        def gen_text(self, *a, **kw):
            return self._timed("decode", super().gen_text, *a, **kw)

        def caption_frames(self, *a, **kw):
            phases.append({"kind": "captioning_start"})
            return self._timed("captioning", super().caption_frames, *a,
                               **kw)

    inf = Timed(bagel, cfg, tok, siglip=sig, siglip_cfg=scfg,
                capacity=BAGEL_CAPACITY, compute_dtype=bf)
    refl, judge = make_reflection_clients("")
    rcfg = dataclasses.replace(ReflexionConfig(),
                               max_think_token_n=BAGEL_QA_TOKENS)
    fa.reset_launches()
    t0 = time.perf_counter()
    answer, trace = reflexion_answer_one(video, QA_QUESTION, inf, refl, judge,
                                         scorer, rcfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9

    # group the timed calls: the captioning call (its inner ViT appends
    # are part of it), then one QA call per decode
    caption = [p for p in phases if p["kind"] == "captioning"]
    qa, cur = [], None
    seen_caption = False
    for p in phases:
        if p["kind"] == "captioning_start":
            seen_caption = True
            continue
        if p["kind"] == "captioning":
            seen_caption = False
            continue
        if seen_caption:
            continue
        if cur is None:
            cur = {"siglip_s": 0.0, "vit_append_s": 0.0,
                   "text_prefill_s": 0.0, "decode_s": 0.0, "frames": 0,
                   "launches": {}}
        cur[f"{p['kind']}_s"] += p["s"]
        cur["frames"] += p["kind"] == "vit_append"
        for k, n in p["launches"].items():
            cur["launches"][k] = cur["launches"].get(k, 0) + n
        if p["kind"] == "decode":
            cur["ms_per_token"] = p["s"] / rcfg.max_think_token_n * 1e3
            qa.append(cur)
            cur = None
    n_layers = cfg.llm.num_layers
    want_caption = {"flash_attention_bf16": n_layers}
    rounds = [r["K"] for r in trace["rounds"]]
    out = {"phase": "bagel_main_path", "model": "BAGEL-7B-MoT",
           "params": n_params, "weights_gb": weights_gb, "init_s": init_s,
           "capacity": BAGEL_CAPACITY, "question_tokens":
           len(QA_QUESTION.split()) + 2, "seconds": wall,
           "captioning": {"frames": rcfg.caption_seed_frames,
                          "s": caption[0]["s"] if caption else None,
                          "ms_per_step": (caption[0]["s"]
                                          / rcfg.max_think_token_n * 1e3
                                          if caption else None),
                          "launches": caption[0]["launches"]
                          if caption else None,
                          "expected_launches": want_caption},
           "qa_calls": qa, "rounds": rounds,
           # the scorer (64 pool frames, 3 queries), video decode, host
           "other_s": wall - sum(p["s"] for p in caption)
           - sum(c[f"{k}_s"] for c in qa for k in (
               "siglip", "vit_append", "text_prefill", "decode")),
           "final_answer_chars": len(answer or ""),
           "peak_memory_gb": peak, "launches": launches}
    log(json.dumps(out))
    if not caption or caption[0]["launches"] != want_caption:
        fail(f"captioning launches {caption} != {want_caption} (the 21-row "
             "prompt takes the decode-shaped einsums, as in JAX)")
    if rounds != [4, 8, 16] or len(qa) != 3:
        fail(f"reflexion rounds {rounds}, {len(qa)} QA calls")
    for call, k in zip(qa, rounds):
        want = {"flash_attention_bf16": n_layers * k,
                "flash_attention_bf16_causal": n_layers}
        if call["launches"] != want or call["frames"] != k:
            fail(f"QA call on {k} frames: launches {call['launches']} != "
                 f"{want}")
    # the ViT appends (captioning and QA) on the sm90 kernel, the causal
    # question prefills on the causal sm90 kernel, none on the mma.sync one
    check_impl("BAGEL QA request", n_layers * (1 + sum(rounds)),
               causal_sm90=n_layers * len(qa))
    log(json.dumps({"check": "BAGEL QA text prefill seconds",
                    "text_prefill_s": [c["text_prefill_s"] for c in qa],
                    "causal_launches_per_call": n_layers}))
    keys = {"video", "question", "qtype_init", "global_caption", "rounds",
            "fallback", "qtype_final", "final_answer"}
    if not keys <= set(trace) or not trace["final_answer"]:
        fail(f"reflexion trace keys {sorted(trace)} or an empty answer")
    if peak >= 80.0:
        fail(f"BAGEL peak memory {peak:.1f} GB")

    # 16 decode steps under the profiler over the largest QA call's cache
    # (one frame's features appended K = 16 times, then the question): is
    # a token bound by the card or by the host's launches?
    base = InterleaveInferencer(bagel, cfg, tok, siglip=sig, siglip_cfg=scfg,
                                capacity=BAGEL_CAPACITY, compute_dtype=bf)
    n_tok = 16
    with torch.no_grad():
        patches, pos, segs, n = base._prep_image_bucketed(
            np.zeros((360, 640, 3), np.float32))
        feats = base.vit_features(patches, pos, segs)
        ctx = base.init_gen_context()
        for _ in range(rcfg.static_seq[-1]):
            ctx = base.vit_append(ctx, feats[None], pos[None], n)
        ctx = _prefill_vs_mma_sync(base, ctx)
        rows = ctx["cache"]["len_host"][0]
        _, prof = profile_call(lambda: generate_text(
            bagel, cfg, ctx, n_tok, compute_dtype=bf))
    log(json.dumps({"check": "bagel_decode_profile", "tokens": n_tok,
                    "cache_rows": rows,
                    "per_token": {k: v / n_tok for k, v in prof.items()
                                  if k not in ("idle_share_upper_bound",
                                               "top_kernels")},
                    "top_kernels_per_token": [
                        dict(r, ms=r["ms"] / n_tok, count=r["count"] / n_tok)
                        for r in prof["top_kernels"]],
                    "idle_share_upper_bound":
                    prof["idle_share_upper_bound"]}))
    del inf, base, ctx, bagel, sig, scorer
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _prefill_vs_mma_sync(inf, ctx):
    """The question's text prefill over a context (the largest QA call's:
    16 appended frames, 19,168 rows), whole and timed to a synchronised
    end, with its causal attention calls (one a layer) on the causal sm90
    kernel and, in turns, on the mma.sync kernel it replaced (old, new,
    new, old, twice). Each run starts from the same context: the prefill
    writes the same cache rows past its length, and the length moves in a
    copy. Returns the context after one prefill."""
    import torch

    from univid_tpu_torch.kernels import flash_attention as fa

    def prefill():
        c = {"cache": dict(ctx["cache"]), "rope": ctx["rope"]}
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inf.update_context_text(QA_QUESTION, c)
        torch.cuda.synchronize()
        return time.perf_counter() - t, out

    def mma_sync(q, k, v, kv_len, q_offset=0, q_offsets=None, lse=None):
        return fa._launch_bf16(q, k, v, kv_len, None, fa._MODE_RUNNING,
                               lse=lse, causal=True, q_offset=q_offset,
                               q_offsets=q_offsets)

    route = fa._launch_causal_sm90
    seconds = {"causal_sm90": [], "mma_sync": []}
    prefill()   # warm-up
    try:
        for impl in ("mma_sync", "causal_sm90", "causal_sm90",
                     "mma_sync") * 2:
            fa._launch_causal_sm90 = mma_sync if impl == "mma_sync" \
                else route
            seconds[impl].append(prefill()[0])
    finally:
        fa._launch_causal_sm90 = route
    log(json.dumps({"check": "question prefill, causal kernel vs mma.sync",
                    "cache_rows": ctx["cache"]["len_host"][0],
                    "text_prefill_s": seconds,
                    "median_s": {k_: statistics.median(v_)
                                 for k_, v_ in seconds.items()}}))
    return prefill()[1]


def qa_cli_on_card(output_dir):
    """The port's eval_understanding CLI once on the card with
    --mock_weights on a small seeded video (its head-dim-16 BAGEL takes the
    reference attention route)."""
    import os

    import numpy as np

    from univid_tpu_torch.cli import eval_understanding
    from univid_tpu_torch.data.video_io import save_video

    vdir = os.path.join(output_dir, "qa_cli")
    frames = np.random.default_rng(12).integers(0, 256, (16, 96, 128, 3),
                                                dtype=np.uint8)
    save_video(frames, os.path.join(vdir, "video1.mp4"), fps=8)
    with open(os.path.join(vdir, "gt.json"), "w") as f:
        json.dump([{"video_id": 1, "question": "what moves?",
                    "answer": "a ball"}], f)
    t0 = time.perf_counter()
    summary = eval_understanding.main([
        "--video_dir", vdir, "--gt_file", os.path.join(vdir, "gt.json"),
        "--output_dir", os.path.join(vdir, "out"), "--output_name",
        "batch1", "--id_from", "1", "--id_to", "1", "--mock_weights",
        "--pool_frames", "16", "--max_think_token_n", "16",
        "--save_frames_root", "", "--deepseek_api_key", ""])
    with open(os.path.join(vdir, "out", "video1_reflexion.json")) as f:
        trace = json.load(f)
    out = {"check": "qa_cli_on_card", "seconds": time.perf_counter() - t0,
           "num_samples": summary["num_samples"],
           "rounds": [r["K"] for r in trace["rounds"]],
           "final_answer": trace["final_answer"]}
    out["ok"] = out["num_samples"] == 1 and out["rounds"] == [4, 8, 16]
    log(json.dumps(out))
    if not out["ok"]:
        fail("the eval_understanding CLI on the card")


# ---------------------------------------------------------------------------
# BAGEL image generation (the eighteenth slice)
# ---------------------------------------------------------------------------

IMAGE_CAPACITY = 16384   # a 1024x1024 editing context (4,098 VAE rows,
                         # 4,902 ViT rows, the instruction) + a 4,098-row
                         # flow pass; the JAX inferencer's default of 4,096
                         # holds no 1024x1024 latent
T2I_TIMESTEPS = 50       # JAX's default
EDIT_TIMESTEPS = 8       # cut for the time limit
IMAGE_PROMPT = ("A red fox sitting in fresh snow at the edge of a pine "
                "forest at dawn, soft golden light on its fur, mist drifting "
                "between the dark trees, a frozen stream in the foreground, "
                "photographed with a long lens and a shallow depth of field")
IMAGE_EDIT = ("Change the season of this photograph from winter to late "
              "summer: replace the snow with tall green grass and small "
              "yellow flowers, keep the animal and its pose exactly as they "
              "are, and make the light warmer, as in the early evening")
AE_SEED = 181            # the synthetic ae.safetensors' draws


def flux_ae_leaf(key, x):
    """The FLUX AE's rule (JAX's convert_flux_ae): every leaf fp32, convs
    [Cout, Cin, kh, kw] as they are, the reference's module names as the
    JAX tree's."""
    import torch

    name, leaf = key.rsplit(".", 1)
    m = re.fullmatch(r"(encoder)\.down\.(\d+)\.(block\.(\d+)|downsample\."
                     r"conv)(.*)", name) or re.fullmatch(
        r"(decoder)\.up\.(\d+)\.(block\.(\d+)|upsample\.conv)(.*)", name)
    if m:
        part, i, what, j, rest = m.groups()
        level = f"{part}.{'down' if part == 'encoder' else 'up'}{i}"
        name = (f"{level}.res{j}{rest}" if j is not None else
                f"{level}.{'down' if part == 'encoder' else 'up'}")
    for old, new in (("mid.block_1", "mid_res1"), ("mid.attn_1", "mid_attn"),
                     ("mid.block_2", "mid_res2"), ("nin_shortcut",
                                                   "shortcut"),
                     ("proj_out", "proj")):
        name = name.replace(old, new)
    return f"{name}.{'w' if leaf == 'weight' else 'b'}", x, torch.float32


def _gen_case(gen, kv_len):
    """A flow pass's attention inputs over a 16,384-row cache: q [1, 4160,
    28, 128] (the latent rows and start / end, 4,098, padded to the
    kernels' multiple of 64 as attention() pads them), k, v [1, 16384, 4,
    128], the live keys the context's rows and the pass's own; the slots
    past kv_len hold 50.0."""
    return _causal_case(gen, 1, 4160, IMAGE_CAPACITY, 28, 4,
                        [kv_len - 4098], 4098, False)


def check_image_gen_kernels():
    """flash_attention_bf16 (the grouped running-max mode of
    flash_attention_sm90.cu) at the flow passes' two shapes: q [1, 4098
    rows padded to 4160, 28, 128] over the text-to-image context (the
    prompt's 64-row bucket: 4,162 keys) and over the editing context (the
    VAE and ViT towers and the instruction: 13,162 keys), 4 kv heads;
    against its plain version within PERF.md s2's bf16 bound, timed beside
    SDPA on the 4,098 live rows and the live keys (kv heads repeated), its
    bound (the live rows' work) and its plain version. Returns the two
    records, counted by the flash_attention_bf16 counter."""
    import torch
    import torch.nn.functional as F

    from univid_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(18)
    n, nk, d, lq = 28, 4, 128, 4098
    tol = dict(atol=1e-3, rtol=2.0 ** -7,
               why="one bf16 ulp of the output (at most 2^-7 relative) "
                   "plus 1e-3 for the fp32 summation order and the "
                   "approximate exp2 before p rounds to bf16")
    records = {}
    for tag, kvl in (("t2i", 4098 + 64), ("edit", 4098 + 4902 + 64 + 4098)):
        q, k, v, _, kv = _gen_case(gen, kvl)
        with torch.no_grad():
            got = fa._flash_cuda(q, k, v, kv, None, None)
            want = fa.attention_plain(q, k, v, kv_len=kv)
            err = compare(f"flash_attention_bf16 image gen pass {tag}", got,
                          want, **tol)
            ms = cuda_time(lambda: fa._flash_cuda(q, k, v, kv, None, None),
                           10)
            plain_ms = cuda_time(lambda: fa.attention_plain(q, k, v,
                                                            kv_len=kv), 1)
            qs, ks, vs = (x.transpose(1, 2) for x in (
                q[:, :lq], fa.repeat_kv(k[:, :kvl], n),
                fa.repeat_kv(v[:, :kvl], n)))
            lib_ms = cuda_time(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, scale=1.0 / fa.LOG2E), 5)
        bms, by = bound_ms(4 * lq * kvl * n * d,
                           2 * lq * n * d * 2 + kvl * nk * d * 2 * 2,
                           H100_BF16_FLOPS)
        rec = dict(name=f"flash_attention_bf16_image_gen_{tag}",
                   counter="flash_attention_bf16", route="cuda",
                   source="univid_tpu_torch/kernels/csrc/"
                          "flash_attention_sm90.cu",
                   replaces="univid_tpu/kernels/flash_attention.py:44",
                   max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                   bound_by=by, library_ms=lib_ms,
                   shape={"q": list(q.shape), "live_rows": lq,
                          "kv": list(k.shape), "kv_len": kvl})
        log(json.dumps({"kernel": rec}))
        records[rec["name"]] = rec
        del q, k, v, got, want, qs, ks, vs
        torch.cuda.empty_cache()
    return records


class _GenRecorder:
    """Instrumentation of an image request: each call of the inferencer's
    building blocks (the text prefill, the FLUX encode and decode, the
    VAE and ViT appends, SigLIP, the flow loop) timed to a synchronised
    end with the launches in it, and a CUDA event at the start of each
    flow pass, so that a step's seconds (its three passes and its CFG
    combine) come without a synchronisation inside the loop."""

    NAMES = ("update_context_text", "image_vae_encode", "update_context_vae",
             "siglip_forward", "update_context_vit", "generate_image_latent",
             "image_vae_decode")

    def __init__(self):
        self.calls, self.events, self.latent = [], [], None

    def __enter__(self):
        import torch

        from univid_tpu_torch.kernels import flash_attention as fa
        from univid_tpu_torch.models.bagel import bagel as bm
        from univid_tpu_torch.pipelines import interleave as im

        self.saved = [(im, n, getattr(im, n)) for n in self.NAMES]
        self.saved.append((bm, "_flow_hidden", bm._flow_hidden))

        def timed(name, fn):
            def call(*a, **kw):
                torch.cuda.synchronize()
                before = dict(fa.LAUNCHES)
                t = time.perf_counter()
                out = fn(*a, **kw)
                if name == "generate_image_latent":
                    self.events.append(self._event())
                    self.latent = out[0]
                torch.cuda.synchronize()
                self.calls.append({"fn": name,
                                   "s": time.perf_counter() - t,
                                   "launches": {k: fa.LAUNCHES[k] - before[k]
                                                for k in before
                                                if fa.LAUNCHES[k] != before[k]}})
                return out
            return call

        def flow_hidden(*a, **kw):
            self.events.append(self._event())
            return self.saved[-1][2](*a, **kw)

        for mod, n, fn in self.saved[:-1]:
            setattr(mod, n, timed(n, fn))
        bm._flow_hidden = flow_hidden
        return self

    @staticmethod
    def _event():
        import torch
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def __exit__(self, *exc):
        for mod, n, fn in self.saved:
            setattr(mod, n, fn)

    def step_seconds(self, passes_per_step):
        """Seconds of each flow step of the last loop: from its first
        pass's event to the next step's (the loop's end for the last)."""
        ev = self.events
        starts = ev[:-1][::passes_per_step] + [ev[-1]]
        return [a.elapsed_time(b) / 1e3 for a, b in zip(starts, starts[1:])]


class _ContextCheck:
    """Mixin: gen_image asserts that its three contexts are three caches
    and leaves each as it was (len, len_host, rope, the rows up to len)."""

    def gen_image(self, image_shape, ctx, **kw):
        import torch

        ctxs = [ctx, kw["cfg_text_ctx"], kw["cfg_img_ctx"]]

        def snap(c):
            n = max(c["cache"]["len_host"])
            return (c["cache"]["len"].clone(), list(c["cache"]["len_host"]),
                    c["rope"].clone(), c["cache"]["k"][:, :, :n].clone(),
                    c["cache"]["v"][:, :, :n].clone())

        before = [snap(c) for c in ctxs]
        out = super().gen_image(image_shape, ctx, **kw)
        same = all(a == b if isinstance(a, list) else torch.equal(a, b)
                   for c, s in zip(ctxs, before) for a, b in zip(snap(c), s))
        self.context_rows = [c["cache"]["len_host"][0] for c in ctxs]
        distinct = len({id(c["cache"]["k"]) for c in ctxs}) == 3
        log(json.dumps({"check": "contexts unchanged by gen_image",
                        "rows": self.context_rows, "distinct": distinct,
                        "ok": same and distinct}))
        if not (same and distinct):
            fail("gen_image changed a context, or two share a cache")
        del before
        return out


def _small_image_models():
    """A small d=128 BAGEL (hidden 512, 4 heads over 2 kv heads, 2 layers,
    llm2vae redrawn N(0, 0.05^2): JAX's is zero-init), a tiny SigLIP and a
    4-level FLUX AE (ch 32, 8x downsampling), bf16 LLM and tower, fp32
    AE, on the CPU from seeds."""
    import torch

    from univid_tpu_torch.models.bagel.autoencoder import (ImageVAEConfig,
                                                           init_image_vae)
    from univid_tpu_torch.models.bagel.bagel import BagelConfig, init_bagel
    from univid_tpu_torch.models.bagel.qwen2_mot import Qwen2MoTConfig
    from univid_tpu_torch.models.bagel.siglip import (SiglipConfig,
                                                      init_siglip)

    bf = torch.bfloat16
    llm = Qwen2MoTConfig(vocab_size=4096, hidden_size=512,
                         intermediate_size=1024, num_layers=2, num_heads=4,
                         num_kv_heads=2)
    cfg = BagelConfig(llm=llm, vit_hidden_size=64, start_of_image=4090,
                      end_of_image=4091, bos_token_id=4092,
                      eos_token_id=4093)
    scfg = SiglipConfig(hidden_size=64, intermediate_size=128, num_layers=2,
                        num_heads=2, patch_size=14, image_size=224)
    vcfg = ImageVAEConfig(ch=32, ch_mult=(1, 2, 2, 2), num_res_blocks=1)
    gen = torch.Generator().manual_seed(31)
    bagel = init_bagel(gen, cfg, dtype=bf, device="cpu")
    sig = init_siglip(gen, scfg, dtype=bf, device="cpu")
    vae = init_image_vae(gen, vcfg, device="cpu")
    with torch.no_grad():
        bagel.llm2vae.w.normal_(0.0, 0.05, generator=gen)
        for layer in bagel.llm.layers:
            layer.attn_gen.q_norm.uniform_(0.5, 1.5, generator=gen)
            layer.attn_gen.k_norm.uniform_(0.5, 1.5, generator=gen)
    return cfg, bagel, scfg, sig, vcfg, vae


def small_bagel_image_parity():
    """The small d=128 BAGEL with its tower and AE in bf16, text to image
    (256x256, 6 timesteps, the three CFG branches) and editing (a 128x192
    image through both towers, then the instruction, 4 timesteps) through
    InterleaveInferencer.interleave_inference on the card (kernels) and on
    the CPU (plain versions), same weights and starting noise: the latent
    and the image rel. L2 < 3e-2, and the card's launches: per loop 2 x 3
    x (T - 1) flash_attention_bf16, 2 per append, 2 causal per prefill."""
    import copy

    import numpy as np
    import torch

    from univid_tpu_torch.kernels import flash_attention as fa
    from univid_tpu_torch.pipelines.interleave import InterleaveInferencer
    from univid_tpu_torch.utils.tokenizers import HashTokenizer

    cfg, bagel, scfg, sig, vcfg, vae = _small_image_models()
    image = np.random.default_rng(5).uniform(-1, 1, (128, 192, 3)).astype(
        np.float32)
    requests = {"t2i": ([IMAGE_PROMPT], (256, 256), 6),
                "edit": ([image, IMAGE_EDIT], (128, 192), 4)}
    layers = cfg.llm.num_layers
    out = {"check": "small_bagel_image_parity", "limit": 3e-2,
           "why": "bf16 on both sides: cuBLAS and the CPU round each GEMM "
                  "at other points (2^-8 relative), over 2 layers and the "
                  "loop's steps"}
    ok = True
    for tag, (inputs, shape, steps) in requests.items():
        n_tok = (shape[0] // 16) * (shape[1] // 16)
        noise = torch.randn((1, n_tok, 64),
                            generator=torch.Generator().manual_seed(6))
        res = {}
        for device in ("cuda", "cpu"):
            inf = InterleaveInferencer(
                copy.deepcopy(bagel).to(device), cfg, HashTokenizer(4090),
                siglip=copy.deepcopy(sig).to(device), siglip_cfg=scfg,
                vae=copy.deepcopy(vae).to(device), vae_cfg=vcfg,
                capacity=1024, compute_dtype=torch.bfloat16)
            fa.reset_launches()
            with _GenRecorder() as rec:
                img = inf.interleave_inference(
                    inputs, num_timesteps=steps, cfg_text_scale=4.0,
                    cfg_img_scale=1.5, image_shapes=shape,
                    noise=noise.to(device))[-1]
            loop = [c for c in rec.calls
                    if c["fn"] == "generate_image_latent"]
            res[device] = {"image": img.float().cpu(),
                           "latent": rec.latent.float().cpu(),
                           "launches": {k: v for k, v in fa.LAUNCHES.items()
                                        if v},
                           "loop_launches": loop[0]["launches"]}
        got, want = res["cuda"], res["cpu"]
        image_err = rel_l2(got["image"], want["image"])
        latent_err = rel_l2(got["latent"], want["latent"])
        n_prefill = 2 * layers          # the prompt in ctx and in cfg_img
        n_append = layers * (2 if tag == "edit" else 0)
        want_loop = {"flash_attention_bf16": layers * 3 * (steps - 1)}
        want_all = {"flash_attention_bf16": want_loop["flash_attention_bf16"]
                    + n_append, "flash_attention_bf16_causal": n_prefill}
        out[tag] = {"latent_rel_l2": latent_err, "image_rel_l2": image_err,
                    "launches": got["launches"], "expected": want_all,
                    "shape": list(got["image"].shape)}
        ok = ok and max(latent_err, image_err) < 3e-2 \
            and got["launches"] == want_all \
            and got["loop_launches"] == want_loop \
            and tuple(got["image"].shape) == (*shape, 3)
    out["ok"] = ok
    log(json.dumps(out))
    if not ok:
        fail("BAGEL image generation on the card disagrees with the CPU, or "
             "went through other kernels")


IMAGE_SIDE = 1024        # both requests: 64 x 64 latent tokens, 4,098 rows


def _edit_input(side):
    """A seeded side x side input image in [-1, 1] with smooth content
    (blocks of 64 x 64 pixels of one colour)."""
    import numpy as np

    rng = np.random.default_rng(19)
    base = rng.uniform(-1, 1, (side // 64, side // 64, 3)).astype(np.float32)
    return np.kron(base, np.ones((64, 64, 1), np.float32))


def _ae_from_checkpoint(output_dir, vcfg):
    """A full-size synthetic ae.safetensors (flux_ae_manifest's keys and
    shapes, fp32, drawn by ckpt_draw from AE_SEED) written by
    write_safetensors, loaded onto the card by load_flux_ae_checkpoint,
    every parameter held to the written tensor bit for bit (flux_ae_leaf),
    the file deleted. -> (the AE, a log record)."""
    import os

    import torch

    from univid_tpu_torch.core.checkpoint import load_flux_ae_checkpoint
    from univid_tpu_torch.core.manifest import flux_ae_manifest

    man = flux_ae_manifest(vcfg)
    root = os.path.join(output_dir, "bagel_ae")
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "ae.safetensors")
    t0 = time.perf_counter()
    size = write_safetensors(path, _draws(man, AE_SEED, torch.float32))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vae, cfg = load_flux_ae_checkpoint(root, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    params = dict(vae.named_parameters())
    seen = set()
    for i, (k, s) in enumerate(sorted(man.items())):
        name, want, dtype = flux_ae_leaf(k, ckpt_draw(k, s, i, AE_SEED))
        p = params.get(name)
        if p is None or p.dtype != dtype or not p.is_cuda \
                or not torch.equal(p, want.to(dtype)):
            fail(f"ae.safetensors: {k} -> {name} is not the written tensor")
        seen.add(name)
    if seen != set(params) or cfg != vcfg:
        fail(f"ae.safetensors: parameters not in the file: "
             f"{sorted(set(params) - seen)[:5]}")
    os.remove(path)
    return vae, {"bytes": size, "write_s": write_s, "load_s": load_s,
                 "parameters_bit_equal": len(seen)}


def _ae_card_vs_cpu(vae, vcfg, side=256):
    """The full AE's encode and decode on a side x side image, card against
    CPU, fp32 on both sides with TF32 off (the decode of the card's
    latent on both): rel. L2 < 1e-4."""
    import copy

    import torch

    from univid_tpu_torch.models.bagel.autoencoder import (image_vae_decode,
                                                           image_vae_encode)

    x = torch.rand((1, side, side, 3),
                   generator=torch.Generator().manual_seed(8)) * 2 - 1
    cpu = copy.deepcopy(vae).cpu()
    with torch.no_grad():
        z = image_vae_encode(vae, vcfg, x.cuda())
        y = image_vae_decode(vae, vcfg, z)
        z_cpu = image_vae_encode(cpu, vcfg, x)
        y_cpu = image_vae_decode(cpu, vcfg, z.cpu())
    out = {"check": "FLUX AE card vs CPU", "side": side,
           "encode_rel_l2": rel_l2(z.cpu(), z_cpu),
           "decode_rel_l2": rel_l2(y.cpu(), y_cpu), "limit": 1e-4,
           "why": "fp32 on both sides, TF32 off: summation order only"}
    out["ok"] = max(out["encode_rel_l2"], out["decode_rel_l2"]) < 1e-4
    log(json.dumps(out))
    if not out["ok"]:
        fail("the FLUX AE on the card disagrees with the CPU")


def _image_request(inf, inputs, steps, **kw):
    """One interleave_inference image request from zero counts: its
    image, its launch counts, the seconds and launches of each call and
    of each flow step."""
    import torch

    from univid_tpu_torch.kernels import flash_attention as fa

    fa.reset_launches()
    with _GenRecorder() as rec:
        t0 = time.perf_counter()
        img = inf.interleave_inference(
            inputs, num_timesteps=steps,
            image_shapes=(IMAGE_SIDE, IMAGE_SIDE), **kw)[-1]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return img, launch_counts(), wall, rec


def _request_record(tag, img, launches, wall, rec, layers, steps):
    """Check one request's image (shape, finite, in [0, 1]), each call's
    launches (a prefill: `layers` causal; an append: `layers`; the loop:
    layers x 3 x (steps - 1); encode, decode and SigLIP none) and its
    flow steps; log its phases. -> the record."""
    import torch

    want = {"update_context_text": {"flash_attention_bf16_causal": layers},
            "update_context_vae": {"flash_attention_bf16": layers},
            "update_context_vit": {"flash_attention_bf16": layers},
            "generate_image_latent":
                {"flash_attention_bf16": layers * 3 * (steps - 1)}}
    bad = [c for c in rec.calls if c["launches"] != want.get(c["fn"], {})]
    seconds = {}
    for c in rec.calls:
        seconds.setdefault(c["fn"], []).append(c["s"])
    step_s = rec.step_seconds(3)
    out = {"phase": f"bagel_image_{tag}", "seconds": wall,
           "calls_s": seconds, "flow_step_s": step_s,
           "flow_step_median_s": statistics.median(step_s),
           "launches": {k: v for k, v in launches.items() if v},
           "image": list(img.shape),
           "image_min_max": [float(img.min()), float(img.max())]}
    log(json.dumps(out))
    if bad or len(step_s) != steps - 1:
        fail(f"{tag}: calls off their launches {bad[:3]}, or "
             f"{len(step_s)} flow steps")
    if tuple(img.shape) != (IMAGE_SIDE, IMAGE_SIDE, 3) \
            or not bool(torch.isfinite(img).all()) \
            or float(img.min()) < 0.0 or float(img.max()) > 1.0:
        fail(f"{tag}: the image is not a finite [0, 1] "
             f"{IMAGE_SIDE}x{IMAGE_SIDE}x3 array")
    return out


def bagel_image_main_path(output_dir):
    """BAGEL image generation at full width and depth: BAGEL-7B-MoT (bf16,
    both experts, all 28 layers, random from seeds, llm2vae redrawn
    N(0, 0.02^2): JAX's is zero-init), the SigLIP so400m tower and the full
    FLUX AE, loaded from a synthetic ae.safetensors (`_ae_from_checkpoint`;
    then `_ae_card_vs_cpu`), in an InterleaveInferencer of 16,384 rows.
    Two requests, each from zero counts: text to image at 1024x1024 (a
    prompt of more than 32 tokens, 50 timesteps, text scale 4.0, image
    scale 1.5, interval (0.4, 1.0], shift 3.0, global renorm: three
    branches every step) and editing (a 1024x1024 image through the FLUX
    encode, the VAE append of 4,098 rows and the ViT append of 4,902, an
    instruction of more than 32 tokens, 8 timesteps, text_channel renorm).
    Checks each call's launches, the images and that gen_image leaves its
    three contexts as they were; logs the seconds of each call and flow
    step and the peak memory; profiles one flow step (three passes) over
    the prompt's context. -> {"bagel_t2i": counts, "bagel_edit": counts}."""
    import gc

    import torch

    from univid_tpu_torch.models.bagel import bagel as bm
    from univid_tpu_torch.models.bagel.autoencoder import ImageVAEConfig
    from univid_tpu_torch.models.bagel.bagel import BagelConfig, init_bagel
    from univid_tpu_torch.models.bagel.siglip import (SiglipConfig,
                                                      init_siglip)
    from univid_tpu_torch.pipelines.interleave import InterleaveInferencer
    from univid_tpu_torch.utils.tokenizers import HashTokenizer

    gc.collect()
    torch.cuda.empty_cache()
    bf = torch.bfloat16
    vcfg = ImageVAEConfig()
    vae, ae_rec = _ae_from_checkpoint(output_dir, vcfg)
    log(json.dumps({"check": "ae.safetensors written, loaded, bit-equal",
                    **ae_rec}))
    _ae_card_vs_cpu(vae, vcfg)

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    cfg, scfg = BagelConfig(), SiglipConfig()
    t0 = time.perf_counter()
    bagel = init_bagel(gen(50), cfg, dtype=bf, device="cuda")
    sig = init_siglip(gen(51), scfg, dtype=bf, device="cuda")
    with torch.no_grad():
        bagel.llm2vae.w.normal_(0.0, 0.02, generator=gen(52))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    class Inferencer(_ContextCheck, InterleaveInferencer):
        pass

    inf = Inferencer(bagel, cfg, HashTokenizer(), siglip=sig,
                     siglip_cfg=scfg, vae=vae, vae_cfg=vcfg,
                     capacity=IMAGE_CAPACITY, compute_dtype=bf)
    n_prompt = len(inf._wrap_ids(IMAGE_PROMPT))
    n_edit = len(inf._wrap_ids(IMAGE_EDIT))
    if min(n_prompt, n_edit) <= 32:
        fail(f"the prompts take {n_prompt} and {n_edit} tokens: a prefill "
             "of 32 or fewer takes the decode-shaped einsums")
    layers = cfg.llm.num_layers
    torch.cuda.reset_peak_memory_stats()
    counts = {}
    img, counts["bagel_t2i"], wall, rec = _image_request(
        inf, [IMAGE_PROMPT], T2I_TIMESTEPS, cfg_text_scale=4.0,
        cfg_img_scale=1.5, cfg_interval=(0.4, 1.0), timestep_shift=3.0,
        cfg_renorm_type="global", rng=gen(53))
    t2i = _request_record("t2i", img, counts["bagel_t2i"], wall, rec, layers,
                          T2I_TIMESTEPS)
    t2i_rows = inf.context_rows
    img, counts["bagel_edit"], wall, rec = _image_request(
        inf, [_edit_input(IMAGE_SIDE), IMAGE_EDIT], EDIT_TIMESTEPS,
        cfg_text_scale=4.0, cfg_img_scale=2.0, cfg_interval=(0.0, 1.0),
        timestep_shift=3.0, cfg_renorm_type="text_channel", rng=gen(54))
    edit = _request_record("edit", img, counts["bagel_edit"], wall, rec,
                           layers, EDIT_TIMESTEPS)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(json.dumps({"phase": "bagel_image_main_path", "model":
                    "BAGEL-7B-MoT", "init_s": init_s,
                    "capacity": IMAGE_CAPACITY, "prompt_tokens": n_prompt,
                    "instruction_tokens": n_edit,
                    "t2i_context_rows": t2i_rows,
                    "edit_context_rows": inf.context_rows,
                    "t2i_s": t2i["seconds"], "edit_s": edit["seconds"],
                    "peak_memory_gb": peak}))
    want_t2i = {"flash_attention_bf16": layers * 3 * (T2I_TIMESTEPS - 1),
                "flash_attention_bf16_causal": 2 * layers}
    want_edit = {"flash_attention_bf16": layers * 3 * (EDIT_TIMESTEPS - 1)
                 + 2 * layers, "flash_attention_bf16_causal": 2 * layers}
    for tag, want in (("bagel_t2i", want_t2i), ("bagel_edit", want_edit)):
        got = {k: counts[tag][k] for k in want}
        if got != want or sum(counts[tag].values()) != sum(want.values()):
            fail(f"{tag}: launches {counts[tag]} != {want}")
    check_impl("BAGEL image requests (the editing one)",
               want_edit["flash_attention_bf16"],
               causal_sm90=want_edit["flash_attention_bf16_causal"])
    if peak >= 80.0:
        fail(f"BAGEL image peak memory {peak:.1f} GB")

    # one flow step (three passes) under the profiler over the prompt's
    # context: where a step's time goes
    with torch.no_grad():
        ctx = inf.update_context_text(IMAGE_PROMPT, inf.init_gen_context())
        side = IMAGE_SIDE // cfg.latent_downsample
        pos_rows, und = bm._latent_grid(cfg, side, side, "cuda")
        x = torch.randn((1, side * side, cfg.patch_latent_dim),
                        generator=gen(55), device="cuda")
        _, prof = profile_call(lambda: [bm._flow_velocity(
            bagel, cfg, x, 0.5, und, pos_rows, ctx, bf) for _ in range(3)])
    log(json.dumps({"check": "bagel_image_flow_step_profile", **prof}))
    del inf, bagel, sig, vae, ctx, x, img
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# FLUX.1 Kontext image editing
# ---------------------------------------------------------------------------

KONTEXT_SIDE = 1024      # the reference operating point: 64 x 64 tokens
KONTEXT_STEPS = 28
KONTEXT_GUIDANCE = 2.5
KONTEXT_INT8_STEPS = 2   # the int8 edit's steps: cut for the time limit
KONTEXT_TOKENS = 512 + 2 * 4096   # text, target and reference tokens
KONTEXT_PADDED = 512 + 2 * 4070   # a 1184x880 target and reference (55 x 74
#                                   tokens), padded to 8,704 with kv_len
KONTEXT_PROMPT = ("Make the person stand upright in a T-pose, arms straight "
                  "out to the sides, facing the camera.")
KONTEXT_WHY = ("one bf16 ulp of the output (at most 2^-7 relative) plus 1e-3 "
               "for the fp32 summation order and the approximate exp2 "
               "before p rounds to bf16")


def check_kontext_kernels():
    """flash_attention_bf16 (the unmasked running-max mode of
    flash_attention_sm90.cu) at the Kontext edit's joint attention, [1,
    8704, 24, 128] bf16 (512 text + 4,096 target + 4,096 reference tokens,
    qk-normed rows), and at a padded bucket's 8,652 tokens padded to 8,704
    (kv_len 8,652, the pad keys 50.0): against its plain version within
    PERF.md s2's bf16 bound, timed with CUDA events beside SDPA on the live
    rows and keys and the bound of that work. Returns the unpadded
    shape's record (counted by flash_attention_bf16); the padded one is
    logged beside it."""
    import torch
    import torch.nn.functional as F

    from univid_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(23)
    n, d, l = 24, 128, KONTEXT_TOKENS
    records = {}
    for tag, live in (("", l), ("_kv_len", KONTEXT_PADDED)):
        q = fa._fold(qk_normed((1, l, n, d), gen, torch.bfloat16), d ** -0.5)
        k = qk_normed((1, l, n, d), gen, torch.bfloat16)
        v = torch.randn((1, l, n, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        kv = None
        if live < l:
            k[:, live:], v[:, live:] = 50.0, 50.0
            kv = torch.full((1,), live, dtype=torch.int32, device="cuda")
        with torch.no_grad():
            got = fa._flash_cuda(q, k, v, kv, None, None)
            want = fa.attention_plain(q, k, v, kv_len=kv)
            err = compare(f"flash_attention_bf16 Kontext joint attention"
                          f"{tag}", got[:, :live], want[:, :live],
                          atol=1e-3, rtol=2.0 ** -7, why=KONTEXT_WHY)
            ms = cuda_time(lambda: fa._flash_cuda(q, k, v, kv, None, None),
                           20)
            plain_ms = cuda_time(lambda: fa.attention_plain(q, k, v,
                                                            kv_len=kv), 1)
            qs, ks, vs = (x[:, :live].transpose(1, 2) for x in (q, k, v))
            lib_ms = cuda_time(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, scale=1.0 / fa.LOG2E), 20)
        bms, by = bound_ms(4 * live * live * n * d, 4 * live * n * d * 2,
                           H100_BF16_FLOPS)
        rec = dict(name=f"flash_attention_bf16_kontext{tag}",
                   counter="flash_attention_bf16", route="cuda",
                   source="univid_tpu_torch/kernels/csrc/"
                          "flash_attention_sm90.cu",
                   replaces="univid_tpu/kernels/flash_attention.py:44",
                   max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                   bound_by=by, library_ms=lib_ms,
                   shape={"q": list(q.shape), "kv_len": live})
        if tag:
            log(json.dumps({"kernel_at_kontext_padded_shape": rec}))
        else:
            log(json.dumps({"kernel": rec}))
            records[rec["name"]] = rec
        del q, k, v, got, want, qs, ks, vs
        torch.cuda.empty_cache()
    return records


class _RefRouteCount:
    """Counts the reference attention route's calls by head dim while the
    block runs (kernels.attention.mha_reference, which attention() calls
    for head dims that are not multiples of 128)."""

    def __enter__(self):
        from univid_tpu_torch.kernels import attention as am

        self.by_d, self._am, self._fn = {}, am, am.mha_reference

        def counted(q, *a, **kw):
            d = int(q.shape[-1])
            self.by_d[d] = self.by_d.get(d, 0) + 1
            return self._fn(q, *a, **kw)

        am.mha_reference = counted
        return self

    def __exit__(self, *exc):
        self._am.mha_reference = self._fn


class _EditRecorder:
    """Instrumentation of a Kontext edit: a CUDA event before each
    transformer pass of the sigma loop (pipelines.kontext.flux_forward;
    meaningless for a CPU pipeline, whose latent alone is read), and the
    loop's final latent (the pipeline's denoise)."""

    def __init__(self, pipe):
        self.pipe, self.events, self.latent = pipe, [], None

    def __enter__(self):
        import torch

        from univid_tpu_torch.pipelines import kontext as km

        self._km, self._fwd = km, km.flux_forward
        self._denoise = self.pipe.denoise

        def fwd(*a, **kw):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
            return self._fwd(*a, **kw)

        def denoise(*a, **kw):
            self.latent = self._denoise(*a, **kw)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
            return self.latent

        km.flux_forward = fwd
        self.pipe.denoise = denoise
        return self

    def __exit__(self, *exc):
        self._km.flux_forward = self._fwd
        del self.pipe.denoise

    def step_seconds(self):
        import torch
        torch.cuda.synchronize()
        ev = self.events
        return [a.elapsed_time(b) / 1e3 for a, b in zip(ev, ev[1:])]


def _kontext_image(side, seed=23):
    """A seeded side x side u8 image of smooth blocks (64 x 64 pixels of
    one colour)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (side // 64, side // 64, 3), dtype=np.uint8)
    return np.kron(base, np.ones((64, 64, 1), np.uint8))


def _small_kontext_pipeline():
    """A small d=128 Kontext editor on the CPU from seeds: the transformer
    at hidden 256, 2 heads, 2 + 2 blocks, in_channels 64 (the published
    packing of a z = 16 latent), bf16; the tiny T5 and CLIP towers (bf16);
    a 4-level FLUX AE (ch 32, 8x downsampling, fp32); the bf16 policy."""
    import torch

    from univid_tpu_torch.models.bagel.autoencoder import (ImageVAEConfig,
                                                           init_image_vae)
    from univid_tpu_torch.models.flux import (FluxConfig, TINY_CLIP_TEXT,
                                              init_clip_text, init_flux)
    from univid_tpu_torch.models.wan.t5 import UMT5Encoder
    from univid_tpu_torch.pipelines import kontext as km
    from univid_tpu_torch.utils.tokenizers import HashTokenizer

    bf = torch.bfloat16
    fcfg = FluxConfig(hidden_size=256, num_heads=2, depth_double=2,
                      depth_single=2, context_dim=km.TINY_FLUX_T5.dim,
                      vec_dim=TINY_CLIP_TEXT.hidden_size, time_freq_dim=32)
    vcfg = ImageVAEConfig(ch=32, ch_mult=(1, 2, 2, 2), num_res_blocks=1)
    t5c, cc = km.TINY_FLUX_T5, TINY_CLIP_TEXT

    def gen(i):
        return torch.Generator().manual_seed(2300 + i)

    kw = dict(dtype=bf, device="cpu")
    return km.KontextPipeline(
        init_flux(gen(0), fcfg, **kw), fcfg,
        init_image_vae(gen(1), vcfg, device="cpu"), vcfg,
        UMT5Encoder(t5c, gen=gen(2), **kw), t5c,
        km._PaddedTok(HashTokenizer(vocab_size=t5c.vocab_size),
                      t5c.text_len),
        init_clip_text(gen(3), cc, **kw), cc,
        km._PaddedTok(HashTokenizer(vocab_size=cc.vocab_size), cc.max_len))


def _kontext_ckpt_card_vs_cpu(output_dir):
    """A Kontext editor dir at the tiny geometry written from the port's
    manifests (fp32 draws, the HF tied embed_tokens and CLIP's
    position_ids beside them), loaded by load_kontext_checkpoint(tiny=True)
    on the card and on the CPU: every parameter of the four modules equal
    bit for bit, dtype for dtype, on the card. The dir is deleted."""
    import os
    import shutil

    import torch

    from univid_tpu_torch.core import manifest as tm
    from univid_tpu_torch.core.checkpoint import load_kontext_checkpoint
    from univid_tpu_torch.models.flux import TINY_CLIP_TEXT, TINY_FLUX
    from univid_tpu_torch.pipelines import kontext as km

    root = os.path.join(output_dir, "kontext_tiny")
    f32 = torch.float32
    files = {
        "flux1-kontext-dev.safetensors": _draws(
            tm.flux_transformer_manifest(TINY_FLUX), 231, f32),
        "ae.safetensors": _draws(tm.flux_ae_manifest(km.TINY_FLUX_VAE), 232,
                                 f32),
        "text_encoder_2/model.safetensors": _draws(
            tm.t5_hf_manifest(km.TINY_FLUX_T5), 233, f32),
        "text_encoder/model.safetensors": _draws(
            tm.clip_text_manifest(TINY_CLIP_TEXT), 234, f32),
    }
    t5 = files["text_encoder_2/model.safetensors"]
    t5["encoder.embed_tokens.weight"] = t5["shared.weight"]
    files["text_encoder/model.safetensors"][
        "text_model.embeddings.position_ids"] = (
        torch.int64, (1, TINY_CLIP_TEXT.max_len),
        lambda: torch.arange(TINY_CLIP_TEXT.max_len)[None])
    for rel, tensors in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_safetensors(path, tensors)
    card = load_kontext_checkpoint(root, device="cuda", tiny=True)
    cpu = load_kontext_checkpoint(root, device="cpu", tiny=True)
    n = 0
    for mc, mh in zip(card[0::2], cpu[0::2]):
        sc, sh = mc.state_dict(), mh.state_dict()
        if set(sc) != set(sh):
            fail("load_kontext_checkpoint: the card's and the CPU's "
                 "modules differ in names")
        for k, t in sc.items():
            if not t.is_cuda or t.dtype != sh[k].dtype \
                    or not torch.equal(t.cpu(), sh[k]):
                fail(f"load_kontext_checkpoint: {k} on the card is not the "
                     "CPU load's")
            n += 1
    shutil.rmtree(root)
    log(json.dumps({"check": "load_kontext_checkpoint card vs CPU (tiny "
                    "dir)", "tensors_bit_equal": n, "ok": True}))


def small_kontext_parity(output_dir):
    """The small d=128 Kontext editor (`_small_kontext_pipeline`) on the
    card against the same pipeline on the CPU: a 256x256 edit (its
    reference resized to the 1024x1024 bucket: 16 + 256 + 4,096 tokens,
    padded to 4,480 with kv_len), 4 steps, guidance 2.5, the same noise:
    latent and image rel. L2 < 3e-2 (PERF.md s2's bf16 bound); the card's
    joint attention 16 sm90 launches (4 blocks x 4 steps); then
    `_kontext_ckpt_card_vs_cpu`."""
    import copy

    import numpy as np
    import torch

    cpu = _small_kontext_pipeline()
    card = copy.copy(cpu)
    for name in ("flux", "vae", "t5", "clip"):
        setattr(card, name, copy.deepcopy(getattr(cpu, name)).cuda())
    card._rope_cache = {}
    img = _kontext_image(256)
    steps = 4
    noise = torch.randn((1, 256, 64), generator=torch.Generator()
                        .manual_seed(2310))
    kw = dict(num_inference_steps=steps, guidance_scale=KONTEXT_GUIDANCE,
              noise=noise)
    _reset_counts()
    with _RefRouteCount() as ref, _EditRecorder(card) as rec:
        out_card = card.edit(img, KONTEXT_PROMPT, **kw)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _all_counts().items() if v}
    with _EditRecorder(cpu) as rec_cpu:
        out_cpu = cpu.edit(img, KONTEXT_PROMPT, **kw)
    lat_card, lat_cpu = rec.latent, rec_cpu.latent
    rec = {"check": "small Kontext edit card vs CPU",
           "latent_rel_l2": rel_l2(lat_card.cpu(), lat_cpu),
           "image_rel_l2": rel_l2(torch.as_tensor(out_card.astype(
               np.float32)), torch.as_tensor(out_cpu.astype(np.float32))),
           "limit": 3e-2, "launches": launches,
           "reference_route_calls_by_head_dim": ref.by_d,
           "why": "the bf16 policy's bound: cuBLAS and the CPU round each "
                  "GEMM at other points, over 4 blocks x 4 steps"}
    want = {"flash_attention_bf16": 4 * steps}
    rec["ok"] = (max(rec["latent_rel_l2"], rec["image_rel_l2"]) < 3e-2
                 and launches == want and 128 not in ref.by_d
                 and out_card.shape == (256, 256, 3)
                 and bool(torch.isfinite(lat_card).all()))
    log(json.dumps(rec))
    if not rec["ok"]:
        fail("the small Kontext edit on the card disagrees with the CPU, or "
             "its attention did not run on the sm90 kernel")
    check_impl("small Kontext edit", 4 * steps)
    del card, cpu
    _kontext_ckpt_card_vs_cpu(output_dir)


def kontext_main_path():
    """FLUX.1 Kontext editing at full width and depth on random weights
    from a seed: the 11.9 B-parameter transformer (FluxConfig(): 19 double
    and 38 single blocks), T5-XXL v1.1 and CLIP-L, in bf16 (the dtype
    from_checkpoint places), the FLUX AE in fp32; one 1024x1024 edit
    through make_edit_fn(pipeline=...) at 28 steps, guidance 2.5, from
    zero counts. Checks a u8 [1024, 1024, 3] image, a finite latent, 57 x
    28 = 1,596 flash_attention_bf16 launches, all on the sm90 kernel, and
    no reference-route call at d=128; logs s/edit, s/step, the peak memory
    and one profiled transformer pass (attention / GEMM / other). Then
    quantizes the transformer weight-only in place (what make_edit_fn's
    int8=True does to a loaded checkpoint) and runs a KONTEXT_INT8_STEPS
    edit the same way. -> {"kontext": counts, "kontext_int8": counts}."""
    import gc

    import numpy as np
    import torch

    from univid_tpu_torch.core.quant import quantize_tree, quantized_bytes
    from univid_tpu_torch.models.flux import flux_forward
    from univid_tpu_torch.pipelines import kontext as km

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = km.KontextPipeline.random_init(seed=0, tiny=False,
                                          dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = {name: quantized_bytes(getattr(pipe, name)) / 1e9
                  for name in ("flux", "t5", "clip", "vae")}
    n_params = sum(p.numel() for p in pipe.flux.parameters())
    img = _kontext_image(KONTEXT_SIDE)
    blocks = pipe.flux_cfg.depth_double + pipe.flux_cfg.depth_single
    counts = {}

    def request(tag, steps):
        edit_fn = km.make_edit_fn(pipeline=pipe, num_inference_steps=steps,
                                  guidance_scale=KONTEXT_GUIDANCE, seed=0)
        torch.cuda.synchronize()
        _reset_counts()
        with _RefRouteCount() as ref, _EditRecorder(pipe) as rec:
            t = time.perf_counter()
            out = edit_fn(img, KONTEXT_PROMPT)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        counts[tag] = _all_counts()
        step_s = rec.step_seconds()
        want = dict(dict.fromkeys(counts[tag], 0),
                    flash_attention_bf16=blocks * steps)
        r = {"phase": tag, "side": KONTEXT_SIDE, "steps": steps,
             "guidance": KONTEXT_GUIDANCE, "s_per_edit": wall,
             "s_per_step": step_s, "s_per_step_median":
                 statistics.median(step_s),
             "steps_s": sum(step_s), "rest_s": wall - sum(step_s),
             "launches": {k: v for k, v in counts[tag].items() if v},
             "reference_route_calls_by_head_dim": ref.by_d,
             "image": [list(out.shape), str(out.dtype)],
             "latent_finite": bool(torch.isfinite(rec.latent).all()),
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        log(json.dumps(r))
        if out.shape != (KONTEXT_SIDE, KONTEXT_SIDE, 3) \
                or out.dtype != np.uint8 or not r["latent_finite"]:
            fail(f"{tag}: the edit is not a finite u8 1024x1024 image")
        if counts[tag] != want or 128 in ref.by_d or len(step_s) != steps:
            fail(f"{tag}: launches {r['launches']} (reference route "
                 f"{ref.by_d}) != {blocks * steps} flash_attention_bf16")
        check_impl(tag, blocks * steps)
        if r["peak_memory_gb"] >= 80.0:
            fail(f"{tag}: peak memory {r['peak_memory_gb']:.1f} GB")
        return r

    edit = request("kontext", KONTEXT_STEPS)
    log(json.dumps({"phase": "kontext_main_path", "model":
                    "FLUX.1-Kontext-dev (random weights)",
                    "transformer_parameters": n_params, "init_s": init_s,
                    "weights_gb": weights_gb, "tokens": KONTEXT_TOKENS,
                    "s_per_edit": edit["s_per_edit"],
                    "peak_memory_gb": edit["peak_memory_gb"]}))

    # one transformer pass under the profiler: where a step's time goes
    with torch.no_grad():
        txt, pooled = pipe.encode_prompt(KONTEXT_PROMPT)
        gen = torch.Generator(device="cuda").manual_seed(24)
        x = torch.randn((1, 2 * 4096, 64), generator=gen, device="cuda").to(
            torch.bfloat16)
        rope = pipe.rope_tables((64, 64), (64, 64), txt.shape[1])
        g = torch.full((1,), KONTEXT_GUIDANCE, device="cuda")
        t = torch.full((1,), 0.5, device="cuda")
        _, prof = profile_call(lambda: flux_forward(
            pipe.flux, pipe.flux_cfg, x, txt, t, guidance=g,
            clip_pooled=pooled, rope_tables=rope, policy=pipe.policy))
    log(json.dumps({"profile": "Kontext transformer pass, 8,704 tokens",
                    **prof}))
    del txt, pooled, x

    t0 = time.perf_counter()
    quantize_tree(pipe.flux)
    torch.cuda.synchronize()
    log(json.dumps({"check": "Kontext transformer quantized weight-only "
                    "(quantize_tree)", "seconds": time.perf_counter() - t0,
                    "transformer_gb": quantized_bytes(pipe.flux) / 1e9}))
    torch.cuda.reset_peak_memory_stats()
    request("kontext_int8", KONTEXT_INT8_STEPS)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# WanAnimate character animation
# ---------------------------------------------------------------------------

ANIMATE_STEPS = 2        # solver steps of the CLI run: cut from 50
ANIMATE_FRAMES = 77      # one clip of clip_len 77
ANIMATE_W, ANIMATE_H = 832, 480
ANIMATE_GRID = (21, 30, 52)        # 20 latent frames + the reference slot
ANIMATE_GRID_720P = (21, 45, 80)   # the preprocess's default 1280x720 area
ANIMATE_PROMPT = ("A dancer in a red jacket performs the moves of the pose "
                  "video in a sunlit studio.")
ONE_SHOT_WHY = ("one bf16 ulp of the output plus one p in [0.5, 1] rounded "
                "to the other bf16 neighbour (2^-8 max|v|, l >= 1; the "
                "one-shot max is the row's own); a leaked masked key (v = "
                "50) is far outside")
F32_D128_WHY = ("fp32 accuracy on both sides: three bf16 parts a side "
                "(~2^-24 a product), summation order and the approximate "
                "exp2 (2^-22 relative)")


def check_animate_kernels():
    """The animate DiT's attention kernels at its 832x480x77 shapes (21 x
    30 x 52 = 32,760 tokens, 40 heads of d=128, batch 1), each against its
    plain version within PERF.md s2's bound (keys past kv_len hold 50.0),
    timed with CUDA events beside SDPA on the live keys and the bound of
    the work: flash_attention_bf16, running max (the animate CLI's policy
    has no bound), [1, 32768, 40, 128] over 32,760 keys; the one-shot cross
    kernel over the 512 text keys and over the 257 CLIP-image keys padded
    to 320 (kv_len 257); the fp32 d=128 face-adapter call, q [21, 1600, 40,
    128] (1,560 tokens a latent frame, 21 frames) over 5 motion tokens
    padded to 64 (kv_len 5), its three split pre-passes included, with a
    kv_len = 0 row exactly 0. Returns the kernels-line records, counted by
    each kernel's own counter in the animate main path."""
    import torch
    import torch.nn.functional as F

    from univid_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(24)
    n, d = 40, 128
    kv_real = ANIMATE_GRID[0] * ANIMATE_GRID[1] * ANIMATE_GRID[2]
    l = -(-kv_real // fa.TILE) * fa.TILE
    bf = torch.bfloat16
    src = "univid_tpu_torch/kernels/csrc/flash_attention_sm90.cu"
    records = {}

    def record(name, counter, source, replaces, err, ms, plain_ms, flops,
               nb, lib_ms, peak, shape):
        bms, by = bound_ms(flops, nb, peak)
        rec = dict(name=name, counter=counter, route="cuda", source=source,
                   replaces=replaces, max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                   library_ms=lib_ms, shape=shape)
        log(json.dumps({"kernel": rec}))
        records[name] = rec

    with torch.no_grad():
        # ---- self-attention, running max, kv_len ---------------------------
        q = fa._fold(qk_normed((1, l, n, d), gen, bf), d ** -0.5)
        k = qk_normed((1, l, n, d), gen, bf)
        v = torch.randn((1, l, n, d), generator=gen, device="cuda").to(bf)
        k[:, kv_real:], v[:, kv_real:] = 50.0, 50.0
        kv = torch.full((1,), kv_real, dtype=torch.int32, device="cuda")
        got = fa._flash_cuda(q, k, v, kv, None, None)
        want = fa.attention_plain(q, k, v, kv_len=kv)
        err = compare("flash_attention_bf16 animate self-attention, running "
                      "max, kv_len", got, want, atol=1e-3, rtol=2.0 ** -7,
                      why=KONTEXT_WHY)
        del want
        ms = cuda_time(lambda: fa._flash_cuda(q, k, v, kv, None, None), 5)
        plain_ms = cuda_time(lambda: fa.attention_plain(q, k, v, kv_len=kv),
                             1)
        qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = cuda_time(lambda: F.scaled_dot_product_attention(
            qs, ks[:, :, :kv_real], vs[:, :, :kv_real],
            scale=1.0 / fa.LOG2E), 5)
        record("flash_attention_bf16_animate", "flash_attention_bf16", src,
               "univid_tpu/kernels/flash_attention.py:44", err, ms,
               plain_ms, 4 * n * l * kv_real * d, nbytes(q, k, v, got),
               lib_ms, H100_BF16_FLOPS,
               {"q": [1, l, n, d], "kv_len": kv_real})
        del k, v, got, qs, ks, vs

        # ---- cross-attention, one-shot max: text and CLIP-image keys -------
        for tag, lk, live in (("", 512, 512), ("_image", 320, 257)):
            k = qk_normed((1, lk, n, d), gen, bf)
            v = torch.randn((1, lk, n, d), generator=gen, device="cuda").to(
                bf)
            k[:, live:], v[:, live:] = 50.0, 50.0
            kvl = (torch.full((1,), live, dtype=torch.int32, device="cuda")
                   if live < lk else None)
            got = fa.cross_attention_padded(q, k, v, kv_len=kvl)
            want = fa.attention_plain(q, k, v, kv_len=kvl)
            err = compare(f"cross_attention_bf16 animate{tag} one-shot "
                          f"max over {live} keys", got, want,
                          atol=2.0 ** -8 * float(v[:, :live].float().abs()
                                                 .max()),
                          rtol=2.0 ** -7, why=ONE_SHOT_WHY)
            del want
            ms = cuda_time(lambda: fa.cross_attention_padded(
                q, k, v, kv_len=kvl), 10)
            plain_ms = cuda_time(lambda: fa.attention_plain(
                q, k, v, kv_len=kvl), 1)
            qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
            lib_ms = cuda_time(lambda: F.scaled_dot_product_attention(
                qs, ks[:, :, :live], vs[:, :, :live],
                scale=1.0 / fa.LOG2E), 10)
            record(f"cross_attention_bf16_animate{tag}",
                   "cross_attention_bf16", src,
                   "univid_tpu/kernels/flash_attention.py:355", err, ms,
                   plain_ms, 4 * n * l * live * d,
                   nbytes(q, got, k[:, :live], v[:, :live]), lib_ms,
                   H100_BF16_FLOPS,
                   {"q": [1, l, n, d], "kv": [1, lk, n, d], "kv_len": live})
            del k, v, got, qs, ks, vs
        del q
        torch.cuda.empty_cache()

        # ---- the face adapter's fp32 call over 5 motion tokens -------------
        frames, s = ANIMATE_GRID[0], ANIMATE_GRID[1] * ANIMATE_GRID[2]
        lq, lk, live = -(-s // fa.TILE) * fa.TILE, fa.TILE, 5
        q = fa._fold(qk_normed((frames, lq, n, d), gen, torch.float32),
                     d ** -0.5)
        k = qk_normed((frames, lk, n, d), gen, torch.float32)
        v = torch.randn((frames, lk, n, d), generator=gen, device="cuda")
        k[:, live:], v[:, live:] = 50.0, 50.0
        kv = torch.full((frames,), live, dtype=torch.int32, device="cuda")
        got = fa._flash_cuda(q, k, v, kv, None, None)
        want = fa.attention_plain(q, k, v, kv_len=kv)
        err = compare("flash_attention_f32_sm90 animate face adapter, 5 "
                      "keys, kv_len", got, want, atol=1e-5, rtol=1e-4,
                      why=F32_D128_WHY)
        del want
        kv0 = kv.clone()
        kv0[3] = 0
        got0 = fa._flash_cuda(q, k, v, kv0, None, None)
        zero_ok = (float(got0[3].abs().max()) == 0.0
                   and bool(torch.equal(got0[:3], got[:3])))
        log(json.dumps({"check": "flash_attention_f32_sm90 animate face: "
                        "a kv_len = 0 row exactly 0, the others unchanged",
                        "ok": zero_ok}))
        if not zero_ok:
            fail("flash_attention_f32_sm90: the animate face call's kv_len "
                 "= 0 row is not exactly 0")
        del got0
        ms = cuda_time(lambda: fa._flash_cuda(q, k, v, kv, None, None), 5)
        plain_ms = cuda_time(lambda: fa.attention_plain(q, k, v, kv_len=kv),
                             1)
        qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = cuda_time(lambda: F.scaled_dot_product_attention(
            qs, ks[:, :, :live], vs[:, :, :live], scale=1.0 / fa.LOG2E), 5)
        # the work: 1,560 live rows a frame over 5 keys (the 6x form of the
        # fp32 products at the bf16 rate), q read and o written in fp32
        record("flash_attention_f32_sm90_animate_face",
               "flash_attention_f32_sm90",
               "univid_tpu_torch/kernels/csrc/flash_attention_f32_sm90.cu",
               "univid_tpu/kernels/flash_attention.py:44", err, ms, plain_ms,
               6 * 4 * frames * n * s * live * d,
               2 * frames * s * n * d * 4 + 2 * frames * live * n * d * 4,
               lib_ms, H100_BF16_FLOPS,
               {"q": [frames, lq, n, d], "kv": [frames, lk, n, d],
                "kv_len": live, "live_rows": s})
        del q, k, v, got, qs, ks, vs
    torch.cuda.empty_cache()
    return records


def _small_animate():
    """A small d=128 animate model on the CPU from seeds: hidden 256, 2
    heads, 10 layers (face adapters after blocks 0 and 5), bf16 with its
    fp32 islands, its zero head redrawn and its qk gains in [0.5, 1.5]; the
    tiny-animate VAE (fp32), CLIP tower (d=8, bf16) and a tiny UMT5 (dim
    64, fp32): (cfg, model, vae_cfg, vae, clip_cfg, clip, text encoder)."""
    import dataclasses
    import types

    import torch

    from univid_tpu_torch.core.config import ANIMATE_CONFIGS, T5Config
    from univid_tpu_torch.models.wan.animate import ClipVision, WanAnimate
    from univid_tpu_torch.models.wan.vae_api import WanVAE
    from univid_tpu_torch.pipelines.encoders import WanTextEncoder

    tiny, vae_cfg, clip_cfg = ANIMATE_CONFIGS["tiny-animate"]()
    cfg = dataclasses.replace(tiny, dim=256, ffn_dim=512, num_heads=2,
                              num_layers=10, text_dim=64, text_len=32,
                              freq_dim=32)

    def gen(i):
        return torch.Generator().manual_seed(2400 + i)

    g = gen(0)
    model = WanAnimate(cfg, dtype=torch.bfloat16, device="cpu", gen=g)
    with torch.no_grad():
        model.head.head.w.normal_(0.0, 0.05, generator=g)
        for blk in model.blocks:
            for p in (blk.self_attn.norm_q, blk.self_attn.norm_k,
                      blk.cross_attn.norm_q, blk.cross_attn.norm_k,
                      blk.cross_attn.norm_k_img):
                p.uniform_(0.5, 1.5, generator=g)
    t5 = types.SimpleNamespace(t5=T5Config(
        vocab_size=512, dim=64, dim_attn=64, dim_ffn=128, num_heads=4,
        num_layers=2, text_len=32))
    return (cfg, model, vae_cfg,
            WanVAE(vae_cfg, dtype=torch.float32, device="cpu", gen=gen(1)),
            clip_cfg, ClipVision(clip_cfg, dtype=torch.bfloat16,
                                 device="cpu", gen=gen(2)),
            WanTextEncoder.random_init(t5, device="cpu", gen=gen(3)))


class _LatentRecorder:
    """The final latent of each clip (what pipelines.animate hands to
    vae_decode), while the block runs."""

    def __enter__(self):
        from univid_tpu_torch.pipelines import animate as tpa

        self.latents, self._tpa, self._fn = [], tpa, tpa.vae_decode

        def decode(vae, z, *a, **kw):
            self.latents.append(z.float().cpu())
            return self._fn(vae, z, *a, **kw)

        tpa.vae_decode = decode
        return self

    def __exit__(self, *exc):
        self._tpa.vae_decode = self._fn


def small_animate_parity():
    """The small d=128 animate pipeline (`_small_animate`) on the card
    against the same on the CPU, bf16 policy, 128x128 frames (8 x 8
    latents, 48 tokens a clip), 9 frames in clips of 5 (two clips with
    refert_num 1), 2 UniPC steps at guidance 1.5 (two forwards a step, the
    second with the face blanked), the same noise: plain animation, replace
    mode, then replace mode with a relighting LoRA merged (rank 4 over two
    sites). Each: every clip's latent and the video within 3e-2 rel. L2,
    the card's launches (per forward 10 self-attention, 20 cross-attention,
    2 fp32 face calls with their 3 split pre-passes each, kernel A's two
    modes 10 each; the d=16 VAE and d=8 CLIP on the reference route),
    none at d=128 on the reference route."""
    import copy

    import numpy as np
    import torch

    from univid_tpu_torch.core.config import DEFAULT_NEG_PROMPT
    from univid_tpu_torch.core.dtypes import DEFAULT_POLICY
    from univid_tpu_torch.pipelines.animate import WanAnimatePipeline

    cfg, model, vae_cfg, vae, clip_cfg, clip, text_enc = _small_animate()
    rng = np.random.default_rng(2410)
    t_real, hw, steps = 9, 128, 2
    cond = rng.uniform(-1, 1, (t_real, hw, hw, 3)).astype(np.float32)
    face = rng.uniform(-1, 1, (t_real, 16, 16, 3)).astype(np.float32)
    ref = rng.uniform(-1, 1, (hw, hw, 3)).astype(np.float32)
    bg = rng.uniform(-1, 1, (t_real, hw, hw, 3)).astype(np.float32)
    mask = (rng.random((t_real, hw, hw)) > 0.5).astype(np.float32)
    ctx, nctx = text_enc([ANIMATE_PROMPT, DEFAULT_NEG_PROMPT])
    noise = [torch.randn((1, 3, 8, 8, vae_cfg.z_dim),
                         generator=torch.Generator().manual_seed(2411 + i))
             for i in range(2)]
    lora = {"sites": {site: {
        "a": torch.randn((cfg.num_layers, cfg.dim, 4),
                         generator=torch.Generator().manual_seed(2413))
        / cfg.dim ** 0.5,
        "b": torch.randn((cfg.num_layers, 4, cfg.dim),
                         generator=torch.Generator().manual_seed(2414)) * 0.1,
        "mask": (torch.arange(cfg.num_layers) % 2 == 0).float()}
        for site in ("self_attn/q", "cross_attn/v")}, "rank": 4,
        "alpha": 8.0}
    per_fwd = {"flash_attention_bf16": 10, "cross_attention_bf16": 20,
               "flash_attention_f32_sm90": 2, "split_bf16x3": 6,
               "qk_norm_rope_bf16": 10, "qk_norm_bf16": 10}
    n_fwd = 2 * steps * 2   # CFG x steps x clips
    for case, replace, relight in (("animate", False, False),
                                   ("replace", True, False),
                                   ("relight", True, True)):
        outs = {}
        for dev in ("cuda", "cpu"):
            lo = None
            if relight:
                lo = {"sites": {s: {k: t.to(dev) for k, t in p.items()}
                                for s, p in lora["sites"].items()},
                      "rank": 4, "alpha": 8.0}
            pipe = WanAnimatePipeline(
                cfg, copy.deepcopy(model).to(dev), vae_cfg,
                copy.deepcopy(vae).to(dev), clip_cfg=clip_cfg,
                clip=copy.deepcopy(clip).to(dev), policy=DEFAULT_POLICY,
                relight_lora=lo)
            _reset_counts()
            with _RefRouteCount() as refc, _LatentRecorder() as rec:
                video = pipe.generate(
                    ctx.to(dev), nctx.to(dev), cond_video=cond,
                    face_video=face, ref_image=ref,
                    bg_video=bg if replace else None,
                    mask_video=mask if replace else None, clip_len=5,
                    refert_num=1, sampling_steps=steps, guide_scale=1.5,
                    sample_solver="unipc", seed=0, noise=noise)
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = {k: v for k, v in _all_counts().items() if v}
                ref_by_d = dict(refc.by_d)
                check_impl(f"small animate {case}", 30 * n_fwd)
            outs[dev] = (torch.cat(rec.latents), video.float().cpu())
            del pipe
        want = {k: v * n_fwd for k, v in per_fwd.items()}
        r = {"check": f"small animate pipeline card vs CPU, {case}",
             "latent_rel_l2": rel_l2(outs["cuda"][0], outs["cpu"][0]),
             "video_rel_l2": rel_l2(outs["cuda"][1], outs["cpu"][1]),
             "limit": 3e-2, "launches": launches, "expected": want,
             "reference_route_calls_by_head_dim": ref_by_d,
             "why": "the bf16 policy's bound: cuBLAS and the CPU round each "
                    "GEMM at other points, over 10 blocks x 2 steps x 2 "
                    "forwards x 2 clips"}
        r["ok"] = (r["latent_rel_l2"] < 3e-2 and r["video_rel_l2"] < 3e-2
                   and launches == want and 128 not in ref_by_d
                   and tuple(outs["cuda"][1].shape) == (t_real, hw, hw, 3)
                   and bool(torch.isfinite(outs["cuda"][1]).all()))
        log(json.dumps(r))
        if not r["ok"]:
            fail(f"the small animate pipeline ({case}) on the card disagrees "
                 "with the CPU or missed a kernel")


def write_animate_src(root):
    """The preprocess output dir of the CLI run: src_pose.mp4 (77 frames of
    832x480), src_face.mp4 (77 face crops of 512x512), src_ref.png
    (832x480), smooth seeded blocks; seconds to write."""
    import os

    import numpy as np
    from PIL import Image

    from univid_tpu_torch.data.video_io import save_video

    t0 = time.perf_counter()
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(2420)

    def blocks(t, h, w, side=32):
        base = rng.integers(0, 256, (t, -(-h // side), -(-w // side), 3),
                            dtype=np.uint8)
        return np.kron(base, np.ones((1, side, side, 1), np.uint8)
                       )[:, :h, :w]

    save_video(blocks(ANIMATE_FRAMES, ANIMATE_H, ANIMATE_W),
               os.path.join(root, "src_pose.mp4"), fps=30)
    save_video(blocks(ANIMATE_FRAMES, 512, 512),
               os.path.join(root, "src_face.mp4"), fps=30)
    Image.fromarray(blocks(1, ANIMATE_H, ANIMATE_W)[0]).save(
        os.path.join(root, "src_ref.png"))
    return time.perf_counter() - t0


class _AnimateRecorder:
    """Instrumentation of the animate CLI run: the pipeline it builds (kept
    for the 720p call) and the video generate returns; a CUDA event pair
    around each DiT forward and each motion-encoder call; the last forward
    run under torch.profiler (`profile_call`); the cross kernel's calls by
    kv length (text 512, image 320)."""

    def __init__(self, profile_at):
        self.profile_at, self.pipe, self.video = profile_at, None, None
        self.fwd, self.motion, self.cross_by_lk, self.profile = \
            [], [], {}, None

    def __enter__(self):
        import torch

        from univid_tpu_torch.kernels import flash_attention as fa
        from univid_tpu_torch.models.wan.animate import model as am
        from univid_tpu_torch.pipelines import animate as tpa

        self._saved = [(tpa, "wan_animate_forward"), (am, "get_motion"),
                       (fa, "cross_attention_padded"),
                       (tpa.WanAnimatePipeline, "__init__"),
                       (tpa.WanAnimatePipeline, "generate")]
        self._orig = [getattr(o, n) for o, n in self._saved]
        fwd, motion, cross, init, gen = self._orig

        def timed(events, fn):
            def run(*a, **kw):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                out = fn(*a, **kw)
                ev[1].record()
                events.append(ev)
                return out
            return run

        timed_fwd = timed(self.fwd, fwd)

        def forward(*a, **kw):
            if len(self.fwd) + 1 == self.profile_at:
                out, self.profile = profile_call(
                    lambda: fwd(*a, **kw), families={
                        "qk_prepass_ms": ("qk_norm_rope",),
                        "convolutions_ms": ("conv", "fprop", "winograd",
                                            "cudnn")})
                self.fwd.append(None)
                return out
            return timed_fwd(*a, **kw)

        def cross_count(q, k, *a, **kw):
            lk = int(k.shape[1])
            self.cross_by_lk[lk] = self.cross_by_lk.get(lk, 0) + 1
            return cross(q, k, *a, **kw)

        def keep(pipe, *a, **kw):
            init(pipe, *a, **kw)
            self.pipe = pipe

        def generate(pipe, *a, **kw):
            self.video = gen(pipe, *a, **kw)
            return self.video

        tpa.wan_animate_forward = forward
        am.get_motion = timed(self.motion, motion)
        fa.cross_attention_padded = cross_count
        tpa.WanAnimatePipeline.__init__ = keep
        tpa.WanAnimatePipeline.generate = generate
        return self

    def __exit__(self, *exc):
        for (o, n), f in zip(self._saved, self._orig):
            setattr(o, n, f)

    def seconds(self, events):
        import torch
        torch.cuda.synchronize()
        return [a.elapsed_time(b) / 1e3 for a, b in
                (e for e in events if e is not None)]


def animate_main_path(output_dir):
    """WanAnimate through the port's CLI at full width and depth on random
    weights from seeds: `--mode animate --model animate-14B --mock_weights`
    (the 40-block dim-5120 DiT with 8 face adapters and the LIA motion
    encoder, bf16 with fp32 islands; the Wan2.1 VAE in fp32; CLIP ViT-H in
    bf16; the JAX CLI's mock UMT5, encoded and freed first) over a
    src_root_path written here (77 frames of 832x480, 512x512 faces): one
    clip, ANIMATE_STEPS steps at the default guidance 5.0 (two forwards a
    step), from zero counts. Checks a 77-frame 480x832 mp4, a finite video,
    the launches (40 a forward of self-attention and of kernel A's two
    modes, 80 cross-attention calls, 160 over the 512 text keys and 160
    over the 320 padded image keys in the run, 8 fp32 face calls with 24
    split pre-passes, 61 d=384 VAE calls: 20 + 20 encoded chunks of the
    pose and overlap videos, the reference frame, 20 decoded latent
    frames), all bf16 forwards on the sm90 kernel and none at d=128 on the
    reference route; logs the phase seconds and peaks, s/forward, the
    motion encoder's seconds, and the last forward profiled (attention /
    GEMM / convolutions / other, idle share). Returns (launch counts, the
    pipeline, kept for `animate_dit_720p`)."""
    import gc
    import os

    import torch

    from univid_tpu_torch.cli import inference
    from univid_tpu_torch.data.video_io import read_video_frames
    from univid_tpu_torch.kernels import flash_attention as fa

    gc.collect()
    torch.cuda.empty_cache()
    root = os.path.join(output_dir, "animate_src")
    write_s = write_animate_src(root)
    n_fwd = 2 * ANIMATE_STEPS
    _reset_counts()
    peaks = _PhasePeaks()
    t0 = time.perf_counter()
    try:
        with _RefRouteCount() as refc, _AnimateRecorder(n_fwd) as rec:
            meta = inference.main([
                "--mode", "animate", "--model", "animate-14B",
                "--mock_weights", "--src_root_path", root, "--steps",
                str(ANIMATE_STEPS), "--prompt", ANIMATE_PROMPT, "--seed",
                "0", "--output_dir", output_dir])[0]
    finally:
        peaks.close()
    wall = time.perf_counter() - t0
    launches = _all_counts()
    f32_by_d = dict(fa.F32_LAUNCHES_BY_D)
    fwd_s, motion_s = rec.seconds(rec.fwd), rec.seconds(rec.motion)
    n_vae = 20 + 1 + 20 + 20
    want = dict(dict.fromkeys(launches, 0), **{
        "flash_attention_bf16": 40 * n_fwd, "qk_norm_rope_bf16": 40 * n_fwd,
        "qk_norm_bf16": 40 * n_fwd, "cross_attention_bf16": 80 * n_fwd,
        "flash_attention_f32_sm90": 8 * n_fwd,
        "split_bf16x3": 24 * n_fwd, "flash_attention_f32": n_vae})
    video = rec.video
    fr = read_video_frames(meta["video_path"])
    r = {"phase": "animate_main_path", "model": "animate-14B (random "
         "weights)", "parameters": sum(p.numel() for p in
                                      rec.pipe.model.parameters()),
         "resolution": f"{ANIMATE_W}x{ANIMATE_H}x{ANIMATE_FRAMES}",
         "steps": ANIMATE_STEPS, "guidance": meta["guidance"],
         "seconds": wall, "src_write_s": write_s,
         "generation_time_s": meta["generation_time_s"],
         "phase_times_s": meta["phase_times_s"],
         "s_per_forward": fwd_s,
         "s_per_step": [a + b for a, b in zip(fwd_s[0::2], fwd_s[1::2])],
         "motion_encoder_s": motion_s,
         "peak_memory_gb_by_phase": peaks.peaks,
         "allocated_gb_at_phase_start": peaks.at_start,
         "launches": {k: v for k, v in launches.items() if v},
         "cross_calls_by_kv_length": rec.cross_by_lk,
         "f32_launches_by_d": f32_by_d,
         "reference_route_calls_by_head_dim": refc.by_d,
         "frames": len(fr), "frame_shape": list(fr[0].shape) if fr else None,
         "video_finite": bool(torch.isfinite(video).all())}
    log(json.dumps(r))
    log(json.dumps({"profile": "animate-14B DiT forward, 832x480x77 (32,760 "
                    "tokens), the last of the CLI run", **rec.profile}))
    if launches != want or f32_by_d != {384: n_vae, 640: 0, 1024: 0} \
            or rec.cross_by_lk != {512: 40 * n_fwd, 320: 40 * n_fwd} \
            or 128 in refc.by_d:
        fail(f"animate main path: launches {r['launches']} {f32_by_d} "
             f"{rec.cross_by_lk} (reference route {refc.by_d}) != "
             f"{ {k: v for k, v in want.items() if v} }")
    check_impl("animate main path", 120 * n_fwd)
    if len(fr) != ANIMATE_FRAMES or tuple(fr[0].shape) != (
            ANIMATE_H, ANIMATE_W, 3) or not r["video_finite"] \
            or tuple(video.shape) != (ANIMATE_FRAMES, ANIMATE_H, ANIMATE_W,
                                      3):
        fail(f"animate main path: {len(fr)} frames of "
             f"{fr[0].shape if fr else None}, finite {r['video_finite']}")
    if max(peaks.peaks.values()) >= 80.0:
        fail(f"animate main path: peak memory {peaks.peaks} GB")
    pipe = rec.pipe
    del rec, video
    return launches, pipe


def animate_dit_720p(pipe):
    """One bare forward of the CLI run's animate-14B DiT at 1280x720x77 (21
    x 45 x 80 = 75,600 tokens; 77 faces of 512x512), timed to a
    synchronised end with its peak memory and launches (40 self-attention,
    80 cross, 8 fp32 face calls), finite and of the latent's shape; then
    the self-attention and the face call alone at this shape ([1, 75648,
    40, 128] over 75,600 keys, running max, beside SDPA over the live
    keys; q [21, 3648, 40, 128] fp32 over 5 keys padded to 64), CUDA
    events, beside their bounds."""
    import gc

    import torch

    from univid_tpu_torch.core.dtypes import DEFAULT_POLICY
    from univid_tpu_torch.kernels import flash_attention as fa
    from univid_tpu_torch.models.wan.animate import wan_animate_forward

    model, cfg = pipe.model, pipe.cfg
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2430)
    f, h, w = ANIMATE_GRID_720P
    lat = (f, h * 2, w * 2)
    x = torch.randn((1,) + lat + (cfg.in_dim,), generator=gen, device=dev)
    pose = torch.randn((1, f - 1) + lat[1:] + (cfg.vae_z_dim,),
                       generator=gen, device=dev)
    ctx = torch.randn((1, cfg.text_len, cfg.text_dim), generator=gen,
                      device=dev) * 0.5
    clip_fea = torch.randn((1, cfg.clip_tokens, cfg.clip_dim), generator=gen,
                           device=dev)
    face = torch.rand((1, ANIMATE_FRAMES, 512, 512, 3), generator=gen,
                      device=dev) * 2 - 1
    t = torch.full((1,), 999.0, device=dev)
    gc.collect()
    torch.cuda.empty_cache()
    _reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = wan_animate_forward(model, x, t, ctx, clip_fea, pose, face,
                                  policy=DEFAULT_POLICY)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    want = {"flash_attention_bf16": 40, "cross_attention_bf16": 80,
            "flash_attention_f32_sm90": 8}
    got = {k: fa.LAUNCHES[k] for k in want}
    r = {"phase": "animate_dit_720p", "model": "animate-14B",
         "tokens": f * h * w, "seconds": secs,
         "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
         "launches": got, "finite": bool(torch.isfinite(out).all()),
         "shape": list(out.shape)}
    del out, x, pose, face
    torch.cuda.empty_cache()

    # the two calls alone at this shape
    n, d, bf = cfg.num_heads, cfg.head_dim, torch.bfloat16
    kv_real = f * h * w
    l = -(-kv_real // fa.TILE) * fa.TILE
    with torch.no_grad():
        q = fa._fold(qk_normed((1, l, n, d), gen, bf), d ** -0.5)
        k = qk_normed((1, l, n, d), gen, bf)
        v = torch.randn((1, l, n, d), generator=gen, device=dev).to(bf)
        kv = torch.full((1,), kv_real, dtype=torch.int32, device=dev)
        ms = cuda_time(lambda: fa._flash_cuda(q, k, v, kv, None, None), 2)
        bms, by = bound_ms(4 * n * l * kv_real * d, nbytes(q, k, v, q),
                           H100_BF16_FLOPS)
        # the library's call on the same folded q over the live keys
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k[:, :kv_real],
                                                  v[:, :kv_real]))
        lib_ms = cuda_time(lambda: torch.nn.functional
                           .scaled_dot_product_attention(
                               qt, kt, vt, scale=1.0 / fa.LOG2E), 2)
        r["self_attention"] = {"q": [1, l, n, d], "kv_len": kv_real,
                               "ms": ms, "bound_ms": bms, "bound_by": by,
                               "library_ms": lib_ms}
        del q, k, v, qt, kt, vt
        s = h * w
        lq = -(-s // fa.TILE) * fa.TILE
        q = fa._fold(qk_normed((f, lq, n, d), gen, torch.float32),
                     d ** -0.5)
        k = qk_normed((f, fa.TILE, n, d), gen, torch.float32)
        v = torch.randn((f, fa.TILE, n, d), generator=gen, device=dev)
        kv = torch.full((f,), 5, dtype=torch.int32, device=dev)
        ms = cuda_time(lambda: fa._flash_cuda(q, k, v, kv, None, None), 3)
        bms, by = bound_ms(6 * 4 * f * n * s * 5 * d,
                           2 * f * s * n * d * 4 + 2 * f * 5 * n * d * 4,
                           H100_BF16_FLOPS)
        r["face_call"] = {"q": [f, lq, n, d], "kv_len": 5, "ms": ms,
                          "bound_ms": bms, "bound_by": by}
        del q, k, v
    log(json.dumps(r))
    if got != want or not r["finite"] \
            or r["shape"] != [1, *lat, cfg.out_dim]:
        fail(f"animate-14B 720p forward: launches {got} != {want}, or its "
             "output is not finite or not the latent's shape")
    if r["peak_memory_gb"] >= 80.0:
        fail(f"animate-14B 720p forward: peak {r['peak_memory_gb']:.1f} GB")
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# BAGEL packed training (the fifth slice)
# ---------------------------------------------------------------------------

PACK_TOKENS = 4096   # the full-width pack; the reference packs 36,864
# sample sizes of the pack's four kinds (VLM, T2I, edit, text-only): ViT
# image sides, text lengths, VAE latent sides (tokens per side)
TRAIN_SIZES = dict(vit_a=448, question_a=40, answer_a=160, prompt_b=64,
                   latent_b=32, instruction_c=48, vit_c=224, latent_c=16,
                   text_d=900)
SMALL_TRAIN_SIZES = dict(vit_a=56, question_a=8, answer_a=16, prompt_b=8,
                         latent_b=8, instruction_c=6, vit_c=28, latent_c=4,
                         text_d=64)


def bagel_train_batch(cfg, sizes, seed, max_tokens):
    """One pack of the four sample kinds of BAGEL's training data, built by
    the port's PackedDataset.pack_sequence / to_batch from seeded arrays:
    A, VLM: a ViT image (full), a question and a CE-loss answer; B, T2I: a
    prompt and a noised VAE latent (noise, MSE); C, edit: an instruction, a
    ViT image, a clean VAE condition (timestep -inf, full) and a noised VAE
    target; D, text-only: a causal text with CE loss. Images in [-1, 1],
    latents [side, side, patch_latent_dim] normal, token ids uniform below
    the special ids; the flow timesteps from np.random.seed(seed), as the
    packer draws them. Returns (batch, kinds' token counts)."""
    import numpy as np

    from univid_tpu_torch.data.packed_dataset import (PackedDataConfig,
                                                      PackedDataset)

    rng = np.random.default_rng(seed)
    np.random.seed(seed)

    def ids(n):
        return rng.integers(0, cfg.start_of_image - 4, n).tolist()

    def image(side):
        return rng.uniform(-1, 1, (side, side, 3)).astype(np.float32)

    def latent(side):
        return rng.standard_normal(
            (side, side, cfg.patch_latent_dim)).astype(np.float32)

    def item(kind, loss):
        return {"type": kind, "enable_cfg": 0, "loss": loss,
                "special_token_loss": 0}

    z = sizes
    samples = [
        {"sequence_plan": [item("vit_image", 0), item("text", 0),
                           item("text", 1)],
         "text_ids_list": [ids(z["question_a"]), ids(z["answer_a"])],
         "image_list": [image(z["vit_a"])]},
        {"sequence_plan": [item("text", 0), item("vae_image", 1)],
         "text_ids_list": [ids(z["prompt_b"])],
         "image_list": [latent(z["latent_b"])]},
        {"sequence_plan": [item("text", 0), item("vit_image", 0),
                           item("vae_image", 0), item("vae_image", 1)],
         "text_ids_list": [ids(z["instruction_c"])],
         "image_list": [image(z["vit_c"]), latent(z["latent_c"]),
                        latent(z["latent_c"])]},
        {"sequence_plan": [item("text", 1)],
         "text_ids_list": [ids(z["text_d"])], "image_list": []},
    ]
    ds = PackedDataset([(lambda: iter([]), 1.0)], data_config=PackedDataConfig(
        vit_patch_size=cfg.vit_patch_size,
        max_num_patch_per_side=cfg.vit_max_num_patch_per_side,
        max_latent_size=cfg.max_latent_size,
        latent_channel=cfg.latent_channel, bos_token_id=cfg.bos_token_id,
        eos_token_id=cfg.eos_token_id, start_of_image=cfg.start_of_image,
        end_of_image=cfg.end_of_image), max_num_tokens=max_tokens)
    st = ds._fresh_status()
    kinds = []
    for sample in samples:
        before = st["curr"]
        st = ds.pack_sequence(sample, st)
        kinds.append(st["curr"] - before)
    if st["curr"] > max_tokens:
        fail(f"the pack holds {st['curr']} tokens > {max_tokens}")
    return ds.to_batch(st, []), kinds


def _train_loss(out):
    """sum of the MSE terms (zero outside mse_mask) + the weighted CE."""
    return out["mse"].sum() + (out["ce"] * out["ce_weights"]).sum()


def _sdpa_masked_ms(qs, k, v, allowed, do=None):
    """SDPA with the materialized boolean mask (True = attend) on the same
    folded inputs, [B, L, N, D] -> its forward ms, or with `do` its
    backward's (a yardstick: rows with no live key come out NaN there)."""
    import torch
    import torch.nn.functional as F

    from univid_tpu_torch.kernels import flash_attention as fa

    qt, kt, vt = (x.transpose(1, 2) for x in (qs, k, v))
    if do is None:
        with torch.no_grad():
            return cuda_time(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=allowed, scale=1.0 / fa.LOG2E), 3)
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
    with torch.enable_grad():   # the callers hold no_grad
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=allowed,
                                             scale=1.0 / fa.LOG2E)
    dog = do.transpose(1, 2)
    ms = cuda_time(lambda: torch.autograd.grad(out, (qg, kg, vg), dog,
                                               retain_graph=True), 3)
    del out, qg, kg, vg
    return ms



def _masked_forward_check(tag, got, want, v_max, allowed):
    """The masked forward's output against its plain version: elementwise
    |got - want| <= 1e-3 + 2^-8 max|v| + 2^-7 |want| and rel. L2 < 1e-2.
    The kernel rounds each p to bf16 against its running max, the plain
    version against the row's final max: the two roundings of a p differ
    by up to 2^-8 relative, which moves the output by up to 2^-8 max|v|
    (max over the live keys' values) and does not average out in a row
    with few live keys. Logs how many elements the narrower bound 1e-3 +
    2^-7 |want| would reject, and the live keys of the worst one's row."""
    import torch

    err = (got.float() - want.float()).abs()
    narrow = err > 1e-3 + 2.0 ** -7 * want.float().abs()
    worst = torch.nonzero(err == err.max())[0].tolist()   # [b, row, head, d]
    log(json.dumps({
        "check": f"{tag}, rounding", "narrow_bound_violations":
        int(narrow.sum()), "elements": err.numel(),
        "worst_row_live_keys": int(allowed[worst[0], 0, worst[1]].sum()),
        "max_abs_err": float(err.max())}))
    e = compare(tag, got, want, atol=1e-3 + 2.0 ** -8 * v_max,
                rtol=2.0 ** -7,
                why="1e-3 for the fp32 summation order and the approximate "
                    "exp2; 2^-8 max|v|: p rounds to bf16 against the running "
                    "max in the kernel and against the row max in the plain "
                    "version; one bf16 ulp of the output")
    check_grad(f"{tag} rel_l2", got, want, 1e-2,
               "bf16 roundings of p and of the output")
    return e


def _mask_case(tag, q, k, v, do, kv_len, masks, live_pairs, allowed,
               no_lse=True, pad_rows=None, live_keys=None):
    """Hold the masked kernels against their plain versions on one case:
    the forward without lse (segments / packed), with lse, the dq and the
    dk/dv kernel (from the plain residuals); time each with CUDA events
    beside its plain version, SDPA with the materialized mask and the
    bound of the case's live (row, key) pairs. pad_rows: rows with no live
    key (bool [B, Lq]), which must come out exactly 0 with lse +1e30;
    live_keys: the keys that some real row sees (bool [B, Lk]; default
    all), whose values bound the forward's rounding difference.
    Returns {kind: record fields}."""
    import torch

    from univid_tpu_torch.kernels import flash_attention as fa

    d = q.shape[-1]
    sc = d ** -0.5
    qs = fa._fold(q, sc)
    v_live = v if live_keys is None else v[live_keys]
    v_max = float(v_live.float().abs().max())
    bwd_why = ("p and dS round to bf16 at the same points on both sides; an "
               "fp32 difference of ~1e-6 flips some roundings by one bf16 "
               "step (2^-8 relative); the output rounds once")
    out = {}
    n_rows = nbytes(qs)
    kvb = nbytes(k, v)
    codes_b = sum(nbytes(t) for t in (masks.get("q_segments"),
                                      masks.get("kv_segments"))
                  if t is not None)
    flops = 2.0 * live_pairs * q.shape[2] * d   # one product, live pairs
    seg = ("packed" if masks.get("packed_mode") else "segments") \
        if "q_segments" in masks else None
    lse_buf = torch.empty((q.shape[0], q.shape[2], q.shape[1]),
                          device=q.device)

    def timed(new, lse):
        """The call's ms; a segment, packed or causal forward in turns with
        the mma.sync kernel it replaced (`sm90_vs_mma_sync` line): (ms, its
        ms or None)."""
        if seg is None and not masks.get("causal"):
            return cuda_time(new, 10), None
        old = (dict(causal=True, q_offsets=masks.get("q_offsets"))
               if seg is None else
               dict(q_segments=masks["q_segments"],
                    kv_segments=masks["kv_segments"], seg=seg))
        ms, old_ms = ab_time(new, lambda: fa._launch_bf16(
            qs, k, v, kv_len, None, fa._MODE_RUNNING, lse=lse, **old), 10)
        log_ab(f"{tag} {'forward with lse' if lse is not None else 'forward'}",
               ms, old_ms)
        return ms, old_ms

    with torch.no_grad():
        if no_lse:
            got = fa._flash_cuda(qs, k, v, kv_len, None, None, **masks)
            want = fa.attention_plain(qs, k, v, kv_len=kv_len, **masks)
            err = _masked_forward_check(f"{tag} forward", got, want, v_max,
                                        allowed)
            if pad_rows is not None and float(got[pad_rows].abs().max()) != 0:
                fail(f"{tag}: pad rows of the forward are not 0")
            ms, old_ms = timed(lambda: fa._flash_cuda(
                qs, k, v, kv_len, None, None, **masks), None)
            out["fwd"] = dict(
                max_abs_err=err, ms=ms, mma_sync_ms=old_ms,
                plain_ms=cuda_time(lambda: fa.attention_plain(
                    qs, k, v, kv_len=kv_len, **masks), 1),
                library_ms=_sdpa_masked_ms(qs, k, v, allowed),
                bound=bound_ms(2 * flops, 2 * n_rows + kvb + codes_b,
                               H100_BF16_FLOPS))
            del got, want
        o, lse = fa.flash_attention_fwd_folded(qs, k, v, kv_len=kv_len,
                                               **masks)
        o_p, lse_p = fa.attention_plain(qs, k, v, kv_len=kv_len,
                                        save_residuals=True, **masks)
        err = max(_masked_forward_check(f"{tag} forward with lse, output",
                                        o, o_p, v_max, allowed),
                  compare(f"{tag} forward with lse, lse", lse, lse_p,
                          atol=1e-3, rtol=0.0,
                          why="fp32 log2 of an fp32 row sum; summation "
                              "order and the approximate exp2"))
        if pad_rows is not None:
            lse_pad = lse.transpose(1, 2)[pad_rows]
            if (float(o[pad_rows].abs().max()) != 0.0
                    or not bool((lse_pad == 1e30).all())):
                fail(f"{tag}: pad rows are not 0 with lse +1e30")
        ms, old_ms = timed(lambda: fa.flash_attention_fwd_folded(
            qs, k, v, kv_len=kv_len, **masks), lse_buf)
        out["lse_fwd"] = dict(
            max_abs_err=err, ms=ms, mma_sync_ms=old_ms,
            plain_ms=cuda_time(lambda: fa.attention_plain(
                qs, k, v, kv_len=kv_len, save_residuals=True, **masks), 1),
            library_ms=_sdpa_masked_ms(qs, k, v, allowed),
            bound=bound_ms(2 * flops, 2 * n_rows + kvb + nbytes(lse)
                           + codes_b, H100_BF16_FLOPS))
        # the backward from the plain residuals: the one-pass sm90 kernel
        # (the path's: the tile-list pre-pass, then its walk) and the
        # mma.sync pair it replaced, against the plain version
        got = fa._launch_bwd_sm90(qs, k, v, o_p, lse_p, do, kv_len, sc,
                                  **masks)
        dq, delta = fa._bwd_dq_cuda(qs, k, v, o_p, lse_p, do, kv_len, sc,
                                    **masks)
        dk, dv = fa._bwd_dkv_cuda(qs, k, v, do, lse_p, delta, kv_len,
                                  **masks)
        want = fa._bwd_plain_folded(qs, k, v, o_p, lse_p, do, kv_len, sc,
                                    **masks)
        errs = {}
        for nm, g_new, g_pair, ref in zip(("dq", "dk", "dv"), got,
                                          (dq, dk, dv), want):
            for key, kind, g in (("bwd_sm90", "sm90", g_new),
                                 ("bwd_dq" if nm == "dq" else "bwd_dkv",
                                  "mma.sync pair", g_pair)):
                e = compare(f"{tag} backward {kind} {nm}", g, ref,
                            atol=2.0 ** -8 * float(ref.float().abs().max()),
                            rtol=2.0 ** -7, why=bwd_why)
                check_grad(f"{tag} backward {kind} {nm} rel_l2", g, ref,
                           1e-2, bwd_why)
                errs[key] = max(errs.get(key, 0.0), e)
        # rows that see no key: dq exactly 0; keys no row sees: dk, dv 0
        no_row = ~allowed.any(dim=2)[:, 0]          # [B, Lk]
        zeros = {"dead_keys": int(no_row.sum()),
                 "dk_dv_exact_zero": not any(bool(g[no_row].any())
                                             for g in got[1:])}
        if pad_rows is not None:
            zeros["pad_rows"] = int(pad_rows.sum())
            zeros["dq_exact_zero"] = not bool(got[0][pad_rows].any())
        log(json.dumps({"check": f"{tag} backward sm90: exact zeros",
                        **zeros, "ok": all(v_ for k_, v_ in zeros.items()
                                           if k_.endswith("zero"))}))
        if not all(v_ for k_, v_ in zeros.items() if k_.endswith("zero")):
            fail(f"{tag}: the sm90 backward's pad rows or dead keys are "
                 "not exactly 0")
        del want, got
        tl_rec = _bwd_tile_list_check(tag, qs, k.shape[1], kv_len, masks)

        def sm90():
            return fa._launch_bwd_sm90(qs, k, v, o_p, lse_p, do, kv_len, sc,
                                       **masks)

        pair = (lambda: fa._bwd_dq_cuda(qs, k, v, o_p, lse_p, do, kv_len, sc,
                                        **masks),
                lambda: fa._bwd_dkv_cuda(qs, k, v, do, lse_p, delta, kv_len,
                                         **masks))
        # in turns with the pair it replaced (dq, then dk/dv on the plain
        # residuals' delta), old, new, new, old: each kernel's own ms
        old1 = [cuda_time(f, 10) for f in pair]
        bwd_ms = (cuda_time(sm90, 10) + cuda_time(sm90, 10)) / 2
        dq_ms, dkv_ms = [(t_ + cuda_time(f, 10)) / 2
                         for t_, f in zip(old1, pair)]
        pair_ms = dq_ms + dkv_ms
        flops5 = 5 * flops   # 5 products over the live pairs
        sm90_bound = bound_ms(flops5, 4 * n_rows + 2 * kvb + nbytes(lse_p)
                              + codes_b, H100_BF16_FLOPS)
        log(json.dumps({"bwd_sm90_vs_mma_sync": f"{tag} backward",
                        "sm90_ms": bwd_ms, "mma_sync_pair_ms": pair_ms,
                        "speedup": pair_ms / bwd_ms,
                        "bound_ms": sm90_bound[0],
                        "share_of_bound": sm90_bound[0] / bwd_ms}))
        # two calls: each launch's device time (pre-pass, delta, main,
        # post-pass), the mean of two
        _, prof = profile_call(lambda: (sm90(), sm90()))
        kern_ms = [(t_["kernel"], t_["ms"] / t_["count"], t_["count"])
                   for t_ in prof["top_kernels"]]
        log(json.dumps({f"bwd_sm90_kernels {tag}": kern_ms}))
        plain_bwd = cuda_time(lambda: fa._bwd_plain_folded(
            qs, k, v, o_p, lse_p, do, kv_len, sc, **masks), 1, warmup=0)
        lib_bwd = _sdpa_masked_ms(qs, k, v, allowed, do)
        lse_b = nbytes(lse_p)
        out["bwd_sm90"] = dict(
            max_abs_err=errs["bwd_sm90"], ms=bwd_ms, mma_sync_ms=pair_ms,
            plain_ms=plain_bwd, library_ms=lib_bwd, bound=sm90_bound)
        out["bwd_tile_list"] = tl_rec
        out["bwd_dq"] = dict(
            max_abs_err=errs["bwd_dq"], ms=dq_ms, plain_ms=plain_bwd,
            library_ms=lib_bwd,
            bound=bound_ms(3 * flops, 4 * n_rows + kvb + 2 * lse_b + codes_b,
                           H100_BF16_FLOPS))
        out["bwd_dkv"] = dict(
            max_abs_err=errs["bwd_dkv"], ms=dkv_ms, plain_ms=plain_bwd,
            library_ms=lib_bwd,
            bound=bound_ms(4 * flops, 2 * n_rows + 2 * kvb + 2 * lse_b
                           + codes_b, H100_BF16_FLOPS))
    del qs, o, lse, o_p, lse_p, dq, dk, dv, delta, lse_buf
    torch.cuda.empty_cache()
    return out


def _bwd_tile_list_check(tag, qs, lk, kv_len, masks):
    """The backward's pre-pass (`bwd_tile_list`, 64 x 128 tiles, for each
    kv tile its q tiles)."""
    from univid_tpu_torch.kernels import flash_attention as fa

    b, lq = qs.shape[:2]
    return _tile_list_check(
        f"{tag} backward", lambda: fa.bwd_tile_list(qs, lk, kv_len, **masks),
        lambda: fa.bwd_tile_list_plain(b, lq, lk, qs.device, kv_len=kv_len,
                                       **masks),
        [masks[nm] for nm in ("q_segments", "kv_segments", "q_offsets")
         if masks.get(nm) is not None], "64 x 128")


# the kernels line's records of the masked modes: (kind, mode) -> (name,
# TPU kernel it replaces)
_MASK_RECORDS = {
    "fwd": ("flash_attention_bf16_{}", {
        "segments": "univid_tpu/kernels/flash_attention.py:191",
        "packed": "univid_tpu/kernels/flash_attention.py:198"}),
    "lse_fwd": ("flash_attention_bf16_lse_{}", {
        "segments": "univid_tpu/kernels/flash_attention.py:191",
        "packed": "univid_tpu/kernels/flash_attention.py:198",
        "causal": "univid_tpu/kernels/flash_attention.py:165"}),
    "bwd_dq": ("flash_attention_bwd_dq_bf16_{}", {
        m: "univid_tpu/kernels/flash_attention.py:831"
        for m in ("segments", "packed", "causal")}),
    "bwd_dkv": ("flash_attention_bwd_dkv_bf16_{}", {
        m: "univid_tpu/kernels/flash_attention.py:940"
        for m in ("segments", "packed", "causal")}),
    "bwd_sm90": ("flash_attention_bwd_bf16_sm90_{}", {
        m: "univid_tpu/kernels/flash_attention.py:1057"
        for m in ("segments", "packed", "causal")}),
}


def _records(mode, case):
    out = {}
    for kind, vals in case.items():
        if kind == "bwd_tile_list":   # the pre-pass: the caller's record
            continue
        name, reps = _MASK_RECORDS[kind]
        src = "univid_tpu_torch/kernels/csrc/" + (
            "flash_attention_bwd_sm90.cu" if kind == "bwd_sm90" else
            "flash_attention_bwd.cu" if "bwd" in kind else
            "flash_attention_causal_sm90.cu" if mode == "causal" else
            "flash_attention_sm90.cu")
        out[name.format(mode)] = dict(
            name=name.format(mode), route="cuda", source=src,
            replaces=reps[mode], max_abs_err=vals["max_abs_err"],
            ms=vals["ms"], plain_ms=vals["plain_ms"],
            bound_ms=vals["bound"][0], bound_by=vals["bound"][1],
            library_ms=vals["library_ms"])
        if vals.get("mma_sync_ms") is not None:
            out[name.format(mode)]["mma_sync_ms"] = vals["mma_sync_ms"]
    return out


def _tile_list_check(tag, run, plain, operands, tiles):
    """A tile-list pre-pass (`run()` -> (list, count)) against its plain
    version (`plain()`) on the same card tensors, exactly; logs the live
    share of the `tiles` tiles and of them the full ones. Returns its
    record fields (the bound: `operands` read once, the list and count
    written once)."""
    import torch

    lists, count = run()
    want, want_n = plain()
    ok = torch.equal(lists, want) and torch.equal(count, want_n)
    n_tiles = lists.shape[0] * lists.shape[1] * lists.shape[2]
    live = int(count.sum())
    full = int(((lists >= 0) & (lists % 2 == 1)).sum())
    log(json.dumps({"check": f"{tag}: tile list equals the plain list",
                    "tiles": tiles, "list_shape": list(lists.shape),
                    "live_tiles": live, "full_tiles": full,
                    "live_tile_share": live / n_tiles, "ok": ok}))
    if not ok:
        fail(f"{tag}: the pre-pass's tile list differs from the plain list")
    ms = cuda_time(run, 20)
    plain_ms = cuda_time(plain, 3)
    bms, by = bound_ms(0, nbytes(*operands, lists, count), H100_BF16_FLOPS)
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None)


def _fwd_tile_list_check(tag, qc, kc, kv_len, packed):
    """The forward's pre-pass (`mask_tile_list`, 128 x 128 tiles)."""
    from univid_tpu_torch.kernels import flash_attention as fa

    return _tile_list_check(
        tag, lambda: fa.mask_tile_list(qc, kc, kv_len, packed),
        lambda: fa.mask_tile_list_plain(qc, kc, kv_len, packed),
        (qc, kc), "128 x 128")


def _tile_lists_check(tag, b, lq, lk, kv_len, masks):
    """csrc/mask_tiles_sm90.cu (`tile_lists`: the forward's and the
    backward's list in one launch; the backward's alone in the causal
    mode) against the plain lists on the same card tensors, bit for bit:
    fails otherwise. Logs each list's live and full tiles. Returns (fwd,
    bwd)."""
    import torch

    from univid_tpu_torch.kernels import flash_attention as fa

    fwd, bwd = fa.tile_lists(b, lq, lk, "cuda", kv_len=kv_len, **masks)
    pairs = {"backward, 64 x 128": (bwd, fa.bwd_tile_list_plain(
        b, lq, lk, "cuda", kv_len=kv_len, **masks))}
    if masks.get("causal"):
        if fwd is not None:
            fail(f"{tag}: the causal mode has no forward list")
    else:
        pairs["forward, 128 x 128"] = (fwd, fa.mask_tile_list_plain(
            masks["q_segments"], masks["kv_segments"], kv_len,
            masks.get("packed_mode", False)))
    for name, ((lists, count), (want, want_n)) in pairs.items():
        ok = torch.equal(lists, want) and torch.equal(count, want_n)
        log(json.dumps({
            "check": f"{tag}: tile_lists' {name} list equals the plain list",
            "list_shape": list(lists.shape), "live_tiles": int(count.sum()),
            "full_tiles": int(((lists >= 0) & (lists % 2 == 1)).sum()),
            "ok": ok}))
        if not ok:
            fail(f"{tag}: tile_lists' {name} list differs from the plain "
                 "list")
    return fwd, bwd


def _runs_per_tile(codes, rows):
    """{runs: tiles} of the runs of equal codes in each `rows`-row tile of
    codes [B, L] (the new tile-list kernel's work a tile)."""
    import numpy as np

    c = codes.cpu().numpy()
    hist = {}
    for r in range(c.shape[0]):
        for i in range(0, c.shape[1], rows):
            t = c[r, i:i + rows]
            n = 1 + int((t[1:] != t[:-1]).sum())
            hist[n] = hist.get(n, 0) + 1
    return dict(sorted(hist.items()))


def _tile_lists_record(codes):
    """The new tile-list kernel at the BAGEL training pack's codes [1,
    4096]: both lists against the plain ones (`_tile_lists_check`), then
    timed in turns with the two pre-passes it replaced (old, new, new,
    old; CUDA events over 50 back-to-back wrapper calls) beside an empty
    kernel's launch, the floor a launch costs, and each launch's device
    time from the profiler. Bound: the codes read once, both lists and
    counts written once. Returns its record of the kernels line."""
    import torch

    from univid_tpu_torch.kernels import build
    from univid_tpu_torch.kernels import flash_attention as fa

    b, l = codes.shape
    masks = dict(q_segments=codes, kv_segments=codes, packed_mode=True)
    fwd, bwd = _tile_lists_check("packed [1, 4096]", b, l, l, None, masks)
    shape_q = torch.empty((b, l, 1, 128), dtype=torch.bfloat16,
                          device="cuda")   # the old backward's shape operand
    empty_fn = fa._fn("mask_tiles_sm90", "univid_empty_launch", [fa._P])
    stream = torch.cuda.current_stream().cuda_stream
    calls = {
        "tile_lists": lambda: fa.tile_lists(b, l, l, "cuda", **masks),
        "mask_tile_list": lambda: fa.mask_tile_list(codes, codes, None,
                                                    True),
        "bwd_tile_list": lambda: fa.bwd_tile_list(shape_q, l, None, **masks),
        "empty_launch": lambda: build.check(empty_fn(stream),
                                            "univid_empty_launch")}
    order = ("mask_tile_list", "bwd_tile_list", "tile_lists", "empty_launch")
    ms = dict.fromkeys(calls, 0.0)
    for turn in (order, order[::-1]):   # old, new, new, old
        for nm in turn:
            ms[nm] += cuda_time(calls[nm], 50) / 2
    _, prof = profile_call(
        lambda: [calls[nm]() for nm in order for _ in range(10)],
        {"mask_tile_list": ["mask_tiles_kernel"],
         "bwd_tile_list": ["bwd_tiles_kernel"],
         "tile_lists": ["tile_lists_kernel"], "empty_launch": ["empty_kernel"]})
    dev = {nm: prof[nm] / 10 for nm in order}   # one launch's device ms
    plain_ms = cuda_time(lambda: (
        fa.mask_tile_list_plain(codes, codes, None, True),
        fa.bwd_tile_list_plain(b, l, l, "cuda", **masks)), 3)
    bms, by = bound_ms(0, nbytes(codes, codes, *fwd, *bwd), H100_BF16_FLOPS)
    runs = {"q_runs_per_64_rows": _runs_per_tile(codes, 64),
            "kv_runs_per_128_keys": _runs_per_tile(codes, 128)}
    log(json.dumps({"tile_lists_vs_old": "packed [1, 4096]",
                    "ms": ms, "device_ms": dev, "bound_ms": bms,
                    "runs": runs}))
    return dict(name="tile_lists", route="cuda",
                source="univid_tpu_torch/kernels/csrc/mask_tiles_sm90.cu",
                replaces="univid_tpu/kernels/flash_attention.py:309",
                also_replaces="univid_tpu/kernels/flash_attention.py:1113",
                max_abs_err=0.0, ms=ms["tile_lists"], plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=None,
                device_ms=dev.get("tile_lists"),
                old_ms={nm: ms[nm] for nm in ("mask_tile_list",
                                              "bwd_tile_list")},
                old_device_ms={nm: dev.get(nm) for nm in (
                    "mask_tile_list", "bwd_tile_list")},
                empty_launch_ms=ms["empty_launch"],
                empty_launch_device_ms=dev.get("empty_launch"), runs=runs)


def check_mask_kernels():
    """The packed, segment and causal-backward kernel modes against their
    plain versions on the card, with CUDA-event times, bounds over the live
    (row, key) pairs and SDPA with the materialized mask; the segment and
    packed forwards (sm90 kernel) also in turns with the mma.sync kernel
    they replaced, and the tile-list pre-pass against its plain version:
      * packed, at the BAGEL training path's shape: q, k, v [1, 4096, 28,
        128] with the full-width pack's own codes (document-0 pad tokens'
        keys hold 50.0); then Lq = 4,000 padded to 4,032 with the
        dispatcher's pad ids (q -1, kv -2; those keys 50.0), whose pad rows
        must come out exactly 0 with lse +1e30;
      * segments: [2, 2048, 12, 128], 3 segments a row (rows meet up to 21
        wholly masked tiles before their first live key);
      * the causal backward (and its forward with lse) at the BAGEL square
        prefill's shape with the kv heads repeated, [1, 2048, 28, 128],
        offset 0, kv_len 2,000; then B = 2 at q_offsets [0, 37], kv_len
        [2000, 2048]; keys past kv_len hold 50.0.
    Returns the records of the kernels line (path shapes)."""
    import torch

    from univid_tpu_torch.kernels import flash_attention as fa
    from univid_tpu_torch.models.bagel.bagel import BagelConfig

    gen = torch.Generator(device="cuda").manual_seed(9)
    n, d = 28, 128
    batch, _ = bagel_train_batch(BagelConfig(), TRAIN_SIZES, 5, PACK_TOKENS)
    codes_np = batch["mask_codes"]
    records = {}

    def inputs(b, l, heads):
        q = qk_normed((b, l, heads, d), gen, torch.bfloat16)
        k = qk_normed((b, l, heads, d), gen, torch.bfloat16)
        v = torch.randn((b, l, heads, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        do = torch.randn((b, l, heads, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        return q, k, v, do

    # packed, the path's pack
    real = int((codes_np >> 16 > 0).sum())
    codes = torch.tensor(codes_np, dtype=torch.int32, device="cuda")[None]
    q, k, v, do = inputs(1, PACK_TOKENS, n)
    k[:, real:] = 50.0   # the pack's document-0 pad tokens
    v[:, real:] = 50.0
    allowed = _allowed_packed(codes, codes)
    live = int(allowed.sum())
    masks = dict(q_segments=codes, kv_segments=codes, packed_mode=True)
    rec = _fwd_tile_list_check("packed [1, 4096]", codes, codes, None,
                               True)
    records["tile_lists"] = _tile_lists_record(codes)
    with torch.no_grad():   # device time of the tile lists and the forward
        _, prof = profile_call(lambda: fa._flash_cuda(
            fa._fold(q, d ** -0.5), k, v, None, None, None, **masks))
    log(json.dumps({"packed_forward_kernels": [
        (t["kernel"], t["ms"]) for t in prof["top_kernels"]]}))
    records["mask_tile_list"] = dict(
        name="mask_tile_list", route="cuda",
        source="univid_tpu_torch/kernels/csrc/flash_attention_sm90.cu",
        replaces="univid_tpu/kernels/flash_attention.py:309", **rec)
    real_keys = torch.zeros((1, PACK_TOKENS), dtype=torch.bool, device="cuda")
    real_keys[:, :real] = True
    case = _mask_case("packed [1, 4096, 28, 128]", q, k, v, do, None, masks,
                      live, allowed, live_keys=real_keys)
    records.update(_records("packed", case))
    records["bwd_tile_list"] = dict(
        name="bwd_tile_list", route="cuda",
        source="univid_tpu_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
        replaces="univid_tpu/kernels/flash_attention.py:1113",
        **case["bwd_tile_list"])
    log(json.dumps({"check": "packed pack", "tokens": PACK_TOKENS,
                    "real_tokens": real, "live_pairs": live,
                    "live_share": live / PACK_TOKENS ** 2}))
    # packed with the dispatcher's pad ids: Lq = Lk = 4,000 -> 4,032
    lp, lr = 4032, 4000
    qc = codes.clone()[:, :lp]
    kc = qc.clone()
    qc[:, lr:] = -1
    kc[:, lr:] = -2
    k[:, lr:lp] = 50.0
    v[:, lr:lp] = 50.0
    pad_rows = torch.zeros((1, lp), dtype=torch.bool, device="cuda")
    pad_rows[:, lr:] = True
    allowed = _allowed_packed(qc, kc)
    masks = dict(q_segments=qc.contiguous(), kv_segments=kc.contiguous(),
                 packed_mode=True)
    _fwd_tile_list_check("packed padded 4000->4032", masks["q_segments"],
                         masks["kv_segments"], None, True)
    # the new kernel with the kv_len the dispatcher sets for padded keys
    _tile_lists_check("packed padded 4000->4032, kv_len 4000", 1, lp, lp,
                      torch.tensor([lr], dtype=torch.int32, device="cuda"),
                      masks)
    case = _mask_case("packed padded 4000->4032",
                      *(x[:, :lp].contiguous() for x in (q, k, v, do)), None,
                      masks, int(allowed.sum()), allowed, pad_rows=pad_rows,
                      live_keys=~pad_rows)
    for key, rec in _records("packed", case).items():
        log(json.dumps({"kernel_at_padded_pack": rec}))
    del q, k, v, do, allowed
    torch.cuda.empty_cache()

    # segments: 3 a row
    b, l, ns = 2, 2048, 12
    segs = torch.zeros((b, l), dtype=torch.int32, device="cuda")
    for r, (c1, c2) in enumerate(((700, 1400), (300, 1650))):
        segs[r, c1:c2] = 1
        segs[r, c2:] = 2
    q, k, v, do = inputs(b, l, ns)
    allowed = (segs[:, :, None] == segs[:, None, :])[:, None]
    masks = dict(q_segments=segs, kv_segments=segs)
    _fwd_tile_list_check("segments [2, 2048]", segs, segs, None, False)
    _tile_lists_check("segments [2, 2048]", b, l, l, None, masks)
    case = _mask_case("segments [2, 2048, 12, 128]", q, k, v, do, None,
                      masks, int(allowed.sum()), allowed)
    records.update(_records("segments", case))
    del q, k, v, do, allowed
    torch.cuda.empty_cache()

    # the causal backward at the square prefill's shape, heads repeated
    for tag, b, offs, kvl in (("causal [1, 2048, 28, 128]", 1, None, [2000]),
                              ("causal B=2 q_offsets [0, 37]", 2, [0, 37],
                               [2000, 2048])):
        q, k, v, do = inputs(b, 2048, n)
        kv = torch.tensor(kvl, dtype=torch.int32, device="cuda")
        for r, kl in enumerate(kvl):
            k[r, kl:] = 50.0
            v[r, kl:] = 50.0
        qo = (torch.tensor(offs, dtype=torch.int32, device="cuda")
              if offs is not None else None)
        rows = fa.causal_rows(2048, 0, qo, "cuda")
        cols = torch.arange(2048, device="cuda")
        allowed = ((cols[None, None, :] <= rows[:, :, None])
                   & (cols[None, None, :] < kv[:, None, None]))[:, None]
        masks = dict(causal=True, q_offsets=qo)
        _tile_lists_check(tag, b, 2048, 2048, kv, masks)
        case = _mask_case(tag, q, k, v, do, kv, masks, int(allowed.sum()),
                          allowed, no_lse=False,
                          live_keys=cols[None, :] < kv[:, None])
        recs = _records("causal", case)
        if offs is None:
            records.update(recs)
        else:
            for rec in recs.values():
                log(json.dumps({"kernel_at_q_offsets": rec}))
        del q, k, v, do, allowed
        torch.cuda.empty_cache()
    for rec in records.values():
        log(json.dumps({"kernel": rec}))
    return records


def _small_train_models():
    """A small d=128 BAGEL (hidden 512, 4 heads over 2 kv heads, 2 layers;
    non-unit qk norms, llm2vae redrawn off its zero init) and a tiny
    SigLIP, bf16 on the CPU, seeded."""
    import torch

    from univid_tpu_torch.models.bagel.bagel import BagelConfig, init_bagel
    from univid_tpu_torch.models.bagel.qwen2_mot import Qwen2MoTConfig
    from univid_tpu_torch.models.bagel.siglip import (SiglipConfig,
                                                      init_siglip)

    bf = torch.bfloat16
    llm = Qwen2MoTConfig(vocab_size=4096, hidden_size=512,
                         intermediate_size=1024, num_layers=2, num_heads=4,
                         num_kv_heads=2)
    cfg = BagelConfig(llm=llm, vit_hidden_size=64, start_of_image=4090,
                      end_of_image=4091, bos_token_id=4092,
                      eos_token_id=4093)
    scfg = SiglipConfig(hidden_size=64, intermediate_size=128, num_layers=2,
                        num_heads=2, patch_size=14, image_size=224)
    gen = torch.Generator().manual_seed(31)
    bagel = init_bagel(gen, cfg, dtype=bf, device="cpu")
    sig = init_siglip(gen, scfg, dtype=bf, device="cpu")
    with torch.no_grad():
        for layer in bagel.llm.layers:
            for a in (layer.attn, layer.attn_gen):
                a.q_norm.uniform_(0.5, 1.5, generator=gen)
                a.k_norm.uniform_(0.5, 1.5, generator=gen)
        bagel.llm2vae.w.normal_(0.0, 0.02, generator=gen)
    return cfg, scfg, bagel, sig


def small_bagel_train_parity():
    """The packed training forward + backward of a small d=128 BAGEL on the
    card (kernels) and on the CPU (plain versions), same bf16 weights, the
    same 4-kind pack scaled down (250 tokens: the dispatcher pads to 256
    with the pad ids) and the same noise; every parameter trainable, with
    freeze_und False and True. Loss rel. error < 2e-2, each gradient
    leaf's rel. L2 < 3e-2; on the card 2 packed forwards with lse, 2
    one-pass sm90 backward calls and one tile_lists launch (the pass's
    tile plan, both lists for both layers) a pass, and no other kernel."""
    import copy

    import torch

    from univid_tpu_torch.kernels import flash_attention as fa
    from univid_tpu_torch.models.bagel.packed import bagel_packed_forward

    cfg, scfg, bagel, sig = _small_train_models()
    batch, kinds = bagel_train_batch(cfg, SMALL_TRAIN_SIZES, 6, 250)
    noise = torch.randn(batch["packed_latent_clean"].shape,
                        generator=torch.Generator().manual_seed(8))
    want_launches = {"flash_attention_bf16_lse": 2,
                     "flash_attention_bwd_bf16_sm90": 2,
                     "flash_attention_bf16_lse_packed": 2,
                     "flash_attention_bwd_bf16_sm90_packed": 2,
                     "tile_lists": 1}

    def run(device, freeze):
        model = copy.deepcopy(bagel).to(device)
        for p in model.parameters():
            p.requires_grad_(True)
        fa.reset_launches()
        out = bagel_packed_forward(model, cfg, batch, noise=noise,
                                   siglip_params=copy.deepcopy(sig).to(device),
                                   siglip_cfg=scfg,
                                   compute_dtype=torch.bfloat16,
                                   freeze_und=freeze)
        loss = _train_loss(out)
        loss.backward()
        used = {k_: v_ for k_, v_ in launch_counts().items() if v_}
        grads = {nm: p.grad.detach().float().cpu()
                 for nm, p in model.named_parameters() if p.grad is not None}
        return float(loss), grads, used

    for freeze in (False, True):
        loss_g, grads_g, used = run("cuda", freeze)
        loss_c, grads_c, _ = run("cpu", freeze)
        leaf_err = {nm: rel_l2(grads_g[nm], g) for nm, g in grads_c.items()
                    if nm in grads_g}
        worst = sorted(leaf_err.items(), key=lambda kv: -kv[1])[:5]
        loss_err = abs(loss_g - loss_c) / max(abs(loss_c), 1e-30)
        out = {"check": "small_bagel_train_parity", "freeze_und": freeze,
               "tokens": kinds, "loss_card": loss_g, "loss_cpu": loss_c,
               "loss_rel_err": loss_err, "leaves": len(leaf_err),
               "worst_leaf_rel_l2": worst, "limits": [2e-2, 3e-2],
               "why": "bf16 on both sides: cuBLAS and the CPU round each "
                      "GEMM at other points (2^-8 relative), over 2 layers "
                      "and their backward",
               "launches": used}
        out["ok"] = (loss_err < 2e-2 and set(grads_g) == set(grads_c)
                     and max(leaf_err.values()) < 3e-2
                     and used == want_launches
                     and math.isfinite(loss_g))
        log(json.dumps(out))
        if not out["ok"]:
            fail("the packed training path on the card disagrees with the "
                 "CPU, or went through other kernels")


REGISTRY_EXPECTED = PACK_TOKENS - 512   # the packer yields at this fill


def _allowed_packed(qc, kc):
    """The packed mode's attend mask of codes qc [B, Lq], kc [B, Lk] as
    SDPA takes it: bool [B, 1, Lq, Lk]."""
    import torch

    from univid_tpu_torch.kernels import flash_attention as fa

    rows = torch.arange(qc.shape[1], device=qc.device)[None, :, None]
    cols = torch.arange(kc.shape[1], device=kc.device)[None, None, :]
    return fa.packed_mask_allowed(qc[:, :, None], kc[:, None, :], rows,
                                  cols)[:, None]


def registry_pack(cfg, output_dir):
    """One PACK_TOKENS-token pack built the way a BAGEL training run feeds
    itself: files written under output_dir/bagel_data, three groups from
    the port's load_data_groups (a dict config, no YAML), all mandatory so
    each kind is in the pack: t2i_pretrain (records read from a JSONL
    file, 256x320 images on disk), vlm_sft (a JSONL of conversations and
    224x280 images on disk) and unified_edit (editing chains of three
    256x256 images, as records); the vae entries through latent_fn, the
    port's full-size FLUX AE (random from a seed: models/bagel/
    autoencoder.py) on the card, its latent patchified by 2 to [h, w, 64].
    The flow timesteps from np.random.seed(70). Returns (batch, the
    dataset names in the pack)."""
    import os

    import numpy as np
    import torch
    from PIL import Image

    from univid_tpu_torch.data.packed_dataset import (PackedDataConfig,
                                                      PackedDataset)
    from univid_tpu_torch.data.registry import load_data_groups
    from univid_tpu_torch.models.bagel.autoencoder import (ImageVAEConfig,
                                                           image_vae_encode,
                                                           init_image_vae)
    from univid_tpu_torch.models.bagel.bagel import patchify_latent
    from univid_tpu_torch.utils.tokenizers import HashTokenizer

    root = os.path.join(output_dir, "bagel_data")
    os.makedirs(root, exist_ok=True)

    def picture(h, w, seed):
        return smooth_clip(1, h, w, seed)[0]

    t2i_path = os.path.join(root, "t2i.jsonl")
    with open(t2i_path, "w") as f:
        for i in range(8):
            img = os.path.join(root, f"t2i_{i}.png")
            Image.fromarray(picture(256, 320, 100 + i)).save(img)
            f.write(json.dumps({"image": img, "captions": {
                "short": f"bands of colour number {i}",
                "long": f"soft diagonal bands of colour, picture {i}, "
                        "drifting across a plain background"}}) + "\n")
    with open(t2i_path) as f:
        t2i_records = [json.loads(line) for line in f]
    vlm_path = os.path.join(root, "vlm.jsonl")
    with open(vlm_path, "w") as f:
        for i in range(8):
            Image.fromarray(picture(224, 280, 200 + i)).save(
                os.path.join(root, f"vlm_{i}.png"))
            f.write(json.dumps({"image": f"vlm_{i}.png", "conversations": [
                {"from": "human", "value": "<image>\nWhat pattern fills "
                                           "this picture, and which way "
                                           "does it run?"},
                {"from": "gpt", "value": f"Picture {i} is filled with soft "
                                         "bands of colour that run "
                                         "diagonally from the top left to "
                                         "the bottom right."}]}) + "\n")
    edit_records = [{"image_list": [picture(256, 256, 300 + 3 * i + j)
                                    for j in range(3)],
                     "instruction_list": [["shift the colours to the left",
                                           "move every band left"],
                                          ["make the bands wider",
                                           "widen the bands"]]}
                    for i in range(4)]
    config = {
        "t2i_pretrain": {"dataset_names": ["synthetic_t2i"],
                         "image_transform_args": {
                             "image_stride": 16, "max_image_size": 512,
                             "min_image_size": 256},
                         "is_mandatory": True, "weight": 1.0},
        "vlm_sft": {"dataset_names": ["synthetic_vlm"],
                    "image_transform_args": {
                        "image_stride": 14, "max_image_size": 490,
                        "min_image_size": 224},
                    "is_mandatory": True, "weight": 1.0},
        "unified_edit": {"dataset_names": ["synthetic_edit"],
                         "image_transform_args": {
                             "image_stride": 16, "max_image_size": 512,
                             "min_image_size": 256},
                         "vit_image_transform_args": {
                             "image_stride": 14, "max_image_size": 490,
                             "min_image_size": 224},
                         "is_mandatory": True, "weight": 1.0},
    }
    info = {"t2i_pretrain": {"synthetic_t2i": {"records": t2i_records}},
            "vlm_sft": {"synthetic_vlm": {"jsonl_path": vlm_path,
                                          "image_dir": root}},
            "unified_edit": {"synthetic_edit": {"records": edit_records}}}
    vcfg = ImageVAEConfig()
    ae = init_image_vae(torch.Generator(device="cuda").manual_seed(71), vcfg,
                        device="cuda")
    p = cfg.latent_patch_size

    def latent_fn(pix):
        with torch.no_grad():
            z = image_vae_encode(ae, vcfg, torch.as_tensor(
                pix, device="cuda")[None])[0]
        tokens = patchify_latent(z.float(), p)
        return tokens.reshape(z.shape[0] // p, z.shape[1] // p, -1) \
            .cpu().numpy()

    # token ids below the config's special ids
    vocab = min(cfg.bos_token_id, cfg.eos_token_id, cfg.start_of_image,
                cfg.end_of_image)
    groups = load_data_groups(config, HashTokenizer(vocab_size=vocab), info,
                              latent_fn=latent_fn, seed=72)
    np.random.seed(70)
    packer = PackedDataset(groups, data_config=PackedDataConfig(
        vit_patch_size=cfg.vit_patch_size,
        max_num_patch_per_side=cfg.vit_max_num_patch_per_side,
        max_latent_size=cfg.max_latent_size,
        latent_channel=cfg.latent_channel, bos_token_id=cfg.bos_token_id,
        eos_token_id=cfg.eos_token_id, start_of_image=cfg.start_of_image,
        end_of_image=cfg.end_of_image), expected_num_tokens=REGISTRY_EXPECTED,
        max_num_tokens=PACK_TOKENS, max_num_tokens_per_sample=PACK_TOKENS,
        seed=73)
    batch = next(iter(packer))
    del ae
    names = sorted({d["dataset_name"] for d in batch["batch_data_indexes"]})
    return batch, names


def registry_pack_pass(bagel, sig, cfg, scfg, output_dir):
    """Phase 9b, on the BAGEL-7B-MoT of the packed-training path: one
    training pass (forward + backward, freeze_und) on the pack of
    `registry_pack`; its launches asserted from zero counts (28 packed
    forwards with lse, 28 one-pass sm90 backward calls, one tile_lists
    launch), a finite loss. Then the packed pair at this pack's codes, [1,
    4096, 28, 128] (the forward with lse and the one-pass backward, with
    the mma.sync kernels in turns, against their plain versions, SDPA with
    the mask beside them: `_mask_case`). Returns (the pass's launch
    counts, kernels-line records `<kernel>_registry`)."""
    import numpy as np
    import torch

    from univid_tpu_torch.kernels import flash_attention as fa
    from univid_tpu_torch.models.bagel.packed import bagel_packed_forward

    t0 = time.perf_counter()
    batch, names = registry_pack(cfg, output_dir)
    build_s = time.perf_counter() - t0
    n_layers = cfg.llm.num_layers
    codes_np = np.asarray(batch["mask_codes"])
    real = int((codes_np >> 16 > 0).sum())
    bagel.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    out = bagel_packed_forward(
        bagel, cfg, batch, rng=torch.Generator(device="cuda").manual_seed(74),
        siglip_params=sig, siglip_cfg=scfg, compute_dtype=torch.bfloat16,
        freeze_und=True)
    loss = _train_loss(out)
    loss.backward()
    torch.cuda.synchronize()
    pass_s = time.perf_counter() - t0
    launches = launch_counts()
    got = {k: v for k, v in launches.items() if v}
    want = {nm: n_layers for nm in (
        "flash_attention_bf16_lse", "flash_attention_bwd_bf16_sm90",
        "flash_attention_bf16_lse_packed",
        "flash_attention_bwd_bf16_sm90_packed")}
    want["tile_lists"] = 1
    grads = sum(1 for p in bagel.parameters()
                if p.grad is not None and bool(p.grad.abs().max() > 0))
    rec = {"phase": "registry_pack_pass", "datasets": names,
           "real_tokens": real, "pack_tokens": PACK_TOKENS,
           "vit_patches": int(batch["packed_vit_patches"].shape[0]),
           "vae_tokens": int(batch["packed_latent_clean"].shape[0]),
           "ce_tokens": int(batch["ce_loss_indexes"].shape[0]),
           "samples": len(batch["sample_lens"]), "build_s": build_s,
           "pass_s": pass_s, "loss": float(loss.detach()),
           "leaves_with_grad": grads, "launches": got, "expected": want}
    log(json.dumps(rec))
    if got != want:
        fail(f"registry pack pass launches {got} != {want}")
    check_impl("registry pack pass", n_layers)
    check_bwd_impl("registry pack pass", n_layers)
    if not math.isfinite(rec["loss"]) or not grads:
        fail("registry pack pass: non-finite loss or no gradient")
    if names != ["sft_jsonl", "t2i", "unified_edit"]:
        fail(f"registry pack holds {names}, not the three groups")
    bagel.zero_grad(set_to_none=True)
    del out, loss
    torch.cuda.empty_cache()

    # the packed pair at this pack's codes
    gen = torch.Generator(device="cuda").manual_seed(75)
    n, d = cfg.llm.num_heads, cfg.llm.hidden_size // cfg.llm.num_heads
    codes = torch.tensor(codes_np, dtype=torch.int32, device="cuda")[None]
    q, k = (qk_normed((1, PACK_TOKENS, n, d), gen, torch.bfloat16)
            for _ in range(2))
    v, do = (torch.randn((1, PACK_TOKENS, n, d), generator=gen,
                         device="cuda").to(torch.bfloat16) for _ in range(2))
    k[:, real:] = 50.0   # the pack's document-0 pad tokens
    v[:, real:] = 50.0
    allowed = _allowed_packed(codes, codes)
    live = int(allowed.sum())
    real_keys = torch.zeros((1, PACK_TOKENS), dtype=torch.bool,
                            device="cuda")
    real_keys[:, :real] = True
    masks = dict(q_segments=codes, kv_segments=codes, packed_mode=True)
    case = _mask_case(f"registry pack [1, {PACK_TOKENS}, {n}, {d}]", q, k, v,
                      do, None, masks, live, allowed, no_lse=False,
                      live_keys=real_keys)
    log(json.dumps({"check": "registry pack", "live_pairs": live,
                    "live_share": live / PACK_TOKENS ** 2}))
    records = {}
    for name, r in _records("packed", case).items():
        log(json.dumps({"kernel_at_registry_pack": r}))
        if name in ("flash_attention_bf16_lse_packed",
                    "flash_attention_bwd_bf16_sm90_packed"):
            records[name + "_registry"] = dict(r, name=name + "_registry",
                                               counter=name)
    del q, k, v, do, allowed, case
    torch.cuda.empty_cache()
    return launches, records


def bagel_train_main_path(output_dir):
    """The BAGEL packed-training path at full width: BAGEL-7B-MoT (bf16,
    both experts, random from seeds; llm2vae redrawn off its zero init,
    which would block every gradient) with SigLIP so400m, on one 4,096-token
    pack of the four sample kinds (`bagel_train_batch`), freeze_und=True
    (the reference's flag): the gen experts, vae2llm, llm2vae and
    time_embedder train; the und experts, embeddings, lm_head, connector
    and SigLIP are frozen. A training pass is the forward, then the
    backward of the sum of the MSE terms and the weighted CE. One untimed
    training pass first (its seconds and the allocator's growth during it
    logged: the first pass with grad grows the caching allocator by its
    activations, in new cudaMalloc calls), then 3 evaluation forwards (no
    grad) and 3 training passes: medians and spreads, launches asserted
    per pass (the counts reset after the warm-up); peak memory, the loss
    and the gradients' reach logged; one more evaluation forward and one
    more training pass profiled (the tile lists' device time apart). Then,
    on the same model, the registry-fed pack's pass (`registry_pack_pass`).
    Returns (the counts of the six passes, the registry pass's counts, its
    kernels-line records)."""
    import gc

    import torch

    from univid_tpu_torch.kernels import flash_attention as fa
    from univid_tpu_torch.models.bagel.bagel import BagelConfig, init_bagel
    from univid_tpu_torch.models.bagel.packed import bagel_packed_forward
    from univid_tpu_torch.models.bagel.siglip import (SiglipConfig,
                                                      init_siglip)

    gc.collect()
    torch.cuda.empty_cache()
    bf = torch.bfloat16
    cfg, scfg = BagelConfig(), SiglipConfig()

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    t0 = time.perf_counter()
    bagel = init_bagel(gen(50), cfg, dtype=bf, device="cuda")
    sig = init_siglip(gen(51), scfg, dtype=bf, device="cuda")
    with torch.no_grad():
        bagel.llm2vae.w.normal_(0.0, 0.02, generator=gen(52))
    trainable = [p for nm, p in bagel.named_parameters()
                 if "_gen" in nm or nm.split(".")[0] in (
                     "vae2llm", "llm2vae", "time_embedder")]
    for p in trainable:
        p.requires_grad_(True)
    batch, kinds = bagel_train_batch(cfg, TRAIN_SIZES, 5, PACK_TOKENS)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = torch.cuda.memory_allocated() / 1e9
    rng = gen(53)
    n_layers = cfg.llm.num_layers

    def forward():
        return bagel_packed_forward(bagel, cfg, batch, rng=rng,
                                    siglip_params=sig, siglip_cfg=scfg,
                                    compute_dtype=bf, freeze_und=True)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def train_pass():
        bagel.zero_grad(set_to_none=True)
        out, fwd_s = timed(forward)
        loss = _train_loss(out)
        _, bwd_s = timed(loss.backward)
        return out, loss, fwd_s, bwd_s

    def allocator():
        st = torch.cuda.memory_stats()
        return {"device_allocs": st.get("num_device_alloc", 0),
                "alloc_retries": st.get("num_alloc_retries", 0),
                "reserved_gb": torch.cuda.memory_reserved() / 1e9}

    def spread(xs):
        return {"median": statistics.median(xs), "min": min(xs),
                "max": max(xs), "runs": xs}

    # one tile_lists launch a pass (the pass's tile plan: both lists, read
    # by every layer in both directions), none of the old pre-passes
    want_eval = {"flash_attention_bf16": n_layers,
                 "flash_attention_bf16_packed": n_layers, "tile_lists": 1}
    want_train = {nm: n_layers for nm in (
        "flash_attention_bf16_lse", "flash_attention_bwd_bf16_sm90",
        "flash_attention_bf16_lse_packed",
        "flash_attention_bwd_bf16_sm90_packed")}
    want_train["tile_lists"] = 1
    torch.cuda.reset_peak_memory_stats()
    # warm-up: the first training pass, outside the medians
    alloc_before = allocator()
    _, loss, warm_fwd_s, warm_bwd_s = train_pass()
    warm = {"train_forward_s": warm_fwd_s, "backward_s": warm_bwd_s,
            "allocator_before": alloc_before, "allocator_after": allocator()}
    del loss, _
    fa.reset_launches()
    launches = dict.fromkeys(launch_counts(), 0)

    def counted(tag, fn, want, bwd_calls=0):
        """fn() with this pass's launches checked (every packed forward on
        the sm90 kernel; `bwd_calls` packed backward calls, all on the
        one-pass sm90 kernel, none on the mma.sync pair), then added to
        the path's."""
        before = launch_counts()
        impl_before = dict(fa.LAUNCHES_BY_IMPL)
        bwd_before = dict(fa.BWD_LAUNCHES_BY_IMPL)
        out = fn()
        got = {k_: v_ - before[k_] for k_, v_ in launch_counts().items()
               if v_ != before[k_]}
        impl = {k_: v_ - impl_before[k_]
                for k_, v_ in fa.LAUNCHES_BY_IMPL.items()}
        bwd = {k_: v_ - bwd_before[k_]
               for k_, v_ in fa.BWD_LAUNCHES_BY_IMPL.items()}
        if (got != want or impl != {"sm90": n_layers, "causal_sm90": 0,
                                    "mma_sync": 0}
                or bwd != {"sm90": bwd_calls, "mma_sync": 0}):
            fail(f"{tag}: launches {got} != {want} or by kernel {impl}, "
                 f"backward {bwd}")
        for k_, v_ in got.items():
            launches[k_] += v_
        return out

    eval_s, fwd_s, bwd_s = [], [], []
    for _ in range(3):
        with torch.no_grad():
            ev, t = counted("BAGEL packed evaluation forward",
                            lambda: timed(forward), want_eval)
        eval_s.append(t)
        eval_loss = float(_train_loss(ev))
        del ev
    for _ in range(3):
        out, loss, f_s, b_s = counted("BAGEL packed training pass",
                                      train_pass, want_train, n_layers)
        fwd_s.append(f_s)
        bwd_s.append(b_s)
    # 28 / 0 a pass over the six passes
    check_impl("BAGEL packed training path (3 evaluation forwards, 3 "
               "training passes)", 6 * n_layers, 0)
    # the packed backward on the one-pass sm90 kernel, 28 a pass
    check_bwd_impl("BAGEL packed training path", 3 * n_layers, 0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    mse_terms = float(out["mse"].sum())
    ce_terms = float((out["ce"] * out["ce_weights"]).sum())
    gen_grads = {nm: float(p.grad.abs().max()) if p.grad is not None
                 else 0.0 for nm, p in bagel.named_parameters()
                 if p.requires_grad}
    und_with_grad = [nm for nm, p in bagel.named_parameters()
                     if not p.requires_grad and p.grad is not None]
    zero_gen = [nm for nm, g in gen_grads.items() if not g > 0.0]
    del out
    tile_fam = {"tile_lists_ms": ["tile_lists"]}
    with torch.no_grad():
        _, profiled_eval = profile_call(lambda: _train_loss(forward()),
                                        tile_fam)
    _, profiled = profile_call(lambda: train_pass()[1], tile_fam)
    rec = {"phase": "bagel_train_main_path", "model": "BAGEL-7B-MoT",
           "params": sum(p.numel() for p in bagel.parameters()),
           "trainable": sum(p.numel() for p in trainable),
           "weights_gb": weights_gb, "init_s": init_s,
           "pack_tokens": PACK_TOKENS, "kind_tokens": dict(zip(
               ("vlm", "t2i", "edit", "text"), kinds)),
           "vit_patches": int(batch["packed_vit_patches"].shape[0]),
           "vae_tokens": int(batch["packed_latent_clean"].shape[0]),
           "ce_tokens": int(batch["ce_loss_indexes"].shape[0]),
           "warm_up_pass": warm, "eval_forward_s": spread(eval_s),
           "train_forward_s": spread(fwd_s), "backward_s": spread(bwd_s),
           "peak_memory_gb": peak,
           "loss": float(loss), "mse_sum": mse_terms, "ce_weighted": ce_terms,
           "eval_loss": eval_loss, "gen_leaves_with_grad":
           len(gen_grads) - len(zero_gen), "gen_leaves_zero": zero_gen[:5],
           "frozen_leaves_with_grad": und_with_grad[:5],
           "eval_launches": want_eval, "train_launches": want_train,
           "profiled_eval_forward": profiled_eval,
           "profiled_train_pass": profiled}
    log(json.dumps(rec))
    if not (math.isfinite(rec["loss"]) and math.isfinite(mse_terms)
            and math.isfinite(ce_terms)):
        fail("non-finite BAGEL training loss")
    if zero_gen or und_with_grad:
        fail(f"gen leaves without a gradient {zero_gen[:5]} or frozen leaves "
             f"with one {und_with_grad[:5]}")
    del loss, batch
    t0 = time.perf_counter()
    reg_launches, reg_records = registry_pack_pass(bagel, sig, cfg, scfg,
                                                   output_dir)
    log(json.dumps({"phase": "registry_pack_pass_total",
                    "seconds": time.perf_counter() - t0,
                    "peak_memory_gb": torch.cuda.max_memory_allocated()
                    / 1e9}))
    del bagel, sig, trainable
    gc.collect()
    torch.cuda.empty_cache()
    return launches, reg_launches, reg_records


def _qa_frames(n_frames):
    """The seeded 640x360 uint8 frames of `_qa_video`, as arrays."""
    import numpy as np

    rng = np.random.default_rng(11)
    base = rng.integers(0, 256, (9, 24, 3), dtype=np.uint8)
    field = np.kron(base, np.ones((40, 40, 1), np.uint8))   # 360 x 960
    return [field[:, 5 * t:5 * t + 640] for t in range(n_frames)]


BAGEL_FP32_FRAMES = 16    # the largest QA call's frames
BAGEL_FP32_TOKENS = 32    # greedy tokens of the fp32 request's decode


def bagel_fp32_main_path():
    """BAGEL-7B-MoT at fp32 compute through the port's entry points, at full
    width (both experts, hidden 3,584, 28 query heads over 4 kv heads, d =
    128, BAGEL_QA_LAYERS of its 28 layers; SigLIP so400m, whose d = 72
    takes the reference route), random weights from seeds held in fp32:
      * one QA request through InterleaveInferencer(..., compute_dtype=
        torch.float32) with a 20,480-row fp32 cache: 16 frames of 640x360
        appended (the grouped kv mode with kv_len: one flash_attention_
        f32_sm90 launch a layer a frame), the question's causal prefill
        (q_offsets: one a layer) and a greedy decode of 32 tokens (the
        decode-shaped einsums, as in JAX);
      * on the same model, BAGEL packed training at fp32 compute on the
        4,096-token pack of `bagel_train_batch` (freeze_und, llm2vae drawn
        off its zero init): one evaluation forward (the packed forward, one
        a layer) and one training pass (the packed forward with the lse,
        the packed dq and dk/dv: one each a layer; one tile_lists launch a
        pass).
    Each from zero counts: seconds, peak memory and the launches by mode,
    asserted exactly (every attention call on the fp32 sm90 kernels, none
    on a bf16 kernel). Returns the counts of the whole phase."""
    import dataclasses
    import gc

    import torch

    from univid_tpu_torch.kernels import flash_attention as fa
    from univid_tpu_torch.models.bagel.bagel import BagelConfig, init_bagel
    from univid_tpu_torch.models.bagel.packed import bagel_packed_forward
    from univid_tpu_torch.models.bagel.qwen2_mot import Qwen2MoTConfig
    from univid_tpu_torch.models.bagel.siglip import (SiglipConfig,
                                                      init_siglip)
    from univid_tpu_torch.pipelines.interleave import InterleaveInferencer
    from univid_tpu_torch.utils.tokenizers import HashTokenizer

    gc.collect()
    torch.cuda.empty_cache()
    f32 = torch.float32
    cfg = BagelConfig(llm=dataclasses.replace(Qwen2MoTConfig(),
                                              num_layers=BAGEL_QA_LAYERS))
    scfg = SiglipConfig()
    n_layers = cfg.llm.num_layers

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    def synced(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def check(tag, got, want):
        got = {k: v for k, v in got.items() if v}
        log(json.dumps({"check": f"{tag} launches", "launches": got,
                        "expected": want, "ok": got == want}))
        if got != want:
            fail(f"{tag}: launches {got} != {want}")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bagel = init_bagel(gen(60), cfg, dtype=f32, device="cuda")
    sig = init_siglip(gen(61), scfg, dtype=f32, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = torch.cuda.memory_allocated() / 1e9
    inf = InterleaveInferencer(bagel, cfg, HashTokenizer(), siglip=sig,
                               siglip_cfg=scfg, capacity=BAGEL_CAPACITY,
                               compute_dtype=f32)
    frames = _qa_frames(BAGEL_FP32_FRAMES)
    total = dict.fromkeys(launch_counts(), 0)

    # ---- the QA request ---------------------------------------------------
    fa.reset_launches()
    t_req = time.perf_counter()
    with torch.no_grad():
        ctx = inf.init_gen_context()
        vit_s = append_s = 0.0
        for frame in frames:
            (patches, pos, segs, n), _ = synced(
                lambda: inf._prep_image_bucketed(frame))
            feats, t = synced(lambda: inf.vit_features(patches, pos, segs))
            vit_s += t
            ctx, t = synced(lambda: inf.vit_append(ctx, feats[None],
                                                   pos[None], n))
            append_s += t
        after_append = launch_counts()
        rows_before = ctx["cache"]["len_host"][0]
        ctx, prefill_s = synced(lambda: inf.update_context_text(QA_QUESTION,
                                                                ctx))
        after_prefill = launch_counts()
        answer, decode_s = synced(lambda: inf.gen_text(
            ctx, max_length=BAGEL_FP32_TOKENS))
    req_s = time.perf_counter() - t_req
    qa = launch_counts()
    n_app = BAGEL_FP32_FRAMES * n_layers
    want_append = {"flash_attention_f32_sm90": n_app,
                   "flash_attention_f32_sm90_grouped": n_app,
                   "split_bf16x3": 3 * n_app}
    want_prefill = {"flash_attention_f32_sm90": n_layers,
                    "flash_attention_f32_sm90_causal": n_layers,
                    "flash_attention_f32_sm90_grouped": n_layers,
                    "split_bf16x3": 3 * n_layers}
    check("BAGEL fp32 QA: ViT appends", after_append, want_append)
    check("BAGEL fp32 QA: question prefill",
          {k: after_prefill[k] - after_append[k] for k in after_prefill},
          want_prefill)
    check("BAGEL fp32 QA: decode", {k: qa[k] - after_prefill[k] for k in qa},
          {})
    qa_rec = {"frames": BAGEL_FP32_FRAMES, "cache_rows_before_prefill":
              rows_before, "cache_rows": ctx["cache"]["len_host"][0],
              "cache_dtype": str(ctx["cache"]["k"].dtype),
              "siglip_s": vit_s, "vit_append_s": append_s,
              "prefill_s": prefill_s, "decode_s": decode_s,
              "decode_ms_per_token": decode_s / BAGEL_FP32_TOKENS * 1e3,
              "request_s": req_s, "answer_chars": len(answer or ""),
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              "launches": {k: v for k, v in qa.items() if v}}
    if ctx["cache"]["k"].dtype != f32 or rows_before != \
            BAGEL_FP32_FRAMES * FRAME_ROWS:
        fail(f"BAGEL fp32 QA: cache {ctx['cache']['k'].dtype} with "
             f"{rows_before} rows before the prefill")
    for k, v in qa.items():
        total[k] += v
    del ctx, feats, patches
    gc.collect()
    torch.cuda.empty_cache()

    # ---- packed training at fp32 -----------------------------------------
    with torch.no_grad():
        bagel.llm2vae.w.normal_(0.0, 0.02, generator=gen(62))
    trainable = [p for nm, p in bagel.named_parameters()
                 if "_gen" in nm or nm.split(".")[0] in (
                     "vae2llm", "llm2vae", "time_embedder")]
    for p in trainable:
        p.requires_grad_(True)
    batch, kinds = bagel_train_batch(cfg, TRAIN_SIZES, 5, PACK_TOKENS)
    rng = gen(63)

    def forward():
        return bagel_packed_forward(bagel, cfg, batch, rng=rng,
                                    siglip_params=sig, siglip_cfg=scfg,
                                    compute_dtype=f32, freeze_und=True)

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    with torch.no_grad():
        ev, eval_s = synced(forward)
    eval_loss = float(_train_loss(ev))
    del ev
    after_eval = launch_counts()
    check("BAGEL fp32 packed evaluation forward", after_eval, {
        "flash_attention_f32_sm90": n_layers,
        "flash_attention_f32_sm90_packed": n_layers, "tile_lists": 1,
        "split_bf16x3": 3 * n_layers})
    bagel.zero_grad(set_to_none=True)
    out, fwd_s = synced(forward)
    loss = _train_loss(out)
    _, bwd_s = synced(loss.backward)
    train = launch_counts()
    check("BAGEL fp32 packed training pass",
          {k: train[k] - after_eval[k] for k in train}, dict(
              {nm: n_layers for nm in (
                  "flash_attention_f32_sm90_lse",
                  "flash_attention_f32_sm90_lse_packed",
                  "flash_attention_bwd_dq_f32_sm90",
                  "flash_attention_bwd_dq_f32_sm90_packed",
                  "flash_attention_bwd_dkv_f32_sm90",
                  "flash_attention_bwd_dkv_f32_sm90_packed")},
              tile_lists=1, split_bf16x3=7 * n_layers))
    zero_gen = [nm for nm, p in bagel.named_parameters() if p.requires_grad
                and (p.grad is None or not float(p.grad.abs().max()) > 0.0)]
    pack_rec = {"pack_tokens": PACK_TOKENS, "kind_tokens": dict(zip(
                    ("vlm", "t2i", "edit", "text"), kinds)),
                "eval_forward_s": eval_s, "train_forward_s": fwd_s,
                "backward_s": bwd_s, "loss": float(loss),
                "eval_loss": eval_loss, "gen_leaves_zero": zero_gen[:5],
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                "launches": {k: v for k, v in train.items() if v}}
    for k, v in train.items():
        total[k] += v
    rec = {"phase": "bagel_fp32_main_path", "model": "BAGEL-7B-MoT",
           "compute_dtype": "float32", "layers": n_layers,
           "params": sum(p.numel() for p in bagel.parameters()),
           "weights_gb": weights_gb, "init_s": init_s, "qa_request": qa_rec,
           "packed_training": pack_rec}
    log(json.dumps(rec))
    if not (math.isfinite(pack_rec["loss"]) and math.isfinite(eval_loss)):
        fail("non-finite BAGEL fp32 training loss")
    if zero_gen:
        fail(f"BAGEL fp32: gen leaves without a gradient {zero_gen[:5]}")
    del out, loss, batch, bagel, sig, inf, trainable
    gc.collect()
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# the full DiT fine-tune at its default fp32 policy
# ---------------------------------------------------------------------------

FP32_TRAIN_FRAMES = 81   # 832x480x81: 32,760 tokens padded to 32,768
FP32_TRAIN_STEPS = 2
# depth cut for chip_smoke.py's time limit: 10 of t2v-1.3B's 30 blocks at
# full width (~33 s a step at 30); the fp32 d=128 kernels keep their
# full-width rows in check_f32_d128_kernels
FP32_TRAIN_BLOCKS = 10


def _bwd_check(name, got, ref):
    """dq / dk / dv of an fp32 backward kernel: 1e-4 max|ref| + 1e-4 |ref|
    elementwise and rel. L2 < 1e-4."""
    why = ("fp32 throughout; summation order over the keys (or queries) "
           "and the approximate exp2 (2^-22 relative)")
    err = compare(name, got, ref, atol=1e-4 * float(ref.abs().max()),
                  rtol=1e-4, why=why)
    check_grad(f"{name} rel_l2", got, ref, 1e-4, why)
    return err


F32_SM90_SRC = "univid_tpu_torch/kernels/csrc/flash_attention_f32_sm90.cu"
F32_SPLIT = 6   # bf16 products a split fp32 product (three parts a side)


def _log_f32_ab(call, new_ms, old_ms):
    log(json.dumps({"f32_sm90_vs_cuda_cores": call, "sm90_ms": new_ms,
                    "cuda_cores_ms": old_ms, "speedup": old_ms / new_ms}))


def check_f32_d128_kernels():
    """The fp32 d=128 kernels against their plain versions at the fp32
    fine-tune's shapes: the forward (running max, bounded, and with the
    lse) at self-attention q, k, v [1, 32768, 12, 128], kv_len 32,760, keys
    past it 50.0; the cross shape q [1, 32768, 12, 128] over k, v [1, 512,
    12, 128] (running max, with and without the lse); the rope pre-pass at
    [1, 32768, 12, 128]; the dq and dk/dv kernels at the self and cross
    shapes from the plain residuals; kv_len = 0 rows at [2, 4096, 12, 128]
    (exactly 0, lse +1e30, zero gradients). The route's kernels are those
    of flash_attention_f32_sm90.cu (wgmma on three bf16 parts, after the
    split pre-pass); the CUDA-core kernels they replaced are held against
    the plain version too and timed in turns with them, whole calls and
    kernel against kernel (`f32_sm90_vs_cuda_cores` lines); two backward
    calls give equal bits. Each kernel timed with CUDA events beside its
    plain version and the library's call (SDPA on fp32 inputs, TF32 off;
    its backward alone). Bounds of the sm90 kernels: the split's six bf16
    products a product at the bf16 tensor-core rate (the 1x fp32 work on
    the CUDA cores beside it, `bound_fp32_cuda_cores_ms`). Returns the
    records of the kernels line (self shape; the cross shape on
    `kernel_at_cross_shape` lines)."""
    import torch
    import torch.nn.functional as F

    from univid_tpu_torch.kernels import flash_attention as fa
    from univid_tpu_torch.ops.rope import build_rope_3d

    gen = torch.Generator(device="cuda").manual_seed(11)
    b, l, n, d = 1, 32768, 12, 128
    sc = 1.0 / math.sqrt(d)
    bound = torch.tensor([1.01 * d * sc * fa.LOG2E], device="cuda")
    fwd_tol = dict(atol=1e-5, rtol=1e-4,
                   why="fp32 accuracy on both sides: three bf16 parts a "
                       "side (~2^-24 a product), summation order and the "
                       "approximate exp2 (2^-22 relative)")
    lse_tol = dict(atol=1e-4, rtol=0.0,
                   why="fp32 log2 of an fp32 row sum; summation order and "
                       "the approximate exp2")
    out = {}

    # ---- rope pre-pass (fp32 serving with fused rope) --------------------
    x = qk_normed((b, l, n, d), gen, torch.float32)
    cos, sin = build_rope_3d(d, (21, 30, 52), device="cuda")
    cq, sq, _, _ = fa._pad_tables(fa.build_fused_rope_tables(cos, sin, d), l,
                                  l, fa.LOG2E / math.sqrt(d))
    with torch.no_grad():
        err = compare("rope_rotate_f32", fa._rope_f32(x, cq, sq),
                      fa.rotate(x, cq, sq, torch.float32), atol=0.0,
                      rtol=0.0, why="the same two fp32 products and sum, "
                                    "each rounded once")
        ms = cuda_time(lambda: fa._rope_f32(x, cq, sq), 5)
        plain_ms = cuda_time(lambda: fa.rotate(x, cq, sq, torch.float32), 3)
        # the split pre-pass: three bf16 parts that sum to x within 2^-24
        parts = fa.split_bf16x3(x)
        err_split = compare("split_bf16x3", parts,
                            fa.split_bf16x3_plain(x), atol=0.0, rtol=0.0,
                            why="the same two fp32 differences and three "
                                "round-to-nearest-even conversions")
        split_ms = cuda_time(lambda: fa.split_bf16x3(x), 5)
        split_plain_ms = cuda_time(lambda: fa.split_bf16x3_plain(x), 3)
        del parts
    bms, by = bound_ms(3 * x.numel(), 2 * nbytes(x) + nbytes(cq, sq),
                       H100_FP32_FLOPS)
    out["rope_rotate_f32"] = dict(
        name="rope_rotate_f32", route="cuda",
        source="univid_tpu_torch/kernels/csrc/flash_attention_f32_d128.cu",
        replaces="univid_tpu/kernels/flash_attention.py:157",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=None)
    # reads 4 bytes an element, writes 3 x 2 (no arithmetic worth a bound)
    bms, by = bound_ms(0, 10 * x.numel(), H100_FP32_FLOPS)
    out["split_bf16x3"] = dict(
        name="split_bf16x3", route="cuda", source=F32_SM90_SRC,
        replaces="univid_tpu/kernels/flash_attention.py:44 (operand "
                 "encoding of the fp32 kernels)",
        max_abs_err=err_split, ms=split_ms, plain_ms=split_plain_ms,
        bound_ms=bms, bound_by=by, library_ms=None)
    del x, cos, sin, cq, sq

    # ---- kv_len = 0 rows: exact zeros, lse +1e30, zero gradients --------
    qz, kz, vz, dz = (qk_normed((2, 4096, n, d), gen, torch.float32)
                      for _ in range(4))
    kz[0, 4000:] = 50.0
    vz[0, 4000:] = 50.0
    kvz = torch.tensor([4000, 0], dtype=torch.int32, device="cuda")
    qz = fa._fold(qz, sc)
    with torch.no_grad():
        oz, lz = fa.flash_attention_fwd_folded(qz, kz, vz, kv_len=kvz)
        op, lp = fa.attention_plain(qz, kz, vz, kv_len=kvz,
                                    save_residuals=True)
        compare("flash_attention_f32_sm90_lse kv_len [4000, 0] output", oz,
                op, **fwd_tol)
        compare("flash_attention_f32_sm90_lse kv_len [4000, 0] lse", lz, lp,
                **lse_tol)
        gz = fa.flash_attention_bwd_folded(qz, kz, vz, op, lp, dz,
                                           kv_len=kvz, softmax_scale=sc)
        for nm, gr, ref in zip(("dq", "dk", "dv"), gz, fa._bwd_plain_folded(
                qz, kz, vz, op, lp, dz, kvz, sc)):
            _bwd_check(f"flash_attention_bwd_f32_sm90 kv_len [4000, 0] {nm}",
                       gr, ref)
        if (float(oz[1].abs().max()) != 0.0 or not bool((lz[1] == 1e30).all())
                or any(float(gr[1].abs().max()) != 0.0 for gr in gz)
                or float(gz[1][0, 4000:].abs().max()) != 0.0
                or float(gz[2][0, 4000:].abs().max()) != 0.0):
            fail("fp32 d=128: kv_len = 0 rows are not 0 (lse +1e30), or "
                 "dk / dv past kv_len are not 0")
    del qz, kz, vz, dz, oz, lz, op, lp, gz

    for shape, lk, kv_real in (("self", l, 32760), ("cross", 512, None)):
        q = qk_normed((b, l, n, d), gen, torch.float32)
        k = qk_normed((b, lk, n, d), gen, torch.float32)
        v = torch.randn((b, lk, n, d), generator=gen, device="cuda")
        do = torch.randn((b, l, n, d), generator=gen, device="cuda")
        kv_len = None
        if kv_real is not None:
            kv_len = torch.full((b,), kv_real, dtype=torch.int32,
                                device="cuda")
            k[:, kv_real:] = 50.0
            v[:, kv_real:] = 50.0
        kv_eff = kv_real or lk
        qs = fa._fold(q, sc)
        errs = {}
        with torch.no_grad():
            # serving forward: running max (the fp32 policy's), and bounded;
            # the route (sm90) and the CUDA-core baseline
            want = fa.attention_plain(qs, k, v, kv_len=kv_len)
            want_b = fa.attention_plain(qs, k, v, kv_len=kv_len, bound=bound)
            for key, tag, run in (
                    ("fwd", "flash_attention_f32_sm90",
                     lambda bd: fa._flash_cuda(qs, k, v, kv_len, bd, None)),
                    ("fwd_old", "flash_attention_f32_d128",
                     lambda bd: fa._launch_f32_d128(qs, k, v, kv_len, bd,
                                                    False)[0])):
                errs[key] = max(
                    compare(f"{tag} {shape} running max", run(None), want,
                            **fwd_tol),
                    compare(f"{tag} {shape} bounded", run(bound), want_b,
                            **fwd_tol))
            del want, want_b
            # training forward with the lse, running max and bounded
            o_p, lse_p = fa.attention_plain(qs, k, v, kv_len=kv_len,
                                            save_residuals=True)
            ob_p, lb_p = fa.attention_plain(qs, k, v, kv_len=kv_len,
                                            bound=bound, save_residuals=True)
            for key, tag, run in (
                    ("lse_fwd", "flash_attention_f32_sm90_lse",
                     lambda bd: fa.flash_attention_fwd_folded(
                         qs, k, v, kv_len=kv_len, score_bound=bd)),
                    ("lse_fwd_old", "flash_attention_f32_lse",
                     lambda bd: fa._launch_f32_d128(qs, k, v, kv_len, bd,
                                                    True))):
                o, lse = run(None)
                ob, lb = run(bound)
                errs[key] = max(
                    compare(f"{tag} {shape} output", o, o_p, **fwd_tol),
                    compare(f"{tag} {shape} lse", lse, lse_p, **lse_tol),
                    compare(f"{tag} {shape} bounded output", ob, ob_p,
                            **fwd_tol),
                    compare(f"{tag} {shape} bounded lse", lb, lb_p,
                            **lse_tol))
            del o, lse, ob, lb, ob_p, lb_p
            # the backward alone, from the plain residuals: the route's
            # pair (its four split pre-passes, dq, dk/dv) twice, equal bits,
            # and the CUDA-core pair
            want = fa._bwd_plain_folded(qs, k, v, o_p, lse_p, do, kv_len, sc)
            grads = fa.flash_attention_bwd_folded(qs, k, v, o_p, lse_p, do,
                                                  kv_len=kv_len,
                                                  softmax_scale=sc)
            again = fa.flash_attention_bwd_folded(qs, k, v, o_p, lse_p, do,
                                                  kv_len=kv_len,
                                                  softmax_scale=sc)
            same = all(torch.equal(x, y) for x, y in zip(grads, again))
            log(json.dumps({"check": f"flash_attention_bwd_f32_sm90 {shape}:"
                            " two calls give equal dq, dk, dv bits",
                            "ok": same}))
            if not same:
                fail("the fp32 sm90 backward is not deterministic")
            del again
            dq_o, delta = fa._bwd_dq_f32(qs, k, v, o_p, lse_p, do, kv_len, sc)
            old = (dq_o,) + fa._bwd_dkv_f32(qs, k, v, do, lse_p, delta,
                                            kv_len)
            for impl, got3 in (("sm90", grads), ("cuda_cores", old)):
                sfx = "" if impl == "sm90" else "_old"
                tag = "_sm90" if impl == "sm90" else ""
                for nm, got, ref in zip(("dq", "dk", "dv"), got3, want):
                    key = ("bwd_dq" if nm == "dq" else "bwd_dkv") + sfx
                    errs[key] = max(errs.get(key, 0.0), _bwd_check(
                        f"flash_attention_bwd_f32{tag} {shape} {nm}", got,
                        ref))
                if kv_real is not None and (
                        float(got3[1][:, kv_real:].abs().max()) != 0.0
                        or float(got3[2][:, kv_real:].abs().max()) != 0.0):
                    fail(f"fp32 backward ({impl}): dk / dv past kv_len are "
                         "not 0")
            del want, grads, old
            # times: whole calls and kernels alone, each sm90 one in turns
            # with the CUDA-core one it replaced (old, new, new, old)
            parts = [fa.split_bf16x3(x) for x in (qs, k, v, do)]
            ms, old_ms = {}, {}
            ms["fwd_call"], old_ms["fwd"] = ab_time(
                lambda: fa._flash_cuda(qs, k, v, kv_len, None, None),
                lambda: fa._launch_f32_d128(qs, k, v, kv_len, None, False),
                2)
            ms["lse_fwd_call"], old_ms["lse_fwd"] = ab_time(
                lambda: fa.flash_attention_fwd_folded(qs, k, v,
                                                      kv_len=kv_len),
                lambda: fa._launch_f32_d128(qs, k, v, kv_len, None, True), 2)
            ms["bwd_call"], old_ms["bwd"] = ab_time(
                lambda: fa.flash_attention_bwd_folded(
                    qs, k, v, o_p, lse_p, do, kv_len=kv_len,
                    softmax_scale=sc),
                lambda: (fa._bwd_dq_f32(qs, k, v, o_p, lse_p, do, kv_len, sc),
                         fa._bwd_dkv_f32(qs, k, v, do, lse_p, delta, kv_len)),
                1)
            ms["fwd"] = cuda_time(lambda: fa._fwd_f32_sm90_parts(
                *parts[:3], kv_len, None, False), 2)
            ms["lse_fwd"] = cuda_time(lambda: fa._fwd_f32_sm90_parts(
                *parts[:3], kv_len, None, True), 2)
            ms["bwd_dq"], old_ms["bwd_dq"] = ab_time(
                lambda: fa._bwd_dq_f32_sm90_parts(*parts, o_p, do, lse_p,
                                                  kv_len, sc),
                lambda: fa._bwd_dq_f32(qs, k, v, o_p, lse_p, do, kv_len, sc),
                1)
            ms["bwd_dkv"], old_ms["bwd_dkv"] = ab_time(
                lambda: fa._bwd_dkv_f32_sm90_parts(*parts, lse_p, delta,
                                                   kv_len),
                lambda: fa._bwd_dkv_f32(qs, k, v, do, lse_p, delta, kv_len),
                1)
            del parts
            for call, key in (("forward", "fwd"), ("forward with lse",
                                                  "lse_fwd"),
                              ("backward pair", "bwd")):
                _log_f32_ab(f"{shape} {call} (whole call)",
                            ms[f"{key}_call"], old_ms[key])
            for key in ("bwd_dq", "bwd_dkv"):
                _log_f32_ab(f"{shape} {key} kernel", ms[key], old_ms[key])
            plain_fwd = cuda_time(lambda: fa.attention_plain(
                qs, k, v, kv_len=kv_len), 1, warmup=0)
            plain_lse = cuda_time(lambda: fa.attention_plain(
                qs, k, v, kv_len=kv_len, save_residuals=True), 1, warmup=0)
            plain_bwd = cuda_time(lambda: fa._bwd_plain_folded(
                qs, k, v, o_p, lse_p, do, kv_len, sc), 1, warmup=0)
            qg, kg, vg = (x.transpose(1, 2)[:, :, :m] for x, m in
                          ((qs, l), (k, kv_eff), (v, kv_eff)))
            lib_fwd = cuda_time(lambda: F.scaled_dot_product_attention(
                qg, kg, vg, scale=1.0 / fa.LOG2E), 3)
        # SDPA's backward on the live keys, from a forward that saved its
        # logsumexp (inputs that need a gradient)
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (qg, kg, vg))
        dog = do.transpose(1, 2)
        ref_out = F.scaled_dot_product_attention(qg, kg, vg,
                                                 scale=1.0 / fa.LOG2E)
        lib_bwd = cuda_time(lambda: torch.autograd.grad(
            ref_out, (qg, kg, vg), dog, retain_graph=True), 2)
        del ref_out, qg, kg, vg, dog

        mm = 2.0 * b * n * l * kv_eff * d   # flops of one product
        row = nbytes(qs)                    # one [B, Lq, N, D] fp32 tensor
        kvb = nbytes(k, v)
        lseb = b * n * l * 4
        # (products, bytes): the function's, whichever kernel computes it
        work = {
            "fwd": (2, 2 * row + kvb),
            "lse_fwd": (2, 2 * row + kvb + lseb),
            # s, dp, dq = dS k; reads qs, o, dO, k, v, lse; writes dq, delta
            "bwd_dq": (3, 4 * row + kvb + 2 * lseb),
            # s^T, dp^T, dv, dk; reads qs, dO, k, v, lse, delta; writes dk, dv
            "bwd_dkv": (4, 2 * row + 2 * kvb + 2 * lseb),
        }
        old_src = {
            "fwd": "univid_tpu_torch/kernels/csrc/flash_attention_f32_d128.cu",
            "bwd": "univid_tpu_torch/kernels/csrc/flash_attention_bwd_f32.cu"}
        meta = {
            "fwd": ("flash_attention_f32_sm90", "flash_attention_f32_d128",
                    "univid_tpu/kernels/flash_attention.py:"
                    + ("44" if shape == "self" else "355"),
                    plain_fwd, lib_fwd),
            "lse_fwd": ("flash_attention_f32_sm90_lse",
                        "flash_attention_f32_lse",
                        "univid_tpu/kernels/flash_attention.py:343",
                        plain_lse, lib_fwd),
            "bwd_dq": ("flash_attention_bwd_dq_f32_sm90",
                       "flash_attention_bwd_dq_f32",
                       "univid_tpu/kernels/flash_attention.py:831",
                       plain_bwd, lib_bwd),
            "bwd_dkv": ("flash_attention_bwd_dkv_f32_sm90",
                        "flash_attention_bwd_dkv_f32",
                        "univid_tpu/kernels/flash_attention.py:940",
                        plain_bwd, lib_bwd),
        }
        for key, (name, old_name, rep, plain_ms, lib_ms) in meta.items():
            products, nb = work[key]
            split_b = bound_ms(F32_SPLIT * products * mm, nb,
                               H100_BF16_FLOPS)
            fp32_b = bound_ms(products * mm, nb, H100_FP32_FLOPS)
            new = dict(name=name, route="cuda", source=F32_SM90_SRC,
                       replaces=rep, max_abs_err=errs[key], ms=ms[key],
                       plain_ms=plain_ms, bound_ms=split_b[0],
                       bound_by=split_b[1], library_ms=lib_ms,
                       bound_fp32_cuda_cores_ms=fp32_b[0],
                       replaced_ms=old_ms[key])
            if key.startswith("bwd"):
                new["pair_call_ms"] = ms["bwd_call"]
                new["replaced_pair_ms"] = old_ms["bwd"]
            else:
                new["call_ms"] = ms[f"{key}_call"]
            base = dict(name=old_name, route="cuda",
                        source=old_src["bwd" if key.startswith("bwd")
                                       else "fwd"],
                        replaces=rep, max_abs_err=errs[f"{key}_old"],
                        ms=old_ms[key], plain_ms=plain_ms,
                        bound_ms=fp32_b[0], bound_by=fp32_b[1],
                        library_ms=lib_ms)
            for rec in (new, base):
                if shape == "self":
                    out[rec["name"]] = rec
                else:
                    log(json.dumps({"kernel_at_cross_shape": rec}))
        del q, k, v, do, qs, o_p, lse_p, delta, dq_o
        torch.cuda.empty_cache()
    for rec in out.values():
        log(json.dumps({"kernel": rec}))
    return out


# ---------------------------------------------------------------------------
# the fp32 d=128 kernels' masked modes (BAGEL-7B-MoT at fp32 compute)
# ---------------------------------------------------------------------------

F32_MASKED_REPLACES = {
    "causal": "univid_tpu/kernels/flash_attention.py:161",
    "grouped": "univid_tpu/kernels/flash_attention.py:44 (grouped kv heads: "
               "univid_tpu/models/bagel/qwen2_mot.py:289 repeats them)",
    "segments": "univid_tpu/kernels/flash_attention.py:191",
    "packed": "univid_tpu/kernels/flash_attention.py:198",
}
F32_MASKED_BWD_REPLACES = {
    "dq": "univid_tpu/kernels/flash_attention.py:831 (_mask_scores :794)",
    "dkv": "univid_tpu/kernels/flash_attention.py:940 (_mask_scores :794)",
}
# the kernels-line records of check_f32_masked_kernels
F32_MASKED_NAMES = (
    "flash_attention_f32_sm90_causal", "flash_attention_f32_sm90_grouped",
    *(f"{nm}_{mode}" for mode in ("packed", "segments") for nm in (
        "flash_attention_f32_sm90", "flash_attention_f32_sm90_lse",
        "flash_attention_bwd_dq_f32_sm90", "flash_attention_bwd_dkv_f32_sm90")),
    "flash_attention_f32_sm90_lse_causal",
    "flash_attention_bwd_dq_f32_sm90_causal",
    "flash_attention_bwd_dkv_f32_sm90_causal")


def _f32_masked_case(tag, q, k, v, kv_len, masks, do=None, fwd=True,
                     lse=True):
    """Hold the fp32 d=128 kernels' masked (or grouped) modes against their
    plain versions on one case, q raw [B, Lq, N, 128], k, v [B, Lk, N /
    group, 128]: the forward (`fwd`), the forward with the lse (`lse`),
    and with `do` the backward from the plain residuals (dq and dk/dv, two
    calls bitwise equal). Rows with no live key exactly 0 with lse +1e30,
    keys no row sees exactly 0 in dk and dv. Each kernel timed alone on
    the split parts (CUDA events) and as the whole call (its split
    pre-passes, and the tile lists in the segment and packed modes),
    beside the plain version and SDPA with the materialized boolean mask
    (kv heads repeated for it); bounds over the live (row, key) pairs: six
    bf16 products a product at 989 TFLOP/s (`bound_ms`), the 1x fp32 work
    at 67 TFLOP/s beside it (`bound_fp32_cuda_cores_ms`). Returns {kind:
    record fields}."""
    import torch

    from univid_tpu_torch.kernels import flash_attention as fa

    b, lq, n, d = q.shape
    lk = k.shape[1]
    sc = d ** -0.5
    qs = fa._fold(q, sc)
    fwd_tol = dict(atol=1e-5, rtol=1e-4,
                   why="fp32 accuracy on both sides: three bf16 parts a "
                       "side (~2^-24 a product), summation order and the "
                       "approximate exp2 (2^-22 relative)")
    lse_tol = dict(atol=1e-4, rtol=0.0,
                   why="fp32 log2 of an fp32 row sum; summation order and "
                       "the approximate exp2")
    allowed = ~fa._dead(0, lq, lk, q.device, kv_len=kv_len,
                        **masks).expand(b, 1, lq, lk)
    live = int(allowed.sum())
    no_key = ~allowed[:, 0].any(-1)                 # [B, Lq]
    mm = 2.0 * live * n * d                         # one product, live pairs
    row, kvb = nbytes(qs), nbytes(k, v)
    lseb = b * n * lq * 4
    codes = sum(nbytes(masks[key]) for key in ("q_segments", "kv_segments")
                if masks.get(key) is not None)
    kr, vr = fa.repeat_kv(k, n), fa.repeat_kv(v, n)
    mode, fwd_l, bwd_l = fa._f32_masks(qs, k, kv_len, None, bwd=do is not None,
                                       **masks)
    out = {}

    def record(kind, err, ms, call_ms, plain_ms, lib_ms, products, nb):
        split_b = bound_ms(F32_SPLIT * products * mm, nb + codes,
                           H100_BF16_FLOPS)
        fp32_b = bound_ms(products * mm, nb + codes, H100_FP32_FLOPS)
        out[kind] = dict(max_abs_err=err, ms=ms, call_ms=call_ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=split_b[0], bound_by=split_b[1],
                         bound_fp32_cuda_cores_ms=fp32_b[0],
                         live_pairs=live, share_of_bound=split_b[0] / ms)
        log(json.dumps({"f32_masked_kernel": f"{tag} {kind}", **out[kind]}))

    with torch.no_grad():
        parts = [fa.split_bf16x3(x) for x in (qs, k, v)]
        lib_fwd = _sdpa_masked_ms(qs, kr, vr, allowed)
        o_p, lse_p = fa.attention_plain(qs, k, v, kv_len=kv_len,
                                        save_residuals=True, **masks)
        if fwd:
            got = fa._flash_cuda(qs, k, v, kv_len, None, None, **masks)
            err = compare(f"{tag} forward", got, o_p, **fwd_tol)
            if not bool((got[no_key] == 0).all()):
                fail(f"{tag}: rows with no live key are not 0")
            del got
            record("fwd", err, cuda_time(lambda: fa._fwd_f32_sm90_parts(
                       *parts, kv_len, None, False, mode, fwd_l, **masks), 3),
                   cuda_time(lambda: fa._flash_cuda(
                       qs, k, v, kv_len, None, None, **masks), 3),
                   cuda_time(lambda: fa.attention_plain(
                       qs, k, v, kv_len=kv_len, **masks), 1, warmup=0),
                   lib_fwd, 2, 2 * row + kvb)
        if lse:
            o, lse_t = fa.flash_attention_fwd_folded(qs, k, v, kv_len=kv_len,
                                                     **masks)
            err = max(compare(f"{tag} forward with lse, output", o, o_p,
                              **fwd_tol),
                      compare(f"{tag} forward with lse, lse", lse_t, lse_p,
                              **lse_tol))
            pad_lse = lse_t.transpose(1, 2)[no_key]
            if (not bool((o[no_key] == 0).all())
                    or not bool((pad_lse == 1e30).all())):
                fail(f"{tag}: rows with no live key are not 0 with lse "
                     "+1e30")
            del o, lse_t
            record("lse_fwd", err, cuda_time(lambda: fa._fwd_f32_sm90_parts(
                       *parts, kv_len, None, True, mode, fwd_l, **masks), 3),
                   cuda_time(lambda: fa.flash_attention_fwd_folded(
                       qs, k, v, kv_len=kv_len, **masks), 3),
                   cuda_time(lambda: fa.attention_plain(
                       qs, k, v, kv_len=kv_len, save_residuals=True,
                       **masks), 1, warmup=0),
                   lib_fwd, 2, 2 * row + kvb + lseb)
        if do is not None:
            want = fa._bwd_plain_folded(qs, k, v, o_p, lse_p, do, kv_len, sc,
                                        **masks)
            grads = fa.flash_attention_bwd_folded(
                qs, k, v, o_p, lse_p, do, kv_len=kv_len, softmax_scale=sc,
                **masks)
            again = fa.flash_attention_bwd_folded(
                qs, k, v, o_p, lse_p, do, kv_len=kv_len, softmax_scale=sc,
                **masks)
            same = all(torch.equal(x, y) for x, y in zip(grads, again))
            log(json.dumps({"check": f"{tag} backward: two calls give equal "
                            "dq, dk, dv bits", "ok": same}))
            if not same:
                fail(f"{tag}: the fp32 masked backward is not deterministic")
            errs = [_bwd_check(f"{tag} backward {nm}", g, w)
                    for nm, g, w in zip(("dq", "dk", "dv"), grads, want)]
            no_row = ~allowed[:, 0].any(1)          # [B, Lk]
            if (not bool((grads[0][no_key] == 0).all())
                    or not all(bool((g[no_row] == 0).all())
                               for g in grads[1:])):
                fail(f"{tag}: dq of rows with no key, or dk / dv of keys no "
                     "row sees, are not 0")
            del want, grads, again
            parts.append(fa.split_bf16x3(do))
            _, delta = fa._bwd_dq_f32_sm90_parts(*parts, o_p, do, lse_p,
                                                 kv_len, sc, mode, fwd_l,
                                                 **masks)
            call_ms = cuda_time(lambda: fa.flash_attention_bwd_folded(
                qs, k, v, o_p, lse_p, do, kv_len=kv_len, softmax_scale=sc,
                **masks), 2)
            plain_ms = cuda_time(lambda: fa._bwd_plain_folded(
                qs, k, v, o_p, lse_p, do, kv_len, sc, **masks), 1, warmup=0)
            lib_bwd = _sdpa_masked_ms(qs, kr, vr, allowed, do)
            record("bwd_dq", errs[0], cuda_time(
                lambda: fa._bwd_dq_f32_sm90_parts(
                    *parts, o_p, do, lse_p, kv_len, sc, mode, fwd_l,
                    **masks), 2), call_ms, plain_ms, lib_bwd, 3,
                   4 * row + kvb + 2 * lseb)
            record("bwd_dkv", max(errs[1:]), cuda_time(
                lambda: fa._bwd_dkv_f32_sm90_parts(
                    *parts, lse_p, delta, kv_len, mode, bwd_l, **masks), 2),
                   call_ms, plain_ms, lib_bwd, 4,
                   2 * row + 2 * kvb + 2 * lseb)
            del delta
        del parts, o_p, lse_p
    del qs, kr, vr, allowed
    torch.cuda.empty_cache()
    return out


def _f32_record(name, mode, kind, vals):
    """A kernels-line record of an fp32 masked case's kind."""
    rep = (F32_MASKED_BWD_REPLACES["dq" if kind == "bwd_dq" else "dkv"]
           if kind.startswith("bwd") else F32_MASKED_REPLACES[mode])
    return dict(name=name, route="cuda", source=F32_SM90_SRC, replaces=rep,
                counter=name, **vals)


def check_f32_masked_kernels():
    """The fp32 d=128 kernels' masked and grouped modes (BAGEL-7B-MoT at fp32
    compute) against their plain versions on the card, at the path's
    shapes, qk-normed q and k, fp32 throughout (`_f32_masked_case`):
      * the question prefill: q [1, 64, 28, 128] over 4 kv heads of a
        20,480-row cache, q_offsets 19,168, kv_len 19,215 (causal,
        grouped; the forward alone, as the prefill runs it);
      * a batch of 16 prefills, [16, 64, 28, 128] over 2,624 rows, offsets
        1,198 + 37 r, kv_len offsets + 47 (causal, grouped);
      * the square prefill [1, 2048, 28, 128] over 4 kv heads, offset 0
        (causal, grouped);
      * the ViT append [1, 2112, 28, 128] over 4 kv heads of the cache,
        kv_len 19,168 (grouped, kv_len; non-causal);
      * image generation's flow pass [1, 4160, 28, 128] over 4,162 keys
        padded to 4,224 (grouped, kv_len);
      * packed [1, 4096, 28, 128] on the training pack's codes: forward,
        with the lse, dq and dk/dv (the packed pass repeats the kv heads);
      * segments [2, 2048, 12, 128], 3 segments a row: the same four;
      * causal [1, 2048, 28, 128] with the lse and the causal backward.
    Keys no query sees (cache slots at or past kv_len) hold 50.0; a key
    some row sees is drawn as the rest. Bounds PERF.md s2's fp32 d=128
    row.
    Returns the kernels-line records (the path's shapes: the prefill, the
    ViT append, the pack; segments and the causal backward at theirs)."""
    import torch

    from univid_tpu_torch.kernels import flash_attention as fa
    from univid_tpu_torch.models.bagel.bagel import BagelConfig

    gen = torch.Generator(device="cuda").manual_seed(26)
    n, nk, d = 28, 4, 128
    f32 = torch.float32
    dev = "cuda"

    def rand(shape, normed=True):
        if normed:
            return qk_normed(shape, gen, f32)
        return torch.randn(shape, generator=gen, device=dev)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    def cache_case(b, lq, lk, heads, kv_len):
        """q [b, lq, n], a cache k, v [b, lk, heads]: slots at or past kv_len
        hold 50.0."""
        q, k, v = rand((b, lq, n, d)), rand((b, lk, heads, d)), \
            rand((b, lk, heads, d), False)
        for r, kl in enumerate(kv_len):
            k[r, kl:] = 50.0
            v[r, kl:] = 50.0
        return q, k, v

    records = {}
    t0 = time.perf_counter()
    # the question prefill over the 16-frame cache
    q, k, v = cache_case(1, 64, BAGEL_CAPACITY, nk, [19215])
    case = _f32_masked_case("f32 causal prefill [1, 64, 28, 128] / 4 kv, "
                            "20480-row cache", q, k, v, i32([19215]),
                            dict(causal=True, q_offsets=i32([19168])),
                            lse=False)
    records["flash_attention_f32_sm90_causal"] = _f32_record(
        "flash_attention_f32_sm90_causal", "causal", "fwd", case["fwd"])
    # 16 prefills at once
    offs = [1198 + 37 * r for r in range(16)]
    kvl = [o + 47 for o in offs]
    q, k, v = cache_case(16, 64, 2624, nk, kvl)
    _f32_masked_case("f32 causal B=16 [16, 64, 28, 128] / 4 kv, 2624 rows",
                     q, k, v, i32(kvl), dict(causal=True, q_offsets=i32(offs)),
                     lse=False)
    # the square prefill
    q, k, v = cache_case(1, 2048, 2048, nk, [2048])
    _f32_masked_case("f32 causal square [1, 2048, 28, 128] / 4 kv", q, k, v,
                     None, dict(causal=True), lse=False)
    # the ViT append over the cache (non-causal, grouped, kv_len)
    q, k, v = cache_case(1, 2112, BAGEL_CAPACITY, nk, [19168])
    case = _f32_masked_case("f32 grouped ViT append [1, 2112, 28, 128] / 4 "
                            "kv, kv_len 19168", q, k, v, i32([19168]), {},
                            lse=False)
    rec = _f32_record("flash_attention_f32_sm90_grouped", "grouped", "fwd",
                      case["fwd"])
    rec["counter"] = "flash_attention_f32_sm90_grouped"
    records[rec["name"]] = rec
    # image generation's flow pass
    q, k, v = cache_case(1, 4160, 4224, nk, [4162])
    _f32_masked_case("f32 grouped flow pass [1, 4160, 28, 128] / 4 kv, "
                     "4162 keys", q, k, v, i32([4162]), {}, lse=False)
    del q, k, v
    # packed, the training pack's codes (kv heads repeated)
    batch, _ = bagel_train_batch(BagelConfig(), TRAIN_SIZES, 5, PACK_TOKENS)
    codes_np = batch["mask_codes"]
    real = int((codes_np >> 16 > 0).sum())
    codes = torch.tensor(codes_np, dtype=torch.int32, device=dev)[None]
    # the pack's document-0 pad tokens see one another: random keys there
    # too (keys at 50.0 that a row sees make its dq a cancellation of
    # ~1e-3 relative noise on both sides, no kernel's error)
    q, k, v, do = (rand((1, PACK_TOKENS, n, d), i < 2) for i in range(4))
    log(json.dumps({"check": "f32 packed pack", "real_tokens": real}))
    case = _f32_masked_case("f32 packed [1, 4096, 28, 128]", q, k, v, None,
                            dict(q_segments=codes, kv_segments=codes,
                                 packed_mode=True), do=do)
    for kind, name in (("fwd", "flash_attention_f32_sm90_packed"),
                       ("lse_fwd", "flash_attention_f32_sm90_lse_packed"),
                       ("bwd_dq", "flash_attention_bwd_dq_f32_sm90_packed"),
                       ("bwd_dkv", "flash_attention_bwd_dkv_f32_sm90_packed")):
        records[name] = _f32_record(name, "packed", kind, case[kind])
    del q, k, v, do
    # segments, 3 a row
    b, l, ns = 2, 2048, 12
    segs = torch.zeros((b, l), dtype=torch.int32, device=dev)
    for r, (c1, c2) in enumerate(((700, 1400), (300, 1650))):
        segs[r, c1:c2] = 1
        segs[r, c2:] = 2
    q, k, v, do = (rand((b, l, ns, d), i < 2) for i in range(4))
    case = _f32_masked_case("f32 segments [2, 2048, 12, 128]", q, k, v,
                            None, dict(q_segments=segs,
                                       kv_segments=segs.clone()), do=do)
    for kind, name in (("fwd", "flash_attention_f32_sm90_segments"),
                       ("lse_fwd", "flash_attention_f32_sm90_lse_segments"),
                       ("bwd_dq", "flash_attention_bwd_dq_f32_sm90_segments"),
                       ("bwd_dkv",
                        "flash_attention_bwd_dkv_f32_sm90_segments")):
        records[name] = _f32_record(name, "segments", kind, case[kind])
    del q, k, v, do
    # the causal forward with the lse and the causal backward
    q, k, v, do = (rand((1, 2048, n, d), i < 2) for i in range(4))
    case = _f32_masked_case("f32 causal [1, 2048, 28, 128] with lse and "
                            "backward", q, k, v, None, dict(causal=True),
                            do=do, fwd=False)
    for kind, name in (("lse_fwd", "flash_attention_f32_sm90_lse_causal"),
                       ("bwd_dq", "flash_attention_bwd_dq_f32_sm90_causal"),
                       ("bwd_dkv", "flash_attention_bwd_dkv_f32_sm90_causal")):
        records[name] = _f32_record(name, "causal", kind, case[kind])
    del q, k, v, do
    torch.cuda.empty_cache()
    log(json.dumps({"phase": "check_f32_masked_kernels",
                    "seconds": time.perf_counter() - t0}))
    for rec in records.values():
        log(json.dumps({"kernel": rec}))
    return records


def _small_fp32_dit(cfg):
    """A seeded fp32 WanDiT on the CPU with the zero head redrawn (it would
    block every gradient) and non-unit qk gains (they move the bounds)."""
    import torch

    from univid_tpu_torch.models.wan.dit import WanDiT

    gen = torch.Generator().manual_seed(0)
    dit = WanDiT(cfg, dtype=torch.float32, device="cpu", gen=gen)
    with torch.no_grad():
        dit.head.head.w.normal_(0.0, 0.02, generator=gen)
        for blk in dit.blocks:
            for a in (blk.self_attn, blk.cross_attn):
                a.norm_q.uniform_(0.5, 1.5, generator=gen)
                a.norm_k.uniform_(0.5, 1.5, generator=gen)
    return dit


def fp32_train_parity():
    """The fp32 policy on the card (kernels) against the CPU (plain
    versions), same weights and inputs, on a 2-layer d=128 DiT (dim 256):
    two make_dit_train_step steps at FP32_POLICY (remat 'attn', 240 tokens
    padded to 256), held as tests/test_torch_fp32_train.py holds the port
    against JAX (losses 1e-5 relative, each parameter 1e-5 relative + 1e-4
    absolute, each tensor's change 5e-4 relative L2); then the fp32 t2v
    pipeline (WanTI2VPipeline at FP32_POLICY, fused rope, batch-2 CFG, 4
    steps, the t2v-1.3B VAE in fp32) at 64x64x9, latents and video rel. L2
    < 1e-4. Returns the pipeline's launches on the card (the fp32 d=128
    serving forward and rope pre-pass)."""
    import copy

    import numpy as np
    import torch

    from univid_tpu_torch.core.config import (WAN_CONFIGS, WanDiTConfig,
                                              WanModelSpec)
    from univid_tpu_torch.core.dtypes import FP32_POLICY
    from univid_tpu_torch.kernels import flash_attention as fa
    from univid_tpu_torch.models.wan.vae_api import WanVAE, vae_decode
    from univid_tpu_torch.ops.rope import build_rope_3d
    from univid_tpu_torch.pipelines.ti2v import WanTI2VPipeline
    from univid_tpu_torch.train import trainer

    cfg = WanDiTConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=2,
                       in_dim=16, out_dim=16, text_dim=32, freq_dim=32,
                       text_len=8, patch_size=(1, 2, 2))
    dit = _small_fp32_dit(cfg)
    rng = np.random.default_rng(12)
    grid = (4, 6, 10)   # 240 tokens
    batch = {"latents": rng.standard_normal((1, 4, 12, 20, 16)),
             "noise": rng.standard_normal((1, 4, 12, 20, 16)),
             "t": np.array([500.0]),
             "context": rng.standard_normal((1, 8, 32)) * 0.5}

    def train(device):
        model = copy.deepcopy(dit).to(device)
        state, tx = trainer.init_train_state(model,
                                             trainer.make_optimizer(1e-3))
        step = trainer.make_dit_train_step(
            cfg, tx, rope=build_rope_3d(128, grid, device=device),
            remat_blocks="attn", seq_pad_to=256)
        losses = []
        for _ in range(2):
            state, loss = step(state, {
                k: torch.as_tensor(v, dtype=torch.float32).to(device)
                for k, v in batch.items()})
            losses.append(float(loss))
        return losses, {nm: p.detach().cpu()
                        for nm, p in model.named_parameters()}

    fa.reset_launches()
    loss_gpu, par_gpu = train("cuda")
    used = {k: c for k, c in launch_counts().items() if c}
    loss_cpu, par_cpu = train("cpu")
    start = {nm: p.detach() for nm, p in dit.named_parameters()}
    param_excess = max(float(((par_gpu[nm] - w).abs()
                              - (1e-4 + 1e-5 * w.abs())).max())
                       for nm, w in par_cpu.items())
    moved = {nm: rel_l2(par_gpu[nm] - start[nm], w - start[nm])
             for nm, w in par_cpu.items()}
    worst = sorted(moved.items(), key=lambda kv: -kv[1])[:3]
    loss_err = max(abs(a - c) / abs(c) for a, c in zip(loss_gpu, loss_cpu))
    # on the sm90 kernels: 12 forwards with lse (3 split pre-passes each),
    # 8 backward pairs (4 each)
    want = {"flash_attention_f32_sm90_lse": 12,
            "flash_attention_bwd_dq_f32_sm90": 8,
            "flash_attention_bwd_dkv_f32_sm90": 8,
            "split_bf16x3": 12 * 3 + 8 * 4}
    out = {"check": "fp32_train_parity", "loss_card": loss_gpu,
           "loss_cpu": loss_cpu, "loss_rel_err": loss_err,
           "param_excess_over_1e-4+1e-5|ref|": param_excess,
           "worst_change_rel_l2": worst, "limits": [1e-5, 5e-4],
           "why": "fp32 on both sides: summation orders of cuBLAS, the CPU "
                  "and the kernels; AdamW moves an element whose gradient "
                  "is at fp32 noise by a rounding-dependent part of lr",
           "launches": used, "expected_launches": want}
    out["ok"] = (loss_err < 1e-5 and param_excess <= 0.0
                 and worst[0][1] < 5e-4 and used == want
                 and all(math.isfinite(x) for x in loss_gpu))
    log(json.dumps(out))
    if not out["ok"]:
        fail("the fp32 fine-tune step on the card disagrees with the CPU, "
             "or went through other kernels")

    # fp32 serving: the t2v pipeline with fused rope
    base = WAN_CONFIGS["t2v-1.3B"]
    spec = WanModelSpec(name="smoke-fp32-d128", dit=cfg, vae=base.vae,
                        generation=base.generation)
    vae = WanVAE(base.vae, dtype=torch.float32, device="cpu",
                 gen=torch.Generator().manual_seed(1))
    noise = torch.as_tensor(rng.standard_normal((1, 3, 8, 8, 16)),
                            dtype=torch.float32)
    ctx, nctx = (torch.as_tensor(rng.standard_normal((1, 8, 32)) * 0.5,
                                 dtype=torch.float32) for _ in range(2))

    def serve(device):
        d, v = copy.deepcopy(dit).to(device), copy.deepcopy(vae).to(device)
        pipe = WanTI2VPipeline(spec, d, v, policy=FP32_POLICY)
        fn = pipe.denoise_fn((3, 8, 8), 48, 4, 5.0, 5.0, "unipc", None)
        with torch.no_grad():
            x0 = fn(d, noise.to(device), ctx.to(device), nctx.to(device),
                    torch.zeros_like(noise).to(device))
            return x0.float().cpu(), vae_decode(v, x0).float().cpu()

    fa.reset_launches()
    x_gpu, v_gpu = serve("cuda")
    serving = launch_counts()
    x_cpu, v_cpu = serve("cpu")
    out = {"check": "fp32_serve_parity", "latent_rel_l2": rel_l2(x_gpu, x_cpu),
           "video_rel_l2": rel_l2(v_gpu, v_cpu), "limit": 1e-4,
           "why": "fp32 policy on both sides: summation orders only, over 2 "
                  "blocks x 4 UniPC steps and the decode",
           "launches": {k: c for k, c in serving.items() if c},
           "finite": bool(torch.isfinite(v_gpu).all())}
    out["ok"] = (out["finite"] and out["latent_rel_l2"] < 1e-4
                 and out["video_rel_l2"] < 1e-4
                 and serving["flash_attention_f32_sm90"] > 0
                 and serving["rope_rotate_f32"] > 0
                 and serving["flash_attention_f32_d128"] == 0)
    log(json.dumps(out))
    if not out["ok"]:
        fail("the fp32 t2v pipeline on the card disagrees with the CPU, or "
             "did not run the fp32 d=128 sm90 kernel")
    return serving


def fp32_train_main_path(n_steps):
    """The full DiT fine-tune at its default policy: make_dit_train_step
    (FP32_POLICY) on t2v-1.3B at full width (dim 1536, 12 heads of d=128),
    depth cut to FP32_TRAIN_BLOCKS of its 30 layers (fp32 weights drawn on
    the card from seeds, the zero head redrawn so that gradients reach
    every block), latents [1, 21, 60,
    104, 16] (832x480x81: 32,760 tokens padded to 32,768), a [1, 512,
    4096] context, t = 500, remat 'attn', AdamW from make_optimizer(1e-4);
    `n_steps` steps with their launches asserted, seconds, peak memory,
    finite losses, every block's weights moved; one more step profiled.
    Returns the launch counts of the timed steps."""
    import dataclasses
    import gc

    import torch

    from univid_tpu_torch.core.config import WAN_CONFIGS, latent_shape
    from univid_tpu_torch.kernels import flash_attention as fa
    from univid_tpu_torch.models.wan.dit import WanDiT
    from univid_tpu_torch.ops.rope import build_rope_3d
    from univid_tpu_torch.train import trainer

    gc.collect()
    torch.cuda.empty_cache()
    spec = WAN_CONFIGS["t2v-1.3B"]
    cfg = dataclasses.replace(spec.dit, num_layers=FP32_TRAIN_BLOCKS)
    _, f, lh, lw = latent_shape(spec, 832, 480, FP32_TRAIN_FRAMES)
    grid = (f, lh // 2, lw // 2)
    tokens = grid[0] * grid[1] * grid[2]
    pad_to = -(-tokens // 64) * 64

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    t0 = time.perf_counter()
    dit = WanDiT(cfg, dtype=torch.float32, device="cuda", gen=gen(60))
    with torch.no_grad():   # the zero head blocks every gradient
        dit.head.head.w.normal_(0.0, 0.02, generator=gen(61))
    state, tx = trainer.init_train_state(dit, trainer.make_optimizer(1e-4))
    step = trainer.make_dit_train_step(
        cfg, tx, rope=build_rope_3d(cfg.head_dim, grid, device="cuda"),
        remat_blocks="attn", seq_pad_to=pad_to)
    c = spec.vae.z_dim
    batch = {"latents": torch.randn((1, f, lh, lw, c), generator=gen(62),
                                    device="cuda"),
             "noise": torch.randn((1, f, lh, lw, c), generator=gen(63),
                                  device="cuda"),
             "context": torch.randn((1, cfg.text_len, cfg.text_dim),
                                    generator=gen(64), device="cuda"),
             "t": torch.tensor([500.0], device="cuda")}
    blocks = {nm: p.detach().cpu() for nm, p in dit.named_parameters()
              if nm.startswith("blocks.")}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # per step, remat 'attn': a self-attention forward with lse in every
    # layer, a cross forward and its recompute in the backward, one backward
    # pair per differentiated call, all on the sm90 kernels (3 split
    # pre-passes a forward, 4 a backward); none on the CUDA-core kernels
    per_step = dict(dict.fromkeys(launch_counts(), 0),
                    flash_attention_f32_sm90_lse=3 * cfg.num_layers,
                    flash_attention_bwd_dq_f32_sm90=2 * cfg.num_layers,
                    flash_attention_bwd_dkv_f32_sm90=2 * cfg.num_layers,
                    split_bf16x3=(9 + 8) * cfg.num_layers)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    seconds, losses = [], []
    for i in range(n_steps):
        before = launch_counts()
        t1 = time.perf_counter()
        state, loss = step(state, batch)
        losses.append(float(loss))   # waits for the step
        seconds.append(time.perf_counter() - t1)
        counts = {k: v - before[k] for k, v in launch_counts().items()}
        if counts != per_step:
            fail(f"fp32 train step {i + 1} launches "
                 f"{ {k: v for k, v in counts.items() if v} } != "
                 f"{ {k: v for k, v in per_step.items() if v} }")
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    still = [nm for nm, p in dit.named_parameters()
             if nm in blocks and torch.equal(p.detach().cpu(), blocks[nm])]
    del blocks
    state, profiled = profile_step(step, state, batch)
    step_s = statistics.median(seconds[1:] or seconds)
    busy_s = profiled["device_busy_ms"] / 1e3
    # derived, not measured: the 30-block step as this step plus 20 more
    # blocks at this step's device time a block (the embeddings, head and
    # optimizer counted in the per-block share, an upper bound)
    derived_30 = step_s + (spec.dit.num_layers - cfg.num_layers) * (
        busy_s / cfg.num_layers)
    out = {"phase": "fp32_train_main_path", "model": "t2v-1.3B",
           "blocks": f"{cfg.num_layers} of {spec.dit.num_layers}",
           "policy": "FP32_POLICY", "resolution": f"832x480x{FP32_TRAIN_FRAMES}",
           "tokens": tokens, "padded_to": pad_to, "remat_blocks": "attn",
           "params": sum(p.numel() for p in dit.parameters()),
           "init_s": init_s, "steps": n_steps, "step_seconds": seconds,
           # the first step also allocates: the median of the others
           "seconds_per_step": step_s,
           "attention_share_of_busy": (profiled["attention_kernels_ms"]
                                       / profiled["device_busy_ms"]),
           "derived_30_block_step_s": derived_30,
           "peak_memory_gb": peak, "losses": losses,
           "block_tensors_unmoved": still[:5],
           "launches": {k: v for k, v in launches.items() if v},
           "launches_per_step": {k: v for k, v in per_step.items() if v},
           "profiled_step": profiled}
    log(json.dumps(out))
    if not all(math.isfinite(x) for x in losses):
        fail("non-finite fp32 training loss")
    if still:
        fail(f"block weights that did not move: {still[:5]}")
    if peak >= 80.0:
        fail(f"fp32 fine-tune peak memory {peak:.1f} GB")
    del state, step, dit, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the Wan serving knobs: --bf16_softmax, --qk_int8, --int8, --taylorseer
# ---------------------------------------------------------------------------

H100_INT8_OPS = 1979e12    # dense tensor-core int8 (SXM data sheet)
# --taylorseer 2 over 6 steps: 5 DiT steps and one Taylor step (cut from 8
# for the time limit; at 4 or 5 steps every step is full)
KNOB_STEPS = 6
KNOB_TAYLORSEER = 2
KNOB_FORWARDS = 5
# the knob CLI run's frames: cut from 121 for the time limit (on an H100
# 80GB HBM3 at 700 W the path took 129.8 s at 121 frames, 58.7 s of it the
# 121-frame decode, which the ti2v-5B path runs again at the same shape);
# 11 latent frames, 9,680 tokens. The per-knob DiT forwards keep the full
# 121-frame shape.
KNOB_FRAMES = 41
# the knob kernels' counters and the paths whose launches the kernels line
# gives them: the all-knob CLI run, or the DiT forward with that knob alone
KNOB_OWNERS = {"flash_attention_int8_sbf16": "knobs",
               "cross_attention_bf16_sbf16": "knobs",
               "quantize_qk_int8": "knobs",
               "flash_attention_bf16_sbf16": "knob_softmax_bf16",
               "flash_attention_int8": "knob_qk_int8"}


BF16_CHAIN_WHY = (
    "the bf16 chain is discontinuous in the scores: where the kernel's mma "
    "and the plain GEMM sum a score in other orders and its bf16 rounding "
    "flips, bf16(s - ref) moves by one step (<= 0.125 for |s - ref| < 32) "
    "and that p by up to 9%, the output by up to ~0.2 max|v| when that key "
    "dominates its row; such rows are rare")


# the fp32 knob modes' own rel. L2 limits against the plain bf16 chain, from
# the readings at t2v-1.3B's shape (PERF.md s2): the int8 scores are the
# plain version's bit for bit, so under a bound only exp2's last bit and p
# v's summation order remain; fp32 scores flip a bf16(s - ref) now and then
# (one step moves its p by up to 9%); the running max rounds against other
# references than the plain version's one-shot max
F32_CHAIN_LIMITS = {"int8_bounded": 1e-5, "fp32_bounded": 5e-4,
                    "running": 5e-3}
# the least rel. L2 between a bf16-chain output and the fp32 chain's on the
# same inputs: the two chains differ by ~5e-3 (running max) to ~1.5e-2
# (bound) of the output, a kernel that ignored the knob by ~1e-6
CHAIN_APART = 1e-3


def compare_bf16_chain(name, got, want, v_max, rel_limit=1e-2, fp32_chain=None):
    """The bf16 softmax chain's kernel against its plain version
    (BF16_CHAIN_WHY): rel. L2 < rel_limit (1e-2: the running max also
    rounds p against other references, and the outputs, ~0.05 at 27k keys,
    round to the other bf16 neighbour, 2^-8 relative), at most 1e-3 of the
    outputs beyond one bf16 ulp + 1e-3, none beyond 0.2 max|v|. With
    `fp32_chain`, the fp32 chain's output of the same call: the control's
    rel. L2 against the plain bf16 chain is logged, and `got` must lie at
    least CHAIN_APART from it (the bf16 chain was computed)."""
    import torch
    err = (got.float() - want.float()).abs()
    lim = 1e-3 + 2.0 ** -7 * want.float().abs()
    outside = float((err > lim).float().mean())
    rel = rel_l2(got, want)
    max_err = float(err.max())
    ok = (bool(torch.isfinite(got).all()) and rel < rel_limit
          and outside <= 1e-3 and max_err <= 0.2 * v_max)
    out = {"check": name, "max_abs_err": max_err,
           "max_abs_ref": float(want.float().abs().max()),
           "rel_l2": rel, "outside_ulp_share": outside,
           "limits": {"rel_l2": rel_limit, "outside_ulp_share": 1e-3,
                      "max_abs_err": 0.2 * v_max},
           "why": BF16_CHAIN_WHY}
    if fp32_chain is not None:
        apart = rel_l2(got, fp32_chain)
        out.update(fp32_chain_control_rel_l2=rel_l2(fp32_chain, want),
                   apart_from_fp32_chain_rel_l2=apart,
                   apart_limit=CHAIN_APART)
        ok = ok and apart > CHAIN_APART
    out["ok"] = ok
    log(json.dumps(out))
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version")
    return max_err


def _knob_case(gen, n, grid, l):
    """q, k, v [2, l, n, 128] (qk-normed q, k; keys past the grid's tokens
    hold 50.0, a leaked one would be far off), the fused-rope tables padded
    to l, kv_len and the folded bound of the knob path's DiT."""
    import torch

    from univid_tpu_torch.kernels import flash_attention as fa
    from univid_tpu_torch.ops.rope import build_rope_3d

    b, d = 2, 128
    kv_real = grid[0] * grid[1] * grid[2]
    q = qk_normed((b, l, n, d), gen, torch.bfloat16)
    k = qk_normed((b, l, n, d), gen, torch.bfloat16)
    v = torch.randn((b, l, n, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    k[:, kv_real:] = 50.0
    v[:, kv_real:] = 50.0
    cos, sin = build_rope_3d(d, grid, device="cuda")
    tabs = fa._pad_tables(fa.build_fused_rope_tables(cos, sin, d), l, l,
                          fa.LOG2E / math.sqrt(d))
    kv_len = torch.full((b,), kv_real, dtype=torch.int32, device="cuda")
    bound = torch.tensor([1.01 * d * fa.LOG2E / math.sqrt(d)], device="cuda")
    return q, k, v, tabs, kv_len, bound, kv_real


def _sdpa_ms(q, k, v, kv_real):
    import torch.nn.functional as F
    qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
    ks, vs = ks[:, :, :kv_real], vs[:, :, :kv_real]
    return cuda_time(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, scale=1.0 / math.log2(math.e)), 3)


def check_knob_kernels(tag, n, grid, l, seed, running):
    """The knob kernels against their plain versions at one model's DiT
    shapes (n heads of d=128, batch-2 CFG, the grid's tokens padded to l,
    512 text tokens), timed with CUDA events beside their plain versions,
    bf16 SDPA and, in the same call, the knob-free kernels: softmax_bf16 on
    self-attention (bounded; with `running` the running max too) and on
    cross-attention (bounded, one-shot); the rope + int8 pre-pass (k scales
    over JAX's 2,048-key blocks); the int8 QK^T kernel bounded with kv_len,
    alone and with softmax_bf16. Returns the records of the kernels line."""
    import torch

    from univid_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, tabs, kv_len, bound, kv_real = _knob_case(gen, n, grid, l)
    b, d = 2, 128
    cq, sq, ck, sk = tabs
    bw = 2048   # jax_block_k at 28,672 and 32,768 keys
    tol = dict(atol=1e-3, rtol=2.0 ** -7,
               why="one bf16 ulp of the output plus 1e-3 for the summation "
                   "order and the approximate exp2 before p rounds to bf16")
    # the running max rounds p against a reference the plain one-shot form
    # reaches at once: a p in [0.5, 1] may take the other bf16 neighbour
    tol_run = dict(atol=1e-3 + 2.0 ** -8 * float(v[:, :kv_real].float()
                                                  .abs().max()),
                   rtol=2.0 ** -7,
                   why="one bf16 ulp of the output plus one p in [0.5, 1] "
                       "rounded to the other bf16 neighbour (2^-8 max|v|)")
    recs = {}
    flops = 4 * b * n * l * kv_real * d
    with torch.no_grad():
        qr, kr = fa.qk_norm_rope(q, k, rope_tables=tabs)
        # ---- K1: softmax_bf16 on self-attention -------------------------
        v_max = float(v[:, :kv_real].float().abs().max())
        got = fa._flash_cuda(q, k, v, kv_len, bound, tabs, softmax_bf16=True)
        want = fa.attention_plain(q, k, v, kv_len=kv_len, bound=bound,
                                  rope_tables=tabs, softmax_bf16=True)
        err = compare_bf16_chain(
            f"flash_attention_bf16_sbf16 {tag} bounded+rope+kv_len", got,
            want, v_max)
        if running:
            compare_bf16_chain(
                f"flash_attention_bf16_sbf16 {tag} running max+rope+kv_len",
                fa._flash_cuda(q, k, v, kv_len, None, tabs,
                               softmax_bf16=True),
                fa.attention_plain(q, k, v, kv_len=kv_len, rope_tables=tabs,
                                   softmax_bf16=True), v_max)
        del got, want
        ms_free = cuda_time(lambda: fa._flash_cuda(qr, kr, v, kv_len, bound,
                                                   None), 3)
        ms, old_ms = ab_time(
            lambda: fa._flash_cuda(qr, kr, v, kv_len, bound, None,
                                   softmax_bf16=True),
            lambda: fa._launch_bf16(qr, kr, v, kv_len, bound,
                                    fa._MODE_BOUNDED, softmax_bf16=True), 3)
        log_ab(f"softmax_bf16 self-attention {tag} bounded", ms, old_ms)
        plain_ms = cuda_time(lambda: fa.attention_plain(
            qr, kr, v, kv_len=kv_len, bound=bound, softmax_bf16=True), 1)
        lib_ms = _sdpa_ms(qr, kr, v, kv_real)
        bms, by = bound_ms(flops, nbytes(qr, kr, v, qr), H100_BF16_FLOPS)
        recs["flash_attention_bf16_sbf16"] = dict(
            name="flash_attention_bf16_sbf16", route="cuda",
            source="univid_tpu_torch/kernels/csrc/flash_attention_sm90.cu",
            replaces="univid_tpu/kernels/flash_attention.py:44",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=by, library_ms=lib_ms, knob_free_ms=ms_free,
            mma_sync_ms=old_ms)

        # ---- K2: the rope + int8 quantize pre-pass ----------------------
        # kernel B of csrc/qk_prepass.cu and the pair it replaced, both
        # against the plain version on the same normed q, k; timed in turns
        codes = fa.quantize_qk_int8(q, k, tabs, bw)
        plain_codes = fa.quantize_qk_int8_plain(q, k, tabs, bw)
        for impl, out in (("route", codes),
                          ("pair", fa._quantize_qk_int8_pair(q, k, tabs,
                                                             bw))):
            off = [int((g != w).sum()) for g, w in zip(out, plain_codes)]
            res = {"check": f"quantize_qk_int8 {tag} ({impl})",
                   "differing": off,
                   "why": "the same fp32 rotation, reciprocal, product and "
                          "round-half-to-even: codes and scales equal",
                   "ok": off == [0, 0, 0, 0]}
            log(json.dumps(res))
            if not res["ok"]:
                fail(f"quantize_qk_int8 ({impl}): kernel disagrees with "
                     "its plain version")
        del plain_codes, out

        ms_q, pair_ms = ab_time(
            lambda: fa.quantize_qk_int8(q, k, tabs, bw),
            lambda: fa._quantize_qk_int8_pair(q, k, tabs, bw), 5)
        log_prepass(f"quantize_qk_int8 {tag} vs pair", ms_q, pair_ms)
        plain_q = cuda_time(lambda: fa.quantize_qk_int8_plain(q, k, tabs, bw),
                            1)
        qi, sqs, ki, akq = codes
        # 2 products and a sum to rotate, |x|, the product and the round;
        # each input read once (the kernel reads k twice)
        bms, by = bound_ms(6 * (q.numel() + k.numel()),
                           nbytes(q, k, cq, sq, ck, sk, *codes),
                           H100_FP32_FLOPS)
        common = dict(route="cuda", max_abs_err=0.0, plain_ms=plain_q,
                      bound_ms=bms, bound_by=by, library_ms=None,
                      replaces="univid_tpu/kernels/flash_attention.py:44")
        src = "univid_tpu_torch/kernels/csrc/qk_prepass.cu"
        recs["quantize_qk_int8"] = dict(
            common, name="quantize_qk_int8", source=src, ms=ms_q,
            pair_ms=pair_ms)
        recs["quantize_qk_int8_pair"] = dict(
            common, name="quantize_qk_int8_pair", ms=pair_ms,
            source="univid_tpu_torch/kernels/csrc/flash_attention_int8.cu")

        # ---- K3 (+ K1): int8 QK^T attention -----------------------------
        # the route's sm90 kernel (flash_attention_int8_sm90.cu) and the
        # mma.sync kernel it replaced, both against the plain version, then
        # timed in turns (old, new, new, old) beside the plain version, bf16
        # SDPA and the knob-free sm90 kernel. QK^T at the int8 rate, p v at
        # the bf16 rate
        t_ops = (flops / 2 / H100_INT8_OPS + flops / 2 / H100_BF16_FLOPS) \
            * 1e3
        t_bytes = nbytes(qi, ki, sqs, akq, v, v) / H100_BYTES * 1e3
        bms, by = ((t_ops, "operations") if t_ops >= t_bytes
                   else (t_bytes, "bytes"))
        for sbf, name in ((False, "flash_attention_int8"),
                          (True, "flash_attention_int8_sbf16")):
            kw = dict(kv_len=kv_len, score_bound=bound, softmax_bf16=sbf,
                      block_k=bw)
            want = fa.attention_int8_plain(*codes, v, kv_len=kv_len,
                                           bound=bound, softmax_bf16=sbf,
                                           block_k=bw)
            errs = {}
            for impl, run in (("sm90", fa.flash_attention_int8),
                              ("mma_sync", fa._launch_int8_mma_sync)):
                got = run(*codes, v, **kw)
                check = f"{name} {tag} bounded+kv_len ({impl})"
                errs[impl] = (compare_bf16_chain(check, got, want, v_max)
                              if sbf else compare(check, got, want, **tol))
            del got, want
            if running:
                kr_ = dict(kv_len=kv_len, softmax_bf16=sbf, block_k=bw)
                got = fa.flash_attention_int8(*codes, v, **kr_)
                want = fa.attention_int8_plain(*codes, v, kv_len=kv_len,
                                               softmax_bf16=sbf, block_k=bw)
                check = f"{name} {tag} running max+kv_len (sm90)"
                if sbf:
                    compare_bf16_chain(check, got, want, v_max)
                else:
                    compare(check, got, want, **tol_run)
                del got, want
            # a batch row with kv_len = 0: no tile loaded, exact zeros
            got = fa.flash_attention_int8(
                *codes, v, kv_len=torch.tensor([0, kv_real], dtype=torch.int32,
                                               device="cuda"),
                score_bound=bound, softmax_bf16=sbf, block_k=bw)
            zero = bool((got[0] == 0).all())
            log(json.dumps({"check": f"{name} {tag} kv_len = 0 row",
                            "exactly_zero": zero, "ok": zero}))
            if not zero:
                fail(f"{name}: a kv_len = 0 row is not exactly 0")
            del got
            ms, old_ms = ab_time(lambda: fa.flash_attention_int8(*codes, v,
                                                                 **kw),
                                 lambda: fa._launch_int8_mma_sync(*codes, v,
                                                                  **kw), 3)
            plain_ms = cuda_time(lambda: fa.attention_int8_plain(
                *codes, v, kv_len=kv_len, bound=bound, softmax_bf16=sbf,
                block_k=bw), 1)
            log(json.dumps({"int8_sm90_vs_mma_sync": f"{name} {tag}",
                            "sm90_ms": ms, "mma_sync_ms": old_ms,
                            "speedup": old_ms / ms, "knob_free_sm90_ms": ms_free,
                            "sdpa_ms": lib_ms, "bound_ms": bms}))
            common = dict(route="cuda",
                          replaces="univid_tpu/kernels/flash_attention.py:44",
                          plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                          library_ms=lib_ms, knob_free_ms=ms_free)
            recs[name] = dict(
                common, name=name, max_abs_err=errs["sm90"], ms=ms,
                source="univid_tpu_torch/kernels/csrc/"
                       "flash_attention_int8_sm90.cu", mma_sync_ms=old_ms)
            recs[f"{name}_mma_sync"] = dict(
                common, name=f"{name}_mma_sync",
                max_abs_err=errs["mma_sync"], ms=old_ms,
                source="univid_tpu_torch/kernels/csrc/flash_attention_int8.cu")
        del q, k, v, qr, kr, codes, qi, ki

        # ---- K1 on cross-attention: 512 text keys -----------------------
        lk = 512
        sc = torch.tensor(fa.LOG2E / math.sqrt(d), dtype=torch.bfloat16,
                          device="cuda")
        q = qk_normed((b, l, n, d), gen, torch.bfloat16) * sc
        k = qk_normed((b, lk, n, d), gen, torch.bfloat16)
        v = torch.randn((b, lk, n, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        v_max = float(v.float().abs().max())
        got = fa.cross_attention_padded(q, k, v, score_bound=bound,
                                        softmax_bf16=True)
        err = compare_bf16_chain(
            f"cross_attention_bf16_sbf16 {tag} bounded", got,
            fa.attention_plain(q, k, v, bound=bound, softmax_bf16=True),
            v_max)
        kvl = torch.tensor([lk, 100], dtype=torch.int32, device="cuda")
        km, vm = k.clone(), v.clone()
        km[1, 100:] = 50.0
        vm[1, 100:] = 50.0
        compare_bf16_chain(
            f"cross_attention_bf16_sbf16 {tag} one-shot max+kv_len",
            fa.cross_attention_padded(q, km, vm, kv_len=kvl,
                                      softmax_bf16=True),
            fa.attention_plain(q, km, vm, kv_len=kvl, softmax_bf16=True),
            v_max)
        del km, vm
        ms_free = cuda_time(lambda: fa.cross_attention_padded(
            q, k, v, score_bound=bound), 5)
        ms, old_ms = ab_time(
            lambda: fa.cross_attention_padded(q, k, v, score_bound=bound,
                                              softmax_bf16=True),
            lambda: fa._launch_bf16(q, k, v, None, bound, fa._MODE_BOUNDED,
                                    softmax_bf16=True), 5)
        log_ab(f"softmax_bf16 cross-attention {tag} bounded", ms, old_ms)
        plain_ms = cuda_time(lambda: fa.attention_plain(
            q, k, v, bound=bound, softmax_bf16=True), 1)
        lib_ms = _sdpa_ms(q, k, v, lk)
        bms, by = bound_ms(4 * b * n * l * lk * d, nbytes(q, k, v, got),
                           H100_BF16_FLOPS)
        recs["cross_attention_bf16_sbf16"] = dict(
            name="cross_attention_bf16_sbf16", route="cuda",
            source="univid_tpu_torch/kernels/csrc/flash_attention_sm90.cu",
            replaces="univid_tpu/kernels/flash_attention.py:355",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=by, library_ms=lib_ms, knob_free_ms=ms_free,
            mma_sync_ms=old_ms)
        del q, k, v, got
    torch.cuda.empty_cache()
    return recs


def _knob_dit_cfg():
    from univid_tpu_torch.core.config import WanDiTConfig
    return WanDiTConfig(model_type="t2v", in_dim=16, out_dim=16, dim=256,
                        ffn_dim=512, freq_dim=32, text_dim=64, num_heads=2,
                        num_layers=2, text_len=32)


KNOB_CASES = {"softmax_bf16": dict(softmax_bf16=True),
              "qk_int8": dict(qk_int8=True),
              "int8": dict(int8=True),
              "all_four": dict(softmax_bf16=True, qk_int8=True, int8=True,
                               taylorseer=2)}


def _knob_launches(knobs, forwards, blocks):
    """The kernels' launches of `forwards` DiT calls of `blocks` blocks with
    `knobs` (a self- and a cross-attention a block and call)."""
    from univid_tpu_torch.kernels import flash_attention as fa
    n = forwards * blocks
    sbf, qk8 = knobs.get("softmax_bf16"), knobs.get("qk_int8")
    out = dict.fromkeys(fa.LAUNCHES, 0)
    if qk8:   # kernel A norms q and k, kernel B rotates and quantizes
        out["flash_attention_int8_sbf16" if sbf else
            "flash_attention_int8"] = n
        out["quantize_qk_int8"] = 2 * n     # kernel B's two launches
        out["qk_norm_bf16"] = 2 * n        # self and cross
    else:
        out["flash_attention_bf16_sbf16" if sbf else
            "flash_attention_bf16"] = n
        out["qk_norm_rope_bf16"] = n
        out["qk_norm_bf16"] = n            # cross
    out["cross_attention_bf16_sbf16" if sbf else "cross_attention_bf16"] = n
    out["w8a8_linear"] = 10 * n if knobs.get("int8") else 0
    return out


def _all_counts():
    from univid_tpu_torch.core import quant
    return dict(launch_counts(), **quant.W8A8_LAUNCHES)


def _reset_counts():
    from univid_tpu_torch.core import quant
    from univid_tpu_torch.kernels import flash_attention as fa
    fa.reset_launches()
    quant.W8A8_LAUNCHES["w8a8_linear"] = 0


# knob_parity's latent rel. L2 limits at FP32_POLICY, each from its case's
# reading and control (PERF.md s2): without W8A8 only the summation orders
# of the fp32 GEMMs and the rare bf16-chain score flips or int8 code flips
# they cause remain (readings 3.0e-6 and 1.6e-5; the controls, the knobs
# off, 1.4e-4 and 4.4e-4); W8A8 codes flip where cuBLAS and the CPU round a
# GEMM differently (2.6e-3 and 5.4e-3)
F32_PARITY_LIMITS = {"softmax_bf16": 3e-5, "qk_int8": 1e-4, "int8": 1e-2,
                     "all_four": 2e-2}


def knob_parity():
    """Each knob alone and all four on the card (kernels) against the CPU
    (plain versions), same weights and noise, the denoise loop of a 2-layer
    d=128 DiT (dim 256), 256 tokens padded to 320 (kv_len), 4 UniPC steps
    (all four: TaylorSeer 2 over 6 steps, 5 DiT calls); --int8 quantizes
    the DiT as the CLI does. Each case twice: the bf16 policy with the
    bound (limit 3e-2 + 3x the card's own change under a one-bf16-step move
    of the noise), and FP32_POLICY (an fp32 DiT, no bound: the fp32 knob
    modes' running max and, at the 320 self- and 32 cross-attention keys,
    the bf16 chain's one-shot max; each case's own limit,
    F32_PARITY_LIMITS). At FP32_POLICY the card also runs the case with
    softmax_bf16 and qk_int8 off, the control: its rel. L2 against the CPU
    is what a kernel that ignored those knobs would read, and where they
    are the case's only knobs it must exceed 3x the limit. Latent rel. L2
    and the card's launches of each kernel. Returns the fp32 cases'
    launches on the card, summed."""
    import copy

    import numpy as np
    import torch

    from univid_tpu_torch.core.config import WAN_CONFIGS, WanModelSpec
    from univid_tpu_torch.core.dtypes import DEFAULT_POLICY, FP32_POLICY
    from univid_tpu_torch.core.quant import quantize_dit_w8a8
    from univid_tpu_torch.models.wan.dit import WanDiT
    from univid_tpu_torch.pipelines.ti2v import WanTI2VPipeline
    import dataclasses

    base = WAN_CONFIGS["t2v-1.3B"]
    cfg = _knob_dit_cfg()
    spec = WanModelSpec(name="smoke-d128", dit=cfg, vae=base.vae,
                        generation=base.generation)
    gen = torch.Generator().manual_seed(0)
    dit = WanDiT(cfg, dtype=torch.bfloat16, device="cpu", gen=gen)
    with torch.no_grad():
        dit.head.head.w.normal_(0.0, 0.05, generator=gen)
        for blk in dit.blocks:
            for a in (blk.self_attn, blk.cross_attn):
                a.norm_q.uniform_(0.5, 1.5, generator=gen)
                a.norm_k.uniform_(0.5, 1.5, generator=gen)
    dit32 = copy.deepcopy(dit).float()
    rng = np.random.default_rng(1)
    grid, seq_len = (4, 16, 16), 320
    noise = torch.as_tensor(rng.standard_normal((1, *grid, 16)),
                            dtype=torch.float32)
    ctx = torch.as_tensor(rng.standard_normal((1, 32, 64)) * 0.5,
                          dtype=torch.float32)
    nctx = torch.as_tensor(rng.standard_normal((1, 32, 64)) * 0.5,
                           dtype=torch.float32)
    fp32_launches = {}
    for case, knobs in KNOB_CASES.items():
        for pol_name in ("bf16", "fp32"):
            ts = knobs.get("taylorseer", 0)
            steps = 6 if ts else 4
            fp32 = pol_name == "fp32"
            policy = dataclasses.replace(
                FP32_POLICY if fp32 else DEFAULT_POLICY,
                bounded_softmax=not fp32,
                softmax_bf16=knobs.get("softmax_bf16", False),
                qk_int8=knobs.get("qk_int8", False))
            model = dit32 if fp32 else dit

            def run(device, x0=noise, policy=policy):
                d = copy.deepcopy(model).to(device)
                if knobs.get("int8"):
                    quantize_dit_w8a8(d)
                pipe = WanTI2VPipeline(spec, d, None, policy=policy)
                fn = pipe.denoise_fn(grid, seq_len, steps, 5.0, 5.0, "unipc",
                                     None, taylorseer_threshold=ts)
                return fn(d, x0.to(device), ctx.to(device), nctx.to(device),
                          torch.zeros_like(noise).to(device)).float().cpu()

            def rel(a, b):
                return float((a - b).norm() / b.norm())

            _reset_counts()
            x_gpu = run("cuda")
            used = _all_counts()
            x_cpu = run("cpu")
            # the card's own sensitivity: the noise moved by ~one bf16 step
            x_moved = run("cuda", noise * (1 + 2.0 ** -9 * torch.randn(
                noise.shape, generator=torch.Generator().manual_seed(2))))
            forwards = 5 if ts else steps
            if fp32:
                want = _f32_knob_launches(knobs, forwards, cfg.num_layers,
                                          bounded=False, lk_self=seq_len,
                                          int8=knobs.get("int8", False))
            else:
                want = _knob_launches(knobs, forwards, cfg.num_layers)
            got = {k: used[k] for k in want}
            err, sens = rel(x_gpu, x_cpu), rel(x_moved, x_gpu)
            control = None
            if fp32:
                limit = F32_PARITY_LIMITS[case]
                why = ("fp32 compute policy, over 2 blocks x "
                       f"{steps} steps: summation orders of the fp32 GEMMs "
                       "and the rare score or code flips they cause"
                       + ("; W8A8 codes flip where cuBLAS and the CPU "
                          "round a GEMM differently" if knobs.get("int8")
                          else ""))
                if policy.softmax_bf16 or policy.qk_int8:
                    control = rel(run("cuda", policy=dataclasses.replace(
                        policy, softmax_bf16=False, qk_int8=False)), x_cpu)
            else:
                limit = 3e-2 + 3 * sens
                why = ("bf16 compute policy: cuBLAS and the CPU round each "
                       f"GEMM at other points, over 2 blocks x {steps} "
                       "steps; W8A8 codes and bf16 scores flip where those "
                       "roundings differ, so 3x the card's own change "
                       "under a one-bf16-step move of the noise")
            out = {"check": f"knob_parity {case} ({pol_name} policy)",
                   "latent_rel_l2": err, "sensitivity_rel_l2": sens,
                   "limit": limit, "control_rel_l2": control, "why": why,
                   "launches": {k: v for k, v in got.items() if v},
                   "expected_launches": {k: v for k, v in want.items() if v},
                   "finite": bool(torch.isfinite(x_gpu).all())}
            # the control must show the attention knobs where they are the
            # case's only knobs
            shows = (control is None or knobs.get("int8")
                     or control > 3 * limit)
            out["ok"] = (out["finite"] and err < limit and got == want
                         and bool(shows))
            log(json.dumps(out))
            if not out["ok"]:
                fail(f"knob parity {case} ({pol_name}): the card disagrees "
                     "with the CPU")
            if fp32:
                for k, v in used.items():
                    fp32_launches[k] = fp32_launches.get(k, 0) + v
    return fp32_launches


def _knob_forward_times(spec, forwards):
    """The ti2v-5B DiT forward at the CLI's 1280x704x121 shape (batch-2
    CFG, 27,280 tokens padded to 28,672, a [2, 512, 4096] context), random
    bf16 weights from a seed, with each knob alone and all four, `forwards`
    timed calls each after the launch counts of one call are checked.
    Returns ({knob: [seconds]}, {knob: launches of one call})."""
    import dataclasses
    import gc

    import torch

    from univid_tpu_torch.core.dtypes import DEFAULT_POLICY
    from univid_tpu_torch.core.quant import quantize_dit_w8a8
    from univid_tpu_torch.models.wan.dit import WanDiT, wan_dit_forward
    from univid_tpu_torch.ops.rope import build_rope_3d

    cfg = spec.dit
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    dit = WanDiT(cfg, dtype=torch.bfloat16, device=dev, gen=gen)
    x = torch.randn((1, 31, 44, 80, cfg.in_dim), generator=gen, device=dev)
    x = x.expand(2, *x.shape[1:])
    ctx = torch.randn((2, cfg.text_len, cfg.text_dim), generator=gen,
                      device=dev) * 0.5
    t = torch.full((2,), 900.0, device=dev)
    grid = (31, 22, 40)
    cos, sin = build_rope_3d(cfg.head_dim, grid, device=dev)
    times, launches = {}, {}
    order = ("baseline", "softmax_bf16", "qk_int8", "int8", "all_four")
    for knob in order:
        kn = dict(KNOB_CASES.get(knob, {}))
        kn.pop("taylorseer", None)
        if knob == "int8":
            quantize_dit_w8a8(dit)   # in place; all_four runs on it too
        policy = dataclasses.replace(
            DEFAULT_POLICY, bounded_softmax=True,
            softmax_bf16=kn.get("softmax_bf16", False),
            qk_int8=kn.get("qk_int8", False))

        def fwd():
            with torch.no_grad():
                return wan_dit_forward(dit, x, t, ctx, cos, sin,
                                       seq_pad_to=28672, policy=policy,
                                       fused_rope=True)

        _reset_counts()
        out = fwd()
        torch.cuda.synchronize()
        got = _all_counts()
        want = _knob_launches(kn, 1, cfg.num_layers)
        launches[knob] = {k: got[k] for k in want}
        if launches[knob] != want or not bool(torch.isfinite(out).all()):
            fail(f"ti2v-5B DiT forward with {knob}: launches "
                 f"{launches[knob]} != {want} or a non-finite output")
        # cross-attention, and self-attention unless int8 QK^T takes it
        check_impl(f"ti2v-5B DiT forward with {knob}",
                   cfg.num_layers * (1 + (not kn.get("qk_int8"))))
        del out
        times[knob] = []
        for _ in range(forwards):
            t0 = time.perf_counter()
            fwd()
            torch.cuda.synchronize()
            times[knob].append(time.perf_counter() - t0)
        if knob == "baseline":
            # where a bare DiT call's time goes: its 30 self- and 30
            # cross-attention calls, the 60 q / k pre-passes (kernel A:
            # 30 norm + rope, 30 norm only), the GEMMs, the rest
            _, prof = profile_call(fwd, families={
                "qk_prepass_ms": ("qk_norm_rope",),
                "attention_ms": ("flash_fwd_sm90",)})
            log(json.dumps({"profile": "ti2v-5B DiT forward, bare",
                            **prof}))
        if knob == "qk_int8":
            # with int8 QK^T: its 30 int8 attention calls, their 30 int8
            # pre-passes (kernel B, two launches each), the 60 norm-only
            # pre-passes (kernel A), the 30 cross-attention calls, the
            # GEMMs, the rest
            _, prof = profile_call(fwd, families={
                "int8_attention_ms": ("flash_fwd_int8_sm90",),
                "int8_prepass_ms": ("quant_qk_",),
                "qk_prepass_ms": ("qk_norm_rope",),
                "cross_attention_ms": ("flash_fwd_sm90",)})
            log(json.dumps({"profile": "ti2v-5B DiT forward, qk_int8 alone",
                            **prof}))
    del dit
    gc.collect()
    torch.cuda.empty_cache()
    return times, launches


def knob_main_path(output_dir):
    """The knob path: ti2v-5B with BAGEL fusion (the CLI default) at
    1280x704xKNOB_FRAMES (41; the full request is 121), full depth and
    width, random weights from a seed,
    --mode t2v --bf16_softmax --qk_int8 --int8 --taylorseer 2, 6 steps,
    through the port's CLI. Checks the mp4, the fusion context, and the
    launches: per DiT call 30 int8 + bf16-softmax self-attention, 30
    bf16-softmax cross-attention, 60 norm-only and 30 int8 pre-passes,
    300 W8A8 GEMMs, 5 DiT calls (1 Taylor step skips it), no knob-free
    attention; (KNOB_FRAMES - 1) / 4 + 1 d=1024 VAE
    attention calls. Prints seconds per DiT step and per Taylor step, for
    the video, peak memory; then times the ti2v-5B DiT forward with each
    knob alone and all four, one forward each. Returns {path: launches}."""
    import gc
    import os

    import torch

    from univid_tpu_torch.cli import inference
    from univid_tpu_torch.core.config import WAN_CONFIGS
    from univid_tpu_torch.data.video_io import read_video_frames
    from univid_tpu_torch.kernels import flash_attention as fa

    gc.collect()
    torch.cuda.empty_cache()
    os.makedirs(output_dir, exist_ok=True)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    meta = inference.main([
        "--model", "ti2v-5B", "--mode", "t2v", "--mock_weights",
        "--video_size", "1280x704", "--video_length", str(KNOB_FRAMES),
        "--steps", str(KNOB_STEPS), "--seed", "0", "--output_dir",
        output_dir, "--bf16_softmax", "--qk_int8", "--int8",
        "--taylorseer", str(KNOB_TAYLORSEER)])[0]
    wall = time.perf_counter() - t0
    launches = _all_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    f32_by_d = dict(fa.F32_LAUNCHES_BY_D)
    n_dec = (KNOB_FRAMES - 1) // 4 + 1
    knobs = dict(softmax_bf16=True, qk_int8=True, int8=True)
    expected = dict(_knob_launches(knobs, KNOB_FORWARDS, 30),
                    flash_attention_f32=n_dec)
    expected = dict(dict.fromkeys(launches, 0), **expected)
    phases = meta["phase_times_s"]
    frames = read_video_frames(meta["video_path"])
    log(json.dumps({
        "phase": "knob_main_path", "model": "ti2v-5B", "mode": "t2v",
        "resolution": f"1280x704x{KNOB_FRAMES}", "steps": KNOB_STEPS,
        "knobs": meta["knobs"], "seconds": wall,
        "generation_time_s": meta["generation_time_s"],
        "phase_times_s": phases,
        "dit_step_s": phases.get("dit_step", 0.0) / KNOB_FORWARDS,
        "taylor_step_s": phases.get("taylor_step", 0.0)
        / (KNOB_STEPS - KNOB_FORWARDS),
        "peak_memory_gb": peak, "launches": launches,
        "expected_launches": expected, "f32_launches_by_d": f32_by_d,
        "frames": len(frames), "context_path": meta["context_path"]}))
    if launches != expected or f32_by_d != {384: 0, 640: 0, 1024: n_dec}:
        fail(f"knob path launch counts {launches} != {expected}")
    # the bf16-softmax cross-attention (self-attention takes int8 QK^T)
    check_impl("knob path", KNOB_FORWARDS * 30)
    if len(frames) != KNOB_FRAMES or frames[0].shape != (704, 1280, 3) \
            or meta["context_path"] != "bagel_fusion":
        fail(f"the knob path's mp4 is not {KNOB_FRAMES} frames of 704x1280 "
             "from the BAGEL fusion context")
    if peak >= 80.0:
        fail(f"knob path peak memory {peak:.1f} GB")
    del meta
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    times, per_call = _knob_forward_times(WAN_CONFIGS["ti2v-5B"], 1)
    log(json.dumps({"phase": "knob_dit_forward_times", "model": "ti2v-5B",
                    "shape": "[2, 31, 44, 80, 48] latents, 28,672 tokens",
                    "seconds": times, "launches_per_call": per_call,
                    "peak_memory_gb":
                        torch.cuda.max_memory_allocated() / 1e9}))
    by_path = {"knobs": launches}
    for knob in ("softmax_bf16", "qk_int8"):
        by_path[f"knob_{knob}"] = dict(dict.fromkeys(launches, 0),
                                       **per_call[knob])
    return by_path


# ---------------------------------------------------------------------------
# the serving knobs on fp32 inputs (the fp32 Wan DiT's softmax_bf16 and
# qk_int8: the knob modes of flash_attention_f32_sm90.cu, kernel B's fp32
# mode)
# ---------------------------------------------------------------------------

F32_KNOB_BLOCKS = 10   # of t2v-1.3B's 30: the time limit (full width)
F32_KNOB_STEPS = 2     # UniPC steps a case, batch-2 CFG, no decode
F32_KNOB_CASES = {"softmax_bf16": dict(softmax_bf16=True),
                  "qk_int8": dict(qk_int8=True),
                  "both": dict(softmax_bf16=True, qk_int8=True)}
# the fp32 knob kernels' counters and the runs whose launches the kernels
# line gives them: the t2v-1.3B pipeline case of that knob (bounded), the
# one-shot cross mode the fp32 cases of knob_parity (FP32_POLICY: no bound)
F32_KNOB_OWNERS = {
    "flash_attention_f32_sm90_sbf16": "fp32_knob_softmax_bf16",
    "flash_attention_f32_sm90_int8": "fp32_knob_qk_int8",
    "quantize_qk_int8_f32": "fp32_knob_qk_int8",
    "flash_attention_f32_sm90_int8_sbf16": "fp32_knob_both",
    "flash_attention_f32_sm90_sbf16_oneshot": "fp32_knob_parity"}
F32_KNOB_WHY = ("fp32 accuracy on both sides: the int8 scores are the plain "
                "version's bit for bit, p v on v's three bf16 parts (~2^-24 "
                "a product); summation order and the approximate exp2 "
                "(2^-22 relative)")


def _f32_knob_launches(knobs, forwards, blocks, bounded=True, lk_self=32768,
                       int8=False):
    """The fp32 DiT's launches of `forwards` calls of `blocks` blocks with
    `knobs` (softmax_bf16, qk_int8; `int8`: W8A8): a self-attention with
    fused rope (kv_len) and a cross-attention a block and call. Without a
    bound the bf16 chain takes the one-shot max at <= 512 keys."""
    from univid_tpu_torch.kernels import flash_attention as fa
    n = forwards * blocks
    sbf, qk8 = knobs.get("softmax_bf16"), knobs.get("qk_int8")
    out = dict.fromkeys(fa.LAUNCHES, 0)
    sbf_self = "flash_attention_f32_sm90_sbf16" + (
        "_oneshot" if not bounded and lk_self <= fa.CROSS_MAX_LK else "")
    sbf_cross = "flash_attention_f32_sm90_sbf16" + ("" if bounded
                                                    else "_oneshot")
    if qk8:   # kernel B rotates and quantizes; v alone is split
        out["flash_attention_f32_sm90_int8" + ("_sbf16" if sbf else "")] = n
        out["quantize_qk_int8_f32"] = 2 * n
        out["split_bf16x3"] += n
    else:
        out[sbf_self if sbf else "flash_attention_f32_sm90"] += n
        out["rope_rotate_f32"] = 2 * n
        out["split_bf16x3"] += 3 * n
    out[sbf_cross if sbf else "flash_attention_f32_sm90"] += n
    out["split_bf16x3"] += 3 * n
    out["w8a8_linear"] = 10 * n if int8 else 0
    return out


def check_f32_knob_kernels():
    """The fp32 knob modes against their plain versions at t2v-1.3B's
    serving shape [2, 32768, 12, 128] (batch-2 CFG; 32,760 tokens, keys past
    them 50.0; fused rope, qk-normed rows): softmax_bf16 bounded and running
    (flash_attention_f32_sm90.cu's SBF16 modes); the fp32 int8 pre-pass
    (kernel B, codes and scales equal; k scales over JAX's 2,048-key
    blocks); int8 QK^T with the fp32 chain and with softmax_bf16, bounded
    and running, a kv_len = 0 row exactly 0; the cross call [2, 32768, 12,
    128] over 512 keys with softmax_bf16, one-shot (kv_len [512, 100]) and
    bounded; both knobs at the Ulysses shard [2, 32768, 6, 128]. Each timed
    with CUDA events, kernel alone and whole call, beside its plain
    version, the knob-free fp32 kernel and fp32 SDPA of the knob-free
    function. Returns the records of the kernels line (self shape; the
    cross and shard shapes on their own lines)."""
    import torch
    import torch.nn.functional as F

    from univid_tpu_torch.kernels import flash_attention as fa
    from univid_tpu_torch.ops.rope import build_rope_3d

    gen = torch.Generator(device="cuda").manual_seed(27)
    b, l, n, d = 2, 32768, 12, 128
    grid = (21, 30, 52)
    kv_real = grid[0] * grid[1] * grid[2]
    bw = 2048   # jax_block_k(32768)
    rep = "univid_tpu/kernels/flash_attention.py:"

    def case(heads):
        q = qk_normed((b, l, heads, d), gen, torch.float32)
        k = qk_normed((b, l, heads, d), gen, torch.float32)
        v = torch.randn((b, l, heads, d), generator=gen, device="cuda")
        k[:, kv_real:] = 50.0
        v[:, kv_real:] = 50.0
        return q, k, v

    cos, sin = build_rope_3d(d, grid, device="cuda")
    tabs = fa._pad_tables(fa.build_fused_rope_tables(cos, sin, d), l, l,
                          fa.LOG2E / math.sqrt(d))
    cq, sq_t, ck, sk_t = tabs
    kv_len = torch.full((b,), kv_real, dtype=torch.int32, device="cuda")
    bound = torch.tensor([1.01 * d * fa.LOG2E / math.sqrt(d)], device="cuda")
    recs = {}
    q, k, v = case(n)
    v_max = float(v[:, :kv_real].abs().max())
    prod = 2.0 * b * n * l * kv_real * d   # one product over the live keys
    io = nbytes(q, k, v, q)                # fp32 q, k, v read, o written
    with torch.no_grad():
        qr, kr = fa._rope_f32(q, cq, sq_t), fa._rope_f32(k, ck, sk_t)
        parts = [fa.split_bf16x3(x) for x in (qr, kr, v)]
        # the knob-free fp32 kernel in the same call, and fp32 SDPA of the
        # knob-free function over the live keys
        free_ms = cuda_time(lambda: fa._fwd_f32_sm90_parts(
            *parts, kv_len, bound, False), 2)
        qg, kg, vg = (x.transpose(1, 2)[:, :, :m] for x, m in
                      ((qr, l), (kr, kv_real), (v, kv_real)))
        sdpa_ms = cuda_time(lambda: F.scaled_dot_product_attention(
            qg, kg, vg, scale=1.0 / fa.LOG2E), 2)
        del qg, kg, vg

        # ---- softmax_bf16: bounded and running, fused rope, kv_len -------
        errs = []
        for tag, bd, lim in (("bounded", bound, "fp32_bounded"),
                             ("running max", None, "running")):
            got = fa._flash_cuda(q, k, v, kv_len, bd, tabs, softmax_bf16=True)
            want = fa.attention_plain(q, k, v, kv_len=kv_len, bound=bd,
                                      rope_tables=tabs, softmax_bf16=True)
            chain32, _ = fa._fwd_f32_sm90_parts(*parts, kv_len, bd, False)
            errs.append(compare_bf16_chain(
                f"flash_attention_f32_sm90_sbf16 t2v-1.3B {tag}+rope+kv_len",
                got, want, v_max, F32_CHAIN_LIMITS[lim], chain32))
            del got, want, chain32
        ms = cuda_time(lambda: fa._fwd_f32_sm90_parts(
            *parts, kv_len, bound, False, softmax_bf16=True), 3)
        run_ms = cuda_time(lambda: fa._fwd_f32_sm90_parts(
            *parts, kv_len, None, False, softmax_bf16=True), 2)
        call_ms = cuda_time(lambda: fa._flash_cuda(
            q, k, v, kv_len, bound, tabs, softmax_bf16=True), 2)
        plain_ms = cuda_time(lambda: fa.attention_plain(
            qr, kr, v, kv_len=kv_len, bound=bound, softmax_bf16=True), 1,
            warmup=0)
        bms, by = bound_ms(9 * prod, io, H100_BF16_FLOPS)
        recs["flash_attention_f32_sm90_sbf16"] = dict(
            name="flash_attention_f32_sm90_sbf16", route="cuda",
            source=F32_SM90_SRC, replaces=rep + "44 (softmax_bf16 :259-265)",
            max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=by, library_ms=sdpa_ms, running_ms=run_ms,
            call_ms=call_ms, knob_free_ms=free_ms)

        # ---- the fp32 int8 pre-pass: codes and scales equal ---------------
        codes = fa.quantize_qk_int8(q, k, tabs, bw)
        plain_codes = fa.quantize_qk_int8_plain(q, k, tabs, bw)
        off = [int((g != w).sum()) for g, w in zip(codes, plain_codes)]
        res = {"check": "quantize_qk_int8_f32 t2v-1.3B (rope, blocks of "
                        f"{bw} keys)", "differing": off,
               "why": "the same fp32 rotation, reciprocal, product and "
                      "round-half-to-even: codes and scales equal",
               "ok": off == [0, 0, 0, 0]}
        log(json.dumps(res))
        if not res["ok"]:
            fail("quantize_qk_int8_f32: kernel disagrees with its plain "
                 "version")
        del plain_codes
        q_ms = cuda_time(lambda: fa.quantize_qk_int8(q, k, tabs, bw), 5)
        q_plain = cuda_time(lambda: fa.quantize_qk_int8_plain(q, k, tabs,
                                                              bw), 1)
        # 2 products and a sum to rotate, |x|, the product and the round
        bms, by = bound_ms(6 * (q.numel() + k.numel()),
                           nbytes(q, k, *tabs, *codes), H100_FP32_FLOPS)
        recs["quantize_qk_int8_f32"] = dict(
            name="quantize_qk_int8_f32", route="cuda",
            source="univid_tpu_torch/kernels/csrc/qk_prepass.cu",
            replaces=rep + "44 (qk_int8 prologue :137-156, :213-226)",
            max_abs_err=0.0, ms=q_ms, plain_ms=q_plain, bound_ms=bms,
            bound_by=by, library_ms=None)

        # ---- int8 QK^T, the fp32 chain and softmax_bf16 -------------------
        vp = parts[2]
        for sbf, name in ((False, "flash_attention_f32_sm90_int8"),
                          (True, "flash_attention_f32_sm90_int8_sbf16")):
            errs = []
            for tag, bd in (("bounded", bound), ("running max", None)):
                got = fa.flash_attention_int8(*codes, v, kv_len=kv_len,
                                              score_bound=bd,
                                              softmax_bf16=sbf, block_k=bw)
                want = fa.attention_int8_plain(*codes, v, kv_len=kv_len,
                                               bound=bd, softmax_bf16=sbf,
                                               block_k=bw)
                check = f"{name} t2v-1.3B {tag}+kv_len"
                if sbf:
                    chain32 = fa.flash_attention_int8(
                        *codes, v, kv_len=kv_len, score_bound=bd,
                        block_k=bw)
                    errs.append(compare_bf16_chain(
                        check, got, want, v_max, F32_CHAIN_LIMITS[
                            "int8_bounded" if bd is not None else "running"],
                        chain32))
                    del chain32
                else:
                    errs.append(compare(check, got, want, atol=1e-5,
                                        rtol=1e-4, why=F32_KNOB_WHY))
                del got, want
            got = fa.flash_attention_int8(
                *codes, v, kv_len=torch.tensor([0, kv_real], dtype=torch.int32,
                                               device="cuda"),
                score_bound=bound, softmax_bf16=sbf, block_k=bw)
            zero = bool((got[0] == 0).all())
            log(json.dumps({"check": f"{name} t2v-1.3B kv_len = 0 row",
                            "exactly_zero": zero, "ok": zero}))
            if not zero:
                fail(f"{name}: a kv_len = 0 row is not exactly 0")
            del got
            ms = cuda_time(lambda: fa._f32_int8_parts(
                *codes, vp, kv_len, bound, sbf, bw), 3)
            run_ms = cuda_time(lambda: fa._f32_int8_parts(
                *codes, vp, kv_len, None, sbf, bw), 2)
            call_ms = cuda_time(lambda: fa.flash_attention_padded(
                q, k, v, kv_len=kv_len, rope_tables=tabs, score_bound=bound,
                softmax_bf16=sbf, qk_int8=True, block_k=bw,
                softmax_scale=1.0 / math.sqrt(d)), 2)
            plain_ms = cuda_time(lambda: fa.attention_int8_plain(
                *codes, v, kv_len=kv_len, bound=bound, softmax_bf16=sbf,
                block_k=bw), 1, warmup=0)
            # QK^T at the int8 rate; p v: 6 (fp32 chain) or 3 bf16 products
            t_ops = (prod / H100_INT8_OPS + (3 if sbf else 6) * prod
                     / H100_BF16_FLOPS) * 1e3
            t_bytes = nbytes(*codes, v, q) / H100_BYTES * 1e3
            bms, by = ((t_ops, "operations") if t_ops >= t_bytes
                       else (t_bytes, "bytes"))
            recs[name] = dict(
                name=name, route="cuda", source=F32_SM90_SRC,
                replaces=rep + "44 (qk_int8 :104-105, :213-233"
                + (", softmax_bf16 :259-265)" if sbf else ")"),
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=sdpa_ms,
                running_ms=run_ms, call_ms=call_ms, knob_free_ms=free_ms)
        del codes, parts, vp, qr, kr, q, k, v
        torch.cuda.empty_cache()

        # ---- the cross call over 512 keys: one-shot and bounded -----------
        lk = 512
        qc = fa._fold(qk_normed((b, l, n, d), gen, torch.float32),
                      1.0 / math.sqrt(d))
        kc = qk_normed((b, lk, n, d), gen, torch.float32)
        vc = torch.randn((b, lk, n, d), generator=gen, device="cuda")
        kvl = torch.tensor([lk, 100], dtype=torch.int32, device="cuda")
        km, vm = kc.clone(), vc.clone()
        km[1, 100:] = 50.0
        vm[1, 100:] = 50.0
        vc_max = float(vc.abs().max())
        # the one-shot max is the plain version's reference: only score
        # flips remain, as under the bound
        lim = F32_CHAIN_LIMITS["fp32_bounded"]
        err1 = compare_bf16_chain(
            "flash_attention_f32_sm90_sbf16_oneshot cross 512 keys, "
            "kv_len [512, 100]",
            fa._flash_cuda(qc, km, vm, kvl, None, None, softmax_bf16=True),
            fa.attention_plain(qc, km, vm, kv_len=kvl, softmax_bf16=True),
            vc_max, lim, fa._flash_cuda(qc, km, vm, kvl, None, None))
        err_o = compare_bf16_chain(
            "flash_attention_f32_sm90_sbf16_oneshot cross 512 keys",
            fa._flash_cuda(qc, kc, vc, None, None, None, softmax_bf16=True),
            fa.attention_plain(qc, kc, vc, softmax_bf16=True), vc_max, lim,
            fa._flash_cuda(qc, kc, vc, None, None, None))
        err_b = compare_bf16_chain(
            "flash_attention_f32_sm90_sbf16 cross 512 keys bounded",
            fa._flash_cuda(qc, kc, vc, None, bound, None, softmax_bf16=True),
            fa.attention_plain(qc, kc, vc, bound=bound, softmax_bf16=True),
            vc_max, lim, fa._flash_cuda(qc, kc, vc, None, bound, None))
        del km, vm
        cparts = [fa.split_bf16x3(x) for x in (qc, kc, vc)]
        one_ms = cuda_time(lambda: fa._fwd_f32_sm90_parts(
            *cparts, None, None, False, softmax_bf16=True, oneshot=True), 5)
        cb_ms = cuda_time(lambda: fa._fwd_f32_sm90_parts(
            *cparts, None, bound, False, softmax_bf16=True), 5)
        cfree_ms = cuda_time(lambda: fa._fwd_f32_sm90_parts(
            *cparts, None, None, False), 5)
        ccall_ms = cuda_time(lambda: fa._flash_cuda(
            qc, kc, vc, None, None, None, softmax_bf16=True), 5)
        cplain_ms = cuda_time(lambda: fa.attention_plain(
            qc, kc, vc, softmax_bf16=True), 1, warmup=0)
        qg, kg, vg = (x.transpose(1, 2) for x in (qc, kc, vc))
        csdpa_ms = cuda_time(lambda: F.scaled_dot_product_attention(
            qg, kg, vg, scale=1.0 / fa.LOG2E), 3)
        del qg, kg, vg, cparts
        cprod = 2.0 * b * n * l * lk * d
        cio = nbytes(qc, kc, vc, qc)
        # the function's 9 products (6 QK^T + 3 p v): the one-shot sweep's
        # second QK^T is the kernel's own cost, not the function's
        bms, by = bound_ms(9 * cprod, cio, H100_BF16_FLOPS)
        recs["flash_attention_f32_sm90_sbf16_oneshot"] = dict(
            name="flash_attention_f32_sm90_sbf16_oneshot", route="cuda",
            source=F32_SM90_SRC,
            replaces=rep + "355 (_cross_kernel, softmax_bf16 :402-403)",
            max_abs_err=max(err1, err_o), ms=one_ms, plain_ms=cplain_ms,
            bound_ms=bms, bound_by=by, library_ms=csdpa_ms,
            call_ms=ccall_ms, knob_free_ms=cfree_ms)
        log(json.dumps({"kernel_at_cross_shape": dict(
            name="flash_attention_f32_sm90_sbf16", route="cuda",
            source=F32_SM90_SRC,
            replaces=rep + "355 (_cross_kernel, softmax_bf16 :402-403)",
            max_abs_err=err_b, ms=cb_ms, plain_ms=cplain_ms, bound_ms=bms,
            bound_by=by, library_ms=csdpa_ms, knob_free_ms=cfree_ms)}))
        del qc, kc, vc
        torch.cuda.empty_cache()

        # ---- both knobs at the Ulysses shard [2, 32768, 6, 128] -----------
        q, k, v = case(n // 2)
        sv_max = float(v[:, :kv_real].abs().max())
        kw = dict(kv_len=kv_len, rope_tables=tabs, score_bound=bound,
                  softmax_bf16=True, qk_int8=True, block_k=bw,
                  softmax_scale=1.0 / math.sqrt(d))
        got = fa.flash_attention_padded(q, k, v, **kw)
        want = fa.attention_int8_plain(
            *fa.quantize_qk_int8_plain(q, k, tabs, bw), v, kv_len=kv_len,
            bound=bound, softmax_bf16=True, block_k=bw)
        err = compare_bf16_chain(
            "flash_attention_f32_sm90_int8_sbf16 sp = 2 shard [2, 32768, 6, "
            "128] bounded+rope", got, want, sv_max,
            F32_CHAIN_LIMITS["int8_bounded"],
            fa.flash_attention_padded(q, k, v, **{**kw,
                                                  "softmax_bf16": False}))
        del got, want
        sp_ms = cuda_time(lambda: fa.flash_attention_padded(q, k, v, **kw), 3)
        t_ops = (prod / 2 / H100_INT8_OPS + 3 * prod / 2 / H100_BF16_FLOPS) \
            * 1e3
        log(json.dumps({"kernel_at_sp_shape": dict(
            name="flash_attention_f32_sm90_int8_sbf16", route="cuda",
            source=F32_SM90_SRC, replaces=rep + "44",
            max_abs_err=err, call_ms=sp_ms, bound_ms=t_ops,
            bound_by="operations")}))
        del q, k, v
    torch.cuda.empty_cache()
    for rec in recs.values():
        log(json.dumps({"kernel": rec}))
    return recs


class _StepTimer:
    """A PhaseTimer-shaped recorder of each denoise step's seconds (the
    pipeline synchronises around each phase)."""

    def __init__(self):
        self.steps = []

    @contextlib.contextmanager
    def phase(self, name):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            torch.cuda.synchronize()
            self.steps.append((name, time.perf_counter() - t0))


def fp32_knob_main_path():
    """The fp32 knob path: t2v-1.3B at full width (dim 1536, 12 heads of
    d=128), depth cut to F32_KNOB_BLOCKS of its 30 blocks, fp32 weights
    drawn on the card from a seed (the zero head redrawn), through
    WanTI2VPipeline's denoise loop at 832x480x81 (32,760 tokens padded to
    32,768) under replace(FP32_POLICY, bounded_softmax=True, ...) with
    softmax_bf16, qk_int8 and both: F32_KNOB_STEPS UniPC steps a case with
    batch-2 CFG from a random [1, 512, 4096] text context, no decode (the
    knobs do not reach the VAE). Launches asserted per case (each block:
    the self-attention on its knob mode after the rope pre-pass or kernel
    B, the cross-attention on the bf16 chain's bounded mode or, under
    qk_int8 alone, the knob-free fp32 kernel); seconds per step, peak
    memory, finite latents. Returns {path: launches}."""
    import dataclasses
    import gc

    import torch

    from univid_tpu_torch.core.config import WAN_CONFIGS, latent_shape
    from univid_tpu_torch.core.dtypes import FP32_POLICY
    from univid_tpu_torch.models.wan.dit import WanDiT
    from univid_tpu_torch.pipelines.ti2v import WanTI2VPipeline

    gc.collect()
    torch.cuda.empty_cache()
    base = WAN_CONFIGS["t2v-1.3B"]
    spec = dataclasses.replace(base, dit=dataclasses.replace(
        base.dit, num_layers=F32_KNOB_BLOCKS))
    cfg = spec.dit
    _, f, lh, lw = latent_shape(spec, 832, 480, 81)
    grid = (f, lh // 2, lw // 2)
    tokens = grid[0] * grid[1] * grid[2]

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    t0 = time.perf_counter()
    dit = WanDiT(cfg, dtype=torch.float32, device="cuda", gen=gen(70))
    with torch.no_grad():   # a zero head would make every velocity 0
        dit.head.head.w.normal_(0.0, 0.02, generator=gen(71))
    c = spec.vae.z_dim
    noise = torch.randn((1, f, lh, lw, c), generator=gen(72), device="cuda")
    ctx, nctx = (torch.randn((1, cfg.text_len, cfg.text_dim),
                             generator=gen(s), device="cuda") * 0.5
                 for s in (73, 74))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    by_path = {}
    for case, knobs in F32_KNOB_CASES.items():
        policy = dataclasses.replace(FP32_POLICY, bounded_softmax=True,
                                     **knobs)
        pipe = WanTI2VPipeline(spec, dit, None, policy=policy)
        timer = _StepTimer()
        fn = pipe.denoise_fn((f, lh, lw), tokens, F32_KNOB_STEPS, 5.0, 5.0,
                             "unipc", None, timer=timer)
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t1 = time.perf_counter()
        x0 = fn(dit, noise, ctx, nctx, torch.zeros_like(noise))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = _all_counts()
        want = dict(dict.fromkeys(launches, 0), **_f32_knob_launches(
            knobs, F32_KNOB_STEPS, cfg.num_layers))
        step_s = [s for nm, s in timer.steps if nm == "dit_step"]
        out = {"phase": "fp32_knob_main_path", "model": "t2v-1.3B",
               "case": case, "policy": "FP32_POLICY, bounded_softmax",
               "knobs": knobs,
               "blocks": f"{cfg.num_layers} of {base.dit.num_layers}",
               "resolution": "832x480x81", "tokens": tokens,
               "steps": F32_KNOB_STEPS, "init_s": init_s, "seconds": wall,
               "step_seconds": step_s,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": {k: v for k, v in launches.items() if v},
               "expected_launches": {k: v for k, v in want.items() if v},
               "finite": bool(torch.isfinite(x0).all())}
        out["ok"] = (launches == want and out["finite"]
                     and len(step_s) == F32_KNOB_STEPS
                     and out["peak_memory_gb"] < 80.0)
        log(json.dumps(out))
        if not out["ok"]:
            fail(f"fp32 knob path {case}: launches, latents, steps or "
                 "memory off")
        by_path[f"fp32_knob_{case}"] = launches
        del x0, fn, pipe
    del dit, noise, ctx, nctx
    gc.collect()
    torch.cuda.empty_cache()
    return by_path


# ---------------------------------------------------------------------------
# checkpoint loading (the seventeenth slice)
# ---------------------------------------------------------------------------

CKPT_STEPS = 2   # denoise steps of the checkpoint run (+ the decode)
CKPT_PROMPT = "A corgi runs through a sunlit meadow, golden hour."


def _manifest_path(name):
    import os
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "manifests", f"{name}.json")


class HostPeak:
    """The peak resident set size of this process while the block runs
    (VmRSS of /proc/self/status, sampled every 10 ms), in GB. Resetting
    the kernel's own high-water mark (VmHWM) needs a write to
    /proc/self/clear_refs, which a sandboxed container may refuse
    (EPERM)."""

    @staticmethod
    def rss_gb():
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024 / 1e9
        return 0.0

    def __enter__(self):
        import threading
        self.start = self.peak = self.rss_gb()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(0.01):
            self.peak = max(self.peak, self.rss_gb())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.rss_gb())


def ckpt_draw(key, shape, index, seed):
    """The fp32 value written for a reference checkpoint key, drawn on the
    card from its own generator (seed, index), so that the bit check can
    draw it again: norm gains 1 + N(0, 0.02^2), modulations N(0, 1/d),
    UMT5's token embedding N(0, 1) and its q N(0, 1/(d * d_attn)) as the
    port's random init draws them, other weights N(0, 1/fan_in), biases
    and scalars N(0, 0.02^2)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed * 1_000_003 + index)
    x = torch.randn(tuple(shape), generator=g, device="cuda")
    leaf = key.rsplit(".", 1)[-1]
    if leaf == "gamma" or (leaf == "weight" and len(shape) == 1):
        return 1.0 + 0.02 * x
    if "modulation" in key:
        return x * shape[-1] ** -0.5
    if key == "token_embedding.weight":
        return x
    if key.endswith(".attn.q.weight"):
        return x * (shape[0] * shape[1]) ** -0.5
    if leaf.endswith("weight") and len(shape) >= 2:
        return x * math.prod(shape[1:]) ** -0.5
    return x * 0.02


def _draws(man, seed, dtype):
    """{key: (dtype, shape, make)} of a manifest for write_safetensors."""
    return {k: (dtype, tuple(s), lambda k=k, s=s, i=i:
                ckpt_draw(k, s, i, seed).to(dtype))
            for i, (k, s) in enumerate(sorted(man.items()))}


# the three files of a Wan2.1-T2V-1.3B checkpoint dir: (manifest, seed,
# the published file's dtype)
CKPT_FILES = {"dit": ("wan_t2v-1.3B_dit", 171, "float32"),
              "vae": ("wan_t2v-1.3B_vae", 172, "float32"),
              "umt5": ("umt5_xxl", 173, "bfloat16")}
DIT_INDEX = "diffusion_pytorch_model.safetensors.index.json"
# depth cuts for the time limit (at 30 and 24 blocks the phase took 64.3
# s, 22 s of it writing UMT5's 11.4 GB): the dir holds the first blocks
# of each, at full width, with the embeddings, norms and head
CKPT_LAYERS = {"dit": 10, "umt5": 6}   # of 30 DiT blocks, 24 UMT5 blocks


def ckpt_manifest(file):
    """The pinned manifest of a checkpoint file, without the blocks past
    its CKPT_LAYERS cut."""
    from univid_tpu_torch.core.manifest import load_manifest

    man = load_manifest(_manifest_path(CKPT_FILES[file][0]))
    n = CKPT_LAYERS.get(file)
    if n is None:
        return man
    return {k: v for k, v in man.items()
            if not k.startswith("blocks.") or int(k.split(".")[1]) < n}


def write_wan_ckpt(root):
    """A Wan2.1-layout t2v-1.3B checkpoint dir at full width, CKPT_LAYERS
    deep, from the pinned manifests (`ckpt_manifest`): the DiT as two fp32
    safetensors shards with their index (written by write_safetensors),
    Wan2.1_VAE.pth (fp32) and models_t5_umt5-xxl-enc-bf16.pth (bf16). ->
    {file: {path, bytes, write_s}}."""
    import os

    import torch

    out = {}
    _, seed, dt = CKPT_FILES["dit"]
    man = ckpt_manifest("dit")
    draws = _draws(man, seed, getattr(torch, dt))
    keys = sorted(man)
    sizes = [math.prod(man[k]) * 4 for k in keys]
    cut = next(i for i in range(len(keys))
               if sum(sizes[:i + 1]) >= sum(sizes) / 2) + 1
    t0 = time.perf_counter()
    weight_map, n = {}, 0
    for i, part in enumerate((keys[:cut], keys[cut:])):
        name = f"diffusion_pytorch_model-{i + 1:05d}-of-00002.safetensors"
        n += write_safetensors(os.path.join(root, name),
                               {k: draws[k] for k in part})
        weight_map.update(dict.fromkeys(part, name))
    with open(os.path.join(root, DIT_INDEX), "w") as f:
        json.dump({"metadata": {"total_size": sum(sizes)},
                   "weight_map": weight_map}, f)
    out["dit"] = {"path": root, "bytes": n,
                  "write_s": time.perf_counter() - t0, "shards": 2}
    for name, fname in (("vae", "Wan2.1_VAE.pth"),
                        ("umt5", "models_t5_umt5-xxl-enc-bf16.pth")):
        _, seed, dt = CKPT_FILES[name]
        man = ckpt_manifest(name)
        t0 = time.perf_counter()
        sd = {k: make().cpu() for k, (_, _, make) in
              _draws(man, seed, getattr(torch, dt)).items()}
        path = os.path.join(root, fname)
        torch.save(sd, path)
        del sd
        out[name] = {"path": path, "bytes": os.path.getsize(path),
                     "write_s": time.perf_counter() - t0}
    return out


def dit_leaf(key, x, dim):
    """The Wan DiT's layout rule for one reference key (a transcription of
    JAX's convert_wan_dit): (the port's name, x laid out, the leaf's
    dtype). The patch embedding [dim, in, pt, ph, pw] becomes [dim, (pt ph
    pw in)], a modulation [1, n, dim] becomes [n, dim]; the time MLPs, the
    head and every modulation are fp32, the rest bf16."""
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    if key == "patch_embedding.weight":
        return "patch_embed.w", \
            x.permute(0, 2, 3, 4, 1).reshape(dim, -1), bf16
    if key.endswith("modulation"):
        return key, x.reshape(-1, dim), f32
    name, leaf = key.rsplit(".", 1)
    for old, new in (("patch_embedding", "patch_embed"),
                     ("text_embedding.0", "text_embedding.fc0"),
                     ("text_embedding.2", "text_embedding.fc1"),
                     ("time_embedding.0", "time_embedding.fc0"),
                     ("time_embedding.2", "time_embedding.fc1"),
                     ("time_projection.1", "time_projection.fc0"),
                     ("ffn.0", "ffn.fc0"), ("ffn.2", "ffn.fc1")):
        if name.endswith(old):
            name = name[:-len(old)] + new
    port = name if name.endswith(("norm_q", "norm_k")) \
        else f"{name}.{'w' if leaf == 'weight' else 'b'}"
    fp32_leaf = name.startswith(("time_embedding", "time_projection",
                                 "head."))
    return port, x, f32 if fp32_leaf else bf16


def vae_leaf(key, x, num_res_blocks):
    """The Wan VAE's rule (JAX's convert_wan_vae): every leaf fp32; the
    RMS gammas flattened; a Conv2d [O, I, kh, kw] as a kt = 1 conv3d; the
    attention's 1x1 convs as linears; the reference's module names as the
    JAX tree's."""
    import torch

    name, leaf = key.rsplit(".", 1)
    res = {"residual.0": "norm1", "residual.2": "conv1",
           "residual.3": "norm2", "residual.6": "conv2",
           "shortcut": "shortcut"}
    m = re.fullmatch(r"(encoder|decoder)\.(down|up)samples\.(\d+)\."
                     r"(?:down|up)samples\.(\d+)\.(.+)", name)
    if m:
        part, kind, i, j, rest = m.groups()
        n_res = num_res_blocks + (part == "decoder")
        base = f"{part}.{kind}{i}"
        if int(j) < n_res:
            name = f"{base}.res{j}.{res[rest]}"
        else:
            name = f"{base}.{'resample' if rest == 'resample.1' else rest}"
    m = re.fullmatch(r"(encoder|decoder)\.middle\.(\d)\.(.+)", name)
    if m:
        part, j, rest = m.groups()
        if j == "1":
            rest = {"norm": "norm", "to_qkv": "qkv", "proj": "proj"}[rest]
            x = x[:, :, 0, 0] if x.ndim == 4 else x
        else:
            rest = res[rest]
        name = f"{part}.{('mid_res1', 'mid_attn', 'mid_res2')[int(j)]}." \
               f"{rest}"
    name = re.sub(r"^(encoder|decoder)\.head\.0$", r"\1.head_norm", name)
    name = re.sub(r"^(encoder|decoder)\.head\.2$", r"\1.head_conv", name)
    name = {"conv1": "conv_mu", "conv2": "conv_z"}.get(name, name)
    if leaf == "gamma":
        return name, x.reshape(-1), torch.float32
    if x.ndim == 4:   # a 2-D conv
        x = x[:, :, None]
    return f"{name}.{'w' if leaf == 'weight' else 'b'}", x, torch.float32


def umt5_leaf(key, x):
    """UMT5's rule (JAX's convert_umt5): every leaf bf16, the reference's
    names as the JAX tree's."""
    import torch

    name = key[:-len(".weight")]
    name = name.replace(".pos_embedding.embedding", ".pos_embedding")
    name = name.replace(".ffn.gate.0", ".ffn.gate")
    if re.search(r"\.(attn\.[qkvo]|ffn\.(gate|fc1|fc2))$", name):
        name += ".w"
    return name, x, torch.bfloat16


def check_ckpt_bits(file, module, rule):
    """Every parameter of `module` against the value written for its
    reference key, drawn again, under the layout rule: the same bits and
    the rule's dtype, and no parameter left over. -> parameters checked."""
    import torch

    _, seed, dt = CKPT_FILES[file]
    params = dict(module.named_parameters())
    seen = set()
    for i, (k, s) in enumerate(sorted(ckpt_manifest(file).items())):
        x = ckpt_draw(k, s, i, seed).to(getattr(torch, dt))
        name, want, dtype = rule(k, x)
        p = params.get(name)
        if p is None or p.dtype != dtype or not p.is_cuda \
                or not torch.equal(p, want.to(dtype)):
            fail(f"{file}: {k} -> {name} is not the written tensor "
                 f"({None if p is None else (p.dtype, p.device)} vs "
                 f"{dtype})")
        seen.add(name)
    if seen != set(params):
        fail(f"{file}: parameters not in the file: "
             f"{sorted(set(params) - seen)[:5]}")
    return len(seen)


def _timed_calls(module, names, into):
    """Wrap module.<name> for each name so that each call adds its
    synchronised seconds to into[name]; returns a function that restores
    them."""
    import torch

    saved = {n: getattr(module, n) for n in names}

    def wrap(n, fn):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            into[n] = into.get(n, 0.0) + time.perf_counter() - t0
            return out
        return timed

    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))
    return lambda: [setattr(module, n, fn) for n, fn in saved.items()]


def checkpoint_main_path(output_dir, steps=CKPT_STEPS):
    """t2v-1.3B serving from a Wan2.1-layout checkpoint dir at full width,
    cut to CKPT_LAYERS blocks of the DiT and of UMT5: write it from the
    pinned manifests, audit each file against
    its manifest (header-only for the shards), load the DiT and the VAE
    with load_wan_checkpoint and UMT5 with load_state_dict + convert_umt5
    onto the card (each file's seconds, the peak host RSS and device
    memory), hold every parameter to the written tensor bit for bit with
    JAX's leaf dtypes, check that WanTextEncoder.from_checkpoint raises
    load_tokenizer's RuntimeError (the dir has no tokenizer), then run
    t2v at 832x480x81 for `steps` steps through WanTI2VPipeline (the
    CLI's class and policy; UMT5 paired with the hash tokenizer, as the
    mock path pairs it) and the decode: the launches of `main_path` for
    `steps` steps, finite latents, an mp4 of 81 frames of 480x832. The
    dir is deleted at the end. Returns the run's launch counts."""
    import dataclasses
    import gc
    import importlib.util
    import os
    import shutil

    import numpy as np
    import torch

    from univid_tpu_torch.core import checkpoint as ck
    from univid_tpu_torch.core.config import TMAConfig, WAN_CONFIGS
    from univid_tpu_torch.core.dtypes import DEFAULT_POLICY
    from univid_tpu_torch.data.video_io import read_video_frames, save_video
    from univid_tpu_torch.kernels import flash_attention as fa
    from univid_tpu_torch.models.wan.vae_api import vae_decode
    from univid_tpu_torch.pipelines.encoders import WanTextEncoder
    from univid_tpu_torch.pipelines.ti2v import WanTI2VPipeline
    from univid_tpu_torch.utils.tokenizers import HashTokenizer

    gc.collect()
    torch.cuda.empty_cache()
    full = WAN_CONFIGS["t2v-1.3B"]
    spec = dataclasses.replace(
        full, dit=dataclasses.replace(full.dit,
                                      num_layers=CKPT_LAYERS["dit"]),
        t5=dataclasses.replace(full.t5, num_layers=CKPT_LAYERS["umt5"]))
    root = os.path.join(output_dir, "wan_t2v-1.3B_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    free = shutil.disk_usage(root).free
    if free < 25e9:
        fail(f"{free / 1e9:.1f} GB free under {root}; the checkpoint "
             "needs ~18 GB")
    rec = {"phase": "checkpoint_main_path", "disk_free_gb": free / 1e9,
           "packages": {p: importlib.util.find_spec(p) is not None
                        for p in ("safetensors", "transformers")}}
    t_all = time.perf_counter()
    with HostPeak() as rss:
        files = write_wan_ckpt(root)
    rec["write"] = {k: {"bytes": v["bytes"], "s": v["write_s"]}
                    for k, v in files.items()}
    rec["bytes_written"] = sum(v["bytes"] for v in files.values())
    rec["write_s"] = sum(v["write_s"] for v in files.values())
    rec["write_peak_host_rss_gb"] = rss.peak

    rec["audit"] = {}
    for name, info in files.items():
        t0 = time.perf_counter()
        diff = ck.audit_checkpoint(info["path"], ckpt_manifest(name))
        rec["audit"][name] = {"s": time.perf_counter() - t0,
                              **{k: len(v) for k, v in diff.items()}}
        if any(diff.values()):
            fail(f"the {name} checkpoint does not match its manifest: "
                 f"{ {k: v[:3] for k, v in diff.items()} }")

    # the DiT's and the VAE's seconds: reading (memory-mapped), converting
    # and placing each file on the card, through load_wan_checkpoint
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times = {}
    with HostPeak() as rss:
        restore = _timed_calls(ck, ("load_state_dict", "convert_wan_dit",
                                    "convert_wan_vae"), times)
        try:
            t0 = time.perf_counter()
            dit, vae = ck.load_wan_checkpoint(root, spec)
            torch.cuda.synchronize()
            dit_vae_s = time.perf_counter() - t0
        finally:
            restore()
        t0 = time.perf_counter()
        umt5 = ck.convert_umt5(ck.load_state_dict(files["umt5"]["path"]),
                               spec.t5)
        torch.cuda.synchronize()
        umt5_s = time.perf_counter() - t0
    lsd = times["load_state_dict"]
    rec["load_s"] = {"dit_and_vae": dit_vae_s,
                     "dit_convert": times["convert_wan_dit"],
                     "vae_convert": times["convert_wan_vae"],
                     "read_headers_and_maps": lsd, "umt5": umt5_s}
    rec["init_weights_s"] = dit_vae_s + umt5_s
    rec["load_peak_host_rss_gb"] = rss.peak
    rec["load_host_rss_before_gb"] = rss.start
    rec["load_peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["weights_device_gb"] = torch.cuda.memory_allocated() / 1e9

    t0 = time.perf_counter()
    dim = spec.dit.dim
    rec["params_checked"] = {
        "dit": check_ckpt_bits("dit", dit, lambda k, x: dit_leaf(k, x, dim)),
        "vae": check_ckpt_bits("vae", vae, lambda k, x: vae_leaf(
            k, x, spec.vae.num_res_blocks)),
        "umt5": check_ckpt_bits("umt5", umt5, umt5_leaf)}
    rec["bit_check_s"] = time.perf_counter() - t0
    rec["leaf_dtypes"] = {
        name: sorted({str(p.dtype) for p in m.parameters()})
        for name, m in (("dit", dit), ("vae", vae), ("umt5", umt5))}
    try:
        WanTextEncoder.from_checkpoint(root, spec)
    except RuntimeError as e:
        rec["from_checkpoint_without_tokenizer"] = str(e)[:160]
    else:
        fail("WanTextEncoder.from_checkpoint found a tokenizer in a dir "
             "without one")
    gc.collect()
    torch.cuda.empty_cache()

    fa.reset_launches()
    t0 = time.perf_counter()
    enc = WanTextEncoder(umt5, spec.t5,
                         HashTokenizer(vocab_size=spec.t5.vocab_size),
                         compute_dtype=torch.bfloat16)
    ctx = enc([CKPT_PROMPT, spec.sample_neg_prompt])
    torch.cuda.synchronize()
    rec["text_encode_s"] = time.perf_counter() - t0
    del enc, umt5
    gc.collect()
    torch.cuda.empty_cache()
    policy = dataclasses.replace(DEFAULT_POLICY, bounded_softmax=True)
    pipe = WanTI2VPipeline(spec, dit, vae, policy=policy)
    t0 = time.perf_counter()
    latent = pipe.generate(ctx[0], ctx[1], size=(832, 480), frame_num=81,
                           shift=5.0, sample_solver="unipc",
                           sampling_steps=steps, guide_scale=5.0, seed=0,
                           tma=TMAConfig(text_prefix_len=spec.dit.text_len),
                           decode=False)
    torch.cuda.synchronize()
    rec["denoise_s"] = time.perf_counter() - t0
    if not bool(torch.isfinite(latent).all()):
        fail("the checkpoint run's latents are not finite")
    t0 = time.perf_counter()
    with torch.no_grad():
        video = vae_decode(vae, latent)[0]
    torch.cuda.synchronize()
    rec["decode_s"] = time.perf_counter() - t0
    launches = launch_counts()
    frames_u8 = ((video.clamp(-1.0, 1.0) + 1.0) * 127.5).round() \
        .to(torch.uint8).cpu().numpy()
    path = save_video(frames_u8, os.path.join(output_dir,
                                              "t2v_from_checkpoint.mp4"),
                      fps=spec.generation.fps)
    frames = read_video_frames(path)
    blocks = spec.dit.num_layers
    expected = {"flash_attention_bf16": blocks * steps,
                "cross_attention_bf16": blocks * steps,
                "flash_attention_f32": 21,
                "qk_norm_rope_bf16": blocks * steps,
                "qk_norm_bf16": blocks * steps}
    expected = dict(dict.fromkeys(launches, 0), **expected)
    f32_by_d = dict(fa.F32_LAUNCHES_BY_D)
    f32_expected = {384: 21, 640: 0, 1024: 0}
    rec.update({
        "latent_shape": list(latent.shape),
        "latent_abs_max": float(latent.abs().max()),
        "video_std": float(np.asarray(frames_u8, np.float32).std()),
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "expected_launches": expected,
        "f32_launches_by_d": f32_by_d, "frames": len(frames),
        "frame_shape": list(frames[0].shape) if frames else None})
    del dit, vae, pipe, latent, video
    shutil.rmtree(root)
    rec["seconds"] = time.perf_counter() - t_all
    log(json.dumps(rec))
    if launches != expected or f32_by_d != f32_expected:
        fail(f"launch counts {launches} {f32_by_d} != {expected} "
             f"{f32_expected}")
    check_impl("t2v-1.3B from a checkpoint", 2 * blocks * steps)
    if len(frames) != 81 or frames[0].shape != (480, 832, 3):
        fail("the checkpoint run's mp4 is not 81 frames of 480x832")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


NAFLEX_HEADS = 12   # google/siglip2-base-patch16-naflex: both towers


def write_naflex_dir(root):
    """A siglip2-base-patch16-naflex-shaped dir from the pinned manifest:
    fp32 model.safetensors and a config.json with model_type siglip2 and
    the published head counts. -> bytes."""
    import os

    import torch

    from univid_tpu_torch.core.manifest import load_manifest

    os.makedirs(root, exist_ok=True)
    man = load_manifest(_manifest_path("siglip2_naflex"))
    n = write_safetensors(os.path.join(root, "model.safetensors"),
                          _draws(man, 174, torch.float32),
                          metadata={"format": "pt"})
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump({"model_type": "siglip2",
                   "vision_config": {"num_attention_heads": NAFLEX_HEADS},
                   "text_config": {"num_attention_heads": NAFLEX_HEADS}}, f)
    return n


def naflex_cli_on_card(output_dir):
    """The QA CLI with --mock_weights and --siglip_ckpt at a full-width
    NaFlex dir: the CLI takes the NaFlex scorer, warns that the dir has no
    tokenizer and takes the LM's, and ends with rounds [4, 8, 16]; then the
    dir's scorer on the card against the same dir loaded on the CPU, fp32
    on both sides (TF32 off): emb_imgs of 8 frames of mixed aspect ratios
    and emb_text within rel. L2 1e-4."""
    import contextlib
    import io
    import os
    import shutil

    import numpy as np
    import torch

    from univid_tpu_torch.cli import eval_understanding
    from univid_tpu_torch.data.video_io import save_video
    from univid_tpu_torch.reflection.naflex import Siglip2NaflexScorer
    from univid_tpu_torch.utils.tokenizers import HashTokenizer

    root = os.path.join(output_dir, "siglip2_naflex")
    vdir = os.path.join(output_dir, "naflex_cli")
    t0 = time.perf_counter()
    n_bytes = write_naflex_dir(root)
    write_s = time.perf_counter() - t0
    frames = np.random.default_rng(13).integers(0, 256, (16, 96, 128, 3),
                                                dtype=np.uint8)
    save_video(frames, os.path.join(vdir, "video1.mp4"), fps=8)
    with open(os.path.join(vdir, "gt.json"), "w") as f:
        json.dump([{"video_id": 1, "question": "what moves?",
                    "answer": "a ball"}], f)
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        summary = eval_understanding.main([
            "--video_dir", vdir, "--gt_file", os.path.join(vdir, "gt.json"),
            "--output_dir", os.path.join(vdir, "out"), "--output_name",
            "batch1", "--id_from", "1", "--id_to", "1", "--mock_weights",
            "--siglip_ckpt", root, "--pool_frames", "16",
            "--max_think_token_n", "16", "--save_frames_root", "",
            "--deepseek_api_key", ""])
    cli_s = time.perf_counter() - t0
    sys.stderr.write(err.getvalue())
    with open(os.path.join(vdir, "out", "video1_reflexion.json")) as f:
        trace = json.load(f)
    warned = "using the LM tokenizer" in err.getvalue()

    rng = np.random.default_rng(14)
    shapes = [(480, 832), (832, 480), (360, 640), (512, 512), (97, 53),
              (224, 224), (300, 500), (64, 1024)]
    pool = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for hw in shapes]
    question = "what moves across the frame?"
    emb = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        s = Siglip2NaflexScorer.from_checkpoint(
            root, tokenizer=HashTokenizer(vocab_size=4090), device=dev,
            compute_dtype=torch.float32)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        emb[dev] = (s.emb_imgs(pool), s.emb_text(question), load_s,
                    time.perf_counter() - t0)
        del s
    rel_img = rel_l2(torch.as_tensor(emb["cuda"][0]),
                     torch.as_tensor(emb["cpu"][0]))
    rel_txt = rel_l2(torch.as_tensor(emb["cuda"][1]),
                     torch.as_tensor(emb["cpu"][1]))
    shutil.rmtree(root)
    out = {"check": "naflex_cli_on_card", "bytes_written": n_bytes,
           "write_s": write_s, "cli_s": cli_s,
           "num_samples": summary["num_samples"],
           "rounds": [r["K"] for r in trace["rounds"]],
           "tokenizer_fallback_warned": warned,
           "emb_imgs_rel_l2_card_vs_cpu": rel_img,
           "emb_text_rel_l2_card_vs_cpu": rel_txt,
           "load_s": {d: emb[d][2] for d in emb},
           "embed_s": {d: emb[d][3] for d in emb},
           "frame_shapes": shapes, "bound": 1e-4}
    out["ok"] = (out["num_samples"] == 1 and out["rounds"] == [4, 8, 16]
                 and warned and rel_img < 1e-4 and rel_txt < 1e-4)
    log(json.dumps(out))
    if not out["ok"]:
        fail("the QA CLI with a NaFlex --siglip_ckpt on the card")


# ---------------------------------------------------------------------------
# multi-GPU serving: two ranks on the one card
# ---------------------------------------------------------------------------

SP_WORLD = 2         # the sp = 2 mesh's ranks, both on the one card
SP_LAYERS = 2        # of t2v-1.3B's 30 blocks (the time limit: at 6 the
#                      phase took 42.5-65.8 s; cut from 4 to pay for
#                      sp_tp_main_path); full width
SP_STEPS = 2         # UniPC steps of the Ulysses pipeline run
SP_T5_LAYERS = 2     # of UMT5-XXL's 24 blocks (full width, fp32)
SP_DEADLINE = 480    # s the ranks may take together, start-up included
SP_SHAPE = dict(size=(832, 480), frame_num=81)   # 32,760 tokens
SP_WHY = ("the bf16 policy's bound: the sequence-parallel forward runs the "
          "same kernels at other shapes (N/sp heads, L/sp queries), and the "
          "ring merges bf16 partials in fp32")


def _sp_tol():
    return dict(atol=1e-3, rtol=2.0 ** -7,
                why="one bf16 ulp of the output (at most 2^-7 relative) "
                    "plus 1e-3 for the fp32 summation order and the "
                    "approximate exp2 before p rounds to bf16")


def check_sp_kernels(tp=1):
    """The kernels of the sequence-parallel path at its shard shapes
    (t2v-1.3B at 832x480x81, sp = 2, batch-2 CFG; with tp = 2 beside it,
    N / tp = 6 of the 12 heads a rank): Ulysses self-attention over the
    whole sequence at N/(sp tp) heads, [2, 32768, 6 or 3, 128] over 32,760
    keys (bounded, after kernel A's rope-only mode, whose output must
    equal the plain rotation bit for bit); at tp = 1 kernel A's norm-only
    mode before the exchange, on a rank's q and k [2, 16384, 12, 128] (at
    tp = 2 the norm is `rms_norm_tp`, plain torch over the tp group); the
    ring's partials, q [2, 16384, 12 or 6, 128] over a kv shard of 16,384
    keys with kv_len 16,384, 16,376 and 0 (running max with the lse; lse
    within 1e-3, kv_len 0 rows exactly 0 with lse +1e30); cross-attention
    [2, 16384, 12 or 6, 128] over 512 keys. Each against its plain
    version, timed beside SDPA on the same inputs. Returns the
    kernels-line records (names `*_sp` at tp = 1, `*_sp_tp` at tp = 2)."""
    import torch
    import torch.nn.functional as F

    from univid_tpu_torch.kernels import flash_attention as fa
    from univid_tpu_torch.ops.rope import build_rope_3d

    gen = torch.Generator(device="cuda").manual_seed(19 + tp)
    sfx, tag = ("", "sp=2") if tp == 1 else ("_tp", f"sp=2 x tp={tp}")
    n_all = 12 // tp   # the rank's heads before the exchange
    b, d, l, l_loc, lk = 2, 128, 32768, 16384, 512
    grid = (21, 30, 52)
    kv_real = grid[0] * grid[1] * grid[2]
    sc = fa.LOG2E / math.sqrt(d)
    bound = torch.tensor([1.01 * d * sc], device="cuda")
    src = "univid_tpu_torch/kernels/csrc/flash_attention_sm90.cu"
    recs = {}
    with torch.no_grad():
        # ---- Ulysses: the whole sequence at 12 / (sp tp) of the heads ----
        n = n_all // SP_WORLD
        q = qk_normed((b, l, n, d), gen, torch.bfloat16)
        k = qk_normed((b, l, n, d), gen, torch.bfloat16)
        v = torch.randn((b, l, n, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        k[:, kv_real:] = 50.0   # padded keys: large values
        v[:, kv_real:] = 50.0
        cos, sin = build_rope_3d(d, grid, device="cuda")
        tabs = fa._pad_tables(fa.build_fused_rope_tables(cos, sin, d), l, l,
                              sc)
        kv_len = torch.full((b,), kv_real, dtype=torch.int32, device="cuda")
        got = fa._flash_cuda(q, k, v, kv_len, bound, tabs)
        want = fa.attention_plain(q, k, v, kv_len=kv_len, bound=bound,
                                  rope_tables=tabs)
        err = compare(f"flash_attention_bf16 {tag} ulysses [2, 32768, {n}, "
                      "128] bounded+rope+kv_len", got, want, **_sp_tol())
        qr, kr = fa.qk_norm_rope(q, k, rope_tables=tabs)
        pq, pk = fa.qk_norm_rope_plain(q, k, None, tabs)
        equal = [bool(torch.equal(qr, pq)), bool(torch.equal(kr, pk))]
        log(json.dumps({"check": f"qk_rope_bf16 {tag} ulysses rope only "
                                 f"[2, 32768, {n}, 128] (q, k)",
                        "equal": equal, "why": "the same fp32 products and "
                        "sum, one rounding to bf16", "ok": all(equal)}))
        if not all(equal):
            fail("qk_rope_bf16: rope only is not bit-equal at the Ulysses "
                 "shape")
        ms = cuda_time(lambda: fa._flash_cuda(qr, kr, v, kv_len, bound,
                                              None), 3)
        plain_ms = cuda_time(lambda: fa.attention_plain(
            qr, kr, v, kv_len=kv_len, bound=bound), 1)
        qs, ks, vs = (x.transpose(1, 2) for x in (qr, kr, v))
        lib_ms = cuda_time(lambda: F.scaled_dot_product_attention(
            qs, ks[:, :, :kv_real], vs[:, :, :kv_real], scale=1.0 / fa.LOG2E),
            3)
        bms, by = bound_ms(4 * b * n * l * kv_real * d, nbytes(qr, kr, v, got),
                           H100_BF16_FLOPS)
        recs[f"flash_attention_bf16_sp{sfx}"] = dict(
            name=f"flash_attention_bf16_sp{sfx}",
            counter="flash_attention_bf16", route="cuda", source=src,
            replaces="univid_tpu/kernels/flash_attention.py:44",
            shape=f"Ulysses ({tag}) [2, 32768, {n}, 128] over 32,760 keys",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=by, library_ms=lib_ms)
        ms_r = cuda_time(lambda: fa.qk_norm_rope(q, k, rope_tables=tabs), 5)
        plain_r = cuda_time(lambda: fa.qk_norm_rope_plain(q, k, None, tabs),
                            2)
        bms, by = bound_ms(0, nbytes(q, k, qr, kr, *tabs), H100_BF16_FLOPS)
        recs[f"qk_rope_bf16_sp{sfx}"] = dict(
            name=f"qk_rope_bf16_sp{sfx}", counter="qk_rope_bf16",
            route="cuda",
            source="univid_tpu_torch/kernels/csrc/qk_prepass.cu",
            replaces="univid_tpu/kernels/flash_attention.py:157",
            shape=f"rope only, q and k [2, 32768, {n}, 128]", max_abs_err=0.0,
            ms=ms_r, plain_ms=plain_r, bound_ms=bms, bound_by=by,
            library_ms=None)
        del q, k, v, got, want, qr, kr, pq, pk, qs, ks, vs

        # ---- kernel A's norm before the exchange: a rank's tokens -------
        n = n_all
        if tp == 1:
            q = (torch.randn((b, l_loc, n, d), generator=gen, device="cuda")
                 * 3).to(torch.bfloat16)
            k = (torch.randn((b, l_loc, n, d), generator=gen, device="cuda")
                 * 3).to(torch.bfloat16)
            gq, gk = ((torch.rand((n * d,), generator=gen, device="cuda") + 0.5)
                      .to(torch.bfloat16) for _ in range(2))
            norm = (gq, gk, QK_EPS)
            want = fa.qk_norm_rope_plain(q, k, norm)
            got = fa.qk_norm_rope(q, k, qk_norm=norm)
            err = max(compare_within(
                f"qk_norm_bf16 sp=2 norm before the exchange {nm}", g, w,
                QK_STEP * w.float().abs(), QK_WHY)
                for nm, g, w in (("q", got[0], want[0]), ("k", got[1], want[1])))
            ms_n = cuda_time(lambda: fa.qk_norm_rope(q, k, qk_norm=norm), 5)
            plain_n = cuda_time(lambda: fa.qk_norm_rope_plain(q, k, norm), 2)
            w_ = n * d
            lib_n = cuda_time(lambda: (
                F.rms_norm(q.view(b, l_loc, w_), (w_,), gq, QK_EPS),
                F.rms_norm(k.view(b, l_loc, w_), (w_,), gk, QK_EPS)), 5)
            bms, by = bound_ms(0, nbytes(q, k, *want, gq, gk), H100_BF16_FLOPS)
            recs["qk_norm_bf16_sp"] = dict(
                name="qk_norm_bf16_sp", counter="qk_norm_bf16", route="cuda",
                source="univid_tpu_torch/kernels/csrc/qk_prepass.cu",
                replaces="univid_tpu/kernels/flash_attention.py:157",
                shape="norm only, q and k [2, 16384, 12, 128]", max_abs_err=err,
                ms=ms_n, plain_ms=plain_n, bound_ms=bms, bound_by=by,
                library_ms=lib_n)
            del q, k, got, want

        # ---- ring: a rank's queries over one visiting kv shard ----------
        q = qk_normed((b, l_loc, n, d), gen, torch.bfloat16)
        k = qk_normed((b, l_loc, n, d), gen, torch.bfloat16)
        v = torch.randn((b, l_loc, n, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        k[:, l_loc - 8:] = 50.0   # the pad of shard 1 (16,376 real keys)
        v[:, l_loc - 8:] = 50.0
        qs = fa._fold(q, 1.0 / math.sqrt(d))
        err, lse_err = 0.0, 0.0
        for kvl in ([l_loc, l_loc - 8], [l_loc - 8, 0]):
            kv = torch.tensor(kvl, dtype=torch.int32, device="cuda")
            if kvl[0] == l_loc:   # shard 0: every key real
                kk, vv = k.clone(), v.clone()
                kk[0, l_loc - 8:] = qk_normed((8, n, d), gen, torch.bfloat16)
                vv[0, l_loc - 8:] = 1.0
            else:
                kk, vv = k, v
            o, lse = fa.flash_attention_padded(q, kk, vv, kv_len=kv,
                                               save_residuals=True)
            wo, wl = fa.attention_plain(qs, kk, vv, kv_len=kv,
                                        save_residuals=True)
            err = max(err, compare(f"flash_attention_bf16_lse {tag} ring "
                                   f"[2, 16384, {n}, 128] kv_len {kvl}", o,
                                   wo, **_sp_tol()))
            live = kv > 0
            lse_err = max(lse_err, compare(
                f"flash_attention_bf16_lse {tag} ring lse kv_len {kvl}",
                lse[live], wl[live], atol=1e-3, rtol=0.0,
                why="the lse of §2: fp32 sums in another order"))
            if not live.all():
                empty = ~live
                if float(o[empty].abs().max()) != 0.0 or not bool(
                        (lse[empty] == -fa.NEG_INF).all()):
                    fail("ring: kv_len 0 rows are not exactly 0 with lse "
                         "+1e30")
            del kk, vv, o, lse, wo, wl
        kv = torch.full((b,), l_loc, dtype=torch.int32, device="cuda")
        ms = cuda_time(lambda: fa.flash_attention_padded(
            q, k, v, kv_len=kv, save_residuals=True), 3)
        plain_ms = cuda_time(lambda: fa.attention_plain(
            qs, k, v, kv_len=kv, save_residuals=True), 1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = cuda_time(lambda: F.scaled_dot_product_attention(
            qt, kt, vt), 3)
        bms, by = bound_ms(4 * b * n * l_loc * l_loc * d,
                           nbytes(q, k, v, q) + b * n * l_loc * 4,
                           H100_BF16_FLOPS)
        recs[f"flash_attention_bf16_lse_sp{sfx}_ring"] = dict(
            name=f"flash_attention_bf16_lse_sp{sfx}_ring",
            counter="flash_attention_bf16_lse", route="cuda", source=src,
            replaces="univid_tpu/kernels/flash_attention.py:343",
            shape=f"ring ({tag}) q [2, 16384, {n}, 128] over a kv shard of "
                  "16,384 (kv_len 16,384 / 16,376 / 0)",
            max_abs_err=err, lse_max_abs_err=lse_err, ms=ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms)
        del k, v, kt, vt

        # ---- cross-attention: a rank's tokens over 512 text keys --------
        qx = q * torch.tensor(sc, dtype=torch.bfloat16, device="cuda")
        k = qk_normed((b, lk, n, d), gen, torch.bfloat16)
        v = torch.randn((b, lk, n, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        got = fa.cross_attention_padded(qx, k, v, score_bound=bound)
        err = compare(f"cross_attention_bf16 {tag} [2, 16384, {n}, 128] x "
                      "512 bounded", got,
                      fa.attention_plain(qx, k, v, bound=bound), **_sp_tol())
        ms = cuda_time(lambda: fa.cross_attention_padded(
            qx, k, v, score_bound=bound), 5)
        plain_ms = cuda_time(lambda: fa.attention_plain(qx, k, v,
                                                        bound=bound), 1)
        qt, kt, vt = (x.transpose(1, 2) for x in (qx, k, v))
        lib_ms = cuda_time(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, scale=1.0 / fa.LOG2E), 5)
        bms, by = bound_ms(4 * b * n * l_loc * lk * d, nbytes(qx, k, v, got),
                           H100_BF16_FLOPS)
        recs[f"cross_attention_bf16_sp{sfx}"] = dict(
            name=f"cross_attention_bf16_sp{sfx}",
            counter="cross_attention_bf16", route="cuda", source=src,
            replaces="univid_tpu/kernels/flash_attention.py:355",
            shape=f"({tag}) [2, 16384, {n}, 128] over [2, 512, {n}, 128]",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=by, library_ms=lib_ms)
        del q, qs, qx, k, v, got, qt, kt, vt
    torch.cuda.empty_cache()
    for r in recs.values():
        log(json.dumps({"kernel": r}))
    return recs


def _sp_spec():
    """t2v-1.3B at full width, SP_LAYERS blocks; UMT5-XXL at SP_T5_LAYERS."""
    import dataclasses

    from univid_tpu_torch.core.config import WAN_CONFIGS

    spec = WAN_CONFIGS["t2v-1.3B"]
    return dataclasses.replace(
        spec, dit=dataclasses.replace(spec.dit, num_layers=SP_LAYERS),
        t5=dataclasses.replace(spec.t5, num_layers=SP_T5_LAYERS))


def _rank_entry(work, deadline, rank, init, results, log_path):
    """A spawned rank of a multi-rank phase: work(rank, init, note) under
    no_grad (a train step enables grad itself), its record or its
    traceback put on `results`; note(msg) appends to log_path, where a
    rank still running near the deadline also dumps its stacks."""
    import faulthandler
    import traceback

    import torch
    t0 = time.perf_counter()
    with open(log_path, "w") as f:
        def note(msg):
            f.write(f"{time.perf_counter() - t0:8.1f} s  {msg}\n")
            f.flush()

        faulthandler.dump_traceback_later(deadline - 30, file=f)
        try:
            with torch.no_grad():
                results.put((rank, True, work(rank, init, note)))
        except BaseException:
            results.put((rank, False, traceback.format_exc()))
        faulthandler.cancel_dump_traceback_later()


def _run_ranks(tag, work, world, deadline, output_dir):
    """Spawn `world` ranks of work(rank, init, note) on the one card
    (`_rank_entry`, a file rendezvous in output_dir) and collect their
    records: a rank that fails, or the ranks past `deadline` s, kill them
    all and fail the run. Returns ({rank: record}, wall seconds, the
    ranks' log tails)."""
    import multiprocessing as mp
    import os
    import queue

    ctx = mp.get_context("spawn")
    os.makedirs(output_dir, exist_ok=True)
    init = os.path.join(os.path.abspath(output_dir), f"{tag}_rendezvous")
    if os.path.exists(init):
        os.remove(init)
    results = ctx.Queue()
    logs = [os.path.join(output_dir, f"{tag}_rank{r}.log")
            for r in range(world)]
    procs = [ctx.Process(target=_rank_entry,
                         args=(work, deadline, r, f"file://{init}", results,
                               logs[r]))
             for r in range(world)]

    def tails():
        out = []
        for path in logs:
            if os.path.exists(path):
                with open(path) as f:
                    out.append(f"{path}:\n{f.read()[-3000:]}")
        return "\n".join(out)
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got = {}
    end = time.monotonic() + deadline
    try:
        while len(got) < world:
            try:
                rank, ok, rec = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead or time.monotonic() > end:
                    fail(f"{tag}: a rank died ({dead}) or the ranks passed "
                         f"{deadline} s\n{tails()}")
                continue
            if not ok:
                fail(f"{tag}: rank {rank} failed:\n{rec}\n{tails()}")
            got[rank] = rec
        for p in procs:
            p.join(max(1.0, end - time.monotonic()))
            if p.exitcode != 0:
                fail(f"{tag}: a rank exited with {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    if os.path.exists(init):
        os.remove(init)
    return got, time.perf_counter() - t0, tails()


def _sp_rank_work(rank, init, note):
    """One rank of sp_main_path. Returns its records (numbers only);
    note(msg) logs its progress."""
    import torch
    import torch.distributed as dist

    from univid_tpu_torch.core.mesh import MeshSpec, make_mesh
    from univid_tpu_torch.kernels import flash_attention as fa
    from univid_tpu_torch.models.wan.dit import (WanDiT, wan_dit_forward,
                                                 wan_dit_forward_sp)
    from univid_tpu_torch.models.wan.t5 import UMT5Encoder, encode_padded
    from univid_tpu_torch.parallel import sharding
    from univid_tpu_torch.parallel.ring import ring_attention
    from univid_tpu_torch.pipelines.ti2v import (WanTI2VPipeline, dit_rope,
                                                 padded_seq_len)
    from univid_tpu_torch.utils.profiling import PhaseTimer

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=SP_WORLD)
    note("group up")
    out = {"rank": rank}
    comm = {"s": 0.0, "calls": 0}

    def timed(fn):   # a collective, synchronised on both sides
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            comm["s"] += time.perf_counter() - t0
            comm["calls"] += 1
            return res
        return call

    dist.all_to_all_single = timed(dist.all_to_all_single)
    dist.all_gather = timed(dist.all_gather)

    spec = _sp_spec()
    cfg = spec.dit
    g = torch.Generator(device="cuda").manual_seed(0)
    dit = WanDiT(cfg, dtype=torch.bfloat16, device="cuda", gen=g)
    with torch.no_grad():   # a seeded head: init's zero head gives v = 0
        dit.head.head.w.copy_(torch.randn(
            dit.head.head.w.shape, generator=g, device="cuda") * 0.02)
    ctx, nctx = (torch.randn((cfg.text_len, cfg.text_dim), generator=g,
                             device="cuda") * 0.5 for _ in range(2))
    mesh = make_mesh(MeshSpec(sp=SP_WORLD))
    kw = dict(SP_SHAPE, sampling_steps=SP_STEPS, seed=0, decode=False)

    # ---- (a) Ulysses through the pipeline, then one rank alone ----------
    fa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    comm.update(s=0.0, calls=0)
    timer = PhaseTimer()
    t0 = time.perf_counter()
    lat = WanTI2VPipeline(spec, dit, None, sp_size=SP_WORLD,
                          mesh=mesh).generate(ctx, nctx, timer=timer, **kw)
    torch.cuda.synchronize()
    out["ulysses"] = dict(
        seconds=time.perf_counter() - t0,
        dit_step_s=timer.totals["dit_step"] / SP_STEPS,
        collectives_s=comm["s"] / SP_STEPS, collective_calls=comm["calls"],
        collective_share=comm["s"] / timer.totals["dit_step"],
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=launch_counts(), by_impl=dict(fa.LAUNCHES_BY_IMPL),
        latent_shape=list(lat.shape), finite=bool(torch.isfinite(lat).all()))
    dist.barrier()
    if rank == 0:
        timer1 = PhaseTimer()
        torch.cuda.reset_peak_memory_stats()
        one = WanTI2VPipeline(spec, dit, None).generate(ctx, nctx,
                                                         timer=timer1, **kw)
        out["single"] = dict(
            dit_step_s=timer1.totals["dit_step"] / SP_STEPS,
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
            latent_rel_l2=rel_l2(lat, one))
        del one
    dist.barrier()
    del lat
    note("Ulysses pipeline")

    # ---- (b) ring: one DiT call, and a call with a shard all padding ----
    grid = (21, 60, 104)
    x = torch.randn((2,) + grid + (cfg.in_dim,), generator=g, device="cuda")
    t = torch.tensor([700.0, 700.0], device="cuda")
    ctx2 = torch.stack([ctx, nctx])
    rope = dit_rope(cfg, grid, "cuda")
    seq = padded_seq_len(spec, SP_SHAPE["size"], SP_SHAPE["frame_num"],
                         SP_WORLD)
    fa.reset_launches()
    comm.update(s=0.0, calls=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    o_ring = wan_dit_forward_sp(dit, x, t, ctx2, *rope, mesh=mesh,
                                sp_impl="ring", seq_pad_to=seq)
    torch.cuda.synchronize()
    out["ring"] = dict(seconds=time.perf_counter() - t0,
                       collectives_s=comm["s"], collective_calls=comm["calls"],
                       launches=launch_counts(),
                       by_impl=dict(fa.LAUNCHES_BY_IMPL),
                       finite=bool(torch.isfinite(o_ring).all()))
    o_one = wan_dit_forward(dit, x, t, ctx2, *rope, seq_pad_to=seq)
    out["ring"]["rel_l2"] = rel_l2(o_ring, o_one)
    del o_ring
    group = mesh["sp"].get_group()
    gk = torch.Generator(device="cuda").manual_seed(21)
    shape = (2, seq, cfg.num_heads, cfg.head_dim)
    q = qk_normed(shape, gk, torch.bfloat16)
    k = qk_normed(shape, gk, torch.bfloat16)
    v = torch.randn(shape, generator=gk, device="cuda").to(torch.bfloat16)
    # row 0: rank 1's shard all padding; row 1: its real keys end inside
    real = torch.tensor([seq // 2, seq - 2000], dtype=torch.int32,
                        device="cuda")
    for row in range(2):
        k[row, int(real[row]):] = 50.0
        v[row, int(real[row]):] = 50.0
    rows = slice(rank * seq // 2, (rank + 1) * seq // 2)
    ql, kl, vl = (x[:, rows].contiguous() for x in (q, k, v))
    o = ring_attention(ql, kl, vl, group, seq_len_global=real)
    want = fa.flash_attention_padded(ql, k, v, kv_len=real)
    out["ring_padded_shard"] = dict(rel_l2=rel_l2(o, want),
                                    max_abs_err=float(
                                        (o.float() - want.float()).abs()
                                        .max()),
                                    finite=bool(torch.isfinite(o).all()))
    del q, k, v, ql, kl, vl, o, want

    note("ring calls")

    # ---- (c) FSDP over fsdp = 2: the DiT and UMT5-XXL ------------------
    mesh_f = make_mesh(MeshSpec(fsdp=SP_WORLD))
    torch.cuda.reset_peak_memory_stats()
    sharding.shard_params(dit, mesh_f, sharding.dit_param_sharding_rules())
    w = dit.blocks[0].self_attn.q.w
    o_fsdp = wan_dit_forward(dit, x, t, ctx2, *rope, seq_pad_to=seq)
    out["fsdp_dit"] = dict(
        rel_l2=rel_l2(o_fsdp, o_one), local_q_shape=list(w.to_local().shape),
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    del dit, o_fsdp, o_one, w
    torch.cuda.empty_cache()
    t5 = UMT5Encoder(spec.t5, dtype=torch.float32, device="cuda",
                     gen=torch.Generator(device="cuda").manual_seed(2))
    ids = torch.randint(0, spec.t5.vocab_size, (2, spec.t5.text_len),
                        generator=g, device="cuda")
    lens = torch.tensor([120, spec.t5.text_len], device="cuda")
    ref = encode_padded(t5, ids, lens, compute_dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats()
    sharding.shard_params(t5, mesh_f, sharding.t5_param_sharding_rules())
    got = encode_padded(t5, ids, lens, compute_dtype=torch.float32)
    out["fsdp_t5"] = dict(
        rel_l2=rel_l2(got, ref),
        local_embedding_shape=list(t5.token_embedding.to_local().shape),
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    dist.barrier()
    dist.destroy_process_group()
    return out


def sp_main_path(output_dir):
    """Phase 13: multi-GPU serving, two ranks on the one card over gloo
    (NCCL refuses two ranks on one device; gloo takes the CUDA tensors of
    all_to_all_single and all_gather, and FSDP2's all-gather), t2v-1.3B at
    full width and SP_LAYERS blocks, the same seeded weights on each rank:
    (a) WanTI2VPipeline(sp_size=2, mesh) for SP_STEPS UniPC steps at
    832x480x81 from a seeded context (decode=False, Ulysses with the fused
    rope), held to the single-rank pipeline's latent from the same seed
    (rank 0, after); (b) one wan_dit_forward_sp(sp_impl='ring') call held
    to wan_dit_forward, and one ring_attention call whose real length
    leaves rank 1's shard of batch row 0 all padding, held to one kernel
    call over every key; (c) on an fsdp = 2 mesh, one DiT call and one
    UMT5-XXL encode_padded (fp32, SP_T5_LAYERS blocks) after shard_params,
    held to the unsharded module. Records seconds per step against the
    single rank, the collectives' share of the step (each collective
    synchronised on both sides: a cost of gloo on one card, not a figure
    for NVLink), peak memory per rank. The kernels are built in this
    process before the ranks start. Each rank's launches are counted from
    zero just before its run; a rank that fails, or the pair past
    SP_DEADLINE, kills both and fails the run. Returns {path: launches}
    summed over the ranks."""
    got, wall, tails = _run_ranks("sp", _sp_rank_work, SP_WORLD,
                                  SP_DEADLINE, output_dir)
    log(json.dumps({"sp_rank_logs": tails}))

    n, steps = SP_LAYERS, SP_STEPS
    zero = dict.fromkeys(got[0]["ulysses"]["launches"], 0)
    want_u = dict(zero, flash_attention_bf16=n * steps,
                  cross_attention_bf16=n * steps,
                  qk_rope_bf16=n * steps,       # kernel A after the exchange
                  qk_norm_bf16=2 * n * steps)   # before it, and the cross q/k
    # the ring rotates and norms q and k in the block (JAX's XLA path), its
    # cross-attention too: no pre-pass
    want_r = dict(zero, flash_attention_bf16_lse=SP_WORLD * n,
                  cross_attention_bf16=n)
    impl_u = {"sm90": 2 * n * steps, "causal_sm90": 0, "mma_sync": 0}
    impl_r = {"sm90": (SP_WORLD + 1) * n, "causal_sm90": 0, "mma_sync": 0}
    single = got[0]["single"]
    u0 = got[0]["ulysses"]
    log(json.dumps({
        "phase": "sp_main_path", "model": f"t2v-1.3B ({n} of 30 blocks, "
        "full width)", "resolution": "832x480x81", "sp": SP_WORLD,
        "seconds": wall, "ranks": got,
        "dit_step_s_sp2": u0["dit_step_s"],
        "dit_step_s_single": single["dit_step_s"],
        "collective_share": u0["collective_share"],
        "expected_launches_per_rank": {"ulysses": want_u, "ring": want_r},
        "expected_by_impl_per_rank": {"ulysses": impl_u, "ring": impl_r}}))
    for rank, rec in got.items():
        u, r = rec["ulysses"], rec["ring"]
        if u["launches"] != want_u or u["by_impl"] != impl_u:
            fail(f"sp rank {rank}: Ulysses launches {u['launches']} "
                 f"{u['by_impl']} != {want_u} {impl_u}")
        if r["launches"] != want_r or r["by_impl"] != impl_r:
            fail(f"sp rank {rank}: ring launches {r['launches']} "
                 f"{r['by_impl']} != {want_r} {impl_r}")
        if not (u["finite"] and r["finite"]
                and rec["ring_padded_shard"]["finite"]):
            fail(f"sp rank {rank}: non-finite output")
        checks = [("ring DiT call vs wan_dit_forward", r["rel_l2"], 3e-2),
                  ("ring with a shard all padding vs one kernel call",
                   rec["ring_padded_shard"]["rel_l2"], 3e-2),
                  ("FSDP DiT vs unsharded", rec["fsdp_dit"]["rel_l2"], 3e-2),
                  ("FSDP UMT5-XXL fp32 vs unsharded",
                   rec["fsdp_t5"]["rel_l2"], 1e-4)]
        if rank == 0:
            checks.append(("Ulysses pipeline latent vs one rank",
                           single["latent_rel_l2"], 3e-2))
        for what, val, lim in checks:
            log(json.dumps({"check": f"sp rank {rank}: {what}",
                            "rel_l2": val, "limit": lim, "why": SP_WHY,
                            "ok": val < lim}))
            if not val < lim:
                fail(f"sp rank {rank}: {what} rel. L2 {val} >= {lim}")
        if rec["fsdp_dit"]["local_q_shape"] != [1536, 768]:
            fail(f"sp rank {rank}: the DiT's q weight is not sharded on its "
                 f"in dim: {rec['fsdp_dit']['local_q_shape']}")
    lat = u0["latent_shape"]
    if lat != [1, 21, 60, 104, 16]:
        fail(f"sp_main_path: latent shape {lat}")
    return {"sp": {c: sum(got[r]["ulysses"]["launches"][c] for r in got)
                   for c in zero},
            "sp_ring": {c: sum(got[r]["ring"]["launches"][c] for r in got)
                        for c in zero}}


TP = 2               # the tp mesh's ranks, both on the one card
TP_WHY = ("fp32 accuracy on both sides: three bf16 parts a side (~2^-24 a "
          "product), summation order and the approximate exp2")


def check_tp_kernels():
    """The kernels of the tensor-parallel path at its shard shapes, N / tp
    heads a rank (t2v-1.3B's 12 over tp = 2, BAGEL-7B-MoT's 28 query heads
    over 4 kv heads): the fp32 train step's forward with lse and its dq
    and dk/dv pair at q, k, v [2, 32768, 6, 128] (the B = 2 step, kv_len
    32,760, keys past it 50.0) and at the cross shape (512 keys); the bf16
    serving call's self-attention [2, 32768, 6, 128] over 32,760 keys
    (bounded) after kernel A's rope-only mode, whose output must equal the
    plain rotation bit for bit, and its cross-attention [2, 32768, 6, 128]
    over 512 keys; the causal kernel at the LLM's tp prefill, q [1, 2048,
    14, 128] over a [1, 2048, 2, 128] cache (group 7). Each against its
    plain version, timed with CUDA events beside the plain version and
    SDPA on the same inputs (fp32 SDPA with TF32 off; its backward alone
    for the pair). Returns the kernels-line records."""
    import torch
    import torch.nn.functional as F

    from univid_tpu_torch.kernels import flash_attention as fa
    from univid_tpu_torch.ops.rope import build_rope_3d

    gen = torch.Generator(device="cuda").manual_seed(21)
    b, l, n, d, lk = 2, 32768, 12 // TP, 128, 512
    kv_real = 21 * 30 * 52
    sc = 1.0 / math.sqrt(d)
    fwd_tol = dict(atol=1e-5, rtol=1e-4, why=TP_WHY)
    lse_tol = dict(atol=1e-4, rtol=0.0,
                   why="fp32 log2 of an fp32 row sum; summation order and "
                       "the approximate exp2")
    recs = {}

    # ---- the fp32 train step: forward with lse, dq and dk/dv ------------
    for shape, keys, real in (("self", l, kv_real), ("cross", lk, None)):
        q = qk_normed((b, l, n, d), gen, torch.float32)
        k = qk_normed((b, keys, n, d), gen, torch.float32)
        v = torch.randn((b, keys, n, d), generator=gen, device="cuda")
        do = torch.randn((b, l, n, d), generator=gen, device="cuda")
        kv_len = None
        if real is not None:
            kv_len = torch.full((b,), real, dtype=torch.int32, device="cuda")
            k[:, real:] = 50.0
            v[:, real:] = 50.0
        live = real or keys
        qs = fa._fold(q, sc)
        with torch.no_grad():
            o, lse = fa.flash_attention_fwd_folded(qs, k, v, kv_len=kv_len)
            o_p, lse_p = fa.attention_plain(qs, k, v, kv_len=kv_len,
                                            save_residuals=True)
            err_f = max(compare(f"flash_attention_f32_sm90_lse tp=2 {shape} "
                                "output", o, o_p, **fwd_tol),
                        compare(f"flash_attention_f32_sm90_lse tp=2 {shape} "
                                "lse", lse, lse_p, **lse_tol))
            del o, lse
            want = fa._bwd_plain_folded(qs, k, v, o_p, lse_p, do, kv_len, sc)
            got = fa.flash_attention_bwd_folded(qs, k, v, o_p, lse_p, do,
                                                kv_len=kv_len,
                                                softmax_scale=sc)
            err_dq = _bwd_check(f"flash_attention_bwd_f32_sm90 tp=2 {shape} "
                                "dq", got[0], want[0])
            err_dkv = max(_bwd_check(f"flash_attention_bwd_f32_sm90 tp=2 "
                                     f"{shape} {nm}", g, w)
                          for nm, g, w in zip(("dk", "dv"), got[1:],
                                              want[1:]))
            del got, want
            fwd_ms = cuda_time(lambda: fa.flash_attention_fwd_folded(
                qs, k, v, kv_len=kv_len), 2)
            bwd_ms = cuda_time(lambda: fa.flash_attention_bwd_folded(
                qs, k, v, o_p, lse_p, do, kv_len=kv_len, softmax_scale=sc),
                1)
            parts = [fa.split_bf16x3(x) for x in (qs, k, v, do)]
            _, delta = fa._bwd_dq_f32_sm90_parts(*parts, o_p, do, lse_p,
                                                 kv_len, sc)
            dq_ms = cuda_time(lambda: fa._bwd_dq_f32_sm90_parts(
                *parts, o_p, do, lse_p, kv_len, sc), 1)
            dkv_ms = cuda_time(lambda: fa._bwd_dkv_f32_sm90_parts(
                *parts, lse_p, delta, kv_len), 1)
            del parts, delta
            plain_fwd = cuda_time(lambda: fa.attention_plain(
                qs, k, v, kv_len=kv_len, save_residuals=True), 1, warmup=0)
            plain_bwd = cuda_time(lambda: fa._bwd_plain_folded(
                qs, k, v, o_p, lse_p, do, kv_len, sc), 1, warmup=0)
            qg, kg, vg = (x.transpose(1, 2)[:, :, :m] for x, m in
                          ((qs, l), (k, live), (v, live)))
            lib_fwd = cuda_time(lambda: F.scaled_dot_product_attention(
                qg, kg, vg, scale=1.0 / fa.LOG2E), 2)
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (qg, kg, vg))
        ref_out = F.scaled_dot_product_attention(qg, kg, vg,
                                                 scale=1.0 / fa.LOG2E)
        lib_bwd = cuda_time(lambda: torch.autograd.grad(
            ref_out, (qg, kg, vg), do.transpose(1, 2), retain_graph=True), 1)
        del ref_out, qg, kg, vg
        mm = 2.0 * b * n * l * live * d
        row, kvb, lseb = nbytes(qs), nbytes(k, v), b * n * l * 4
        sfx = "_tp" if shape == "self" else "_tp_cross"
        where = f"tp=2 {shape} [2, 32768, 6, 128]" + (
            " over 512 keys" if shape == "cross" else " over 32,760 keys")
        for name, rep, ms, plain_ms, lib_ms, products, nb, extra in (
                ("flash_attention_f32_sm90_lse",
                 "univid_tpu/kernels/flash_attention.py:343", fwd_ms,
                 plain_fwd, lib_fwd, 2, 2 * row + kvb + lseb, {}),
                ("flash_attention_bwd_dq_f32_sm90",
                 "univid_tpu/kernels/flash_attention.py:831", dq_ms,
                 plain_bwd, lib_bwd, 3, 4 * row + kvb + 2 * lseb,
                 {"pair_call_ms": bwd_ms}),
                ("flash_attention_bwd_dkv_f32_sm90",
                 "univid_tpu/kernels/flash_attention.py:940", dkv_ms,
                 plain_bwd, lib_bwd, 4, 2 * row + 2 * kvb + 2 * lseb,
                 {"pair_call_ms": bwd_ms})):
            bms, by = bound_ms(F32_SPLIT * products * mm, nb,
                               H100_BF16_FLOPS)
            err = {"flash_attention_f32_sm90_lse": err_f,
                   "flash_attention_bwd_dq_f32_sm90": err_dq}.get(name,
                                                                  err_dkv)
            recs[name + sfx] = dict(
                name=name + sfx, counter=name, route="cuda",
                source=F32_SM90_SRC, replaces=rep, shape=where,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms, **extra)
        del q, k, v, do, qs, o_p, lse_p
        torch.cuda.empty_cache()

    # ---- the bf16 serving call: self after kernel A's rope, cross --------
    src = "univid_tpu_torch/kernels/csrc/flash_attention_sm90.cu"
    bsc = fa.LOG2E * sc
    bound = torch.tensor([1.01 * d * bsc], device="cuda")
    with torch.no_grad():
        q = qk_normed((b, l, n, d), gen, torch.bfloat16)
        k = qk_normed((b, l, n, d), gen, torch.bfloat16)
        v = torch.randn((b, l, n, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        k[:, kv_real:] = 50.0
        v[:, kv_real:] = 50.0
        cos, sin = build_rope_3d(d, (21, 30, 52), device="cuda")
        tabs = fa._pad_tables(fa.build_fused_rope_tables(cos, sin, d), l, l,
                              bsc)
        kv_len = torch.full((b,), kv_real, dtype=torch.int32, device="cuda")
        qr, kr = fa.qk_norm_rope(q, k, rope_tables=tabs)
        pq, pk = fa.qk_norm_rope_plain(q, k, None, tabs)
        equal = [bool(torch.equal(qr, pq)), bool(torch.equal(kr, pk))]
        log(json.dumps({"check": "qk_rope_bf16 tp=2 rope only "
                                 "[2, 32768, 6, 128] (q, k)", "equal": equal,
                        "why": "the same fp32 products and sum, one "
                               "rounding to bf16", "ok": all(equal)}))
        if not all(equal):
            fail("qk_rope_bf16: rope only is not bit-equal at the tp shape")
        ms_r = cuda_time(lambda: fa.qk_norm_rope(q, k, rope_tables=tabs), 5)
        plain_r = cuda_time(lambda: fa.qk_norm_rope_plain(q, k, None, tabs),
                            2)
        bms, by = bound_ms(0, nbytes(q, k, qr, kr, *tabs), H100_BF16_FLOPS)
        recs["qk_rope_bf16_tp"] = dict(
            name="qk_rope_bf16_tp", counter="qk_rope_bf16", route="cuda",
            source="univid_tpu_torch/kernels/csrc/qk_prepass.cu",
            replaces="univid_tpu/kernels/flash_attention.py:157",
            shape="rope only, q and k [2, 32768, 6, 128] (after the tp norm)",
            max_abs_err=0.0, ms=ms_r, plain_ms=plain_r, bound_ms=bms,
            bound_by=by, library_ms=None)
        del pq, pk
        got = fa._flash_cuda(qr, kr, v, kv_len, bound, None)
        want = fa.attention_plain(qr, kr, v, kv_len=kv_len, bound=bound)
        err = compare("flash_attention_bf16 tp=2 [2, 32768, 6, 128] "
                      "bounded+kv_len", got, want, **_sp_tol())
        ms = cuda_time(lambda: fa._flash_cuda(qr, kr, v, kv_len, bound,
                                              None), 3)
        plain_ms = cuda_time(lambda: fa.attention_plain(
            qr, kr, v, kv_len=kv_len, bound=bound), 1)
        qs_, ks_, vs_ = (x.transpose(1, 2) for x in (qr, kr, v))
        lib_ms = cuda_time(lambda: F.scaled_dot_product_attention(
            qs_, ks_[:, :, :kv_real], vs_[:, :, :kv_real],
            scale=1.0 / fa.LOG2E), 3)
        bms, by = bound_ms(4 * b * n * l * kv_real * d,
                           nbytes(qr, kr, v, got), H100_BF16_FLOPS)
        recs["flash_attention_bf16_tp"] = dict(
            name="flash_attention_bf16_tp", counter="flash_attention_bf16",
            route="cuda", source=src,
            replaces="univid_tpu/kernels/flash_attention.py:44",
            shape="tp=2 [2, 32768, 6, 128] over 32,760 keys",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=by, library_ms=lib_ms)
        del k, v, got, want, qs_, ks_, vs_, kr, q
        qx = qr * torch.tensor(bsc, dtype=torch.bfloat16, device="cuda")
        k = qk_normed((b, lk, n, d), gen, torch.bfloat16)
        v = torch.randn((b, lk, n, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        got = fa.cross_attention_padded(qx, k, v, score_bound=bound)
        err = compare("cross_attention_bf16 tp=2 [2, 32768, 6, 128] x 512 "
                      "bounded", got, fa.attention_plain(qx, k, v,
                                                         bound=bound),
                      **_sp_tol())
        ms = cuda_time(lambda: fa.cross_attention_padded(
            qx, k, v, score_bound=bound), 5)
        plain_ms = cuda_time(lambda: fa.attention_plain(qx, k, v,
                                                        bound=bound), 1)
        qt, kt, vt = (x.transpose(1, 2) for x in (qx, k, v))
        lib_ms = cuda_time(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, scale=1.0 / fa.LOG2E), 5)
        bms, by = bound_ms(4 * b * n * l * lk * d, nbytes(qx, k, v, got),
                           H100_BF16_FLOPS)
        recs["cross_attention_bf16_tp"] = dict(
            name="cross_attention_bf16_tp", counter="cross_attention_bf16",
            route="cuda", source=src,
            replaces="univid_tpu/kernels/flash_attention.py:355",
            shape="tp=2 [2, 32768, 6, 128] over [2, 512, 6, 128]",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=by, library_ms=lib_ms)
        del qr, qx, k, v, got, qt, kt, vt
    torch.cuda.empty_cache()

    # ---- the causal kernel at the LLM's tp prefill: group 7 kept --------
    nq, nk, lq = 28 // TP, 4 // TP, TP_QWEN_TOKENS
    q, k, v, qo, kv = _causal_case(gen, 1, lq, lq, nq, nk, [0], lq, False)
    with torch.no_grad():
        got = fa._flash_cuda(q, k, v, kv, None, None, causal=True,
                             q_offsets=qo)
        want = fa.attention_plain(q, k, v, kv_len=kv, causal=True,
                                  q_offsets=qo)
        err = compare("flash_attention_bf16_causal tp=2 [1, 2048, 14, 128] "
                      "over 2 kv heads", got, want, **_sp_tol())
        ms = cuda_time(lambda: fa._flash_cuda(q, k, v, kv, None, None,
                                              causal=True, q_offsets=qo), 10)
        plain_ms = cuda_time(lambda: fa.attention_plain(
            q, k, v, kv_len=kv, causal=True, q_offsets=qo), 1)
        qs_, ks_, vs_ = (x.transpose(1, 2) for x in (
            q, fa.repeat_kv(k, nq), fa.repeat_kv(v, nq)))
        lib_ms = cuda_time(lambda: F.scaled_dot_product_attention(
            qs_, ks_, vs_, is_causal=True, scale=1.0 / fa.LOG2E), 5)
    bms, by = bound_ms(_causal_work(lq, [0], [lq], nq),
                       nbytes(q, got) + lq * nk * d * 2 * 2, H100_BF16_FLOPS)
    recs["flash_attention_bf16_causal_tp"] = dict(
        name="flash_attention_bf16_causal_tp",
        counter="flash_attention_bf16_causal", route="cuda",
        source="univid_tpu_torch/kernels/csrc/flash_attention_causal_sm90.cu",
        replaces="univid_tpu/kernels/flash_attention.py:44",
        shape="tp=2 prefill q [1, 2048, 14, 128] over [1, 2048, 2, 128]",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        library_ms=lib_ms, splits=fa.causal_splits(1, nq, nq // nk, lq, lq))
    del q, k, v, got, want, qs_, ks_, vs_
    torch.cuda.empty_cache()
    for r in recs.values():
        log(json.dumps({"kernel": r}))
    return recs


# depth cuts for the time limit: at 4 training and 6 serving blocks the
# phase took 105.5 s (its tp = 2 step 29.6 s, 83% in gloo's host copies of
# the 400 MB activations) and the script 1,054.6 s of its 1,200; at 2 and
# 4, 67.4 s; one serving block a rank pays for the fp32 knob phases
TP_TRAIN_LAYERS = 1  # of t2v-1.3B's 30 blocks in the three sharded steps
#                      and their one-rank reference
TP_LAYERS = 1        # of t2v-1.3B's 30 blocks in the bf16 serving call
TP_T5_LAYERS = 2     # of UMT5-XXL's 24 blocks (full width, fp32)
TP_QWEN_LAYERS = 2   # of BAGEL-7B-MoT's 28 LLM layers (full width, bf16)
TP_QWEN_TOKENS = 2048   # the prefill's rows (the largest text bucket)
TP_FRAMES = 64       # frames the dp = 2 scorer embeds
TP_DEADLINE = 480    # s the ranks may take together, start-up included
TP_TRAIN_LR = 1e-4
TP_TRAIN_WHY = ("fp32 throughout; the sharded step sums its gradients in "
                "another order (the batch split over ranks, the tp partial "
                "products summed by all-reduce) and Adam's step is about "
                "lr * sign(g), so an element whose gradient is at that "
                "order's rounding noise can move the other way")


def _tp_train_model(cfg, seed):
    """The fp32 t2v-1.3B DiT (cfg's depth) drawn on the card from `seed`,
    the zero head redrawn so that gradients reach every block."""
    import torch

    from univid_tpu_torch.models.wan.dit import WanDiT

    g = torch.Generator(device="cuda").manual_seed(seed)
    dit = WanDiT(cfg, dtype=torch.float32, device="cuda", gen=g)
    with torch.no_grad():
        dit.head.head.w.normal_(0.0, 0.02, generator=g)
    return dit


def _tp_rank_work(rank, init, note):
    """One rank of tp_main_path. Returns its records (numbers only);
    note(msg) logs its progress."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from univid_tpu_torch.core.config import WAN_CONFIGS, latent_shape
    from univid_tpu_torch.core.mesh import MeshSpec, make_mesh
    from univid_tpu_torch.kernels import flash_attention as fa
    from univid_tpu_torch.models.bagel import qwen2_mot as tq
    from univid_tpu_torch.models.wan.dit import WanDiT, wan_dit_forward
    from univid_tpu_torch.models.wan.t5 import UMT5Encoder, encode_padded
    from univid_tpu_torch.ops.rope import build_rope_3d
    from univid_tpu_torch.parallel import sharding
    from univid_tpu_torch.pipelines.ti2v import padded_seq_len
    from univid_tpu_torch.reflection.scorer import Siglip2Scorer
    from univid_tpu_torch.train import trainer

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=TP)
    note("group up")
    out = {"rank": rank}
    comm = {"s": 0.0, "calls": 0}

    def timed(fn):   # a collective, synchronised on both sides
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            comm["s"] += time.perf_counter() - t0
            comm["calls"] += 1
            return res
        return call

    for nm in ("all_reduce", "all_gather", "all_gather_into_tensor",
               "reduce_scatter_tensor"):
        setattr(dist, nm, timed(getattr(dist, nm)))

    def start(together=True):
        # together: both ranks run the call (rank 0's one-rank references
        # run alone, while rank 1 waits in its next collective)
        torch.cuda.synchronize()
        if together:
            dist.barrier()
        fa.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        comm.update(s=0.0, calls=0)
        return time.perf_counter()

    def stop(t0):
        torch.cuda.synchronize()
        return dict(seconds=time.perf_counter() - t0,
                    collectives_s=comm["s"], collective_calls=comm["calls"],
                    peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                    launches={k: v for k, v in launch_counts().items() if v},
                    by_impl=dict(fa.LAUNCHES_BY_IMPL))

    # ---- (a) the fp32 train step on fsdp / dp / tp, against one rank ----
    spec = WAN_CONFIGS["t2v-1.3B"]
    cfg = dataclasses.replace(spec.dit, num_layers=TP_TRAIN_LAYERS)
    _, f, lh, lw = latent_shape(spec, 832, 480, 81)
    grid = (f, lh // 2, lw // 2)
    pad_to = -(-grid[0] * grid[1] * grid[2] // 64) * 64
    rope = build_rope_3d(cfg.head_dim, grid, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(62)
    c = spec.vae.z_dim
    batch = {"latents": torch.randn((2, f, lh, lw, c), generator=g,
                                    device="cuda"),
             "noise": torch.randn((2, f, lh, lw, c), generator=g,
                                  device="cuda"),
             "context": torch.randn((2, cfg.text_len, cfg.text_dim),
                                    generator=g, device="cuda"),
             "t": torch.tensor([500.0, 700.0], device="cuda")}

    def one_step(mesh):
        dit = _tp_train_model(cfg, 60)
        if mesh is not None:
            sharding.shard_params(dit, mesh,
                                  sharding.dit_param_sharding_rules())
        state, tx = trainer.init_train_state(
            dit, trainer.make_optimizer(TP_TRAIN_LR))
        step = trainer.make_dit_train_step(cfg, tx, mesh=mesh, rope=rope,
                                           remat_blocks="attn",
                                           seq_pad_to=pad_to)
        note(f"train step on {mesh}: start")
        t0 = start(together=mesh is not None)
        with torch.enable_grad():
            state, loss = step(state, batch)
        rec = dict(stop(t0), loss=float(loss))
        note(f"train step on {mesh}: {rec['seconds']:.2f} s")
        after = {nm: sharding.full_tensor(p).detach().cpu()
                 for nm, p in dit.named_parameters()}
        del state, step, dit
        torch.cuda.empty_cache()
        return rec, after

    train = {}
    if rank == 0:
        start0 = _tp_train_model(cfg, 60)
        p0 = {nm: p.detach().cpu() for nm, p in start0.named_parameters()}
        del start0
        train["one_rank"], ref = one_step(None)
    for axes in (dict(fsdp=TP), dict(dp=TP), dict(tp=TP)):
        tag = "_".join(f"{k}{v}" for k, v in axes.items())
        rec, after = one_step(make_mesh(MeshSpec(**axes)))
        if rank == 0:
            num = sum(float((after[nm].double() - ref[nm].double())
                            .square().sum()) for nm in ref)
            den = sum(float(ref[nm].double().square().sum()) for nm in ref)
            dnum = sum(float((after[nm].double() - ref[nm].double())
                             .square().sum()) for nm in ref)
            dden = sum(float((ref[nm].double() - p0[nm].double())
                             .square().sum()) for nm in ref)
            rec.update(loss_rel=abs(rec["loss"] - train["one_rank"]["loss"])
                       / abs(train["one_rank"]["loss"]),
                       params_rel_l2=(num / den) ** 0.5,
                       update_rel_l2=(dnum / dden) ** 0.5,
                       moved=sum(not torch.equal(after[nm], p0[nm])
                                 for nm in p0), tensors=len(p0))
        train[tag] = rec
        del after
    out["train"] = train
    del batch
    if rank == 0:
        del ref, p0
    torch.cuda.empty_cache()
    mesh = make_mesh(MeshSpec(tp=TP))

    # ---- (b) a bf16 serving DiT call at tp = 2 --------------------------
    cfg = dataclasses.replace(spec.dit, num_layers=TP_LAYERS)
    g = torch.Generator(device="cuda").manual_seed(0)
    dit = WanDiT(cfg, dtype=torch.bfloat16, device="cuda", gen=g)
    with torch.no_grad():
        dit.head.head.w.copy_(torch.randn(dit.head.head.w.shape, generator=g,
                                          device="cuda") * 0.02)
    x = torch.randn((2, f, lh, lw, cfg.in_dim), generator=g, device="cuda")
    t = torch.tensor([700.0, 700.0], device="cuda")
    ctx = torch.randn((2, cfg.text_len, cfg.text_dim), generator=g,
                      device="cuda") * 0.5
    seq = padded_seq_len(spec, (832, 480), 81)
    kw = dict(seq_pad_to=seq, fused_rope=True)
    one = wan_dit_forward(dit, x, t, ctx, *rope, **kw) if rank == 0 else None
    sharding.shard_params(dit, mesh, sharding.dit_param_sharding_rules())
    local_q = list(dit.blocks[0].self_attn.q.w.to_local().shape)
    t0 = start()
    o_tp = wan_dit_forward(dit, x, t, ctx, *rope, **kw)
    out["dit"] = dict(stop(t0), local_q_shape=local_q,
                      finite=bool(torch.isfinite(o_tp).all()))
    note("tp DiT call")
    if rank == 0:
        out["dit"]["rel_l2"] = rel_l2(o_tp, one)
    del dit, o_tp, one, x
    torch.cuda.empty_cache()

    # ---- (c) UMT5-XXL encode_padded at tp = 2 ---------------------------
    t5cfg = dataclasses.replace(spec.t5, num_layers=TP_T5_LAYERS)
    t5 = UMT5Encoder(t5cfg, dtype=torch.float32, device="cuda",
                     gen=torch.Generator(device="cuda").manual_seed(2))
    ids = torch.randint(0, t5cfg.vocab_size, (2, t5cfg.text_len),
                        generator=g, device="cuda")
    lens = torch.tensor([120, t5cfg.text_len], device="cuda")
    ref = (encode_padded(t5, ids, lens, compute_dtype=torch.float32)
           if rank == 0 else None)
    sharding.shard_params(t5, mesh, sharding.t5_param_sharding_rules())
    t0 = start()
    got = encode_padded(t5, ids, lens, compute_dtype=torch.float32)
    out["t5"] = stop(t0)
    note("tp UMT5")
    if rank == 0:
        out["t5"]["rel_l2"] = rel_l2(got, ref)
    del t5, got, ref
    torch.cuda.empty_cache()

    # ---- (d) BAGEL-7B-MoT's LLM: a prefill at tp = 2 --------------------
    qcfg = dataclasses.replace(tq.Qwen2MoTConfig(), num_layers=TP_QWEN_LAYERS)
    llm = tq.init_qwen2_mot(torch.Generator(device="cuda").manual_seed(3),
                            qcfg, dtype=torch.bfloat16, device="cuda")
    xq = (torch.randn((1, TP_QWEN_TOKENS, qcfg.hidden_size), generator=g,
                      device="cuda") * 0.5).to(torch.bfloat16)
    pos = torch.arange(TP_QWEN_TOKENS, device="cuda")[None]

    def prefill(tp):
        cache = tq.init_kv_cache(qcfg, TP_QWEN_TOKENS, device="cuda", tp=tp)
        return tq.qwen2_mot_forward(llm, qcfg, xq, pos, cache)[0]

    ref = prefill(1) if rank == 0 else None
    sharding.shard_params(llm, mesh, sharding.bagel_llm_param_sharding_rules())
    t0 = start()
    got = prefill(TP)
    out["qwen"] = stop(t0)
    note("tp LLM prefill")
    if rank == 0:
        out["qwen"]["rel_l2"] = rel_l2(got, ref)
    del llm, got, ref, xq
    torch.cuda.empty_cache()

    # ---- (e) Siglip2Scorer.emb_imgs at dp = 2 ---------------------------
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (360, 640, 3), dtype=np.uint8)
              for _ in range(TP_FRAMES)]
    ref = Siglip2Scorer(seed=0).emb_imgs(frames) if rank == 0 else None
    scorer = Siglip2Scorer(seed=0, mesh=make_mesh(MeshSpec(dp=TP)))
    t0 = start()
    got = scorer.emb_imgs(frames)
    out["scorer"] = dict(stop(t0), shape=list(got.shape))
    if rank == 0:
        out["scorer"]["rel_l2"] = float(np.linalg.norm(got - ref)
                                        / np.linalg.norm(ref))
    dist.barrier()
    dist.destroy_process_group()
    return out


def tp_main_path(output_dir):
    """Phase 14: sharded training and tensor parallelism, two ranks on the
    one card over gloo (as sp_main_path), full width, the same seeded
    weights on each rank: (a) make_dit_train_step on MeshSpec(fsdp=2),
    MeshSpec(dp=2) and MeshSpec(tp=2), each one step of the fp32 t2v-1.3B
    fine-tune at TP_TRAIN_LAYERS blocks, B = 2 at 832x480x81 (32,760 tokens
    padded to 32,768), remat 'attn', held to the one-rank step of the same
    model and batch (rank 0, first): the loss, the parameters after the
    update and the update itself by relative L2; (b) one bf16 serving
    wan_dit_forward at tp = 2 (TP_LAYERS blocks, batch-2 CFG, the fused
    rope); (c) UMT5-XXL encode_padded at tp = 2 (fp32, TP_T5_LAYERS
    blocks); (d) a BAGEL-7B-MoT qwen2_mot_forward prefill of
    TP_QWEN_TOKENS rows at tp = 2 (bf16, TP_QWEN_LAYERS layers, a cache of
    the rank's 2 kv heads); (e) Siglip2Scorer.emb_imgs on TP_FRAMES frames
    at dp = 2. (b)-(e) held to the unsharded call (rank 0, before). Records
    seconds against the one rank, the collectives' share (each collective
    synchronised on both sides: a cost of gloo on one card, not a figure
    for NVLink), peak memory per rank, and each rank's launches, counted
    from zero just before each call. Returns {path: launches} summed over
    the ranks."""
    got, wall, tails = _run_ranks("tp", _tp_rank_work, TP, TP_DEADLINE,
                                  output_dir)
    log(json.dumps({"tp_rank_logs": tails}))

    nt, n = TP_TRAIN_LAYERS, TP_LAYERS
    # one fp32 step, remat 'attn': as fp32_train_main_path's, a rank's
    # every block at its shard shape
    want_train = {"flash_attention_f32_sm90_lse": 3 * nt,
                  "flash_attention_bwd_dq_f32_sm90": 2 * nt,
                  "flash_attention_bwd_dkv_f32_sm90": 2 * nt,
                  "split_bf16x3": 17 * nt}
    # the tp DiT call: the norm in the block (over the tp group), kernel
    # A's rope-only mode, self- and cross-attention at 6 heads
    want_dit = {"flash_attention_bf16": n, "cross_attention_bf16": n,
                "qk_rope_bf16": n}
    want_qwen = {"flash_attention_bf16_causal": TP_QWEN_LAYERS}
    r0 = got[0]
    log(json.dumps({
        "phase": "tp_main_path", "model": "t2v-1.3B (train "
        f"{nt}, serve {n} of 30 blocks), UMT5-XXL ({TP_T5_LAYERS} of 24), "
        f"BAGEL-7B-MoT LLM ({TP_QWEN_LAYERS} of 28), SigLIP2-base scorer, "
        "full width", "resolution": "832x480x81", "ranks_on_one_card": TP,
        "seconds": wall, "ranks": got,
        "train_step_s": {k: v["seconds"] for k, v in r0["train"].items()},
        "collective_share": {
            k: v["collectives_s"] / v["seconds"]
            for k, v in r0["train"].items() if k != "one_rank"},
        "expected_launches_per_rank": {"train": want_train, "dit": want_dit,
                                       "qwen": want_qwen}}))
    checks = []
    for rank, rec in got.items():
        for tag, v in rec["train"].items():
            if v["launches"] != want_train:
                fail(f"tp rank {rank}: {tag} train step launches "
                     f"{v['launches']} != {want_train}")
            if not math.isfinite(v["loss"]):
                fail(f"tp rank {rank}: {tag} non-finite loss")
        if rec["dit"]["launches"] != want_dit or \
                rec["dit"]["by_impl"]["sm90"] != 2 * n:
            fail(f"tp rank {rank}: DiT call launches {rec['dit']['launches']}"
                 f" {rec['dit']['by_impl']} != {want_dit}")
        if rec["qwen"]["launches"] != want_qwen:
            fail(f"tp rank {rank}: prefill launches {rec['qwen']['launches']}"
                 f" != {want_qwen}")
        for tag in ("t5", "scorer"):   # head dim 64: the reference route
            if rec[tag]["launches"]:
                fail(f"tp rank {rank}: {tag} launched {rec[tag]['launches']}")
        if rec["dit"]["local_q_shape"] != [768, 1536] or not rec["dit"][
                "finite"]:
            fail(f"tp rank {rank}: the DiT's q weight is not the rank's 6 "
                 f"heads, or a non-finite output: {rec['dit']}")
        if rec["scorer"]["shape"] != [TP_FRAMES, 1024]:
            fail(f"tp rank {rank}: scorer output {rec['scorer']['shape']}")
    for tag in ("fsdp2", "dp2", "tp2"):
        v = r0["train"][tag]
        if v["moved"] != v["tensors"]:
            fail(f"tp {tag}: {v['tensors'] - v['moved']} tensors did not "
                 "move")
        checks += [(f"{tag} train step loss vs one rank (relative)",
                    v["loss_rel"], 1e-5, TP_TRAIN_WHY),
                   (f"{tag} train step parameters vs one rank",
                    v["params_rel_l2"], 1e-6, TP_TRAIN_WHY),
                   (f"{tag} train step update vs one rank",
                    v["update_rel_l2"], 1e-2, TP_TRAIN_WHY)]
    checks += [("tp DiT call vs one rank", r0["dit"]["rel_l2"], 3e-2,
                "the bf16 policy's bound; the row-parallel sums add bf16 "
                "partial products in fp32"),
               ("tp UMT5-XXL fp32 vs one rank", r0["t5"]["rel_l2"], 1e-4,
                "fp32; the row-parallel sums in another order"),
               ("tp BAGEL LLM prefill vs one rank", r0["qwen"]["rel_l2"],
                3e-2, "bf16; the row-parallel sums add bf16 partial "
                      "products in fp32"),
               ("dp scorer vs one rank", r0["scorer"]["rel_l2"], 1e-2,
                "bf16; the same per-image tower, the projection on a "
                "smaller batch")]
    for what, val, lim, why in checks:
        log(json.dumps({"check": f"tp: {what}", "value": val, "limit": lim,
                        "why": why, "ok": val < lim}))
        if not val < lim:
            fail(f"tp: {what} {val} >= {lim}")

    def total(tag):
        keys = launch_counts()
        return {c: sum(got[r][tag]["launches"].get(c, 0) for r in got)
                for c in keys}

    return {"tp_train": {c: sum(got[r]["train"]["tp2"]["launches"].get(c, 0)
                                for r in got) for c in launch_counts()},
            "tp_dit": total("dit"), "tp_qwen": total("qwen")}


# ---------------------------------------------------------------------------
# sequence and tensor parallelism together, and sequence-parallel training:
# four ranks on the one card
# ---------------------------------------------------------------------------

SP_TP_WORLD = 4      # sp 2 x tp 2 (serving), fsdp 2 x sp 2 (training)
SP_TP_LAYERS = 2     # of t2v-1.3B's 30 blocks in the serving runs
SP_TP_TRAIN_LAYERS = 1   # of 30 in the fp32 train step and its reference
SP_TP_STEPS = 2      # UniPC steps of the sp x tp pipeline run
SP_TP_DEADLINE = 480   # s the ranks may take together, start-up included


def _sp_tp_rank_work(rank, init, note):
    """One rank of sp_tp_main_path. Returns its records (numbers only);
    note(msg) logs its progress."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from univid_tpu_torch.core.config import WAN_CONFIGS, latent_shape
    from univid_tpu_torch.core.mesh import MeshSpec, make_mesh
    from univid_tpu_torch.kernels import flash_attention as fa
    from univid_tpu_torch.models.wan.dit import (WanDiT, wan_dit_forward,
                                                 wan_dit_forward_sp)
    from univid_tpu_torch.ops.rope import build_rope_3d
    from univid_tpu_torch.parallel import sharding, ulysses
    from univid_tpu_torch.pipelines.ti2v import (WanTI2VPipeline, dit_rope,
                                                 padded_seq_len)
    from univid_tpu_torch.train import optim, trainer
    from univid_tpu_torch.utils.profiling import PhaseTimer

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=SP_TP_WORLD)
    note("group up")
    # every mesh before any rank runs alone: a mesh is a collective
    mesh = make_mesh(MeshSpec(sp=2, tp=2))
    mesh_t = make_mesh(MeshSpec(fsdp=2, sp=2))
    out = {"rank": rank}
    comm = {}

    def timed(nm, fn):   # a collective, synchronised on both sides
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            comm[nm] = comm.get(nm, 0.0) + time.perf_counter() - t0
            return res
        return call

    for nm in ("all_to_all_single", "all_reduce", "all_gather",
               "all_gather_into_tensor", "reduce_scatter_tensor"):
        setattr(dist, nm, timed(nm, getattr(dist, nm)))

    def start(together=True):
        # together: every rank runs the call (rank 0's one-rank references
        # run alone, while the others wait in their next collective)
        torch.cuda.synchronize()
        if together:
            dist.barrier()
        fa.reset_launches()
        for k in ulysses.ROUTES:
            ulysses.ROUTES[k] = 0
        torch.cuda.reset_peak_memory_stats()
        comm.clear()
        return time.perf_counter()

    def stop(t0):
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return dict(seconds=secs, collectives_s=dict(comm),
                    collective_share=sum(comm.values()) / secs,
                    peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                    launches={k: v for k, v in launch_counts().items() if v},
                    by_impl=dict(fa.LAUNCHES_BY_IMPL),
                    routes=dict(ulysses.ROUTES))

    spec = WAN_CONFIGS["t2v-1.3B"]
    cfg = dataclasses.replace(spec.dit, num_layers=SP_TP_LAYERS)
    spec = dataclasses.replace(spec, dit=cfg)

    def serving_dit():
        g = torch.Generator(device="cuda").manual_seed(0)
        dit = WanDiT(cfg, dtype=torch.bfloat16, device="cuda", gen=g)
        with torch.no_grad():   # a seeded head: init's zero head gives 0
            dit.head.head.w.copy_(torch.randn(
                dit.head.head.w.shape, generator=g, device="cuda") * 0.02)
        return dit, g

    dit, g = serving_dit()
    ctx, nctx = (torch.randn((cfg.text_len, cfg.text_dim), generator=g,
                             device="cuda") * 0.5 for _ in range(2))
    sharding.shard_params(dit, mesh, sharding.dit_param_sharding_rules())
    local_q = list(dit.blocks[0].self_attn.q.w.to_local().shape)
    kw = dict(SP_SHAPE, sampling_steps=SP_TP_STEPS, seed=0, decode=False)

    # ---- (a) the Ulysses pipeline at sp 2 x tp 2, then one rank alone --
    timer = PhaseTimer()
    t0 = start()
    lat = WanTI2VPipeline(spec, dit, None, sp_size=2, mesh=mesh).generate(
        ctx, nctx, timer=timer, **kw)
    rec = stop(t0)
    rec.update(dit_step_s=timer.totals["dit_step"] / SP_TP_STEPS,
               local_q_shape=local_q, latent_shape=list(lat.shape),
               finite=bool(torch.isfinite(lat).all()))
    out["pipeline"] = rec
    note(f"sp x tp pipeline: {rec['seconds']:.2f} s")
    grid = (21, 60, 104)
    x = torch.randn((2,) + grid + (cfg.in_dim,), generator=g, device="cuda")
    t = torch.tensor([700.0, 700.0], device="cuda")
    ctx2 = torch.stack([ctx, nctx])
    rope = dit_rope(cfg, grid, "cuda")
    seq = padded_seq_len(spec, SP_SHAPE["size"], SP_SHAPE["frame_num"], 2)
    one_dit = one_ring = None
    if rank == 0:
        one_dit = serving_dit()[0]
        timer1 = PhaseTimer()
        t0 = start(together=False)
        one = WanTI2VPipeline(spec, one_dit, None).generate(
            ctx, nctx, timer=timer1, **kw)
        out["single"] = dict(stop(t0),
                             dit_step_s=timer1.totals["dit_step"]
                             / SP_TP_STEPS, latent_rel_l2=rel_l2(lat, one))
        one_ring = wan_dit_forward(one_dit, x, t, ctx2, *rope,
                                   seq_pad_to=seq)
        del one, one_dit
    del lat

    # ---- (b) one ring DiT call at sp 2 x tp 2 ---------------------------
    t0 = start()
    o_ring = wan_dit_forward_sp(dit, x, t, ctx2, *rope, mesh=mesh,
                                sp_impl="ring", seq_pad_to=seq)
    out["ring"] = dict(stop(t0), finite=bool(torch.isfinite(o_ring).all()))
    note(f"sp x tp ring call: {out['ring']['seconds']:.2f} s")
    if rank == 0:
        out["ring"]["rel_l2"] = rel_l2(o_ring, one_ring)
    del dit, o_ring, one_ring, x
    torch.cuda.empty_cache()

    # ---- (c) the fp32 train step on fsdp 2 x sp 2, against one rank -----
    tcfg = dataclasses.replace(cfg, num_layers=SP_TP_TRAIN_LAYERS)
    _, f, lh, lw = latent_shape(spec, 832, 480, 81)
    tgrid = (f, lh // 2, lw // 2)
    pad_to = -(-tgrid[0] * tgrid[1] * tgrid[2] // 64) * 64
    trope = build_rope_3d(tcfg.head_dim, tgrid, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(62)
    c = spec.vae.z_dim
    batch = {"latents": torch.randn((2, f, lh, lw, c), generator=g,
                                    device="cuda"),
             "noise": torch.randn((2, f, lh, lw, c), generator=g,
                                  device="cuda"),
             "context": torch.randn((2, tcfg.text_len, tcfg.text_dim),
                                    generator=g, device="cuda"),
             "t": torch.tensor([500.0, 700.0], device="cuda")}

    def one_step(m):
        model = _tp_train_model(tcfg, 60)
        if m is not None:
            sharding.shard_params(model, m,
                                  sharding.dit_param_sharding_rules())
        state, tx = trainer.init_train_state(
            model, trainer.make_optimizer(TP_TRAIN_LR))
        step = trainer.make_dit_train_step(tcfg, tx, mesh=m, rope=trope,
                                           remat_blocks="attn",
                                           seq_pad_to=pad_to)
        t0 = start(together=m is not None)
        with torch.enable_grad():
            state, loss = step(state, batch)
        rec = dict(stop(t0), loss=float(loss))
        note(f"train step on {m}: {rec['seconds']:.2f} s")
        return model, rec

    if rank == 0:
        p0 = {nm: p.detach().cpu() for nm, p in
              _tp_train_model(tcfg, 60).named_parameters()}
        model, out["train_one_rank"] = one_step(None)
        ref = {nm: p.detach().cpu() for nm, p in model.named_parameters()}
        del model
        torch.cuda.empty_cache()
    model, rec = one_step(mesh_t)
    # the sp replicas: each rank's own shards against its sp peer's
    group = mesh_t["sp"].get_group()
    equal = True
    for p in model.parameters():
        own = optim.local(p).detach().contiguous()
        both = own.new_empty((2,) + tuple(own.shape))
        dist.all_gather_into_tensor(both, own[None], group=group)
        equal = equal and bool(torch.equal(both[0], both[1]))
    rec.update(sp_replicas_bitwise_equal=equal,
               local_q_shape=list(optim.local(
                   model.blocks[0].self_attn.q.w).shape))
    after = {nm: sharding.full_tensor(p).detach().cpu()
             for nm, p in model.named_parameters()}
    if rank == 0:
        one = out["train_one_rank"]

        def sq(a, b=None):   # the squared L2 of a - b over every tensor
            return sum(float((a[nm].double() - (0.0 if b is None else
                                                b[nm].double()))
                             .square().sum()) for nm in ref)
        rec.update(loss_rel=abs(rec["loss"] - one["loss"]) / abs(one["loss"]),
                   params_rel_l2=(sq(after, ref) / sq(ref)) ** 0.5,
                   update_rel_l2=(sq(after, ref) / sq(ref, p0)) ** 0.5,
                   moved=sum(not torch.equal(after[nm], p0[nm]) for nm in p0),
                   tensors=len(p0))
    out["train"] = rec
    del model, after, batch
    dist.barrier()
    dist.destroy_process_group()
    return out


def sp_tp_main_path(output_dir):
    """Phase 15: sequence and tensor parallelism together, and the
    sequence-parallel train step, four ranks on the one card over gloo (as
    sp_main_path and tp_main_path), t2v-1.3B at full width, the same seeded
    weights on each rank: (a) WanTI2VPipeline(sp_size=2) on an sp 2 x tp 2
    mesh, the bf16 DiT (SP_TP_LAYERS blocks) sharded over tp first, for
    SP_TP_STEPS UniPC steps at 832x480x81 (batch-2 CFG, Ulysses with the
    fused rope, 12 / (2 x 2) = 3 heads a rank after the exchange, decode
    False), held to the single-rank pipeline's latent from the same seed
    (rank 0, after); (b) one wan_dit_forward_sp(sp_impl='ring') call on the
    same mesh (6 heads a rank), held to wan_dit_forward; (c) one fp32
    make_dit_train_step step on an fsdp 2 x sp 2 mesh (SP_TP_TRAIN_LAYERS
    blocks, B = 2 at 832x480x81, remat 'attn'), held to the one-rank step
    (rank 0, first) at TP_TRAIN_WHY's bounds, and both sp replicas' shards
    bitwise equal after it. Records seconds against the one rank, the
    collectives' seconds by kind (all-to-alls, the tp all-reduces, the
    gathers; each synchronised on both sides: a cost of gloo on one card,
    not a figure for NVLink) and their share, peak memory and launches a
    rank, each counted from zero just before its call. Returns {path:
    launches} summed over the ranks."""
    got, wall, tails = _run_ranks("sp_tp", _sp_tp_rank_work, SP_TP_WORLD,
                                  SP_TP_DEADLINE, output_dir)
    log(json.dumps({"sp_tp_rank_logs": tails}))
    n, steps, nt = SP_TP_LAYERS, SP_TP_STEPS, SP_TP_TRAIN_LAYERS
    # kernel A's rope-only mode after the exchange (the norm ran over tp
    # in the block), self- and cross-attention at the rank's heads
    want_p = {"flash_attention_bf16": n * steps,
              "cross_attention_bf16": n * steps,
              "qk_rope_bf16": n * steps}
    want_r = {"flash_attention_bf16_lse": 2 * n, "cross_attention_bf16": n}
    want_t = {"flash_attention_f32_sm90_lse": 3 * nt,
              "flash_attention_bwd_dq_f32_sm90": 2 * nt,
              "flash_attention_bwd_dkv_f32_sm90": 2 * nt,
              "split_bf16x3": 17 * nt}
    r0 = got[0]
    log(json.dumps({
        "phase": "sp_tp_main_path", "model": f"t2v-1.3B (serve {n}, train "
        f"{nt} of 30 blocks, full width)", "resolution": "832x480x81",
        "ranks_on_one_card": SP_TP_WORLD, "seconds": wall, "ranks": got,
        "dit_step_s_sp2_tp2": r0["pipeline"]["dit_step_s"],
        "dit_step_s_single": r0["single"]["dit_step_s"],
        "train_step_s_fsdp2_sp2": r0["train"]["seconds"],
        "train_step_s_single": r0["train_one_rank"]["seconds"],
        "expected_launches_per_rank": {"pipeline": want_p, "ring": want_r,
                                       "train": want_t}}))
    for rank, rec in got.items():
        p, r, t = rec["pipeline"], rec["ring"], rec["train"]
        for what, v, want, impl in (
                ("pipeline", p, want_p, 2 * n * steps),
                ("ring", r, want_r, 3 * n), ("train", t, want_t, None)):
            if v["launches"] != want or (
                    impl is not None and v["by_impl"] != {
                        "sm90": impl, "causal_sm90": 0, "mma_sync": 0}):
                fail(f"sp_tp rank {rank}: {what} launches {v['launches']} "
                     f"{v['by_impl']} != {want} (sm90 {impl})")
        if p["routes"] != {"heads": n * steps, "gather": 0}:
            fail(f"sp_tp rank {rank}: Ulysses routes {p['routes']}")
        if not (p["finite"] and r["finite"] and math.isfinite(t["loss"])):
            fail(f"sp_tp rank {rank}: a non-finite output")
        if p["local_q_shape"] != [768, 1536] or p["latent_shape"] != [
                1, 21, 60, 104, 16]:
            fail(f"sp_tp rank {rank}: q weight {p['local_q_shape']} (the "
                 f"rank's 6 heads) or latent {p['latent_shape']}")
        if t["local_q_shape"] != [1536, 768]:
            fail(f"sp_tp rank {rank}: the train step's q weight is not "
                 f"sharded on its in dim: {t['local_q_shape']}")
        if not t["sp_replicas_bitwise_equal"]:
            fail(f"sp_tp rank {rank}: the sp replicas' parameters differ "
                 "after the step")
    t0 = r0["train"]
    if t0["moved"] != t0["tensors"]:
        fail(f"sp_tp train: {t0['tensors'] - t0['moved']} tensors did not "
             "move")
    checks = [("sp 2 x tp 2 Ulysses pipeline latent vs one rank",
               r0["single"]["latent_rel_l2"], 3e-2, SP_WHY),
              ("sp 2 x tp 2 ring DiT call vs wan_dit_forward",
               r0["ring"]["rel_l2"], 3e-2, SP_WHY),
              ("fsdp 2 x sp 2 train step loss vs one rank (relative)",
               t0["loss_rel"], 1e-5, TP_TRAIN_WHY),
              ("fsdp 2 x sp 2 train step parameters vs one rank",
               t0["params_rel_l2"], 1e-6, TP_TRAIN_WHY),
              ("fsdp 2 x sp 2 train step update vs one rank",
               t0["update_rel_l2"], 1e-2, TP_TRAIN_WHY)]
    for what, val, lim, why in checks:
        log(json.dumps({"check": f"sp_tp: {what}", "value": val,
                        "limit": lim, "why": why, "ok": val < lim}))
        if not val < lim:
            fail(f"sp_tp: {what} {val} >= {lim}")

    def total(tag):
        return {c: sum(got[r][tag]["launches"].get(c, 0) for r in got)
                for c in launch_counts()}

    return {"sp_tp": total("pipeline"), "sp_tp_ring": total("ring"),
            "sp_tp_train": total("train")}


# ---------------------------------------------------------------------------
# the animate preprocess (the twenty-fifth slice): the ONNX detectors on
# torch, the SAM2.1 Hiera-L video segmenter, cli/preprocess_animate.py
# ---------------------------------------------------------------------------

PREP_FRAMES = 16        # the drive video's frames: a cut of a clip (the
                        # reference chunks 400); 16 keeps the 400-frame
                        # chunk's 4 key frames (0, 4, 8, 12) and 12
                        # propagated frames, so the 6-slot ring wraps
PREP_POSE_BLOCKS = 4    # of ViTPose-H's 32 blocks in the written graph
PREP_SIZE = (720, 1280)  # the drive video, at the CLI's default area
PREP_SEED = 191         # the .pt's and the graph's draws
PREP_DEADLINE = 600     # s the CLI's subprocess may take
SAM2_KEYS_FULL = 8 * 4096 + 6 * 4096 + (8 + 15) * 4   # 57,436 memory keys


# a minimal ONNX protobuf writer (no `onnx` package): ModelProto.graph with
# nodes, initializers and typed inputs / outputs, the fields the port's
# parser reads

def _pb_uvarint(v):
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _pb_varint(v):   # int64: negatives as two's complement
    return _pb_uvarint(v & ((1 << 64) - 1))


def _pb_tag(fn, wt):
    return _pb_uvarint((fn << 3) | wt)


def _pb_ld(fn, payload):
    return _pb_tag(fn, 2) + _pb_uvarint(len(payload)) + payload


_ONNX_DTYPE = {"float32": 1, "uint8": 2, "int32": 6, "int64": 7, "bool": 9,
               "float64": 11}


def onnx_tensor(name, arr):
    """TensorProto: dims, data_type, name, raw_data (a 0-d array is
    written as [1])."""
    import numpy as np

    arr = np.ascontiguousarray(arr)
    out = b"".join(_pb_tag(1, 0) + _pb_varint(d) for d in arr.shape)
    out += _pb_tag(2, 0) + _pb_uvarint(_ONNX_DTYPE[arr.dtype.name])
    return out + _pb_ld(8, name.encode()) + _pb_ld(9, arr.tobytes())


def onnx_attr(name, value):
    import struct

    import numpy as np

    out = _pb_ld(1, name.encode())
    if isinstance(value, float):
        return out + _pb_tag(2, 5) + struct.pack("<f", value)
    if isinstance(value, (bool, int)):
        return out + _pb_tag(3, 0) + _pb_varint(int(value))
    if isinstance(value, bytes):
        return out + _pb_ld(4, value)
    if isinstance(value, np.ndarray):
        return out + _pb_ld(5, onnx_tensor("", value))
    if all(isinstance(v, int) for v in value):
        return out + _pb_ld(8, b"".join(_pb_varint(v) for v in value))
    return out + _pb_ld(7, struct.pack(f"<{len(value)}f", *value))


def onnx_node(op, inputs, outputs, **attrs):
    out = b"".join(_pb_ld(1, n.encode()) for n in inputs)
    out += b"".join(_pb_ld(2, n.encode()) for n in outputs)
    out += _pb_ld(4, op.encode())
    return out + b"".join(_pb_ld(5, onnx_attr(k, v))
                          for k, v in attrs.items())


def _onnx_value_info(name, shape):
    dims = b"".join(_pb_ld(1, _pb_tag(1, 0) + _pb_varint(d)) for d in shape)
    ttype = _pb_ld(1, _pb_tag(1, 0) + _pb_uvarint(1) + _pb_ld(2, dims))
    return _pb_ld(1, name.encode()) + _pb_ld(2, ttype)


def onnx_model(nodes, inputs, outputs, initializers=()):
    """ModelProto bytes: nodes, [(name, shape)] inputs and outputs,
    [(name, array)] initializers."""
    g = b"".join(_pb_ld(1, n) for n in nodes)
    g += b"".join(_pb_ld(5, onnx_tensor(k, v)) for k, v in initializers)
    g += b"".join(_pb_ld(11, _onnx_value_info(k, s)) for k, s in inputs)
    g += b"".join(_pb_ld(12, _onnx_value_info(k, s)) for k, s in outputs)
    return _pb_ld(7, g)


def _onnx_case(nodes, feeds, inits=(), outputs=("y",)):
    """(model bytes, numpy feeds, output names)."""
    return (onnx_model(nodes, [(k, v.shape) for k, v in feeds.items()],
                       [(o, [0]) for o in outputs], list(inits)),
            feeds, list(outputs))


def onnx_op_cases():
    """{name: (model, feeds, outputs)}: the op set of the port's ONNX
    executor (data/onnx_rt.py), each case from its own seed. The CPU tests
    hold these against the JAX package's numpy executor; the card run
    holds the CUDA session against the CPU one."""
    import zlib

    import numpy as np

    def case(name):
        rng = np.random.default_rng(zlib.crc32(name.encode()))

        def f(*shape):
            return rng.standard_normal(shape).astype(np.float32)

        return f

    def i64(*vals):
        return np.asarray(vals, np.int64)

    node = onnx_node
    cases = {}

    def add(name, build):
        cases[name] = build(case(name))

    for name, (g, s, p, d) in {"conv": (1, 1, 1, 1),
                               "conv_group_stride": (2, 2, 0, 1),
                               "conv_depthwise_dilated": (4, 1, 2, 2)}.items():
        add(name, lambda f, g=g, s=s, p=p, d=d: _onnx_case(
            [node("Conv", ["x", "w", "b"], ["y"], group=g, strides=[s, s],
                  dilations=[d, d], pads=[p, p + 1, p, p])],
            {"x": f(2, 4, 13, 11)}, [("w", f(8, 4 // g, 3, 3)),
                                     ("b", f(8))]))
    add("conv_same_upper", lambda f: _onnx_case(
        [node("Conv", ["x", "w"], ["y"], auto_pad=b"SAME_UPPER",
              strides=[2, 2])], {"x": f(1, 3, 10, 9)},
        [("w", f(5, 3, 4, 4))]))
    add("conv_transpose", lambda f: _onnx_case(
        [node("ConvTranspose", ["x", "w", "b"], ["y"], strides=[2, 2],
              pads=[1, 0, 1, 2], output_padding=[1, 0], group=2)],
        {"x": f(1, 6, 8, 7)}, [("w", f(6, 3, 4, 4)), ("b", f(6))]))
    add("maxpool_upsample", lambda f: _onnx_case(
        [node("MaxPool", ["x"], ["p"], kernel_shape=[2, 2], strides=[2, 2]),
         node("Resize", ["p", "", "scales"], ["y"], mode=b"nearest",
              coordinate_transformation_mode=b"asymmetric",
              nearest_mode=b"floor")], {"x": f(1, 3, 10, 10)},
        [("scales", np.array([1, 1, 2, 2], np.float32))]))
    for name, op, attrs in (
            ("maxpool_pad_ceil_dilation", "MaxPool",
             dict(kernel_shape=[3, 2], strides=[2, 2], pads=[1, 0, 1, 1],
                  ceil_mode=1, dilations=[1, 2])),
            ("avgpool_exclude_pad", "AveragePool",
             dict(kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1])),
            ("avgpool_include_pad", "AveragePool",
             dict(kernel_shape=[3, 3], strides=[2, 1], pads=[1, 1, 1, 1],
                  count_include_pad=1)),
            ("global_avgpool", "GlobalAveragePool", {})):
        add(name, lambda f, op=op, attrs=attrs: _onnx_case(
            [node(op, ["x"], ["y"], **attrs)], {"x": f(2, 3, 11, 9)}))
    for name, mode, ct, nearest, sizes in (
            ("resize_linear_half_pixel", "linear", "half_pixel", None, None),
            ("resize_linear_align_corners", "linear", "align_corners", None,
             (1, 2, 9, 4)),
            ("resize_linear_asymmetric", "linear", "asymmetric", None, None),
            ("resize_nearest_round_floor", "nearest", "half_pixel",
             "round_prefer_floor", None),
            ("resize_nearest_round_ceil", "nearest", "half_pixel",
             "round_prefer_ceil", (1, 2, 3, 11)),
            ("resize_nearest_ceil", "nearest", "asymmetric", "ceil", None)):
        attrs = dict(mode=mode.encode(),
                     coordinate_transformation_mode=ct.encode())
        if nearest:
            attrs["nearest_mode"] = nearest.encode()
        inputs, inits = (["x", "", "", "sizes"], [("sizes", i64(*sizes))]) \
            if sizes else (["x", "", "scales"], [
                ("scales", np.array([1, 1, 2.5, 1.5], np.float32))])
        add(name, lambda f, inputs=inputs, inits=inits, attrs=attrs:
            _onnx_case([node("Resize", inputs, ["y"], **attrs)],
                       {"x": f(1, 2, 5, 7)}, inits))
    add("transformer_block", lambda f: _onnx_case(
        [node("LayerNormalization", ["x", "g", "b"], ["ln"], epsilon=1e-5),
         node("MatMul", ["ln", "w"], ["mm"]),
         node("Softmax", ["mm"], ["sm"], axis=-1),
         node("Gemm", ["sm", "w", "c"], ["y"], alpha=0.5, beta=2.0,
              transB=1)], {"x": f(5, 16)},
        [("w", f(16, 16)), ("g", f(16)), ("b", f(16)), ("c", f(16))]))
    add("gemm_trans_a", lambda f: _onnx_case(
        [node("Gemm", ["a", "b"], ["y"], transA=1)],
        {"a": f(6, 4), "b": f(6, 3)}))
    add("batch_instance_norm", lambda f: _onnx_case(
        [node("BatchNormalization", ["x", "s", "b", "m", "v"], ["bn"],
              epsilon=1e-3),
         node("InstanceNormalization", ["bn", "s", "b"], ["y"])],
        {"x": f(2, 4, 5, 6)}, [("s", f(4)), ("b", f(4)), ("m", f(4)),
                               ("v", np.abs(f(4)) + 0.5)]))
    # a ViT export's shape arithmetic: Shape -> Gather -> Concat ->
    # Reshape, with Range, ConstantOfShape and Expand
    add("shape_plumbing", lambda f: _onnx_case(
        [node("Shape", ["x"], ["s"]),
         node("Gather", ["s", "i0"], ["b"], axis=0),
         node("Gather", ["s", "i1"], ["n"], axis=0),
         node("Concat", ["b", "n", "two", "m1"], ["shp"], axis=0),
         node("Reshape", ["x", "shp"], ["r"]),
         node("Transpose", ["r"], ["t"], perm=[0, 2, 1, 3]),
         node("Squeeze", ["n", "ax0"], ["n0"]),
         node("Squeeze", ["zero"], ["zero0"]),
         node("Squeeze", ["one"], ["one0"]),
         node("Range", ["zero0", "n0", "one0"], ["ar"]),
         node("Cast", ["ar"], ["arf"], to=1),
         node("ConstantOfShape", ["s"], ["c"],
              value=np.array([0.5], np.float32)),
         node("Unsqueeze", ["arf", "ax1"], ["aru"]),
         node("Expand", ["aru", "s"], ["e"]),
         node("Add", ["c", "e"], ["ce"]),
         node("Reshape", ["ce", "shp"], ["cer"]),
         node("Transpose", ["cer"], ["cet"], perm=[0, 2, 1, 3]),
         node("Add", ["t", "cet"], ["y"])], {"x": f(2, 6, 8)},
        [("i0", i64(0)), ("i1", i64(1)), ("ax0", i64(0)), ("ax1", i64(1)),
         ("two", i64(2)), ("m1", i64(-1)), ("zero", i64(0)),
         ("one", i64(1))]))
    add("slice_negative_step", lambda f: _onnx_case(
        [node("Slice", ["x", "st", "en", "ax", "sp"], ["y"])],
        {"x": f(4, 9, 5)}, [("st", i64(-1, 1)), ("en", i64(-2 ** 62, 8)),
                            ("ax", i64(1, 2)), ("sp", i64(-2, 2))]))
    add("slice_transpose_concat_reshape", lambda f: _onnx_case(
        [node("Transpose", ["x"], ["t"], perm=[0, 2, 1]),
         node("Slice", ["t", "st", "en", "ax"], ["s"]),
         node("Concat", ["s", "s"], ["c"], axis=1),
         node("Reshape", ["c", "shape"], ["y"])], {"x": f(2, 3, 4)},
        [("st", i64(1)), ("en", i64(3)), ("ax", i64(1)),
         ("shape", i64(2, -1))]))
    add("split_sigmoid_mul", lambda f: _onnx_case(
        [node("Split", ["x"], ["a", "b"], axis=1, num_outputs=2),
         node("Sigmoid", ["a"], ["sa"]), node("Mul", ["a", "sa"], ["silu"]),
         node("Add", ["silu", "b"], ["y"])], {"x": f(1, 8, 4, 4)}))
    add("split_sizes", lambda f: _onnx_case(
        [node("Split", ["x", "sz"], ["y", "z"], axis=2)], {"x": f(2, 3, 7)},
        [("sz", i64(3, 4))], outputs=("y", "z")))
    add("pad_constant", lambda f: _onnx_case(
        [node("Pad", ["x", "p", "v"], ["y"])], {"x": f(2, 3, 4)},
        [("p", i64(0, 1, 2, 1, 0, 3)), ("v", np.array(1.5, np.float32))]))
    add("pad_reflect", lambda f: _onnx_case(
        [node("Pad", ["x", "p"], ["y"], mode=b"reflect")], {"x": f(2, 5, 6)},
        [("p", i64(0, 2, 1, 0, 3, 2))]))
    add("pad_edge", lambda f: _onnx_case(
        [node("Pad", ["x", "p"], ["y"], mode=b"edge")], {"x": f(3, 4)},
        [("p", i64(2, 0, 1, 3))]))
    add("einsum", lambda f: _onnx_case(
        [node("Einsum", ["a", "b"], ["y"], equation=b"bij,bjk->bik")],
        {"a": f(2, 3, 4), "b": f(2, 4, 5)}))
    add("gather_negative", lambda f: _onnx_case(
        [node("Gather", ["x", "i"], ["y"], axis=1)], {"x": f(3, 5, 2)},
        [("i", np.array([[0, -1], [2, 4]], np.int64))]))
    add("gather_elements", lambda f: _onnx_case(
        [node("GatherElements", ["x", "i"], ["y"], axis=1)], {"x": f(3, 4)},
        [("i", np.array([[0, 3], [1, -1], [2, 2]], np.int64))]))
    add("squeeze_flatten_tile_where", lambda f: _onnx_case(
        [node("Squeeze", ["x", "ax"], ["s"]),
         node("Flatten", ["s"], ["fl"], axis=1),
         node("Tile", ["fl", "rep"], ["t"]),
         node("Greater", ["t", "zero"], ["m"]),
         node("Where", ["m", "t", "zero"], ["y"])], {"x": f(2, 1, 3, 4)},
        [("ax", i64(1)), ("rep", i64(2, 1)),
         ("zero", np.array(0.0, np.float32))]))
    add("argmax_ties", lambda f: _onnx_case(
        [node("ArgMax", ["x"], ["y"], axis=1, keepdims=0)],
        {"x": np.array([[1, 3, 3, 0], [2, 2, 2, 2], [0, 1, 5, 5]],
                       np.float32)}))
    add("topk_ties", lambda f: _onnx_case(
        [node("TopK", ["x", "k"], ["y", "i"], axis=-1)],
        {"x": np.array([[1, 3, 3, 0, 3], [2, 2, 1, 2, 2]], np.float32)},
        [("k", i64(3))], outputs=("y", "i")))
    add("topk_smallest", lambda f: _onnx_case(
        [node("TopK", ["x", "k"], ["y", "i"], axis=0, largest=0)],
        {"x": np.array([[4, 1], [1, 1], [1, 0]], np.float32)},
        [("k", i64(2))], outputs=("y", "i")))
    # numpy's promotion: an integer Div is a float64 true division
    add("cast_int_div_mod", lambda f: _onnx_case(
        [node("Cast", ["x"], ["xi"], to=7), node("Div", ["xi", "d"], ["q"]),
         node("Mod", ["xi", "d"], ["r"]), node("Cast", ["r"], ["rf"], to=1),
         node("Add", ["q", "rf"], ["y"])],
        {"x": np.array([[7.9, -7.9, 12.0], [5.0, -3.5, 0.0]], np.float32)},
        [("d", np.array([3, 3, 5], np.int64))]))
    add("pow_int_exponent", lambda f: _onnx_case(
        [node("Pow", ["a", "b"], ["y"])],
        {"a": np.abs(f(3, 4)) + 0.5, "b": np.array([2, 3, 1, 0], np.int64)}))
    add("float_mod", lambda f: _onnx_case(
        [node("Mod", ["a", "b"], ["y"])], {"a": f(3, 4) * 5, "b": f(4) + 3}))
    add("min_max", lambda f: _onnx_case(
        [node("Min", ["a", "b"], ["m"]), node("Max", ["m", "a"], ["y"])],
        {"a": f(3, 4), "b": f(4)}))
    add("compare_logic", lambda f: _onnx_case(
        [node("Equal", ["a", "b"], ["e"]), node("Less", ["a", "b"], ["l"]),
         node("Or", ["e", "l"], ["o"]), node("Not", ["o"], ["n"]),
         node("And", ["n", "l"], ["y"])],
        {"a": np.array([1, 2, 3, 4], np.int64),
         "b": np.array([1, 3, 2, 4], np.int64)}))
    add("constant_variants", lambda f: _onnx_case(
        [node("Constant", [], ["c1"], value_float=0.25),
         node("Constant", [], ["c2"], value_floats=[1.0, 2.0, 3.0]),
         node("Constant", [], ["c3"], value=np.full((3,), 2.0, np.float32)),
         node("Mul", ["x", "c1"], ["m"]), node("Add", ["m", "c2"], ["a"]),
         node("Sub", ["a", "c3"], ["y"])], {"x": f(2, 3)}))
    add("clip_inputs_and_attrs", lambda f: _onnx_case(
        [node("Clip", ["x", "lo", "hi"], ["c"]),
         node("Clip", ["c"], ["y"], min=-0.25)], {"x": f(4, 5)},
        [("lo", np.array(-0.5, np.float32)),
         ("hi", np.array(0.75, np.float32))]))
    add("dropout_identity_size", lambda f: _onnx_case(
        [node("Dropout", ["x"], ["d"]), node("Identity", ["d"], ["y"]),
         node("Size", ["x"], ["z"])], {"x": f(2, 3)}, outputs=("y", "z")))
    add("nms", lambda f: _onnx_case(
        [node("NonMaxSuppression", ["b", "s", "k", "iou", "th"], ["y"])],
        {"b": np.array([[[0, 0, 10, 10], [1, 1, 10, 10], [20, 20, 25, 25]]],
                       np.float32),
         "s": np.array([[[0.9, 0.8, 0.7], [0.1, 0.6, 0.9]]], np.float32)},
        [("k", i64(5)), ("iou", np.array([0.5], np.float32)),
         ("th", np.array([0.05], np.float32))]))
    for op, attrs in (("Relu", {}), ("Sigmoid", {}), ("Tanh", {}),
                      ("Exp", {}), ("Neg", {}), ("Abs", {}), ("Floor", {}),
                      ("Ceil", {}), ("Erf", {}), ("Softplus", {}),
                      ("HardSwish", {}), ("Mish", {}), ("Gelu", {}),
                      ("LeakyRelu", dict(alpha=0.1)),
                      ("HardSigmoid", dict(alpha=0.3, beta=0.4))):
        add(f"unary_{op}", lambda f, op=op, attrs=attrs: _onnx_case(
            [node(op, ["x"], ["y"], **attrs)], {"x": f(3, 5, 7)}))
    add("unary_Log_Sqrt", lambda f: _onnx_case(
        [node("Abs", ["x"], ["a"]), node("Log", ["a"], ["l"]),
         node("Sqrt", ["a"], ["s"]), node("Add", ["l", "s"], ["y"])],
        {"x": f(3, 4) + 0.01}))
    for op in ("ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin",
               "ReduceProd", "ReduceL2"):
        add(f"{op}_axes", lambda f, op=op: _onnx_case(
            [node(op, ["x"], ["y"], axes=[0, -1], keepdims=1)],
            {"x": f(2, 3, 4)}))
    add("ReduceMean_all", lambda f: _onnx_case(
        [node("ReduceMean", ["x"], ["y"], keepdims=0)], {"x": f(2, 3, 4)}))
    add("ReduceSum_axes_input", lambda f: _onnx_case(
        [node("ReduceSum", ["x", "ax"], ["y"], keepdims=0)],
        {"x": f(2, 3, 4)}, [("ax", i64(1))]))
    add("ReduceSum_int", lambda f: _onnx_case(
        [node("Cast", ["x"], ["xi"], to=6),
         node("ReduceSum", ["xi"], ["y"], axes=[1])], {"x": f(3, 4) * 10}))
    return cases


VITPOSE_H = dict(dim=1280, heads=16, mlp=5120, patch=16, input=(256, 192),
                 deconv=256, keypoints=133)


def vitpose_onnx(blocks, seed=PREP_SEED, width=VITPOSE_H):
    """An ONNX graph in ViTPose-H's shape (the published
    vitpose_h_wholebody end2end export's op set): a [1, 3, 256, 192]
    input, a 16x16 patch embedding to 1280 plus a position embedding,
    `blocks` pre-norm blocks (16 heads of d = 80 by MatMul / Softmax, MLP
    5120 with GELU through Erf), a last LayerNorm, two 4x4 stride-2
    deconvolutions to 256 channels with BatchNorm and ReLU, a 1x1 conv to
    133 heatmaps of 64x48. Weights U(+-1/sqrt(fan_in)) from `seed`, norm
    gains 1 and biases 0."""
    import numpy as np

    rng = np.random.default_rng(seed)
    d, nh, hid = width["dim"], width["heads"], width["mlp"]
    ph, pw = (s // width["patch"] for s in width["input"])
    n, hd = ph * pw, d // nh

    def w(*shape, fan_in=None):
        lim = 1.0 / math.sqrt(fan_in or shape[0])
        return rng.uniform(-lim, lim, shape).astype(np.float32)

    def c(name, arr):
        inits.append((name, np.asarray(arr)))
        return name

    def i64(*v):
        return np.asarray(v, np.int64)

    node = onnx_node
    inits = []
    ones, zeros = np.ones(d, np.float32), np.zeros(d, np.float32)
    p = width["patch"]
    nodes = [
        node("Conv", ["input", c("pe_w", w(d, 3, p, p, fan_in=3 * p * p)),
                      c("pe_b", np.zeros(d, np.float32))], ["pe"],
             strides=[p, p]),
        node("Reshape", ["pe", c("flat", i64(1, d, -1))], ["pe_f"]),
        node("Transpose", ["pe_f"], ["tok"], perm=[0, 2, 1]),
        node("Add", ["tok", c("pos", 0.02 * rng.standard_normal(
            (1, n, d)).astype(np.float32))], ["x0"])]
    c("ln_g", ones)
    c("ln_b", zeros)
    c("scale", np.array([1.0 / math.sqrt(hd)], np.float32))
    c("sqrt2", np.array([math.sqrt(2.0)], np.float32))
    c("one", np.array([1.0], np.float32))
    c("half", np.array([0.5], np.float32))
    c("heads", i64(1, n, 3, nh, hd))
    c("merge", i64(1, n, d))
    c("ax0", i64(0))
    x = "x0"
    for i in range(blocks):
        b = f"b{i}_"
        nodes += [
            node("LayerNormalization", [x, "ln_g", "ln_b"], [b + "ln1"],
                 epsilon=1e-6),
            node("MatMul", [b + "ln1", c(b + "qkv_w", w(d, 3 * d))],
                 [b + "qkv0"]),
            node("Add", [b + "qkv0", c(b + "qkv_b",
                                       np.zeros(3 * d, np.float32))],
                 [b + "qkv"]),
            node("Reshape", [b + "qkv", "heads"], [b + "qkv5"]),
            node("Transpose", [b + "qkv5"], [b + "qkvt"],
                 perm=[2, 0, 3, 1, 4]),
            node("Split", [b + "qkvt"], [b + "q5", b + "k5", b + "v5"],
                 axis=0, num_outputs=3),
            node("Squeeze", [b + "q5", "ax0"], [b + "q"]),
            node("Squeeze", [b + "k5", "ax0"], [b + "k"]),
            node("Squeeze", [b + "v5", "ax0"], [b + "v"]),
            node("Transpose", [b + "k"], [b + "kt"], perm=[0, 1, 3, 2]),
            node("MatMul", [b + "q", b + "kt"], [b + "s0"]),
            node("Mul", [b + "s0", "scale"], [b + "s"]),
            node("Softmax", [b + "s"], [b + "p"], axis=-1),
            node("MatMul", [b + "p", b + "v"], [b + "o"]),
            node("Transpose", [b + "o"], [b + "ot"], perm=[0, 2, 1, 3]),
            node("Reshape", [b + "ot", "merge"], [b + "om"]),
            node("MatMul", [b + "om", c(b + "proj_w", w(d, d))],
                 [b + "pr0"]),
            node("Add", [b + "pr0", c(b + "proj_b",
                                      np.zeros(d, np.float32))],
                 [b + "pr"]),
            node("Add", [x, b + "pr"], [b + "x1"]),
            node("LayerNormalization", [b + "x1", "ln_g", "ln_b"],
                 [b + "ln2"], epsilon=1e-6),
            node("MatMul", [b + "ln2", c(b + "fc1_w", w(d, hid))],
                 [b + "h0"]),
            node("Add", [b + "h0", c(b + "fc1_b",
                                     np.zeros(hid, np.float32))],
                 [b + "h"]),
            node("Div", [b + "h", "sqrt2"], [b + "hs"]),
            node("Erf", [b + "hs"], [b + "he"]),
            node("Add", [b + "he", "one"], [b + "he1"]),
            node("Mul", [b + "h", b + "he1"], [b + "hm"]),
            node("Mul", [b + "hm", "half"], [b + "g"]),
            node("MatMul", [b + "g", c(b + "fc2_w", w(hid, d))],
                 [b + "m0"]),
            node("Add", [b + "m0", c(b + "fc2_b",
                                     np.zeros(d, np.float32))],
                 [b + "m"]),
            node("Add", [b + "x1", b + "m"], [b + "x2"])]
        x = b + "x2"
    dc = width["deconv"]
    nodes += [
        node("LayerNormalization", [x, "ln_g", "ln_b"], ["last"],
             epsilon=1e-6),
        node("Transpose", ["last"], ["last_t"], perm=[0, 2, 1]),
        node("Reshape", ["last_t", c("grid", i64(1, d, ph, pw))], ["feat"])]
    cin = d
    for j in range(2):
        nodes += [
            node("ConvTranspose", [f"feat{j}" if j else "feat",
                                   c(f"dc{j}_w", w(cin, dc, 4, 4,
                                                   fan_in=dc * 16))],
                 [f"dc{j}"], strides=[2, 2], pads=[1, 1, 1, 1]),
            node("BatchNormalization",
                 [f"dc{j}", c(f"bn{j}_g", np.ones(dc, np.float32)),
                  c(f"bn{j}_b", np.zeros(dc, np.float32)),
                  c(f"bn{j}_m", np.zeros(dc, np.float32)),
                  c(f"bn{j}_v", np.ones(dc, np.float32))], [f"bn{j}"],
                 epsilon=1e-5),
            node("Relu", [f"bn{j}"], [f"feat{j + 1}"])]
        cin = dc
    k = width["keypoints"]
    nodes.append(node("Conv", ["feat2", c("head_w", w(k, dc, 1, 1,
                                                      fan_in=dc)),
                               c("head_b", np.zeros(k, np.float32))],
                      ["heatmaps"]))
    hh, ww = ph * 4, pw * 4
    return onnx_model(nodes, [("input", [1, 3] + list(width["input"]))],
                      [("heatmaps", [1, k, hh, ww])], inits)


def sam2_state_dict(manifest, seed, device):
    """A published-layout SAM2 state dict from a manifest, drawn on
    `device` at the init's scale from `seed`: weights U(+-1/sqrt(fan_in)),
    norm gains 1, biases 0, the position, memory-time and no-object
    embeddings N(0, 0.02^2), the random-Fourier matrix N(0, 1), the layer
    scales 1e-6. fp32."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for k, shape in sorted(manifest.items()):
        f32 = dict(dtype=torch.float32, device=device)
        if k.endswith("gaussian_matrix"):
            v = torch.randn(shape, generator=g, **f32)
        elif k.endswith(".gamma"):
            v = torch.full(shape, 1e-6, **f32)
        elif k.endswith(".weight") and len(shape) >= 2:
            lim = 1.0 / math.sqrt(math.prod(shape[1:]))
            v = torch.empty(shape, **f32).uniform_(-lim, lim, generator=g)
        elif k.endswith(".weight"):
            v = torch.ones(shape, **f32)
        elif k.endswith(".bias"):
            v = torch.zeros(shape, **f32)
        else:
            v = 0.02 * torch.randn(shape, generator=g, **f32)
        out[k] = v
    return out


def hiera_flops(cfg, image_size):
    """Multiply-adds x 2 of one Hiera trunk pass at image_size: the patch
    embed, each block's qkv, (windowed or global) attention, projections,
    MLP and dim-change shortcut, the way block_layout runs them."""
    h = image_size // cfg.patch_stride
    total = 2 * h * h * 3 * cfg.patch_kernel ** 2 * cfg.embed_dim
    for spec in cfg.block_layout():
        d, do, ws = spec["dim"], spec["dim_out"], spec["window"]
        n = h * h
        if spec["pooled"]:
            h //= 2
        nq = h * h
        keys = ws * ws if ws else n          # keys a query attends
        total += 2 * n * d * 3 * do          # qkv
        total += 2 * 2 * nq * keys * do      # q.k and p.v
        total += 2 * nq * do * do            # attn proj
        total += 2 * 2 * nq * do * int(do * cfg.mlp_ratio)
        if d != do:
            total += 2 * n * d * do          # shortcut proj
    return total


def memory_attention_flops(cfg, keys):
    """One memory-attention layer at a grid of cfg.feat_size^2 queries:
    its self-attention, the cross-attention into `keys` memory keys (d
    256 over kv 64) and the MLP, multiply-adds x 2."""
    n, d = cfg.feat_size ** 2, cfg.d_model
    self_attn = 2 * n * d * d * 4 + 2 * 2 * n * n * d
    cross = 2 * n * d * d * 2 + 2 * keys * cfg.mem_dim * d * 2 \
        + 2 * 2 * n * keys * d
    return self_attn + cross + 2 * 2 * n * d * cfg.dim_feedforward


def _host_libs():
    """Which of the preprocess's host libraries import here."""
    import importlib

    out = {}
    for name in ("cv2", "PIL", "imageio", "scipy"):
        try:
            mod = importlib.import_module(name)
            out[name] = getattr(mod, "__version__", "yes")
        except ImportError as e:
            out[name] = f"missing: {e}"
    return out


def _hiera_l_widths(image_size):
    """Hiera-L's widths and heads (embed 144, 2 heads doubling a stage,
    memory d 256, decoder heads d 32 / 16), depth cut to 5 trunk blocks
    and 2 memory layers."""
    from univid_tpu_torch.models import sam2

    return sam2.Sam2Config(
        image_size=image_size,
        hiera=sam2.HieraConfig(stages=(1, 1, 2, 1), global_att_blocks=(3,)),
        head=sam2.SamHeadConfig(image_size=image_size,
                                embedding_grid=image_size // 16),
        memory=sam2.MemoryConfig(num_layers=2, feat_size=image_size // 16))


def _sam2_track(model, cfg, frames, clicks):
    """One click frame, the rest propagated: ([low-res logits], [slots])
    in step order."""
    import numpy as np

    from univid_tpu_torch.models import sam2

    pred = sam2.Sam2VideoPredictor(model, cfg)
    state = pred.init_state_v2(list(frames))
    pred.add_new_points(state, 0, 1, clicks, np.ones(len(clicks), np.int32))
    list(pred.propagate_in_video(state))
    low = [state["cond"][0]["mask"]] + [
        state["tracked"][t]["mask"] for t in range(1, len(frames))]
    slots = [state["cond"][0]["slot"]] + [
        state["tracked"][t]["slot"] for t in range(1, len(frames))]
    return low, slots


def small_preprocess_parity():
    """The new host libraries; the ONNX op cases (the CPU tests' graphs)
    and a one-block ViTPose-H-shaped graph through OnnxSession on cuda
    against the same session on the CPU; two SAM2 predictor runs on cuda
    against the port on the CPU (tiny_sam2_config(64) and Hiera-L's
    widths at a 256 image, grid 16, depth cut): one click frame and three
    propagated frames, each frame's low-res logits (rel. L2 < 1e-4), the
    chosen mask slot (equal) and the mask pixels that differ."""
    import copy

    import numpy as np
    import torch

    from univid_tpu_torch.data.onnx_rt import OnnxSession
    from univid_tpu_torch.models import sam2

    log(json.dumps({"check": "preprocess host libraries",
                    "import": _host_libs()}))
    worst = 0.0
    for name, (model, feeds, outs) in sorted(onnx_op_cases().items()):
        got = OnnxSession(model, device="cuda").run(outs, feeds)
        want = OnnxSession(model, device="cpu").run(outs, feeds)
        for g, w in zip(got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                fail(f"ONNX case {name}: {g.shape} {g.dtype} on the card, "
                     f"{w.shape} {w.dtype} on the CPU")
            if np.issubdtype(w.dtype, np.floating):
                err = float(np.max(np.abs(g - w) / (1e-6 + np.abs(w)))) \
                    if w.size else 0.0
                worst = max(worst, err)
                if not np.allclose(g, w, rtol=1e-5, atol=1e-6):
                    fail(f"ONNX case {name}: card vs CPU {err:.3g}")
            elif not np.array_equal(g, w):
                fail(f"ONNX case {name}: integer outputs differ")
    graph = vitpose_onnx(1)
    x = np.random.default_rng(5).standard_normal(
        (1, 3) + VITPOSE_H["input"]).astype(np.float32)
    (got,) = OnnxSession(graph, device="cuda").run(None, {"input": x})
    (want,) = OnnxSession(graph, device="cpu").run(None, {"input": x})
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    log(json.dumps({"check": "onnx card vs CPU", "cases": len(
        onnx_op_cases()), "worst_rel_err": worst,
        "vitpose_h_1_block_rel_l2": rel, "heatmaps": list(got.shape),
        "why": "fp32 with TF32 off on both: summation order and the "
               "card's exp / erf"}))
    if rel >= 1e-5 or got.shape != (1, 133, 64, 48):
        fail(f"ViTPose-shaped graph card vs CPU rel. L2 {rel:.3g}")

    for tag, cfg, hw in (("tiny_sam2_config(64)", sam2.tiny_sam2_config(64),
                          (48, 40)),
                         ("hiera_l_widths_256", _hiera_l_widths(256),
                          (192, 160))):
        gen = torch.Generator().manual_seed(7)
        cpu = sam2.init_sam2(cfg, gen=gen, device="cpu")
        card = copy.deepcopy(cpu).to("cuda")
        rng = np.random.default_rng(3)
        frames = rng.integers(0, 60, (4,) + hw + (3,)).astype(np.uint8)
        h, w = hw
        for t in range(4):
            frames[t, h // 6 + 2 * t: h // 2 + 2 * t, w // 6: w // 2] = 230
        clicks = np.array([[w / 3, h / 3], [w / 2.5, h / 2.5]], np.float32)
        lo_c, sl_c = _sam2_track(card, cfg, frames, clicks)
        lo_h, sl_h = _sam2_track(cpu, cfg, frames, clicks)
        rels = [float(np.linalg.norm(a - b) / np.linalg.norm(b))
                for a, b in zip(lo_c, lo_h)]
        diff = [int(((a > 0) != (b > 0)).sum()) for a, b in zip(lo_c, lo_h)]
        log(json.dumps({"check": f"sam2 card vs CPU, {tag}",
                        "image_size": cfg.image_size, "frames": 4,
                        "low_res_rel_l2": rels, "slots_card": sl_c,
                        "slots_cpu": sl_h, "mask_pixels_differ": diff,
                        "low_res": list(lo_c[0].shape),
                        "why": "fp32 with TF32 off on both: summation order"}))
        if sl_c != sl_h or max(rels) >= 1e-4 \
                or not all(np.isfinite(a).all() for a in lo_c):
            fail(f"SAM2 {tag} card vs CPU: slots {sl_c} / {sl_h}, rel. L2 "
                 f"{max(rels):.3g}")
        del card, cpu
    torch.cuda.empty_cache()


def _prep_drive(root):
    """A 16-frame 1280x720 drive video and a 720x1280 reference written
    from seeded draws on the card: a bright figure walking over a noisy
    background."""
    import os

    import torch
    from PIL import Image

    from univid_tpu_torch.data.video_io import save_video

    g = torch.Generator(device="cuda").manual_seed(PREP_SEED)
    h, w = PREP_SIZE
    bg = torch.randint(0, 90, (1, h, w, 3), generator=g, device="cuda")
    frames = bg.repeat(PREP_FRAMES, 1, 1, 1)
    for t in range(PREP_FRAMES):
        x0 = w // 3 + 12 * t
        frames[t, h // 6: 5 * h // 6, x0: x0 + w // 8] = 230   # body
        frames[t, h // 12: h // 6, x0 + w // 48: x0 + w // 12] = 250  # head
    video = os.path.join(root, "drive.mp4")
    save_video(frames.to(torch.uint8).cpu().numpy(), video, fps=30)
    ref = torch.randint(0, 255, (w, h, 3), generator=g, device="cuda")
    ref_path = os.path.join(root, "ref.png")
    Image.fromarray(ref.to(torch.uint8).cpu().numpy()).save(ref_path)
    return video, ref_path


def _prep_ckpt(root):
    """ckpt_path/sam2/sam2_hiera_large.pt (every key of
    manifests/sam2_hiera_large.json drawn at the init's scale, under
    "model") and ckpt_path/pose2d/vitpose_h_wholebody.onnx
    (PREP_POSE_BLOCKS blocks); no det/, so Pose2dDriver takes the
    full-frame box. Returns (seconds, bytes) of each."""
    import os

    import torch

    from univid_tpu_torch.core.manifest import load_manifest

    out = {}
    t0 = time.perf_counter()
    os.makedirs(os.path.join(root, "sam2"), exist_ok=True)
    sd = sam2_state_dict(load_manifest(_manifest_path("sam2_hiera_large")),
                         PREP_SEED, "cuda")
    pt = os.path.join(root, "sam2", "sam2_hiera_large.pt")
    torch.save({"model": {k: v.cpu() for k, v in sd.items()}}, pt)
    out["sam2_pt"] = (time.perf_counter() - t0, os.path.getsize(pt),
                      sum(v.numel() for v in sd.values()))
    del sd
    t0 = time.perf_counter()
    os.makedirs(os.path.join(root, "pose2d"), exist_ok=True)
    onnx = os.path.join(root, "pose2d", "vitpose_h_wholebody.onnx")
    with open(onnx, "wb") as fh:
        fh.write(vitpose_onnx(PREP_POSE_BLOCKS))
    out["vitpose_onnx"] = (time.perf_counter() - t0, os.path.getsize(onnx))
    return out


class _StageClock:
    """CUDA events around named calls, charged to the SAM2 step they run
    in ("cond" or "prop", numbered); read after the run."""

    def __init__(self):
        self.step = None
        self.steps = 0
        self.events = []     # (step kind, step number, stage, start, end)

    def wrap(self, fn, stage):
        import torch

        def timed(*a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **kw)
            e.record()
            self.events.append(self.step + (stage, s, e))
            return out
        return timed

    def step_wrap(self, fn, kind):
        def stepped(*a, **kw):
            self.step = (kind, self.steps)
            self.steps += 1
            try:
                return self.wrap(fn, "step")(*a, **kw)
            finally:
                self.step = None
        return stepped

    def summary(self):
        """{kind: [{stage: ms summed over the step's calls, "step": ms},
        ...] in step order}."""
        import torch

        torch.cuda.synchronize()
        steps = {}
        for kind, n, stage, s, e in self.events:
            rec = steps.setdefault((kind, n), {})
            rec[stage] = rec.get(stage, 0.0) + s.elapsed_time(e)
        out = {}
        for (kind, _), rec in sorted(steps.items(), key=lambda kv:
                                     kv[0][1]):
            out.setdefault(kind, []).append(rec)
        return out


def prep_cli_child(argv):
    """The CLI's main(argv) in this (child) process, with CUDA events
    around each SAM2 step and its stages (the Hiera encode with the neck,
    the memory attention with its bank, the SAM heads, the memory encode)
    and around each ONNX run, host clocks around the checkpoint load and
    main; the bundle's masks and every step's logits checked. Prints one
    `prep_child` JSON line."""
    import numpy as np
    import torch

    import univid_tpu_torch.core.checkpoint as ckpt
    from univid_tpu_torch.cli import preprocess_animate
    from univid_tpu_torch.data import animate_preprocess, onnx_rt
    from univid_tpu_torch.models.sam2 import predictor

    clock = _StageClock()
    for name, stage in (("encode_frame", "encode"),
                        ("memory_attention_forward", "memory_attention"),
                        ("bank_memory", "memory_attention"),
                        ("sam_heads", "heads"),
                        ("memory_encoder_forward", "memory_encode")):
        setattr(predictor, name, clock.wrap(getattr(predictor, name),
                                            stage))
    finite, keys = [], []
    bank_memory = predictor.bank_memory

    def counted_bank(*a, **kw):
        out = bank_memory(*a, **kw)
        keys.append(int(out[0].shape[1]))
        return out

    predictor.bank_memory = counted_bank
    for name, step in (("cond_frame_step", "cond"),
                       ("propagate_step", "prop")):
        fn = clock.step_wrap(getattr(predictor, name), step)

        def checked(*a, fn=fn, **kw):
            out = fn(*a, **kw)
            finite.append(torch.isfinite(out[0]).all())
            return out
        setattr(predictor, name, checked)
    pose_ms = []
    run = onnx_rt.OnnxSession.run

    def timed_run(self, *a, **kw):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        s.record()
        out = run(self, *a, **kw)
        e.record()
        torch.cuda.synchronize()
        pose_ms.append((s.elapsed_time(e), (time.perf_counter() - t0) * 1e3))
        return out

    onnx_rt.OnnxSession.run = timed_run
    load_s = []
    load = ckpt.load_sam2_checkpoint

    def timed_load(*a, **kw):
        t0 = time.perf_counter()
        out = load(*a, **kw)
        torch.cuda.synchronize()
        load_s.append(time.perf_counter() - t0)
        return out

    ckpt.load_sam2_checkpoint = timed_load
    bundle = {}
    save = animate_preprocess.AnimatePreprocessPipeline.save

    def inspecting_save(self, b, *a, **kw):
        bundle.update({k: (list(v.shape), str(v.dtype)) for k, v in
                       b.items()})
        bundle["mask_values"] = sorted(int(v) for v in
                                       np.unique(b["aug_masks"]))
        return save(self, b, *a, **kw)

    animate_preprocess.AnimatePreprocessPipeline.save = inspecting_save
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    meta = preprocess_animate.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stages = clock.summary()
    print("prep_child " + json.dumps({
        "meta": meta, "wall_s": wall, "sam2_load_s": load_s,
        "stages_ms": stages, "pose_ms": pose_ms, "memory_keys": keys,
        "logits_finite": bool(torch.stack(finite).all()),
        "bundle": bundle,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}),
        flush=True)


def preprocess_main_path(output_dir):
    """The port's preprocess CLI in a subprocess (`python -m`-equivalent:
    prep_cli_child runs its main with CUDA events around the stages) on the
    card: --replace_flag at the default --resolution_area 1280 720, a
    PREP_FRAMES-frame synthetic drive video, --ckpt_path holding the full
    SAM2.1 Hiera-L .pt (224 M fp32 parameters, image 1024, a memory bank
    of up to 57,436 keys) written from its manifest and a ViTPose-H-shaped
    graph of PREP_POSE_BLOCKS blocks at full width. Checks the src_* files
    (frame counts and sizes of the JAX chain: 720x1280 pose, background
    and mask videos, 512x512 faces), 0/1 masks, finite logits, 4
    conditioning and 12 propagated SAM2 steps, a full bank; logs seconds a
    step by stage, the pose graph's seconds a frame, the host's share and
    the peak memory."""
    import os
    import shutil

    from univid_tpu_torch.data.animate_preprocess import fit_area_size
    from univid_tpu_torch.data.video_io import read_video_frames

    root = os.path.join(output_dir, "prep")
    ckpt_dir = os.path.join(root, "ckpt")
    os.makedirs(ckpt_dir, exist_ok=True)
    t0 = time.perf_counter()
    written = _prep_ckpt(ckpt_dir)
    video, ref = _prep_drive(root)
    write_s = time.perf_counter() - t0
    save = os.path.join(root, "src")
    argv = ["--video_path", video, "--refer_path", ref, "--save_path", save,
            "--ckpt_path", ckpt_dir, "--replace_flag"]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", "import json, sys, chip_smoke; "
         "chip_smoke.prep_cli_child(json.loads(sys.argv[1]))",
         json.dumps(argv)], capture_output=True, text=True,
        timeout=PREP_DEADLINE)
    sub_s = time.perf_counter() - t0
    if proc.returncode != 0:
        log(proc.stdout[-4000:])
        log(proc.stderr[-4000:])
        fail(f"the preprocess CLI exited {proc.returncode}")
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("prep_child ")]
    if not line:
        fail("the preprocess CLI printed no prep_child line")
    child = json.loads(line[-1][len("prep_child "):])
    shutil.rmtree(ckpt_dir)

    # the size the chain resizes to: the largest 16-aligned one of the
    # default 1280x720 area at the drive video's aspect ratio
    w, h = fit_area_size(PREP_SIZE[1], PREP_SIZE[0], 1280 * 720, 16)
    want = {"src_pose.mp4": (h, w), "src_bg.mp4": (h, w),
            "src_mask.mp4": (h, w), "src_face.mp4": (512, 512)}
    decoded = {}
    for name, hw in want.items():
        path = os.path.join(save, name)
        if not os.path.exists(path):
            fail(f"preprocess: {name} missing")
        frames = read_video_frames(path)
        decoded[name] = [len(frames), list(frames[0].shape)]
        if len(frames) != PREP_FRAMES or frames[0].shape != hw + (3,):
            fail(f"preprocess: {name} is {decoded[name]}")
    if not os.path.exists(os.path.join(save, "src_ref.png")):
        fail("preprocess: src_ref.png missing")
    st = child["stages_ms"]
    n_cond, n_prop = len(st.get("cond", [])), len(st.get("prop", []))
    bundle = child["bundle"]
    ok = (child["logits_finite"] and set(bundle["mask_values"]) <= {0, 1}
          and bundle["aug_masks"] == [[PREP_FRAMES, h, w], "uint8"]
          and n_cond == 4 and n_prop == PREP_FRAMES - 4
          and max(child["memory_keys"]) == SAM2_KEYS_FULL
          and child["meta"]["frames"] == PREP_FRAMES
          and child["meta"]["size"] == [h, w])

    def per_step(kind):
        """Seconds of a step of this kind: the first (the process's first
        convolutions and products) and the median of the rest, in all and
        by stage (the bank's assembly and the attention make
        memory_attention)."""
        recs = st.get(kind, [])
        stages = ("step", "encode", "memory_attention", "heads",
                  "memory_encode")
        return {"first": {k: recs[0].get(k, 0.0) / 1e3 for k in stages},
                "median": {k: statistics.median(
                    r.get(k, 0.0) for r in recs[1:] or recs) / 1e3
                    for k in stages}}

    device_s = (sum(r["step"] for r in st.get("cond", []) + st.get(
        "prop", [])) + sum(ms for ms, _ in child["pose_ms"])) / 1e3
    from univid_tpu_torch.models.sam2 import Sam2Config
    cfg = Sam2Config()
    log(json.dumps({
        "phase": "preprocess_main_path", "frames": PREP_FRAMES,
        "video": f"{PREP_SIZE[1]}x{PREP_SIZE[0]}", "output": f"{w}x{h}",
        "sam2": "SAM2.1 Hiera-L, fp32, TF32 off, "
        "image 1024", "pose_graph_blocks": PREP_POSE_BLOCKS,
        "written": written, "write_inputs_s": write_s,
        "subprocess_s": sub_s, "cli_main_s": child["wall_s"],
        "sam2_load_s": child["sam2_load_s"],
        "sam2_s_per_step": {"cond": per_step("cond"),
                            "prop": per_step("prop")},
        "sam2_steps": [n_cond, n_prop],
        "memory_keys": child["memory_keys"],
        "hiera_tflop_per_frame": hiera_flops(cfg.hiera, 1024) / 1e12,
        "memory_attention_tflop_per_layer_full_bank":
            memory_attention_flops(cfg.memory, SAM2_KEYS_FULL) / 1e12,
        "pose_graph_s_per_frame": [ms / 1e3 for ms, _ in child["pose_ms"]],
        "pose_run_wall_s": [wl / 1e3 for _, wl in child["pose_ms"]],
        "host_share": 1.0 - device_s / child["wall_s"],
        "peak_memory_gb": child["peak_memory_gb"], "decoded": decoded,
        "bundle": bundle, "logits_finite": child["logits_finite"]}))
    if not ok:
        fail(f"preprocess main path: {json.dumps(child)[:2000]}")


def kernels_line(records, by_path, mask_records):
    """The `kernels` line: each kernel's record with the launches of the
    path it serves (None with --kernels-only) and `launches_by_path`."""
    own = {"flash_attention_f32": "ti2v-5B",
           "flash_attention_bf16_causal": "bagel",
           "flash_attention_bf16_lse": "train",
           "flash_attention_bwd_bf16_sm90": "train",
           # the mma.sync pair is no path's kernel since the sm90 backward
           # took its masked modes too: the same-call baseline, 0 launches
           "flash_attention_bwd_dq_bf16": None,
           "flash_attention_bwd_dkv_bf16": None,
           # fp32 serving: the fp32 t2v pipeline run of fp32_train_parity
           "flash_attention_f32_sm90": "fp32_serve",
           "rope_rotate_f32": "fp32_serve",
           "flash_attention_f32_sm90_lse": "fp32_train",
           "flash_attention_bwd_dq_f32_sm90": "fp32_train",
           "flash_attention_bwd_dkv_f32_sm90": "fp32_train",
           "split_bf16x3": "fp32_train",
           # the CUDA-core fp32 d=128 kernels are no path's kernels since
           # the sm90 ones took every fp32 d=128 call: same-call baselines
           "flash_attention_f32_d128": None,
           "flash_attention_f32_lse": None,
           "flash_attention_bwd_dq_f32": None,
           "flash_attention_bwd_dkv_f32": None,
           # the mma.sync int8 QK^T kernel is no path's kernel since the sm90
           # one took every int8 call: the same-call baseline
           "flash_attention_int8_mma_sync": None,
           "flash_attention_int8_sbf16_mma_sync": None,
           # kernel A's rope-only mode has no caller on the paths (q and k
           # reach it before their norm); the pre-passes kernels A and B
           # replaced are baselines: 0
           "qk_rope_bf16": None,
           "rope_rotate_bf16": None,
           "quantize_qk_int8_pair": None}
    # the packed modes serve BAGEL packed training; no path of the JAX package reaches the segment modes at
    # d=128 (SigLIP's segments are d=72, the reference route) or the causal
    # backward (no causal training caller), and the mma.sync pair's masked
    # modes are baselines: their launches on the paths are 0
    for nm in mask_records:
        own[nm] = ("bagel_train" if nm.endswith("_packed")
                   and "_bwd_d" not in nm else None)
    # the tile lists of BAGEL packed training: one tile_lists launch a pass
    # since the tile plan; the pre-passes it replaced are baselines (0)
    own.update(tile_lists="bagel_train", mask_tile_list=None,
               bwd_tile_list=None)
    own.update(KNOB_OWNERS)
    own.update(F32_KNOB_OWNERS)
    # the flow passes' shapes of BAGEL image generation: counted by the
    # flash_attention_bf16 counter, in the request of their shape
    own.update(flash_attention_bf16_image_gen_t2i="bagel_t2i",
               flash_attention_bf16_image_gen_edit="bagel_edit")
    # the fp32 d=128 masked and grouped modes: BAGEL-7B-MoT at fp32 compute
    # (the QA request's ViT appends and prefill, the packed evaluation
    # forward and training pass); no path reaches the segment modes or the
    # causal forward with lse and backward (no causal training caller)
    own.update({nm: ("bagel_fp32" if nm.endswith(("_packed", "_grouped"))
                     or nm == "flash_attention_f32_sm90_causal" else None)
                for nm in F32_MASKED_NAMES})
    # the Kontext edit's joint attention: the 28-step 1024x1024 edit
    own.update(flash_attention_bf16_kontext="kontext")
    # the animate shapes: the animate-14B CLI run (the cross counter counts
    # the text and the image calls together, 160 each)
    own.update({nm: "animate" for nm in (
        "flash_attention_bf16_animate", "cross_attention_bf16_animate",
        "cross_attention_bf16_animate_image",
        "flash_attention_f32_sm90_animate_face")})
    # the A14B shapes: the t2v-A14B request (the i2v-A14B one beside it in
    # launches_by_path)
    own.update({f"{nm}_a14b": "t2v-A14B" for nm in A14B_KERNELS},
               flash_attention_f32_d384="t2v-A14B")
    # the shard shapes of multi-GPU serving: the sp = 2 Ulysses pipeline
    # run (both ranks' launches), the ring's lse kernel the ring DiT call
    own.update(flash_attention_bf16_sp="sp", qk_rope_bf16_sp="sp",
               qk_norm_bf16_sp="sp", cross_attention_bf16_sp="sp",
               flash_attention_bf16_lse_sp_ring="sp_ring")
    # sp 2 x tp 2: the pipeline run (all four ranks' launches), the ring
    # call; the train step on fsdp 2 x sp 2 runs the fp32 kernels at the
    # fp32 fine-tune's shapes, whose rows keep the fine-tune's launches
    own.update(flash_attention_bf16_sp_tp="sp_tp", qk_rope_bf16_sp_tp="sp_tp",
               cross_attention_bf16_sp_tp="sp_tp",
               flash_attention_bf16_lse_sp_tp_ring="sp_tp_ring")
    # the shard shapes of tensor parallelism: the tp = 2 train step (both
    # ranks' launches), the tp DiT call, the LLM's tp prefill
    own.update({f"{nm}{sfx}": "tp_train" for sfx in ("_tp", "_tp_cross")
                for nm in ("flash_attention_f32_sm90_lse",
                           "flash_attention_bwd_dq_f32_sm90",
                           "flash_attention_bwd_dkv_f32_sm90")},
               flash_attention_bf16_tp="tp_dit", qk_rope_bf16_tp="tp_dit",
               cross_attention_bf16_tp="tp_dit",
               flash_attention_bf16_causal_tp="tp_qwen")
    # the training CLI's shapes (ti2v-5B, 512x320x21): its LoRA run; the
    # registry-fed pack's packed pair: its training pass
    own.update({nm: "train_cli" for nm in (
        "flash_attention_bf16_lse_train_cli",
        "flash_attention_bwd_bf16_sm90_train_cli",
        "flash_attention_bf16_lse_train_cli_cross",
        "flash_attention_bwd_bf16_sm90_train_cli_cross",
        "flash_attention_f32_train_cli")},
               flash_attention_bf16_lse_packed_registry="bagel_registry",
               flash_attention_bwd_bf16_sm90_packed_registry="bagel_registry")
    kernels = []
    for nm, rec in records.items():
        owner = own.get(nm, "t2v-1.3B")
        counter = rec.get("counter", nm)
        launches = None
        if by_path:
            launches = by_path[owner][counter] if owner else 0
        kernels.append(dict(rec, launches=launches, launches_by_path={
            p: c[counter] for p, c in by_path.items()}))
    return kernels


def ptxas_by_function(text):
    """nvcc -Xptxas -v output by kernel function (its mangled name):
    registers, spill bytes (stores + loads) and whether ptxas serialised a
    wgmma (C7513 / C7514) there."""
    out = {}
    for chunk in text.split("Compiling entry function '")[1:]:
        fn = chunk.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", chunk)
        spills = re.search(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
        out[fn] = {
            "registers": int(regs.group(1)) if regs else None,
            "spill_bytes": (int(spills.group(1)) + int(spills.group(2))
                            if spills else None),
            "serialised_wgmma": bool(re.search(
                r"C751[34].*" + re.escape(fn), text))}
    return out


def launch_counts():
    """Every launch counter: LAUNCHES, the masked modes' LAUNCHES_BY_MODE
    and the fp32 forwards over grouped kv heads (`<name>_grouped`)."""
    from univid_tpu_torch.kernels import flash_attention as fa
    return {**fa.LAUNCHES, **fa.LAUNCHES_BY_MODE,
            **{f"{k}_grouped": v for k, v in fa.GROUPED_LAUNCHES.items()}}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--train-steps", type=int, default=3)
    ap.add_argument("--kernels-only", action="store_true")
    ap.add_argument("--output_dir", default="smoke_out")
    ap.add_argument("--log", default=None,
                    help="also append every line to this file")
    args = ap.parse_args()
    global LOG_FILE
    LOG_FILE = args.log

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
    t_run = t0 = time.perf_counter()
    times = build.build_all()
    log(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                    "per_source_s": times}))
    for name, text in build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line \
                    or "Performance Loss" in line:
                log(f"ptxas {name}: {line.strip()}")
    # the Hopper kernels: no spills, no serialised wgmma (ptxas warnings
    # C7513 / C7514), in any instantiation
    for name in ("flash_attention_sm90", "flash_attention_bwd_sm90",
                 "flash_attention_f32_sm90", "flash_attention_int8_sm90",
                 "flash_attention_causal_sm90", "mask_tiles_sm90"):
        sm90_log = build.BUILD_LOG.get(name, "")
        spills = re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", sm90_log)
        if (any(a != "0" or b != "0" for a, b in spills)
                or re.search(r"C751[34]", sm90_log)):
            fail(f"{name}.cu spills or serialises its wgmma")
    for name in ("flash_attention_int8_sm90", "flash_attention_causal_sm90",
                 "flash_attention_f32_sm90", "qk_prepass"):
        log(json.dumps({"check": f"{name}.cu instantiations",
                        "ptxas": ptxas_by_function(
                            build.BUILD_LOG.get(name, ""))}))

    t0 = time.perf_counter()
    records = check_kernels()
    retime_ti2v_kernels()
    records.update(retime_a14b_kernels())
    check_a14b_720p_kernels()
    records.update(check_train_kernels())
    records.update(check_train_cli_kernels())
    records.update(check_causal_kernels())
    records.update(check_image_gen_kernels())
    t1 = time.perf_counter()
    records.update(check_kontext_kernels())
    log(json.dumps({"phase": "check_kontext_kernels",
                    "seconds": time.perf_counter() - t1}))
    t1 = time.perf_counter()
    records.update(check_animate_kernels())
    log(json.dumps({"phase": "check_animate_kernels",
                    "seconds": time.perf_counter() - t1}))
    mask_records = check_mask_kernels()
    records.update(mask_records)
    records.update(check_f32_d128_kernels())
    records.update(check_f32_masked_kernels())
    # the knob kernels: the kernels line carries the ti2v-5B shape (the
    # knob path's model), the t2v-1.3B shape is logged beside it
    records.update(check_knob_kernels("ti2v-5B", 24, (31, 22, 40), 28672,
                                      31, running=True))
    for rec in check_knob_kernels("t2v-1.3B", 12, (21, 30, 52), 32768, 30,
                                  running=False).values():
        log(json.dumps({"kernel_at_t2v13b_shape": rec}))
    t1 = time.perf_counter()
    records.update(check_f32_knob_kernels())
    log(json.dumps({"phase": "check_f32_knob_kernels",
                    "seconds": time.perf_counter() - t1}))
    records.update(check_sp_kernels())
    records.update(check_sp_kernels(tp=2))
    records.update(check_tp_kernels())
    log(json.dumps({"phase": "kernel_checks",
                    "seconds": time.perf_counter() - t0}))

    by_path = {}
    if not args.kernels_only:
        for phase, fn in (("small_parity", small_parity),
                          ("small_fusion_parity", small_fusion_parity),
                          ("train_parity",
                           lambda: train_parity(args.output_dir)),
                          ("full_width_extractor",
                           lambda: full_width_extractor(args.output_dir)),
                          ("small_moe_parity", small_moe_parity),
                          ("small_bagel_parity", small_bagel_parity),
                          ("small_bagel_image_parity",
                           small_bagel_image_parity),
                          ("small_bagel_train_parity",
                           small_bagel_train_parity),
                          ("fp32_train_parity", fp32_train_parity),
                          ("knob_parity", knob_parity),
                          ("small_kontext_parity",
                           lambda: small_kontext_parity(args.output_dir)),
                          ("small_animate_parity", small_animate_parity),
                          ("small_preprocess_parity",
                           small_preprocess_parity)):
            t0 = time.perf_counter()
            res = fn()
            log(json.dumps({"phase": phase,
                            "seconds": time.perf_counter() - t0}))
            if phase == "fp32_train_parity":
                by_path["fp32_serve"] = res
            if phase == "knob_parity":
                by_path["fp32_knob_parity"] = res
        # each path is driven with every count at 0 just before it; a
        # kernel's launches are those of the path it serves (the t2v-1.3B
        # CLI run for the serving kernels, the ti2v-5B run for the fp32 VAE
        # kernel, timed at its d=1024 shape, the training run for the
        # training kernels, the QA request for the causal mode, the BAGEL
        # training passes for the packed modes); `launches_by_path` gives
        # every path's
        by_path["t2v-1.3B"] = main_path(args.steps, args.output_dir)
        t0 = time.perf_counter()
        checkpoint_main_path(args.output_dir)
        log(json.dumps({"phase": "checkpoint_main_path_total",
                        "seconds": time.perf_counter() - t0}))
        t0 = time.perf_counter()
        by_path["train"] = train_main_path(args.train_steps)
        log(json.dumps({"phase": "train_main_path_total",
                        "seconds": time.perf_counter() - t0}))
        t0 = time.perf_counter()
        by_path["train_cli"] = train_cli_on_card(args.output_dir)
        log(json.dumps({"phase": "train_cli_on_card_total",
                        "seconds": time.perf_counter() - t0}))
        t0 = time.perf_counter()
        by_path["ti2v-5B"] = ti2v_main_path(args.output_dir)
        log(json.dumps({"phase": "ti2v_main_path_total",
                        "seconds": time.perf_counter() - t0}))
        t0 = time.perf_counter()
        by_path.update(a14b_main_path(args.output_dir))
        log(json.dumps({"phase": "a14b_main_path_total",
                        "seconds": time.perf_counter() - t0}))
        t0 = time.perf_counter()
        a14b_dit_calls()
        log(json.dumps({"phase": "a14b_dit_calls_total",
                        "seconds": time.perf_counter() - t0}))
        t0 = time.perf_counter()
        by_path.update(knob_main_path(args.output_dir))
        log(json.dumps({"phase": "knob_main_path_total",
                        "seconds": time.perf_counter() - t0}))
        t0 = time.perf_counter()
        by_path.update(fp32_knob_main_path())
        log(json.dumps({"phase": "fp32_knob_main_path_total",
                        "seconds": time.perf_counter() - t0}))
        t0 = time.perf_counter()
        by_path["bagel"] = bagel_main_path(args.output_dir)
        log(json.dumps({"phase": "bagel_main_path_total",
                        "seconds": time.perf_counter() - t0}))
        t0 = time.perf_counter()
        by_path.update(bagel_image_main_path(args.output_dir))
        log(json.dumps({"phase": "bagel_image_main_path_total",
                        "seconds": time.perf_counter() - t0}))
        t0 = time.perf_counter()
        by_path.update(kontext_main_path())
        log(json.dumps({"phase": "kontext_main_path_total",
                        "seconds": time.perf_counter() - t0}))
        t0 = time.perf_counter()
        by_path["animate"], pipe = animate_main_path(args.output_dir)
        log(json.dumps({"phase": "animate_main_path_total",
                        "seconds": time.perf_counter() - t0}))
        t0 = time.perf_counter()
        animate_dit_720p(pipe)
        del pipe
        log(json.dumps({"phase": "animate_dit_720p_total",
                        "seconds": time.perf_counter() - t0}))
        gc.collect()
        torch.cuda.empty_cache()   # the CLI's process shares the card
        t0 = time.perf_counter()
        preprocess_main_path(args.output_dir)
        log(json.dumps({"phase": "preprocess_main_path_total",
                        "seconds": time.perf_counter() - t0}))
        t0 = time.perf_counter()
        by_path["bagel_train"], by_path["bagel_registry"], reg_records = \
            bagel_train_main_path(args.output_dir)
        records.update(reg_records)
        log(json.dumps({"phase": "bagel_train_main_path_total",
                        "seconds": time.perf_counter() - t0}))
        t0 = time.perf_counter()
        by_path["bagel_fp32"] = bagel_fp32_main_path()
        log(json.dumps({"phase": "bagel_fp32_main_path_total",
                        "seconds": time.perf_counter() - t0}))
        t0 = time.perf_counter()
        by_path["fp32_train"] = fp32_train_main_path(FP32_TRAIN_STEPS)
        log(json.dumps({"phase": "fp32_train_main_path_total",
                        "seconds": time.perf_counter() - t0}))
        gc.collect()
        torch.cuda.empty_cache()   # the ranks share the card with us
        t0 = time.perf_counter()
        by_path.update(sp_main_path(args.output_dir))
        log(json.dumps({"phase": "sp_main_path_total",
                        "seconds": time.perf_counter() - t0}))
        t0 = time.perf_counter()
        by_path.update(tp_main_path(args.output_dir))
        log(json.dumps({"phase": "tp_main_path_total",
                        "seconds": time.perf_counter() - t0}))
        t0 = time.perf_counter()
        by_path.update(sp_tp_main_path(args.output_dir))
        log(json.dumps({"phase": "sp_tp_main_path_total",
                        "seconds": time.perf_counter() - t0}))
        t0 = time.perf_counter()
        qa_cli_on_card(args.output_dir)
        log(json.dumps({"phase": "qa_cli_on_card",
                        "seconds": time.perf_counter() - t0}))
        t0 = time.perf_counter()
        naflex_cli_on_card(args.output_dir)
        log(json.dumps({"phase": "naflex_cli_on_card",
                        "seconds": time.perf_counter() - t0}))
    log(json.dumps({"phase": "chip_smoke_total",
                    "seconds": time.perf_counter() - t_run}))
    log(json.dumps({"kernels": kernels_line(records, by_path,
                                            mask_records)}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
