"""Pyramid Reflection — multi-round video QA state machine (the JAX
package's univid_tpu/reflection/reflexion.py over the port's BAGEL
inferencer and scorer; the logic is the same code).

Parity with reference reflexion_answer_one (eval_understanding.py:521-721):
  1. classify question type (static/dynamic) via the judge LLM
  2. sample a 64-frame pool; caption 16 seed frames with BAGEL; summarize
     into a global caption
  3. static branch: rounds K in (4, 8, 16) of SigLIP2 top-k retrieval
     (cumulative, excluding already-chosen frames) -> BAGEL QA -> judge
     score; accept at score >= 0.7 or verdict accept; otherwise reflect
     and refine the retrieval query
  4. dynamic branch: 64 -> MMR(32) -> MMR(16) with lambda=0.5
  5. fallbacks: judge answer-from-global-caption, else last BAGEL answer
Trace JSON layout matches the reference's per-video artifacts.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..data.video_io import _sample_indices, sample_video_frames_uniform, save_image
from .mmr import mmr_select

SINGLE_FRAME_PROMPT = (
    "You are assisting video understanding via per-frame analysis. "
    "Describe the main objects and actions in THIS SINGLE FRAME concisely."
)

ACCEPT_SCORE = 0.7


@dataclass
class ReflexionConfig:
    pool_frames: int = 64
    static_seq: Tuple[int, ...] = (4, 8, 16)
    dynamic_seq: Tuple[int, ...] = (64, 32, 16)
    caption_seed_frames: int = 16
    max_think_token_n: int = 512
    do_sample: bool = False
    temperature: float = 0.3
    mmr_lambda: float = 0.5
    siglip_bs: int = 64
    save_frames_root: Optional[str] = None


def _accepted(eval_json: Dict[str, Any]) -> bool:
    if eval_json.get("verdict", "reject") == "accept":
        return True
    try:
        return float(eval_json.get("score", 0)) >= ACCEPT_SCORE
    except Exception:
        return False


def _save_frames(root, video_path, tag, frames, indices):
    if not root:
        return
    vid = os.path.splitext(os.path.basename(video_path))[0]
    out_dir = os.path.join(root, vid, tag)
    os.makedirs(out_dir, exist_ok=True)
    for rank, (f, i) in enumerate(zip(frames, indices)):
        save_image(np.asarray(f),
                   os.path.join(out_dir, f"rank{rank}_frame{i}.jpg"))


def _to_model_image(frame: np.ndarray) -> np.ndarray:
    f = np.asarray(frame)
    if f.dtype == np.uint8:
        f = f.astype(np.float32) / 127.5 - 1.0
    return f


def reflexion_answer_one(
    video_path: str,
    question: str,
    bagel,                       # InterleaveInferencer-compatible
    ds_client,                   # reflector
    qwen_client,                 # judge
    scorer,                      # Siglip2Scorer
    cfg: ReflexionConfig = ReflexionConfig(),
    frames: Optional[List[np.ndarray]] = None,
) -> Tuple[str, Dict[str, Any]]:
    """Returns (final_answer, trace)."""
    qtype_info = qwen_client.classify_qtype(question)
    qtype = qtype_info.get("qtype", "static")

    pool = frames if frames is not None else \
        sample_video_frames_uniform(video_path, cfg.pool_frames)
    n = len(pool)

    # global caption from seed-frame notes — batched (vmapped) when the
    # inferencer supports it, else the sequential reference loop
    seed_idx = _sample_indices(n, cfg.caption_seed_frames)
    if hasattr(bagel, "caption_frames"):
        frame_notes = bagel.caption_frames(
            [_to_model_image(pool[i]) for i in seed_idx],
            SINGLE_FRAME_PROMPT, max_length=cfg.max_think_token_n,
            do_sample=cfg.do_sample, temperature=cfg.temperature)
    else:
        frame_notes = []
        for i in seed_idx:
            out = bagel(image=_to_model_image(pool[i]),
                        text=SINGLE_FRAME_PROMPT,
                        understanding_output=True,
                        max_think_token_n=cfg.max_think_token_n,
                        do_sample=cfg.do_sample,
                        text_temperature=cfg.temperature)
            frame_notes.append(out.get("text", ""))
    global_caption = qwen_client.summarize_frames(frame_notes)

    # the pool is fixed across reflexion rounds: embed it once and
    # re-rank each refined query through the text tower only
    pool_emb_cache: List[Optional[np.ndarray]] = [None]

    def select_topk(query_text: str, topk: int, exclude: set
                    ) -> Tuple[List[int], List[float]]:
        remain = [i for i in range(n) if i not in exclude]
        if not remain:
            return [], []
        if pool_emb_cache[0] is None:
            pool_emb_cache[0] = np.asarray(
                scorer.emb_imgs(pool, bs=cfg.siglip_bs))
        t = np.asarray(scorer.emb_text(query_text)).reshape(-1)
        sims = pool_emb_cache[0][remain] @ t
        k = min(topk, len(remain))
        order = np.argsort(-sims)[:k]
        return [remain[j] for j in order], [float(sims[j]) for j in order]

    def qa_on_frames(frame_list: List[np.ndarray]) -> str:
        out = bagel.video_understanding(
            video=[_to_model_image(f) for f in frame_list], text=question,
            fps=1.0, max_frames=len(frame_list),
            max_think_token_n=cfg.max_think_token_n,
            do_sample=cfg.do_sample, text_temperature=cfg.temperature)
        return out.get("text", "")

    trace: Dict[str, Any] = {
        "video": video_path,
        "question": question,
        "qtype_init": qtype,
        "global_caption": global_caption,
        "rounds": [],
    }
    refined_query = question
    final_answer: Optional[str] = None

    if qtype == "static":
        selected: List[int] = []
        exclude: set = set()
        last_answer = ""
        for it, k in enumerate(cfg.static_seq, start=1):
            need = k - len(selected)
            if need > 0:
                new_idx, _ = select_topk(refined_query, need, exclude)
                selected.extend(new_idx)
                exclude.update(new_idx)
            frames_this = [pool[i] for i in selected]
            _save_frames(cfg.save_frames_root, video_path,
                         f"static_it{it}_k{len(selected)}", frames_this,
                         selected)
            ans = qa_on_frames(frames_this)
            last_answer = ans
            ev = qwen_client.eval_answer(question, global_caption, ans)
            trace["rounds"].append({"type": "static", "iter": it,
                                    "K": len(frames_this), "answer": ans,
                                    "eval": ev})
            if _accepted(ev):
                final_answer = ans
                break
            refl = ds_client.reflect(question, global_caption, ans, ev)
            refined_query = refl.get("refined_query") or refined_query
        if final_answer is None:
            fallback = qwen_client.answer_from_global(
                question, global_caption).strip()
            if fallback == "" or "not enough" in fallback.lower() \
                    or "insufficient" in fallback.lower():
                final_answer = last_answer
                trace["fallback"] = {
                    "reason": "final_score_below_0.7_and_global_not_enough",
                    "answer_from_qwen": fallback}
            else:
                final_answer = fallback
                trace["fallback"] = {"reason": "final_score_below_0.7",
                                     "answer_from_qwen": fallback}
    else:
        k0 = cfg.dynamic_seq[0]
        idx0 = _sample_indices(n, k0)
        frames0 = [pool[i] for i in idx0]
        _save_frames(cfg.save_frames_root, video_path,
                     f"dynamic_it1_k{k0}", frames0, idx0)
        ans0 = qa_on_frames(frames0)
        ev0 = qwen_client.eval_answer(question, global_caption, ans0)
        trace["rounds"].append({"type": "dynamic", "iter": 1, "K": k0,
                                "answer": ans0, "eval": ev0})
        if _accepted(ev0):
            final_answer = ans0
        else:
            refl = ds_client.reflect(question, global_caption, ans0, ev0)
            refined_query = refl.get("refined_query") or question
            q_emb = scorer.emb_text(refined_query)
            v_emb = scorer.emb_imgs(frames0, bs=cfg.siglip_bs)
            local1 = mmr_select(v_emb, q_emb, cfg.dynamic_seq[1],
                                cfg.mmr_lambda)
            idx1 = [idx0[i] for i in local1]
            frames1 = [pool[i] for i in idx1]
            _save_frames(cfg.save_frames_root, video_path,
                         f"dynamic_it2_k{cfg.dynamic_seq[1]}", frames1,
                         idx1)
            ans1 = qa_on_frames(frames1)
            ev1 = qwen_client.eval_answer(question, global_caption, ans1)
            trace["rounds"].append({"type": "dynamic", "iter": 2,
                                    "K": len(frames1), "answer": ans1,
                                    "eval": ev1})
            if _accepted(ev1):
                final_answer = ans1
            else:
                refl = ds_client.reflect(question, global_caption, ans1,
                                         ev1)
                refined_query = refl.get("refined_query") or refined_query
                q_emb2 = scorer.emb_text(refined_query)
                v_emb2 = scorer.emb_imgs(frames1, bs=cfg.siglip_bs)
                local2 = mmr_select(v_emb2, q_emb2, cfg.dynamic_seq[2],
                                    cfg.mmr_lambda)
                idx2 = [idx1[i] for i in local2]
                frames2 = [pool[i] for i in idx2]
                _save_frames(cfg.save_frames_root, video_path,
                             f"dynamic_it3_k{cfg.dynamic_seq[2]}",
                             frames2, idx2)
                ans2 = qa_on_frames(frames2)
                ev2 = qwen_client.eval_answer(question, global_caption,
                                              ans2)
                trace["rounds"].append({"type": "dynamic", "iter": 3,
                                        "K": len(frames2), "answer": ans2,
                                        "eval": ev2})
                if _accepted(ev2):
                    final_answer = ans2
                else:
                    fallback = qwen_client.answer_from_global(
                        question, global_caption).strip()
                    if fallback == "" or "not enough" in fallback.lower() \
                            or "insufficient" in fallback.lower():
                        final_answer = ans0
                        trace["fallback"] = {
                            "reason":
                            "final_score_below_0.7_and_global_not_enough",
                            "answer_from_qwen": fallback}
                    else:
                        final_answer = fallback
                        trace["fallback"] = {
                            "reason": "final_score_below_0.7",
                            "answer_from_qwen": fallback}

    trace["qtype_final"] = qtype
    trace["final_answer"] = final_answer
    return final_answer, trace
