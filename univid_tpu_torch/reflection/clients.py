"""LLM judge / reflector clients for Pyramid Reflection (copy of
univid_tpu/reflection/clients.py).

Parity with reference eval_understanding.py:243-421: an OpenAI-compatible
chat endpoint (DashScope) drives three roles — Qwen judge (answer scoring,
frame summarization, question-type classification, global-caption
fallback answers) and DeepSeek reflector (query refinement) — with no-op
offline fallbacks when no API key is present so evals stay hermetic.

Implemented over urllib (no SDK dependency); JSON parsing is as defensive
as the reference's (code-fence stripping, embedded-object regex, score
clamping, verdict coercion to accept only when score >= 0.7).
"""

from __future__ import annotations

import json
import re
import urllib.request
from typing import Any, Dict, List, Optional

DEFAULT_BASE_URL = "https://dashscope.aliyuncs.com/compatible-mode/v1"


def _chat(base_url: str, api_key: str, model: str, sys_prompt: str,
          user_prompt: str, timeout: float = 60.0) -> str:
    req = urllib.request.Request(
        f"{base_url}/chat/completions",
        data=json.dumps({
            "model": model,
            "messages": [
                {"role": "system", "content": sys_prompt},
                {"role": "user", "content": user_prompt},
            ],
            "stream": False,
        }).encode(),
        headers={"Authorization": f"Bearer {api_key}",
                 "Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        out = json.loads(resp.read().decode())
    return out["choices"][0]["message"]["content"]


def _parse_json_blob(s: str) -> Dict[str, Any]:
    try:
        return json.loads(s)
    except Exception:
        m = re.search(r"(\{.*\}|\[.*\])", s, flags=re.S)
        if m:
            try:
                return json.loads(m.group(1))
            except Exception:
                pass
    return {}


class QwenJudge:
    """Judge LLM (reference class `Qwen`, model qwen-plus)."""

    def __init__(self, api_key: str, base_url: str = DEFAULT_BASE_URL,
                 model: str = "qwen-plus"):
        assert api_key, "judge API key required"
        self.api_key = api_key
        self.base_url = base_url
        self.model = model

    def chat(self, sys_prompt: str, user_prompt: str) -> str:
        return _chat(self.base_url, self.api_key, self.model, sys_prompt,
                     user_prompt)

    def eval_answer(self, question: str, global_caption: str, answer: str
                    ) -> Dict[str, Any]:
        sys_p = (
            "You are a precise evaluator for video-QA. "
            "Return a SINGLE-LINE JSON ONLY. No Markdown, no code block, "
            "no extra text. Keys: score (float 0..1), verdict ('accept' if "
            "score>=0.7 else 'reject'), brief_reason (string; 1-2 short "
            "bullets).")
        user_p = (
            f"Question: {question}\n"
            f"Global Caption: {global_caption}\n"
            f"Candidate Answer: {answer}\n\n"
            "Output strictly one-line JSON. Do not explain.")
        obj = _parse_json_blob(self.chat(sys_p, user_p).strip())
        try:
            score = max(0.0, min(1.0, float(obj.get("score", 0.0))))
        except Exception:
            score = 0.0
        verdict = str(obj.get("verdict", "")).lower().strip()
        verdict = "accept" if verdict == "accept" and score >= 0.7 \
            else "reject"
        brief = str(obj.get("brief_reason", "")).strip() or \
            "Insufficient evidence or mismatch."
        return {"score": score, "verdict": verdict, "brief_reason": brief}

    def summarize_frames(self, frame_captions: List[str]) -> str:
        sys_p = ("You are a precise video-summary assistant. Summarize "
                 "chronologically ordered frame notes into a compact "
                 "global caption. Do not invent facts; only use what "
                 "appears in the notes.")
        notes = "\n".join(f"- {c}" for c in frame_captions[:64])
        user_p = (f"Frame-wise notes (chronological, earlier->later):\n"
                  f"{notes}\n\nWrite ONE global caption that connects "
                  "multiple frames focusing on visual facts only.")
        return self.chat(sys_p, user_p).strip()

    def classify_qtype(self, question: str) -> Dict[str, Any]:
        sys_p = ("You are a precise QA type classifier for video "
                 "questions. Output JSON only.")
        user_p = (
            "Decide whether the following video question requires temporal "
            'reasoning ("dynamic") or can be answered from a small set of '
            'frames without ordering ("static").\n\n'
            '- "dynamic": needs counting/repetition/order/temporal '
            "dependency.\n"
            '- "static": identity/attribute/location/one-shot action.\n\n'
            f"Question:\n{question}\n\n"
            "Return a JSON with fields:\n"
            '- qtype: "static" or "dynamic"\n'
            "- rationale: 1-2 short phrases")
        obj = _parse_json_blob(self.chat(sys_p, user_p).strip())
        qtype = str(obj.get("qtype", "static")).lower().strip()
        if qtype not in ("static", "dynamic"):
            qtype = "static"
        return {"qtype": qtype, "rationale": obj.get("rationale", "")}

    def answer_from_global(self, question: str, global_caption: str) -> str:
        sys_p = ("You answer concisely using only the given question and "
                 "the global video caption.")
        user_p = (
            f"Question: {question}\n"
            f"Global caption (may miss fine details): {global_caption}\n\n"
            "Instruction:\n- Produce a single short answer (1-2 "
            "sentences).\n- If information is insufficient, say 'Not "
            "enough evidence from global caption.'")
        return self.chat(sys_p, user_p).strip()


class DeepSeekReflector:
    """Reflector LLM (reference class `DeepSeek`, model deepseek-v3.1)."""

    def __init__(self, api_key: str, base_url: str = DEFAULT_BASE_URL,
                 model: str = "deepseek-v3.1"):
        assert api_key, "reflector API key required"
        self.api_key = api_key
        self.base_url = base_url
        self.model = model

    def chat(self, sys_prompt: str, user_prompt: str) -> str:
        return _chat(self.base_url, self.api_key, self.model, sys_prompt,
                     user_prompt)

    def reflect(self, question: str, global_caption: str, last_answer: str,
                eval_json: Dict[str, Any]) -> Dict[str, str]:
        sys_p = ("You are the Reflector in a video-understanding "
                 "pipeline. Output JSON ONLY with a single key: "
                 "refined_query (<=25 tokens, declarative).")
        user_p = (
            f"Question: {question}\n"
            f"Global Caption: {global_caption}\n"
            f"Last Answer: {last_answer}\n"
            f"Evaluation JSON: {json.dumps(eval_json, ensure_ascii=False)}"
        )
        obj = _parse_json_blob(self.chat(sys_p, user_p).strip())
        return {"refined_query": str(obj.get("refined_query", "")).strip()}


# ---------------------------------------------------------------------------
# offline no-op fallbacks (eval_understanding.py:403-421)
# ---------------------------------------------------------------------------


class NoOpReflector:
    def reflect(self, *args, **kwargs):
        return {"refined_query": ""}


class NoOpJudge:
    def classify_qtype(self, question: str):
        return {"qtype": "static", "rationale": "no-api-key"}

    def summarize_frames(self, frame_captions):
        return ""

    def eval_answer(self, question, global_caption, answer):
        return {"score": 0.0, "verdict": "reject",
                "brief_reason": "no-api-key"}

    def answer_from_global(self, question, global_caption):
        return "Not enough evidence from global caption."


def make_reflection_clients(api_key: Optional[str],
                            base_url: str = DEFAULT_BASE_URL):
    """(reflector, judge) — real clients with a key, no-ops without."""
    if api_key:
        return (DeepSeekReflector(api_key, base_url),
                QwenJudge(api_key, base_url))
    return NoOpReflector(), NoOpJudge()
