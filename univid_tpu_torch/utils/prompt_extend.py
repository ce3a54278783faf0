"""Prompt expanders: cinematic rewriting of user prompts before t2v / i2v
(a copy of univid_tpu/utils/prompt_extend.py; the port does not import the
JAX package).

  * PromptExpander: the task-keyed default system prompt (ti2v picks its
    t2v or i2v prompt by is_vl; i2v with an empty prompt takes the 'empty'
    variant) and the __call__ dispatch.
  * DashScopePromptExpander: qwen-plus / qwen-vl-max through DashScope's
    OpenAI-compatible HTTP API (urllib), with retries; PromptOutput
    status / message bookkeeping. Without DASH_API_KEY the factory falls
    back to the offline expander.
  * QwenPromptExpander: a local HF Qwen2.5-Instruct (or, with is_vl,
    Qwen2.5-VL) checkpoint dir, on the CPU (host-side work); needs
    `transformers`.
  * OfflinePromptExpander: returns the prompt unchanged (hermetic runs).

The cinematic system prompts (zh + en; T2V, I2V, I2V-empty) ship as
package data, cinematic_prompts.json (the JAX package's file).
"""

from __future__ import annotations

import json
import os
import random
import sys
import urllib.request
from dataclasses import dataclass
from typing import Optional

_PROMPTS = None


def system_prompts() -> dict:
    global _PROMPTS
    if _PROMPTS is None:
        path = os.path.join(os.path.dirname(__file__),
                            "cinematic_prompts.json")
        with open(path, encoding="utf-8") as f:
            _PROMPTS = json.load(f)
    return _PROMPTS


def default_sys_prompt(task: str, tar_lang: str = "zh",
                       is_vl: bool = False, prompt: str = "") -> str:
    """The default system prompt of `task` (decide_system_prompt)."""
    p = system_prompts()
    lang = tar_lang.upper()
    if "ti2v" in task:
        return p[f"{'I2V' if is_vl else 'T2V'}_A14B_{lang}_SYS_PROMPT"]
    if "i2v" in task:
        if len(prompt) == 0:
            return p[f"I2V_A14B_EMPTY_{lang}_SYS_PROMPT"]
        return p[f"I2V_A14B_{lang}_SYS_PROMPT"]
    return p[f"T2V_A14B_{lang}_SYS_PROMPT"]


@dataclass
class PromptOutput:
    status: bool
    prompt: str
    seed: int
    system_prompt: str
    message: str


class PromptExpander:
    def __init__(self, model_name: Optional[str] = None,
                 task: str = "t2v-A14B", is_vl: bool = False):
        self.model_name = model_name
        self.task = task
        self.is_vl = is_vl

    def extend(self, prompt, system_prompt, seed=-1) -> PromptOutput:
        raise NotImplementedError

    def extend_with_img(self, prompt, system_prompt, image=None,
                        seed=-1) -> PromptOutput:
        raise NotImplementedError

    def decide_system_prompt(self, tar_lang="zh", prompt="") -> str:
        return default_sys_prompt(self.task, tar_lang, self.is_vl, prompt)

    def __call__(self, prompt, system_prompt=None, tar_lang="zh",
                 image=None, seed=-1) -> PromptOutput:
        if system_prompt is None:
            system_prompt = self.decide_system_prompt(tar_lang=tar_lang,
                                                      prompt=prompt)
        if seed < 0:
            seed = random.randint(0, sys.maxsize)
        if image is not None and self.is_vl:
            return self.extend_with_img(prompt, system_prompt,
                                        image=image, seed=seed)
        if not self.is_vl:
            return self.extend(prompt, system_prompt, seed)
        raise NotImplementedError


class OfflinePromptExpander(PromptExpander):
    """Deterministic no-op: returns the input prompt unchanged (hermetic
    CI / no-API-key mode)."""

    def extend(self, prompt, system_prompt, seed=-1) -> PromptOutput:
        return PromptOutput(True, prompt, seed, system_prompt, "offline")

    def extend_with_img(self, prompt, system_prompt, image=None,
                        seed=-1) -> PromptOutput:
        return self.extend(prompt, system_prompt, seed)


class DashScopePromptExpander(PromptExpander):
    """qwen-plus (text) / qwen-vl-max (vl) over the DashScope
    OpenAI-compatible endpoint."""

    BASE_URL = "https://dashscope.aliyuncs.com/compatible-mode/v1"

    def __init__(self, api_key: Optional[str] = None,
                 model_name: Optional[str] = None, task: str = "t2v-A14B",
                 is_vl: bool = False, retry_times: int = 4,
                 base_url: Optional[str] = None, timeout: float = 60.0):
        if model_name is None:
            model_name = "qwen-vl-max" if is_vl else "qwen-plus"
        super().__init__(model_name, task, is_vl)
        self.api_key = api_key or os.environ.get("DASH_API_KEY", "")
        if not self.api_key:
            raise ValueError("DASH_API_KEY is not set")
        self.base_url = base_url or os.environ.get("DASH_API_URL",
                                                   self.BASE_URL)
        self.retry_times = retry_times
        self.timeout = timeout

    def _chat(self, messages, seed) -> str:
        req = urllib.request.Request(
            f"{self.base_url}/chat/completions",
            data=json.dumps({"model": self.model_name,
                             "messages": messages,
                             "seed": seed % (2 ** 31)}).encode(),
            headers={"Authorization": f"Bearer {self.api_key}",
                     "Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            out = json.load(resp)
        return out["choices"][0]["message"]["content"]

    def extend(self, prompt, system_prompt, seed=-1) -> PromptOutput:
        messages = [{"role": "system", "content": system_prompt},
                    {"role": "user", "content": prompt}]
        err = None
        for _ in range(self.retry_times):
            try:
                text = self._chat(messages, seed)
                return PromptOutput(True, text, seed, system_prompt, "ok")
            except Exception as e:  # noqa: BLE001
                err = e
        return PromptOutput(False, prompt, seed, system_prompt, str(err))

    def extend_with_img(self, prompt, system_prompt, image=None,
                        seed=-1) -> PromptOutput:
        import base64
        import io

        from PIL import Image
        if isinstance(image, str):
            image = Image.open(image).convert("RGB")
        buf = io.BytesIO()
        image.save(buf, format="PNG")
        b64 = base64.b64encode(buf.getvalue()).decode()
        messages = [
            {"role": "system", "content": system_prompt},
            {"role": "user", "content": [
                {"type": "text", "text": prompt},
                {"type": "image_url", "image_url": {
                    "url": f"data:image/png;base64,{b64}"}}]},
        ]
        err = None
        for _ in range(self.retry_times):
            try:
                text = self._chat(messages, seed)
                return PromptOutput(True, text, seed, system_prompt, "ok")
            except Exception as e:  # noqa: BLE001
                err = e
        return PromptOutput(False, prompt, seed, system_prompt, str(err))


class QwenPromptExpander(PromptExpander):
    """Local HF Qwen2.5-Instruct expander, torch on the CPU (host-side
    preprocessing, not accelerator work). is_vl=True loads a Qwen2.5-VL
    checkpoint instead (AutoProcessor + AutoModelForVision2Seq), whose
    `extend_with_img` conditions on the image."""

    def __init__(self, model_name: str, task: str = "t2v-A14B",
                 is_vl: bool = False, max_new_tokens: int = 512):
        super().__init__(model_name, task, is_vl)
        if is_vl:
            from transformers import (AutoModelForVision2Seq,
                                      AutoProcessor)
            self.processor = AutoProcessor.from_pretrained(
                model_name, local_files_only=True, use_fast=True)
            self.model = AutoModelForVision2Seq.from_pretrained(
                model_name, local_files_only=True)
            self.tokenizer = getattr(self.processor, "tokenizer",
                                     self.processor)
        else:
            from transformers import AutoModelForCausalLM, AutoTokenizer
            self.tokenizer = AutoTokenizer.from_pretrained(
                model_name, local_files_only=True)
            self.model = AutoModelForCausalLM.from_pretrained(
                model_name, local_files_only=True)
            self.processor = None
        self.max_new_tokens = max_new_tokens

    def extend(self, prompt, system_prompt, seed=-1) -> PromptOutput:
        import torch
        try:
            messages = [{"role": "system", "content": system_prompt},
                        {"role": "user", "content": prompt}]
            text = self.tokenizer.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=True)
            ids = self.tokenizer([text], return_tensors="pt")
            torch.manual_seed(seed % (2 ** 31))
            out = self.model.generate(**ids,
                                      max_new_tokens=self.max_new_tokens)
            new = out[0][ids["input_ids"].shape[1]:]
            expanded = self.tokenizer.decode(new,
                                             skip_special_tokens=True)
            return PromptOutput(True, expanded, seed, system_prompt, "ok")
        except Exception as e:  # noqa: BLE001
            return PromptOutput(False, prompt, seed, system_prompt,
                                str(e))

    def extend_with_img(self, prompt, system_prompt, image=None,
                        seed=-1) -> PromptOutput:
        """Image-conditioned expansion through the local VL processor: the
        image rides in the user turn's content list; the processor handles
        its smart-resize; generated ids are trimmed past the prompt before
        decode."""
        import torch
        if self.processor is None:
            return PromptOutput(
                False, prompt, seed, system_prompt,
                "extend_with_img needs is_vl=True (a Qwen2.5-VL "
                "checkpoint via --prompt_extend_model)")
        try:
            from PIL import Image
            if isinstance(image, str):
                image = Image.open(image).convert("RGB")
            elif image is not None and not isinstance(image, Image.Image):
                import numpy as _np
                image = Image.fromarray(_np.asarray(image))
            messages = [
                {"role": "system",
                 "content": [{"type": "text", "text": system_prompt}]},
                {"role": "user",
                 "content": [{"type": "image", "image": image},
                             {"type": "text", "text": prompt}]},
            ]
            text = self.processor.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=True)
            inputs = self.processor(text=[text], images=[image],
                                    padding=True, return_tensors="pt")
            torch.manual_seed(seed % (2 ** 31))
            out = self.model.generate(**inputs,
                                      max_new_tokens=self.max_new_tokens)
            new = out[0][inputs["input_ids"].shape[1]:]
            expanded = self.processor.batch_decode(
                [new], skip_special_tokens=True,
                clean_up_tokenization_spaces=False)[0]
            return PromptOutput(True, expanded, seed, system_prompt,
                                "ok")
        except Exception as e:  # noqa: BLE001
            return PromptOutput(False, prompt, seed, system_prompt,
                                str(e))


def make_prompt_expander(method: str, task: str, is_vl: bool = False,
                         model_name: Optional[str] = None,
                         api_key: Optional[str] = None) -> PromptExpander:
    """CLI factory: 'dashscope' | 'local_qwen' | 'offline'."""
    if method == "dashscope":
        try:
            return DashScopePromptExpander(api_key=api_key, task=task,
                                           is_vl=is_vl,
                                           model_name=model_name)
        except ValueError:
            return OfflinePromptExpander(task=task, is_vl=is_vl)
    if method == "local_qwen":
        if not model_name:
            raise ValueError("local_qwen needs --prompt_extend_model (a "
                             "local checkpoint dir)")
        return QwenPromptExpander(model_name, task=task, is_vl=is_vl)
    return OfflinePromptExpander(task=task, is_vl=is_vl)
