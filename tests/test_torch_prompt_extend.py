"""The port's prompt extension (utils/prompt_extend.py) against
univid_tpu's on the CPU, and `--use_prompt_extend` through the port's CLI.

No test reaches the network: DashScope's transport is held to JAX's with
urllib.request.urlopen replaced, and without DASH_API_KEY both factories
fall back to the offline expander."""

import json
import urllib.request

import pytest

from univid_tpu.utils import prompt_extend as jpe
from univid_tpu_torch.utils import prompt_extend as tpe


def test_system_prompts_equal_jax():
    assert tpe.system_prompts() == jpe.system_prompts()


@pytest.mark.parametrize("task,lang,is_vl,prompt", [
    ("ti2v-5B", "en", False, "a dog"), ("ti2v-5B", "zh", True, "a dog"),
    ("i2v-A14B", "en", False, ""), ("i2v-A14B", "zh", False, "a cat"),
    ("t2v-A14B", "zh", False, ""), ("t2v-1.3B", "en", False, "x")])
def test_default_sys_prompt_matches_jax(task, lang, is_vl, prompt):
    assert tpe.default_sys_prompt(task, lang, is_vl, prompt) == \
        jpe.default_sys_prompt(task, lang, is_vl, prompt)


@pytest.mark.parametrize("method", ["offline", "dashscope"])
def test_factory_and_offline_output_match_jax(method, monkeypatch):
    """'offline', and 'dashscope' without DASH_API_KEY (which falls back to
    offline): the same expander kind and the same PromptOutput fields."""
    monkeypatch.delenv("DASH_API_KEY", raising=False)
    j = jpe.make_prompt_expander(method, task="ti2v-5B")
    t = tpe.make_prompt_expander(method, task="ti2v-5B")
    assert type(t).__name__ == type(j).__name__ == "OfflinePromptExpander"
    jo = j("a cat on a mat", tar_lang="en", seed=7)
    to = t("a cat on a mat", tar_lang="en", seed=7)
    assert vars(to) == vars(jo)


def test_local_qwen_needs_a_model_dir():
    with pytest.raises(ValueError, match="prompt_extend_model"):
        tpe.make_prompt_expander("local_qwen", task="t2v-A14B")


class _Resp:
    def __init__(self, payload):
        self.payload = payload

    def read(self):
        return json.dumps(self.payload).encode()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


@pytest.mark.parametrize("fail", [False, True])
def test_dashscope_transport_matches_jax(fail, monkeypatch):
    """The OpenAI-compatible chat payload and its first choice; on failure
    the retries, then the input prompt with status False. Both packages
    post the same requests and return the same PromptOutput."""
    calls = []

    def fake_urlopen(req, timeout=None):
        body = json.loads(req.data)
        calls.append((req.full_url, req.headers, body, timeout))
        if fail:
            raise OSError("unreachable")
        return _Resp({"choices": [{"message": {
            "content": f"EXPANDED: {body['messages'][1]['content']}"}}]})

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    outs = []
    for mod in (jpe, tpe):
        e = mod.DashScopePromptExpander(api_key="k", task="t2v-A14B",
                                        retry_times=2,
                                        base_url="http://localhost:1")
        outs.append(vars(e("a cat", tar_lang="en", seed=3)))
    assert outs[0] == outs[1]
    assert outs[1]["status"] is (not fail)
    n = len(calls) // 2
    assert n == (2 if fail else 1)
    assert calls[:n] == calls[n:]


@pytest.mark.parametrize("method", ["offline", "dashscope",
                                    "dashscope_key"])
def test_cli_use_prompt_extend(method, tmp_path, monkeypatch):
    """`--use_prompt_extend` in the port's t2v CLI (tiny, mock weights, the
    CPU) gives the prompt JAX's expander gives: offline, and dashscope
    without a key, keep it; dashscope with a key (urlopen replaced) takes
    the expansion, which the sidecar carries."""
    from univid_tpu_torch.cli import inference
    monkeypatch.delenv("DASH_API_KEY", raising=False)
    if method == "dashscope_key":
        monkeypatch.setenv("DASH_API_KEY", "k")
        monkeypatch.setattr(urllib.request, "urlopen", lambda req, timeout=None:
                            _Resp({"choices": [{"message": {
                                "content": "a red ball, cinematic"}}]}))
    prompt = "a red ball bouncing"
    want = jpe.make_prompt_expander(method.split("_")[0], task="tiny")(
        prompt, tar_lang="en", seed=42)
    meta = inference.main([
        "--model", "tiny", "--mock_weights", "--no_bagel", "--device", "cpu",
        "--video_size", "64x64", "--video_length", "5", "--steps", "1",
        "--prompt", prompt, "--use_prompt_extend", "--prompt_extend_method",
        method.split("_")[0], "--output_dir", str(tmp_path)])[0]
    assert want.status and meta["prompt"] == want.prompt
    assert (want.prompt == prompt) == (method != "dashscope_key")
