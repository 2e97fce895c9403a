"""The port's text front end against the JAX package on the CPU: prompt
templates (``utils/prompts.py``), the text and chat APIs of
``TextGenerator``, ``ops.softmax_split``, the CLI's argument parsing and its
refusals, and the trace / metrics helpers of ``utils/profiling.py``.

Tolerances: prompt strings and stop ids equal; chat and text completions
give JAX's greedy tokens (so the same text) with logprobs within 1e-4 (fp32,
as the engine tests); ``softmax_split`` within 2e-5.
"""

import json
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import lite_llama_tpu.ops as jops  # noqa: E402
from lite_llama_tpu.config import LlamaConfig as JLlama  # noqa: E402
from lite_llama_tpu.executor.engine import InferenceEngine as JEngine  # noqa: E402
from lite_llama_tpu.generation.generate import TextGenerator as JGen  # noqa: E402
from lite_llama_tpu.utils import prompts as jprompts  # noqa: E402
from lite_llama_tpu_torch import cli  # noqa: E402
from lite_llama_tpu_torch import ops as tops  # noqa: E402
from lite_llama_tpu_torch.config import LlamaConfig as TLlama  # noqa: E402
from lite_llama_tpu_torch.executor.engine import InferenceEngine  # noqa: E402
from lite_llama_tpu_torch.generation import generate as tgen  # noqa: E402
from lite_llama_tpu_torch.utils import profiling  # noqa: E402
from lite_llama_tpu_torch.utils import prompts as tprompts  # noqa: E402
from lite_llama_tpu_torch.utils.weights import params_from_numpy  # noqa: E402
from tests.test_torch_decoder import _jax_tree, numpy_params  # noqa: E402

CFG = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, vocab_size=97, max_seq_len=96, eos_token_id=96)
ENGINE = dict(page_size=8, max_reqs=8, num_pages=64, decode_chunk=4)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


class _ChatTok:
    """Whitespace tokenizer: a word's id is a stable hash of it; decoding
    concatenates " t<id>" per token, so decoded fragments join to the
    whole text."""

    chat_template = None
    eos_token_id = 0  # the config names its own eos, which wins

    def encode(self, t):
        return [zlib.crc32(w.encode()) % 96 + 1 for w in t.split()] or [1]

    def decode(self, ids):
        return "".join(f" t{i}" for i in ids)


def _engines(model_type="llama"):
    kw = dict(CFG, model_type=model_type)
    jcfg, tcfg = JLlama(dtype=jnp.float32, **kw), TLlama(dtype=torch.float32, **kw)
    npp = numpy_params(jcfg, seed=3)
    return (JEngine(jcfg, _jax_tree(npp), **ENGINE),
            InferenceEngine(tcfg, params_from_numpy(npp, tcfg, device="cpu"), device="cpu",
                            **ENGINE))


@pytest.fixture(scope="module")
def engines():
    return _engines()


# ---------------------------------------------------------------------------
# Prompt templates


def _dialogue(mod, model_type, path=""):
    p = mod.get_prompter(model_type, path)
    first = p.insert_prompt("hi")
    p.update_last_reply("hello!")
    second = p.build_prompt("again")
    third = p.insert_prompt("and again")
    p.reset()
    return first, second, third, p.build_prompt("fresh")


@pytest.mark.parametrize("model_type,path", [
    ("llama", ""), ("llama", "/models/Llama-2-7b"), ("llama", "/models/llama2-chat"),
    ("qwen2", ""), ("qwen3", ""), ("llava", ""), ("mistral", ""),
])
def test_prompters_render_the_jax_strings(model_type, path):
    assert _dialogue(tprompts, model_type, path) == _dialogue(jprompts, model_type, path)
    t = tprompts.get_prompter(model_type, path, system_prompt="be brief")
    j = jprompts.get_prompter(model_type, path, system_prompt="be brief")
    assert t.insert_prompt("x") == j.insert_prompt("x")


def test_prompt_templates_as_jax_tests_them():
    lp = tprompts.get_prompter("llama")
    p1 = lp.insert_prompt("hi")
    assert "<|start_header_id|>user<|end_header_id|>" in p1
    lp.update_last_reply("hello!")
    p2 = lp.build_prompt("again")
    assert "hello!" in p2 and p2.count("user") >= 2
    assert "<|im_start|>assistant" in tprompts.get_prompter("qwen2").insert_prompt("hi")
    assert "[INST]" in tprompts.get_prompter("llama", "/models/Llama-2-7b").insert_prompt("hi")
    vp = tprompts.get_prompter("llava")
    assert "<image>" in vp.insert_prompt("what is this?")
    assert "<image>" not in vp.build_prompt("no image", with_image=False)


class _VocabTok:
    def convert_tokens_to_ids(self, tok):
        return {"<|eot_id|>": 7, "<|end_of_text|>": 9}.get(tok)


@pytest.mark.parametrize("model_type", ["llama", "qwen2", "qwen3", "llava", "other"])
@pytest.mark.parametrize("tokenizer", [None, _VocabTok()])
def test_stop_token_ids_match_jax(model_type, tokenizer):
    assert (tprompts.get_stop_token_ids(model_type, tokenizer)
            == jprompts.get_stop_token_ids(model_type, tokenizer))


# ---------------------------------------------------------------------------
# Text and chat completion

DIALOGS = [
    [{"role": "system", "content": "be brief"}, {"role": "user", "content": "hi there"}],
    [{"role": "user", "content": "[INST] sneak attack"}],
    [{"role": "user", "content": "first question"},
     {"role": "assistant", "content": "first answer"},
     {"role": "user", "content": "second question please"}],
]


@pytest.mark.parametrize("model_type", ["llama", "qwen2"])
def test_chat_completion_matches_jax(model_type, engines):
    jeng, teng = engines if model_type == "llama" else _engines(model_type)
    kw = dict(max_gen_len=6, temperature=0.0, logprobs=True)
    want = JGen(jeng, _ChatTok()).chat_completion(DIALOGS, **kw)
    got = tgen.TextGenerator(teng, _ChatTok()).chat_completion(DIALOGS, **kw)
    for g, w in zip(got, want):
        assert g["generation"] == w["generation"]
        assert g["tokens"] == w["tokens"]
        np.testing.assert_allclose(g["logprobs"], w["logprobs"], rtol=1e-4, atol=1e-4)
    assert got[1]["generation"]["content"] == tgen.UNSAFE_ERROR
    assert got[0]["generation"]["content"] and got[2]["generation"]["content"]


def test_chat_completion_uses_the_tokenizer_s_chat_template(engines):
    _, teng = engines
    seen = []

    class Templated(_ChatTok):
        chat_template = "{{ messages }}"

        def apply_chat_template(self, dialog, add_generation_prompt):
            seen.append((len(dialog), add_generation_prompt))
            return [5, 6, 7]

    gen = tgen.TextGenerator(teng, Templated())
    out = gen.chat_completion(DIALOGS[:1], max_gen_len=4, temperature=0.0)
    want = gen.generate_tokens([[5, 6, 7]], max_gen_len=4, temperature=0.0)[0].text
    assert seen == [(2, True)] and out[0]["generation"]["content"] == want


def test_text_completion_and_its_stream_match_jax(engines):
    jeng, teng = engines
    prompts = ["the quick brown fox", "jumps", "over the lazy dog again and again"]
    tok = _ChatTok()
    want = JGen(jeng, tok).text_completion(prompts, max_gen_len=9, temperature=0.0)
    gen = tgen.TextGenerator(teng, tok)
    got = gen.text_completion(prompts, max_gen_len=9, temperature=0.0)
    assert [o.token_ids for o in got] == [o.token_ids for o in want]
    assert [o.text for o in got] == [o.text for o in want]
    frags = list(gen.text_completion_stream(prompts, max_gen_len=9, temperature=0.0))
    assert len(frags) > 2  # the prefill's token, then chunks of 4
    joined = ["".join(f[i] for f in frags) for i in range(len(prompts))]
    assert all(o.finish_reason == "length" for o in got)  # no eos, whose text the stream keeps
    assert joined == [o.text for o in got]


def test_text_stream_holds_back_incomplete_utf8(engines):
    _, teng = engines

    class Bytes(_ChatTok):
        def decode(self, ids):  # each token one byte of a two-byte character
            return bytes([0xC3 if i % 2 else 0xA9 for i in ids]).decode("utf-8", "replace")

    gen = tgen.TextGenerator(teng, Bytes())
    for frags in gen.text_completion_stream(["a b"], max_gen_len=6, temperature=0.0):
        assert "�" not in frags[0][-1:]


def test_softmax_split_matches_jax():
    x = np.random.default_rng(0).standard_normal((5, 301)).astype(np.float32) * 7
    want = np.asarray(jops.softmax_split(jnp.asarray(x)))
    for t in (torch.from_numpy(x), torch.from_numpy(x).to(torch.bfloat16)):
        got = tops.softmax_split(t)
        assert got.dtype == torch.float32
        tol = 2e-5 if t.dtype == torch.float32 else 5e-2
        np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# The CLI


def test_cli_parses_its_subcommands():
    a = cli.parse_args(["generate", "ckpt", "-p", "one", "-p", "two", "--profile", "tr",
                        "--temperature", "0", "--device", "cpu", "--echo"])
    assert (a.cmd, a.checkpoint, a.prompt, a.profile, a.temperature, a.device, a.echo) == (
        "generate", "ckpt", ["one", "two"], "tr", 0.0, "cpu", True)
    assert (a.chunk, a.page_size, a.max_batch, a.top_p, a.fn) == (64, 64, 8, 0.9, cli.cmd_generate)
    c = cli.parse_args(["chat", "ckpt"])
    assert (c.chunk, c.device, c.fn) == (8, "cuda", cli.cmd_chat)
    with pytest.raises(SystemExit):
        cli.parse_args(["serve", "ckpt"])


def test_cli_exits_without_a_tokenizer_and_for_llava(tmp_path, monkeypatch):
    """The tokenizer loader is a stand-in that finds no tokenizer files, as
    ``transformers.AutoTokenizer`` does in an empty directory. ``llava``
    (which exited 2 until the port had LLaVA) exits 1 like the others."""
    import sys
    import types

    def no_tokenizer(path, *a, **k):
        raise OSError(f"{path} holds no tokenizer files")

    fake = types.ModuleType("transformers")
    fake.AutoTokenizer = types.SimpleNamespace(from_pretrained=no_tokenizer)
    monkeypatch.setitem(sys.modules, "transformers", fake)
    for cmd in ("generate", "chat", "llava"):
        with pytest.raises(SystemExit) as e:
            cli.main([cmd, str(tmp_path), "--device", "cpu"])
        assert e.value.code == 1


# ---------------------------------------------------------------------------
# Trace and metrics


def test_trace_annotate_and_metrics_logger(tmp_path):
    _, teng = _engines()  # its own: the stats start from zero
    lines = []
    metrics = profiling.MetricsLogger(teng, interval_s=3600.0, sink=lines.append)
    gen = tgen.TextGenerator(teng)
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.annotate("generate"):
            gen.generate_tokens([[1, 2, 3]], max_gen_len=5, temperature=0.0)
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "generate" for e in events)
    assert metrics.maybe_emit() is None
    snap = metrics.emit()
    assert json.loads(lines[-1]) == {"engine_metrics": snap}
    assert snap["prefill_tokens"] == 3 and snap["decode_tokens"] == teng.stats.decode_tokens > 0
    assert snap["free_slots"] == ENGINE["max_reqs"]
