"""LLaVA generation through the port's engine, generator, scheduler and
checkpoint loaders against the JAX package's on the CPU, at a tiny size
(the shapes of tests/test_llava_generate.py), on the same fp32 weights:

1. greedy tokens of ``LlavaEngine`` + ``LlavaTextGenerator`` (a batch
   mixing image and text prompts) and of text-only prompts through the
   same engine equal JAX's ``LlavaEngine``'s;
2. the multimodal scheduler (text and image requests mixed, the prefix
   cache on) gives JAX's scheduler's tokens and prefix hits, and image
   requests never hit;
3. ``tokenizer_image_token`` and ``text_completion_stream_mm``;
4. ``LlavaEngine.build`` of an HF directory (``save_pretrained``) and of
   the port's converted one gives the in-memory engine's tokens;
5. the refusals: a prompt longer than max_seq_len once expanded, a
   placeholder without pixels, two placeholders, an image without a
   placeholder (scheduler and generator), and a CUDA engine without CUDA;
   the CLI's REPL keeps one image a dialog.
"""

import os

import numpy as np
import pytest

os.environ.setdefault("USE_TF", "0")  # transformers without TensorFlow

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lite_llama_tpu.config import LlavaConfig as JLlava  # noqa: E402
from lite_llama_tpu.executor.llava_engine import LlavaEngine as JEngine  # noqa: E402
from lite_llama_tpu.executor.scheduler import (  # noqa: E402
    ContinuousBatchingScheduler as JScheduler,
)
from lite_llama_tpu.generation.generate import TextGenerator as JText  # noqa: E402
from lite_llama_tpu.generation.llava_generate import (  # noqa: E402
    LlavaTextGenerator as JGen,
    tokenizer_image_token as j_tokenizer_image_token,
)
from lite_llama_tpu.models.llava import init_llava_params  # noqa: E402
from lite_llama_tpu_torch.config import LlavaConfig  # noqa: E402
from lite_llama_tpu_torch.executor.llava_engine import LlavaEngine  # noqa: E402
from lite_llama_tpu_torch.executor.scheduler import ContinuousBatchingScheduler  # noqa: E402
from lite_llama_tpu_torch.generation.generate import TextGenerator  # noqa: E402
from lite_llama_tpu_torch.generation.llava_generate import (  # noqa: E402
    LlavaTextGenerator,
    tokenizer_image_token,
)
from lite_llama_tpu_torch.utils.weights import params_from_numpy  # noqa: E402

IMG_TOK = 120
CFG = dict(
    vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                       num_attention_heads=4, image_size=28, patch_size=14),
    text_config=dict(hidden_size=48, intermediate_size=96, num_hidden_layers=2,
                     num_attention_heads=4, num_key_value_heads=2, vocab_size=128,
                     rms_norm_eps=1e-5, rope_theta=10000.0),
    image_token_index=IMG_TOK, max_seq_len=64, eos_token_id=127,
)
ENGINE = dict(page_size=8, max_reqs=4, num_pages=48, decode_chunk=4)
MM_PROMPTS = [[5, IMG_TOK, 9, 17], [3, IMG_TOK, 4], [1, 2, 3, 4, 5]]  # the last: no image
TEXT_PROMPTS = [[1, 2, 3], [9, 8, 7, 6]]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    """(JAX config, JAX params, port config, port params): one fp32 tree."""
    jcfg = JLlava(dtype=jnp.float32, **CFG)
    tcfg = LlavaConfig(dtype=torch.float32, **CFG)
    tree = jax.tree_util.tree_map(np.asarray, init_llava_params(jcfg, jax.random.PRNGKey(0)))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, jp, tcfg, params_from_numpy(tree, tcfg, device="cpu")


def engines(weights, **kw):
    jcfg, jp, tcfg, tp = weights
    return (JEngine(jcfg, jp, **ENGINE, **kw),
            LlavaEngine(tcfg, tp, device="cpu", **ENGINE, **kw))


def pixels(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 3, 28, 28)).astype(np.float32)


def streamed(gen, prompts, px, max_gen_len=8):
    out = [[] for _ in prompts]
    for new in gen.stream_tokens_multimodal(prompts, px, max_gen_len=max_gen_len,
                                            temperature=0.0):
        for i, ids in enumerate(new):
            out[i].extend(ids)
    return out


def drained(engine):
    """Every slot free, and every page but the prefix cache's."""
    cached = sum(e[0] for e in engine.prefix.entries.values()) if engine.prefix else 0
    assert len(engine._free_slots) == engine.max_reqs
    assert engine._host_free_pages == engine.num_pages - cached == int(engine.cache.free_top)


# ---------------------------------------------------------------------------
# 1. Engine and generator


def test_greedy_multimodal_tokens_match_jax_engine(weights):
    jeng, teng = engines(weights)
    px = pixels(3)
    want = streamed(JGen(jeng), MM_PROMPTS, px)
    got = streamed(LlavaTextGenerator(teng), MM_PROMPTS, px)
    assert got == want
    assert all(1 <= len(t) <= 8 for t in got)
    assert teng.expanded_lens(MM_PROMPTS) == jeng.expanded_lens(MM_PROMPTS) == [7, 6, 5]
    assert teng.stats.prefill_tokens == 18
    drained(teng)


def test_multimodal_prefill_logits_match_jax_engine(weights):
    """The first-token logits and logprobs of the multimodal prefill (JAX
    runs blank images through its tower for the rows without one and its pad
    rows; the port runs the tower on the image rows only)."""
    from lite_llama_tpu.generation.sampling import SamplingParams as JSampling
    from lite_llama_tpu_torch.generation.sampling import SamplingParams

    jeng, teng = engines(weights)
    px = pixels(3, seed=5)
    want = jeng.prefill_multimodal(MM_PROMPTS, px, JSampling.make(3, temperature=0.0),
                                   jeng.admit_requests([20] * 3))
    got = teng.prefill_multimodal(MM_PROMPTS, px,
                                  SamplingParams.make(3, temperature=0.0, device="cpu"),
                                  teng.admit_requests([20] * 3), return_logits=True)
    np.testing.assert_array_equal(got[0], np.asarray(want[0])[:3])
    np.testing.assert_array_equal(got[1], np.asarray(want[1])[:3])
    np.testing.assert_allclose(got[2], np.asarray(want[2])[:3], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[3], np.asarray(want[3])[:3], rtol=1e-4, atol=1e-4)


def test_text_only_prompts_through_llava_engine_match_jax(weights):
    jeng, teng = engines(weights)
    want = [o.token_ids for o in JText(jeng).generate_tokens(TEXT_PROMPTS, max_gen_len=6,
                                                              temperature=0.0)]
    got = [o.token_ids for o in TextGenerator(teng).generate_tokens(TEXT_PROMPTS, max_gen_len=6,
                                                                     temperature=0.0)]
    assert got == want
    drained(teng)


# ---------------------------------------------------------------------------
# 2. The scheduler


def test_multimodal_scheduler_matches_jax_with_the_prefix_cache_on(weights):
    """Text requests share a 16-token prefix (two pages of 8): the first to
    finish registers it and later ones hit. The image requests start with
    the same prefix and never hit: their KV depends on the image."""
    jeng, teng = engines(weights, prefix_cache=True)
    prefix = list(range(20, 36))
    px = pixels(4, seed=2)
    reqs = [  # (prompt, pixel index or None, max_gen_len)
        (prefix + [1, 2], None, 3),
        (prefix + [5, IMG_TOK, 9], 0, 6),
        (prefix + [7, 8, 9], None, 6),
        ([3, IMG_TOK, 4], 1, 5),
        (prefix + [IMG_TOK, 11], 2, 4),
        (prefix + [4, 4], None, 5),
        (prefix + [6, 1, 6], None, 7),
        ([IMG_TOK, 2, 2, 2], 3, 6),
    ]

    def run(sched_cls, engine):
        sched = sched_cls(engine, max_prefill_batch=2)
        ids = [sched.submit(p, max_gen_len=g, temperature=0.0,
                            pixel_values=None if i is None else px[i]) for p, i, g in reqs]
        done = {r.req_id: r for r in sched.run()}
        return [done[i].output_tokens for i in ids], [done[i].finish_reason for i in ids]

    want, _ = run(JScheduler, jeng)
    got, reasons = run(ContinuousBatchingScheduler, teng)
    assert got == want
    assert all(r in ("stop", "length") for r in reasons)
    assert teng.stats.prefix_hits == jeng.stats.prefix_hits >= 2
    assert teng.stats.prefix_hits <= sum(1 for _, i, _ in reqs if i is None) - 1
    drained(teng)


def test_scheduler_rejects_two_placeholders_and_keeps_serving(weights):
    _, teng = engines(weights)
    sched = ContinuousBatchingScheduler(teng)
    bad = sched.submit([1, IMG_TOK, 2, IMG_TOK], max_gen_len=4, pixel_values=pixels(1)[0])
    ok = sched.submit([3, IMG_TOK, 4], max_gen_len=4, temperature=0.0, pixel_values=pixels(1)[0])
    done = {r.req_id: r for r in sched.run()}
    assert done[bad].finish_reason == "rejected_multiple_images"
    assert 1 <= len(done[ok].output_tokens) <= 4
    drained(teng)


def test_scheduler_rejects_an_image_without_a_placeholder_and_keeps_serving(weights):
    """An image whose prompt has no <image> would go unread: rejected, where
    the JAX scheduler serves the prompt as text."""
    _, teng = engines(weights)
    sched = ContinuousBatchingScheduler(teng)
    bad = sched.submit([1, 2, 3], max_gen_len=4, pixel_values=pixels(1)[0])
    ok = sched.submit([3, IMG_TOK, 4], max_gen_len=4, temperature=0.0, pixel_values=pixels(1)[0])
    done = {r.req_id: r for r in sched.run()}
    assert done[bad].finish_reason == "rejected_missing_image_placeholder"
    assert not done[bad].output_tokens
    assert 1 <= len(done[ok].output_tokens) <= 4
    drained(teng)


# ---------------------------------------------------------------------------
# 3. Tokens and text


class CharTokenizer:
    """encode: bos 1, then (ord(c) % 100) + 2 per non-space character;
    decode: one letter per id."""

    eos_token_id = None
    chat_template = None

    def encode(self, s, add_special_tokens=True):
        ids = [ord(c) % 100 + 2 for c in s if not c.isspace()]
        return ([1] if add_special_tokens else []) + ids

    def decode(self, ids):
        return "".join(chr(97 + t % 26) for t in ids)


def test_tokenizer_image_token_matches_jax():
    tok = CharTokenizer()
    for prompt in ("ab <image> cd", "<image>\nwhat is this?", "no image here", "x<image>"):
        got = tokenizer_image_token(prompt, tok, 777)
        assert got == j_tokenizer_image_token(prompt, tok, 777)
        assert got.count(777) == prompt.count("<image>") and got[0] == 1


def test_text_completion_stream_mm_joins_to_the_streamed_tokens(weights, tmp_path):
    from PIL import Image

    from lite_llama_tpu_torch.utils.image import process_images

    _, teng = engines(weights)
    path = tmp_path / "img.png"
    Image.fromarray(np.random.default_rng(1).integers(0, 256, (20, 30, 3), dtype=np.uint8)
                    ).save(path)
    gen = LlavaTextGenerator(teng, CharTokenizer())
    prompt = "USER: <image>\nwhat? ASSISTANT:"
    text = "".join(f[0] for f in gen.text_completion_stream_mm([prompt], [str(path)],
                                                               max_gen_len=6, temperature=0.0))
    ids = tokenizer_image_token(prompt, gen.tokenizer, IMG_TOK)
    toks = streamed(gen, [ids], process_images([str(path)], 28), max_gen_len=6)[0]
    assert text == gen.tokenizer.decode(toks) and len(text) >= 1
    drained(teng)


def test_text_completion_stream_mm_refuses_an_image_without_a_placeholder(weights):
    _, teng = engines(weights)
    gen = LlavaTextGenerator(teng, CharTokenizer())
    with pytest.raises(ValueError, match="placeholder"):
        next(gen.text_completion_stream_mm(["USER: what? ASSISTANT:"], ["unread.png"]))
    drained(teng)


def test_cli_llava_keeps_one_image_a_dialog(monkeypatch, capsys):
    """The REPL sends a dialog's image with each of its turns, its <image>
    in the first turn; an image attached after the first turn starts a new
    dialog. The engine is a stand-in that records each prompt."""
    import builtins

    from lite_llama_tpu_torch import cli
    from lite_llama_tpu_torch.utils import image as timage
    from lite_llama_tpu_torch.utils.prompts import get_prompter

    calls = []

    class Gen:
        def text_completion_stream(self, prompts, **kw):
            calls.append((prompts[0], None))
            yield ["ok"]

        def text_completion_stream_mm(self, prompts, images, **kw):
            calls.append((prompts[0], images[0]))
            yield ["ok"]

    lines = iter(["hello", "/image a.png", "what is it?", "and now?", "/image b.png",
                  "second", "exit"])
    monkeypatch.setattr(builtins, "input", lambda *_: next(lines))
    monkeypatch.setattr(timage, "vis_images", lambda paths: None)
    monkeypatch.setattr(cli, "_build", lambda args, llava=False: (None, Gen(),
                                                                  get_prompter("llava")))
    cli.main(["llava", "unused", "--device", "cpu"])
    assert [img for _, img in calls] == [None, "a.png", "a.png", "b.png"]
    assert "<image>" not in calls[0][0]
    assert all(p.count("<image>") == 1 for p, _ in calls[1:])
    assert "hello" not in calls[1][0] and "USER: <image>\nwhat is it?" in calls[1][0]
    assert "USER: <image>\nwhat is it?" in calls[2][0] and "and now?" in calls[2][0]
    assert "what is it?" not in calls[3][0] and "USER: <image>\nsecond" in calls[3][0]
    assert capsys.readouterr().out.count("starting a new dialog") == 2


# ---------------------------------------------------------------------------
# 4. Checkpoints on disk


def test_build_from_hf_and_converted_dirs_gives_the_in_memory_tokens(tmp_path):
    transformers = pytest.importorskip("transformers")
    from lite_llama_tpu_torch import convert as tconvert
    from lite_llama_tpu_torch.config import load_config
    from lite_llama_tpu_torch.utils.weights import params_from_hf_state_dict

    torch.manual_seed(0)
    vc = {k: v for k, v in CFG["vision_config"].items()}
    hf_cfg = transformers.LlavaConfig(
        vision_config=transformers.CLIPVisionConfig(**vc),
        text_config=transformers.LlamaConfig(**CFG["text_config"]), image_token_index=IMG_TOK,
        image_seq_length=4)
    hf = transformers.LlavaForConditionalGeneration(hf_cfg).eval()
    hf_dir, conv_dir = str(tmp_path / "hf"), str(tmp_path / "converted")
    hf.save_pretrained(hf_dir, safe_serialization=True)
    cfg = load_config(hf_dir, dtype=torch.float32, max_seq_len=64)
    mem = LlavaEngine(cfg, params_from_hf_state_dict(hf.state_dict(), cfg, device="cpu"),
                      device="cpu", **ENGINE)
    px = pixels(3, seed=7)
    want = streamed(LlavaTextGenerator(mem), MM_PROMPTS, px)
    tconvert.convert_checkpoint(hf_dir, conv_dir, torch.float32, device="cpu")
    for src in (hf_dir, conv_dir):
        eng = LlavaEngine.build(src, dtype=torch.float32, max_seq_len=64, device="cpu",
                                **ENGINE)
        assert eng.load_stats["converted"] == (src == conv_dir)
        assert (eng.config.hidden_size, eng.config.vision_config.hidden_size) == (48, 32)
        assert streamed(LlavaTextGenerator(eng), MM_PROMPTS, px) == want, src


# ---------------------------------------------------------------------------
# 5. Refusals


def test_llava_engine_refusals(weights):
    from lite_llama_tpu_torch.executor.engine import InferenceEngine
    from lite_llama_tpu_torch.generation.sampling import SamplingParams

    _, _, tcfg, tp = weights
    _, teng = engines(weights)
    samp = SamplingParams.make(1, temperature=0.0, device="cpu")
    with pytest.raises(ValueError, match="max_seq_len"):
        teng.prefill_multimodal([[IMG_TOK] + [1] * 61], pixels(1), samp, [0])
    with pytest.raises(ValueError, match="pixel values"):
        teng.prefill_multimodal([[1, IMG_TOK]], None, samp, [0])
    with pytest.raises(ValueError, match="image placeholders"):
        teng.expanded_lens([[IMG_TOK, IMG_TOK]])
    with pytest.raises(ValueError, match="LlavaEngine"):
        InferenceEngine(tcfg, tp, device="cpu", **ENGINE)
    with pytest.raises(NotImplementedError):
        LlavaEngine(tcfg, tp, device="cpu", mesh=object(), **ENGINE)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            LlavaEngine(tcfg, tp, **ENGINE)
    drained(teng)


def test_cli_llava_repl_attaches_an_image(tmp_path, monkeypatch, capsys):
    """``python -m lite_llama_tpu_torch.cli llava dir --device cpu``: the
    REPL builds a LlavaEngine from an HF directory, '/image <path>' attaches
    an image to the next message (echoed in the terminal), a plain message
    chats without one."""
    import sys
    import types

    from PIL import Image

    from lite_llama_tpu_torch import cli

    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.LlavaForConditionalGeneration(transformers.LlavaConfig(
        vision_config=transformers.CLIPVisionConfig(**CFG["vision_config"]),
        text_config=transformers.LlamaConfig(**CFG["text_config"]),
        image_token_index=IMG_TOK, image_seq_length=4)).eval()
    d = str(tmp_path / "llava")
    hf.save_pretrained(d, safe_serialization=True)
    img = tmp_path / "img.png"
    Image.new("RGB", (30, 20), (0, 128, 255)).save(img)
    fake = types.ModuleType("transformers")
    fake.AutoTokenizer = types.SimpleNamespace(from_pretrained=lambda path: CharTokenizer())
    monkeypatch.setitem(sys.modules, "transformers", fake)
    lines = iter([f"/image {img}", "what is this", "and now", "exit"])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(lines))
    cli.main(["llava", d, "--device", "cpu", "--max-gen-len", "3", "--page-size", "8"])
    out = capsys.readouterr().out
    assert f"[image attached: {img}]" in out and "[image 30x20]" in out
    assert out.count("assistant> ") == 2
