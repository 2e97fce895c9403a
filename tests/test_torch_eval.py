"""The port's evaluation subsystem (``lite_llama_tpu_torch/eval``,
``validate.py``) against the JAX package on the CPU:

1. metrics and dataset adapters: the cases of tests/test_eval.py, outputs
   equal to the JAX functions' on the same inputs;
2. ``corpus_perplexity`` on test_eval.py's tiny fixture (same numpy
   weights): NLL within 1e-5 of JAX's in fp32 for plain weights, int8
   weights, int8 and fp8 pools, and int4 riffle weights (W4A8, JAX on its
   Pallas path); the score does not depend on the chunk width;
3. ``run_eval`` through the engine-backed harness with a fake tokenizer:
   JAX's scores on the same weights;
4. the validation recipe's dry fixture in process: every gate passes and
   the NLLs are JAX's recipe's within 1e-5.
"""

import importlib.util
import json
import os
import zlib
from pathlib import Path

os.environ.setdefault("USE_TF", "0")  # transformers (the dry fixture) without TensorFlow

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import lite_llama_tpu.eval as jeval  # noqa: E402
import lite_llama_tpu.ops as jops  # noqa: E402
from lite_llama_tpu.config import LlamaConfig as JLlama  # noqa: E402
from lite_llama_tpu.executor.engine import InferenceEngine as JEngine  # noqa: E402
from lite_llama_tpu.generation.generate import TextGenerator as JGen  # noqa: E402
from lite_llama_tpu.quant import qtensor as jq  # noqa: E402
import lite_llama_tpu_torch.eval as teval  # noqa: E402
from lite_llama_tpu_torch import validate as tvalidate  # noqa: E402
from lite_llama_tpu_torch.config import LlamaConfig as TLlama  # noqa: E402
from lite_llama_tpu_torch.executor.engine import InferenceEngine  # noqa: E402
from lite_llama_tpu_torch.generation.generate import TextGenerator  # noqa: E402
from lite_llama_tpu_torch.quant import qtensor as tq  # noqa: E402
from lite_llama_tpu_torch.utils.weights import params_from_numpy  # noqa: E402
from tests.test_torch_decoder import _jax_tree, numpy_params  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIXTURE = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, vocab_size=97, max_seq_len=128)
SEQ_LENS = (60, 40, 33)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# 1. Metrics and datasets

TEXT_PAIRS = [
    ("The  Quick, quick brown FOX!", "quick brown fox"),
    ("a the an", ""),
    ("The Answer", "answer"),
    ("answer one", "answer two"),
    ("paris", "paris"),
    ("tokyo", "paris"),
    ("paris is a large city in northern france", "paris"),
    ("red blue", "blue red"),
    ("", "x"),
    ("he starts playing a song", "He plays a song."),
]
METRICS = ["normalize_answer", "exact_match", "penalized_f1", "jaccard_similarity",
           "embedding_similarity"]


@pytest.mark.parametrize("name", METRICS)
def test_metrics_match_jax(name):
    t, j = getattr(teval, name, None), getattr(jeval, name, None)
    if t is None:
        from lite_llama_tpu.eval import metrics as jm
        from lite_llama_tpu_torch.eval import metrics as tm

        t, j = getattr(tm, name), getattr(jm, name)
    for pred, gt in TEXT_PAIRS:
        if name == "normalize_answer":
            assert t(pred) == j(pred)
        else:
            assert t(pred, gt) == j(pred, gt), (pred, gt)


def test_metrics_as_jax_tests_them():
    assert teval.normalize_answer("The  Quick, quick brown FOX!") == "quick brown fox"
    assert teval.exact_match("The Answer", "answer") == 1.0
    assert teval.penalized_f1("paris is a large city in northern france", "paris") < \
        teval.penalized_f1("paris is", "paris")
    assert teval.jaccard_similarity("", "x") == 0.0
    scores = teval.score_all(["paris"], ["paris"])
    assert set(scores) == {"EM", "F1 (penalized)", "Jaccard", "Embedding Sim"}
    assert scores["EM"] == 1.0 and scores["Embedding Sim"] == pytest.approx(1.0, abs=1e-5)


@pytest.mark.parametrize("text", ["The answer: B", "I pick option c", "A) because ...",
                                  "no letters here at all", "d is correct", "choice: a"])
def test_extract_final_choice_matches_jax(text):
    assert teval.extract_final_choice(text) == jeval.extract_final_choice(text)


def test_scores_and_option_matching_match_jax():
    preds, gts = [p for p, _ in TEXT_PAIRS], [g for _, g in TEXT_PAIRS]
    assert teval.score_all(preds, gts) == jeval.score_all(preds, gts)
    opts = list(zip("ABCD", ["He plays a song.", "He eats it.", "He flies.", "He melts."]))
    assert teval.match_mc_option("he starts playing a song", opts) == \
        jeval.match_mc_option("he starts playing a song", opts)


def test_datasets_match_jax(tmp_path):
    hotpot = [{"question": f"Who wrote book {i}?", "answer": f"Author {i} ",
               "context": [[f"Book {i}", [f"Book {i} was written by author {i}.", "x"]],
                           ["Distractor", ["Unrelated sentence."]]],
               "supporting_facts": [[f"Book {i}", 0], ["Distractor", 5]]} for i in range(5)]
    (tmp_path / "hotpot.json").write_text(json.dumps(hotpot))
    rows = [{"ctx": f"A man sits down at piano {i}.",
             "endings": ["He plays a song.", "He eats it.", "He flies.", "He melts."],
             "label": str(i % 4)} for i in range(4)]
    (tmp_path / "hs.jsonl").write_text("\n".join(json.dumps(r) for r in rows))
    for name, path in (("hotpotqa", "hotpot.json"), ("hellaswag", "hs.jsonl")):
        t = teval.DATASETS[name](str(tmp_path / path), data_batch=3, seed=1)
        j = jeval.DATASETS[name](str(tmp_path / path), data_batch=3, seed=1)
        parsed = t.parse_data()
        assert parsed == j.parse_data()
        gts, prompts, options = parsed
        preds = ["The answer is A", "he starts playing a song", f"author 1 {gts[0]}"]
        if name == "hellaswag":
            assert t.evaluate(preds, gts, options) == j.evaluate(preds, gts, options)
        else:
            assert t.evaluate(preds, gts) == j.evaluate(preds, gts)


# ---------------------------------------------------------------------------
# 2. corpus_perplexity


def _fixture(num_hidden_layers=2, hidden_size=64, head_dim=None, vocab_size=97, scale=1.0):
    """Config, numpy weights (the projections and the embedding times
    ``scale``) and a seeded corpus of random ids."""
    kw = dict(FIXTURE, num_hidden_layers=num_hidden_layers, hidden_size=hidden_size,
              vocab_size=vocab_size)
    if head_dim:
        kw["head_dim"] = head_dim
    jcfg, tcfg = JLlama(dtype=jnp.float32, **kw), TLlama(dtype=torch.float32, **kw)
    npp = numpy_params(jcfg, seed=0)
    npp["embed"] = npp["embed"] * scale
    for k in ("wq", "wkv", "o_proj", "gate_up_proj", "down_proj"):
        npp["layers"][k] = npp["layers"][k] * scale
    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, vocab_size, size=n).tolist() for n in SEQ_LENS]
    return jcfg, tcfg, npp, seqs


PPL = dict(chunk=32, batch_size=2, page_size=8)


@pytest.mark.parametrize("case", ["fp32", "int8_weights", "int8_pool", "fp8_pool"])
def test_corpus_perplexity_matches_jax(case):
    jcfg, tcfg, npp, seqs = _fixture()
    jp, tp = _jax_tree(npp), params_from_numpy(npp, tcfg, device="cpu")
    kv = {"int8_pool": True, "fp8_pool": "fp8"}.get(case, False)
    if case == "int8_weights":
        jp, tp = jq.quantize_decoder_params(jp, jnp.int8), tq.quantize_decoder_params(tp, "int8")
    want = jeval.corpus_perplexity(jcfg, jp, seqs, kv_quant=kv, **PPL)
    got = teval.corpus_perplexity(tcfg, tp, seqs, kv_quant=kv, device="cpu", **PPL)
    assert got["tokens"] == want["tokens"] == sum(n - 1 for n in SEQ_LENS)
    assert abs(got["nll"] - want["nll"]) < 1e-5, (got, want)
    assert got["perplexity"] == pytest.approx(want["perplexity"], rel=1e-5)


def test_corpus_perplexity_int4_riffle_matches_jax_kernel_path(monkeypatch):
    """W4A8 (int4 riffle g32 without σ-FFN) with every projection and the
    head on the W4A8 route (stored widths multiples of 128, at most 256 rows
    a chunk): the port's plain K6 against JAX's Pallas kernel in interpret
    mode, JAX's attention through its XLA references. One layer, as the W4A8
    decoder parity test in tests/test_torch_quant.py: from the second layer
    on, an int8 activation rounding that flips on a 1-ulp difference moves
    a random model's logits by ~1 %, which says nothing about the port.
    Weights at 0.02, the scale of the models' own init (numpy_params draws
    0.1, whose larger logits carry such a flip further)."""
    _int4_perplexity_matches_jax_kernel_path(monkeypatch, riffle=True)


def test_corpus_perplexity_int4_sigma_matches_jax_kernel_path(monkeypatch):
    """The validation recipe's int4 layout, σ-FFN g32 (gate/up in the
    kernel's [evens | odds] order, down's rows pre-permuted), on the same
    W4A8 route as the riffle case above."""
    _int4_perplexity_matches_jax_kernel_path(monkeypatch, sigma_ffn=True)


def _int4_perplexity_matches_jax_kernel_path(monkeypatch, **layout):
    from lite_llama_tpu.ops import ref as jref

    jcfg, tcfg, npp, seqs = _fixture(num_hidden_layers=1, hidden_size=256, head_dim=64,
                                     vocab_size=256, scale=0.2)
    jp = jq.quantize_decoder_params(_jax_tree(npp), jnp.int4, group_size=32, **layout)
    tp = tq.quantize_decoder_params(params_from_numpy(npp, tcfg, device="cpu"), "int4",
                                    group_size=32, **layout)
    calls = []
    real = tq.quantized_matmul_packed
    monkeypatch.setattr(tq, "quantized_matmul_packed",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    chunked = jops.chunked_prefill_attention
    monkeypatch.setattr(jops, "prefill_attention", jref.prefill_attention)
    monkeypatch.setattr(jops, "chunked_prefill_attention",
                        lambda *a, force_ref=False, **k: chunked(*a, force_ref=True, **k))
    prev = jops._BACKEND
    jops.set_backend("pallas")
    try:
        want = jeval.corpus_perplexity(jcfg, jp, seqs, **PPL)
    finally:
        jops.set_backend(prev)
    got = teval.corpus_perplexity(tcfg, tp, seqs, device="cpu", **PPL)
    # wqkv (riffle fuses it; σ keeps wq and wkv), o_proj, gate_up, down and
    # the head, each chunk of each batch
    assert len(calls) == (5 if layout.get("riffle") else 6) * 4
    assert abs(got["nll"] - want["nll"]) < 1e-5, (got, want)


def test_corpus_perplexity_does_not_depend_on_the_chunk_width():
    _, tcfg, npp, seqs = _fixture()
    tp = params_from_numpy(npp, tcfg, device="cpu")
    a = teval.corpus_perplexity(tcfg, tp, seqs, device="cpu", **PPL)
    for chunk in (16, 64):
        b = teval.corpus_perplexity(tcfg, tp, seqs, device="cpu", **dict(PPL, chunk=chunk))
        assert b["tokens"] == a["tokens"]
        assert abs(b["nll"] - a["nll"]) <= 1e-6 * abs(a["nll"]), (chunk, a, b)
    last = teval.corpus_perplexity(tcfg, tp, seqs, device="cpu", keep_last_logits=True, **PPL)
    assert last["nll"] == a["nll"] and last["last_logits"].shape == (1, 32, tcfg.vocab_size)


def test_corpus_perplexity_runs_on_the_card_unless_asked():
    _, tcfg, npp, seqs = _fixture()
    tp = params_from_numpy(npp, tcfg, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            teval.corpus_perplexity(tcfg, tp, seqs)
    with pytest.raises(ValueError, match="live on"):
        teval.corpus_perplexity(tcfg, tp, seqs, device="meta")


# ---------------------------------------------------------------------------
# 3. run_eval


class _FakeTokenizer:
    """Whitespace tokenizer with stable ids (crc32, not the salted hash)."""

    eos_token_id = 0

    def encode(self, text):
        return [zlib.crc32(w.encode()) % 97 + 1 for w in text.split()] or [1]

    def decode(self, ids):
        return " ".join(f"t{i}" for i in ids)

    def __call__(self, text, add_special_tokens=False):
        return {"input_ids": self.encode(text)}


def test_run_eval_matches_jax(tmp_path):
    cfg = dict(FIXTURE, head_dim=16, vocab_size=128)
    jcfg, tcfg = JLlama(dtype=jnp.float32, **cfg), TLlama(dtype=torch.float32, **cfg)
    npp = numpy_params(jcfg, seed=0)
    eng = dict(page_size=16, max_reqs=4, num_pages=48, decode_chunk=4)
    jgen = JGen(JEngine(jcfg, _jax_tree(npp), **eng), _FakeTokenizer())
    tgen = TextGenerator(InferenceEngine(tcfg, params_from_numpy(npp, tcfg, device="cpu"),
                                         device="cpu", **eng), _FakeTokenizer())
    harness = dict(temperature=0.0, max_gen_len=6, apply_template=False)
    th = teval.InferenceHarness(generator=tgen, **harness)
    texts, elapsed, tokens = th.inference(tgen, ["hello world", "another prompt"])
    assert len(texts) == 2 and elapsed > 0 and tokens > 0
    rows = [{"ctx": "ctx", "endings": ["one", "two", "three", "four"], "label": "1"}]
    (tmp_path / "hs.jsonl").write_text("\n".join(json.dumps(r) for r in rows))
    items = [{"question": f"Who wrote book {i}?", "answer": f"author {i}",
              "context": [[f"Book {i}", [f"Book {i} was written by author {i}.", "x"]]],
              "supporting_facts": [[f"Book {i}", 0]]} for i in range(5)]
    (tmp_path / "hotpot.json").write_text(json.dumps(items))
    for name, path, kw in (("hellaswag", "hs.jsonl", {}), ("hotpotqa", "hotpot.json",
                                                           {"data_batch": 3})):
        got = teval.run_eval(teval.DATASETS[name](str(tmp_path / path), **kw), th)
        want = jeval.run_eval(jeval.DATASETS[name](str(tmp_path / path), **kw),
                              jeval.InferenceHarness(generator=jgen, **harness))
        assert set(got) == {"EM", "F1 (penalized)", "Jaccard", "Embedding Sim"}
        assert all(0.0 <= v <= 1.0 for v in got.values())
        assert got == pytest.approx(want, abs=1e-6), name


# ---------------------------------------------------------------------------
# 4. The validation recipe


def _jax_recipe():
    spec = importlib.util.spec_from_file_location("jax_validate", REPO / "examples" / "validate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_validate_dry_fixture_in_process(capsys):
    pytest.importorskip("transformers")
    names = "bf16,int8,int8_kv"
    assert tvalidate.main(["--dry-fixture", "--configs", names]) == 0
    last = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")][-1]
    r = json.loads(last)
    assert r["all_pass"] is True
    assert r["configs"]["int8"]["pass"] is True and r["configs"]["int8_kv"]["pass"] is True
    # JAX's recipe on the same fixture (the same HF model through its
    # converter); the quantized configs' parity is corpus_perplexity's above.
    jv = _jax_recipe()
    jcfg, jparams, jseqs = jv._dry_fixture_model()
    want, _ = jv.run_table(jcfg, jparams, jseqs, ["bf16"], chunk=64, batch_size=2)
    assert abs(r["configs"]["bf16"]["nll"] - want["bf16"]["nll"]) < 1e-5


def test_validate_configs_and_tolerances():
    jv = _jax_recipe()
    assert tvalidate.TOLERANCES == jv.TOLERANCES
    configs = tvalidate._configs(list(jv.TOLERANCES))
    assert list(configs) == list(jv.TOLERANCES)
    with pytest.raises(ValueError):
        tvalidate._configs(["int3"])
    # The int4 rows take the JAX recipe's layout, σ-FFN g128 (examples/validate.py).
    rng = np.random.default_rng(0)
    tree = {"layers": {"gate_up_proj": rng.standard_normal((1, 2, 128, 256)).astype(np.float32),
                       "down_proj": rng.standard_normal((1, 256, 128)).astype(np.float32)},
            "embed": rng.standard_normal((8, 128)).astype(np.float32)}
    want = jq.quantize_decoder_params(_jax_tree(tree), jnp.int4, group_size=128,
                                      sigma_ffn=True)
    for name in ("int4", "int4_int8kv"):
        got = configs[name][0]({"layers": {k: torch.from_numpy(a)
                                           for k, a in tree["layers"].items()},
                                "embed": torch.from_numpy(tree["embed"])})
        for key in ("gate_up_proj", "down_proj"):
            g, w = got["layers"][key], want["layers"][key]
            assert (g.sigma_out, g.sigma_in, g.sigma_groups) == (w.sigma_out, w.sigma_in,
                                                                 w.sigma_groups)
            np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q))
            np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale))
