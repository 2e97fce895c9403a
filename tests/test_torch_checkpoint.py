"""Checkpoint loading and the offline converter of the port
(``utils/safetensors_io.py``, ``utils/weights.py``, ``convert.py``,
``InferenceEngine.build``) against safetensors, HF transformers and the JAX
package, on the CPU:

1. the port's safetensors reader and writer against ``safetensors.torch``,
   bit for bit in both directions (file bytes too), for bf16 / fp16 / fp32
   / int8 / fp8 tensors, one file and shards with an index;
2. tiny HF llama / qwen2 / qwen3 models written by ``save_pretrained``: the
   port's ``load_hf_checkpoint`` equals its ``convert_hf_state_dict`` of the
   model's state dict and the JAX package's ``load_hf_checkpoint`` of the
   same directory, bit for bit; a bf16 checkpoint loads to the same bits as
   the fp32 numpy path did;
3. ``InferenceEngine.build`` of a directory gives the JAX engine's greedy
   tokens, from an HF directory and from a converted one;
4. converted checkpoints written by either package load in the other (fp32),
   and ``python -m lite_llama_tpu_torch.convert`` (through ``main``) writes
   the tree ``convert_hf_state_dict`` gives.
"""

import json
import os

import numpy as np
import pytest

os.environ.setdefault("USE_TF", "0")  # transformers without TensorFlow

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lite_llama_tpu import config as jconfig  # noqa: E402
from lite_llama_tpu.executor.engine import InferenceEngine as JEngine  # noqa: E402
from lite_llama_tpu.generation.generate import TextGenerator as JGen  # noqa: E402
from lite_llama_tpu.utils import weights as jw  # noqa: E402
from lite_llama_tpu_torch import config as tconfig  # noqa: E402
from lite_llama_tpu_torch import convert as tconvert  # noqa: E402
from lite_llama_tpu_torch.executor.engine import InferenceEngine  # noqa: E402
from lite_llama_tpu_torch.generation.generate import TextGenerator  # noqa: E402
from lite_llama_tpu_torch.utils import safetensors_io as sio  # noqa: E402
from lite_llama_tpu_torch.utils import weights as tw  # noqa: E402

TINY = dict(hidden_size=64, intermediate_size=112, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=128,
            max_position_embeddings=64)
MODELS = {  # case -> (model_type, tied, extra HF config fields)
    "llama-tied": ("llama", True, {"rope_theta": 10000.0}),
    "qwen2-untied": ("qwen2", False, {}),
    "qwen3": ("qwen3", True, {"head_dim": 16}),
}
ENGINE = dict(page_size=8, max_reqs=4, num_pages=32, decode_chunk=4)
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21]]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _hf_model(model_type, tie, extra, dtype=torch.float32):
    torch.manual_seed(0)
    cfg_cls, model_cls = {
        "llama": (transformers.LlamaConfig, transformers.LlamaForCausalLM),
        "qwen2": (transformers.Qwen2Config, transformers.Qwen2ForCausalLM),
        "qwen3": (transformers.Qwen3Config, transformers.Qwen3ForCausalLM),
    }[model_type]
    model = model_cls(cfg_cls(**TINY, tie_word_embeddings=tie, **extra)).eval()
    with torch.no_grad():  # norms and biases away from their init, so each one counts
        for name, p in model.named_parameters():
            if p.ndim == 1:
                p.add_(torch.randn(p.shape) * 0.1)
    return model.to(dtype)


def _hf_dir(tmp_path, case, dtype=torch.float32, **save_kw):
    model = _hf_model(*MODELS[case], dtype=dtype)
    d = str(tmp_path / f"hf-{case}")
    model.save_pretrained(d, **save_kw)
    return model, d


def _same_tree(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _same_tree(got[k], want[k])
        else:
            w = want[k] if isinstance(want[k], torch.Tensor) else torch.from_numpy(
                np.asarray(want[k]))
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            assert torch.equal(got[k], w), k


# ---------------------------------------------------------------------------
# 1. The safetensors reader and writer


def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w.bf16": torch.randn(5, 7, generator=g).to(torch.bfloat16),
        "w.fp16": torch.randn(3, 4, generator=g).to(torch.float16),
        "w.fp32": torch.randn(6, generator=g),
        "q.int8": torch.randint(-128, 128, (9, 3), generator=g, dtype=torch.int8),
        "q.fp8": torch.randn(11, generator=g).to(torch.float8_e4m3fn),
        "a.bf16": torch.randn(1, generator=g).to(torch.bfloat16),  # after 11 one-byte values
        "s.scalar": torch.tensor(3.5),
    }


def _bits(t):
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _same_tensors(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(_bits(got[k]), _bits(want[k])), k


@pytest.mark.parametrize("metadata", [None, {"format": "pt"}])
def test_safetensors_writer_writes_the_library_s_bytes(tmp_path, metadata):
    t = _tensors()
    ours, theirs = str(tmp_path / "ours.safetensors"), str(tmp_path / "theirs.safetensors")
    sio.save_file(t, ours, metadata)
    safetensors_torch.save_file(t, theirs, metadata)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    _same_tensors(safetensors_torch.load_file(ours), t)


def test_safetensors_reader_reads_the_library_s_files(tmp_path):
    t = _tensors(1)
    path = str(tmp_path / "x.safetensors")
    safetensors_torch.save_file(t, path, {"format": "pt"})
    got = sio.load_file(path)
    _same_tensors(got, t)
    header, meta, _ = sio.read_header(path)
    assert meta == {"format": "pt"} and set(header) == set(t)


def test_sharded_checkpoint_with_an_index(tmp_path):
    t = {f"layers.{i}.w": torch.randn(64, 32).to(torch.bfloat16) for i in range(5)}
    t["embed"] = torch.randn(100, 32)
    files = sio.save_sharded(t, str(tmp_path), max_shard_bytes=3 * 64 * 32 * 2)
    assert len(files) == 3
    with open(tmp_path / sio.INDEX_FILE) as f:
        index = json.load(f)
    assert set(index["weight_map"]) == set(t)
    assert index["metadata"]["total_size"] == sum(v.numel() * v.element_size() for v in t.values())
    lib = {}
    for path in files:
        lib.update(safetensors_torch.load_file(path))
    _same_tensors(lib, t)
    _same_tensors(tw.load_hf_safetensors(str(tmp_path), device="cpu"), t)
    # An HF directory sharded by transformers reads the same way.
    model, d = _hf_dir(tmp_path, "llama-tied", max_shard_size="40KB")
    assert os.path.exists(os.path.join(d, sio.INDEX_FILE))
    _same_tensors(tw.load_hf_safetensors(d, device="cpu"),
                  {k: v for k, v in model.state_dict().items() if k != "lm_head.weight"})


# ---------------------------------------------------------------------------
# 2. HF directories -> engine trees


def _configs(d, dtype=None):
    tdt = dtype or torch.float32
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[tdt]
    return tconfig.load_config(d, dtype=tdt), jconfig.load_config(d, dtype=jdt)


@pytest.mark.parametrize("case", list(MODELS))
def test_load_hf_checkpoint_matches_convert_and_jax(tmp_path, case):
    model, d = _hf_dir(tmp_path, case)
    tcfg, jcfg = _configs(d)
    got = tw.load_hf_checkpoint(d, tcfg, device="cpu")
    _same_tree(got, tw.convert_hf_state_dict(model.state_dict(), tcfg, device="cpu"))
    jtree = jax.tree_util.tree_map(np.asarray, jw.load_hf_checkpoint(d, jcfg))
    _same_tree(got, tw.params_from_numpy(jtree, tcfg, device="cpu"))


@pytest.mark.parametrize("case", ["llama-tied", "qwen2-untied"])
def test_bf16_checkpoint_loads_to_the_fp32_numpy_path_s_bits(tmp_path, case):
    """A bf16 checkpoint goes to the device in bf16 and is cast once; the
    old path widened every leaf to fp32 numpy first. The bits agree."""
    model, d = _hf_dir(tmp_path, case, dtype=torch.bfloat16)
    tcfg, jcfg = _configs(d, torch.bfloat16)
    got = tw.load_hf_checkpoint(d, tcfg, device="cpu")
    sd32 = {k: v.float().numpy() for k, v in model.state_dict().items()}
    jcfg32 = jconfig.load_config(d, dtype=jnp.float32)
    prefix = "model."
    old = jax.tree_util.tree_map(np.asarray, jw.convert_hf_state_dict(sd32, jcfg32, prefix))
    _same_tree(got, tw.params_from_numpy(old, tcfg, device="cpu"))
    assert got["embed"].dtype == torch.bfloat16


def test_llava_checkpoints_are_refused(tmp_path):
    """LLaVA checkpoints were refused until the port had LLaVA; now an HF
    LLaVA directory loads to the JAX loader's tree, bit for bit (the tiny
    models of tests/test_torch_llava.py). ``save_pretrained`` writes only
    the text fields that differ from transformers' defaults, so the JAX
    package reads the config with its own defaults (tied embeddings: no
    lm_head); the JAX side is given the full config."""
    from tests.test_torch_llava import configs, hf_llava, same_tree

    d = str(tmp_path / "llava")
    hf_llava().save_pretrained(d, safe_serialization=True)
    tcfg = tconfig.load_config(d, dtype=torch.float32)
    jcfg = configs()[0]
    for f in ("hidden_size", "num_hidden_layers", "tie_word_embeddings", "rms_norm_eps"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert jconfig.load_config(d).tie_word_embeddings != tcfg.tie_word_embeddings
    got = tw.load_hf_checkpoint(d, tcfg, device="cpu")
    assert set(got) == {"lm", "vision", "projector"}
    want = jax.tree_util.tree_map(np.asarray, jw.load_hf_checkpoint(d, jcfg))
    same_tree(got, tw.params_from_numpy(want, tcfg, device="cpu"))


# ---------------------------------------------------------------------------
# 3. InferenceEngine.build


def _greedy_tokens(engine, gen_cls):
    return [o.token_ids for o in gen_cls(engine).generate_tokens(
        PROMPTS, max_gen_len=8, temperature=0.0)]


@pytest.mark.parametrize("case", ["llama-tied", "qwen2-untied"])
def test_build_gives_the_jax_engine_s_greedy_tokens(tmp_path, case):
    model, d = _hf_dir(tmp_path, case)
    conv = str(tmp_path / "converted")
    tconvert.convert_checkpoint(d, conv, torch.float32, device="cpu")
    want = _greedy_tokens(JEngine.build(d, dtype=jnp.float32, max_seq_len=64, **ENGINE), JGen)
    for src in (d, conv):
        eng = InferenceEngine.build(src, dtype=torch.float32, max_seq_len=64, device="cpu",
                                    **ENGINE)
        assert eng.load_stats["converted"] == (src == conv)
        assert eng.load_stats["bytes"] > 0 and eng.load_stats["ready_s"] >= eng.load_stats["read_s"]
        assert _greedy_tokens(eng, TextGenerator) == want, src


def test_build_and_convert_need_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs its absence")
    _, d = _hf_dir(tmp_path, "llama-tied")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine.build(d)
    with pytest.raises(RuntimeError, match="CUDA"):
        tconvert.convert_checkpoint(d, str(tmp_path / "out"))


# ---------------------------------------------------------------------------
# 4. The converted format across the packages


def test_converted_checkpoints_cross_between_the_packages(tmp_path):
    model, d = _hf_dir(tmp_path, "qwen2-untied")
    tcfg, jcfg = _configs(d)
    jparams = jw.convert_hf_state_dict(model.state_dict(), jcfg)
    tparams = tw.convert_hf_state_dict(model.state_dict(), tcfg, device="cpu")
    # JAX writes, the port reads.
    jw.save_converted(jparams, jcfg, str(tmp_path / "from_jax"))
    _same_tree(tw.load_converted(str(tmp_path / "from_jax"), dtype=torch.float32, device="cpu"),
               tparams)
    # The port writes, JAX reads.
    tw.save_converted(tparams, tcfg, str(tmp_path / "from_torch"))
    back = jw.load_converted(str(tmp_path / "from_torch"), dtype=jnp.float32)
    _same_tree(tparams, jax.tree_util.tree_map(np.asarray, back))
    # The configs round-trip through both load_config functions.
    for out in ("from_jax", "from_torch"):
        t2, j2 = _configs(str(tmp_path / out))
        assert t2.model_type == j2.model_type == "qwen2"
        assert vars(t2) == {**vars(tcfg)}
        assert {k: v for k, v in vars(j2).items() if k != "dtype"} == {
            k: v for k, v in vars(jcfg).items() if k != "dtype"}


def test_convert_main_writes_the_converted_tree(tmp_path):
    model, d = _hf_dir(tmp_path, "qwen3")
    for name in ("tokenizer.json", "tokenizer_config.json"):  # copied beside the weights
        (tmp_path / f"hf-qwen3/{name}").write_text("{}")
    out = str(tmp_path / "out")
    tconvert.main([d, out, "--dtype", "fp32", "--device", "cpu"])
    assert tw.is_converted_checkpoint(out) and not tw.is_converted_checkpoint(d)
    assert os.path.exists(os.path.join(out, "tokenizer.json"))
    tcfg = tconfig.load_config(d, dtype=torch.float32)
    _same_tree(tw.load_converted(out, device="cpu"),
               tw.convert_hf_state_dict(model.state_dict(), tcfg, device="cpu"))
    assert tconfig.load_config(out).qk_norm is True
