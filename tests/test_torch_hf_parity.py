"""The port against HuggingFace transformers (torch, CPU): a tiny HF model
built from config with random init goes through the port's
``convert_hf_state_dict``, and the port's prefill and step-by-step paged
decode logits agree with HF's in fp32 (the tolerances of
tests/test_hf_parity.py, which holds the JAX package to the same models)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

from lite_llama_tpu_torch.config import LlamaConfig, Qwen2Config, Qwen3Config  # noqa: E402
from lite_llama_tpu_torch.executor.kv_cache import (  # noqa: E402
    alloc_decode,
    alloc_prefill,
    create_kv_cache,
)
from lite_llama_tpu_torch.models.decoder import (  # noqa: E402
    AttnContext,
    decoder_decode,
    decoder_prefill,
)
from lite_llama_tpu_torch.utils.weights import convert_hf_state_dict  # noqa: E402

TINY = dict(hidden_size=64, intermediate_size=112, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=128,
            max_position_embeddings=64)
LLAMA3_ROPE = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0, "original_max_position_embeddings": 32}
CASES = {
    "llama-tied": ("llama", True, {}),
    "llama-untied": ("llama", False, {}),
    "llama3-rope": ("llama", True, {"rope_scaling": LLAMA3_ROPE}),
    "qwen2": ("qwen2", True, {}),
    "qwen3": ("qwen3", False, {"head_dim": 16}),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def build_hf(model_type, tie, extra):
    torch.manual_seed(0)
    hf_cls, cfg_cls, ours_cls = {
        "llama": (transformers.LlamaForCausalLM, transformers.LlamaConfig, LlamaConfig),
        "qwen2": (transformers.Qwen2ForCausalLM, transformers.Qwen2Config, Qwen2Config),
        "qwen3": (transformers.Qwen3ForCausalLM, transformers.Qwen3Config, Qwen3Config),
    }[model_type]
    kw = dict(TINY, tie_word_embeddings=tie, **extra)
    if model_type == "llama":
        kw["rope_theta"] = 10000.0
    hf_cfg = cfg_cls(**kw)
    model = hf_cls(hf_cfg).eval()
    ours = ours_cls.from_dict(hf_cfg.to_dict(), dtype=torch.float32, max_seq_len=64)
    return model, ours


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_hf(case):
    model, cfg = build_hf(*CASES[case])
    params = convert_hf_state_dict(model.state_dict(), cfg, device="cpu")
    B, S, extra = 2, 7, 3
    rng = np.random.default_rng(0)
    full = rng.integers(0, cfg.vocab_size, size=(B, S + extra))
    with torch.no_grad():
        hf = model(torch.tensor(full)).logits.numpy()

    cache = create_kv_cache(cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim,
                            num_pages=16, page_size=4, max_reqs=B, max_seq_len=32,
                            dtype=torch.float32, device="cpu")
    req = torch.arange(B, dtype=torch.int32)
    lens = torch.full((B,), S, dtype=torch.int32)
    alloc_prefill(cache, req, lens)
    ctx = AttnContext(cache.page_table[req.long()], lens, torch.zeros_like(lens), lens)
    logits, _ = decoder_prefill(params, cfg, cache.kv_pages, ctx,
                                torch.tensor(full[:, :S]))
    np.testing.assert_allclose(logits.numpy(), hf[:, :S], rtol=1e-3, atol=2e-4)

    for t in range(extra):
        alloc_decode(cache, req)
        sl = cache.seq_lens[req.long()]
        ctx = AttnContext(cache.page_table[req.long()], sl, sl - 1, torch.ones_like(sl))
        logits, _ = decoder_decode(params, cfg, cache.kv_pages, ctx,
                                   torch.tensor(full[:, S + t]))
        np.testing.assert_allclose(logits.numpy(), hf[:, S + t], rtol=1e-3, atol=2e-4,
                                   err_msg=f"decode step {t}")
