"""The port's decoder against the JAX decoder on the CPU: the same numpy
parameters (through ``params_from_numpy``) and tokens give prefill and
decode logits within 1e-4 in fp32, for tiny llama (tied, untied, D=64),
qwen2 (biases, untied) and qwen3 (qk-norm, decoupled head_dim) configs, and
the paged pools agree after the deferred decode writes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from lite_llama_tpu import config as jconfig  # noqa: E402
from lite_llama_tpu.executor import kv_cache as jkv  # noqa: E402
from lite_llama_tpu.models import decoder as jdec  # noqa: E402
from lite_llama_tpu_torch import config as tconfig  # noqa: E402
from lite_llama_tpu_torch.executor import kv_cache as tkv  # noqa: E402
from lite_llama_tpu_torch.models import decoder as tdec  # noqa: E402
from lite_llama_tpu_torch.models.presets import PRESETS as T_PRESETS  # noqa: E402
from lite_llama_tpu_torch.utils.weights import convert_hf_state_dict, params_from_numpy  # noqa: E402
from lite_llama_tpu.models.presets import PRESETS as J_PRESETS  # noqa: E402

TOL = 1e-4
PS, NPAGES, MAXR = 4, 40, 4

CASES = {
    "llama_tied": ("LlamaConfig", dict(head_dim=16, tie_word_embeddings=True,
                                       rope_scaling={"rope_type": "llama3", "factor": 8.0,
                                                     "original_max_position_embeddings": 16})),
    "llama_untied": ("LlamaConfig", dict(head_dim=16, tie_word_embeddings=False)),
    "llama_d64": ("LlamaConfig", dict(head_dim=64)),  # Llama-3.2-1B's head dim
    "qwen2": ("Qwen2Config", dict(head_dim=16)),
    "qwen3": ("Qwen3Config", dict(head_dim=32)),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _configs(name):
    cls, kw = CASES[name]
    base = dict(hidden_size=64, intermediate_size=96, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, vocab_size=101,
                max_seq_len=32, **kw)
    return (getattr(jconfig, cls)(dtype=jnp.float32, **base),
            getattr(tconfig, cls)(dtype=torch.float32, **base))


def numpy_params(cfg, seed=0):
    """Random tree in the layout of init_decoder_params, with non-trivial
    norms and biases so every branch contributes."""
    rng = np.random.default_rng(seed)
    L, H, D = cfg.num_hidden_layers, cfg.hidden_size, cfg.head_dim
    Nq, Nkv, I, V = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.intermediate_size, cfg.vocab_size)

    def w(*s, scale=0.1):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    def norm(*s):
        return (1.0 + rng.standard_normal(s) * 0.1).astype(np.float32)

    layers = {"attn_norm": norm(L, H), "wq": w(L, H, Nq, D), "wkv": w(L, H, 2, Nkv, D),
              "o_proj": w(L, Nq, D, H), "mlp_norm": norm(L, H),
              "gate_up_proj": w(L, 2, H, I), "down_proj": w(L, I, H)}
    if cfg.attention_bias:
        layers["q_bias"] = w(L, Nq, D)
        layers["kv_bias"] = w(L, 2, Nkv, D)
    if getattr(cfg, "qk_norm", False):
        layers["q_norm"] = norm(L, D)
        layers["k_norm"] = norm(L, D)
    params = {"embed": w(V, H, scale=0.5), "layers": layers, "final_norm": norm(H)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = w(H, V)
    return params


def _jax_tree(tree):
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _close(got, want, tol=TOL, **kw):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(want), rtol=tol, atol=tol, **kw)


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_and_decode_logits_match_jax(name):
    jcfg, tcfg = _configs(name)
    npp = numpy_params(jcfg)
    jp, tp = _jax_tree(npp), params_from_numpy(npp, tcfg, device="cpu")
    jc = jkv.create_kv_cache(2, 2, jcfg.head_dim, NPAGES, page_size=PS, max_reqs=MAXR,
                             max_seq_len=32, dtype=jnp.float32)
    tc = tkv.create_kv_cache(2, 2, tcfg.head_dim, NPAGES, page_size=PS, max_reqs=MAXR,
                             max_seq_len=32, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(1)
    lens = np.asarray([7, 12], np.int32)
    ids = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    slots = np.asarray([1, 3], np.int32)
    jc = jkv.alloc_prefill(jc, jnp.asarray(slots), jnp.asarray(lens))
    tkv.alloc_prefill(tc, torch.from_numpy(slots), torch.from_numpy(lens))
    jctx = jdec.AttnContext(jc.page_table[jnp.asarray(slots)], jnp.asarray(lens),
                            jnp.zeros(2, jnp.int32), jnp.asarray(lens))
    tctx = tdec.AttnContext(tc.page_table[torch.from_numpy(slots).long()],
                            torch.from_numpy(lens), torch.zeros(2, dtype=torch.int32),
                            torch.from_numpy(lens))
    for last_only in (False, True):
        jl, jpool = jdec.decoder_prefill(jp, jcfg, jc.kv_pages, jctx,
                                         input_ids=jnp.asarray(ids), last_only=last_only)
        tl, _ = tdec.decoder_prefill(tp, tcfg, tc.kv_pages, tctx, torch.from_numpy(ids).long(),
                                     last_only=last_only)
        if last_only:
            _close(tl, jl)
        else:
            for b in range(2):
                _close(tl[b, : lens[b]], np.asarray(jl)[b, : lens[b]], err_msg=f"b={b}")
    jc = type(jc)(kv_pages=jpool, page_table=jc.page_table, seq_lens=jc.seq_lens,
                  free_stack=jc.free_stack, free_top=jc.free_top)
    _close(tc.kv_pages.pages, jc.kv_pages.pages)

    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    jslots, tslots = jnp.asarray(slots), torch.from_numpy(slots)
    for step in range(5):
        active = np.asarray([True, step < 3])
        jc = jkv.alloc_decode(jc, jslots, jnp.asarray(active))
        tkv.alloc_decode(tc, tslots, torch.from_numpy(active))
        seq = np.asarray(jc.seq_lens)[slots]
        jctx = jdec.AttnContext(jc.page_table[jslots], jnp.asarray(seq), jnp.asarray(seq - 1),
                                jnp.ones(2, jnp.int32), jnp.asarray(active))
        tctx = tdec.AttnContext(tc.page_table[tslots.long()], torch.from_numpy(seq),
                                torch.from_numpy(seq - 1), torch.ones(2, dtype=torch.int32),
                                torch.from_numpy(active))
        jl, jpool = jdec.decoder_decode(jp, jcfg, jc.kv_pages, jctx, jnp.asarray(tok))
        tl, _ = tdec.decoder_decode(tp, tcfg, tc.kv_pages, tctx, torch.from_numpy(tok).long())
        _close(tl[active], np.asarray(jl)[active], err_msg=f"step {step}")
        jc = type(jc)(kv_pages=jpool, page_table=jc.page_table, seq_lens=jc.seq_lens,
                      free_stack=jc.free_stack, free_top=jc.free_top)
        _close(tc.kv_pages.pages, jc.kv_pages.pages)
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)


def test_decode_matches_reprefill():
    """The repository's key invariant, in the port alone: greedy-decode
    through the paged cache, then re-prefill prompt + generated tokens in a
    fresh cache; the last-position logits agree."""
    _, tcfg = _configs("llama_tied")
    tp = params_from_numpy(numpy_params(tcfg, seed=3), tcfg, device="cpu")
    c = tkv.create_kv_cache(2, 2, 16, NPAGES, page_size=PS, max_reqs=MAXR, max_seq_len=32,
                            dtype=torch.float32, device="cpu")
    prompt = torch.tensor([[5, 9, 2, 7, 1]])
    slot, n = torch.tensor([0], dtype=torch.int32), torch.tensor([5], dtype=torch.int32)
    tkv.alloc_prefill(c, slot, n)
    ctx = tdec.AttnContext(c.page_table[[0]], n, torch.zeros_like(n), n)
    logits, _ = tdec.decoder_prefill(tp, tcfg, c.kv_pages, ctx, prompt, last_only=True)
    seq = prompt[0].tolist()
    for _ in range(6):
        tok = int(logits.argmax(-1))
        seq.append(tok)
        tkv.alloc_decode(c, slot)
        sl = c.seq_lens[[0]]
        ctx = tdec.AttnContext(c.page_table[[0]], sl, sl - 1, torch.ones_like(sl))
        logits, _ = tdec.decoder_decode(tp, tcfg, c.kv_pages, ctx, torch.tensor([tok]))
    fresh = tkv.create_kv_cache(2, 2, 16, NPAGES, page_size=PS, max_reqs=MAXR,
                                max_seq_len=32, dtype=torch.float32, device="cpu")
    full = torch.tensor([seq])
    nf = torch.tensor([len(seq)], dtype=torch.int32)
    tkv.alloc_prefill(fresh, slot, nf)
    ctx = tdec.AttnContext(fresh.page_table[[0]], nf, torch.zeros_like(nf), nf)
    want, _ = tdec.decoder_prefill(tp, tcfg, fresh.kv_pages, ctx, full, last_only=True)
    _close(logits, want.numpy())


def test_presets_and_configs_match_jax():
    for name, make in T_PRESETS.items():
        j, t = J_PRESETS[name](), make()
        for f in ("hidden_size", "intermediate_size", "num_hidden_layers",
                  "num_attention_heads", "num_key_value_heads", "head_dim", "vocab_size",
                  "rope_theta", "rope_scaling", "tie_word_embeddings", "attention_bias",
                  "eos_token_id", "model_type"):
            assert getattr(j, f) == getattr(t, f), (name, f)
    d = {"model_type": "qwen2", "hidden_size": 32, "n_heads": 4, "n_kv_heads": 2,
         "max_seq_length": 99}
    j, t = jconfig.load_config(d), tconfig.load_config(d)
    assert type(j).__name__ == type(t).__name__
    for f in ("num_attention_heads", "num_key_value_heads", "head_dim", "max_seq_len",
              "attention_bias", "rope_theta", "tie_word_embeddings"):
        assert getattr(j, f) == getattr(t, f), f
    assert t.dtype == torch.bfloat16
    # LLaVA (once refused): an HF config with full text and vision configs
    # reads as JAX reads it.
    d = {"model_type": "llava", "image_token_index": 32000, "pad_token_id": 32001,
         "text_config": dict(hidden_size=64, intermediate_size=96, num_hidden_layers=2,
                             num_attention_heads=4, num_key_value_heads=2, vocab_size=101,
                             rms_norm_eps=1e-6, rope_theta=10000.0, tie_word_embeddings=False),
         "vision_config": dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                               num_attention_heads=4, image_size=28, patch_size=14,
                               projection_dim=32)}
    j, t = jconfig.load_config(d), tconfig.load_config(d)
    assert type(j).__name__ == type(t).__name__ == "LlavaConfig"
    for f in ("hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
              "num_key_value_heads", "head_dim", "vocab_size", "rms_norm_eps", "rope_theta",
              "tie_word_embeddings", "image_token_index", "pad_token_id", "num_image_patches"):
        assert getattr(j, f) == getattr(t, f), f
    assert vars(j.vision_config) == vars(t.vision_config)


def test_convert_hf_state_dict_matches_jax():
    from lite_llama_tpu.utils.weights import convert_hf_state_dict as j_convert

    jcfg, tcfg = _configs("qwen2")
    rng = np.random.default_rng(4)
    H, D, Nq, Nkv, I = 64, 16, 4, 2, 96
    sd = {"model.embed_tokens.weight": rng.standard_normal((101, H)),
          "model.norm.weight": rng.standard_normal(H), "lm_head.weight": rng.standard_normal((101, H))}
    for i in range(2):
        p = f"model.layers.{i}."
        sd.update({
            p + "input_layernorm.weight": rng.standard_normal(H),
            p + "post_attention_layernorm.weight": rng.standard_normal(H),
            p + "self_attn.q_proj.weight": rng.standard_normal((Nq * D, H)),
            p + "self_attn.k_proj.weight": rng.standard_normal((Nkv * D, H)),
            p + "self_attn.v_proj.weight": rng.standard_normal((Nkv * D, H)),
            p + "self_attn.q_proj.bias": rng.standard_normal(Nq * D),
            p + "self_attn.k_proj.bias": rng.standard_normal(Nkv * D),
            p + "self_attn.v_proj.bias": rng.standard_normal(Nkv * D),
            p + "self_attn.o_proj.weight": rng.standard_normal((H, Nq * D)),
            p + "mlp.gate_proj.weight": rng.standard_normal((I, H)),
            p + "mlp.up_proj.weight": rng.standard_normal((I, H)),
            p + "mlp.down_proj.weight": rng.standard_normal((H, I)),
        })
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    j, t = j_convert(sd, jcfg), convert_hf_state_dict(sd, tcfg, device="cpu")
    assert set(j["layers"]) == set(t["layers"])
    for k in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
    for k in j["layers"]:
        np.testing.assert_array_equal(t["layers"][k].numpy(), np.asarray(j["layers"][k]))
