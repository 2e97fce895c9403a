"""The port's LLaVA model path against the JAX package and HF transformers on
the CPU, at a tiny size (CLIP tower H 32, 2 layers, 28-pixel images of
14-pixel patches, so 4 patches an image; LM H 48, 2 layers):

1. configs: the port's ``LlavaConfig`` and ``llava15_7b`` equal JAX's; an HF
   config that omits text or vision fields reads as transformers reads it
   (JAX reads its own defaults: divergence 2);
2. the activations (2e-5), ``vision_forward`` and ``encode_images`` (fp32,
   1e-4), ``merge_image_features`` bit for bit (rows with and without an
   image, and mixed), ``llava_prefill`` logits (1e-4), each against JAX's;
   the tower and the prefill also against HF (2e-4 / 2e-3);
3. a row with two image placeholders is refused;
4. ``convert_hf_llava_state_dict`` bit for bit against JAX's in both key
   styles, and a bf16 checkpoint to the fp32 path's bits; a JAX LLaVA tree
   through ``params_from_numpy``; a converted LLaVA checkpoint reloads as
   the same model (JAX's does not: divergence 1);
5. image preprocessing bit for bit against JAX's, on PIL images made here.
"""

import base64
import io
import os

import numpy as np
import pytest

os.environ.setdefault("USE_TF", "0")  # transformers without TensorFlow

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")
PIL_Image = pytest.importorskip("PIL.Image")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lite_llama_tpu import config as jconfig  # noqa: E402
from lite_llama_tpu.executor import kv_cache as jkv  # noqa: E402
from lite_llama_tpu.models import decoder as jdec  # noqa: E402
from lite_llama_tpu.models import llava as jllava  # noqa: E402
from lite_llama_tpu.models import vision as jvision  # noqa: E402
from lite_llama_tpu.models.presets import llava15_7b as j_llava15_7b  # noqa: E402
from lite_llama_tpu.ops import activations as jact  # noqa: E402
from lite_llama_tpu.utils import image as jimage  # noqa: E402
from lite_llama_tpu.utils import weights as jw  # noqa: E402
from lite_llama_tpu_torch import config as tconfig  # noqa: E402
from lite_llama_tpu_torch.executor import kv_cache as tkv  # noqa: E402
from lite_llama_tpu_torch.models import decoder as tdec  # noqa: E402
from lite_llama_tpu_torch.models import llava as tllava  # noqa: E402
from lite_llama_tpu_torch.models import vision as tvision  # noqa: E402
from lite_llama_tpu_torch.models.presets import llava15_7b  # noqa: E402
from lite_llama_tpu_torch.ops import activations as tact  # noqa: E402
from lite_llama_tpu_torch.utils import image as timage  # noqa: E402
from lite_llama_tpu_torch.utils import weights as tw  # noqa: E402

IMG_TOK = 120
P = 4  # patches of a 28-pixel image at patch 14
VISION = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
              image_size=28, patch_size=14, projection_dim=32)
TEXT = dict(hidden_size=48, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, vocab_size=128, rope_theta=10000.0)
# The fields a LlavaConfig mirrors from its text config, and the tower's.
TEXT_FIELDS = ("hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
               "num_key_value_heads", "head_dim", "vocab_size", "rms_norm_eps", "rope_theta",
               "rope_scaling", "tie_word_embeddings")
VISION_FIELDS = ("hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
                 "image_size", "patch_size", "projection_dim", "layer_norm_eps", "num_channels")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def hf_llava(dtype=torch.float32):
    """A tiny random HF LlavaForConditionalGeneration, its 1-D parameters
    moved off their init so that every norm and bias counts."""
    torch.manual_seed(0)
    hf_cfg = transformers.LlavaConfig(
        vision_config=transformers.CLIPVisionConfig(**VISION),
        text_config=transformers.LlamaConfig(**TEXT), image_token_index=IMG_TOK,
        image_seq_length=P)
    model = transformers.LlavaForConditionalGeneration(hf_cfg).eval()
    with torch.no_grad():
        for _, p in model.named_parameters():
            if p.ndim == 1:
                p.add_(torch.randn(p.shape) * 0.1)
    return model.to(dtype)


def configs(dtype=None):
    """The tiny LLaVA config of JAX and of the port, from the same full HF
    dicts (the tiny HF model's)."""
    kw = dict(vision_config=transformers.CLIPVisionConfig(**VISION).to_dict(),
              text_config=transformers.LlamaConfig(**TEXT).to_dict(), image_token_index=IMG_TOK,
              max_seq_len=64)
    return (jconfig.LlavaConfig(dtype=jnp.float32, **kw),
            tconfig.LlavaConfig(dtype=dtype or torch.float32, **kw))


@pytest.fixture(scope="module")
def models():
    """(HF model, JAX config, JAX params, port config, port params): both
    trees converted from the HF model's state dict."""
    hf = hf_llava()
    jcfg, tcfg = configs()
    jp = jw.convert_hf_llava_state_dict(hf.state_dict(), jcfg)
    tp = tw.convert_hf_llava_state_dict(hf.state_dict(), tcfg, device="cpu")
    return hf, jcfg, jp, tcfg, tp


def same_tree(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            same_tree(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def pixels(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 3, 28, 28)).astype(np.float32)


# ---------------------------------------------------------------------------
# 1. Configs


def test_llava_config_and_preset_match_jax():
    jcfg, tcfg = configs()
    for f in TEXT_FIELDS + ("image_token_index", "vision_feature_layer", "max_seq_len",
                            "model_type", "num_image_patches"):
        assert getattr(jcfg, f) == getattr(tcfg, f), f
    for f in VISION_FIELDS:
        assert getattr(jcfg.vision_config, f) == getattr(tcfg.vision_config, f), f
    assert tcfg.text_config.dtype == tcfg.dtype == torch.float32
    j, t = j_llava15_7b(), llava15_7b()
    for f in TEXT_FIELDS + ("image_token_index", "eos_token_id", "num_image_patches"):
        assert getattr(j, f) == getattr(t, f), f
    assert (t.hidden_size, t.num_hidden_layers, t.vocab_size, t.num_image_patches) == (
        4096, 32, 32064, 576)
    assert t.vision_config.num_hidden_layers == 24 and t.vision_config.image_size == 336


def test_hf_llava_config_reads_as_transformers_reads_it():
    """Divergence 2. An HF LLaVA config.json may omit text and vision fields
    (llava-1.5-7b-hf's text_config names only a few); transformers fills them
    from LlamaConfig's and CLIPVisionConfig's defaults, and so does the
    port. The JAX package fills them from its own defaults."""
    cases = [
        {"model_type": "llava", "text_config": {"vocab_size": 32064, "rms_norm_eps": 1e-5,
                                                "max_position_embeddings": 4096,
                                                "model_type": "llama"},
         "vision_config": {"hidden_size": 1024, "image_size": 336, "intermediate_size": 4096,
                           "num_attention_heads": 16, "num_hidden_layers": 24,
                           "patch_size": 14, "projection_dim": 768}},
        {"model_type": "llava", "vision_config": {"hidden_size": 64}},
        {"model_type": "llava"},
    ]
    for d in cases:
        hf = transformers.LlavaConfig(**{k: v for k, v in d.items() if k != "model_type"})
        t = tconfig.load_config(d)
        assert isinstance(t, tconfig.LlavaConfig)
        for f in TEXT_FIELDS:
            assert getattr(t, f) == getattr(hf.text_config, f), (d, f)
        for f in VISION_FIELDS:
            assert getattr(t.vision_config, f) == getattr(hf.vision_config, f), (d, f)
    j = jconfig.load_config(cases[0])
    assert (j.hidden_size, j.num_hidden_layers, j.rope_theta) == (2048, 16, 500000.0)
    assert (t.hidden_size, t.num_hidden_layers, t.rope_theta) == (4096, 32, 10000.0)


# ---------------------------------------------------------------------------
# 2. The model path against JAX and HF


@pytest.mark.parametrize("name", sorted(tact.ACT2FN))
def test_activations_match_jax(name):
    x = np.random.default_rng(3).normal(scale=3.0, size=(4, 257)).astype(np.float32)
    want = np.asarray(jact.ACT2FN[name](jnp.asarray(x)))
    got = tact.ACT2FN[name](torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    xb = torch.from_numpy(x).bfloat16()  # fp32 inside, cast back
    assert tact.ACT2FN[name](xb).dtype == torch.bfloat16
    np.testing.assert_allclose(tact.ACT2FN[name](xb).float().numpy(),
                               tact.ACT2FN[name](xb.float()).bfloat16().float().numpy())


def test_init_vision_params_has_jax_s_tree():
    jcfg, tcfg = configs()
    want = tw.flatten_params(jax.tree_util.tree_map(np.asarray, jvision.init_vision_params(
        jcfg.vision_config, jax.random.PRNGKey(0))))
    got = tvision.init_vision_params(tcfg.vision_config, torch.Generator().manual_seed(0))
    assert {k: (tuple(v.shape), v.dtype) for k, v in tw.flatten_params(got).items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in want.items()}
    layers = got["layers"]
    assert torch.equal(layers["ln1_scale"], torch.ones(2, 32)) and not layers["bq"].any()
    assert 0.015 < float(layers["wq"].std()) < 0.025


@pytest.mark.parametrize("feature_layer", [-2, -1, 0])
def test_vision_forward_matches_jax(models, feature_layer):
    _, jcfg, jp, tcfg, tp = models
    px = pixels(3, seed=1)
    want = np.asarray(jvision.vision_forward(jp["vision"], jcfg.vision_config, jnp.asarray(px),
                                             feature_layer))
    got = tvision.vision_forward(tp["vision"], tcfg.vision_config, torch.from_numpy(px),
                                 feature_layer)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_encode_images_matches_jax_and_hf(models):
    hf, jcfg, jp, tcfg, tp = models
    px = pixels(2)
    got = tllava.encode_images(tp, tcfg, torch.from_numpy(px)).numpy()
    want = np.asarray(jllava.encode_images(jp, jcfg, jnp.asarray(px)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        hidden = hf.model.vision_tower(torch.tensor(px), output_hidden_states=True
                                       ).hidden_states[-2][:, 1:]
        want_hf = hf.model.multi_modal_projector(hidden).numpy()
    np.testing.assert_allclose(got, want_hf, rtol=2e-4, atol=2e-4)


MERGE_CASES = {  # rows of raw ids (padded with 0), their lengths, has_image per row
    "all images": ([[5, 9, IMG_TOK, 17, 33], [IMG_TOK, 4, 4, 0, 0]], [5, 3], [True, True]),
    "mixed": ([[5, 9, IMG_TOK, 17, 33], [7, 8, 9, 0, 0], [1, 2, 3, IMG_TOK, 0]], [5, 3, 4],
              [True, False, True]),
    # the second row's placeholder is a plain token where it has no image
    "no image": ([[5, 9, 17, 0, 0], [3, IMG_TOK, 4, 0, 0]], [3, 3], [False, False]),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_image_features_matches_jax_bit_for_bit(models, case):
    """The port takes one image's features per row with an image (JAX one
    per row, unread where has_image is False)."""
    _, _, jp, _, tp = models
    rows, lens, has = MERGE_CASES[case]
    ids = np.asarray(rows, np.int32)
    lens = np.asarray(lens, np.int32)
    has = np.asarray(has)
    H = 48
    feats = np.random.default_rng(2).normal(size=(len(rows), P, H)).astype(np.float32)
    S_out = 12
    want = jllava.merge_image_features(jnp.asarray(ids), jnp.asarray(lens), jnp.asarray(feats),
                                       jnp.asarray(has), jp["lm"]["embed"], IMG_TOK, S_out)
    got = tllava.merge_image_features(torch.from_numpy(ids), torch.from_numpy(lens),
                                      torch.from_numpy(feats[has]), torch.from_numpy(has),
                                      tp["lm"]["embed"], IMG_TOK, S_out)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want[0]))
    # JAX's new lengths are the host's expanded lengths (a row whose
    # placeholder has no image keeps its raw length).
    host = tllava.expand_image_tokens_host([r[:n] for r, n in zip(rows, lens)], IMG_TOK, P)
    np.testing.assert_array_equal(np.where(has, host, lens), np.asarray(want[1]))
    if not has.any():  # a row without an image is its plain embedding rows
        np.testing.assert_array_equal(got[:, :3].numpy(), tp["lm"]["embed"][ids[:, :3]].numpy())
        assert not got[:, 3:].any()


def _jax_prefill(jcfg, jp, ids, raw, exp, px, has):
    B, S_out = ids.shape
    cache = jkv.create_kv_cache(jcfg.num_hidden_layers, jcfg.num_key_value_heads, jcfg.head_dim,
                                num_pages=32, page_size=4, max_reqs=B, max_seq_len=64,
                                dtype=jnp.float32)
    req = jnp.arange(B, dtype=jnp.int32)
    lens = jnp.asarray(exp, jnp.int32)
    cache = jkv.alloc_prefill(cache, req, lens)
    ctx = jdec.AttnContext(cache.page_table[req], lens, jnp.zeros((B,), jnp.int32), lens)
    logits, _ = jllava.llava_prefill(jp, jcfg, cache.kv_pages, ctx, input_ids=jnp.asarray(ids),
                                     pixel_values=jnp.asarray(px), has_image=jnp.asarray(has),
                                     raw_lens=jnp.asarray(raw, jnp.int32))
    return np.asarray(logits)


def _port_prefill(tcfg, tp, ids, raw, exp, px, has, last_only=False):
    B = ids.shape[0]
    cache = tkv.create_kv_cache(tcfg.num_hidden_layers, tcfg.num_key_value_heads, tcfg.head_dim,
                                num_pages=32, page_size=4, max_reqs=B, max_seq_len=64,
                                dtype=torch.float32, device="cpu")
    req = torch.arange(B, dtype=torch.int32)
    lens = torch.tensor(exp, dtype=torch.int32)
    tkv.alloc_prefill(cache, req, lens)
    ctx = tdec.AttnContext(cache.page_table[req.long()], lens, torch.zeros_like(lens), lens)
    logits, _ = tllava.llava_prefill(tp, tcfg, cache.kv_pages, ctx, torch.from_numpy(ids).long(),
                                     pixel_values=torch.from_numpy(px[has]),
                                     has_image=torch.from_numpy(has),
                                     raw_lens=torch.tensor(raw, dtype=torch.int32),
                                     last_only=last_only)
    return logits.numpy()


def test_llava_prefill_matches_jax(models):
    """A batch with two image rows and a text row, padded to the expanded
    width; every valid row's logits within 1e-4."""
    _, jcfg, jp, tcfg, tp = models
    rows = [[5, 9, IMG_TOK, 17, 33], [7, 8, 9, 10], [IMG_TOK, 3, 4]]
    raw = [len(r) for r in rows]
    exp = tllava.expand_image_tokens_host(rows, IMG_TOK, P)
    assert exp == jllava.expand_image_tokens_host(rows, IMG_TOK, P) == [8, 4, 6]
    ids = np.zeros((3, max(exp)), np.int32)
    for i, r in enumerate(rows):
        ids[i, : len(r)] = r
    has = np.asarray(exp) != np.asarray(raw)
    px = pixels(3, seed=4)
    want = _jax_prefill(jcfg, jp, ids, raw, exp, px, has)
    got = _port_prefill(tcfg, tp, ids, raw, exp, px, has)
    for b, n in enumerate(exp):
        np.testing.assert_allclose(got[b, :n], want[b, :n], rtol=1e-4, atol=1e-4)
    last = _port_prefill(tcfg, tp, ids, raw, exp, px, has, last_only=True)
    np.testing.assert_allclose(last, got[np.arange(3), np.asarray(exp) - 1], rtol=1e-6,
                               atol=1e-6)


def test_llava_prefill_matches_hf(models):
    hf, _, _, tcfg, tp = models
    px = pixels(1, seed=1)
    raw = [5, 9, IMG_TOK, 17, 33]
    hf_ids = [5, 9] + [IMG_TOK] * P + [17, 33]  # HF takes the expanded ids
    with torch.no_grad():
        want = hf(input_ids=torch.tensor([hf_ids]), pixel_values=torch.tensor(px)).logits.numpy()
    exp = tllava.expand_image_tokens_host([raw], IMG_TOK, P)
    assert exp == [len(hf_ids)]
    ids = np.zeros((1, exp[0]), np.int32)
    ids[0, :5] = raw
    got = _port_prefill(tcfg, tp, ids, [5], exp, px, np.asarray([True]))
    np.testing.assert_allclose(got[0], want[0], rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# 3. One image per request


def test_two_image_placeholders_in_a_row_are_refused(models):
    """JAX sums both placeholders' starts into one offset and places the
    image wrongly; the port refuses the row."""
    _, _, _, _, tp = models
    with pytest.raises(ValueError, match="image placeholder"):
        tllava.expand_image_tokens_host([[1, IMG_TOK, 2, IMG_TOK]], IMG_TOK, P)
    ids = torch.tensor([[1, IMG_TOK, 2, IMG_TOK, 0]])
    with pytest.raises(ValueError, match="image placeholder"):
        tllava.merge_image_features(ids, torch.tensor([4]), torch.zeros(1, P, 48),
                                    torch.tensor([True]), tp["lm"]["embed"], IMG_TOK, 12)


# ---------------------------------------------------------------------------
# 4. Checkpoints


def _legacy_keys(sd):
    """The older HF key style: language_model.model.*, vision_tower.*,
    multi_modal_projector.*, language_model.lm_head.weight."""
    out = {}
    for k, v in sd.items():
        if k.startswith("model.language_model."):
            k = "language_model.model." + k[len("model.language_model."):]
        elif k.startswith("model."):
            k = k[len("model."):]
        elif k == "lm_head.weight":
            k = "language_model.lm_head.weight"
        out[k] = v
    return out


@pytest.mark.parametrize("style", ["current", "legacy"])
def test_convert_hf_llava_state_dict_matches_jax_bit_for_bit(models, style):
    hf, jcfg, _, tcfg, _ = models
    sd = hf.state_dict()
    assert any(k.startswith("model.language_model.") for k in sd)  # transformers' style
    if style == "legacy":
        sd = _legacy_keys(sd)
        assert any(k.startswith("language_model.model.") for k in sd)
    got = tw.convert_hf_llava_state_dict(sd, tcfg, device="cpu")
    want = jax.tree_util.tree_map(np.asarray, jw.convert_hf_llava_state_dict(sd, jcfg))
    same_tree(got, tw.params_from_numpy(want, tcfg, device="cpu"))
    assert got["vision"]["patch_embed"].shape == (3 * 14 * 14, 32)
    same_tree(tw.params_from_hf_state_dict(sd, tcfg, device="cpu"), got)


def test_bf16_llava_checkpoint_loads_to_the_fp32_numpy_path_s_bits():
    hf = hf_llava(torch.bfloat16)
    _, tcfg = configs(torch.bfloat16)
    jcfg, _ = configs()
    got = tw.convert_hf_llava_state_dict(hf.state_dict(), tcfg, device="cpu")
    sd32 = {k: v.float().numpy() for k, v in hf.state_dict().items()}
    old = jax.tree_util.tree_map(np.asarray, jw.convert_hf_llava_state_dict(sd32, jcfg))
    same_tree(got, tw.params_from_numpy(old, tcfg, device="cpu"))
    assert got["vision"]["layers"]["wq"].dtype == torch.bfloat16


def test_params_from_numpy_carries_a_jax_llava_tree():
    jcfg, tcfg = configs()
    jtree = jax.tree_util.tree_map(np.asarray,
                                   jllava.init_llava_params(jcfg, jax.random.PRNGKey(3)))
    got = tw.params_from_numpy(jtree, tcfg, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert len(flat) == len(tw.flatten_params(got)) > 20
    for path, leaf in flat:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), leaf)


def test_converted_llava_checkpoint_reloads_as_the_same_model(models, tmp_path):
    """Divergence 1. The port writes the vision and text configs into the
    converted config.json, so the reload has the model's shapes; the JAX
    package drops them and reloads default shapes. The JAX package reads
    the port's converted LLaVA as the same model too."""
    _, jcfg, jp, tcfg, tp = models
    tw.save_converted(tp, tcfg, str(tmp_path / "port"))
    back = tconfig.load_config(str(tmp_path / "port"), dtype=torch.float32)
    assert isinstance(back, tconfig.LlavaConfig)
    for f in TEXT_FIELDS + ("image_token_index", "max_seq_len"):
        assert getattr(back, f) == getattr(tcfg, f), f
    for f in VISION_FIELDS:
        assert getattr(back.vision_config, f) == getattr(tcfg.vision_config, f), f
    same_tree(tw.load_converted(str(tmp_path / "port"), torch.float32, device="cpu"), tp)
    jback = jconfig.load_config(str(tmp_path / "port"), dtype=jnp.float32)
    assert (jback.hidden_size, jback.num_hidden_layers, jback.vision_config.hidden_size) == (
        48, 2, 32)
    jw.save_converted(jp, jcfg, str(tmp_path / "jax"))
    jax_reload = tconfig.load_config(str(tmp_path / "jax"))
    assert (jax_reload.hidden_size, jax_reload.num_hidden_layers) != (48, 2)


# ---------------------------------------------------------------------------
# 5. Images


def _photo(w, h, seed=0):
    arr = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    return PIL_Image.fromarray(arr)


@pytest.mark.parametrize("size", [(40, 28), (28, 28), (17, 61)])
def test_preprocess_image_matches_jax_bit_for_bit(size):
    img = _photo(*size)
    for pad in (True, False):
        got = timage.preprocess_image(img, 28, pad_square=pad)
        want = jimage.preprocess_image(img, 28, pad_square=pad)
        assert got.dtype == np.float32 and got.shape == (3, 28, 28)
        np.testing.assert_array_equal(got, want)


def test_process_images_loads_paths_and_base64(tmp_path):
    img = _photo(30, 20, seed=1)
    path = tmp_path / "a.png"
    img.save(path)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    url = "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()
    got = timage.process_images([str(path), url, img], 28)
    np.testing.assert_array_equal(got, jimage.process_images([str(path), url, img], 28))
    np.testing.assert_array_equal(got[0], got[1])
    with pytest.raises(ValueError):
        timage.load_image(str(tmp_path / "missing.png"))


def test_vis_images_renders_or_labels(tmp_path, capsys, monkeypatch):
    p = tmp_path / "img.png"
    PIL_Image.new("RGB", (16, 8), (255, 0, 0)).save(p)
    txt = timage.render_image_ansi(str(p), max_width=8)
    assert txt == jimage.render_image_ansi(str(p), max_width=8)
    assert "\x1b[38;2;255;0;0m" in txt and "▀" in txt
    monkeypatch.delenv("FORCE_COLOR", raising=False)
    timage.vis_images([str(p)])  # not a tty under pytest: the size label
    assert "[image 16x8]" in capsys.readouterr().out
