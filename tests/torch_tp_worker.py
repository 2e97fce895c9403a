"""Worker process of the port's tensor-parallel tests (not a test module; the
counterpart of tests/multihost_worker.py). Imports no JAX.

    python tests/torch_tp_worker.py <spec.json> <rank>

Each of ``world`` processes joins a gloo group through a FileStore
rendezvous (``spec["init"]``, a ``file://`` path), builds every case of the
spec at tp = world from the numpy trees the test wrote (``save_tree``), and
writes its outputs as ``<out>/<case>.rank<r>.npz``. The test process holds
them against the JAX package on ``make_mesh(tp=world)``.

A case is a dict: ``kind`` ("engine" or "llava"), ``cfg`` (the config
class name and fields, fp32), ``tree`` (the npz of the weights, quantized
leaves included), ``engine`` (``InferenceEngine`` keywords), ``prompts``,
``gen`` (new tokens, greedy), optional ``rounds`` (the prompts generated
this many times over: a prefix-cache case) and ``pixels`` (LLaVA).
"""

from __future__ import annotations

import json
import os
import sys
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

QT_FIELDS = ("unit_shape", "out_shape", "packed", "riffle_groups", "fused_tp", "sigma_out",
             "sigma_in", "sigma_groups")


def save_tree(path: str, tree) -> None:
    """A nested dict of arrays and quantized leaves (anything with ``q``,
    ``scale`` and the QTensor's static fields, a JAX QTensor included) as
    one npz: "a/b" keys for arrays, "a/b.q" / "a/b.scale" for a quantized
    leaf, its static fields as JSON under "__qt__"."""
    arrays, meta = {}, {}

    def walk(node, key):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{key}/{k}" if key else k)
        elif hasattr(node, "q") and hasattr(node, "scale"):
            q = np.asarray(node.q)
            if q.dtype.itemsize == 1 and q.dtype not in (np.int8, np.uint8):
                q = q.view(np.uint8)  # fp8 as its bits
            arrays[key + ".q"], arrays[key + ".scale"] = q, np.asarray(node.scale, np.float32)
            meta[key] = {f: (list(getattr(node, f)) if isinstance(getattr(node, f), tuple)
                             else getattr(node, f)) for f in QT_FIELDS if hasattr(node, f)}
        else:
            arrays[key] = np.asarray(node, np.float32)

    walk(tree, "")
    arrays["__qt__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **arrays)


def load_tree(path: str) -> dict:
    """``save_tree``'s npz as a nested dict of numpy arrays and the port's
    QTensors with numpy fields (what ``params_from_numpy`` takes)."""
    from lite_llama_tpu_torch.quant.qtensor import QTensor

    data = np.load(path)
    meta = json.loads(bytes(data["__qt__"]).decode())
    tree: dict = {}

    def put(key, value):
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value

    for key in data.files:
        if key == "__qt__" or key.endswith(".scale"):
            continue
        if key.endswith(".q"):
            name = key[:-2]
            m = dict(meta[name])
            m["unit_shape"], m["out_shape"] = tuple(m["unit_shape"]), tuple(m["out_shape"])
            put(name, QTensor(q=data[key], scale=data[name + ".scale"], **m))
        else:
            put(key, data[key])
    return tree


def _config(spec_cfg):
    import torch

    from lite_llama_tpu_torch import config

    cls = getattr(config, spec_cfg["class"])
    return cls(dtype=torch.float32, **spec_cfg["fields"])


def _engine_case(case, mesh, out):
    import torch

    from lite_llama_tpu_torch.executor.engine import InferenceEngine
    from lite_llama_tpu_torch.generation.generate import TextGenerator
    from lite_llama_tpu_torch.generation.sampling import SamplingParams
    from lite_llama_tpu_torch.utils.weights import params_from_numpy

    cfg = _config(case["cfg"])
    params = params_from_numpy(load_tree(case["tree"]), cfg, device="cpu")
    engine = InferenceEngine(cfg, params, device="cpu", mesh=mesh, **case["engine"])
    prompts = case["prompts"]
    slots = engine.admit_requests([len(p) + 1 for p in prompts])
    _, lens, last, _ = engine.prefill(prompts, SamplingParams.make(len(prompts), 0.0,
                                                                   device="cpu"),
                                      slots, return_logits=True)
    engine.release_slots(slots, lens)
    out["prefill_logits"] = last
    gen = TextGenerator(engine)
    for r in range(case.get("rounds", 1)):
        res = gen.generate_tokens(prompts, max_gen_len=case["gen"], temperature=0.0,
                                  logprobs=True)
        out[f"tokens{r}"] = np.asarray([o.token_ids for o in res], dtype=object)
        out[f"logprobs{r}"] = np.asarray([o.logprobs for o in res], dtype=object)
    out["prefix_hits"] = np.asarray(engine.stats.prefix_hits)
    pool = engine.cache.kv_pages
    out["pages"] = (pool.pages.view(torch.uint8) if pool.pages.dtype == torch.float8_e4m3fn
                    else pool.pages).numpy()
    if pool.scales is not None:
        out["scales"] = pool.scales.float().numpy()
    out["head_offset"] = np.asarray(pool.head_offset)
    out["local_wqkv_shape"] = np.asarray(engine.params["layers"]["wqkv"].shape)


def _llava_case(case, mesh, out):
    from lite_llama_tpu_torch.config import LlavaConfig
    from lite_llama_tpu_torch.executor.llava_engine import LlavaEngine
    from lite_llama_tpu_torch.generation.llava_generate import LlavaTextGenerator
    from lite_llama_tpu_torch.utils.weights import params_from_numpy

    import torch

    cfg = LlavaConfig(dtype=torch.float32, **case["cfg"]["fields"])
    params = params_from_numpy(load_tree(case["tree"]), cfg, device="cpu")
    engine = LlavaEngine(cfg, params, device="cpu", mesh=mesh, **case["engine"])
    px = np.load(case["pixels"])
    toks = [[] for _ in case["prompts"]]
    for new in LlavaTextGenerator(engine).stream_tokens_multimodal(
            case["prompts"], px, max_gen_len=case["gen"], temperature=0.0):
        for i, ids in enumerate(new):
            toks[i].extend(ids)
    out["tokens0"] = np.asarray(toks, dtype=object)


def main(spec_path: str, rank: int) -> int:
    import torch

    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    from lite_llama_tpu_torch.parallel.distributed import init_distributed
    from lite_llama_tpu_torch.parallel.shardings import make_mesh

    world = spec["world"]
    init_distributed(init_method=spec["init"], num_processes=world, process_id=rank,
                     backend="gloo", timeout_s=120)
    mesh = make_mesh(tp=world)
    for name, case in spec["cases"].items():
        out = {}
        try:
            (_llava_case if case["kind"] == "llava" else _engine_case)(case, mesh, out)
        except Exception:  # reported to the test, which fails the case
            out = {"error": np.asarray(traceback.format_exc())}
        np.savez(os.path.join(spec["out"], f"{name}.rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
