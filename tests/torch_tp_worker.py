"""Worker process of the port's multi-process tests (not a test module; the
counterpart of tests/multihost_worker.py). Imports no JAX.

    python tests/torch_tp_worker.py <spec.json> <rank>

Each of ``world`` processes joins a gloo group through a FileStore
rendezvous (``spec["init"]``, a ``file://`` path), or from the ``LLT_*``
environment where ``spec["env"]`` is set (the rank argument is then
ignored), builds every case of the spec on its mesh (``spec["mesh"]``:
``make_mesh`` keywords, default tp = world; with ``env``,
``make_multihost_mesh(tp=spec["mesh"]["tp"])``) from the numpy trees the
test wrote (``save_tree``), and writes its outputs as
``<out>/<case>.rank<r>.npz``. The test process holds them against the JAX
package on the same mesh.

A case is a dict: ``kind`` ("engine" or "llava"), ``cfg`` (the config
class name and fields, fp32), ``tree`` (the npz of the weights, quantized
leaves included), ``engine`` (``InferenceEngine`` keywords), ``prompts``,
A "cp_ops" case runs the context-parallel attention functions on the
inputs of ``inputs`` (an npz) for each entry of ``ops``, the rank holding
its share of each pool. ``gen`` (new tokens, greedy), optional ``rounds`` (the prompts generated
this many times over: a prefix-cache case; a list of prompt lists instead
generates each list in turn) and ``pixels`` (LLaVA). Besides tokens,
logprobs and logits, a rank writes its place in the mesh, the slots each
admission took, the widths its prefills and decode steps ran at, and its
pool's lengths and pages right after the first prefill.

The serving kinds build the engine of an engine case (``llava``: a
``LlavaEngine`` of the LLaVA tree) and take ``requests`` ([prompt,
max_gen_len, image row or None]): "sched" runs a
``ContinuousBatchingScheduler`` (``sched`` keywords) over them on every rank;
"server" serves them over HTTP on rank 0 in ``waves`` (lists of request
indices, ``idle_s`` apart, each posted from ``threads`` client threads,
odd indices streamed) while the other ranks follow (``serve``, or
``serve_background`` and ``join`` with ``background``), then shuts down;
"fault" plants a follower that applies a message's submits in reverse
order and submits two requests in one message; "spec" runs
``SpeculativeTextGenerator`` for each ``chunk_steps`` of ``modes``.
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
    widths, admitted = [], []
    real_rows, real_admit = engine._prefill_rows, engine.admit_requests

    def rows(token_lists, *a):
        widths.append(len(token_lists))
        return real_rows(token_lists, *a)

    def admit(*a, **k):
        admitted.append(real_admit(*a, **k))
        return admitted[-1]

    engine._prefill_rows, engine.admit_requests = rows, admit
    prompts = case["prompts"]
    rounds = case.get("rounds", 1)
    lists = rounds if isinstance(rounds, list) else [prompts] * rounds
    first = lists[0]
    slots = engine.admit_requests([len(p) + 1 for p in first])
    _, lens, last, _ = engine.prefill(first, SamplingParams.make(len(first), 0.0, device="cpu"),
                                      slots, return_logits=True)
    out["prefill_seq_lens"] = engine.cache.seq_lens.numpy().copy()
    out["prefill_pages"] = engine.cache.kv_pages.pages.float().numpy().copy()
    out["prefill_table"] = engine.cache.page_table.numpy().copy()
    engine.release_slots(slots, lens)
    out["prefill_logits"] = last
    gen = TextGenerator(engine)
    for r, ps in enumerate(lists):
        res = gen.generate_tokens(ps, max_gen_len=case["gen"], temperature=0.0, logprobs=True)
        out[f"tokens{r}"] = np.asarray([o.token_ids for o in res], dtype=object)
        out[f"logprobs{r}"] = np.asarray([o.logprobs for o in res], dtype=object)
    out["prefix_hits"] = np.asarray(engine.stats.prefix_hits)
    out["admitted"] = np.asarray(admitted, dtype=object)
    out["prefill_widths"] = np.asarray(widths)
    out["step_widths"] = np.asarray(sorted({k[0] for k in engine._steps}))
    sh = engine.shard
    out["place"] = np.asarray([sh.dp_rank, sh.cp_rank, sh.rank, sh.dp, sh.cp, sh.tp])
    pool = engine.cache.kv_pages
    out["pages"] = (pool.pages.view(torch.uint8) if pool.pages.dtype == torch.float8_e4m3fn
                    else pool.pages).numpy()
    if pool.scales is not None:
        out["scales"] = pool.scales.float().numpy()
    out["head_offset"] = np.asarray(pool.head_offset)
    if "wqkv" in engine.params["layers"]:  # fused at tp > 1
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


def _serving_engine(case, mesh):
    import torch

    from lite_llama_tpu_torch.executor.engine import InferenceEngine
    from lite_llama_tpu_torch.utils.weights import params_from_numpy

    if case.get("llava"):
        from lite_llama_tpu_torch.config import LlavaConfig
        from lite_llama_tpu_torch.executor.llava_engine import LlavaEngine

        cfg = LlavaConfig(dtype=torch.float32, **case["cfg"]["fields"])
        params = params_from_numpy(load_tree(case["tree"]), cfg, device="cpu")
        return LlavaEngine(cfg, params, device="cpu", mesh=mesh, **case["engine"])
    cfg = _config(case["cfg"])
    params = params_from_numpy(load_tree(case["tree"]), cfg, device="cpu")
    return InferenceEngine(cfg, params, device="cpu", mesh=mesh, **case["engine"])


def _submit_kw(case, req):
    prompt, gen, image = req
    px = None if image is None else np.load(case["pixels"])[image]
    return dict(max_gen_len=gen, temperature=0.0, pixel_values=px), prompt


def _accounting(engine, out):
    """The engine's call count and whether every slot and page came back
    (pages held by this rank's group's prefix entries count as back)."""
    held = [0] * engine.dp
    for g, reg in enumerate(engine.prefixes or ()):
        held[g] = sum(e[0] for e in reg.entries.values())
    out["calls"] = np.asarray(engine.stats.calls)
    out["drained"] = np.asarray(
        len(engine._free_slots) == engine.max_reqs
        and engine._host_free_pages + sum(held) == engine.num_pages
        and int(engine.cache.free_top) + held[engine.shard.dp_rank]
        == engine.num_pages // engine.dp)


def _sched_case(case, mesh, out):
    from lite_llama_tpu_torch.executor.scheduler import ContinuousBatchingScheduler

    engine = _serving_engine(case, mesh)
    sched = ContinuousBatchingScheduler(engine, **case.get("sched", {}))
    ids = []
    for req in case["requests"]:
        kw, prompt = _submit_kw(case, req)
        ids.append(sched.submit(prompt, **kw))
    done = {r.req_id: r for r in sched.run()}
    res = [done[i] for i in ids]
    out["tokens0"] = np.asarray([r.output_tokens for r in res], dtype=object)
    out["logprobs0"] = np.asarray([r.output_logprobs for r in res], dtype=object)
    out["finish"] = np.asarray([r.finish_reason for r in res])
    out["slots"] = np.asarray([-1 if r.slot is None else r.slot for r in res])
    out["step_widths"] = np.asarray(sorted({k[0] for k in engine._steps}))
    out["prefix_hits"] = np.asarray(engine.stats.prefix_hits)
    _accounting(engine, out)


def _post(port, prompt, gen, stream):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/generate", body=json.dumps(
        {"tokens": prompt, "max_gen_len": gen, "temperature": 0.0, "stream": stream}))
    body = conn.getresponse().read().decode()
    if not stream:
        r = json.loads(body)
        return r["tokens"], r["logprobs"], r["finish_reason"]
    lines = [json.loads(x) for x in body.splitlines()]
    assert lines[-1]["done"] is True
    return [t for x in lines[:-1] for t in x["tokens"]], None, lines[-1]["finish_reason"]


def _server_case(case, mesh, out):
    import threading
    import time

    import torch

    from lite_llama_tpu_torch.server import serve, serve_background

    engine = _serving_engine(case, mesh)
    kw = case.get("sched")
    if engine.shard.mesh.leader != torch.distributed.get_rank():
        if case.get("background"):
            _, follower = serve_background(engine, scheduler_kw=kw)
            follower.join(timeout=300)
        else:
            _, follower = serve(engine, scheduler_kw=kw)
        out["turns"], out["steps"] = np.asarray(follower.turns), np.asarray(follower.steps)
        _accounting(engine, out)
        return
    httpd, fe = serve_background(engine, port=0, scheduler_kw=kw)
    port = httpd.server_address[1]
    reqs, got, errors = case["requests"], {}, []

    def client(mine):
        try:
            for i in mine:
                prompt, gen, _ = reqs[i]
                got[i] = _post(port, prompt, gen, stream=bool(i % 2))
        except Exception as e:  # reported through the case's error
            errors.append(repr(e))

    try:
        for w, wave in enumerate(case["waves"]):
            if w:
                time.sleep(case["idle_s"])  # idle turns: the followers keep receiving
            n = case["threads"]
            pool = [threading.Thread(target=client, args=(wave[t::n],)) for t in range(n)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=300)
    finally:
        httpd.shutdown()
        fe.shutdown()
    assert not errors and fe.error is None, (errors, fe.error)
    assert not fe._thread.is_alive()
    order = range(len(reqs))
    out["tokens0"] = np.asarray([got[i][0] for i in order], dtype=object)
    out["logprobs0"] = np.asarray([got[i][1] or [] for i in order], dtype=object)
    out["finish"] = np.asarray([got[i][2] for i in order])
    out["turns"] = np.asarray(fe.turns)
    _accounting(engine, out)


def _fault_case(case, mesh, out):
    """A follower that reverses the order of a message's submits: every
    rank must raise the digest mismatch on that turn, before a step."""
    import time

    import torch

    from lite_llama_tpu_torch import server

    engine = _serving_engine(case, mesh)
    t0 = time.perf_counter()
    if engine.shard.mesh.leader != torch.distributed.get_rank():
        real = server.MeshFollower._apply
        server.MeshFollower._apply = lambda self, subs: real(self, subs[::-1])
        try:
            server.serve(engine)
        except Exception as e:  # the expected failure
            out["raised"] = np.asarray(f"{type(e).__name__}: {e}")
        finally:
            server.MeshFollower._apply = real
    else:
        fe = server.ServingFrontend(server.ContinuousBatchingScheduler(engine))
        with fe._lock:  # both land in one message
            rids = [fe.submit(p, max_gen_len=g, temperature=0.0) for p, g, _ in case["requests"]]
        try:
            fe.result(rids[0], timeout=60)
        except Exception as e:  # the expected failure
            out["raised"] = np.asarray(f"{type(e).__name__}: {e}")
        fe.shutdown()
        out["loop_ended"] = np.asarray(not fe._thread.is_alive())
    out["calls"] = np.asarray(engine.stats.calls)
    out["seconds"] = np.asarray(time.perf_counter() - t0)


def _spec_case(case, mesh, out):
    from lite_llama_tpu_torch.generation.speculative import SpeculativeTextGenerator

    engine = _serving_engine(case, mesh)
    for chunk_steps in case["modes"]:
        gen = SpeculativeTextGenerator(engine, draft_len=case["draft_len"], ngram=3,
                                       chunk_steps=chunk_steps)
        res = gen.generate_tokens(case["prompts"], max_gen_len=case["gen"])
        out[f"tokens_{chunk_steps}"] = np.asarray([o.token_ids for o in res], dtype=object)
        out[f"finish_{chunk_steps}"] = np.asarray([o.finish_reason for o in res])
        _accounting(engine, out)
        out[f"drained_{chunk_steps}"] = out.pop("drained")
    out["spec_graphs"] = np.asarray([st.graph is not None for st in engine._spec_steps.values()])


def _cp_ops_case(case, mesh, out):
    """Each op of the case through ``parallel/context_parallel.py`` on this
    context rank's share of the op's pool (global pages [c * P/cp, (c+1) *
    P/cp)); the outputs of layers ``op["layers"]`` stacked."""
    import torch

    from lite_llama_tpu_torch.executor.kv_cache import KVPool
    from lite_llama_tpu_torch.parallel import context_parallel as cpm
    from lite_llama_tpu_torch.parallel.shardings import ShardingPolicy

    shard = ShardingPolicy(mesh)
    data = np.load(case["inputs"])
    for op in case["ops"]:
        name = op["name"]

        def arr(key, name=name):
            return torch.from_numpy(data[f"{name}/{key}"])

        ps = op["page_size"]
        pages = arr("pages")
        total = pages.shape[2] // ps
        loc, c = total // shard.cp, shard.cp_rank
        rows = slice(c * loc * ps, (c + 1) * loc * ps)
        scales = arr("scales").to(torch.bfloat16)[:, rows].contiguous() if op["quantized"] else None
        pool = KVPool(pages=pages[:, :, rows].contiguous(), page_size=ps,
                      num_kv_heads=op["hkv"], head_dim=op["d"], scales=scales,
                      page_offset=c * loc, total_pages=total)
        res = []
        for layer in op["layers"]:
            if op["kind"] == "decode":
                kw = dict(k_new=arr("k_new"), v_new=arr("v_new")) if op.get("virtual") else {}
                res.append(cpm.cp_paged_flash_decode(arr("q"), pool, layer, arr("table"),
                                                      arr("lens"), shard, **kw))
            else:
                res.append(cpm.cp_flash_prefill_chunked(
                    arr("q"), arr("k"), arr("v"), arr("chunk_lens"), arr("start_pos"), pool,
                    layer, arr("table"), shard))
        out[name] = torch.stack(res).numpy()


def _count_cp_calls():
    """Count the decoder's calls of the context-parallel attention functions
    (``cp_calls``: decode, chunked prefill)."""
    from lite_llama_tpu_torch.parallel import context_parallel as cpm

    calls = [0, 0]
    for i, fname in enumerate(("cp_paged_flash_decode", "cp_flash_prefill_chunked")):
        real = getattr(cpm, fname)

        def counted(*a, _real=real, _i=i, **k):
            calls[_i] += 1
            return _real(*a, **k)

        setattr(cpm, fname, counted)
    return calls


def main(spec_path: str, rank: int) -> int:
    import torch

    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    from lite_llama_tpu_torch.parallel.distributed import init_distributed
    from lite_llama_tpu_torch.parallel.shardings import make_mesh

    world = spec["world"]
    if spec.get("env"):
        from lite_llama_tpu_torch.parallel.distributed import make_multihost_mesh

        assert init_distributed(timeout_s=120), "the LLT_* environment must configure the group"
        rank = torch.distributed.get_rank()
        mesh = make_multihost_mesh(tp=spec["mesh"]["tp"])
    else:
        init_distributed(init_method=spec["init"], num_processes=world, process_id=rank,
                         backend="gloo", timeout_s=120)
        mesh = make_mesh(**spec.get("mesh", {"tp": world}))
    cp_calls = _count_cp_calls()
    runners = {"llava": _llava_case, "cp_ops": _cp_ops_case, "engine": _engine_case,
               "sched": _sched_case, "server": _server_case, "fault": _fault_case,
               "spec": _spec_case}
    for name, case in spec["cases"].items():
        out = {}
        cp_calls[:] = [0, 0]
        try:
            runners[case["kind"]](case, mesh, out)
            out["cp_calls"] = np.asarray(cp_calls)
        except Exception:  # reported to the test, which fails the case
            out = {"error": np.asarray(traceback.format_exc())}
        np.savez(os.path.join(spec["out"], f"{name}.rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
