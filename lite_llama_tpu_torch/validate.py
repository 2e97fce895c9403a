"""One-command quantization-quality validation (port of the JAX package's
``examples/validate.py``).

Runs the quantized-config perplexity table against the bf16 baseline on the
forward path generation uses (chunked prefill through the paged pool,
``eval/perplexity.py``) and checks each config against the committed
tolerances (``docs/validation.md``).

Checkpoint mode (on the card unless ``--device cpu``):
    python -m lite_llama_tpu_torch.validate --checkpoint /path/to/Llama-3.2-3B \
        --data /path/to/eval.txt [--configs bf16,int8,fp8,int4,int8_kv,int4_int8kv]

``--data`` is plain text (tokenized with the checkpoint's tokenizer) or a
``.jsonl`` with a "text" field per line.

Dry-fixture mode (no checkpoint; proves the pipeline end to end on the CPU):
    python -m lite_llama_tpu_torch.validate --dry-fixture

Dry-fixture builds a tiny random-init HF Llama in process, converts it
through the real converter (``utils/weights.convert_hf_state_dict``), scores a
random-token corpus under every config, and applies the same gates.

The ``int4`` config is the JAX recipe's: packed int4 with C-grouped scales
of 128 in the σ-FFN layout (``sigma_ffn=True``), under its tolerance.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

# Committed tolerances (docs/validation.md): max NLL increase vs the bf16
# baseline. NLL (log-domain) rather than raw perplexity, so the gate is
# scale-free: delta nll = ln(ppl_q / ppl_bf16).
TOLERANCES = {
    "int8": 0.01,        # int8 weights, per-channel scales
    "fp8": 0.01,         # fp8 (e4m3) weights
    "int4": 0.05,        # packed int4, g=128 grouped scales, σ-FFN layout
    "int8_kv": 0.02,     # bf16 weights + int8 KV pool
    "int4_int8kv": 0.06, # int4 weights + int8 KV pool
}


def _configs(names):
    """{name: (quantize(params) -> params, kv_quant)}."""
    from .quant.qtensor import quantize_decoder_params

    def int4(p):
        return quantize_decoder_params(p, "int4", group_size=128, sigma_ffn=True)

    table = {
        "bf16": (lambda p: p, False),
        "int8": (lambda p: quantize_decoder_params(p, "int8"), False),
        "fp8": (lambda p: quantize_decoder_params(p, "fp8"), False),
        "int4": (int4, False),
        "int8_kv": (lambda p: p, True),
        "int4_int8kv": (int4, True),
    }
    unknown = [n for n in names if n not in table]
    if unknown:
        raise ValueError(f"unknown configs {unknown}: choose from {list(table)}")
    return {n: table[n] for n in names}


def run_table(cfg, params, seqs, names, chunk=256, batch_size=4, page_size=16, device="cuda"):
    """Perplexity per config + gate verdicts vs bf16. Returns (rows, ok);
    each row carries the run's seconds and tokens/s beside its NLL."""
    import time

    from .eval.perplexity import corpus_perplexity

    rows = {}
    base_nll = None
    ok = True
    for name, (quantize, kv_q) in _configs(names).items():
        qp = quantize(params)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        r = corpus_perplexity(cfg, qp, seqs, kv_quant=kv_q, chunk=chunk,
                              batch_size=batch_size, page_size=page_size, device=device)
        dt = time.perf_counter() - t0
        del qp
        row = {"perplexity": round(r["perplexity"], 4), "nll": round(r["nll"], 6),
               "tokens": r["tokens"], "seconds": dt, "tokens_per_s": r["tokens"] / dt}
        if name == "bf16":
            base_nll = r["nll"]
        elif base_nll is not None:
            d = r["nll"] - base_nll
            tol = TOLERANCES.get(name)
            row["delta_nll_vs_bf16"] = round(d, 6)
            if tol is not None:
                row["tolerance"] = tol
                row["pass"] = bool(d <= tol)
                ok &= row["pass"]
        rows[name] = row
        print(f"[validate] {name}: {row}", file=sys.stderr, flush=True)
    return rows, ok


def _dry_fixture_model():
    """Tiny random-init HF Llama -> the real converter -> engine tree, on
    the CPU, fp32."""
    import transformers

    from .config import LlamaConfig
    from .utils.weights import convert_hf_state_dict

    torch.manual_seed(0)
    hf_cfg = transformers.LlamaConfig(
        hidden_size=128, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, vocab_size=256,
        max_position_embeddings=512, tie_word_embeddings=False,
    )
    model = transformers.LlamaForCausalLM(hf_cfg)
    cfg = LlamaConfig.from_dict(hf_cfg.to_dict(), dtype=torch.float32, max_seq_len=512)
    params = convert_hf_state_dict(model.state_dict(), cfg, device="cpu")
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, 256, size=n).tolist() for n in (150, 90, 64)]
    return cfg, params, seqs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="lite_llama_tpu_torch.validate")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--data", default=None, help="text / jsonl corpus")
    ap.add_argument("--configs", default="bf16,int8,fp8,int4,int8_kv,int4_int8kv")
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-seqs", type=int, default=64)
    ap.add_argument("--max-seq-len", type=int, default=2048)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dry-fixture", action="store_true",
                    help="tiny in-process model on the CPU, no checkpoint needed")
    args = ap.parse_args(argv)
    names = [n.strip() for n in args.configs.split(",") if n.strip()]

    if args.dry_fixture:
        cfg, params, seqs = _dry_fixture_model()
        rows, ok = run_table(cfg, params, seqs, names, chunk=64, batch_size=2, device="cpu")
    else:
        if not (args.checkpoint and args.data):
            ap.error("--checkpoint and --data are required without --dry-fixture")
        from transformers import AutoTokenizer

        from .config import load_config
        from .utils.weights import is_converted_checkpoint, load_converted, load_hf_checkpoint

        cfg = load_config(args.checkpoint, dtype=torch.bfloat16, max_seq_len=args.max_seq_len)
        if is_converted_checkpoint(args.checkpoint):
            params = load_converted(args.checkpoint, dtype=torch.bfloat16, device=args.device)
        else:
            params = load_hf_checkpoint(args.checkpoint, cfg, device=args.device)
        tok = AutoTokenizer.from_pretrained(args.checkpoint)
        texts = []
        with open(args.data) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if args.data.endswith(".jsonl"):
                    line = json.loads(line).get("text", "")
                texts.append(line)
                if len(texts) >= args.max_seqs:
                    break
        seqs = [tok(t, add_special_tokens=False)["input_ids"][: args.max_seq_len] for t in texts]
        rows, ok = run_table(cfg, params, seqs, names, chunk=args.chunk,
                             batch_size=args.batch_size, device=args.device)

    print(json.dumps({"configs": rows, "all_pass": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
