"""Offline weight converter: HF checkpoint -> fused engine checkpoint (port
of ``lite_llama_tpu/convert.py``).

Reads the HF safetensors (one file or index + shards) onto the device in
their stored dtype, converts them there (``utils/weights.py``), and writes
``engine.safetensors`` + ``config.json`` + the tokenizer files, the format
the JAX package's converter writes. ``InferenceEngine.build`` loads it
without the conversion step. A LLaVA checkpoint (``model_type`` "llava")
converts to the {"lm", "vision", "projector"} tree, which
``LlavaEngine.build`` loads. Runs on the card unless ``--device cpu``.

Usage:
    python -m lite_llama_tpu_torch.convert <hf_checkpoint_dir> <out_dir> \
        [--dtype bf16|fp16|fp32] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from .config import load_config
from .executor.engine import require_device
from .utils.logger import get_logger
from .utils.weights import load_hf_safetensors, params_from_hf_state_dict, save_converted

logger = get_logger()

_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16, "fp32": torch.float32}


def convert_checkpoint(src: str, dst: str, dtype=torch.bfloat16, device="cuda") -> None:
    require_device(device)
    cfg = load_config(src, dtype=dtype)
    logger.info(f"model_type={cfg.model_type}, loading safetensors from {src}")
    t0 = time.perf_counter()
    sd = load_hf_safetensors(src, device)
    logger.info(f"loaded {len(sd)} tensors in {time.perf_counter() - t0:.1f}s")
    params = params_from_hf_state_dict(sd, cfg, device)
    del sd
    save_converted(params, cfg, dst, src_dir=src)
    logger.info(f"wrote fused engine checkpoint to {dst}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="lite_llama_tpu_torch.convert")
    p.add_argument("src", help="HF checkpoint dir (config.json + safetensors)")
    p.add_argument("dst", help="output dir for the fused engine checkpoint")
    p.add_argument("--dtype", choices=_DTYPES, default="bf16")
    p.add_argument("--device", default="cuda", help="where the conversion runs")
    args = p.parse_args(argv)
    convert_checkpoint(args.src, args.dst, _DTYPES[args.dtype], args.device)


if __name__ == "__main__":
    main()
