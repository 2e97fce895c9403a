"""Interactive chat REPL and one-shot generation CLI (port of
``lite_llama_tpu/cli.py``).

Usage:
    python -m lite_llama_tpu_torch.cli chat <checkpoint_dir> [--temperature 0.6 ...]
    python -m lite_llama_tpu_torch.cli generate <checkpoint_dir> -p "prompt" [--profile DIR]
    python -m lite_llama_tpu_torch.cli llava <llava_checkpoint_dir>

The checkpoint dir holds an HF checkpoint or a converted one
(``python -m lite_llama_tpu_torch.convert``) and a tokenizer that
``transformers.AutoTokenizer`` reads. The engine runs on the card unless
``--device cpu``. ``llava`` is a chat REPL over a LLaVA checkpoint in which
``/image <path>`` attaches an image to the next message.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

from .utils.logger import get_logger

logger = get_logger()


def _build(args, llava=False):
    import torch

    from .executor.engine import InferenceEngine
    from .executor.llava_engine import LlavaEngine
    from .generation.generate import TextGenerator
    from .generation.llava_generate import LlavaTextGenerator
    from .utils.prompts import get_prompter, get_stop_token_ids

    try:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.checkpoint)
    except Exception as e:
        logger.error(f"failed to load tokenizer from {args.checkpoint}: {e}")
        raise SystemExit(1)

    t0 = time.perf_counter()
    engine = (LlavaEngine if llava else InferenceEngine).build(
        args.checkpoint,
        dtype=torch.bfloat16,
        device=args.device,
        max_reqs=args.max_batch,
        page_size=args.page_size,
        decode_chunk=args.chunk,
    )
    logger.info(
        f"engine built in {time.perf_counter() - t0:.1f}s "
        f"({engine.num_pages} KV pages x {engine.page_size} tokens)"
    )
    gen = (LlavaTextGenerator if llava else TextGenerator)(engine, tokenizer)
    stops = get_stop_token_ids(engine.config.model_type, tokenizer)
    if stops:
        gen.eos_ids |= set(stops)
        engine.set_eos(sorted(gen.eos_ids))
    prompter = get_prompter(engine.config.model_type, args.checkpoint)
    return engine, gen, prompter


def cmd_chat(args):
    engine, gen, prompter = _build(args)
    print("Interactive chat. Ctrl-D or 'exit' to quit, 'reset' to clear history.")
    while True:
        try:
            user = input("\nyou> ").strip()
        except EOFError:
            break
        if not user or user in ("exit", "quit"):
            break
        if user == "reset":
            prompter.reset()
            continue
        prompt = prompter.insert_prompt(user)
        sys.stdout.write("assistant> ")
        reply_parts = []
        decoded0 = engine.stats.decode_tokens
        t0 = time.perf_counter()
        for frags in gen.text_completion_stream(
            [prompt],
            max_gen_len=args.max_gen_len,
            temperature=args.temperature,
            top_p=args.top_p,
        ):
            sys.stdout.write(frags[0])
            sys.stdout.flush()
            reply_parts.append(frags[0])
        dt = time.perf_counter() - t0
        prompter.update_last_reply("".join(reply_parts))
        print(f"\n[{(engine.stats.decode_tokens - decoded0) / max(dt, 1e-9):.1f} tokens/s]")


def cmd_generate(args):
    from .utils.common import get_device_memory
    from .utils.profiling import trace

    engine, gen, prompter = _build(args)
    prompts = args.prompt or ["Hello, my name is"]
    ctx = trace(args.profile) if args.profile else contextlib.nullcontext()
    t0 = time.perf_counter()
    with ctx:
        outs = gen.text_completion(
            prompts,
            max_gen_len=args.max_gen_len,
            temperature=args.temperature,
            top_p=args.top_p,
            echo=args.echo,
        )
    dt = time.perf_counter() - t0
    total = sum(len(o.token_ids) for o in outs)
    for i, o in enumerate(outs):
        print(f"--- [{i}] ({o.finish_reason}) ---\n{o.text}")
    print(
        f"\n{total} tokens in {dt:.2f}s -> {total / dt:.1f} tokens/s "
        f"({1000 * dt / max(total, 1):.2f} ms/token)"
    )
    mem = get_device_memory() if engine.device.type == "cuda" else None
    if mem:
        print(f"device memory: {mem['used_gb']:.2f} / {mem['total_gb']:.2f} GB")


def cmd_llava(args):
    """Multimodal REPL: '/image <path>' attaches an image to the next
    message (and echoes it in the terminal); plain text chats as usual.
    LLaVA-1.5 reads one image, placed in a dialog's first message: every
    later turn of that dialog is sent with it, and an image attached after
    the first turn starts a new dialog."""
    from .utils.image import vis_images

    engine, gen, prompter = _build(args, llava=True)
    print("Multimodal chat. '/image <path>' attaches an image; 'exit' quits.")
    image = None  # attached to the next message
    dialog_image = None  # the dialog's image, sent with each of its turns
    while True:
        try:
            user = input("\nyou> ").strip()
        except EOFError:
            break
        if not user or user in ("exit", "quit"):
            break
        if user.startswith("/image "):
            image = user[len("/image "):].strip()
            print(f"[image attached: {image}]")
            vis_images([image])
            continue
        if image is not None:
            if prompter.history:
                print("[one image a dialog: starting a new dialog with this image]")
                prompter.history.clear()
            dialog_image, image = image, None
            user = "<image>\n" + user  # kept in the history's first turn
        prompt = prompter.insert_prompt(user, with_image=False)
        sys.stdout.write("assistant> ")
        kw = dict(max_gen_len=args.max_gen_len, temperature=args.temperature, top_p=args.top_p)
        stream = (gen.text_completion_stream_mm([prompt], [dialog_image], **kw)
                  if dialog_image is not None else gen.text_completion_stream([prompt], **kw))
        parts = []
        for frags in stream:
            sys.stdout.write(frags[0])
            sys.stdout.flush()
            parts.append(frags[0])
        prompter.update_last_reply("".join(parts))
        print()


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="lite_llama_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in (("chat", cmd_chat), ("generate", cmd_generate), ("llava", cmd_llava)):
        s = sub.add_parser(name)
        s.add_argument("checkpoint")
        s.add_argument("--temperature", type=float, default=0.6)
        s.add_argument("--top-p", dest="top_p", type=float, default=0.9)
        s.add_argument("--max-gen-len", type=int, default=512)
        s.add_argument("--max-batch", type=int, default=8)
        s.add_argument("--page-size", type=int, default=64)
        s.add_argument("--chunk", type=int, default=8 if name in ("chat", "llava") else 64)
        s.add_argument("--device", default="cuda", help="'cpu' runs the plain PyTorch path")
        s.set_defaults(fn=fn)
        if name == "generate":
            s.add_argument("-p", "--prompt", action="append")
            s.add_argument("--echo", action="store_true")
            s.add_argument("--profile", metavar="DIR", default=None,
                           help="write a torch.profiler trace (trace.json) here")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
