"""Image loading and preprocessing for LLaVA (port of
``lite_llama_tpu/utils/image.py``).

Loading from a path, a base64 data URL or a PIL image, padding to a square
with CLIP's background colour, the bicubic resize and CLIP's normalisation,
in PIL and numpy, plus an ANSI half-block renderer that echoes an image in
the terminal. PIL is imported inside the functions that need it: the engine
takes pixel arrays and never does.
"""

from __future__ import annotations

import base64
import io
import os
import sys
from typing import Sequence

import numpy as np

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def load_image(source):
    """Path / base64 data URL / PIL image -> RGB PIL image."""
    from PIL import Image

    if hasattr(source, "convert"):
        return source.convert("RGB")
    if isinstance(source, str) and source.startswith("data:image"):
        payload = source.split(",", 1)[1]
        return Image.open(io.BytesIO(base64.b64decode(payload))).convert("RGB")
    if isinstance(source, str) and os.path.exists(source):
        return Image.open(source).convert("RGB")
    raise ValueError(f"cannot load image from {source!r}")


def expand2square(img, background=(122, 116, 104)):
    """Pad to a square, centred, with the CLIP background colour."""
    from PIL import Image

    w, h = img.size
    if w == h:
        return img
    side = max(w, h)
    out = Image.new("RGB", (side, side), background)
    out.paste(img, ((side - w) // 2, (side - h) // 2))
    return out


def preprocess_image(img, image_size: int = 336, pad_square: bool = True) -> np.ndarray:
    """PIL image -> normalised CHW fp32 array [3, S, S] (CLIP semantics)."""
    from PIL import Image

    if pad_square:
        img = expand2square(img)
    img = img.resize((image_size, image_size), Image.BICUBIC)
    x = np.asarray(img, np.float32) / 255.0  # [S, S, 3]
    x = (x - np.asarray(CLIP_MEAN)) / np.asarray(CLIP_STD)
    return x.transpose(2, 0, 1).astype(np.float32)


def process_images(sources: Sequence, image_size: int = 336,
                   pad_square: bool = True) -> np.ndarray:
    """Paths / PIL images / base64 data URLs -> [N, 3, S, S] fp32."""
    return np.stack([preprocess_image(load_image(s), image_size, pad_square)
                     for s in sources])


def render_image_ansi(source, max_width: int = 48) -> str:
    """The image as ANSI truecolour half-block text: two pixels per
    character cell (the upper-half-block glyph over its background)."""
    img = load_image(source)
    w, h = img.size
    new_w = min(max_width, w)
    new_h = max(2, int(h * new_w / max(w, 1) * 0.5) * 2)  # cell aspect ~2:1
    small = np.asarray(img.resize((new_w, new_h)), np.uint8)
    lines = []
    for y in range(0, new_h - 1, 2):
        row = []
        for x in range(new_w):
            tr, tg, tb = small[y, x][:3]
            br, bg, bb = small[y + 1, x][:3]
            row.append(f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀")
        lines.append("".join(row) + "\x1b[0m")
    return "\n".join(lines)


def vis_images(image_files: Sequence, max_width: int = 48) -> None:
    """Print each image in the terminal: rendered on a colour terminal (a
    tty, or FORCE_COLOR set), else its size."""
    for path in image_files:
        label = path if isinstance(path, str) else "<image>"
        if label.startswith("data:image"):
            label = "<base64 image>"
        print(f"--- {label} ---")
        try:
            if sys.stdout.isatty() or os.environ.get("FORCE_COLOR"):
                print(render_image_ansi(path, max_width))
            else:
                img = load_image(path)
                print(f"[image {img.size[0]}x{img.size[1]}]")
        except Exception as e:  # a display problem must not end the REPL
            print(f"[image display failed: {e}]")
