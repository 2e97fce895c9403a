"""Chat prompt templates (port of ``lite_llama_tpu/utils/prompts.py``, plain
Python): template classes per model family (Llama-2 one-shot, Llama-3
header format, Qwen <|im_start|> format, LLaVA), multi-turn state,
model-type + path sniffing via ``get_prompter``, and ``get_stop_token_ids``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class BasePrompter:
    system_prompt: str = ""
    history: List[Tuple[str, str]] = field(default_factory=list)

    def build_prompt(self, user_msg: str) -> str:
        raise NotImplementedError

    def update_last_reply(self, reply: str) -> None:
        if self.history and self.history[-1][1] is None:
            user, _ = self.history[-1]
            self.history[-1] = (user, reply)

    def insert_prompt(self, user_msg: str) -> str:
        prompt = self.build_prompt(user_msg)
        self.history.append((user_msg, None))
        return prompt

    def reset(self) -> None:
        self.history.clear()


@dataclass
class Llama3Prompter(BasePrompter):
    """Llama-3 header format."""

    system_prompt: str = "You are a helpful assistant."

    def build_prompt(self, user_msg: str) -> str:
        parts = ["<|begin_of_text|>"]
        if self.system_prompt:
            parts.append(
                "<|start_header_id|>system<|end_header_id|>\n\n"
                f"{self.system_prompt}<|eot_id|>"
            )
        for user, assistant in self.history:
            parts.append(
                "<|start_header_id|>user<|end_header_id|>\n\n"
                f"{user}<|eot_id|>"
            )
            if assistant is not None:
                parts.append(
                    "<|start_header_id|>assistant<|end_header_id|>\n\n"
                    f"{assistant}<|eot_id|>"
                )
        parts.append(
            "<|start_header_id|>user<|end_header_id|>\n\n"
            f"{user_msg}<|eot_id|>"
            "<|start_header_id|>assistant<|end_header_id|>\n\n"
        )
        return "".join(parts)


@dataclass
class Llama2Prompter(BasePrompter):
    system_prompt: str = (
        "You are a helpful, respectful and honest assistant."
    )

    def build_prompt(self, user_msg: str) -> str:
        parts = []
        sys_block = (
            f"<<SYS>>\n{self.system_prompt}\n<</SYS>>\n\n"
            if self.system_prompt
            else ""
        )
        turns = self.history + [(user_msg, None)]
        for i, (user, assistant) in enumerate(turns):
            prefix = sys_block if i == 0 else ""
            if assistant is not None:
                parts.append(f"<s>[INST] {prefix}{user} [/INST] {assistant} </s>")
            else:
                parts.append(f"<s>[INST] {prefix}{user} [/INST]")
        return "".join(parts)


@dataclass
class QwenPrompter(BasePrompter):
    """Qwen2/2.5/Qwen3 <|im_start|> chat format."""

    system_prompt: str = "You are a helpful assistant."

    def build_prompt(self, user_msg: str) -> str:
        parts = []
        if self.system_prompt:
            parts.append(f"<|im_start|>system\n{self.system_prompt}<|im_end|>\n")
        for user, assistant in self.history:
            parts.append(f"<|im_start|>user\n{user}<|im_end|>\n")
            if assistant is not None:
                parts.append(f"<|im_start|>assistant\n{assistant}<|im_end|>\n")
        parts.append(
            f"<|im_start|>user\n{user_msg}<|im_end|>\n<|im_start|>assistant\n"
        )
        return "".join(parts)


@dataclass
class LlavaPrompter(BasePrompter):
    """LLaVA-1.5 (vicuna-style) with <image> placeholder."""

    system_prompt: str = (
        "A chat between a curious human and an artificial intelligence "
        "assistant. The assistant gives helpful, detailed, and polite "
        "answers to the human's questions."
    )

    def build_prompt(self, user_msg: str, with_image: bool = True) -> str:
        parts = [self.system_prompt + " "] if self.system_prompt else []
        for user, assistant in self.history:
            parts.append(f"USER: {user} ")
            if assistant is not None:
                parts.append(f"ASSISTANT: {assistant}</s>")
        img = "<image>\n" if with_image and not self.history else ""
        parts.append(f"USER: {img}{user_msg} ASSISTANT:")
        return "".join(parts)

    def insert_prompt(self, user_msg: str, with_image: bool = True) -> str:
        prompt = self.build_prompt(user_msg, with_image)
        self.history.append((user_msg, None))
        return prompt


_PROMPTERS = {
    "llama": Llama3Prompter,
    "llama2": Llama2Prompter,
    "qwen2": QwenPrompter,
    "qwen3": QwenPrompter,
    "llava": LlavaPrompter,
}


def get_prompter(
    model_type: str, checkpoint_path: str = "", system_prompt: Optional[str] = None
) -> BasePrompter:
    """Pick a prompter by model type + path sniffing."""
    key = model_type.lower()
    low = checkpoint_path.lower()
    if key == "llama" and ("llama-2" in low or "llama2" in low):
        key = "llama2"
    cls = _PROMPTERS.get(key, Llama3Prompter)
    if system_prompt is not None:
        return cls(system_prompt=system_prompt)
    return cls()


def get_stop_token_ids(model_type: str, tokenizer=None) -> List[int]:
    """Stop ids per family."""
    if model_type == "llama":
        ids = []
        if tokenizer is not None:
            for tok in ("<|eot_id|>", "<|end_of_text|>"):
                tid = tokenizer.convert_tokens_to_ids(tok)
                if tid is not None:
                    ids.append(tid)
        return ids or [128001, 128009]
    if model_type in ("qwen2", "qwen3"):
        return [151643, 151645]
    if model_type == "llava":
        return [2]  # </s>
    return []
