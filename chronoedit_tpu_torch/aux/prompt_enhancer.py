"""Prompt enhancer: VLM rewrite of the user's edit instruction.

Host-side equivalent of ``scripts/prompt_enhancer.py``: a Qwen-VL class
model looks at the input image + terse instruction and expands it into an
~80-100-word physically-plausible chain-of-thought edit prompt
(prompt_enhancer.py:62-117 loader, :199-240 system prompt contract).

Runs through transformers on the card unless the caller asks for the CPU
(``PromptEnhancerConfig.device``); gated on local weights (zero-egress
safe). The system prompt below is an original formulation of the same
contract.

A copy of ``chronoedit_tpu/aux/prompt_enhancer.py`` except for the device:
JAX's defaults to "cpu", the port's to the card (``utils/platform.py``).
"""

from __future__ import annotations

import dataclasses

import torch

SYSTEM_PROMPT = """You rewrite terse image-edit instructions into rich edit
prompts for a video-based image editor. Given the input image and the user's
instruction, produce one 80-100 word description of how the scene evolves
from the original image to the edited result, as if describing a short
video: start from what is present, describe the transformation as a
physically plausible continuous change (motion, lighting, deformation), and
end with the final edited state. Preserve every element the user did not ask
to change, including identity, pose, background and style. Mention the
subject explicitly; avoid vague pronouns. Output only the rewritten prompt
text with no preamble."""


@dataclasses.dataclass
class PromptEnhancerConfig:
    model_path: str = "Qwen/Qwen2.5-VL-7B-Instruct"
    max_new_tokens: int = 256
    # None: the card (``utils/platform.cuda_device``, which raises without one)
    device: str | None = None


class PromptEnhancer:
    """image + instruction -> expanded edit prompt."""

    def __init__(self, cfg: PromptEnhancerConfig | None = None):
        from chronoedit_tpu_torch.utils.platform import cuda_device

        self.cfg = cfg or PromptEnhancerConfig()
        self.device = cuda_device() if self.cfg.device is None else torch.device(self.cfg.device)
        self._model = None
        self._processor = None

    def _load(self):
        if self._model is not None:
            return
        from transformers import AutoModelForImageTextToText, AutoProcessor

        self._processor = AutoProcessor.from_pretrained(self.cfg.model_path)
        self._model = AutoModelForImageTextToText.from_pretrained(
            self.cfg.model_path).to(self.device)

    def __call__(self, instruction: str, image=None) -> str:
        """``image``: PIL image or None (text-only fallback)."""
        self._load()
        content = []
        if image is not None:
            content.append({"type": "image", "image": image})
        content.append({"type": "text", "text": instruction})
        messages = [
            {"role": "system", "content": [{"type": "text", "text": SYSTEM_PROMPT}]},
            {"role": "user", "content": content},
        ]
        inputs = self._processor.apply_chat_template(
            messages, add_generation_prompt=True, tokenize=True,
            return_dict=True, return_tensors="pt").to(self.device)
        out = self._model.generate(**inputs, max_new_tokens=self.cfg.max_new_tokens)
        text = self._processor.batch_decode(
            out[:, inputs["input_ids"].shape[1]:], skip_special_tokens=True)[0]
        return text.strip()
