"""Safety guardrails: text + video checks around generation (the PyTorch
port's copy of ``chronoedit_tpu/aux/guardrails.py``).

Host-side equivalent of the reference guardrail stack
(``chronoedit/_ext/imaginaire/auxiliary/guardrail/``, SURVEY §2.8):

- :class:`GuardrailRunner` chains safety checks and postprocessors
  (common/core.py:37-65);
- text preset = :class:`Blocklist` (word/substring lists + simple
  leet-speak normalization) + an optional LLM classifier
  (:class:`LLMTextGuard`, the Qwen3Guard/LlamaGuard3 slot);
- video preset = an optional frame safety classifier
  (:class:`FrameSafetyClassifier`, the SigLIP+MLP slot) + an optional face
  blurrer (:class:`FaceBlur`, the RetinaFace slot).

Model-backed checks are *pluggable and gated*: they activate only when their
(external) weights are supplied — the framework runs fully without them, and
refuses closed (blocks) only on checks that are actually enabled.
"""

from __future__ import annotations

import dataclasses
import os
import re
import threading
from typing import Callable, Iterable

import numpy as np
import torch

_POOL_LOCK = threading.Lock()


class GuardrailBlocked(Exception):
    """Raised when a guardrail rejects an input/output."""


# ---------------------------------------------------------------- runner

class GuardrailRunner:
    """Chain of (name, check) pairs; a check returns (ok, reason) for text
    or a possibly-postprocessed array for video."""

    def __init__(self, checks: Iterable[tuple[str, Callable]] = ()):
        self.checks = list(checks)

    def run_text(self, prompt: str) -> None:
        for name, check in self.checks:
            ok, reason = check(prompt)
            if not ok:
                raise GuardrailBlocked(f"{name}: {reason}")

    def run_video(self, frames: np.ndarray) -> np.ndarray:
        """frames: (T, H, W, 3) uint8. Checks may transform (e.g. blur) or
        raise GuardrailBlocked."""
        for _, check in self.checks:
            frames = check(frames)
        return frames

@dataclasses.dataclass
class Guardrails:
    """Pipeline-facing facade: separate text and video runners (the
    reference keeps distinct presets, common/presets.py:28-43)."""

    text: GuardrailRunner | None = None
    video: GuardrailRunner | None = None

    def check_text_or_raise(self, prompt: str = "") -> None:
        if self.text is not None:
            self.text.run_text(prompt)

    def check_video(self, video):
        """video: (B, 3, T, H, W) tensor in [-1, 1].

        Pulls the decoded video to the host and runs the checks
        synchronously; returns a tensor of the input's dtype on its device.
        In a serving loop prefer :meth:`check_video_async` so the next
        edit's device compute overlaps the host-side guardrails."""
        if self.video is None or not self.video.checks:
            return video
        arr = video.detach().float().cpu().numpy()
        out = []
        for i in range(arr.shape[0]):
            frames = ((arr[i].transpose(1, 2, 3, 0) + 1) * 127.5
                      ).clip(0, 255).astype(np.uint8)
            frames = self.video.run_video(frames)
            out.append(frames.astype(np.float32).transpose(3, 0, 1, 2)
                       / 127.5 - 1.0)
        return torch.from_numpy(np.stack(out)).to(device=video.device, dtype=video.dtype)

    def check_video_async(self, video):
        """Serving-path variant: returns a ``concurrent.futures.Future`` of
        :meth:`check_video` run on a worker thread, so the device->host
        copy + classifier don't serialize against the next request's
        denoise."""
        import concurrent.futures

        with _POOL_LOCK:  # two first-callers racing would each build a pool
            if not hasattr(self, "_pool"):
                object.__setattr__(  # frozen-safe lazy pool
                    self, "_pool",
                    concurrent.futures.ThreadPoolExecutor(
                        max_workers=1, thread_name_prefix="guardrail"))
        return self._pool.submit(self.check_video, video)


# ---------------------------------------------------------------- blocklist

_LEET = str.maketrans({"0": "o", "1": "i", "3": "e", "4": "a", "5": "s",
                       "7": "t", "@": "a", "$": "s", "!": "i"})

# bundled starter denylist (assets/blocklist/*.txt) so the text guardrail
# blocks something out of the box, as the reference's data files do
# (blocklist.py:36-202); production deployments extend/replace via
# Blocklist.from_dir. Falls back to a minimal hardcoded list if the asset
# files are missing from a stripped install.
_BUNDLED_BLOCKLIST_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "assets", "blocklist")


def _read_word_list(path: str) -> tuple[str, ...]:
    if not os.path.exists(path):
        return ()
    with open(path) as f:
        return tuple(w.strip().lower() for w in f
                     if w.strip() and not w.lstrip().startswith("#"))


_DEFAULT_EXACT = _read_word_list(
    os.path.join(_BUNDLED_BLOCKLIST_DIR, "exact.txt")) or ("csam",)
_DEFAULT_PARTIAL = _read_word_list(
    os.path.join(_BUNDLED_BLOCKLIST_DIR, "partial.txt")) or ("child sexual",)
_DEFAULT_WHITELIST = _read_word_list(
    os.path.join(_BUNDLED_BLOCKLIST_DIR, "whitelist.txt"))

# naive lemmatizer: suffix-strip candidates tried against the exact tier so
# plural/inflected forms of a blocked token still match ("beheadings" ->
# "beheading"). The reference uses nltk's WordNetLemmatizer for the same
# purpose (blocklist.py:52,180-184); suffix stripping covers the regular
# inflections without the nltk data download.
_SUFFIXES = ("ings", "ing", "ers", "er", "ies", "es", "s", "ed")


def _lemma_candidates(token: str) -> tuple[str, ...]:
    # possessives first: the tokenizer keeps apostrophes (so "grape's"
    # cannot leak a bare "rape" token), which means "rapist's" must be
    # reduced here or every exact entry is bypassed by writing it as a
    # possessive
    bases = [token]
    if "'" in token:
        if token.endswith("'s"):
            bases.append(token[:-2])
        bases.append(token.rstrip("'"))
    out = []
    for base in dict.fromkeys(bases):
        out.append(base)
        for suf in _SUFFIXES:
            if base.endswith(suf) and len(base) - len(suf) >= 3:
                stem = base[: -len(suf)]
                out.append(stem)
                if suf in ("ies",):
                    out.append(stem + "y")
                if suf in ("ing", "ings", "ed", "er", "ers"):
                    out.append(stem + "e")  # rape -> raping/raped/raper
    return tuple(dict.fromkeys(out))


@dataclasses.dataclass
class Blocklist:
    """Tiered word-list text filter applied to a normalized (lowercase,
    de-leet-speaked) prompt. Tier semantics mirror the reference blocklist
    (blocklist/blocklist.py:76-202) without its nltk/better_profanity deps:

    - **exact tier**: single tokens, whole-word match only (``grape`` can
      never fire ``rape``); inflected forms match via suffix-stripping
      lemma candidates.
    - **partial tier**: phrases, substring match against the normalized
      prompt; entries >= ``fuzzy_min_chars`` additionally fuzzy-match word
      windows of the prompt with up to ``fuzzy_letter_count`` characters of
      edit tolerance (SequenceMatcher, reference check_partial_match
      blocklist.py:94-127) so one-letter obfuscations still block.
    - **whitelist**: phrases removed from the prompt before matching, so
      legitimate text a fuzzy/leet rule would clip is never blocked
      (reference uncensor_whitelist blocklist.py:65-74).
    """

    exact_words: tuple[str, ...] = _DEFAULT_EXACT
    partial_phrases: tuple[str, ...] = _DEFAULT_PARTIAL
    whitelist: tuple[str, ...] = _DEFAULT_WHITELIST
    # fuzzy matching only for phrases >= 10 chars: at the reference's 6-char
    # floor a 1-char tolerance on short two-word phrases clips everyday
    # bigrams ("was the" ~ "gas the", "will all" ~ "kill all"). Short
    # entries still match as exact substrings.
    fuzzy_min_chars: int = 10
    fuzzy_letter_count: float = 1.0

    @classmethod
    def from_dir(cls, path: str) -> "Blocklist":
        """Load ``exact.txt`` / ``partial.txt`` / ``whitelist.txt`` word-list
        files (one entry per line, '#' comments) from a directory."""

        return cls(
            exact_words=_read_word_list(os.path.join(path, "exact.txt"))
            or _DEFAULT_EXACT,
            partial_phrases=_read_word_list(os.path.join(path, "partial.txt"))
            or _DEFAULT_PARTIAL,
            # NO bundled fallback for the whitelist: it is subtractive (a
            # whitelisted token can disarm a custom partial phrase), so a
            # deployment that ships its own lists without a whitelist.txt
            # must get an empty one, not ours
            whitelist=_read_word_list(os.path.join(path, "whitelist.txt")))

    @staticmethod
    def normalize(prompt: str) -> str:
        p = prompt.lower().translate(_LEET)
        return re.sub(r"\s+", " ", p).strip()

    def _strip_whitelist(self, norm: str,
                         keep: frozenset[str] = frozenset(),
                         single_word_only: bool = False) -> str:
        """Remove whitelist phrases; tokens in ``keep`` survive the removal.

        The partial tier passes ``keep`` = every token that appears in an
        exact word or partial phrase, so a whitelist span can never disarm a
        blocked phrase that STRADDLES it: 'suicide prevention vest' keeps
        'suicide' and still matches 'suicide vest' (with
        plain deletion, appending 'prevention' bypassed every suicide-related
        phrase). The exact tier passes ``single_word_only=True``: only
        per-token whitelist entries apply there, mirroring the reference's
        uncensor_whitelist (blocklist.py:65-74) — see __call__ for why.
        All removals are word-boundary anchored: a span must never be
        clipped out of a LONGER word ('suicide preventionists' kept its
        exact token hidden as 'ists')."""
        for phrase in self.whitelist:
            if single_word_only and " " in phrase:
                continue
            kept = " ".join(t for t in phrase.split() if t in keep)
            repl = f" {kept} " if kept else " "
            norm = re.sub(rf"\b{re.escape(phrase)}\b", repl, norm)
        return re.sub(r"\s+", " ", norm).strip()

    def _fuzzy_match(self, words: list[str], phrase: str) -> bool:
        """Slide a window of len(phrase.split()) words over the prompt
        (reference check_partial_match, blocklist.py:94-127) and accept when
        the window reaches the phrase with at most ``fuzzy_letter_count``
        inserted+deleted characters and NO substitutions. Divergence from the
        reference's pure-ratio test is deliberate: leet normalization already
        canonicalizes substitution-style obfuscation, while a 1-char
        substitution tolerance false-positives on benign near-miss bigrams
        ('burning olive' ~ 'burning alive'). Insert/delete tolerance keeps
        'mas shooting' blocked."""
        import difflib

        n = len(phrase.split())
        if n > len(words):
            return False
        sm = difflib.SequenceMatcher(b=phrase)
        for i in range(len(words) - n + 1):
            window = " ".join(words[i:i + n])
            if abs(len(window) - len(phrase)) > self.fuzzy_letter_count:
                continue
            sm.set_seq1(window)
            cost = 0.0
            for tag, i1, i2, j1, j2 in sm.get_opcodes():
                if tag == "equal":
                    continue
                if tag == "replace":
                    cost = float("inf")
                    break
                cost += (i2 - i1) + (j2 - j1)
            if cost <= self.fuzzy_letter_count:
                return True
        return False

    def _danger_tokens(self) -> frozenset[str]:
        """Tokens that carry block signal: exact words plus every token of
        every partial phrase. Whitelist stripping preserves these for the
        partial tier (see _strip_whitelist)."""
        return frozenset(self.exact_words).union(
            t for p in self.partial_phrases for t in p.split())

    def __call__(self, prompt: str) -> tuple[bool, str]:
        norm0 = self.normalize(prompt)
        # exact tier: only SINGLE-word whitelist entries apply, per-token
        # like the reference's uncensor_whitelist (blocklist.py:65-74).
        # Multi-word entries used to strip their whole span here, which let
        # ANY prompt disarm an exact word by appending a whitelist phrase
        # containing it ('a man committing suicide prevention' passed while
        # 'a man committing suicide' blocked). The false positive on
        # genuinely-benign usages
        # ('suicide prevention poster' now blocks) is accepted, exactly as
        # the reference accepts it; the LLM guard tier is the place for
        # semantic judgments.
        norm = self._strip_whitelist(norm0, single_word_only=True)
        tokens = re.findall(r"[a-z']+", norm)
        lemmas = {c for t in tokens for c in _lemma_candidates(t)}
        exact = set(self.exact_words)
        hit = lemmas & exact
        if hit:
            return False, f"blocked word {sorted(hit)[0]!r}"
        # partial tier: whitelist spans collapsed to their danger tokens so
        # phrases straddling a whitelist span still match
        norm_p = self._strip_whitelist(norm0, keep=self._danger_tokens())
        tokens_p = re.findall(r"[a-z']+", norm_p)
        for phrase in self.partial_phrases:
            # word-boundary match (reference blocklist.py:155-157) — a bare
            # substring test lets short phrases clip longer words
            # ("gas the" inside "gas theory")
            if re.search(rf"\b{re.escape(phrase)}\b", norm_p):
                return False, f"blocked phrase {phrase!r}"
            if (len(phrase) >= self.fuzzy_min_chars
                    and self._fuzzy_match(tokens_p, phrase)):
                return False, f"blocked phrase (fuzzy) {phrase!r}"
        return True, ""


# ---------------------------------------------------------------- LLM guard

class LLMTextGuard:
    """LLM-based prompt safety classifier (the Qwen3Guard slot,
    qwen3guard/qwen3guard.py:30-84). Loads local HF weights from
    ``model_path``, or takes pre-built ``tokenizer``/``model`` objects
    (chat-template + generate API) for tests and custom runtimes."""

    def __init__(self, model_path: str | None = None,
                 unsafe_markers: tuple[str, ...] = ("unsafe",),
                 tokenizer=None, model=None):
        if tokenizer is None or model is None:
            from transformers import AutoModelForCausalLM, AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(model_path)
            model = AutoModelForCausalLM.from_pretrained(model_path)
        self.tokenizer = tokenizer
        self.model = model
        self.unsafe_markers = unsafe_markers

    def __call__(self, prompt: str) -> tuple[bool, str]:
        msgs = [{"role": "user", "content": prompt}]
        text = self.tokenizer.apply_chat_template(
            msgs, tokenize=False, add_generation_prompt=True)
        ids = self.tokenizer(text, return_tensors="pt")
        out = self.model.generate(**ids, max_new_tokens=32)
        reply = self.tokenizer.decode(out[0][ids["input_ids"].shape[1]:],
                                      skip_special_tokens=True).lower()
        if any(m in reply for m in self.unsafe_markers):
            return False, f"classifier verdict: {reply[:80]}"
        return True, ""


# Qwen3Guard's published ternary taxonomy (the model's own output labels;
# qwen3guard/categories.py in the reference)
QWEN3GUARD_CATEGORIES = {
    "S1": "Violent",
    "S2": "Non-violent Illegal Acts",
    "S3": "Sexual Content or Sexual Acts",
    "S4": "Suicide & Self-Harm",
    "S5": "Unethical Acts",
    "S6": "Jailbreak",
}

_QWEN3_SAFETY_RE = re.compile(r"Safety: (Safe|Unsafe|Controversial)")
_QWEN3_CATEGORY_RE = re.compile(
    "(" + "|".join(re.escape(v) for v in QWEN3GUARD_CATEGORIES.values()) + ")")


def parse_qwen3guard_verdict(content: str) -> tuple[str | None, list[str]]:
    """Parse a Qwen3Guard-Gen generation into (label, categories).

    The model emits free text containing ``Safety: Safe|Unsafe|Controversial``
    plus zero or more category names from its taxonomy
    (qwen3guard/qwen3guard.py:58-76). Returns (None, []) when no safety
    line is present (malformed generation -> caller fails open, matching the
    reference's behavior)."""
    m = _QWEN3_SAFETY_RE.search(content)
    label = m.group(1) if m else None
    categories = _QWEN3_CATEGORY_RE.findall(content)
    return label, categories


class Qwen3Guard:
    """The actual Qwen3Guard protocol on top of the generic LLM slot
    (qwen3guard/qwen3guard.py:30-84): chat-template prompt construction,
    128-token generation, and ternary Safe/Controversial/Unsafe parsing.
    Blocks ONLY on "Unsafe" — "Controversial" passes, as in the reference.
    Parse failures and runtime errors fail OPEN (return safe) exactly like
    the reference's exception handler.

    Weights-gated: pass ``model_path`` pointing at local
    Qwen/Qwen3Guard-Gen-* weights, or inject ``tokenizer``/``model``
    objects (tests use canned fakes on the same API)."""

    def __init__(self, model_path: str | None = None, tokenizer=None,
                 model=None, max_new_tokens: int = 128):
        if tokenizer is None or model is None:
            from transformers import AutoModelForCausalLM, AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(model_path)
            model = AutoModelForCausalLM.from_pretrained(model_path)
        self.tokenizer = tokenizer
        self.model = model
        self.max_new_tokens = max_new_tokens

    def _generate(self, prompt: str) -> str:
        msgs = [{"role": "user", "content": prompt}]
        text = self.tokenizer.apply_chat_template(msgs, tokenize=False)
        ids = self.tokenizer([text], return_tensors="pt")
        out = self.model.generate(**ids, max_new_tokens=self.max_new_tokens)
        return self.tokenizer.decode(
            out[0][ids["input_ids"].shape[1]:], skip_special_tokens=True)

    def __call__(self, prompt: str) -> tuple[bool, str]:
        try:
            content = self._generate(prompt)
            label, categories = parse_qwen3guard_verdict(content)
        except Exception as e:  # fail open, as the reference does
            return True, f"Qwen3Guard error (failing open): {e}"
        if label is not None and label.lower() == "unsafe":
            return False, (f"Prompt blocked by Qwen3Guard. Safety: {label}, "
                           f"Categories: {categories}")
        return True, ""


# ---------------------------------------------------------------- video

class FrameSafetyClassifier:
    """Per-frame safety classifier slot (the SigLIP encoder + MLP head,
    video_content_safety_filter.py:50-130). ``classify_fn(frames_uint8) ->
    bool`` is injected (e.g. ``aux/safety_classifier.py:make_classify_fn``)."""

    def __init__(self, classify_fn: Callable[[np.ndarray], bool],
                 sample_every: int = 1):
        self.classify_fn = classify_fn
        self.sample_every = sample_every

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        sampled = frames[:: self.sample_every]
        if not self.classify_fn(sampled):
            raise GuardrailBlocked("video safety classifier rejected output")
        return frames


class FaceBlur:
    """Face-region blur postprocessor (the RetinaFace slot,
    face_blur_filter.py). ``detect_fn(frame) -> [(x0,y0,x1,y1), ...]``; a
    pixelation blur is applied to each detection. The in-repo detector is
    ``aux/face_detector.py:make_face_detect_fn`` (RetinaFace-R50)."""

    def __init__(self, detect_fn: Callable[[np.ndarray], list], block: int = 16):
        self.detect_fn = detect_fn
        self.block = block

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        out = frames.copy()
        for t in range(len(out)):
            for (x0, y0, x1, y1) in self.detect_fn(out[t]):
                region = out[t, y0:y1, x0:x1]
                h, w = region.shape[:2]
                if h < 2 or w < 2:
                    continue
                small = region[:: self.block, :: self.block]
                out[t, y0:y1, x0:x1] = np.kron(
                    small, np.ones((self.block, self.block, 1), np.uint8)
                )[:h, :w]
        return out


# ---------------------------------------------------------------- presets

def text_guardrail(blocklist_dir: str | None = None,
                   llm_guard_path: str | None = None) -> GuardrailRunner:
    """Text preset: blocklist (+ LLM classifier when weights are given) —
    common/presets.py:28-43."""
    checks: list[tuple[str, Callable]] = [
        ("blocklist", Blocklist.from_dir(blocklist_dir) if blocklist_dir else Blocklist()),
    ]
    if llm_guard_path:
        checks.append(("llm_guard", LLMTextGuard(llm_guard_path)))
    return GuardrailRunner(checks)


def video_guardrail(classify_fn=None, face_detect_fn=None) -> GuardrailRunner:
    """Video preset: safety classifier + face blur, each active only when
    its backing model is supplied."""
    checks = []
    if classify_fn is not None:
        checks.append(("video_safety", FrameSafetyClassifier(classify_fn)))
    if face_detect_fn is not None:
        checks.append(("face_blur", FaceBlur(face_detect_fn)))
    return GuardrailRunner(checks)
