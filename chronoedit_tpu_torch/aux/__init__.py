"""Guardrails and the models behind their video slots (the port of
``chronoedit_tpu/aux``)."""

from chronoedit_tpu_torch.aux.guardrails import (
    Blocklist,
    GuardrailRunner,
    Guardrails,
    text_guardrail,
    video_guardrail,
)

__all__ = ["Blocklist", "GuardrailRunner", "Guardrails", "text_guardrail",
           "video_guardrail", "make_face_detect_fn", "make_classify_fn"]


def make_face_detect_fn(*args, **kwargs):
    """Lazy re-export: RetinaFace detector for the FaceBlur slot."""
    from chronoedit_tpu_torch.aux.face_detector import make_face_detect_fn as fn

    return fn(*args, **kwargs)


def make_classify_fn(*args, **kwargs):
    """Lazy re-export: SigLIP safety classifier for the video-safety slot."""
    from chronoedit_tpu_torch.aux.safety_classifier import make_classify_fn as fn

    return fn(*args, **kwargs)
