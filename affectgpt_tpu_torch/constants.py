"""Modality patch-token names.

The port's own copy of the part of affectgpt_tpu/constants.py it uses (the
reference's global token table, AffectGPT/config.py:121-126). The six
placeholders are special tokens of the tokenizer and are replicated once per
query token in prompts before tokenization.
"""

DEFAULT_IMAGE_PATCH_TOKEN = "<ImageHere>"
DEFAULT_AUDIO_PATCH_TOKEN = "<AudioHere>"
DEFAULT_FRAME_PATCH_TOKEN = "<FrameHere>"
DEFAULT_FACE_PATCH_TOKEN = "<FaceHere>"
DEFAULT_MULTI_PATCH_TOKEN = "<MultiHere>"
DEFAULT_NONVERBAL_PATCH_TOKEN = "<NonverbalHere>"

ALL_PATCH_TOKENS = (
    DEFAULT_IMAGE_PATCH_TOKEN,
    DEFAULT_AUDIO_PATCH_TOKEN,
    DEFAULT_FRAME_PATCH_TOKEN,
    DEFAULT_FACE_PATCH_TOKEN,
    DEFAULT_MULTI_PATCH_TOKEN,
    DEFAULT_NONVERBAL_PATCH_TOKEN,
)
