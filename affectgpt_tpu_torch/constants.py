"""Modality patch-token names and media preprocessing constants.

The port's own copy of the part of affectgpt_tpu/constants.py it uses: the
reference's global token table (AffectGPT/config.py:121-126), whose six
placeholders are special tokens of the tokenizer, replicated once per query
token in prompts before tokenization; the label-masking sentinel; the audio
clip constants; the image normalization stats of the encoders' processors.
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

# labels outside the answer, ignored by the loss (HF convention)
IGNORE_INDEX = -100

# Audio front-end constants (reference: my_affectgpt/models/ImageBind/data.py:117-239).
AUDIO_SAMPLE_RATE = 16_000
AUDIO_CLIP_SECONDS = 2.0
AUDIO_CLIPS_PER_VIDEO = 8
AUDIO_NUM_MEL_BINS = 128
AUDIO_TARGET_FRAMES = 204
AUDIO_MEL_MEAN = -4.268
AUDIO_MEL_STD = 9.138

# CLIP image normalization (reference: my_affectgpt/processors/video_processor.py:412-414).
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)
# per-encoder processor stats (the reference runs each tower's own HF
# AutoImageProcessor, encoder.py:221/262): DINOv2 = ImageNet, SigLIP = 0.5
IMAGENET_IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGENET_IMAGE_STD = (0.229, 0.224, 0.225)
SIGLIP_IMAGE_MEAN = (0.5, 0.5, 0.5)
SIGLIP_IMAGE_STD = (0.5, 0.5, 0.5)
