"""Prompt assembly for multimodal conversations.

The port's own copy of `get_prompt_for_multimodal`,
`replace_token_for_multimodal` and the `NEEDED_DATA` table from
affectgpt_tpu/prompts.py: string-for-string
the reference templates (my_affectgpt/datasets/datasets/base_dataset.py:798-927),
so that tokenized prompts are identical in both packages.
"""

from __future__ import annotations

from typing import List, Optional

from affectgpt_tpu_torch import constants

_SUFFIX = "Now, please answer my question based on all the provided information. {user_message} ###Assistant: "
_AUDIO_PART = "The audio content is as follows: <Audio><AudioHere></Audio>. "
_FRAME_PART = "Meanwhile, we uniformly sample raw frames from the video: <Video><FrameHere></Video>. "
_FACE_PART = (
    "Meanwhile, we uniformly sample raw frames from the video and extract faces "
    "from these frames: <Video><FaceHere></Video>. "
)
# faceframe mode alone opens the face clause with "Additionally," because it
# follows the frame clause's "Meanwhile," (reference: base_dataset.py:812)
_FACE_PART_ADDITIONALLY = (
    "Additionally, we uniformly sample raw frames from the video and extract faces "
    "from these frames: <Video><FaceHere></Video>. "
)
_SUBTITLE_PART = "The subtitle of this video is: <Subtitle>{subtitle}</Subtitle>. "
_MULTI_PART = "The audio and video merged info is: <Multi><MultiHere></Multi>. "
_NONVERBAL_PART = (
    "The nonverbal clues (facial action units and audio emotion clues) are: "
    "<Nonverbal>{nonverbal_text}</Nonverbal>. "
)


# face_or_frame mode → which device-side modalities must be loaded
# (reference: base_dataset.py:298-335).
NEEDED_DATA = {
    "faceframe": ["audio", "frame", "face"],
    "face": ["audio", "face"],
    "frame": ["audio", "frame"],
    "audioonly": ["audio"],
    "textonly": [],
    "faceonly": ["face"],
    "frameonly": ["frame"],
    "multiface_text": ["face", "audio", "multi"],
    "multiface_audio_face_text": ["face", "audio", "multi"],
    "image": ["image"],
    "multiframe_audio_frame_text": ["frame", "audio", "multi"],
    "multiface_audio_face_frame_text": ["frame", "face", "audio", "multi"],
    "multiface_audio_face_frame_au_text": ["frame", "face", "audio", "multi"],
    "multiface_audio_face_au_text": ["face", "audio", "multi"],
    "audio_text": ["audio"],
    "face_text": ["face"],
    "frame_text": ["frame"],
}


def get_needed_data(face_or_frame: str) -> List[str]:
    try:
        return list(NEEDED_DATA[face_or_frame])
    except KeyError:
        raise ValueError(f"Unknown face_or_frame mode: {face_or_frame}") from None


def get_prompt_for_multimodal(
    face_or_frame: str,
    subtitle: Optional[str],
    user_message: str,
    nonverbal_text: Optional[str] = None,
) -> str:
    """Build the human-turn prompt for a given modality combination."""
    suffix = _SUFFIX.format(user_message=user_message)

    def sub() -> str:
        if subtitle is None:
            raise ValueError(f"mode {face_or_frame!r} needs a subtitle")
        return _SUBTITLE_PART.format(subtitle=subtitle)

    if face_or_frame == "faceframe":
        return "###Human: " + _AUDIO_PART + _FRAME_PART + _FACE_PART_ADDITIONALLY + sub() + suffix
    if face_or_frame == "face":
        return "###Human: " + _AUDIO_PART + _FACE_PART + sub() + suffix
    if face_or_frame == "frame":
        return "###Human: " + _AUDIO_PART + _FRAME_PART + sub() + suffix
    if face_or_frame == "audioonly":
        return "###Human: " + _AUDIO_PART + suffix
    if face_or_frame == "textonly":
        return "###Human: " + sub() + suffix
    if face_or_frame == "faceonly":
        return (
            "###Human: We uniformly sample raw frames from the video and extract "
            "faces from these frames: <Video><FaceHere></Video>. " + suffix
        )
    if face_or_frame == "frameonly":
        return (
            "###Human: We uniformly sample raw frames from the video: "
            "<Video><FrameHere></Video>. " + suffix
        )
    if face_or_frame == "image":
        return (
            "###Human: The image content is as follows: <Image><ImageHere></Image>. "
            + suffix
        )
    # Ablation modes for fair comparison with other MLLMs (no ###Human prefix).
    if face_or_frame == "audio_text":
        return _AUDIO_PART + sub() + suffix
    if face_or_frame == "face_text":
        return (
            "We uniformly sample raw frames from the video and extract faces from "
            "these frames: <Video><FaceHere></Video>. " + sub() + suffix
        )
    if face_or_frame == "frame_text":
        return (
            "we uniformly sample raw frames from the video: "
            "<Video><FrameHere></Video>. " + sub() + suffix
        )
    # Pre-fusion (<Multi>) modes.
    if face_or_frame == "multiface_text":
        return "###Human: " + _MULTI_PART + sub() + suffix
    if face_or_frame == "multiface_audio_face_text":
        return "###Human: " + _MULTI_PART + _AUDIO_PART + _FACE_PART + sub() + suffix
    if face_or_frame == "multiframe_audio_frame_text":
        return "###Human: " + _MULTI_PART + _AUDIO_PART + _FRAME_PART + sub() + suffix
    if face_or_frame == "multiface_audio_face_frame_text":
        return (
            "###Human: " + _MULTI_PART + _AUDIO_PART + _FACE_PART + _FRAME_PART
            + sub() + suffix
        )
    if face_or_frame == "multiface_audio_face_frame_au_text":
        nonverbal = (
            _NONVERBAL_PART.format(nonverbal_text=nonverbal_text) if nonverbal_text else ""
        )
        return (
            "###Human: " + _MULTI_PART + _AUDIO_PART + _FACE_PART + _FRAME_PART
            + nonverbal + sub() + suffix
        )
    if face_or_frame == "multiface_audio_face_au_text":
        nonverbal = (
            _NONVERBAL_PART.format(nonverbal_text=nonverbal_text) if nonverbal_text else ""
        )
        return "###Human: " + _MULTI_PART + _AUDIO_PART + _FACE_PART + nonverbal + sub() + suffix
    raise ValueError(f"Unknown face_or_frame mode: {face_or_frame}")


def replace_token_for_multimodal(
    prompt: str,
    num_video_query_token: int,
    num_audio_query_token: int,
    num_multi_query_token: int,
    num_image_query_token: int,
) -> str:
    """Replicate each modality placeholder to one token per query slot
    (reference: base_dataset.py:914-927). Frame and face share the video count."""
    for token, n in (
        (constants.DEFAULT_FRAME_PATCH_TOKEN, num_video_query_token),
        (constants.DEFAULT_FACE_PATCH_TOKEN, num_video_query_token),
        (constants.DEFAULT_AUDIO_PATCH_TOKEN, num_audio_query_token),
        (constants.DEFAULT_MULTI_PATCH_TOKEN, num_multi_query_token),
        (constants.DEFAULT_IMAGE_PATCH_TOKEN, num_image_query_token),
    ):
        prompt = prompt.replace(token, token * n)
    return prompt
