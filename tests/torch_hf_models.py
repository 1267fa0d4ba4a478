"""Tiny HF model directories for the port's loader tests, built from configs
with `transformers` and `tokenizers` (no download): a Qwen2ForCausalLM, a
CLIPModel, a HubertModel and a Qwen2-style tokenizer, at the geometries of
the JAX package's tiny configs so the towers plug into the tiny bootstrap."""

import dataclasses
import json

import numpy as np
import torch

LLM = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, head_dim=8, rope_theta=1_000_000.0, rms_norm_eps=1e-6)
LLM_VOCAB = 1280  # above the test tokenizer's 1234 tokens

SPECIALS = ["<|endoftext|>", "<|im_start|>", "<|im_end|>", "<|object_ref_start|>",
            "<|object_ref_end|>", "<|box_start|>", "<|box_end|>", "<|quad_start|>",
            "<|quad_end|>", "<|vision_start|>", "<|vision_end|>", "<|vision_pad|>",
            "<|image_pad|>", "<|video_pad|>", "<tool_call>", "</tool_call>", "<|fim_prefix|>",
            "<|fim_middle|>", "<|fim_suffix|>", "<|fim_pad|>", "<|repo_name|>", "<|file_sep|>"]

CORPUS = [
    "I can't believe you did that for me. We're fine, THEY'LL come, I'M here, he'd go.",
    "你好世界，我们赢了！为什么总是这样？ 今天天气很好。",
    "Numbers: 123 4567 89, ² ³ ½ Ⅻ ٣٤٥ and 2024-10-18.",
    "Emoji 😀😂😍 and ſpelling; tabs\there, lines\r\n\r\n  and   spaces   ",
    "Ελληνικά και Русский текст с пробелами. café naïve résumé",
    "ひらがなのテキスト、日本語 「引用」 — dash … ellipsis",
    "Please infer the person's emotional state and provide your reasoning process.",
    "The character's subtitle content: so happy. Emotions? ### Assistant: The person feels",
]


def qwen_config(cls, vocab_size: int = LLM_VOCAB, lora_r: int = 16):
    """The tiny HF Qwen2 geometry as a QwenConfig of either package (`cls`),
    in the signature of `QwenConfig.qwen25_7b`."""
    return cls(vocab_size=vocab_size, hidden_size=32, intermediate_size=64, num_layers=2,
               num_heads=4, num_kv_heads=2, head_dim=8, rope_theta=1_000_000.0, rms_eps=1e-6,
               lora_r=lora_r)


def qwen2_model(seed: int = 0, vocab_size: int = LLM_VOCAB, tie: bool = False):
    from transformers import Qwen2Config, Qwen2ForCausalLM

    torch.manual_seed(seed)
    cfg = Qwen2Config(vocab_size=vocab_size, tie_word_embeddings=tie,
                      attn_implementation="eager", **LLM)
    model = Qwen2ForCausalLM(cfg).eval()
    with torch.no_grad():  # HF inits biases to 0: give them values
        for name, p in model.named_parameters():
            if name.endswith("bias") or "norm" in name:
                p.add_(torch.randn_like(p) * 0.1)
    return model


def clip_model(projection_dim: int = 12, seed: int = 0):
    """CLIPModel at ClipVisionConfig.tiny() (projection 12) or, with
    projection_dim=8, the text tower of ClipTextConfig.tiny()."""
    from transformers import CLIPConfig, CLIPModel

    torch.manual_seed(seed)
    cfg = CLIPConfig(
        text_config=dict(vocab_size=64, hidden_size=16, intermediate_size=32,
                         num_hidden_layers=2, num_attention_heads=2, max_position_embeddings=16,
                         hidden_act="quick_gelu", eos_token_id=63),
        vision_config=dict(hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                           num_attention_heads=2, image_size=28, patch_size=14,
                           hidden_act="quick_gelu"),
        projection_dim=projection_dim)
    model = CLIPModel(cfg).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") or "norm" in name:
                p.add_(torch.randn_like(p) * 0.1)
    return model


def hubert_model(seed: int = 0):
    """HubertModel at HubertConfig.tiny() (stable layer norm)."""
    from transformers import HubertConfig, HubertModel

    torch.manual_seed(seed)
    cfg = HubertConfig(
        vocab_size=32, hidden_size=16, num_hidden_layers=3, num_attention_heads=2,
        intermediate_size=32, conv_dim=(8, 8), conv_kernel=(10, 3), conv_stride=(5, 2),
        num_feat_extract_layers=2, conv_bias=True, feat_extract_norm="layer",
        do_stable_layer_norm=True, num_conv_pos_embeddings=8, num_conv_pos_embedding_groups=2,
        feat_proj_dropout=0.0, hidden_dropout=0.0, attention_dropout=0.0, layerdrop=0.0,
        apply_spec_augment=False)
    model = HubertModel(cfg).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") or "norm" in name:
                p.add_(torch.randn_like(p) * 0.1)
    return model


def hubert_state(model, form: str) -> dict:
    """HuBERT's state dict with its positional conv in one of the three key
    forms: "parametrizations" (original0 = g, original1 = v), "weight_g"
    (weight_g / weight_v) or "plain" (the materialized weight)."""
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    base = "encoder.pos_conv_embed.conv"
    g = sd.pop(f"{base}.parametrizations.weight.original0")
    v = sd.pop(f"{base}.parametrizations.weight.original1")
    if form == "parametrizations":
        sd[f"{base}.parametrizations.weight.original0"] = g
        sd[f"{base}.parametrizations.weight.original1"] = v
    elif form == "weight_g":
        sd[f"{base}.weight_g"], sd[f"{base}.weight_v"] = g, v
    else:
        sd[f"{base}.weight"] = torch._weight_norm(v, g, 2)
    return sd


def write_qwen2_tokenizer(out_dir, vocab_size: int = 1200) -> None:
    """tokenizer.json (a byte-level BPE trained on CORPUS by `tokenizers`,
    Qwen2's normalizer, pre-tokenizer and decoder, SPECIALS after the vocab)
    and tokenizer_config.json as Qwen2.5-Instruct's (eos <|im_end|>)."""
    from tokenizers import Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers, \
        trainers

    from affectgpt_tpu_torch.tokenization import QWEN2_PATTERN

    tok = Tokenizer(models.BPE(ignore_merges=False))
    tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(QWEN2_PATTERN), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=vocab_size, show_progress=False,
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(CORPUS * 20, trainer)
    tok.add_special_tokens(SPECIALS)
    out_dir.mkdir(parents=True, exist_ok=True)
    tok.save(str(out_dir / "tokenizer.json"))
    spec = json.loads((out_dir / "tokenizer.json").read_text(encoding="utf-8"))
    decoder = {str(t["id"]): {k: v for k, v in t.items() if k != "id"}
               for t in spec["added_tokens"]}
    (out_dir / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "Qwen2Tokenizer", "bos_token": None, "eos_token": "<|im_end|>",
        "pad_token": "<|endoftext|>", "clean_up_tokenization_spaces": False,
        "errors": "replace", "model_max_length": 32768, "split_special_tokens": False,
        "added_tokens_decoder": decoder}))


def write_llm_dir(out_dir, seed: int = 0, **save_kw):
    """The tiny Qwen2 checkpoint and the tokenizer in one directory (an
    LLM directory as PATH_TO_LLM names it). Returns the HF model."""
    model = qwen2_model(seed)
    model.save_pretrained(str(out_dir), **save_kw)
    write_qwen2_tokenizer(out_dir)
    return model


def flat(tree, prefix: str = ""):
    """(path, leaf) pairs of a nested dict/list tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def bits(x) -> np.ndarray:
    """A leaf's values as f32 bits (bf16 widens exactly), for bit-for-bit
    comparisons across the packages."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        arr = (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    else:
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
    return np.ascontiguousarray(arr).view(np.uint8)


def assert_same_tree(jax_tree, port_tree) -> None:
    """The two trees have the same paths, shapes and dtypes (torch.float32 ~
    float32, torch.bfloat16 ~ bfloat16) and equal bits."""
    want, got = dict(flat(jax_tree)), dict(flat(port_tree))
    assert sorted(want) == sorted(got)
    for path, leaf in want.items():
        other = got[path]
        assert tuple(np.shape(leaf)) == tuple(other.shape), path
        assert str(np.asarray(leaf).dtype) == str(other.dtype).replace("torch.", ""), path
        assert other.is_contiguous(), path
        np.testing.assert_array_equal(bits(leaf), bits(other), err_msg=path)


def set_tiny_presets(monkeypatch) -> None:
    """Both packages' Qwen25 preset at the tiny HF Qwen2 geometry, and their
    CLIP_VIT_LARGE / HUBERT_LARGE specs and ViT-L/14, HuBERT-large and
    ViT-B/32 text configs at the tiny ones."""
    from affectgpt_tpu import registry as jregistry
    from affectgpt_tpu.models import clip_vit as jclip
    from affectgpt_tpu.models import encoders as jencoders  # noqa: F401 (registers the specs)
    from affectgpt_tpu.models import hubert as jhubert
    from affectgpt_tpu.models import qwen2 as jq
    from affectgpt_tpu_torch.models import clip_vit, encoders, hubert
    from affectgpt_tpu_torch.models import qwen2 as tq

    for cls in (jq.QwenConfig, tq.QwenConfig):
        monkeypatch.setattr(cls, "qwen25_7b", classmethod(qwen_config))
    for clip, hub in ((jclip, jhubert), (clip_vit, hubert)):
        monkeypatch.setattr(clip.ClipVisionConfig, "vit_l_14",
                            classmethod(lambda cls: cls.tiny()))
        monkeypatch.setattr(clip.ClipTextConfig, "vit_b_32_text",
                            classmethod(lambda cls: cls.tiny()))
        monkeypatch.setattr(hub.HubertConfig, "large", classmethod(lambda cls: cls.tiny()))
    for ns, name, make in (("visual_encoder", "CLIP_VIT_LARGE", jclip.ClipVisionConfig.tiny),
                           ("acoustic_encoder", "HUBERT_LARGE", jhubert.HubertConfig.tiny)):
        spec = dataclasses.replace(jregistry.get(ns, name), make_config=make)
        monkeypatch.setitem(jregistry._REGISTRY[ns], name, spec)
    monkeypatch.setitem(encoders.VISUAL, "CLIP_VIT_LARGE", dataclasses.replace(
        encoders.VISUAL["CLIP_VIT_LARGE"], make_config=clip_vit.ClipVisionConfig.tiny))
    monkeypatch.setitem(encoders.ACOUSTIC, "HUBERT_LARGE", dataclasses.replace(
        encoders.ACOUSTIC["HUBERT_LARGE"], make_config=hubert.HubertConfig.tiny))


def write_model_dirs(root, monkeypatch):
    """The tiny LLM (sharded, with its tokenizer), CLIP (vision at
    projection 12), CLIP text (projection 8) and HuBERT (.bin, weight_g
    form) directories under `root`, named by both packages' path tables."""
    from affectgpt_tpu import paths as jpaths
    from affectgpt_tpu_torch import paths as tpaths

    write_llm_dir(root / "llm", safe_serialization=True, max_shard_size="20KB")
    clip_model().save_pretrained(str(root / "clip"))
    clip_model(projection_dim=8, seed=1).save_pretrained(str(root / "clip_text"))
    (root / "hubert").mkdir(parents=True, exist_ok=True)
    torch.save(hubert_state(hubert_model(), "weight_g"), root / "hubert" / "pytorch_model.bin")
    for table, key, sub in (("PATH_TO_LLM", "Qwen25", "llm"),
                            ("PATH_TO_VISUAL", "CLIP_VIT_LARGE", "clip"),
                            ("PATH_TO_VISUAL", "CLIP_VIT_BASE32", "clip_text"),
                            ("PATH_TO_AUDIO", "HUBERT_LARGE", "hubert")):
        for paths in (jpaths, tpaths):
            monkeypatch.setitem(getattr(paths, table), key, str(root / sub))
    return root
