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


# ---------------------------------------------------------------------------
# Llama-2 and Baichuan2 tokenizers: a Llama-2-form tokenizer.json and
# sentencepiece tokenizer.model files (unigram and BPE), learned from CORPUS
# by `tokenizers` and written with the protobuf schema transformers vendors

SP_SPECIALS = ["<unk>", "<s>", "</s>"]
BYTE_PIECES = [f"<0x{b:02X}>" for b in range(256)]
USER_DEFINED = "<sep>"  # a user-defined piece of the sentencepiece models


def _train_metaspace(model, trainer):
    """`model` trained by `trainer` on CORPUS with Llama's normalizer
    ("▁" prepended, spaces replaced) and words split before each "▁"."""
    from tokenizers import Tokenizer, normalizers, pre_tokenizers

    tok = Tokenizer(model)
    tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                           normalizers.Replace(" ", "▁")])
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="never",
                                                 split=True)
    tok.train_from_iterator(CORPUS * 20, trainer)
    return json.loads(tok.to_str())["model"]


def _bpe_pieces(vocab_size: int):
    """(pieces in Llama's order: the specials, the 256 byte pieces, the
    merged pieces in merge order, then the single characters; merges)."""
    from tokenizers import models, trainers

    model = _train_metaspace(models.BPE(unk_token="<unk>"), trainers.BpeTrainer(
        vocab_size=vocab_size, special_tokens=SP_SPECIALS, show_progress=False))
    merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m) for m in model["merges"]]
    merged = list(dict.fromkeys(a + b for a, b in merges))
    chars = [t for t in sorted(model["vocab"], key=model["vocab"].get)
             if t not in SP_SPECIALS and t not in merged]
    return SP_SPECIALS + BYTE_PIECES + merged + chars, merges


def write_llama2_tokenizer(out_dir, vocab_size: int = 700) -> None:
    """tokenizer.json of Llama-2's form (Prepend + Replace normalizer, no
    pre-tokenizer, BPE with byte_fallback and fuse_unk, the Replace /
    ByteFallback / Fuse / Strip decoder) with the vocabulary laid out as
    Llama-2's, and Llama-2's tokenizer_config.json."""
    from tokenizers import AddedToken, Tokenizer, decoders, models, normalizers

    pieces, merges = _bpe_pieces(vocab_size)
    tok = Tokenizer(models.BPE({p: i for i, p in enumerate(pieces)}, merges,
                               unk_token="<unk>", fuse_unk=True, byte_fallback=True))
    tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                           normalizers.Replace(" ", "▁")])
    tok.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(),
                                     decoders.Fuse(), decoders.Strip(" ", 1, 0)])
    tok.add_special_tokens([AddedToken(t, normalized=False) for t in SP_SPECIALS])
    out_dir.mkdir(parents=True, exist_ok=True)
    tok.save(str(out_dir / "tokenizer.json"))
    (out_dir / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "LlamaTokenizer", "bos_token": "<s>", "eos_token": "</s>",
        "unk_token": "<unk>", "pad_token": None, "add_bos_token": True,
        "add_eos_token": False, "clean_up_tokenization_spaces": False, "legacy": False,
        "model_max_length": 4096}))


def sentencepiece_proto(kind: str, vocab_size: int = 500, add_dummy_prefix: bool = True):
    """A sentencepiece ModelProto (transformers' vendored schema) learned
    from CORPUS: "unigram" (the specials, the byte pieces, USER_DEFINED, then
    the unigram pieces with their log-probabilities) or "bpe" (Llama's
    layout, each merged piece scored by minus its merge rank, the characters
    below them), identity normalizer, byte fallback."""
    try:
        from transformers.utils import sentencepiece_model_pb2_new as sp
    except ImportError:  # older transformers layout
        from transformers.utils import sentencepiece_model_pb2 as sp
    from tokenizers import models, trainers

    piece_type = sp.ModelProto.SentencePiece
    if kind == "unigram":
        model = _train_metaspace(models.Unigram(), trainers.UnigramTrainer(
            vocab_size=vocab_size, special_tokens=SP_SPECIALS, unk_token="<unk>",
            show_progress=False))
        learned = [(p, s) for p, s in model["vocab"] if p not in SP_SPECIALS]
        body = [(USER_DEFINED, 0.0, piece_type.USER_DEFINED)] + \
            [(p, s, piece_type.NORMAL) for p, s in learned]
    else:
        pieces, merges = _bpe_pieces(vocab_size)
        body = [(p, -float(i), piece_type.NORMAL)
                for i, p in enumerate(pieces[len(SP_SPECIALS) + 256:])]
    m = sp.ModelProto()
    m.trainer_spec.model_type = sp.TrainerSpec.UNIGRAM if kind == "unigram" else sp.TrainerSpec.BPE
    m.trainer_spec.unk_id, m.trainer_spec.bos_id, m.trainer_spec.eos_id = 0, 1, 2
    m.trainer_spec.byte_fallback = True
    m.normalizer_spec.name = "identity"
    m.normalizer_spec.add_dummy_prefix = add_dummy_prefix
    m.normalizer_spec.remove_extra_whitespaces = False
    head = [("<unk>", 0.0, piece_type.UNKNOWN), ("<s>", 0.0, piece_type.CONTROL),
            ("</s>", 0.0, piece_type.CONTROL)] + [(b, 0.0, piece_type.BYTE) for b in BYTE_PIECES]
    for piece, score, kind_ in head + body:
        p = m.pieces.add()
        p.piece, p.score, p.type = piece, score, kind_
    return m


def write_sentencepiece_model(out_dir, kind: str, **kw) -> None:
    """tokenizer.model (sentencepiece_proto) and a tokenizer_config.json
    naming a sentencepiece-backed class, as a Baichuan2 directory holds."""
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "tokenizer.model").write_bytes(sentencepiece_proto(kind, **kw).SerializeToString())
    (out_dir / "tokenizer_config.json").write_text(
        json.dumps({"tokenizer_class": "LlamaTokenizer"}))


# ---------------------------------------------------------------------------
# The encoder zoo's HF towers at the JAX package's tiny geometries

_NO_DROPOUT = dict(hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                   feat_proj_dropout=0.0, layerdrop=0.0, apply_spec_augment=False)
_WAV = dict(vocab_size=32, hidden_size=16, num_hidden_layers=3, num_attention_heads=2,
            intermediate_size=32, conv_dim=(8, 8), conv_kernel=(10, 3), conv_stride=(5, 2),
            num_feat_extract_layers=2, conv_bias=True, feat_extract_norm="layer")


def _perturbed(model):
    """HF inits biases, norms and layer scales to constants: give them
    values, so every leaf shapes the output."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") or "norm" in name or "lambda" in name or "const" in name:
                p.add_(torch.randn_like(p) * 0.1)
    return model.eval()


def dinov2_model(seed: int = 0):
    """Dinov2Model at Dinov2Config.tiny() (28 px, patch 14, width 16)."""
    from transformers import Dinov2Config, Dinov2Model

    torch.manual_seed(seed)
    return _perturbed(Dinov2Model(Dinov2Config(
        hidden_size=16, num_hidden_layers=2, num_attention_heads=2, mlp_ratio=2,
        image_size=28, patch_size=14, use_swiglu_ffn=False, attn_implementation="eager")))


def siglip_model(seed: int = 0):
    """SiglipVisionModel at SiglipConfig.tiny() (32 px, patch 16, width 16)."""
    from transformers import SiglipVisionConfig, SiglipVisionModel

    torch.manual_seed(seed)
    return _perturbed(SiglipVisionModel(SiglipVisionConfig(
        hidden_size=16, num_hidden_layers=2, num_attention_heads=2, intermediate_size=32,
        image_size=32, patch_size=16, attn_implementation="eager")))


def wavlm_model(seed: int = 0):
    """WavLMModel at WavLMConfig.tiny() (stable layer norm, 8 buckets)."""
    from transformers import WavLMConfig, WavLMModel

    torch.manual_seed(seed)
    return _perturbed(WavLMModel(WavLMConfig(
        **_WAV, do_stable_layer_norm=True, num_conv_pos_embeddings=8,
        num_conv_pos_embedding_groups=2, num_buckets=8, max_bucket_distance=16, **_NO_DROPOUT)))


def data2vec_audio_model(seed: int = 0):
    """Data2VecAudioModel at Data2VecAudioConfig.tiny() (2 positional
    convolutions of kernel 5)."""
    from transformers import Data2VecAudioConfig, Data2VecAudioModel

    torch.manual_seed(seed)
    return _perturbed(Data2VecAudioModel(Data2VecAudioConfig(
        **_WAV, num_conv_pos_embeddings=2, conv_pos_kernel_size=5,
        num_conv_pos_embedding_groups=2, **_NO_DROPOUT)))


def eva_state(seed: int = 0, width: int = 16, layers: int = 2, mlp: int = 32, patch: int = 14,
              grid: int = 2) -> dict:
    """A state dict with the names and shapes of an EVA ViT checkpoint
    (eva_vit.py's VisionTransformer), random values."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=g) * 0.1  # noqa: E731
    state = {"patch_embed.proj.weight": r(width, 3, patch, patch),
             "patch_embed.proj.bias": r(width), "cls_token": r(1, 1, width),
             "pos_embed": r(1, grid * grid + 1, width)}
    for i in range(layers):
        p = f"blocks.{i}"
        state.update({f"{p}.norm1.weight": 1 + r(width), f"{p}.norm1.bias": r(width),
                      f"{p}.attn.qkv.weight": r(3 * width, width), f"{p}.attn.q_bias": r(width),
                      f"{p}.attn.v_bias": r(width), f"{p}.attn.proj.weight": r(width, width),
                      f"{p}.attn.proj.bias": r(width), f"{p}.norm2.weight": 1 + r(width),
                      f"{p}.norm2.bias": r(width), f"{p}.mlp.fc1.weight": r(mlp, width),
                      f"{p}.mlp.fc1.bias": r(mlp), f"{p}.mlp.fc2.weight": r(width, mlp),
                      f"{p}.mlp.fc2.bias": r(width)})
    return state


def imagebind_audio_state(seed: int = 0, width: int = 16, layers: int = 2, mlp: int = 32,
                          kernel: int = 16, tokens: int = 9, out: int = 12) -> dict:
    """A state dict with the names and shapes of imagebind_huge's audio
    branch (ImageBindAudioConfig.tiny(): 2 x 4 patches + cls), random
    values."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=g) * 0.1  # noqa: E731
    pre, trunk = "modality_preprocessors.audio", "modality_trunks.audio"
    state = {f"{pre}.audio_stem.proj.0.weight": r(width, 1, kernel, kernel),
             f"{pre}.audio_stem.norm_layer.weight": 1 + r(width),
             f"{pre}.audio_stem.norm_layer.bias": r(width), f"{pre}.cls_token": r(1, 1, width),
             f"{pre}.pos_embedding_helper.pos_embed": r(1, tokens, width),
             "modality_heads.audio.0.weight": 1 + r(width), "modality_heads.audio.0.bias": r(width),
             "modality_heads.audio.2.weight": r(out, width)}
    for i in range(layers):
        p = f"{trunk}.blocks.{i}"
        state.update({f"{p}.norm_1.weight": 1 + r(width), f"{p}.norm_1.bias": r(width),
                      f"{p}.attn.in_proj_weight": r(3 * width, width),
                      f"{p}.attn.in_proj_bias": r(3 * width),
                      f"{p}.attn.out_proj.weight": r(width, width),
                      f"{p}.attn.out_proj.bias": r(width), f"{p}.norm_2.weight": 1 + r(width),
                      f"{p}.norm_2.bias": r(width), f"{p}.mlp.fc1.weight": r(mlp, width),
                      f"{p}.mlp.fc1.bias": r(mlp), f"{p}.mlp.fc2.weight": r(width, mlp),
                      f"{p}.mlp.fc2.bias": r(width)})
    return state
