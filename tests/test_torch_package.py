"""Package-level guards of the PyTorch port: it never imports jax or the
JAX package, its entry points default to the card, its config dataclasses
keep the JAX package's fields and defaults, and a kernel wrapper given CPU
tensors runs the plain version without counting a launch."""

import dataclasses
import inspect
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import affectgpt_tpu_torch
from affectgpt_tpu.inference import generate as jgen
from affectgpt_tpu_torch import bootstrap
from affectgpt_tpu.models import affectgpt as ja
from affectgpt_tpu.models import clip_vit as jclip
from affectgpt_tpu.models import hubert as jhub
from affectgpt_tpu.models import mergers as jm
from affectgpt_tpu.models import qformer as jqf
from affectgpt_tpu.models import qwen2 as jq
from affectgpt_tpu_torch.data import ingest, jpeg_encode
from affectgpt_tpu_torch.evaluation import __main__ as teval
from affectgpt_tpu_torch.inference import generate as tgen
from affectgpt_tpu_torch.inference import paged as tpaged
from affectgpt_tpu_torch.models import affectgpt as ta
from affectgpt_tpu_torch.models import clip_vit as tclip
from affectgpt_tpu_torch.models import convert
from affectgpt_tpu_torch.models import hubert as thub
from affectgpt_tpu_torch.models import mergers as tm
from affectgpt_tpu_torch.models import qformer as tqf
from affectgpt_tpu_torch.models import qwen2 as tq
from affectgpt_tpu_torch.ops import _build
from affectgpt_tpu_torch.ops import paged_attention as paged_ops
from affectgpt_tpu_torch.ops.decode_mlp import decode_mlp
from affectgpt_tpu_torch.ops.decode_mlp_bf16 import decode_mlp_bf16
from affectgpt_tpu_torch.ops.decode_qkv import decode_qkv

REPO = Path(__file__).resolve().parent.parent
# packages the card's installation lacks
ABSENT_ON_THE_CARD = ("yaml", "pandas", "transformers", "tokenizers", "safetensors", "regex",
                      "google.protobuf", "sentencepiece", "sklearn", "PIL", "cv2", "decord")
# those the port may try inside a function: PyYAML in Config.from_file, PIL for
# image-caption samples, cv2 and decord as rungs of the video ladders
TRIED_INSIDE_A_FUNCTION = ("yaml", "PIL", "cv2", "decord")


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(affectgpt_tpu_torch.__path__, "affectgpt_tpu_torch.")
    )


def test_port_imports_without_jax():
    """Every port module, and chip_smoke.py with all it imports, load with
    `import jax`, `import affectgpt_tpu` and the import of every package of
    ABSENT_ON_THE_CARD (PyYAML, pandas, transformers, tokenizers,
    safetensors, regex, protobuf, sentencepiece, sklearn, PIL, cv2, decord)
    made to fail."""
    modules = _port_modules() + ["chip_smoke"]
    assert "affectgpt_tpu_torch.inference.chat" in modules and len(modules) >= 22
    assert {"affectgpt_tpu_torch.models.au_agent", "affectgpt_tpu_torch.models.qformer",
            "affectgpt_tpu_torch.utils.clip_text", "affectgpt_tpu_torch.registry",
            "affectgpt_tpu_torch.training.optim", "affectgpt_tpu_torch.training.train_step",
            "affectgpt_tpu_torch.training.checkpoint", "affectgpt_tpu_torch.ops.audio",
            "affectgpt_tpu_torch.ops.augment", "affectgpt_tpu_torch.ops.jpeg",
            "affectgpt_tpu_torch.config", "affectgpt_tpu_torch.train",
            "affectgpt_tpu_torch.training.runner", "affectgpt_tpu_torch.parallel.mesh",
            "affectgpt_tpu_torch.data.datasets", "affectgpt_tpu_torch.data.loaders",
            "affectgpt_tpu_torch.data.media", "affectgpt_tpu_torch.ops.sampling",
            "affectgpt_tpu_torch.utils.logging", "affectgpt_tpu_torch.inference_hybird",
            "affectgpt_tpu_torch.inference_sample",
            "affectgpt_tpu_torch.extract_multimodal_features_precompute",
            "affectgpt_tpu_torch.models.vit_variants", "affectgpt_tpu_torch.models.eva_vit",
            "affectgpt_tpu_torch.models.wav_encoders",
            "affectgpt_tpu_torch.models.imagebind_audio", "affectgpt_tpu_torch.utils.xlsx",
            "affectgpt_tpu_torch.evaluation.wheel", "affectgpt_tpu_torch.evaluation.ew_metric",
            "affectgpt_tpu_torch.evaluation.judge", "affectgpt_tpu_torch.evaluation.__main__",
            "affectgpt_tpu_torch.evaluation_scoreonly",
            "affectgpt_tpu_torch.evaluation_emotion_llama", "affectgpt_tpu_torch.compare_outputs",
            "affectgpt_tpu_torch.verify_au_pipeline",
            "affectgpt_tpu_torch.ovmer.zero_shot_harness",
            "affectgpt_tpu_torch.mer_unibench.extract_frame_emotion_peak_batch",
            "affectgpt_tpu_torch.au_agent_finetune.prepare_au_instruction_dataset",
            "affectgpt_tpu_torch.au_agent_finetune.train_au_agent",
            "affectgpt_tpu_torch.data.corpus_recipes", "affectgpt_tpu_torch.data.ingest",
            "affectgpt_tpu_torch.data.jpeg_encode"} <= set(modules)
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"  # any `import jax` now raises ImportError
        "sys.modules['affectgpt_tpu'] = None\n"  # and so does the JAX package
        f"for blocked in {ABSENT_ON_THE_CARD!r}:\n"
        "    sys.modules[blocked] = None\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(k == b or k.startswith(b + '.') for b in ('jax', 'affectgpt_tpu') + "
        f"{ABSENT_ON_THE_CARD!r}\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


@pytest.mark.parametrize("entry", [bootstrap.build_model, convert.from_jax,
                                   convert.tree_to_torch, tq.init_cache,
                                   tpaged.init_paged_cache, convert.convert_qwen2,
                                   convert.convert_baichuan2, convert.convert_clip_vision,
                                   convert.convert_clip_text, convert.convert_hubert,
                                   convert.convert_reference_affectgpt,
                                   ingest.write_mjpeg_avi, ingest.transcode_video,
                                   ingest.transcode_tree, ingest.segment_transcode,
                                   jpeg_encode.encode_frames, teval.build_judge,
                                   teval.main_zeroshot_scores],
                         ids=lambda f: f.__name__)
def test_entry_points_default_to_the_card(entry):
    assert inspect.signature(entry).parameters["device"].default == "cuda"


def test_no_import_of_what_the_card_lacks():
    """No line of the port or of chip_smoke.py imports a package the card
    lacks, not even inside a function (which the import test cannot see),
    but those TRIED_INSIDE_A_FUNCTION."""
    import re

    never = [m for m in ABSENT_ON_THE_CARD if m not in TRIED_INSIDE_A_FUNCTION]
    pattern = re.compile(r"^\s*(?:import|from)\s+(" + "|".join(map(re.escape, never)) + r")\b")
    sources = sorted((REPO / "affectgpt_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    found = [f"{path.relative_to(REPO)}:{i}" for path in sources
             for i, line in enumerate(path.read_text().splitlines(), 1) if pattern.match(line)]
    assert len(sources) > 60 and not found, found


def test_init_cache_without_device_needs_a_card():
    """No fallback: the KV cache goes to the card unless the caller asks for
    the CPU."""
    cfg = tq.QwenConfig.tiny()
    if torch.cuda.is_available():
        assert tq.init_cache(cfg, 1, 4)[0]["k"].device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            tq.init_cache(cfg, 1, 4)
    assert tq.init_cache(cfg, 1, 4, device="cpu")[0]["k"].device.type == "cpu"


def test_build_model_without_device_needs_a_card():
    """No fallback: without a card the default device raises."""
    node = {"keep_full_llm": False}
    if torch.cuda.is_available():
        frozen = bootstrap.build_model(node)[1]
        assert frozen["llm"]["embed_tokens"]["table"].device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            bootstrap.build_model(node)


def _defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:
            out[f.name] = dataclasses.asdict(f.default_factory())
        else:
            out[f.name] = dataclasses.MISSING
    return out


@pytest.mark.parametrize("pair", [
    (jq.QwenConfig, tq.QwenConfig),
    (ja.AffectGPTConfig, ta.AffectGPTConfig),
    (jm.MergerConfig, tm.MergerConfig),
    (jm.MultiFusionConfig, tm.MultiFusionConfig),
    (jgen.GenerateConfig, tgen.GenerateConfig),
    (jclip.ClipVisionConfig, tclip.ClipVisionConfig),
    (jclip.ClipTextConfig, tclip.ClipTextConfig),
    (jhub.HubertConfig, thub.HubertConfig),
    (jqf.QFormerConfig, tqf.QFormerConfig),
], ids=lambda p: p[0].__name__)
def test_config_fields_and_defaults_match_jax(pair):
    jax_cls, port_cls = pair
    assert [f.name for f in dataclasses.fields(port_cls)] == \
        [f.name for f in dataclasses.fields(jax_cls)]
    assert _defaults(port_cls) == _defaults(jax_cls)


@pytest.mark.parametrize("preset", ["qwen25_7b", "llama2_7b", "baichuan2_7b", "tiny"])
def test_qwen_presets_match_jax(preset):
    assert dataclasses.asdict(getattr(tq.QwenConfig, preset)()) == \
        dataclasses.asdict(getattr(jq.QwenConfig, preset)())


@pytest.mark.parametrize("port,jax_cls,preset", [
    (tclip.ClipVisionConfig, jclip.ClipVisionConfig, "vit_l_14"),
    (tclip.ClipVisionConfig, jclip.ClipVisionConfig, "tiny"),
    (thub.HubertConfig, jhub.HubertConfig, "large"),
    (thub.HubertConfig, jhub.HubertConfig, "tiny"),
], ids=lambda v: v if isinstance(v, str) else v.__name__)
def test_encoder_presets_match_jax(port, jax_cls, preset):
    assert dataclasses.asdict(getattr(port, preset)()) == \
        dataclasses.asdict(getattr(jax_cls, preset)())


def test_kernel_wrappers_on_cpu_count_no_launch():
    decode_qkv.launches = decode_mlp_bf16.launches = 0
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 128, generator=g, dtype=torch.bfloat16)
    w = lambda *s: (torch.randn(*s, generator=g) * 0.05).to(torch.bfloat16)  # noqa: E731
    q, k, v = decode_qkv(x, torch.tensor([3, 9]), w(128, 128), w(128), w(128, 128), w(128),
                         w(128, 128), w(128), num_heads=1, num_kv_heads=1, head_dim=128,
                         theta=1e6, ln_scale=w(128) + 1)
    y = decode_mlp_bf16(x, w(128) + 1, w(128, 256), w(128, 256), w(256, 128))
    assert q.dtype == k.dtype == v.dtype == y.dtype == torch.bfloat16
    assert decode_qkv.launches == 0 and decode_mlp_bf16.launches == 0


def test_serving_wrappers_on_cpu_count_no_launch():
    decode_mlp.launches = paged_ops.paged_attention.launches = 0
    paged_ops.paged_attention_int8.launches = 0
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 128, generator=g, dtype=torch.bfloat16)
    i8 = lambda *s: torch.randint(-127, 128, s, generator=g, dtype=torch.int8)  # noqa: E731
    sc = lambda n: torch.rand(1, n, generator=g) * 0.01  # noqa: E731
    y = decode_mlp(x, torch.ones(128, dtype=torch.bfloat16), i8(128, 256), sc(256),
                   i8(128, 256), sc(256), i8(256, 128), sc(128))
    q = torch.randn(2, 4, 64, generator=g, dtype=torch.bfloat16)
    pool = torch.randn(6, 4, 2, 64, generator=g, dtype=torch.bfloat16)
    tables = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    lens = torch.tensor([7, 2], dtype=torch.int32)
    a = paged_ops.paged_attention(q, pool, pool, tables, lens)
    scales = torch.rand(6, 4, 2, generator=g)
    b = paged_ops.paged_attention_int8(q, i8(6, 4, 2, 64), i8(6, 4, 2, 64), tables, lens,
                                       scales, scales)
    assert y.dtype == a.dtype == b.dtype == torch.bfloat16 and a.shape == b.shape == q.shape
    assert decode_mlp.launches == 0 and paged_ops.paged_attention.launches == 0
    assert paged_ops.paged_attention_int8.launches == 0


def test_kernel_build_is_keyed_by_source_hash():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert {p.name for p in _build.CSRC_DIR.glob("*.cu")} >= {
        "decode_qkv.cu", "decode_mlp_bf16.cu", "decode_attention.cu", "decode_attn_o.cu",
        "prefill_attention.cu", "int8_matmul.cu", "int8_matmul_w8a8.cu", "int4_matmul.cu",
        "int4_matmul_smallm.cu", "decode_mlp_int8.cu", "paged_attention.cu",
        "vit_attention.cu", "vit_sublayer.cu", "vit_mlp.cu", "vit_mlp_fused.cu"}
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def _wrappers():
    from affectgpt_tpu_torch.ops import (decode_attention, decode_attn_o, prefill_attention,
                                         quant, vit_attention, vit_mlp, vit_mlp_fused,
                                         vit_sublayer)
    qkv_kw = dict(num_heads=1, num_kv_heads=1, head_dim=128, theta=1e6)
    return {
        "decode_qkv": (decode_qkv, 8, qkv_kw), "decode_mlp_bf16": (decode_mlp_bf16, 5, {}),
        "decode_mlp": (decode_mlp, 8, {}),
        "decode_attention": (decode_attention.decode_attention, 4, {}),
        "decode_attn_o": (decode_attn_o.decode_attn_o, 6, {}),
        "prefill_attention": (prefill_attention.prefill_attention, 4, {}),
        "paged_attention": (paged_ops.paged_attention, 5, {}),
        "paged_attention_int8": (paged_ops.paged_attention_int8, 7, {}),
        "int8_matmul": (quant.int8_matmul, 3, {}), "int4_matmul": (quant.int4_matmul, 3, {}),
        "int4_matmul_smallm": (quant.int4_matmul_smallm, 3, {}),
        "int8_matmul_w8a8": (quant.int8_matmul_w8a8, 3, {}),
        "fused_vit_attention": (vit_attention.fused_vit_attention, 3, {"valid_len": 1}),
        "fused_self_attention": (vit_attention.fused_self_attention, 3, {"valid_len": 1}),
        "mlp_sublayer": (vit_mlp.mlp_sublayer, 7, {}),
        "mlp_sublayer_fused": (vit_mlp_fused.mlp_sublayer_fused, 7, {}),
        "attn_sublayer": (vit_sublayer.attn_sublayer, 11, {"num_heads": 1, "valid_len": 1}),
    }


@pytest.mark.parametrize("name", list(_wrappers()))
def test_kernel_wrapper_refuses_grad_off_the_cpu(name):
    """Every wrapper of a hand-written kernel raises before launching when
    grad mode is on and an operand off the CPU requires grad (a "meta"
    tensor stands in for the card's here): no kernel has a backward, and
    its output would silently cut the graph. Under no_grad the same call
    goes on to the device check."""
    fn, n_args, kwargs = _wrappers()[name]
    args = [torch.empty(2, 2, device="meta") for _ in range(n_args)]
    args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*args, **kwargs)
    with torch.no_grad(), pytest.raises(Exception) as info:
        fn(*args, **kwargs)
    assert "no backward" not in str(info.value)


def test_refuse_grad_keeps_the_cpu_plain_version_differentiable():
    """A CPU operand that requires grad takes the plain version, whose
    result keeps its graph."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(3, 128, generator=g, requires_grad=True)
    w_q = torch.randint(-127, 128, (128, 64), generator=g, dtype=torch.int8)
    from affectgpt_tpu_torch.ops import quant

    y = quant.int8_matmul(x, w_q, torch.rand(1, 64, generator=g) * 0.01)
    (dx,) = torch.autograd.grad(y.sum(), x)
    assert dx.shape == x.shape and bool(dx.abs().sum() > 0)
    _build.refuse_grad("k", x, None, 3)  # CPU tensors and non-tensors pass
    with pytest.raises(RuntimeError, match="k: the CUDA kernel has no backward"):
        _build.refuse_grad("k", torch.empty(1, device="meta", requires_grad=True))
