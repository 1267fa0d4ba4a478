"""Package-level guards of the PyTorch port: it never imports jax, its
config dataclasses keep the JAX package's fields and defaults, and a
kernel wrapper given CPU tensors runs the plain version without counting
a launch."""

import dataclasses
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import affectgpt_tpu_torch
from affectgpt_tpu.inference import generate as jgen
from affectgpt_tpu.models import affectgpt as ja
from affectgpt_tpu.models import mergers as jm
from affectgpt_tpu.models import qwen2 as jq
from affectgpt_tpu_torch.inference import generate as tgen
from affectgpt_tpu_torch.models import affectgpt as ta
from affectgpt_tpu_torch.models import mergers as tm
from affectgpt_tpu_torch.models import qwen2 as tq
from affectgpt_tpu_torch.ops import _build
from affectgpt_tpu_torch.ops.decode_mlp_bf16 import decode_mlp_bf16
from affectgpt_tpu_torch.ops.decode_qkv import decode_qkv

REPO = Path(__file__).resolve().parent.parent


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(affectgpt_tpu_torch.__path__, "affectgpt_tpu_torch.")
    )


def test_port_imports_without_jax():
    modules = _port_modules()
    assert "affectgpt_tpu_torch.inference.chat" in modules and len(modules) >= 14
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"  # any `import jax` now raises ImportError
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items()\n"
        "               if v is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


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


def test_kernel_build_is_keyed_by_source_hash():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert {p.name for p in _build.CSRC_DIR.glob("*.cu")} >= {"decode_qkv.cu",
                                                              "decode_mlp_bf16.cu"}
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
