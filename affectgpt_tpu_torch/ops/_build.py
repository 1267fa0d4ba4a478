"""Build and load the port's hand-written CUDA kernels.

All `csrc/*.cu` sources are compiled by `nvcc`, one process per source, all
started together, and linked into one shared library with a plain C
interface, which is loaded with `ctypes` (no PyTorch headers, so a build
takes seconds). The library lands in `affectgpt_tpu_torch/_build/`
under a name that carries a hash of the sources and flags: a changed source
builds a new library, an unchanged one is reused. Nothing here runs at import
time; the first kernel launch triggers the build.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures of the entries in csrc/*.cu
_SIGNATURES = {
    "agk_decode_qkv_bf16": [_P] * 12 + [_I] * 5 + [_F, _F, _P],
    "agk_decode_mlp_bf16": [_P] * 7 + [_I] * 3 + [_F, _P],
    "agk_decode_attention_bf16": [_P] * 7 + [_I] * 5 + [_P],
    "agk_decode_attn_o_bf16": [_P] * 10 + [_I] * 6 + [_P],
    "agk_prefill_attention_bf16": [_P] * 5 + [_I] * 5 + [_P],
    "agk_int8_matmul": [_P] * 5 + [_I] * 5 + [_P],
    "agk_int4_matmul": [_P] * 5 + [_I] * 5 + [_P],
    "agk_int4_matmul_smallm": [_P] * 5 + [_I] * 5 + [_P],
    "agk_int8_matmul_w8a8": [_P] * 7 + [_I] * 8 + [_P],
    "agk_decode_mlp_int8": [_P] * 10 + [_I] * 6 + [_F, _P],
    "agk_paged_attention_bf16": [_P] * 8 + [_I] * 6 + [_P],
    "agk_paged_attention_int8": [_P] * 10 + [_I] * 6 + [_P],
    "agk_vit_attention_bf16": [_P] * 4 + [_I] * 5 + [_L] * 6 + [_P],
    "agk_vit_attn_sublayer_bf16": [_P] * 17 + [_I] * 5 + [_F, _P],
    "agk_vit_mlp_bf16": [_P] * 11 + [_I] * 5 + [_F, _P],
    "agk_vit_mlp_fused_bf16": [_P] * 9 + [_I] * 6 + [_F, _P],
}


def find_nvcc() -> str:
    """nvcc from PATH, else from the CUDA toolkit PyTorch was pointed at."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def _source_hash() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return digest.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libaffectgpt_kernels_{_source_hash()}.so"


def build() -> Path:
    """Compile the kernels unless a library for the current sources exists.
    Raises RuntimeError carrying nvcc's stderr when a compile or the link
    fails."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        try:
            for src in _sources():
                obj = os.path.join(tmp, src.stem + ".o")
                cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                jobs.append((cmd, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
            failures = []
            for cmd, _, proc in jobs:
                _, err = proc.communicate()
                if proc.returncode != 0:
                    failures.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
        finally:
            for _, _, proc in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if failures:
            raise RuntimeError("\n".join(failures))
        lib = os.path.join(tmp, target.name)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stderr}")
        os.replace(lib, target)  # atomic: a concurrent loader sees all or nothing
    return target


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare every entry's
    argument and return types (ctypes would otherwise cut 64-bit pointers)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.agk_error_string.argtypes = [ctypes.c_int]
    lib.agk_error_string.restype = ctypes.c_char_p
    return lib


def check(status: int, name: str) -> None:
    """Raise when a C entry reports a CUDA error (refused launch, bad
    shared-memory size, ...): such a launch never ran."""
    if status != 0:
        reason = load_library().agk_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} ({reason}) at launch")


def check_bf16_operands(name: str, device: torch.device, operands) -> None:
    """Raise unless every (tensor, shape) pair lies on `device` as a
    contiguous, 16-byte aligned bf16 tensor of that shape: what the encoder
    kernels (csrc/vit_*.cu) read with 16-byte loads."""
    for t, shape in operands:
        if t.device != device:
            raise ValueError(f"{name}: all operands must be on one device")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} kernel takes bfloat16, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} kernel takes contiguous, 16-byte aligned tensors")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)}, expected {tuple(shape)}")
