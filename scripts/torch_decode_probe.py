"""Probes of the two bf16 decode kernels on one CUDA card: `decode_qkv` and
`decode_mlp_bf16` (csrc/decode_qkv.cu, csrc/decode_mlp_bf16.cu on
csrc/decode_swapab.cuh), and the decode step of `generate` that runs them.

    python3 scripts/torch_decode_probe.py check               # against the plain versions
    python3 scripts/torch_decode_probe.py time [DIR ...]      # this tree beside each DIR's
    python3 scripts/torch_decode_probe.py builds [DIR]        # the loads alone, edited copies
    python3 scripts/torch_decode_probe.py sweep               # every K split, through the C entries
    python3 scripts/torch_decode_probe.py generate [DIR ...]  # decode ms per step, 3B, b = 384
    python3 scripts/torch_decode_probe.py attn_o [DIR ...]    # decode_attn_o, by launch
    python3 scripts/torch_decode_probe.py attention [DIR ...] # decode_attention, by launch

`check`: both wrappers against their plain versions (rtol 1.6e-2, atol
1e-2 in bf16) at b = 1, 8, 13, 16, 24, 64, 100, 384 and 392 on small widths
(h 256, I 1024, 4 heads of 128 over 2 kv heads) and at the Qwen2.5-3B and
7B widths, with and without decode_qkv's rmsnorm; two calls must give the
same bits, each call counts one launch; prints each call's plan.
`time`: device ms per call (calls captured in a CUDA graph over enough
weight copies that a replay cycle reads past the 50 MB L2, 20 replays, the
median) at Qwen2.5-7B width, b = 8, 16 and 64, and at bench.py's 3B
geometry, b = 384, for this tree's package and each DIR's (the root of
another checkout, such as the parent commit unpacked by `git archive` into
a directory that .gitignore lists), each in a process of its own, in the
order A B B A; beside them the library chains (rms_norm, one addmm for
q/k/v, RoPE; rms_norm, one matmul for gate/up, silu * up, addmm onto the
residual) and the bound (bytes at 3.35 TB/s or operations at 989 TFLOP/s).
`builds`: this tree's package (and DIR's) copied with the products taken
out (this design: no wgmma, the ring alone; the previous CUDA-core design
of a DIR: the FMAs of csrc/gemv_tile.cuh reduced to one add a weight, the
16-byte weight loads kept), built and timed as `time` does. `sweep`: both C entries at every K split the
cluster allows (decode_qkv's, the down projection's; gate/up's at 1, 2 and
4), at 7B b = 8, 16 and 64 and 3B b = 8 and 384, beside the plan's and the
clusters of each size the card holds at once. `generate`:
`generate` at bench.py's default geometry (Qwen2.5-3B in bf16, its own copy
of bench.py's configuration and of `make_clip_batch`'s prompts: b = 384,
128-token prompts, max_len 192, 32 greedy tokens, random weights from a
seed), with qwen2.DECODE_QKV and DECODE_MLP "auto" and "xla", each package
in a process of its own, A B B A; decode ms per step = (time of 32 tokens -
time of 1 token) / 31, three runs each, the median. Prints the card's name
and power limit first. `attn_o`: `decode_attn_o` (csrc/decode_attn_o.cu, the
opt-in DECODE_ATTN_O="pallas" route) at Qwen2.5-7B width (28 q heads over 4
kv heads of 128, hidden 3584), b = 8 and 64, T = 640 and 577, with
chip_smoke.py's windows of valid columns (0-19 left pads, a write index in
[T - 95, T - 2]): device ms per call as `time` takes it, the device ms of
each launch of a call (torch.profiler, by kernel name), the largest error
against the plain version and whether two calls give the same bits; beside
it (the first package only) the library chain (SDPA with GQA and the bool
mask, addmm onto the residual) and the bound (valid K/V rows, W_o, q, x and
y at 3.35 TB/s); this tree and each DIR's package, A B B A. `attention`:
`decode_attention` (csrc/decode_attention.cu, the opt-in
DECODE_ATTENTION="pallas" route, which the dense BatchServer decodes
through) at the same width, b = 8 and 64 at T = 640 and 577, b = 1, 4, 16
and 32 at T = 640, with the same windows, as `attn_o` takes it (device ms per
call, by launch, error, same bits; beside it, the first package only,
SDPA with GQA and the bool mask and the bound: valid K/V rows, q, out and
the mask at 3.35 TB/s); for a package whose plan has key modes
(ops/decode_attention.py `attention_plan`), also its plan and `modes`: the
C entry's ms and largest error against the plain version under each key
mode, at every split count whose grid fits two blocks an SM (and 1), with
a ring of up to 8 stages and one that holds a block's whole share (up to
16).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SWAPAB = "affectgpt_tpu_torch/csrc/decode_swapab.cuh"
GEMV = "affectgpt_tpu_torch/csrc/gemv_tile.cuh"
# name: [(file, old text, new text)], for `builds`
LOADS_ONLY = {
    SWAPAB: ("kProducts = true;", "kProducts = false;"),
    GEMV: ("for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(xv, w[j], acc[m][j]);",
           "for (int j = 0; j < 8; ++j) acc[m][j] = m == 0 ? acc[m][j] + w[j] : acc[m][j];"),
}
SHAPES = [("7b", 8), ("7b", 16), ("7b", 64), ("3b", 384)]
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

COMMON = r'''
import json, statistics, sys, torch
GEOM = {"7b": (3584, 18944, 28, 4), "3b": (2048, 11008, 16, 2), "tiny": (256, 1024, 4, 2)}
g = torch.Generator(device="cuda").manual_seed(0)

def rnd(*s, scale=1.0, shift=0.0):
    return (torch.randn(s, generator=g, device="cuda") * scale + shift).to(torch.bfloat16)

def graph_ms(calls, reps=20):
    side = torch.cuda.Stream(); side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls: fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls: fn()
    graph.replay(); ev = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(); graph.replay(); b.record(); ev.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev) / len(calls)

def layer(geom, copies):
    h, inter, heads, kv = GEOM[geom]
    nq, nkv = heads * 128, kv * 128
    qkv = [(rnd(h, nq, scale=0.02), rnd(nq, scale=0.1), rnd(h, nkv, scale=0.02),
            rnd(nkv, scale=0.1), rnd(h, nkv, scale=0.02), rnd(nkv, scale=0.1))
           for _ in range(copies)]
    mlp = [(rnd(h, inter, scale=0.02), rnd(h, inter, scale=0.02), rnd(inter, h, scale=0.02))
           for _ in range(max(1, copies // 4))]
    return h, inter, heads, kv, qkv, mlp
'''

TIME = COMMON + r'''
from affectgpt_tpu_torch.ops.decode_qkv import decode_qkv
from affectgpt_tpu_torch.ops.decode_mlp_bf16 import decode_mlp_bf16
label, shapes, chain = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3] == "1"

def rope(t, cos, sin):
    t1, t2 = t.float().chunk(2, dim=-1)
    return torch.cat([t1 * cos - t2 * sin, t2 * cos + t1 * sin], dim=-1).to(t.dtype)

for geom, b in shapes:
    h, inter, heads, kv, qkv, mlp = layer(geom, 8)
    nq, nkv = heads * 128, kv * 128
    x, ln = rnd(b, h), rnd(h, scale=0.1, shift=1.0)
    pos = torch.randint(0, 4097, (b,), generator=g, device="cuda", dtype=torch.int32)
    kw = dict(num_heads=heads, num_kv_heads=kv, head_dim=128, theta=1e6, ln_scale=ln, eps=1e-6)
    row = {"label": label, "geom": geom, "b": b,
           "qkv_ms": graph_ms([lambda w=w: decode_qkv(x, pos, *w, **kw) for w in qkv] * 3),
           "mlp_ms": graph_ms([lambda w=w: decode_mlp_bf16(x, ln, *w, eps=1e-6) for w in mlp] * 4)}
    if chain:
        cat = [(torch.cat(w[0::2], dim=1), torch.cat(w[1::2])) for w in qkv]
        gu = [(torch.cat(w[:2], dim=1), w[2]) for w in mlp]
        freqs = 1.0 / (1e6 ** (torch.arange(0, 128, 2, device="cuda") / 128))
        ang = pos[:, None, None].float() * freqs
        cos, sin = torch.cos(ang), torch.sin(ang)

        def qkv_chain(wqkv, bqkv):
            xn = torch.nn.functional.rms_norm(x, (h,), ln, 1e-6)
            q, k, v = torch.addmm(bqkv, xn, wqkv).split((nq, nkv, nkv), dim=-1)
            return rope(q.view(b, heads, -1), cos, sin), rope(k.view(b, kv, -1), cos, sin), v

        def mlp_chain(wgu, wd):
            xn = torch.nn.functional.rms_norm(x, (h,), ln, 1e-6)
            gg, u = (xn @ wgu).chunk(2, dim=-1)
            return torch.addmm(x, torch.nn.functional.silu(gg) * u, wd)

        row["qkv_chain_ms"] = graph_ms([lambda c=c: qkv_chain(*c) for c in cat] * 3)
        row["mlp_chain_ms"] = graph_ms([lambda c=c: mlp_chain(*c) for c in gu] * 4)
    try:
        from affectgpt_tpu_torch.ops.decode_qkv import decode_qkv_plan
        from affectgpt_tpu_torch.ops.decode_mlp_bf16 import decode_mlp_bf16_plan
        from affectgpt_tpu_torch.ops.decode_gemm import active_clusters_on_card as active
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        p = decode_qkv_plan(b, h, nq, nkv, 128, sms, active)
        m = decode_mlp_bf16_plan(b, h, inter, sms, active)
        keys = ("wgmma", "cb", "ck", "stages", "grid", "smem_bytes")
        row["plan"] = {"qkv": {k: p[k] for k in keys}, "gateup": {k: m["gateup"][k] for k in keys},
                       "down": {k: m["down"][k] for k in keys}}
    except ImportError:
        pass
    print(json.dumps(row), flush=True)
    del qkv, mlp
    torch.cuda.empty_cache()
'''

ATTN_O = COMMON + r'''
from torch.profiler import ProfilerActivity, profile
from affectgpt_tpu_torch.ops.decode_attn_o import decode_attn_o, decode_attn_o_reference
label, chain = sys.argv[1], sys.argv[2] == "1"
h, kv, groups, d = 3584, 4, 7, 128
nq = kv * groups * d
sdpa = torch.nn.functional.scaled_dot_product_attention

def kernel_ms(fn, reps=10):  # device ms of each kernel a call launches, by name
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if e.count and t:
            out[e.key.split("(")[0][-48:]] = t / e.count / 1000
    return out

for b in (8, 64):
    for t in (640, 577):
        lo = torch.randint(0, 20, (b,), generator=g, device="cuda")
        hi = torch.randint(t - 95, t - 1, (b,), generator=g, device="cuda")
        cols = torch.arange(t, device="cuda")
        mask = (cols[None, :] >= lo[:, None]) & (cols[None, :] <= hi[:, None])
        q, x = rnd(b, kv, groups, d), rnd(b, h)
        set_bytes = 2 * b * kv * t * d * 2 + nq * h * 2
        copies = max(2, -(-64 * 2**20 // set_bytes))  # a replay cycle reads past the L2
        sets = [(rnd(b, kv, t, d), rnd(b, kv, t, d), rnd(nq, h, scale=0.02))
                for _ in range(copies)]
        reps = max(1, 24 // copies)
        k, v, wo = sets[0]
        got = decode_attn_o(x, q, k, v, mask, wo)
        same = torch.equal(got, decode_attn_o(x, q, k, v, mask, wo))
        err = float((got.float() - decode_attn_o_reference(x, q, k, v, mask, wo).float())
                    .abs().max())
        valid = int(mask.sum())
        nbytes = 2 * valid * kv * d * 2 + 2 * (q.numel() + nq * h + 2 * b * h) + b * t
        row = {"label": label, "b": b, "T": t, "max_abs_err": err, "same_bits": same,
               "ms": graph_ms([lambda k=k, v=v, wo=wo: decode_attn_o(x, q, k, v, mask, wo)
                               for k, v, wo in sets] * reps),
               "bound_ms": nbytes / 3.35e12 * 1e3,
               "launch_ms": kernel_ms(lambda: decode_attn_o(x, q, k, v, mask, wo))}
        if chain:
            q4, mask4 = q.reshape(b, kv * groups, 1, d), mask[:, None, None, :]
            row["chain_ms"] = graph_ms([lambda k=k, v=v, wo=wo: torch.addmm(
                x, sdpa(q4, k, v, attn_mask=mask4, enable_gqa=True).reshape(b, nq), wo)
                for k, v, wo in sets] * reps)
        print(json.dumps(row), flush=True)
        del sets, k, v, wo
        torch.cuda.empty_cache()
'''

ATTENTION = COMMON + r'''
from torch.profiler import ProfilerActivity, profile
from affectgpt_tpu_torch.ops import decode_attention as da
label, extras = sys.argv[1], sys.argv[2] == "1"
kv, groups, d = 4, 7, 128
sdpa = torch.nn.functional.scaled_dot_product_attention
sms = torch.cuda.get_device_properties(0).multi_processor_count

def kernel_ms(fn, reps=10):  # device ms of each kernel a call launches, by name
    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(2):  # a process's first profiler session may record no device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
            if e.count and t:
                out[e.key.split("(")[0][-48:]] = t / e.count / 1000
        if out:
            break
    return out

for b in (1, 4, 8, 16, 32, 64):
    for t in ((640, 577) if b in (8, 64) else (640,)):
        lo = torch.randint(0, 20, (b,), generator=g, device="cuda")
        hi = torch.randint(t - 95, t - 1, (b,), generator=g, device="cuda")
        cols = torch.arange(t, device="cuda")
        mask = (cols[None, :] >= lo[:, None]) & (cols[None, :] <= hi[:, None])
        q = rnd(b, kv, groups, d)
        copies = max(2, -(-64 * 2**20 // (2 * b * kv * t * d * 2)))  # past the L2 a cycle
        sets = [(rnd(b, kv, t, d), rnd(b, kv, t, d)) for _ in range(copies)]
        reps = max(1, 24 // copies)
        k, v = sets[0]
        got = da.decode_attention(q, k, v, mask)
        same = torch.equal(got, da.decode_attention(q, k, v, mask))
        err = float((got.float() - da.decode_attention_reference(q, k, v, mask).float())
                    .abs().max())
        valid = int(mask.sum())
        nbytes = 2 * valid * kv * d * 2 + 2 * 2 * q.numel() + b * t
        row = {"label": label, "b": b, "T": t, "max_abs_err": err, "same_bits": same,
               "ms": graph_ms([lambda k=k, v=v: da.decode_attention(q, k, v, mask)
                               for k, v in sets] * reps),
               "bound_ms": nbytes / 3.35e12 * 1e3,
               "launch_ms": kernel_ms(lambda: da.decode_attention(q, k, v, mask))}
        if extras:
            q4, mask4 = q.reshape(b, kv * groups, 1, d), mask[:, None, None, :]
            row["sdpa_ms"] = graph_ms([lambda k=k, v=v: sdpa(q4, k, v, attn_mask=mask4,
                                                            enable_gqa=True)
                                       for k, v in sets] * reps)
        if hasattr(da, "attention_plan"):
            row["plan"] = da.decode_attention_plan(b, kv, groups, d, t, sms)
            lib, out = da._build.load_library(), torch.empty_like(q)
            ref = da.decode_attention_reference(q, k, v, mask).float()
            tiles = -(-t // 16)
            row["modes"] = {}
            for keys in (da.MASK_WINDOW, da.MASK_ALL):
                for splits in range(1, 9):
                    if splits > tiles or splits > 1 and b * kv * splits > 2 * sms:
                        break
                    fill = -(-(-(-tiles // splits)) // 4) * 4  # a block's whole share
                    for stages in sorted({min(8, fill), min(16, fill)}):
                        def call(k, v, splits=splits, stages=stages, keys=keys):
                            st = lib.agk_decode_attention_bf16(
                                q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                                out.data_ptr(), b, kv, groups, t, d, splits, stages, keys,
                                torch.cuda.current_stream().cuda_stream)
                            assert st == 0, st
                        call(k, v)
                        torch.cuda.synchronize()
                        err_m = float((out.float() - ref).abs().max())
                        row["modes"][f"{da.KEYS[keys]}_c{splits}_s{stages}"] = [
                            graph_ms([lambda k=k, v=v: call(k, v) for k, v in sets] * reps), err_m]
        print(json.dumps(row), flush=True)
        del sets, k, v
        torch.cuda.empty_cache()
'''

CHECK = COMMON + r'''
from affectgpt_tpu_torch.ops.decode_qkv import decode_qkv, decode_qkv_plan, decode_qkv_reference
from affectgpt_tpu_torch.ops.decode_mlp_bf16 import (decode_mlp_bf16, decode_mlp_bf16_plan,
                                                     decode_mlp_bf16_reference)
from affectgpt_tpu_torch.ops.decode_gemm import active_clusters_on_card as active
sms = torch.cuda.get_device_properties(0).multi_processor_count
cases = [("tiny", b) for b in (1, 8, 13, 16, 24, 64, 100, 384, 392)]
cases += [("3b", b) for b in (8, 100, 384, 392)] + [("7b", b) for b in (8, 16, 64, 384)]
worst = {"decode_qkv": 0.0, "decode_mlp_bf16": 0.0}
for geom, b in cases:
    h, inter, heads, kv, qkv, mlp = layer(geom, 1)
    x, ln = rnd(b, h), rnd(h, scale=0.1, shift=1.0)
    pos = torch.randint(0, 32768, (b,), generator=g, device="cuda", dtype=torch.int32)
    for with_ln in (False, True):
        kw = dict(num_heads=heads, num_kv_heads=kv, head_dim=128, theta=1e6,
                  ln_scale=ln if with_ln else None, eps=1e-6)
        before = decode_qkv.launches
        got = decode_qkv(x, pos, *qkv[0], **kw)
        again = decode_qkv(x, pos, *qkv[0], **kw)
        torch.cuda.synchronize()
        assert decode_qkv.launches == before + 2
        assert all(torch.equal(a, c) for a, c in zip(got, again)), f"qkv {geom} b={b}: bits differ"
        for a, r in zip(got, decode_qkv_reference(x, pos, *qkv[0], **kw)):
            torch.testing.assert_close(a.float(), r.float(), rtol=1.6e-2, atol=1e-2)
            worst["decode_qkv"] = max(worst["decode_qkv"], float((a.float() - r.float()).abs().max()))
    before = decode_mlp_bf16.launches
    got = decode_mlp_bf16(x, ln, *mlp[0])
    again = decode_mlp_bf16(x, ln, *mlp[0])
    torch.cuda.synchronize()
    assert decode_mlp_bf16.launches == before + 2
    assert torch.equal(got, again), f"mlp {geom} b={b}: bits differ"
    ref = decode_mlp_bf16_reference(x, ln, *mlp[0])
    torch.testing.assert_close(got.float(), ref.float(), rtol=1.6e-2, atol=1e-2)
    worst["decode_mlp_bf16"] = max(worst["decode_mlp_bf16"], float((got.float() - ref.float()).abs().max()))
    p = decode_qkv_plan(b, h, heads * 128, kv * 128, 128, sms, active)
    m = decode_mlp_bf16_plan(b, h, inter, sms, active)
    keys = ("wgmma", "cb", "ck", "stages", "grid")
    print(json.dumps({"geom": geom, "b": b, "ok": True, "qkv": {k: p[k] for k in keys},
                      "gateup": {k: m["gateup"][k] for k in keys},
                      "down": {k: m["down"][k] for k in keys}}), flush=True)
print(json.dumps({"max_abs_err": worst}), flush=True)
'''

SWEEP = COMMON + r'''
from affectgpt_tpu_torch.ops import _build
from affectgpt_tpu_torch.ops.decode_mlp_bf16 import decode_mlp_bf16_plan
from affectgpt_tpu_torch.ops.decode_qkv import decode_qkv_plan
from affectgpt_tpu_torch.ops.decode_gemm import active_clusters_on_card as active
lib = _build.load_library()
sms = torch.cuda.get_device_properties(0).multi_processor_count
for geom, b in json.loads(sys.argv[1]):
    h, inter, heads, kv, qkv, mlp = layer(geom, 8)
    nq, nkv = heads * 128, kv * 128
    x, ln = rnd(b, h), rnd(h, scale=0.1, shift=1.0)
    pos = torch.randint(0, 4097, (b,), generator=g, device="cuda", dtype=torch.int32)
    q, k, v = (torch.empty((b, n), dtype=torch.bfloat16, device="cuda") for n in (nq, nkv, nkv))
    xn, y = torch.empty_like(x), torch.empty_like(x)
    act = torch.empty((b, inter), dtype=torch.bfloat16, device="cuda")
    pq = decode_qkv_plan(b, h, nq, nkv, 128, sms, active)
    pm = decode_mlp_bf16_plan(b, h, inter, sms, active)

    def qkv_call(w, ck):
        assert lib.agk_decode_qkv_bf16(
            x.data_ptr(), ln.data_ptr(), pos.data_ptr(), *(t.data_ptr() for t in w),
            q.data_ptr(), k.data_ptr(), v.data_ptr(), xn.data_ptr(), b, h, nq, nkv, 128,
            pq["nb"], pq["cb"], ck, pq["stages"], 1e-6, 1e6,
            torch.cuda.current_stream().cuda_stream) == 0

    def mlp_call(w, ck_a, ck_b):
        pa, pd = pm["gateup"], pm["down"]
        assert lib.agk_decode_mlp_bf16(
            x.data_ptr(), ln.data_ptr(), *(t.data_ptr() for t in w), xn.data_ptr(),
            act.data_ptr(), y.data_ptr(), b, h, inter, pa["nb"], pa["cb"], ck_a, pa["stages"],
            pd["nb"], pd["cb"], ck_b, pd["stages"], 1e-6, 1,
            torch.cuda.current_stream().cuda_stream) == 0

    def cks(plan):  # the K splits the kernel takes
        return range(1, min(8 // plan["cb"], plan["units"]) + 1)

    ga, gd = pm["gateup"]["ck"], pm["down"]["ck"]
    row = {"geom": geom, "b": b, "plan_ck": {"qkv": pq["ck"], "gateup": ga, "down": gd},
           "active_clusters": {c: active(pq["nb"], pq["cb"] * c, pq["stages"]) for c in cks(pq)}}
    row["qkv_ms_by_ck"] = {c: graph_ms([lambda w=w: qkv_call(w, c) for w in qkv] * 3)
                           for c in cks(pq)}
    row["mlp_ms_by_down_ck"] = {c: graph_ms([lambda w=w: mlp_call(w, ga, c) for w in mlp] * 4)
                                for c in cks(pm["down"])}
    row["mlp_ms_by_gateup_ck"] = {c: graph_ms([lambda w=w: mlp_call(w, c, gd) for w in mlp] * 4)
                                  for c in (1, 2, 4)}
    print(json.dumps(row), flush=True)
    del qkv, mlp
    torch.cuda.empty_cache()
'''

GENERATE = r'''
import json, statistics, sys, time
import numpy as np, torch
from affectgpt_tpu_torch.inference import generate as gen
from affectgpt_tpu_torch.models import affectgpt, qwen2
label, batch, reps = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
PROMPT_LEN, NEW_TOKENS, MAX_LEN = 128, 32, 192  # bench.py's defaults
llm = qwen2.QwenConfig(vocab_size=151936, hidden_size=2048, intermediate_size=11008,
                       num_layers=36, num_heads=16, num_kv_heads=2, head_dim=128)  # bench.py qwen_3b_config
cfg = affectgpt.AffectGPTConfig(llm=llm, video_fusion_type="attention",
                                audio_fusion_type="attention", multi_fusion_type="attention",
                                num_video_query_token=8, num_audio_query_token=8,
                                num_multi_query_token=1)
g = torch.Generator(device="cuda").manual_seed(0)
frozen = affectgpt.init_frozen(g, cfg, dtype=torch.bfloat16)
trainable = affectgpt.init_trainable(torch.Generator(device="cuda").manual_seed(1), cfg,
                                     dtype=torch.bfloat16)

def make_clip_batch(b):  # bench.py make_clip_batch
    rng = np.random.RandomState(0)
    ids = rng.randint(1, 1000, (b, PROMPT_LEN)).astype(np.int64)
    offsets = {"multi": 2, "audio": 5, "face": 20, "frame": 30}
    q = {"multi": cfg.num_multi_query_token, "audio": cfg.num_audio_query_token,
         "face": cfg.num_video_query_token, "frame": cfg.num_video_query_token}
    for m, off in offsets.items():
        ids[:, off:off + q[m]] = 0
    feats = {"frame": rng.randn(b, 8, cfg.visual_dim), "face": rng.randn(b, 8, cfg.visual_dim),
             "audio": rng.randn(b, 8, cfg.acoustic_dim)}
    return (torch.tensor(ids, device="cuda"),
            {m: torch.tensor(v, device="cuda").to(torch.bfloat16) for m, v in feats.items()},
            {m: torch.full((b,), off, dtype=torch.long, device="cuda") for m, off in offsets.items()})

ids, feats, offsets = make_clip_batch(batch)
with torch.no_grad():
    embeds = affectgpt.build_inputs_embeds(frozen, trainable, cfg, ids, feats, offsets)
lengths = torch.full((batch,), PROMPT_LEN, dtype=torch.long, device="cuda")

def run(new_tokens):
    gcfg = gen.GenerateConfig(max_new_tokens=new_tokens, do_sample=False)
    torch.cuda.synchronize(); t0 = time.perf_counter()
    with torch.no_grad():
        tokens, _ = gen.generate(frozen["llm"], llm, gcfg, embeds, lengths, None, MAX_LEN)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, tokens

out = {"label": label, "b": batch}
for switch in ("auto", "xla"):
    qwen2.DECODE_QKV = qwen2.DECODE_MLP = switch
    run(2)  # warm-up: kernels built, allocator grown
    steps = []
    for _ in range(reps):
        t1, _ = run(1)
        t32, tokens = run(NEW_TOKENS)
        steps.append((t32 - t1) / (NEW_TOKENS - 1) * 1e3)
    out[switch] = {"decode_ms_per_step": statistics.median(steps), "runs": steps,
                   "tokens_checksum": int(tokens.sum())}
out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
print(json.dumps(out), flush=True)
'''


def card() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)


def run_in(root: Path, code: str, *argv: str, timeout: int = 1200) -> list:
    """Run `code` with root's package first on the path (cwd root, so that
    `python -c` cannot import another copy); its JSON lines."""
    env = {**os.environ, "PYTHONPATH": str(root)}
    proc = subprocess.run([sys.executable, "-c", code, *argv], env=env, cwd=root,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise SystemExit(f"{root}: failed\n{proc.stdout[-3000:]}\n{proc.stderr[-4000:]}")
    return [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]


def bounds(geom: str, b: int) -> dict:
    h, inter, heads, kv = {"7b": (3584, 18944, 28, 4), "3b": (2048, 11008, 16, 2)}[geom]
    n = (heads + 2 * kv) * 128
    qkv_bytes = 2 * (h * n + n + h + b * h + b * n) + 4 * b
    mlp_bytes = 2 * (3 * h * inter + h + 2 * b * h)

    def ms(nbytes, flops):
        by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
        return {"bound_ms": max(by_bytes, by_ops),
                "bound_by": "bytes" if by_bytes >= by_ops else "operations"}

    return {"qkv": ms(qkv_bytes, 2 * b * h * n), "mlp": ms(mlp_bytes, 6 * b * h * inter)}


def time_packages(roots: list, code: str = TIME) -> None:
    order = roots + roots[::-1] if len(roots) > 1 else roots
    for i, root in enumerate(order):
        for row in run_in(root, code, str(root), json.dumps(SHAPES), "1" if i == 0 else "0"):
            if i == 0:
                row["bound"] = bounds(row["geom"], row["b"])
            print(json.dumps(row), flush=True)


def copy_with(root: Path, edits: dict, tmp: Path, name: str) -> Path:
    dst = tmp / name
    shutil.copytree(root / "affectgpt_tpu_torch", dst / "affectgpt_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel, (old, new) in edits.items():
        path = dst / rel
        if not path.exists() or old not in path.read_text():
            continue
        path.write_text(path.read_text().replace(old, new))
    return dst


def main() -> None:
    cmd, dirs = sys.argv[1], [Path(d).resolve() for d in sys.argv[2:]]
    card()
    if cmd == "check":
        for row in run_in(REPO, CHECK):
            print(json.dumps(row), flush=True)
    elif cmd == "time":
        time_packages([REPO, *dirs])
    elif cmd == "builds":
        tmp = Path(tempfile.mkdtemp())
        roots = []
        for i, root in enumerate([REPO, *dirs]):
            roots += [copy_with(root, {}, tmp, f"as_is_{i}"),
                      copy_with(root, LOADS_ONLY, tmp, f"loads_only_{i}")]
        for root in roots:
            for row in run_in(root, TIME, root.name, json.dumps(SHAPES), "0"):
                print(json.dumps(row), flush=True)
        shutil.rmtree(tmp, ignore_errors=True)
    elif cmd == "sweep":
        shapes = [("7b", 8), ("7b", 16), ("7b", 64), ("3b", 8), ("3b", 384)]
        for row in run_in(REPO, SWEEP, json.dumps(shapes)):
            print(json.dumps(row), flush=True)
    elif cmd == "generate":
        roots = [REPO, *dirs]
        for root in roots + roots[::-1] if len(roots) > 1 else roots:
            for row in run_in(root, GENERATE, str(root), "384", "3", timeout=1800):
                print(json.dumps(row), flush=True)
    elif cmd == "attention":
        roots = [REPO, *dirs]
        for i, root in enumerate(roots + roots[::-1] if len(roots) > 1 else roots):
            for row in run_in(root, ATTENTION, str(root), "1" if i == 0 else "0"):
                print(json.dumps(row), flush=True)
    elif cmd == "attn_o":
        roots = [REPO, *dirs]
        for i, root in enumerate(roots + roots[::-1] if len(roots) > 1 else roots):
            for row in run_in(root, ATTN_O, str(root), "1" if i == 0 else "0"):
                print(json.dumps(row), flush=True)
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main()
