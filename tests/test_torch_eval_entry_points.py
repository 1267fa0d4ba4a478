"""The port's evaluation command lines against the repo's root scripts, on
the CPU: `python -m affectgpt_tpu_torch.evaluation --no-llm --device cpu`,
`.evaluation_scoreonly`, `.evaluation_emotion_llama` and `.compare_outputs`
beside evaluation.py, evaluation_scoreonly.py, evaluation_emotion_llama.py
and compare_outputs.py, over tests/synth_corpus.py's MER2023 labels plus a
CMU-MOSI and an OV-MERD+ label tree (one dataset of each scoring kind),
with the LexiconJudge over the vendored wheel: the same scores and the same
judge caches. `--device cuda` without a card raises. The LLM judge runs on
the CPU from a tiny HF Qwen2 directory (tests/torch_hf_models.py): sampled,
so held to its caches and finite scores, not to JAX's draws."""

import csv
import logging
import os
import sys

import numpy as np
import pytest
import torch

from affectgpt_tpu import paths as jpaths
from affectgpt_tpu.evaluation import ew_metric as jew
from affectgpt_tpu_torch import compare_outputs as tcompare
from affectgpt_tpu_torch import evaluation_emotion_llama as tllama
from affectgpt_tpu_torch import evaluation_scoreonly as tscoreonly
from affectgpt_tpu_torch import paths as tpaths
from affectgpt_tpu_torch.evaluation import __main__ as teval
from affectgpt_tpu_torch.evaluation import ew_metric as tew
from affectgpt_tpu_torch.evaluation.judge import LexiconJudge, LLMJudge
from tests.synth_corpus import NAMES, build_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOSI = {"mosi_a": 1.4, "mosi_b": -0.6, "mosi_c": 0.0, "mosi_d": -2.0}
OV = {"ov_a": "['happy', 'excited']", "ov_b": "[]", "ov_c": "['sad', 'worried']"}
REASONS = {
    "result-mer2023": [{n: "The person seems sad and gloomy." for n in NAMES},
                       {n: f"The person is clearly happy and cheerful ({n})." for n in NAMES}],
    "result-cmumosi": [dict(zip(MOSI, ["She is happy and joyful.", "He sounds angry.",
                                        "Nothing to see.", "A cheerful tone."]))],
    "result-ovmerdplus": [dict(zip(OV, ["Happy and thrilled.", "calm", "sad, anxious"]))],
}


def jax_entry(name: str):
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    return __import__(name)


def write_label_trees(root) -> dict:
    """A CMU-MOSI label npz with its transcription and an OV-MERD+ ovlabel.csv
    with its subtitles; returns the path tables' entries."""
    mosi, ov = root / "cmumosi", root / "ovmerdplus"
    mosi.mkdir()
    ov.mkdir()
    corpus = {n: {"emo": 0, "val": v} for n, v in MOSI.items()}
    np.savez(mosi / "label.npz", train_corpus=np.array(corpus, dtype=object),
             test_corpus=np.array(corpus, dtype=object))
    for path, header, rows in (
            (mosi / "transcription.csv", ["name", "english"], [[n, "hi"] for n in MOSI]),
            (ov / "ovlabel.csv", ["name", "openset"], list(OV.items())),
            (ov / "subtitle_eng.csv", ["name", "sentence"], [[n, "hello"] for n in OV])):
        with open(path, "w", newline="") as handle:
            csv.writer(handle).writerows([header] + [list(r) for r in rows])
    return {"DATA_DIR": {"CMUMOSI": str(mosi), "OVMERDPlus": str(ov)},
            "PATH_TO_LABEL": {"CMUMOSI": str(mosi / "label.npz"),
                              "OVMERDPlus": str(ov / "ovlabel.csv")},
            "PATH_TO_TRANSCRIPTIONS": {"CMUMOSI": str(mosi / "transcription.csv"),
                                       "OVMERDPlus": str(ov / "subtitle_eng.csv")}}


def write_results(root, reasons=REASONS, decorate=False) -> str:
    for ds, epochs in reasons.items():
        (root / ds).mkdir(parents=True)
        for epoch, name2reason in enumerate(epochs, 1):
            if decorate:
                name2reason = {n: f"Answer: {r} ### Human: next" for n, r in name2reason.items()}
            np.savez_compressed(root / ds / f"{epoch}.npz", name2reason=name2reason)
    return str(root)


def caches(root) -> dict:
    out = {}
    for p in sorted(root.rglob("*-*.npz")):
        with np.load(p, allow_pickle=True) as data:
            out[str(p.relative_to(root))] = {k: data[k].tolist() for k in data.files}
    return out


@pytest.fixture()
def env(tmp_path, monkeypatch):
    overrides, _ = build_corpus(tmp_path)
    extra = write_label_trees(tmp_path)
    for table, entries in extra.items():
        overrides.setdefault(table, {}).update(entries)
    for paths in (jpaths, tpaths):
        for table, entries in overrides.items():
            for key, value in entries.items():
                monkeypatch.setitem(getattr(paths, table), key, value)
    return tmp_path


def test_evaluation_and_score_only_equal_jax(env):
    jax_root, port_root = env / "jax_results", env / "port_results"
    write_results(jax_root)
    write_results(port_root)
    want = jax_entry("evaluation").main_zeroshot_scores(str(jax_root), use_llm=False)
    got = teval.main(["--input-dir", str(port_root), "--no-llm", "--device", "cpu"])
    assert got == want
    assert set(got) == {"MER2023", "CMUMOSI", "OVMERDPlus"} and got["MER2023"][0] == "2.npz"
    assert all(0 < score <= 1 for _, score in got.values())
    assert caches(port_root) == caches(jax_root) and len(caches(port_root)) == 5

    scoreonly = jax_entry("evaluation_scoreonly")
    want_cached = jax_entry("evaluation").main_zeroshot_scores(
        str(jax_root), use_llm=False, judge=scoreonly.CacheOnlyJudge())
    assert tscoreonly.main(["--input-dir", str(port_root)]) == want_cached == want


def test_score_only_without_caches_raises_as_jax(env):
    jax_root, port_root = env / "jax_results", env / "port_results"
    write_results(jax_root)
    write_results(port_root)
    with pytest.raises(RuntimeError, match="score-only mode"):
        jax_entry("evaluation").main_zeroshot_scores(
            str(jax_root), use_llm=False, judge=jax_entry("evaluation_scoreonly").CacheOnlyJudge())
    with pytest.raises(RuntimeError, match="score-only mode"):
        tscoreonly.main(["--input-dir", str(port_root)])


def test_emotion_llama_equals_jax(env):
    jax_root, port_root = env / "jax_results", env / "port_results"
    write_results(jax_root, decorate=True)
    write_results(port_root, decorate=True)
    llama = jax_entry("evaluation_emotion_llama")
    try:
        jew.set_reason_normalizer(llama.normalize_baseline_answer)
        want = jax_entry("evaluation").main_zeroshot_scores(str(jax_root), use_llm=False)
        got = tllama.main(["--input-dir", str(port_root), "--no-llm", "--device", "cpu"])
    finally:
        jew.set_reason_normalizer(None)
        tew.set_reason_normalizer(None)
    assert got == want and set(got) == {"MER2023", "CMUMOSI", "OVMERDPlus"}
    assert caches(port_root) == caches(jax_root)
    for text in ("Answer: happy ### x", " response：sad", "OUTPUT : fine###", "plain"):
        assert tllama.normalize_baseline_answer(text) == llama.normalize_baseline_answer(text)


def _messages(caplog) -> list:
    keep = ("common clips", "exact text match", "label-set agreement")
    return [r.getMessage() for r in caplog.records if any(k in r.getMessage() for k in keep)]


def test_compare_outputs_equals_jax(env, monkeypatch, caplog):
    ours, ref = env / "ours.npz", env / "ref.npz"
    np.savez_compressed(ours, name2reason={"a": "He looks happy.", "b": "She is sad.",
                                           "c": "calm", "d": "only ours"})
    np.savez_compressed(ref, filenames=["a", "b", "c", "e"],
                        fileitems=["He looks happy.", "She is sad and angry.", "calm ", "x"])
    argv = ["--ours", str(ours), "--reference", str(ref), "--no-llm"]
    with caplog.at_level(logging.INFO):
        monkeypatch.setattr(sys, "argv", ["compare_outputs.py", *argv])
        jax_entry("compare_outputs").main()
        want = _messages(caplog)
        caplog.clear()
        report = tcompare.main([*argv, "--device", "cpu"])
        got = _messages(caplog)
    assert got == want and len(got) == 3
    assert (report["common"], report["exact_text"], report["label_sets_equal"]) == (3, 2, 2)


@pytest.mark.parametrize("entry", ["evaluation", "emotion_llama", "compare_outputs"])
def test_device_cuda_without_a_card_raises(env, entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    root = write_results(env / "results")
    argv = {"evaluation": (teval.main, ["--input-dir", root, "--no-llm"]),
            "emotion_llama": (tllama.main, ["--input-dir", root, "--no-llm"]),
            "compare_outputs": (tcompare.main, ["--ours", root + "/result-mer2023/1.npz",
                                                "--reference", root + "/result-mer2023/2.npz",
                                                "--no-llm"])}[entry]
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            argv[0](argv[1] + extra)
    assert not caches(env / "results")


def test_build_judge_without_weights_falls_back_as_jax(env, caplog):
    assert not os.path.isdir(tpaths.PATH_TO_LLM.get("Qwen25", ""))
    with caplog.at_level(logging.WARNING):
        judge = teval.build_judge(use_llm=True, device="cpu")
    assert isinstance(judge, LexiconJudge)
    assert any("random-weight" in r.getMessage() for r in caplog.records)
    assert isinstance(jax_entry("evaluation").build_judge(use_llm=True),
                      type(jax_entry("evaluation").build_judge(use_llm=False)))


def test_llm_judge_scores_on_the_cpu(env, monkeypatch):
    """With the judge LLM's directory present, `evaluation` builds the LLM
    judge on --device and scores every dataset through it: each extraction
    a batch of the port's generate, the caches written, the scores finite."""
    pytest.importorskip("transformers")
    from tests import torch_hf_models as hf

    hf.set_tiny_presets(monkeypatch)
    hf.write_model_dirs(env / "models", monkeypatch)
    calls = []
    complete = LLMJudge.complete_batch

    def spy(self, prompts, batch_size=8):
        assert self.frozen_llm["embed_tokens"]["table"].device.type == "cpu"
        calls.append(len(prompts))
        return complete(self, prompts, batch_size)

    monkeypatch.setattr(LLMJudge, "complete_batch", spy)
    monkeypatch.setattr(LLMJudge.__init__, "__defaults__", (64, 0.7, 0.8))
    root = env / "results"
    write_results(root)
    got = teval.main(["--input-dir", str(root), "--device", "cpu"])
    assert set(got) == {"MER2023", "CMUMOSI", "OVMERDPlus"}
    assert all(np.isfinite(score) for _, score in got.values())
    # openset of the 2 + 1 + 1 epoch files, and the sentiment of CMU-MOSI's
    assert sorted(calls) == [3, 3, 3, 4, 4] and len(caches(root)) == 5
