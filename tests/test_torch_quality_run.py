"""The port's quality-run recipe (`python -m
affectgpt_tpu_torch.scripts.quality_run`) against scripts/quality_run.sh
on the CPU: `--synthetic --device cpu` runs the port's three command lines
end to end as subprocesses and writes the result tree the bash recipe
writes (result-mer2023/0.npz of name2reason, the judge's
0-openset.npz); its corpus and config are the root setup's, byte for
byte and key for key; the real mode runs the precompute, inference and
evaluation with the bash recipe's arguments, and a step that fails stops
it with its exit code."""

import json
import os
import sys

import numpy as np
import pytest
import yaml

from affectgpt_tpu_torch.scripts import quality_run, synth_corpus
from tests import synth_corpus as root_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_synthetic_run_writes_the_recipes_results(tmp_path, capsys):
    quality_run.main(["--synthetic", str(tmp_path), "--device", "cpu"])
    assert "quality_run complete: output/results/quality_run" in capsys.readouterr().out
    root = tmp_path / "output" / "results" / "quality_run"
    keys = {}
    for path in sorted(root.rglob("*.npz")):
        with np.load(path, allow_pickle=True) as data:
            keys[str(path.relative_to(root))] = data.files
            if path.name == "0.npz":
                answers = data["name2reason"].item()
    # what scripts/quality_run.sh --synthetic writes
    assert keys == {"result-mer2023/0.npz": ["name2reason"],
                    "result-mer2023/0-openset.npz": ["filenames", "fileitems"]}
    assert sorted(answers) == synth_corpus.NAMES
    assert all(isinstance(v, str) and v for v in answers.values())


def test_synthetic_corpus_and_config_equal_the_root_setup(tmp_path):
    port_overrides, port_feats = synth_corpus.build_corpus(tmp_path / "port")
    root_overrides, root_feats = root_corpus.build_corpus(tmp_path / "root")
    files = sorted(p.relative_to(tmp_path / "root") for p in (tmp_path / "root").rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*") if p.is_file())
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "root" / rel).read_bytes(), rel
    assert json.dumps(port_overrides).replace("/port/", "/root/") == json.dumps(root_overrides)
    assert port_feats.replace("/port/", "/root/") == root_feats

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import _synth_quality_setup as setup
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))
    setup.main(str(tmp_path / "root_work"))
    want = yaml.safe_load((tmp_path / "root_work" / "quality_run.yaml").read_text())
    got_path = quality_run.write_synthetic_config(str(tmp_path / "port_work"), "cpu")
    assert got_path.endswith("quality_run.json") and quality_run.config_name(got_path) == \
        "quality_run"
    got = open(got_path).read().replace("/port_work/", "/root_work/")
    assert json.loads(got) == want
    # on the card the LLM takes the 3B geometry, whose widths the decode kernels take
    card = json.loads(open(quality_run.write_synthetic_config(str(tmp_path / "card"))).read())
    assert card["model"] == {**want["model"], "llama_model": "Qwen25_3B", "keep_full_llm": True}


def test_real_mode_runs_the_recipes_steps(tmp_path, monkeypatch):
    steps = []
    monkeypatch.setattr(quality_run, "run_step", lambda m, a, cwd: steps.append((m, a, cwd)))
    monkeypatch.setenv("QUALITY_LIMIT", "5")
    monkeypatch.setenv("QUALITY_BATCH", "4")
    monkeypatch.delenv("QUALITY_NEW_TOKENS", raising=False)
    cfg = tmp_path / "exp.json"
    cfg.write_text(json.dumps({"name": "first_run", "model": {}}))
    quality_run.main([str(cfg), "MER2023", str(tmp_path / "ckpt")])
    cpu = [s for s in steps if s[2] != str(quality_run.REPO)]
    assert not cpu and [m for m, _, _ in steps] == [
        "extract_multimodal_features_precompute"] * 3 + ["inference_hybird", "evaluation"]
    assert [a for _, a, _ in steps[:3]] == [
        ["--dataset", "MER2023", "--modality", m, "--device", "cuda", "--limit", "5"]
        for m in ("frame", "face", "audio")]
    assert steps[3][1] == ["--cfg-path", str(cfg), "--dataset", "MER2023", "--greedy",
                           "--batch_size", "4", "--max_new_tokens", "64", "--ckpt_root",
                           str(tmp_path / "ckpt"), "--device", "cuda"]
    assert steps[4][1] == ["--input-dir", "output/results/first_run", "--cfg-path", str(cfg),
                           "--device", "cuda"]


def test_a_failing_step_stops_the_recipe(tmp_path, capsys):
    with pytest.raises(SystemExit) as info:
        quality_run.run_step("no_such_module", [], str(tmp_path))
    assert info.value.code == 1
    assert "no_such_module exited 1" in capsys.readouterr().err
