"""The port's twins of the three operational command lines against the
repo's root scripts, on the CPU over tiny trees: `encode_fine_grained`
(the same keys in temporal order, features within 1e-4 from one shared f32
text tower, the same skips), `ingest_transcode` (the same counts and
outputs, frames within the JPEG tolerance of the DCT port) and `judge_ab`
(`compare_judges`' reports equal on lexicon judges; the command line's
report from a random tiny LLM judge on the CPU). `python -m
affectgpt_tpu_torch.scripts.<name> --help` runs."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from affectgpt_tpu.data import ingest as jingest
from affectgpt_tpu.data import media
from affectgpt_tpu.evaluation.judge import LexiconJudge as JLexiconJudge
from affectgpt_tpu.models import clip_vit as jclip
from affectgpt_tpu.utils import clip_text as jtext
from affectgpt_tpu_torch.evaluation.judge import LexiconJudge
from affectgpt_tpu_torch.models import clip_vit, convert
from affectgpt_tpu_torch.scripts import encode_fine_grained, ingest_transcode, judge_ab
from affectgpt_tpu_torch.utils import clip_text

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JPEG_ATOL = 24  # tests/test_torch_ingest.py's bound between the two encoders
REASONS = {
    "clip1": "The person smiles broadly and sounds happy and excited.",
    "clip2": "He looks sad, almost crying; the tone is gloomy.",
    "clip3": "She is angry, shouting with a furious expression.",
    "clip4": "A calm, neutral delivery without strong emotion.",
    "clip5": "Nervous laughter suggests she is worried and anxious.",
}


def root_script(name: str):
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    return __import__(f"scripts.{name}", fromlist=["main"])


def run_root(monkeypatch, name: str, argv: list):
    monkeypatch.setattr(sys, "argv", [f"scripts/{name}.py"] + argv)
    root_script(name).main()


@pytest.mark.parametrize("module", [encode_fine_grained, ingest_transcode, judge_ab],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_help_names_the_device(module, capsys):
    with pytest.raises(SystemExit) as info:
        module.main(["--help"])
    assert info.value.code == 0 and "--device" in capsys.readouterr().out


def test_module_runs_as_a_command():
    proc = subprocess.run([sys.executable, "-m", "affectgpt_tpu_torch.scripts.judge_ab",
                           "--help"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "--device" in proc.stdout, proc.stderr


def test_encode_fine_grained_matches_jax(tmp_path, monkeypatch):
    mf = tmp_path / "mf"
    for vid, descs in (("vid1", {"10.5s": "jaw clenches", "0.0s": "neutral face",
                                 "2.0s": "brow lowers", "end": "relaxed"}),
                       ("vid3", {"1s": "lip corner pull"})):
        (mf / vid).mkdir(parents=True)
        (mf / vid / f"{vid}_au_analysis.json").write_text(json.dumps(
            {"fine_grained_descriptions": descs, "au_info": {}}))
    (mf / "vid2").mkdir()
    (mf / "vid2" / "vid2_au_analysis.json").write_text(json.dumps({"au_info": {}}))
    (mf / "vid4").mkdir()
    (mf / "vid4" / "vid4_au_analysis.json").write_text("{not json")
    cfg = jclip.ClipTextConfig.tiny()
    rng = np.random.RandomState(3)
    params = jax.tree.map(lambda x: rng.randn(*x.shape).astype(np.float32) * 0.1,
                          jax.eval_shape(lambda k: jclip.init_text_params(k, cfg),
                                         jax.random.PRNGKey(0)))
    tcfg = clip_vit.ClipTextConfig(**dataclasses.asdict(cfg))
    tparams = convert.text_tower_from_jax(params, tcfg, device="cpu")
    devices = []
    monkeypatch.setattr(jtext, "load_text_tower", lambda: (jax.tree.map(np.asarray, params), cfg))
    monkeypatch.setattr(clip_text, "load_text_tower",
                        lambda device="cuda": devices.append(device) or (tparams, tcfg))
    for side in ("jax", "port"):
        argv = ["--mer-factory-output", str(mf), "--save-root", str(tmp_path / side)]
        if side == "jax":
            run_root(monkeypatch, "encode_fine_grained", argv)
        else:
            encode_fine_grained.main(argv + ["--device", "cpu"])
    assert devices == ["cpu"]
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == \
        ["vid1_fine_grained_clip.npz", "vid3_fine_grained_clip.npz"]
    for name in os.listdir(tmp_path / "jax"):
        got, want = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        assert got["keys"].tolist() == want["keys"].tolist()
        np.testing.assert_allclose(got["features"], want["features"], rtol=1e-4, atol=1e-4)
    assert np.load(tmp_path / "port" / "vid1_fine_grained_clip.npz")["keys"].tolist() == \
        ["0.0s", "2.0s", "10.5s", "end"]
    assert encode_fine_grained._temporal_key("2.0s") < encode_fine_grained._temporal_key("10s")


def test_ingest_transcode_matches_jax(tmp_path, monkeypatch, capsys):
    rng = np.random.RandomState(0)
    frames = [np.clip(rng.randn(32, 48, 3) * 20 + 128, 0, 255).astype(np.uint8)
              for _ in range(4)]
    (tmp_path / "corpus" / "sub").mkdir(parents=True)
    for path in (tmp_path / "corpus" / "a.avi", tmp_path / "corpus" / "sub" / "b.avi"):
        jingest.write_mjpeg_avi(str(path), frames, fps=10, quality=92)
    src = str(tmp_path / "corpus" / "a.avi")
    outputs = {}
    for side in ("jax", "port"):
        for kind, argv in (("file", ["--src", src, "--dst", str(tmp_path / f"{side}.avi")]),
                           ("tree", ["--src", str(tmp_path / "corpus"),
                                     "--dst", str(tmp_path / f"{side}_tree"), "--quality", "80"])):
            if side == "jax":
                run_root(monkeypatch, "ingest_transcode", argv)
            else:
                ingest_transcode.main(argv + ["--device", "cpu"])
            outputs[side, kind] = capsys.readouterr().out.replace(side, "X")
    assert outputs["port", "file"] == outputs["jax", "file"] == \
        f"transcoded 4 frames → {tmp_path / 'X.avi'}\n"
    assert outputs["port", "tree"] == outputs["jax", "tree"]
    assert "transcoded 2 clips" in outputs["port", "tree"]
    for rel in ("{}.avi", "{}_tree/a.avi", "{}_tree/sub/b.avi"):
        got = media._read_video_native(str(tmp_path / rel.format("port")), 4, "uniform",
                                       None, None)
        want = media._read_video_native(str(tmp_path / rel.format("jax")), 4, "uniform",
                                        None, None)
        assert got.shape == want.shape == (4, 32, 48, 3)
        assert np.abs(got.astype(int) - want).max() <= JPEG_ATOL


class Memo:
    """A judge whose answers are computed once per input list (the lexicon
    judge runs thousands of patterns a reason)."""

    cache = {}

    def __init__(self, judge, key: str):
        self.judge, self.key = judge, key

    def _call(self, method: str, items):
        key = (self.key, method, tuple(items))
        if key not in Memo.cache:
            Memo.cache[key] = getattr(self.judge, method)(items)
        return Memo.cache[key]

    def reason_to_openset(self, reasons):
        return self._call("reason_to_openset", reasons)

    def openset_to_sentiment(self, opensets):
        return self._call("openset_to_sentiment", opensets)


def judges(side: str, biased: bool):
    cls = JLexiconJudge if side == "jax" else LexiconJudge
    full = Memo(cls(), f"{side}_full")
    if not biased:
        return full, full
    return full, Memo(cls(vocabulary=["happy", "sad"]), f"{side}_biased")


@pytest.mark.parametrize("case", ["self", "biased", "wheel"])
def test_compare_judges_matches_jax(case):
    jab = root_script("judge_ab")
    port, jax_judges = judges("port", case != "self"), judges("jax", case != "self")
    wheels = (None, None)
    if case == "wheel":
        from affectgpt_tpu.evaluation.wheel import WheelMetrics as JWheel
        from affectgpt_tpu_torch.evaluation.wheel import WheelMetrics

        wheels = (JWheel(), WheelMetrics())
    want = jab.compare_judges(REASONS, *jax_judges, wheels[0])
    got = judge_ab.compare_judges(REASONS, *port, wheels[1])
    assert got == want and got["samples"] == len(REASONS)
    if case == "self":
        assert got["openset_jaccard_mean"] == got["sentiment_match_rate"] == 1.0
    for raw in ("['Joyful', 'happy']", "[]", "sad, angry"):
        assert judge_ab.label_set(raw, wheels[1]) == jab.label_set(raw, wheels[0])


def test_judge_ab_command_line(tmp_path, capsys):
    """The command line on the CPU: the tiny random LLM judge (sampled, so
    not held to JAX's draws) against the lexicon judge, one JSON line; an
    npz of answers reads as the JSON does."""
    captured = tmp_path / "reasons.json"
    captured.write_text(json.dumps(REASONS))
    np.savez_compressed(tmp_path / "1.npz", name2reason=REASONS)
    report = judge_ab.main(["--npz", str(tmp_path / "1.npz"), "--no-wheel",
                            "--max_new_tokens", "8", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"metric": "llm-vs-lexicon judge agreement", **report}
    assert report["samples"] == len(REASONS)
    assert 0.0 <= report["openset_jaccard_mean"] <= 1.0
    assert judge_ab.load_reasons(str(tmp_path / "1.npz"), None) == \
        judge_ab.load_reasons(None, str(captured)) == REASONS
    with pytest.raises(SystemExit):
        judge_ab.main(["--device", "cpu"])
