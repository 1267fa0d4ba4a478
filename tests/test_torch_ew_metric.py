"""The port's dataset scorers against the JAX package's: `score_discrete`,
`score_ov` and `score_dimension` with the LexiconJudge over the vendored
wheel, on synthetic result npz in both formats (name2reason, and
filenames/fileitems), give the same scores and write the same judge caches;
the numpy F1 and accuracy equal sklearn's (the oracle; the card has no
sklearn) to 1e-12 on drawn labels, classes absent from either side
included."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from sklearn.metrics import accuracy_score, f1_score

from affectgpt_tpu.evaluation import ew_metric as jew
from affectgpt_tpu.evaluation import judge as jjudge
from affectgpt_tpu.evaluation import wheel as jwheel
from affectgpt_tpu_torch.evaluation import ew_metric as tew
from affectgpt_tpu_torch.evaluation import judge as tjudge
from affectgpt_tpu_torch.evaluation import wheel as twheel

REASONS = [
    "The person looks happy and excited, smiling broadly.",
    "She seems sad, her voice trembling; maybe worried too.",
    "He is furious and angry at the news.",
    "Nothing emotional is visible here.",
    "A calm, content and relaxed mood with a hint of surprise.",
    "Answer: gloomy and anxious ### trailing",
]
NAMES = [f"clip_{i}" for i in range(len(REASONS))]
JUDGES = {"jax": jjudge.LexiconJudge(), "port": tjudge.LexiconJudge()}
WHEELS = {"jax": jwheel.WheelMetrics(), "port": twheel.WheelMetrics()}


def write_results(path, fmt: str):
    if fmt == "name2reason":
        np.savez_compressed(path, name2reason=dict(zip(NAMES, REASONS)))
    else:
        np.savez_compressed(path, filenames=NAMES, fileitems=REASONS)


def caches(tmp_path, side: str) -> dict:
    out = {}
    for p in sorted(tmp_path.glob(f"{side}/*-*.npz")):
        with np.load(p, allow_pickle=True) as data:
            out[p.name] = {k: data[k].tolist() for k in data.files}
    return out


@pytest.fixture(params=["name2reason", "filenames"])
def results(tmp_path, request):
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        write_results(tmp_path / side / "3.npz", request.param)
    return tmp_path


def test_lexicon_vocabulary_equals_jax():
    assert JUDGES["port"].vocabulary == JUDGES["jax"].vocabulary
    assert len(JUDGES["port"].vocabulary) == 7386


def test_score_discrete_equals_jax(results):
    gt = dict(zip(NAMES, ["happy", "sad", "angry", "neutral", "happy", "worried"]))
    want = jew.score_discrete(str(results / "jax" / "3.npz"), gt, JUDGES["jax"], WHEELS["jax"])
    got = tew.score_discrete(str(results / "port" / "3.npz"), gt, JUDGES["port"],
                             WHEELS["port"])
    assert got == want and 0 < got[0] < 1
    assert caches(results, "port") == caches(results, "jax")
    assert list(caches(results, "port")) == ["3-openset.npz"]


def test_score_ov_equals_jax(results):
    gt = dict(zip(NAMES, ["['happy', 'excited']", "sad, worried", "[angry]", "[]",
                          "calm, relaxed", "gloomy"]))
    want = jew.score_ov(str(results / "jax" / "3.npz"), gt, JUDGES["jax"], WHEELS["jax"])
    got = tew.score_ov(str(results / "port" / "3.npz"), gt, JUDGES["port"], WHEELS["port"])
    assert got == want and 0 < got[0] < 1
    assert caches(results, "port") == caches(results, "jax")


def test_score_dimension_equals_jax(results):
    gt = dict(zip(NAMES, [0.8, -0.4, -1.2, 0.0, 0.6, 0.2]))
    want = jew.score_dimension(str(results / "jax" / "3.npz"), gt, JUDGES["jax"])
    got = tew.score_dimension(str(results / "port" / "3.npz"), gt, JUDGES["port"])
    assert got == pytest.approx(want, abs=1e-12) and 0 < got[0] < 1
    assert caches(results, "port") == caches(results, "jax")
    assert list(caches(results, "port")) == ["3-openset-sentiment.npz", "3-openset.npz"]


def test_reason_normalizer_equals_jax(results):
    import evaluation_emotion_llama as jax_llama  # noqa: F401 (the root script)

    from affectgpt_tpu_torch.evaluation_emotion_llama import normalize_baseline_answer

    try:
        jew.set_reason_normalizer(jax_llama.normalize_baseline_answer)
        tew.set_reason_normalizer(normalize_baseline_answer)
        for side, mod in (("jax", jew), ("port", tew)):
            loaded = mod.load_name2reason(str(results / side / "3.npz"))
            assert loaded[NAMES[-1]] == "gloomy and anxious"
        assert tew.load_name2reason(str(results / "port" / "3.npz")) == \
            jew.load_name2reason(str(results / "jax" / "3.npz"))
    finally:
        jew.set_reason_normalizer(None)
        tew.set_reason_normalizer(None)


ABSENT_CLASS_CASES = [
    ([True, True, True], [True, True, True]),
    ([True, True, True], [False, False, False]),
    ([True, False, True], [True, True, True]),
    ([False, False], [True, False]),
    ([True], [False]),
    ([False, True, False, True], [False, False, False, False]),
]


@pytest.mark.parametrize("y_true,y_pred", ABSENT_CLASS_CASES)
def test_f1_and_accuracy_equal_sklearn_where_a_class_is_absent(y_true, y_pred):
    assert tew.weighted_f1_score(y_true, y_pred) == pytest.approx(
        f1_score(y_true, y_pred, average="weighted", zero_division=0), abs=1e-12)
    assert tew.accuracy_score(y_true, y_pred) == pytest.approx(
        accuracy_score(y_true, y_pred), abs=1e-12)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.tuples(st.booleans(), st.booleans()), min_size=1, max_size=40))
def test_f1_and_accuracy_equal_sklearn_on_drawn_labels(pairs):
    y_true = np.array([a for a, _ in pairs])
    y_pred = np.array([b for _, b in pairs])
    assert tew.weighted_f1_score(y_true, y_pred) == pytest.approx(
        f1_score(y_true, y_pred, average="weighted", zero_division=0), abs=1e-12)
    assert tew.accuracy_score(y_true, y_pred) == pytest.approx(
        accuracy_score(y_true, y_pred), abs=1e-12)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 4), st.integers(0, 4)), min_size=1, max_size=30))
def test_weighted_f1_equals_sklearn_on_several_classes(pairs):
    y_true = [a for a, _ in pairs]
    y_pred = [b for _, b in pairs]
    assert tew.weighted_f1_score(y_true, y_pred) == pytest.approx(
        f1_score(y_true, y_pred, average="weighted", zero_division=0), abs=1e-12)
