"""The toolkit's IO, API helpers and GPT-4V annotation engine in the port
against the JAX package's, with stub transports: the CSVs equal byte for
byte (the port writes them without pandas), the npz contents equal (the
shuffled order, each batch's names and response), the bisection path's
files, resume, parsing, validation, top-1 scoring and sample selection,
and `LocalJudgeTransport`'s prompt."""

import os

import numpy as np
import pytest

from affectgpt_tpu.toolkit import api_helpers as japi
from affectgpt_tpu.toolkit import gptv as jgptv
from affectgpt_tpu.toolkit import io as jio
from affectgpt_tpu_torch.toolkit import api_helpers, gptv
from affectgpt_tpu_torch.toolkit import io as tio


def make_images(root, n=7):
    paths = []
    for i in range(n):
        p = root / "src" / f"img{i}.jpg"
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(b"\xff\xd8fake" + bytes([i]))
        paths.append(str(p))
    return paths


class FormatTransport:
    """Answers every batch in the reference 'name/result' contract; fails
    the calls whose numbers are in `fail_calls`."""

    def __init__(self, label="Happiness", fail_calls=()):
        self.label = label
        self.fail_calls = set(fail_calls)
        self.calls = 0
        self.prompts = []

    def __call__(self, messages):
        self.calls += 1
        self.prompts.append(messages)
        if self.calls in self.fail_calls:
            raise RuntimeError("simulated API error")
        content = messages[0]["content"]
        n_images = sum(1 for c in content if c.get("type") == "image_url")
        return "".join(
            f"{{'name': image-{i + 1}, 'result': ['{self.label}', 'Neutral']}}\n"
            for i in range(n_images))


def npz_contents(root):
    out = {}
    for name in sorted(os.listdir(root)):
        pack = np.load(os.path.join(root, name), allow_pickle=True)
        out[name] = {k: pack[k].tolist() for k in pack.files}
    return out


def both(tmp_path, fn):
    """fn(module, directory) for the JAX and the port module in directories
    of their own; returns both results."""
    out = []
    for side, module in (("jax", jgptv), ("port", gptv)):
        (tmp_path / side).mkdir(exist_ok=True)
        out.append(fn(module, tmp_path / side))
    return out


# -- io -----------------------------------------------------------------------------


ROWS = {"s1": [1, 0.5, "happy"], "s2": [2, float("nan"), "sad, a \"quote\""],
        "s3": [3, 1e-5, None], "s4": [4, 2.0, "中文"]}


@pytest.mark.parametrize("keys", [("idx", "val", "label"), ("idx",), ("idx", "val")])
def test_write_key_to_csv_matches_pandas(tmp_path, keys):
    names = list(ROWS)
    jio.func_write_key_to_csv(str(tmp_path / "jax.csv"), names, ROWS, keys)
    tio.func_write_key_to_csv(str(tmp_path / "port.csv"), names, ROWS, keys)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    scalar = {n: v[1] for n, v in ROWS.items()}
    jio.func_write_key_to_csv(str(tmp_path / "jax1.csv"), names, scalar, ["val"])
    tio.func_write_key_to_csv(str(tmp_path / "port1.csv"), names, scalar, ["val"])
    assert (tmp_path / "port1.csv").read_bytes() == (tmp_path / "jax1.csv").read_bytes()


@pytest.mark.parametrize("rows", [
    [],
    [{"a": 1, "b": 2.5}, {"a": 2, "b": 3}],
    [{"a": True}, {"a": None}, {"c": "x,y"}],
    [{"a": np.float32(0.1)}, {"a": np.float32(2)}],
    [{"a": np.int64(3)}, {"a": "s"}, {"a": float("inf")}],
    [{"only": ""}, {"only": None}],
], ids=["empty", "int_float", "bool_missing", "float32", "mixed", "single_empty"])
def test_write_rows_csv_matches_pandas(tmp_path, rows):
    import pandas as pd

    pd.DataFrame(rows).to_csv(tmp_path / "pandas.csv", index=False)
    tio.write_rows_csv(str(tmp_path / "port.csv"), rows)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "pandas.csv").read_bytes()


def test_csv_readers_and_npz_match_jax(tmp_path):
    names = list(ROWS)
    path = str(tmp_path / "t.csv")
    jio.func_write_key_to_csv(path, names, ROWS, ("value", "val", "label"))
    for key in ("name", "value", "val", "label"):
        got, want = tio.func_read_key_from_csv(path, key), jio.func_read_key_from_csv(path, key)
        assert [str(x) for x in got] == [str(x) for x in want]
    assert tio.read_csv_as_map(path) == jio.read_csv_as_map(path)
    assert tio.read_csv_as_map(path, value="label").keys() == \
        jio.read_csv_as_map(path, value="label").keys()
    n2v = {"a": "happy", "b": "sad, calm", "c": ""}
    jio.write_name2value_npz(str(tmp_path / "jax.npz"), n2v)
    tio.write_name2value_npz(str(tmp_path / "port.npz"), n2v)
    assert tio.read_name2value_npz(str(tmp_path / "port.npz")) == \
        jio.read_name2value_npz(str(tmp_path / "jax.npz")) == n2v
    corpus = {"x": {"emo": "sad", "val": -1.0}}
    np.savez(tmp_path / "label.npz", test_corpus=np.array(corpus, dtype=object))
    assert tio.read_npz_corpus(str(tmp_path / "label.npz"), "test_corpus") == \
        jio.read_npz_corpus(str(tmp_path / "label.npz"), "test_corpus") == corpus


# -- api_helpers ---------------------------------------------------------------------


def test_retry_and_prompts_match_jax():
    calls = {"n": 0}

    def flaky(messages):
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("boom")
        return "ok"

    assert api_helpers.complete_with_retry(flaky, [], max_retries=5, backoff_s=0) == "ok"
    assert calls["n"] == 3

    def always_fail(messages):
        raise RuntimeError("nope")

    assert api_helpers.complete_with_retry(always_fail, [], max_retries=2, backoff_s=0) is None
    assert api_helpers.EMOTION_ANNOTATION_PROMPT == japi.EMOTION_ANNOTATION_PROMPT
    assert api_helpers.TRANSLATION_PROMPT == japi.TRANSLATION_PROMPT
    seen = []
    for module in (japi, api_helpers):
        assert module.translate_text(lambda m: seen.append(m) or "hello", "你好") == "hello"
    assert seen[0] == seen[1] and "Input: 你好" in seen[1][0]["content"]


def test_annotate_dataset_matches_jax(tmp_path, monkeypatch):
    """The same csv bytes after each run; resume skips the rows written, a
    transport failing every attempt leaves its clip out."""
    frame = tmp_path / "f.jpg"
    frame.write_bytes(b"\xff\xd8fake")
    name2frames = {"a": [str(frame)], "b": [str(frame), str(frame)], "c": [str(frame)]}
    fail = lambda m: (_ for _ in ()).throw(RuntimeError("down"))  # noqa: E731
    for module, csv in ((japi, tmp_path / "jax.csv"), (api_helpers, tmp_path / "port.csv")):
        seen = []
        out = module.annotate_dataset(lambda m: seen.append(m) or f"[happy {len(seen)}]",
                                      {"a": name2frames["a"], "b": name2frames["b"]}, str(csv))
        assert out == {"a": "[happy 1]", "b": "[happy 2]"}
        assert len(seen[1][0]["content"]) == 3  # the prompt and two frames
        orig = module.complete_with_retry

        def quick(fn, messages, max_retries=5, backoff_s=2.0, _orig=orig):
            return _orig(fn, messages, max_retries=2, backoff_s=0)

        with monkeypatch.context() as patch:
            patch.setattr(module, "complete_with_retry", quick)
            assert module.annotate_dataset(fail, name2frames, str(csv)) == out
        out2 = module.annotate_dataset(lambda m: "[sad]", name2frames, str(csv))
        assert out2 == {**out, "c": "[sad]"}
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert api_helpers.image_content(str(frame)) == japi.image_content(str(frame))


def test_local_judge_transport_prompt_matches_jax():
    class Judge:
        def __init__(self):
            self.prompts = []

        def complete_batch(self, prompts):
            self.prompts.append(list(prompts))
            return [f"answer {len(p)}" for p in prompts]

    messages = [{"role": "system", "content": "be brief"},
                {"role": "user", "content": [{"type": "text", "text": "label these"},
                                             {"type": "image_url", "image_url": {"url": "x"}},
                                             {"type": "text", "text": "two images"}]}]
    judges = Judge(), Judge()
    assert api_helpers.LocalJudgeTransport(judges[1])(messages) == \
        japi.LocalJudgeTransport(judges[0])(messages)
    assert judges[0].prompts == judges[1].prompts == [["be brief\nlabel these\ntwo images"]]


# -- gptv ----------------------------------------------------------------------------


def test_vocabularies_and_prompt_match_jax(tmp_path):
    assert gptv.GPTV_EMOS == jgptv.GPTV_EMOS and len(gptv.GPTV_EMOS) == 21
    paths = make_images(tmp_path, n=2)
    assert gptv.build_batch_prompt(paths, gptv.GPTV_EMOS["mer2023"]) == \
        jgptv.build_batch_prompt(paths, jgptv.GPTV_EMOS["mer2023"])
    text = "{'name': 1, 'result': ['happy', 'sad']}\n{'name': 2, 'result': ['angry']}"
    assert gptv.parse_batch_response(text) == jgptv.parse_batch_response(text)
    assert gptv._split_ranking("'happy', 'sad'") == jgptv._split_ranking("'happy', 'sad'")


@pytest.mark.parametrize("case", [
    {"n": 7, "bsize": 3, "fail": ()},  # three batches, then a resume
    {"n": 6, "bsize": 6, "fail": (1,)},  # the whole batch fails: two segments
    {"n": 8, "bsize": 8, "fail": (1, 2)},  # a segment fails too: quarters
    {"n": 4, "bsize": 4, "fail": (1, 2, 3)},  # bisect_depth 2 gives up on a quarter
], ids=["resume", "bisect", "bisect_twice", "give_up"])
def test_annotate_images_matches_jax(tmp_path, case):
    paths = make_images(tmp_path, case["n"])

    def run(module, out):
        transport = FormatTransport(fail_calls=case["fail"])
        args = (paths, str(out / "ann"), str(out / "order.npz"), module.GPTV_EMOS["rafdb"])
        module.annotate_images(transport, *args, bsize=case["bsize"], bisect_depth=2)
        calls = transport.calls
        module.annotate_images(transport, *args, bsize=case["bsize"], bisect_depth=2)
        return calls, transport.calls, transport.prompts, npz_contents(out / "ann"), \
            np.load(out / "order.npz", allow_pickle=True)["image_paths"].tolist(), \
            module.collect_batches(str(out / "ann"))

    want, got = both(tmp_path, run)
    assert got[:2] == want[:2] and got[2] == want[2]
    assert got[3] == want[3] and got[4] == want[4] and got[5] == want[5]
    if case["fail"]:
        assert any("segment" in name for name in got[3])


def test_collect_score_and_select_match_jax(tmp_path):
    paths = make_images(tmp_path, n=5)
    name2gt = {f"img{i}.jpg": ("Sadness" if i % 2 == 0 else "Anger") for i in range(4)}

    def run(module, out):
        module.annotate_images(FormatTransport(label="Sadness"), paths, str(out / "ann"),
                               str(out / "order.npz"), module.GPTV_EMOS["rafdb"], bsize=2)
        np.savez_compressed(out / "ann" / "batch_9.npz", gpt4v="{'name': 1, 'result': ['x']}",
                            names=np.array(["a.jpg", "b.jpg"], dtype=object))
        acc = module.score_top1(str(out / "ann"), name2gt, str(out / "merged.csv"))
        kept = module.collect_batches(str(out / "ann"), delete_bad=True)
        csv = module.select_samples(list(name2gt), list(name2gt.values()),
                                    image_src=lambda n: str(tmp_path / "src" / n),
                                    save_root=str(out / "sel"))
        return acc, kept, sorted(os.listdir(out / "ann")), (out / "merged.csv").read_bytes(), \
            open(csv, "rb").read(), sorted(os.listdir(out / "sel" / "image"))

    want, got = both(tmp_path, run)
    assert got == want
    assert got[0] == 0.5 and "batch_9.npz" not in got[2] and len(got[5]) == 4
