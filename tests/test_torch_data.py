"""The port's data pipeline against the JAX package's, on the CPU.

- Every registered dataset class on a corpus built from
  `tests/synth_corpus.build_corpus` plus files for the other corpora:
  `__getitem__` and `collate` give the same ids, labels, masks, offsets,
  names and features (preextracted, and raw audio read from wav files at
  16 and 8 kHz) bit for bit.
- The CSV readers without pandas against pandas on empty cells, NA markers,
  quoted commas and numeric and boolean columns.
- `ops/sampling`, `data/qa`, `data/normalize`, `data/shards` and the
  `IterLoader` / `MultiIterLoader` streams for a seed.
- The two media defects the port does not copy, each against the JAX
  module's behaviour.
- `DevicePrefetcher` on the CPU: order, an error raised in the consumer,
  `close()` joining a worker blocked on a full queue.
"""

import json
import random
import threading
import time

import numpy as np
import pandas as pd
import pytest
import torch

from affectgpt_tpu import paths as jpaths
from affectgpt_tpu import registry as jregistry
from affectgpt_tpu import tokenization as jtok
from affectgpt_tpu.data import base_dataset as jbase
from affectgpt_tpu.data import datasets as jdatasets
from affectgpt_tpu.data import instruction_datasets as jinstr
from affectgpt_tpu.data import loaders as jloaders
from affectgpt_tpu.data import media as jmedia
from affectgpt_tpu.data import normalize as jnorm
from affectgpt_tpu.data import qa as jqa
from affectgpt_tpu.data import shards as jshards
from affectgpt_tpu.ops import sampling as jsampling
from affectgpt_tpu_torch import paths as tpaths
from affectgpt_tpu_torch import registry as tregistry
from affectgpt_tpu_torch import tokenization as ttok
from affectgpt_tpu_torch.data import base_dataset as tbase
from affectgpt_tpu_torch.data import datasets as tdatasets
from affectgpt_tpu_torch.data import instruction_datasets as tinstr
from affectgpt_tpu_torch.data import loaders as tloaders
from affectgpt_tpu_torch.data import media as tmedia
from affectgpt_tpu_torch.data import normalize as tnorm
from affectgpt_tpu_torch.data import qa as tqa
from affectgpt_tpu_torch.data import shards as tshards
from affectgpt_tpu_torch.ops import sampling as tsampling
from tests.synth_corpus import NAMES, build_corpus, write_wav

del jinstr, tinstr  # imported for their registrations

OV = ("OVMERD", "OVMERDPlus", "MER2025OV")
ONEHOT = ("MER2024", "MELD")
VALENCE = ("CMUMOSI", "CMUMOSEI", "SIMS", "SIMSv2")
CSV_FAMILIES = {
    "EMERCoarse": "emer_coarse.csv", "EMERFine": "emer_fine.csv",
    "EMERCoarseFilter": "emer_coarse_filter.csv", "MERRCoarse": "merr_coarse.csv",
    "MERRFine": "merr_fine.csv", "MAFW": "mafw.csv", "Preference": "preference.csv",
    "Preference2": "preference2.csv", "Preference4": "preference4.csv",
    "Preference3": "preference3.csv",
}
JSON_FAMILIES = ("VideoChat", "LLaVA", "EmoVIT")
CAPTION_FAMILIES = ("MiniGPT4", "WavCaps", "TextrolSpeech", "PromptSpeech")
IEMOCAP_NAMES = ["Ses01F_a", "Ses02M_b", "Ses05F_c", "Ses03M_d"]


def subtitles(root, names, column="english"):
    pd.DataFrame({"name": names, column: ["hello, there", "", "so sad", "NA"][:len(names)]}) \
        .to_csv(root / "subtitles.csv", index=False)


def extend_corpus(tmp_path, overrides):
    """Files for every registered corpus that build_corpus does not make."""
    add = {k: {} for k in ("DATA_DIR", "PATH_TO_RAW_AUDIO", "PATH_TO_TRANSCRIPTIONS",
                           "PATH_TO_LABEL")}

    def root_of(ds):
        root = tmp_path / ds.lower()
        (root / "audio").mkdir(parents=True, exist_ok=True)
        add["DATA_DIR"][ds] = str(root)
        add["PATH_TO_RAW_AUDIO"][ds] = str(root / "audio")
        add["PATH_TO_TRANSCRIPTIONS"][ds] = str(root / "subtitles.csv")
        return root

    for ds in OV:
        root = root_of(ds)
        col = "sentence" if ds == "OVMERDPlus" else "english"
        subtitles(root, NAMES, col)
        if ds == "OVMERD":
            pd.DataFrame({"name": NAMES, "openset": ["['a', 'b']", "", "['c']"]}) \
                .to_csv(root / "track2_train_ovmerd.csv", index=False)
            pd.DataFrame({"name": NAMES, "reason": ["r, one", "", "r3"]}) \
                .to_csv(root / "track3_train_ovmerd.csv", index=False)
        if ds == "MER2025OV":  # test-only: candidate names, no training labels
            pd.DataFrame({"name": NAMES + ["000123"]}).to_csv(
                root / "track_all_candidates.csv", index=False)
        if ds == "OVMERDPlus":
            pd.DataFrame({"name": NAMES, "openset": ["['joy']", "['anger', 'fear']", "[]"]}) \
                .to_csv(root / "ovlabel.csv", index=False)
    for ds in ONEHOT + VALENCE:
        root = root_of(ds)
        subtitles(root, NAMES)
        if ds in ONEHOT:
            train = {n: {"emo": e} for n, e in zip(NAMES, ["happy", "sad", "happy"])}
        else:
            train = {n: {"val": v} for n, v in zip(NAMES, [0.5, -1.25, 0.0])}
        label = root / "label.npz"
        np.savez(label, train_corpus=np.array(train, dtype=object),
                 test_corpus=np.array(train, dtype=object),
                 test1_corpus=np.array(train, dtype=object))
        add["PATH_TO_LABEL"][ds] = str(label)
    root = root_of("IEMOCAPFour")
    subtitles(root, IEMOCAP_NAMES)
    whole = {n: {"emo": i % 4} for i, n in enumerate(IEMOCAP_NAMES)}
    np.savez(root / "label_4way.npz", whole_corpus=np.array(whole, dtype=object))
    add["PATH_TO_LABEL"]["IEMOCAPFour"] = str(root / "label_4way.npz")
    rows = {"name": NAMES, "openset": ["['happy']", "", "['sad', 'tired']"],
            "reason": ["because, well", "", "tears"], "valence": [0.5, "", -1],
            "sentiment": ["positive", "", "negative"], "a1": ["x", "y", "z"],
            "a2": ["u", "v", "w"], "p": ["a1", "same", "a2"],
            "reward": ["accept", "reject", "accept"], "caption": ["c1", "c, 2", "c3"]}
    for ds, csv_name in CSV_FAMILIES.items():
        root = root_of(ds)
        subtitles(root, NAMES)
        pd.DataFrame(rows).to_csv(root / csv_name, index=False)
    for ds in JSON_FAMILIES:
        root = root_of(ds)
        (root / "instructions.json").write_text(json.dumps(
            [{"name": n, "question": f"q{i}?", "answer": f"a, {i}"} for i, n in enumerate(NAMES)]))
    for ds in CAPTION_FAMILIES:
        root = root_of(ds)
        pd.DataFrame({"name": NAMES, "caption": ["c1", "c, 2", "c3"]}) \
            .to_csv(root / "captions.csv", index=False)
    for ds, roots in add["DATA_DIR"].items():  # raw audio at 16 and 8 kHz
        for i, n in enumerate(NAMES + IEMOCAP_NAMES):
            rate = 8000 if i % 2 else 16000
            write_wav(f"{roots}/audio/{n}.wav",
                      np.random.RandomState(i).randn(rate * 3 // 2) * 0.1, rate=rate)
    for table, entries in add.items():
        overrides.setdefault(table, {}).update(entries)
    return overrides


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("corpus")
    overrides, feat_root = build_corpus(tmp)
    overrides = extend_corpus(tmp, overrides)
    saved = [(m, k, dict(getattr(m, k))) for m in (jpaths, tpaths) for k in overrides]
    jpaths.update_from_dict(overrides)
    tpaths.update_from_dict(overrides)
    yield feat_root
    for module, name, value in saved:
        getattr(module, name).clear()
        getattr(module, name).update(value)


def dataset_cases():
    names = tregistry.names("dataset")
    assert names == jregistry.names("dataset")
    return names


def make_pair(name, feat_root, seed=3):
    """The JAX and the port's dataset `name` on the same config."""
    if name in ("MERCaptionPlus", "MER2023"):
        node = {"face_or_frame": "multiface_audio_face_frame_text", "use_preextracted_frame": True,
                "use_preextracted_face": True, "use_preextracted_audio": True,
                "preextracted_root": feat_root, "max_length": 640}
    elif name in CAPTION_FAMILIES or name in JSON_FAMILIES:
        node = {"face_or_frame": "textonly", "max_length": 640}
    else:  # raw audio from the wav files, resampled to 16 kHz where they are 8
        node = {"face_or_frame": "audio_text", "max_length": 640}
    mcfg = dict(num_video_query_token=2, num_audio_query_token=3, num_multi_query_token=1,
                num_image_query_token=2)
    jds = jregistry.get("dataset", name)(jtok.ByteTokenizer(), jbase.DatasetConfig.from_cfg(node),
                                         jbase.ModelDataConfig(**mcfg), seed)
    tds = tregistry.get("dataset", name)(ttok.ByteTokenizer(), tbase.DatasetConfig.from_cfg(node),
                                         tbase.ModelDataConfig(**mcfg), seed, device="cpu")
    return jds, tds


def assert_tree_equal(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            assert_tree_equal(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, float) and np.isnan(want):
        assert isinstance(got, float) and np.isnan(got), where
    else:
        assert got == want, where


@pytest.mark.parametrize("name", dataset_cases())
def test_dataset_items_and_batches_equal_jax(name, corpus):
    jds, tds = make_pair(name, corpus)
    try:
        want_names = jds.read_test_names()
    except (NotImplementedError, AttributeError):
        want_names = None
    if want_names is not None:
        assert tds.read_test_names() == want_names
    assert len(tds) == len(jds)
    if name == "MER2025OV":  # test-only
        assert len(tds) == 0 and len(want_names) == 4
        return
    assert len(tds) > 0
    assert tds.annotation == jds.annotation or str(tds.annotation) == str(jds.annotation)
    items_j = [jds[i] for i in range(len(jds))]
    items_t = [tds[i] for i in range(len(tds))]
    for a, b in zip(items_t, items_j):
        assert_tree_equal(a, b, name)
    assert_tree_equal(tds.collate(items_t), jds.collate(items_j), name)
    assert_tree_equal(tds.smoke_check(), jds.smoke_check(), name)
    if hasattr(jds, "get_test_name2gt"):
        try:
            want = jds.get_test_name2gt()
        except NotImplementedError:
            want = None
        if want is not None:
            assert tds.get_test_name2gt() == want


TRICKY_CSV = ('name,english,val,flag,idx,text\n'
              '001,"hello, world",1.5,True,3,"a ""quoted"" one"\n'
              '002,,NA,False,,None\n'
              '003,None,-2,true,5,n/a\n'
              '004,plain,1e-5,false,7,"multi\nline"\n')


def test_csv_reader_equals_pandas(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text(TRICKY_CSV)
    want = pd.read_csv(path).to_dict("records")
    got = tdatasets.read_csv(str(path))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_tree_equal(g, w)
        assert {k: type(v) for k, v in g.items()} == {k: type(v) for k, v in w.items()}


@pytest.mark.parametrize("column", ["english", "text", "val", "flag"])
def test_subtitle_and_column_readers_equal_jax(tmp_path, column, monkeypatch):
    path = tmp_path / "subtitles.csv"
    path.write_text(TRICKY_CSV)
    for module in (jpaths, tpaths):
        monkeypatch.setitem(module.PATH_TO_TRANSCRIPTIONS, "MER2023", str(path))
    assert_tree_equal(tdatasets._read_subtitles("MER2023", column),
                      jdatasets._read_subtitles("MER2023", column))
    assert_tree_equal(tdatasets._read_name_column_csv(str(path), "name", column),
                      jdatasets._read_name_column_csv(str(path), "name", column))


@pytest.mark.parametrize("value", ["['happy', 'sad']", "[]", "", float("nan"), None,
                                   "['a','b' ,\"c\"]", np.array(["x", "y"]), ["p"], "calm"])
def test_string_to_list_equals_jax(value):
    assert tdatasets.string_to_list(value) == jdatasets.string_to_list(value)


@pytest.mark.parametrize("vlen,n", [(1, 8), (5, 8), (8, 8), (37, 8), (300, 16)])
def test_sampling_indices_equal_jax(vlen, n):
    assert tsampling.uniform_indices(vlen, n) == jsampling.uniform_indices(vlen, n)
    if vlen >= 2 * n:
        assert tsampling.headtail_indices(vlen, n, random.Random(vlen)) == \
            jsampling.headtail_indices(vlen, n, random.Random(vlen))
    for peak, before, after in ((0, 0, 3), (4, 1, 1), (10, 2, 1), (6, 3, 5), (vlen - 1, 2, 0)):
        info = {"total_frames": vlen, "peak_frames": [
            {"peak_index": min(peak, vlen - 1), "frames_before_peak": before,
             "frames_after_peak": after}]}
        assert tsampling.emotion_peak_indices(info, vlen, n) == \
            jsampling.emotion_peak_indices(info, vlen, n)
    assert tsampling.emotion_peak_indices(None, vlen, n) == jsampling.emotion_peak_indices(None, vlen, n)
    assert tsampling.clip_timepoints(vlen / 4) == jsampling.clip_timepoints(vlen / 4)


QA_SAMPLE = {"description": "d", "ovlabel": "happy", "onehot": "sad", "valence": -0.25,
             "sentiment": "negative", "question": "q?", "answer": "a", "caption": "c",
             "preference": {"a1": "x", "a2": "y", "p": "a2"}, "reward": "reject"}
QA_DATASETS = ("EMERCoarse", "MERCaptionPlus", "EMERCoarseFilter", "Preference", "Preference3",
               "MERRFine", "MER2023", "CMUMOSI", "LLaVA", "MiniGPT4", "WavCaps")


@pytest.mark.parametrize("dataset", QA_DATASETS)
def test_qa_pairs_equal_jax(dataset):
    for label_type in ("description", "ovlabel", "onehot_w_candidates", "onehot_wo_candidates",
                       "valence", "sentiment", "qa", "preference", "reward", "caption"):
        try:
            want = jqa.get_qa_pairs(dataset, label_type, QA_SAMPLE, "a,b", -3, 3,
                                    rng=random.Random(1))
        except KeyError:
            with pytest.raises(KeyError):
                tqa.get_qa_pairs(dataset, label_type, QA_SAMPLE, "a,b", -3, 3,
                                 rng=random.Random(1))
            continue
        assert tqa.get_qa_pairs(dataset, label_type, QA_SAMPLE, "a,b", -3, 3,
                                rng=random.Random(1)) == want
    assert tqa.pick_label_type(["x", "y", "z"], "hybird", random.Random(4)) == \
        jqa.pick_label_type(["x", "y", "z"], "hybird", random.Random(4))


def test_normalize_equals_jax(tmp_path):
    samples = [{"name": f"s{i}", "emo": "happy" if i % 2 else "sad", "text": f"t, {i}"}
               for i in range(7)]
    outs = {}
    for tag, module in (("j", jnorm), ("t", tnorm)):
        root = tmp_path / tag
        counts = module.normalize_corpus(
            str(root), samples, label_fn=lambda s: {"emo": s["emo"]},
            subtitle_fn=lambda s: s["text"],
            split_fn=lambda s: "test" if s["name"] == "s3" else "train")
        module.write_transcriptions(str(root / "zh.csv"), {"a": "x, y", "b": ""}, {"a": "中"})
        outs[tag] = (counts, (root / "transcription-engchi-polish.csv").read_text(),
                     (root / "zh.csv").read_text(),
                     {k: v.tolist() for k, v in np.load(root / "label.npz",
                                                        allow_pickle=True).items()})
    assert outs["t"] == outs["j"]
    assert tnorm.split_by_ratio([f"n{i}" for i in range(11)], 0.7, seed=5) == \
        jnorm.split_by_ratio([f"n{i}" for i in range(11)], 0.7, seed=5)


def test_shards_equal_jax(tmp_path):
    samples = [{"__key__": f"k{i:03d}", "feat.npy": np.arange(i + 1, dtype=np.float32),
                "meta.json": {"i": i}, "cap.txt": f"caption {i}"} for i in range(9)]
    paths_j = jshards.write_shards(samples, str(tmp_path / "j"), shard_size=4)
    paths_t = tshards.write_shards(samples, str(tmp_path / "t"), shard_size=4)
    assert [p.split("/")[-1] for p in paths_t] == [p.split("/")[-1] for p in paths_j]
    for kwargs in ({}, {"shuffle_buffer": 3, "seed": 2}, {"worker_index": 1, "num_workers": 2}):
        got = list(tshards.ShardDataset(paths_t, **kwargs))
        want = list(jshards.ShardDataset(paths_j, **kwargs))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_tree_equal(g, w)


class Toy:
    """A dataset whose items are their indices and whose collate lists them."""

    def __init__(self, n, tag):
        self.n, self.tag = n, tag

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (self.tag, i)

    def collate(self, items):
        return list(items)


def test_loader_streams_equal_jax():
    def stream(module):
        loaders = [module.IterLoader(Toy(5, "a"), 3, seed=11),
                   module.IterLoader(Toy(7, "b"), 3, seed=12, shuffle=True)]
        mixed = module.MultiIterLoader(loaders, [1.0, 2.5], seed=42)
        return [next(mixed) for _ in range(20)]

    assert stream(tloaders) == stream(jloaders)
    concat_t = tloaders.ConcatDataset([Toy(2, "a"), Toy(3, "b")])
    concat_j = jloaders.ConcatDataset([Toy(2, "a"), Toy(3, "b")])
    assert [concat_t[i] for i in range(5)] == [concat_j[i] for i in range(5)]
    assert tloaders.reorg_datasets_by_split({"x": {"train": 1, "val": 2}, "y": 3}) == \
        jloaders.reorg_datasets_by_split({"x": {"train": 1, "val": 2}, "y": 3})


def avi_without_vids(path):
    """An AVI whose only stream header is 'auds', and whose movi holds a
    JPEG-bodied '00dc' chunk."""
    import struct

    def chunk(fourcc, body):
        return fourcc + struct.pack("<I", len(body)) + body + (b"\0" if len(body) % 2 else b"")

    strh = chunk(b"strh", b"auds" + b"\0" * 52)
    hdrl = chunk(b"LIST", b"hdrl" + chunk(b"avih", b"\0" * 56) + chunk(b"LIST", b"strl" + strh))
    movi = chunk(b"LIST", b"movi" + chunk(b"00dc", b"\xff\xd8" + b"\0" * 30 + b"\xff\xd9"))
    body = b"AVI " + hdrl + movi
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


def test_demux_without_a_video_stream_gives_no_frames(tmp_path):
    path = tmp_path / "audio_only.avi"
    avi_without_vids(path)
    assert jmedia.demux_mjpeg_avi(str(path))  # the JAX demuxer admits the chunk
    assert tmedia.demux_mjpeg_avi(str(path)) is None


def test_au_analysis_copies_are_independent(tmp_path):
    (tmp_path / "clip").mkdir()
    (tmp_path / "clip" / "clip_au_analysis.json").write_text(json.dumps(
        {"summary_description": {"0": "smile"}, "au_info": {"peak_frames": []}}))
    for module, shared in ((jmedia, True), (tmedia, False)):
        module._load_au_analysis_cached.cache_clear()
        first = module.load_au_analysis(str(tmp_path), "clip")
        first["summary_description"]["0"] = "edited"
        again = module.load_au_analysis(str(tmp_path), "clip")
        assert (again["summary_description"]["0"] == "edited") is shared
        module._load_au_analysis_cached.cache_clear()
    assert tmedia.load_au_summary_texts(str(tmp_path), "clip") == \
        jmedia.load_au_summary_texts(str(tmp_path), "clip") == ["smile"]


def test_wav_and_feature_paths_equal_jax(tmp_path):
    for rate in (16000, 22050):
        write_wav(tmp_path / "a.wav", np.random.RandomState(0).randn(rate // 3) * 0.2, rate=rate)
        got, want = tmedia.read_wav(str(tmp_path / "a.wav")), jmedia.read_wav(str(tmp_path / "a.wav"))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    for m in ("frame", "face", "audio", "multi", "au"):
        assert tmedia.feature_cache_path("r", "D", m, "E", "n") == \
            jmedia.feature_cache_path("r", "D", m, "E", "n")


class Counter:
    def __init__(self, fail_at=None):
        self.i, self.fail_at = 0, fail_at

    def __next__(self):
        if self.i == self.fail_at:
            raise ValueError(f"broken sample {self.i}")
        self.i += 1
        return {"x": np.full((2,), self.i - 1, np.int32), "name": self.i - 1}


def test_prefetcher_on_cpu_keeps_order_and_converts():
    pre = tloaders.DevicePrefetcher(Counter(), device="cpu")
    try:
        got = [next(pre) for _ in range(6)]
    finally:
        pre.close()
    assert [b["name"] for b in got] == list(range(6))
    assert all(torch.is_tensor(b["x"]) and b["x"].dtype == torch.int32 for b in got)
    assert not pre.thread.is_alive()


def test_prefetcher_raises_loader_errors_in_the_consumer():
    pre = tloaders.DevicePrefetcher(Counter(fail_at=3), device="cpu")
    try:
        assert [next(pre)["name"] for _ in range(3)] == [0, 1, 2]
        with pytest.raises(ValueError, match="broken sample 3"):
            next(pre)
    finally:
        pre.close()
    assert not pre.thread.is_alive()


def test_prefetcher_close_joins_a_worker_blocked_on_a_full_queue():
    pre = tloaders.DevicePrefetcher(Counter(), device="cpu", depth=1)
    deadline = time.time() + 5
    while not pre.queue.full() and time.time() < deadline:
        time.sleep(0.01)
    assert pre.queue.full()
    closer = threading.Thread(target=pre.close)
    closer.start()
    closer.join(timeout=5)
    assert not closer.is_alive() and not pre.thread.is_alive()
