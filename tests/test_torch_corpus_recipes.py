"""The port's corpus recipes against the JAX package's, on synthetic raw
trees: every recipe writes the same label*.npz (the same splits, names,
labels and value types), the same transcription.csv bytes, the same media
copies and returns the same counts. The raw CSVs hold what pandas types
(quoted commas, empty cells, integer and float columns, Chinese text);
the port reads them with its csv reader, JAX with pandas."""

import os
import pickle

import numpy as np
import pandas as pd
import pytest

from affectgpt_tpu.data import corpus_recipes as jcr
from affectgpt_tpu_torch.data import corpus_recipes as tcr


def touch(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as handle:
        handle.write(b"\x00" * 16)


def write_mer2023(root):
    for split, n in (("train", 3), ("test1", 2), ("test2", 2), ("test3", 2)):
        rows = {"name": [f"{split}_{i:05d}" for i in range(n)],
                "discrete": ["happy", "sad", "angry"][:n]}
        if split != "test3":
            rows["valence"] = [0.5, -1.25, 2][:n]
        pd.DataFrame(rows).to_csv(root / f"{split}-label.csv", index=False)
        for name in rows["name"][:-1]:  # the last clip's media is missing
            touch(root / split / f"{name}.mp4")


def write_mer2024(root):
    pd.DataFrame({"name": ["a", "b", 7], "discrete": ["sad", "happy", "worried"]}).to_csv(
        root / "label-disdim.csv", index=False)
    pd.DataFrame({"name": [f"s{i}" for i in range(7)],
                  "discrete": ["neutral"] * 7}).to_csv(root / "semi-label.csv", index=False)
    touch(root / "video-labeled" / "a.mp4")
    touch(root / "video-unlabeled" / "s3.mp4")


def write_meld(root):
    for csv_name, video_dir in (("train_sent_emo.csv", "train"), ("dev_sent_emo.csv", "dev"),
                                ("test_sent_emo.csv", "test")):
        pd.DataFrame({
            "Sr No.": [1, 2, 3], "Dialogue_ID": [0, 0, 12], "Utterance_ID": [0, 1, 3],
            "Emotion": ["joy", "anger", "surprise"],
            "Utterance": ['hi, "there"', "", "你好 world"],
        }).to_csv(root / csv_name, index=False)
        touch(root / video_dir / "dia0_utt1.mp4")


def write_sims(root):
    meta = root / "metadata"
    os.makedirs(meta / "sentiment", exist_ok=True)
    pd.DataFrame({"video_id": ["v1", "v1", "v2", "0003"], "clip_id": [1, 2, 1, 10],
                  "label": [0.4, -0.6, 0.0, 1.0]}).to_csv(
        meta / "sentiment" / "label_M.csv", index=False)
    for split, idx in (("train", [0, 1, 3]), ("val", [2]), ("test", [2, 3])):
        pd.DataFrame({"index": idx}).to_csv(meta / f"{split}_index.csv", index=False)
    pd.DataFrame({"video_id": ["v1", "v2"], "clip_id": [1, 1],
                  "Chinese": ["你好", "谢谢，朋友"], "English": ["hello", "thanks, friend"]}).to_csv(
        meta / "Translation.csv", index=False)
    touch(root / "Raw" / "v1" / "0002.mp4")


def write_simsv2(root):
    pd.DataFrame({
        "video_id": ["a", "a", "b", "c"], "clip_id": [1, 2, 1, 3],
        "text": ["x", "y, z", "", "好"], "label": [0.1, 0.2, -0.3, 1],
        "mode": ["train", "valid", "test", "train"],
    }).to_csv(root / "meta.csv", index=False)
    touch(root / "Raw" / "a" / "0001.mp4")


def write_mosi(root, name):
    video_ids = {"vidA": ["uA_1", "uA_2"], "vidB": ["uB_1"], "vidC": ["uC_1"]}
    labels = {"vidA": [0.5, -0.5], "vidB": [1.0], "vidC": [-3]}
    sentences = {"vidA": ["one", "two, three"], "vidB": ["four"], "vidC": [""]}
    with open(root / f"{name}_features_raw_2way.pkl", "wb") as handle:
        pickle.dump((video_ids, labels, None, sentences, {"vidA"}, {"vidC"}, {"vidB"}), handle)
    sub = os.path.join("Video", "Segmented") if name == "CMUMOSI" else "subvideo-raw"
    touch(root / sub / "uA_2.mp4")


def write_iemocap(root):
    trans = root / "Session1" / "dialog" / "transcriptions"
    os.makedirs(trans, exist_ok=True)
    (trans / "Ses01F_impro01.txt").write_text(
        "Ses01F_impro01_F000 [1.00-2.50]: Hello, there.\n"
        "garbage line\n"
        "Ses01F_impro01_M000 [3.00-4.00]: Hi.\n"
        "Ses01F_impro01_M001 [bad-4.00]: skipped\n")
    touch(root / "Session1" / "dialog" / "avi" / "DivX" / "Ses01F_impro01.avi")
    video_ids = {"Ses01F_impro01": ["Ses01F_impro01_F000", "Ses01F_impro01_M000"],
                 "Ses02": ["Ses02_F000"]}
    labels = {"Ses01F_impro01": [2, 3], "Ses02": [1]}
    with open(root / "labels.pkl", "wb") as handle:
        pickle.dump((video_ids, labels, None, None, {"Ses01F_impro01"}, {"Ses02"}), handle)


RECIPES = {
    "mer2023": (write_mer2023, lambda cr, root, out: cr.normalize_mer2023(root, out)),
    "mer2024": (write_mer2024, lambda cr, root, out: cr.normalize_mer2024(root, out, seed=3)),
    "meld": (write_meld, lambda cr, root, out: cr.normalize_meld(root, out)),
    "sims": (write_sims, lambda cr, root, out: cr.normalize_sims(root, out)),
    "simsv2": (write_simsv2, lambda cr, root, out: cr.normalize_simsv2(root, out)),
    "cmumosi": (lambda r: write_mosi(r, "CMUMOSI"),
                lambda cr, root, out: cr.normalize_cmumosi(root, out)),
    "cmumosei": (lambda r: write_mosi(r, "CMUMOSEI"),
                 lambda cr, root, out: cr.normalize_cmumosei(root, out)),
}


def outputs(root) -> dict:
    """Every file under a recipe's save root: npz as {key: object}, the rest
    as bytes."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            rel = os.path.relpath(path, root)
            if f.endswith(".npz"):
                with np.load(path, allow_pickle=True) as data:
                    out[rel] = {k: data[k].tolist() for k in data.files}
            else:
                out[rel] = open(path, "rb").read()
    return out


def typed(tree):
    """The value with its Python types spelt out, so 1 and 1.0 differ."""
    if isinstance(tree, dict):
        return {k: typed(v) for k, v in tree.items()}
    return (type(tree).__name__, tree)


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_recipe_writes_jax_outputs(tmp_path, recipe):
    write, run = RECIPES[recipe]
    raw = tmp_path / "raw"
    raw.mkdir()
    write(raw)
    want = run(jcr, str(raw), str(tmp_path / "jax"))
    got = run(tcr, str(raw), str(tmp_path / "port"))
    assert got == want
    jax_out, port_out = outputs(tmp_path / "jax"), outputs(tmp_path / "port")
    assert sorted(port_out) == sorted(jax_out)
    for rel, value in jax_out.items():
        if rel.endswith(".npz"):
            assert typed(port_out[rel]) == typed(value), rel
        else:
            assert port_out[rel] == value, rel
    assert any(rel.endswith(".npz") for rel in port_out)


def test_iemocap_writes_jax_outputs_and_transcodes(tmp_path):
    raw = tmp_path / "raw"
    write_iemocap(raw)
    calls = {"jax": [], "port": []}
    for side, cr in (("jax", jcr), ("port", tcr)):
        out = str(tmp_path / side)
        counts = cr.normalize_iemocap(str(raw), out, str(raw / "labels.pkl"),
                                      transcode=lambda *a, s=side: calls[s].append(
                                          (a[0], os.path.relpath(a[1], tmp_path / s), *a[2:])))
        assert counts == {"whole": 3, "transcribed": 2}
    assert calls["port"] == calls["jax"] and len(calls["port"]) == 2
    assert outputs(tmp_path / "port") == outputs(tmp_path / "jax")


def test_mer2023_unlabel_equals_jax(tmp_path):
    for side, cr in (("jax", jcr), ("port", tcr)):
        face_root = tmp_path / side / "openface_face"
        for name, n in (("sample_a", 40), ("sample_b", 10), ("sample_c", 17)):
            (face_root / name).mkdir(parents=True)
            np.save(face_root / name / f"{name}.npy", np.zeros((n, 4, 4, 3), np.uint8))
        (face_root / "sample_bad").mkdir()
        (face_root / "sample_bad" / "sample_bad.npy").write_bytes(b"not a npy")
        assert cr.normalize_mer2023_unlabel(str(tmp_path / side), prune=True) == {
            "total": 4, "kept": 2, "short": 1, "errors": 1}
    assert outputs(tmp_path / "port") == outputs(tmp_path / "jax")
