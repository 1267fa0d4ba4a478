"""A synthetic MER2023 + MERCaptionPlus corpus with preextracted features,
for the quality-run recipe's `--synthetic` mode (random tiny weights, no
media or labels of the real corpora).

The port's copy of the repo's tests/synth_corpus.py (`build_corpus`,
`write_wav`, `NAMES`): numpy and the csv module, no pandas. Its CSVs hold
what `pd.DataFrame(...).to_csv(index=False)` writes for these string
columns.
"""

from __future__ import annotations

import csv
import os
import struct

import numpy as np

NAMES = ["sample_0001", "sample_0002", "sample_0003"]


def write_wav(path, samples, rate=16000):
    pcm = (np.clip(samples, -1, 1) * 32767).astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, rate, rate * 2, 2, 16))
        f.write(b"data" + struct.pack("<I", len(pcm)) + pcm)


def _write_csv(path, columns: dict) -> None:
    with open(path, "w", newline="") as handle:
        writer = csv.writer(handle, lineterminator="\n")
        writer.writerow(list(columns))
        writer.writerows(zip(*columns.values()))


def build_corpus(root, visual_dim=12, acoustic_dim=16):
    """Create MERCaptionPlus + MER2023 synthetic corpora under `root` with
    preextracted frame/face/audio features; returns the path-table
    overrides and the feature root."""
    root = str(root)
    roots = {}
    for ds in ("MERCaptionPlus", "MER2023"):
        d = os.path.join(root, ds.lower())
        for sub in ("audio", "video", "openface_face"):
            os.makedirs(os.path.join(d, sub))
        roots[ds] = d
        for name in NAMES:
            write_wav(os.path.join(d, "audio", f"{name}.wav"),
                      np.random.RandomState(0).randn(24000) * 0.1)
            faces = (np.random.RandomState(1).rand(5, 64, 64, 3) * 255).astype(np.uint8)
            if ds == "MERCaptionPlus":
                os.makedirs(os.path.join(d, "openface_face", name))
                np.save(os.path.join(d, "openface_face", name, f"{name}.npy"), faces)
            else:
                np.save(os.path.join(d, "openface_face", f"{name}.npy"), faces)
        _write_csv(os.path.join(d, "subtitles.csv"),
                   {"name": NAMES, "english": ["hello there", "", "so sad"]})

    mcp = roots["MERCaptionPlus"]
    _write_csv(os.path.join(mcp, "track2_train_mercaptionplus.csv"),
               {"name": NAMES, "openset": ["['happy','excited']", "[]", "['sad']"]})
    _write_csv(os.path.join(mcp, "track3_train_mercaptionplus.csv"),
               {"name": NAMES, "reason": [f"Because {n} smiles." for n in NAMES]})

    m23 = roots["MER2023"]
    train_corpus = {n: {"emo": e} for n, e in zip(NAMES, ["happy", "sad", "neutral"])}
    test_corpus = {n: {"emo": "happy"} for n in NAMES}
    np.savez(
        os.path.join(m23, "label-6way.npz"),
        train_corpus=np.array(train_corpus, dtype=object),
        test1_corpus=np.array(test_corpus, dtype=object),
    )

    feat_root = os.path.join(root, "features")
    for ds in ("MERCaptionPlus", "MER2023"):
        for modality, dim in (("frame", visual_dim), ("face", visual_dim)):
            d = os.path.join(feat_root, ds, f"{modality}_CLIP_VIT_LARGE_uniform_8frms")
            if modality == "face":
                d = os.path.join(feat_root, ds, f"{modality}_CLIP_VIT_LARGE_8frms")
            os.makedirs(d)
            for name in NAMES:
                np.save(os.path.join(d, f"{name}.npy"),
                        np.random.RandomState(2).randn(8, dim).astype(np.float32))
        d = os.path.join(feat_root, ds, "audio_HUBERT_LARGE_8clips")
        os.makedirs(d)
        for name in NAMES:
            np.save(os.path.join(d, f"{name}.npy"),
                    np.random.RandomState(3).randn(8, acoustic_dim).astype(np.float32))

    overrides = {
        "DATA_DIR": {ds: roots[ds] for ds in roots},
        "PATH_TO_RAW_AUDIO": {ds: os.path.join(roots[ds], "audio") for ds in roots},
        "PATH_TO_RAW_VIDEO": {ds: os.path.join(roots[ds], "video") for ds in roots},
        "PATH_TO_RAW_FACE": {ds: os.path.join(roots[ds], "openface_face") for ds in roots},
        "PATH_TO_TRANSCRIPTIONS": {ds: os.path.join(roots[ds], "subtitles.csv") for ds in roots},
        "PATH_TO_LABEL": {"MER2023": os.path.join(m23, "label-6way.npz")},
    }
    return overrides, feat_root
