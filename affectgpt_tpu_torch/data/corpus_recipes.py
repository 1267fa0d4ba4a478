"""Per-corpus normalizer recipes: raw distribution → processed contract.

Capability-parity with the reference's per-corpus preprocessors
(reference: AffectGPT/toolkit/preprocess/{mer2023,mer2024,meld,sims,
simsv2,cmumosi,cmumosei,iemocap}.py): each recipe reads the corpus's raw
label/metadata files and emits
  {save_root}/label*.npz          {split}_corpus dicts of {'emo','val'}
  {save_root}/transcription.csv   name → english[/chinese] subtitles
  {save_root}/video|subvideo/     media copies (optional)
— the layout every dataset class in data/datasets.py consumes.

Host-only pure Python: no ffmpeg/OpenCV dependency. Codec work (IEMOCAP avi→mp4 + utterance splitting,
reference iemocap.py:24-62; CMU-MOSEI interval splitting,
cmumosei.py:21-51) is injected via a `transcode(src, dst, start, end)`
callable so deployments can plug in their own decoder (native/ video
path or an external tool) without this module depending on one.

The port's own copy of affectgpt_tpu/data/corpus_recipes.py: the label
and metadata CSVs are read with `data/datasets.read_csv` (the csv module,
typed as `pandas.read_csv` types them) instead of pandas, which the card
lacks; `data/ingest.segment_transcode` is the port's `transcode=`.
"""

from __future__ import annotations

import logging
import os
import pickle
import shutil
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from affectgpt_tpu_torch.data.datasets import read_csv
from affectgpt_tpu_torch.data.normalize import write_label_npz, write_transcriptions

logger = logging.getLogger(__name__)

# MELD's 7-way label order (reference meld.py:7-11)
MELD_EMOS = ("anger", "joy", "sadness", "neutral", "disgust", "fear", "surprise")


def _read_csv_columns(path: str, columns: Sequence[str]) -> List[list]:
    rows = read_csv(path)
    return [[row[c] for row in rows] for c in columns]


def _copy_media(src: str, dst: str) -> None:
    if os.path.exists(dst):
        return
    if not os.path.exists(src):
        logger.warning("media missing: %s", src)
        return
    shutil.copy(src, dst)


def _media_dir(save_root: str, name: str) -> str:
    path = os.path.join(save_root, name)
    os.makedirs(path, exist_ok=True)
    return path


def normalize_mer2023(data_root: str, save_root: str, copy_media: bool = True) -> Dict[str, int]:
    """MER2023: train/test1/test2/test3 csvs (name, discrete, valence);
    test3 carries no valence → -10 (reference mer2023.py:8-47).
    Emits label-6way.npz with train/test1/test2/test3_corpus."""
    save_video = _media_dir(save_root, "video")
    splits: Dict[str, Dict[str, dict]] = {}
    counts = {}
    for split in ("train", "test1", "test2", "test3"):
        label_path = os.path.join(data_root, f"{split}-label.csv")
        names, emos = _read_csv_columns(label_path, ["name", "discrete"])
        if split == "test3":
            vals = [-10.0] * len(names)
        else:
            (vals,) = _read_csv_columns(label_path, ["valence"])
        corpus = {}
        for name, emo, val in zip(names, emos, vals):
            corpus[str(name)] = {"emo": emo, "val": float(val)}
            if copy_media:
                _copy_media(
                    os.path.join(data_root, split, f"{name}.mp4"),
                    os.path.join(save_video, f"{name}.mp4"),
                )
        splits[f"{split}_corpus"] = corpus
        counts[split] = len(corpus)
    write_label_npz(os.path.join(save_root, "label-6way.npz"), splits)
    return counts


def normalize_mer2024(
    data_root: str, save_root: str, seed: int = 0, copy_media: bool = True
) -> Dict[str, int]:
    """MER2024: labeled train (label-disdim.csv) + semi-labeled pool
    (semi-label.csv) split 50/50 into test1/test2 (reference
    mer2024.py:9-77). Emits label-6way.npz."""
    train_names, train_emos = _read_csv_columns(
        os.path.join(data_root, "label-disdim.csv"), ["name", "discrete"]
    )
    semi_names, semi_emos = _read_csv_columns(
        os.path.join(data_root, "semi-label.csv"), ["name", "discrete"]
    )
    rng = np.random.RandomState(seed)
    order = rng.permutation(len(semi_names))
    half = len(order) // 2
    groups = {
        "train": (train_names, train_emos, "video-labeled"),
        "test1": ([semi_names[i] for i in order[:half]],
                  [semi_emos[i] for i in order[:half]], "video-unlabeled"),
        "test2": ([semi_names[i] for i in order[half:]],
                  [semi_emos[i] for i in order[half:]], "video-unlabeled"),
    }
    splits, counts = {}, {}
    for split, (names, emos, video_dir) in groups.items():
        save_video = _media_dir(save_root, f"video-{split}")
        corpus = {}
        for name, emo in zip(names, emos):
            corpus[str(name)] = {"emo": emo}
            if copy_media:
                _copy_media(
                    os.path.join(data_root, video_dir, f"{name}.mp4"),
                    os.path.join(save_video, f"{name}.mp4"),
                )
        splits[f"{split}_corpus"] = corpus
        counts[split] = len(corpus)
    write_label_npz(os.path.join(save_root, "label-6way.npz"), splits)
    return counts


def normalize_meld(data_root: str, save_root: str, copy_media: bool = True) -> Dict[str, int]:
    """MELD: {train,dev,test}_sent_emo.csv → 7-way int labels, names
    '{split}_dia{D}_utt{U}', val=-10, english transcription (reference
    meld.py:14-89)."""
    emo2idx = {e: i for i, e in enumerate(MELD_EMOS)}
    save_video = _media_dir(save_root, "subvideo")
    splits, counts, name2eng = {}, {}, {}
    for split, csv_name, video_dir in (
        ("train", "train_sent_emo.csv", "train"),
        ("val", "dev_sent_emo.csv", "dev"),
        ("test", "test_sent_emo.csv", "test"),
    ):
        dia, utt, emotions, utterances = _read_csv_columns(
            os.path.join(data_root, csv_name),
            ["Dialogue_ID", "Utterance_ID", "Emotion", "Utterance"],
        )
        corpus = {}
        for d, u, emo, text in zip(dia, utt, emotions, utterances):
            name = f"{split}_dia{d}_utt{u}"
            corpus[name] = {"emo": emo2idx[emo], "val": -10.0}
            name2eng[name] = text
            if copy_media:
                _copy_media(
                    os.path.join(data_root, video_dir, f"dia{d}_utt{u}.mp4"),
                    os.path.join(save_video, f"{name}.mp4"),
                )
        splits[f"{split}_corpus"] = corpus
        counts[split] = len(corpus)
    write_label_npz(os.path.join(save_root, "label.npz"), splits)
    write_transcriptions(os.path.join(save_root, "transcription.csv"), name2eng)
    return counts


def _sims_newname(video_id, clip_id) -> str:
    return f"{video_id}_{int(clip_id):04d}"  # reference sims.py:6-8


def normalize_sims(data_root: str, save_root: str, copy_media: bool = True) -> Dict[str, int]:
    """CH-SIMS: metadata/sentiment/label_M.csv + {split}_index.csv +
    Translation.csv; sentiment-only ('emo': 0, 'val': label in [-1,1]);
    names '{video_id}_{clip:04d}' (reference sims.py:15-104)."""
    meta = os.path.join(data_root, "metadata")
    video_ids, clip_ids, labels = _read_csv_columns(
        os.path.join(meta, "sentiment", "label_M.csv"),
        ["video_id", "clip_id", "label"],
    )
    names = [_sims_newname(v, c) for v, c in zip(video_ids, clip_ids)]
    save_video = _media_dir(save_root, "video")
    splits, counts = {}, {}
    for split, idx_csv in (("train", "train_index.csv"),
                           ("val", "val_index.csv"),
                           ("test", "test_index.csv")):
        (indexes,) = _read_csv_columns(os.path.join(meta, idx_csv), ["index"])
        corpus = {}
        for i in indexes:
            corpus[names[i]] = {"emo": 0, "val": float(labels[i])}
            if copy_media:
                _copy_media(
                    os.path.join(data_root, "Raw", str(video_ids[i]),
                                 "%04d.mp4" % int(clip_ids[i])),
                    os.path.join(save_video, f"{names[i]}.mp4"),
                )
        splits[f"{split}_corpus"] = corpus
        counts[split] = len(corpus)
    write_label_npz(os.path.join(save_root, "label.npz"), splits)

    trans_path = os.path.join(meta, "Translation.csv")
    if os.path.exists(trans_path):
        t_vid, t_clip, chis, engs = _read_csv_columns(
            trans_path, ["video_id", "clip_id", "Chinese", "English"]
        )
        t_names = [_sims_newname(v, c) for v, c in zip(t_vid, t_clip)]
        write_transcriptions(
            os.path.join(save_root, "transcription.csv"),
            dict(zip(t_names, engs)),
            dict(zip(t_names, chis)),
        )
    return counts


def normalize_simsv2(data_root: str, save_root: str, copy_media: bool = True) -> Dict[str, int]:
    """CH-SIMS v2: single meta.csv with video_id/clip_id/text/label/mode
    ('valid' mode maps to val_corpus); chinese-only transcription
    (reference simsv2.py:15-77)."""
    video_ids, clip_ids, texts, labels, modes = _read_csv_columns(
        os.path.join(data_root, "meta.csv"),
        ["video_id", "clip_id", "text", "label", "mode"],
    )
    save_video = _media_dir(save_root, "video")
    splits: Dict[str, Dict[str, dict]] = {}
    name2chi = {}
    for v, c, text, label, mode in zip(video_ids, clip_ids, texts, labels, modes):
        name = _sims_newname(v, c)
        split = {"valid": "val"}.get(str(mode), str(mode))
        splits.setdefault(f"{split}_corpus", {})[name] = {"emo": 0, "val": float(label)}
        name2chi[name] = text
        if copy_media:
            _copy_media(
                os.path.join(data_root, "Raw", str(v), "%04d.mp4" % int(c)),
                os.path.join(save_video, f"{name}.mp4"),
            )
    write_label_npz(os.path.join(save_root, "label.npz"), splits)
    write_transcriptions(
        os.path.join(save_root, "transcription.csv"),
        {n: "" for n in name2chi}, name2chi,
    )
    return {k[: -len("_corpus")]: len(v) for k, v in splits.items()}


def _load_mosi_pkl(label_path: str):
    with open(label_path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def normalize_cmumosi(data_root: str, save_root: str, copy_media: bool = True) -> Dict[str, int]:
    """CMU-MOSI: 7-tuple pkl (videoIDs, videoLabels, _, videoSentences,
    trainVids, valVids, testVids); sentiment-only {'emo': 0, 'val': y};
    english transcription from videoSentences (reference cmumosi.py:9-88)."""
    label_path = os.path.join(data_root, "CMUMOSI_features_raw_2way.pkl")
    video_ids, video_labels, _, video_sentences, train_vids, val_vids, test_vids = (
        _load_mosi_pkl(label_path)
    )
    return _emit_mosi_family(
        data_root, save_root, video_ids, video_labels, video_sentences,
        {"train": train_vids, "val": val_vids, "test": test_vids},
        video_subdir=os.path.join("Video", "Segmented"), copy_media=copy_media,
    )


def normalize_cmumosei(data_root: str, save_root: str, copy_media: bool = True) -> Dict[str, int]:
    """CMU-MOSEI: same pkl contract as MOSI (reference cmumosei.py:71-142)."""
    label_path = os.path.join(data_root, "CMUMOSEI_features_raw_2way.pkl")
    video_ids, video_labels, _, video_sentences, train_vids, val_vids, test_vids = (
        _load_mosi_pkl(label_path)
    )
    return _emit_mosi_family(
        data_root, save_root, video_ids, video_labels, video_sentences,
        {"train": train_vids, "val": val_vids, "test": test_vids},
        video_subdir="subvideo-raw", copy_media=copy_media,
    )


def _emit_mosi_family(
    data_root, save_root, video_ids, video_labels, video_sentences, split_vids,
    video_subdir: str, copy_media: bool,
) -> Dict[str, int]:
    save_video = _media_dir(save_root, "subvideo")
    splits, counts, name2eng = {}, {}, {}
    for split, vids in split_vids.items():
        corpus = {}
        for vid in vids:
            for name, label, sentence in zip(
                video_ids[vid], video_labels[vid], video_sentences[vid]
            ):
                corpus[name] = {"emo": 0, "val": float(label)}
                name2eng[name] = sentence
                if copy_media:
                    _copy_media(
                        os.path.join(data_root, video_subdir, f"{name}.mp4"),
                        os.path.join(save_video, f"{name}.mp4"),
                    )
        splits[f"{split}_corpus"] = corpus
        counts[split] = len(corpus)
    write_label_npz(os.path.join(save_root, "label.npz"), splits)
    write_transcriptions(os.path.join(save_root, "transcription.csv"), name2eng)
    return counts


def normalize_iemocap(
    data_root: str,
    save_root: str,
    label_pkl: str,
    transcode: Optional[Callable[[str, str, float, float], None]] = None,
) -> Dict[str, int]:
    """IEMOCAP: session transcription txts ('Ses.. [start-end]: text') →
    transcription.csv; 6-tuple label pkl → single whole_corpus npz with
    val=-10 (reference iemocap.py:66-110). Utterance media splitting
    needs a decoder: pass transcode(avi_path, out_path, start_s, end_s)
    to materialize subvideos (reference iemocap.py:24-62 shells to
    ffmpeg; this framework keeps codecs injected)."""
    names, sentences, intervals = [], [], {}
    for session in ("Session1", "Session2", "Session3", "Session4", "Session5"):
        trans_root = os.path.join(data_root, session, "dialog", "transcriptions")
        if not os.path.isdir(trans_root):
            continue
        for fname in sorted(os.listdir(trans_root)):
            if not (fname.startswith("S") and fname.endswith(".txt")):
                continue
            dialog = os.path.splitext(fname)[0]
            with open(os.path.join(trans_root, fname), encoding="utf8") as f:
                for line in f:
                    line = line.strip()
                    if not line or " [" not in line or "]:" not in line:
                        continue
                    try:
                        subname = line.split(" [")[0]
                        span = line.split("[", 1)[1].split("]", 1)[0]
                        start, end = (float(x) for x in span.split("-"))
                        sentence = line.split("]:", 1)[1].strip()
                    except (IndexError, ValueError):
                        continue
                    names.append(subname)
                    sentences.append(sentence)
                    intervals[subname] = (session, dialog, start, end)
    os.makedirs(save_root, exist_ok=True)
    write_transcriptions(
        os.path.join(save_root, "transcription.csv"), dict(zip(names, sentences))
    )

    video_ids, video_labels, _, _, train_vids, test_vids = _load_mosi_pkl(label_pkl)
    whole = {}
    for vid in sorted(train_vids | test_vids):
        for name, label in zip(video_ids[vid], video_labels[vid]):
            whole[name] = {"emo": label, "val": -10.0}
    write_label_npz(os.path.join(save_root, "label.npz"), {"whole_corpus": whole})

    if transcode is not None:
        save_video = _media_dir(save_root, "subvideo")
        for subname, (session, dialog, start, end) in intervals.items():
            avi = os.path.join(
                data_root, session, "dialog", "avi", "DivX", f"{dialog}.avi"
            )
            if os.path.exists(avi):
                transcode(avi, os.path.join(save_video, f"{subname}.mp4"), start, end)
    return {"whole": len(whole), "transcribed": len(names)}


def normalize_mer2023_unlabel(
    data_root: str,
    save_root: Optional[str] = None,
    min_faces: int = 16,
    prune: bool = False,
) -> Dict[str, int]:
    """MER2023 unlabeled-corpus prep (reference mer2023_unlabel.py:8-36):
    scan `{data_root}/openface_face/{name}/{name}.npy` face stacks, record
    per-clip frame counts to `unlabel-name2len.npz`, and flag (optionally
    delete, reference's `rm -rf`) clips with ≤ min_faces usable faces or
    unreadable stacks — the filter that leaves the pretraining pool.

    Returns {"total", "kept", "short", "errors"}."""
    import glob

    face_root = os.path.join(data_root, "openface_face")
    save_root = save_root or data_root
    name2len: Dict[str, int] = {}
    errors: List[str] = []
    for face_dir in sorted(glob.glob(os.path.join(face_root, "*"))):
        if not os.path.isdir(face_dir):
            continue
        facename = os.path.basename(face_dir)
        face_npy = os.path.join(face_dir, facename + ".npy")
        try:
            faces = np.load(face_npy)
            name2len[facename] = len(faces)
        except Exception:
            logger.warning("mer2023_unlabel: error file %s", facename)
            errors.append(facename)
    short = [n for n, ln in name2len.items() if ln <= min_faces]
    os.makedirs(save_root, exist_ok=True)
    np.savez_compressed(
        os.path.join(save_root, "unlabel-name2len.npz"), name2len=name2len
    )
    if prune:
        for name in short + errors:
            face_dir = os.path.join(face_root, name)
            if os.path.isdir(face_dir):
                shutil.rmtree(face_dir)
    return {
        "total": len(name2len) + len(errors),
        "kept": len(name2len) - len(short),
        "short": len(short),
        "errors": len(errors),
    }
